"""Neal's funnel, BASELINE config 2, and its non-centred form.

The port's counterpart of ``inplacedhmc_tpu/models/funnel.py``: ``q = (v,
x_1..x_{dim-1})`` with ``v ~ N(0, scale^2)`` and ``x_i | v ~ N(0, e^v)``.
The neck forces small step sizes and produces divergent transitions, which
the sampler reports through the ``-inf`` sentinel.  ``funnel`` names the
``"funnel"`` tile physics (``ops/tile_physics.py``,
``csrc/tree_funnel.cu``); ``funnel_nc`` is a standard normal in disguise
and runs on the Gaussian kernels.
"""

from __future__ import annotations

import torch

from .base import Model
from .gaussian import diag_gaussian_model


def funnel(dim: int = 10, scale: float = 3.0, device="cuda") -> Model:
    """The centred funnel.  Its ``structure`` carries the ``x_mask`` row
    (1 on the x lanes) on ``device`` and the scalars ``k = dim - 1`` and
    ``inv_s2 = 1 / scale^2``."""
    k = dim - 1

    def logp(q):
        v, x = q[..., 0], q[..., 1:]
        return -0.5 * (v / scale) ** 2 \
            - 0.5 * (torch.sum(x * x, dim=-1) * torch.exp(-v) + k * v)

    x_mask = torch.ones((dim,), dtype=torch.float32, device=device)
    x_mask[0] = 0.0
    return Model(name=f"funnel_{dim}", dim=dim, logp=logp,
                 structure={"kind": "tile_logp", "physics": "funnel",
                            "data": {"x_mask": x_mask},
                            "scalars": {"k": float(k),
                                        "inv_s2": 1.0 / (scale * scale)}})


def funnel_nc(dim: int = 10, scale: float = 3.0, device="cuda") -> Model:
    """The non-centred funnel: ``z ~ N(0, I)`` with ``v = scale z_0`` and
    ``x_i = exp(v / 2) z_i``, which removes the neck.  A
    ``"diag_gaussian"`` model of unit precision; ``constrain`` maps draws
    back to ``(v, x)``, whose moments are the centred model's."""
    model = diag_gaussian_model(
        f"funnel_nc_{dim}", torch.ones((dim,), dtype=torch.float32,
                                       device=device))

    def constrain(q):
        v = scale * q[..., 0]
        return {"v": v, "x": torch.exp(0.5 * v)[..., None] * q[..., 1:]}

    return Model(name=model.name, dim=dim, logp=model.logp,
                 constrain=constrain, structure=model.structure)
