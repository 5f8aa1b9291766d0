"""Gaussian targets: the standard normal and the diagonal normal.

The port's counterpart of ``inplacedhmc_tpu/models/gaussian.py``.  BASELINE
config 1 is the 100-dimensional standard normal, the basic correctness
target (posterior mean and variance within Monte Carlo error).  Both models
carry ``structure={"kind": "diag_gaussian", "precision": <[D] tensor>}``:
their gradient is ``-precision * q``, the structure the fused Gaussian
leapfrog (``ops/leapfrog.py``) and the whole-tree kernel (``ops/tree.py``)
are written for.

Not ported yet: ``mvn`` (``"dense_gaussian"``), which needs the dense branch
of the whole-tree kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Model


def diag_gaussian_model(name: str, precision: torch.Tensor) -> Model:
    """The model ``N(0, diag(1 / precision))`` with its ``structure``;
    ``precision`` is a ``[D]`` tensor, kept as it is given."""
    def logp(q):
        return -0.5 * torch.sum(q * q * precision.to(q.dtype), dim=-1)

    return Model(name=name, dim=precision.shape[0], logp=logp,
                 structure={"kind": "diag_gaussian", "precision": precision})


def std_normal(dim: int = 100, device="cuda") -> Model:
    """``N(0, I_dim)``; its precision is a ``[dim]`` float32 tensor of ones
    on ``device``."""
    return diag_gaussian_model(
        f"std_normal_{dim}",
        torch.ones((dim,), dtype=torch.float32, device=device))


def diag_normal(variances, device="cuda") -> Model:
    """``N(0, diag(variances))``: ill-conditioned targets for the metric's
    adaptation.  ``variances`` (a tensor or a numpy array) is placed on
    ``device``; a numpy array becomes float32."""
    if not isinstance(variances, torch.Tensor):
        variances = np.asarray(variances, dtype=np.float32)
    var = torch.as_tensor(variances, device=device)
    return diag_gaussian_model(f"diag_normal_{var.shape[0]}", 1.0 / var)
