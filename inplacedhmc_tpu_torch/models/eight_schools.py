"""Eight schools, BASELINE config 4 (1,024 chains on one card).

The port's counterpart of ``inplacedhmc_tpu/models/eight_schools.py``: the
non-centred parameterisation ``q = (mu, log_tau, z_1..z_8)``, school
effects ``theta_j = mu + tau z_j``.  Its ``structure`` names the
``"eight_schools"`` tile physics (``ops/tile_physics.py``), whose
hand-written value and gradient the whole-tree kernel runs
(``csrc/tree_eight_schools.cu``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model

# Rubin (1981): treatment effects and their standard errors
Y = np.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def tile_data(dim: int, device="cuda"):
    """The tile physics' data rows, ``[dim]`` float32 each, the data on
    the z lanes ``2..9`` and zero elsewhere: ``y``, ``sig`` and ``obs_mask``
    (1 on those lanes)."""
    n = len(Y)
    rows = {k: np.zeros(dim, np.float32) for k in ("y", "sig", "obs_mask")}
    rows["y"][2:2 + n] = Y
    rows["sig"][2:2 + n] = SIGMA
    rows["obs_mask"][2:2 + n] = 1.0
    return {k: torch.as_tensor(v, device=device) for k, v in rows.items()}


def eight_schools(device="cuda") -> Model:
    """Stan's priors: ``mu ~ N(0, 10^2)``, ``tau ~ half-Cauchy(0, 5)``
    sampled as ``log_tau`` with its ``+log_tau`` Jacobian, ``z ~ N(0, 1)``.
    The data rows of its ``structure`` live on ``device``."""
    dim = 2 + len(Y)

    def logp(q):
        mu, log_tau, z = q[..., 0], q[..., 1], q[..., 2:]
        tau = torch.exp(log_tau)
        theta = mu[..., None] + tau[..., None] * z
        lp = -0.5 * (mu / 10.0) ** 2
        # half-Cauchy in log_tau form; (tau/5)^2 would overflow f32 at
        # log_tau ~ 46 while the density is finite to ~88
        x = 2.0 * (log_tau - math.log(5.0))
        lp = lp - torch.logaddexp(torch.zeros_like(x), x) + log_tau
        lp = lp - 0.5 * torch.sum(z * z, dim=-1)
        yy = torch.as_tensor(Y, dtype=q.dtype, device=q.device)
        sig = torch.as_tensor(SIGMA, dtype=q.dtype, device=q.device)
        return lp + torch.sum(-0.5 * ((yy - theta) / sig) ** 2, dim=-1)

    def constrain(q):
        mu, log_tau, z = q[..., 0], q[..., 1], q[..., 2:]
        tau = torch.exp(log_tau)
        return {"mu": mu, "tau": tau,
                "theta": mu[..., None] + tau[..., None] * z}

    return Model(name="eight_schools", dim=dim, logp=logp,
                 constrain=constrain,
                 structure={"kind": "tile_logp", "physics": "eight_schools",
                            "data": tile_data(dim, device), "scalars": {}})
