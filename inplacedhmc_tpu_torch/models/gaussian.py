"""Gaussian targets: the standard normal, the diagonal normal and the
multivariate normal with a dense covariance.

The port's counterpart of ``inplacedhmc_tpu/models/gaussian.py``.  BASELINE
config 1 is the 100-dimensional standard normal, the basic correctness
target (posterior mean and variance within Monte Carlo error).
``std_normal`` and ``diag_normal`` carry ``structure={"kind":
"diag_gaussian", "precision": <[D] tensor>}``: their gradient is
``-precision * q``, the structure the fused Gaussian leapfrog
(``ops/leapfrog.py``) and the whole-tree kernel (``ops/tree.py``) are
written for.  ``mvn`` carries ``{"kind": "dense_gaussian", "precision":
<[D, D] tensor>}``: its gradient is ``-(q P)``, the whole-tree kernel's
``dense_gaussian`` physics (``ops/tile_physics.py``).
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


def dense_gaussian_model(name: str, precision: torch.Tensor) -> Model:
    """The model ``N(0, precision^-1)`` with its ``structure``;
    ``precision`` is a symmetric ``[D, D]`` tensor, kept as it is given."""
    def logp(q):
        return -0.5 * torch.sum((q @ precision.to(q.dtype)) * q, dim=-1)

    return Model(name=name, dim=precision.shape[0], logp=logp,
                 structure={"kind": "dense_gaussian",
                            "precision": precision})


def mvn(cov, device="cuda") -> Model:
    """``N(0, cov)`` with a dense covariance: the target of the dense
    metric.  As in the JAX package, the precision is ``cov``'s inverse,
    symmetrized, computed in ``cov``'s dtype (a numpy array becomes
    float32) on ``device``."""
    if not isinstance(cov, torch.Tensor):
        cov = np.asarray(cov, dtype=np.float32)
    cov = torch.as_tensor(cov, device=device)
    prec = torch.linalg.inv(cov)
    prec = 0.5 * (prec + prec.T)
    return dense_gaussian_model(f"mvn_{cov.shape[0]}", prec)
