"""Gaussian kinetic energies (diagonal and dense) and mass-matrix estimation.

The port's counterpart of ``inplacedhmc_tpu/core/metric.py``.  Metric tensors
broadcast over the chains axis: ``[D]`` / ``[D, D]`` (one shared metric, as
pooled adaptation produces) or ``[C, D]`` / ``[C, D, D]`` (per chain).

The dense products here are plain ``torch.matmul``/``einsum``; the port's
entry points switch TF32 off (see :func:`inplacedhmc_tpu_torch.sample.f32_matmuls`),
so on the card they run in IEEE f32, the f32-grade class the JAX package
asks of the q-update, the kinetic energy and the momentum refresh.

Not ported yet: the low-rank metric and the streamed-moment forms.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class DiagMetric(NamedTuple):
    """Diagonal Gaussian kinetic energy: ``inv`` is ``M^-1``, ``sqrt_mass``
    is ``M^(1/2)``, cached for momentum draws."""

    inv: torch.Tensor        # [..., D]
    sqrt_mass: torch.Tensor  # [..., D]


class DenseMetric(NamedTuple):
    """Dense Gaussian kinetic energy: ``inv`` is ``M^-1``; ``mass_chol`` is a
    factor ``A`` with ``A A^T = M``, used for momentum draws."""

    inv: torch.Tensor        # [..., D, D]
    mass_chol: torch.Tensor  # [..., D, D]


Metric = Union[DiagMetric, DenseMetric]


def identity_metric(dim: int, dtype=torch.float32, device="cuda",
                    m_inv: float = 1.0) -> DiagMetric:
    """Identity (scaled) starting metric."""
    inv = torch.full((dim,), m_inv, dtype=dtype, device=device)
    return DiagMetric(inv=inv, sqrt_mass=1.0 / torch.sqrt(inv))


def diag_metric(inv: torch.Tensor) -> DiagMetric:
    return DiagMetric(inv=inv, sqrt_mass=1.0 / torch.sqrt(inv))


def dense_metric(inv: torch.Tensor) -> DenseMetric:
    """Dense metric from ``M^-1``, factoring ``M^-1`` directly:
    ``L = chol(M^-1)`` and ``A = L^-T`` satisfy ``A A^T = M``.  Inverting
    first would square the condition number."""
    sym = 0.5 * (inv + inv.transpose(-1, -2))
    l = torch.linalg.cholesky(sym)
    eye = torch.eye(inv.shape[-1], dtype=inv.dtype,
                    device=inv.device).expand(inv.shape)
    l_inv = torch.linalg.solve_triangular(l, eye, upper=False)
    return DenseMetric(inv=inv, mass_chol=l_inv.transpose(-1, -2))


def _matvec(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``m @ p`` per chain: ``m`` is ``[D, D]`` (shared) or ``[C, D, D]``."""
    if m.ndim == 2:
        return p @ m.transpose(0, 1)
    return torch.einsum("...ij,...j->...i", m, p)


def kinetic_energy(metric: Metric, p: torch.Tensor) -> torch.Tensor:
    """``K(p) = 1/2 p^T M^-1 p``.  ``p``: [C, D] -> [C]."""
    if isinstance(metric, DiagMetric):
        return 0.5 * torch.sum(p * metric.inv * p, dim=-1)
    return 0.5 * torch.sum(p * _matvec(metric.inv, p), dim=-1)


def psharp(metric: Metric, p: torch.Tensor) -> torch.Tensor:
    """``p# = M^-1 p``: the integrator's q-update and the U-turn statistic."""
    if isinstance(metric, DiagMetric):
        return metric.inv * p
    return _matvec(metric.inv, p)


def sample_momentum(metric: Metric, gen: torch.Generator, shape,
                    dtype) -> torch.Tensor:
    """Draw ``p ~ N(0, M)``.  ``shape``: [C, D]; ``gen`` lives on the device
    of the metric."""
    xi = torch.randn(shape, generator=gen, dtype=dtype,
                     device=metric.inv.device)
    if isinstance(metric, DiagMetric):
        return metric.sqrt_mass * xi
    return _matvec(metric.mass_chol, xi)


def _regularize(var, n_eff, lam, target=None):
    """``var N/(N+lam) + target lam/(N+lam)``, the single definition of the
    shrinkage; ``target`` is the scalar 1e-3 (diag) or ``1e-3 I``."""
    if target is None:
        target = 1e-3
    return var * (n_eff / (n_eff + lam)) + target * (lam / (n_eff + lam))


def regularized_variance(draws: torch.Tensor, lam,
                         pooled: bool = False) -> torch.Tensor:
    """Regularized per-coordinate variance of warmup draws ``[N, C, D]``:
    ``var N/(N+lam) + 1e-3 lam/(N+lam)`` with the unbiased sample variance,
    per chain ``[C, D]`` or pooled over chains ``[D]`` (two-pass centered
    moments)."""
    n = draws.shape[0]
    if pooled:
        cnt = float(n * draws.shape[1])
        mean = torch.sum(draws, dim=(0, 1)) / cnt
        c = draws - mean
        var = torch.sum(c * c, dim=(0, 1)) / (cnt - 1)
        n_eff = cnt
    else:
        var = torch.var(draws, dim=0, correction=1)
        n_eff = float(n)
    return _regularize(var, n_eff, lam)


def estimate_diag_metric(draws: torch.Tensor, lam,
                         pooled: bool = False) -> DiagMetric:
    return diag_metric(regularized_variance(draws, lam, pooled))


def regularized_cov(draws: torch.Tensor, lam, pooled: bool = True,
                    ) -> torch.Tensor:
    """Regularized covariance for the dense metric:
    ``cov N/(N+lam) + 1e-3 lam/(N+lam) I``.  ``draws``: [N, C, D] -> [D, D]
    (pooled, two-pass centered Gram) or [C, D, D] (per chain)."""
    n = draws.shape[0]
    d = draws.shape[-1]
    if pooled:
        cnt = float(n * draws.shape[1])
        flat = draws.reshape(-1, d)
        flatc = flat - torch.sum(flat, dim=0) / cnt
        cov = (flatc.transpose(0, 1) @ flatc) / (cnt - 1)
        n_eff = cnt
    else:
        c = draws - torch.mean(draws, dim=0)[None]
        cov = torch.einsum("nci,ncj->cij", c, c) / (n - 1)
        n_eff = float(n)
    eye = torch.eye(d, dtype=draws.dtype, device=draws.device)
    return _regularize(cov, n_eff, lam, target=1e-3 * eye)


def estimate_dense_metric(draws: torch.Tensor, lam,
                          pooled: bool = True) -> DenseMetric:
    return dense_metric(regularized_cov(draws, lam, pooled))

