"""Hamiltonian assembly: batched log-density evaluation and joint density.

The port's counterpart of ``inplacedhmc_tpu/core/hamiltonian.py``.  A model's
``logp`` takes positions ``[..., D]`` and returns ``[...]``: the JAX package's
``vmap`` written out as a batch dimension.  The gradient comes from one
batched autograd call (chains are independent, so the gradient of the summed
log density is every chain's own gradient).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .metric import Metric, kinetic_energy
from .state import EvalPoint


def guard(val: torch.Tensor, grad: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map a non-finite log density, or a finite one with a non-finite
    gradient, to ``-inf`` with a zero gradient: the divergence sentinel."""
    ok = torch.isfinite(val) & torch.all(torch.isfinite(grad), dim=-1)
    val = torch.where(ok, val, torch.full_like(val, -torch.inf))
    grad = torch.where(ok[..., None], grad, torch.zeros_like(grad))
    return val, grad


def batched_logdensity_and_grad(logp: Callable) -> Callable:
    """Turn a batched ``logp([C, D]) -> [C]`` into a guarded
    ``[C, D] -> ([C], [C, D])`` through autograd.  The outputs take the
    state's dtype."""

    def evaluate(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            val = logp(qq)
            (grad,) = torch.autograd.grad(val.sum(), qq)
        val, grad = guard(val.detach(), grad)
        return val.to(q.dtype), grad.to(q.dtype)

    return evaluate


def evaluate(potential: Callable, q: torch.Tensor) -> EvalPoint:
    """Build an :class:`EvalPoint` at ``q``."""
    logp, grad = potential(q)
    return EvalPoint(q=q, logp=logp, grad=grad)


def joint_logdensity(metric: Metric, logp_q: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """``logp(q) - K(p)``; a non-finite log density or kinetic energy gives
    ``-inf``, making the point divergent."""
    k = kinetic_energy(metric, p)
    val = logp_q - torch.where(torch.isfinite(k), k,
                               torch.full_like(k, torch.inf))
    return torch.where(torch.isfinite(val), val,
                       torch.full_like(val, -torch.inf))
