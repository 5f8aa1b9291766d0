"""Velocity-Verlet leapfrog integrator.

The port's counterpart of ``inplacedhmc_tpu/ops/integrator.py``::

    p_mid = p + eps/2 * grad(q)
    q'    = q + eps * M^-1 * p_mid
    p'    = p_mid + eps/2 * grad(q')

batched over chains with a (possibly per-chain, signed) step size.  The
potential is where the logistic model's kernel runs.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.metric import Metric, psharp
from ..core.state import EvalPoint, PhasePoint


def leapfrog(potential: Callable, metric: Metric, z: PhasePoint,
             eps) -> PhasePoint:
    """One leapfrog step.  ``eps`` is a scalar or ``[C]`` and may be negative.
    Uses the gradient cached in ``z.Q``, so each position is evaluated once."""
    q, grad, p = z.Q.q, z.Q.grad, z.p
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    eps_b = eps[..., None] if eps.ndim else eps
    half = 0.5 * eps_b
    p_mid = p + half * grad
    q_new = q + eps_b * psharp(metric, p_mid)
    logp_new, grad_new = potential(q_new)
    p_new = p_mid + half * grad_new
    return PhasePoint(Q=EvalPoint(q=q_new, logp=logp_new, grad=grad_new),
                      p=p_new)
