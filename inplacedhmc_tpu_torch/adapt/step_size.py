"""Step-size adaptation: dual averaging and the lockstep initial-eps search.

The port's counterpart of ``inplacedhmc_tpu/adapt/step_size.py``.  Dual
averaging is the same recurrence, per chain ``[C]`` or on a pooled scalar
(the caller pre-reduces the acceptance).  The initial search is the same
bracket-then-bisect, run in lockstep for all chains: each iteration is one
batched leapfrog step, and a Python loop with one ``.any()`` sync per
iteration replaces ``lax.while_loop``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import DualAveraging, InitialStepsizeSearch
from ..core.hamiltonian import joint_logdensity
from ..core.metric import Metric
from ..core.state import PhasePoint
from ..ops.integrator import leapfrog


class DualAveragingState(NamedTuple):
    """Per-chain (or pooled scalar) dual-averaging state."""

    mu: torch.Tensor
    m: int                # iteration counter
    h_bar: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor


def da_init(params: DualAveraging, eps: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(eps)
    z = torch.zeros_like(log_eps)
    return DualAveragingState(mu=math.log(10.0) + log_eps, m=0, h_bar=z,
                              log_eps=log_eps, log_eps_bar=z)


def da_update(params: DualAveraging, s: DualAveragingState,
              accept: torch.Tensor) -> DualAveragingState:
    """One dual-averaging step."""
    m = s.m + 1
    h_bar = s.h_bar + (params.delta - accept - s.h_bar) / (m + params.t0)
    log_eps = s.mu - math.sqrt(m) / params.gamma * h_bar
    log_eps_bar = s.log_eps_bar + m ** (-params.kappa) * (log_eps
                                                          - s.log_eps_bar)
    return DualAveragingState(mu=s.mu, m=m, h_bar=h_bar, log_eps=log_eps,
                              log_eps_bar=log_eps_bar)


def da_current_eps(s: DualAveragingState) -> torch.Tensor:
    """Step size while tuning."""
    return torch.exp(s.log_eps)


def da_final_eps(s: DualAveragingState) -> torch.Tensor:
    """Smoothed step size after the window."""
    return torch.exp(s.log_eps_bar)


def local_acceptance_ratio(potential: Callable, metric: Metric,
                           z: PhasePoint) -> Callable:
    """``A(eps) = exp(H(leapfrog(z, eps)) - H(z))``, batched; non-finite
    ratios become 0 and the exponent is capped at 50."""
    target = joint_logdensity(metric, z.Q.logp, z.p)

    def a_of(eps):
        z1 = leapfrog(potential, metric, z, eps)
        val = joint_logdensity(metric, z1.Q.logp, z1.p) - target
        val = torch.where(torch.isnan(val), -torch.inf, val)
        return torch.exp(torch.clamp(val, max=50.0))

    return a_of


def find_initial_stepsize(params: InitialStepsizeSearch, potential: Callable,
                          metric: Metric, z: PhasePoint) -> torch.Tensor:
    """Per-chain eps with ``A(eps)`` in ``[a_min, a_max]``, all chains
    searched in lockstep.  Phase 0 brackets (grow or shrink eps by ``c``
    until the acceptance crosses the band), phase 1 bisects, phase 2 is
    done; chains that never converge fall back to the bracket midpoint."""
    q = z.Q.q
    c, dtype, dev = q.shape[0], q.dtype, q.device
    a_of = local_acceptance_ratio(potential, metric, z)
    a_min, a_max = params.a_min, params.a_max

    eps = torch.full((c,), params.eps0, dtype=dtype, device=dev)
    a0 = a_of(eps)
    phase = torch.where((a0 >= a_min) & (a0 <= a_max), 2, 0).to(torch.int32)
    grow = a0 > a_max
    eps_lo = eps_hi = eps
    factor = torch.where(grow, params.c, 1.0 / params.c).to(dtype)
    thresh = torch.where(grow, a_max, a_min).to(dtype)
    sign = torch.where(grow, 1.0, -1.0).to(dtype)
    max_it = params.maxiter_crossing + params.maxiter_bisect

    for it in range(max_it):
        if not bool((phase < 2).any()):
            break
        bracketing = phase == 0
        bisecting = phase == 1
        cand = torch.where(bracketing, eps * factor,
                           torch.where(bisecting, 0.5 * (eps_lo + eps_hi), eps))
        a = a_of(cand)   # done chains compute but never consume this
        in_band = (a >= a_min) & (a <= a_max)

        # bracketing ends when the acceptance crossed the threshold it was
        # moving toward; the side with A > a_max becomes lo
        crossed = sign * (a - thresh) <= 0
        lo_cross = torch.where(grow, eps, cand)
        hi_cross = torch.where(grow, cand, eps)
        done_now = bracketing & crossed & in_band
        to_bisect = bracketing & crossed & ~in_band
        keep_bracketing = bracketing & ~crossed
        # chains still bracketing after maxiter_crossing switch to bisection
        # over the last (eps, cand) interval
        force_bisect = keep_bracketing & (it + 1 >= params.maxiter_crossing)
        keep_bracketing = keep_bracketing & ~force_bisect

        bi_done = bisecting & in_band
        hi_new = torch.where(bisecting & (a < a_min), cand, eps_hi)
        lo_new = torch.where(bisecting & (a > a_max), cand, eps_lo)

        phase = torch.where(done_now | bi_done, 2, phase).to(torch.int32)
        phase = torch.where(to_bisect | force_bisect, 1, phase).to(torch.int32)
        eps_next = torch.where(done_now | bi_done | keep_bracketing, cand, eps)
        eps_lo = torch.where(to_bisect, lo_cross, torch.where(
            force_bisect, torch.minimum(eps, cand), lo_new))
        eps_hi = torch.where(to_bisect, hi_cross, torch.where(
            force_bisect, torch.maximum(eps, cand), hi_new))
        eps = eps_next

    return torch.where(phase == 2, eps, 0.5 * (eps_lo + eps_hi))
