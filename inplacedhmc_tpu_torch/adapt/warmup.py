"""Warmup stages and the post-warmup sampling loop.

The port's counterpart of ``inplacedhmc_tpu/adapt/warmup.py``: one function
per stage, driven in order by ``sample.py``.  Each ``lax.scan`` over
transitions becomes a Python loop; every random draw comes from the
``torch.Generator`` passed in.

Pooled adaptation (one step size on the cross-chain mean acceptance, one
metric from all chains' draws) and independent per-chain adaptation are both
supported.  A tuning window and the sampling loop may run each transition
through a fused kernel: ``transition_factory(metric, n_chains)`` returns a
whole-tree transition (or ``None``), ``step_factory(metric)`` a fused
leapfrog ``step_fn`` for the lockstep tree (or ``None``).  Each factory is
called once per window with the window's metric, so a metric re-estimate
rebuilds the closure.  Not ported yet: streamed metric moments, chunked
tuning windows, work-sorted scheduling, the whole-tree sweep runner and
split-moment sampling.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import (DualAveraging, FindLocalOptimum, InitialStepsizeSearch,
                      NUTS, TuningNUTS)
from ..core.hamiltonian import evaluate
from ..core.metric import (Metric, estimate_dense_metric, estimate_diag_metric,
                           identity_metric, sample_momentum)
from ..core.state import EvalPoint, PhasePoint, TreeStats, WarmupState
from ..nuts.tree import nuts_transition
from .optimize import lbfgs_batched
from .step_size import (da_current_eps, da_final_eps, da_init, da_update,
                        find_initial_stepsize)


def random_position(gen: torch.Generator, n_chains: int, dim: int, dtype,
                    device) -> torch.Tensor:
    """Uniform starting positions in ``[-2, 2]^D``."""
    u = torch.rand((n_chains, dim), generator=gen, dtype=dtype, device=device)
    return 4.0 * u - 2.0


def init_warmup_state(gen: torch.Generator, potential: Callable, dim: int,
                      n_chains: int, dtype=torch.float32, device="cuda",
                      q: Optional[torch.Tensor] = None,
                      metric: Optional[Metric] = None,
                      eps: Optional[float] = None) -> WarmupState:
    """Initial warmup state: random positions (unless given), the identity
    metric (unless given), and no eps (``None`` asks for the search)."""
    if q is None:
        q = random_position(gen, n_chains, dim, dtype, device)
    else:
        q = torch.as_tensor(q, dtype=dtype, device=device)
        if q.ndim == 1:
            q = q[None].expand(n_chains, dim).contiguous()
    if metric is None:
        metric = identity_metric(dim, dtype, device)
    log_eps = None if eps is None else torch.log(
        torch.tensor(eps, dtype=dtype, device=device))
    return WarmupState(z=evaluate(potential, q), metric=metric,
                       log_eps=log_eps)


def run_local_optimum(gen: torch.Generator, potential: Callable,
                      stage: FindLocalOptimum,
                      state: WarmupState) -> WarmupState:
    """Penalized L-BFGS toward the typical set.

    The objective per chain is ``-(logp(q) - 0.5 pen |q|^2)``.  It is
    evaluated through the model's batched, guarded potential (the fused
    kernel for logistic regression): the same function the JAX package
    differentiates per chain with autodiff of ``model.logp``, and the guard
    turns a non-finite point into ``f = +inf``, which the line search
    rejects as the JAX version does.  Chains that end at a non-finite density
    restart from fresh random positions with a doubled penalty, up to
    ``max_retries`` times.
    """
    q = state.z.q
    c, dim = q.shape
    pen = stage.magnitude_penalty
    for _ in range(stage.max_retries + 1):
        def objective(qq, pen=pen):
            lp, g = potential(qq)
            return (-(lp - 0.5 * pen * torch.sum(qq * qq, dim=-1)),
                    -(g - pen * qq))

        q_opt, _, _ = lbfgs_batched(objective, q, stage.iterations)
        z = evaluate(potential, q_opt)
        bad = ~torch.isfinite(z.logp)
        if not bool(bad.any()):
            return WarmupState(z=z, metric=state.metric,
                               log_eps=state.log_eps)
        fresh = random_position(gen, c, dim, q.dtype, q.device)
        q = torch.where(bad[:, None], fresh, q_opt)
        pen = pen * 2.0
    # after the retries keep the positions and let divergences cope
    return WarmupState(z=evaluate(potential, q), metric=state.metric,
                       log_eps=state.log_eps)


def run_stepsize_search(gen: torch.Generator, potential: Callable,
                        stage: InitialStepsizeSearch, state: WarmupState,
                        pooled: bool = False) -> WarmupState:
    """Momentum refresh and the bracket/bisect search; ``pooled`` collapses
    the per-chain step sizes to their geometric mean."""
    p = sample_momentum(state.metric, gen, state.z.q.shape, state.z.q.dtype)
    eps = find_initial_stepsize(stage, potential, state.metric,
                                PhasePoint(Q=state.z, p=p))
    log_eps = torch.log(eps)
    if pooled:
        log_eps = torch.mean(log_eps)
    return WarmupState(z=state.z, metric=state.metric, log_eps=log_eps)


def _one_transition(gen: torch.Generator, z: EvalPoint, eps, *,
                    metric: Metric, potential: Callable, algorithm: NUTS,
                    fused_trans: Optional[Callable],
                    fused_step: Optional[Callable]):
    """One NUTS transition: through the whole-tree transition when there is
    one, else the lockstep tree (with the fused leapfrog as its ``step_fn``
    when there is one).  The single definition shared by the tuning and the
    sampling loops."""
    if fused_trans is not None:
        return fused_trans(gen, z, eps)
    return nuts_transition(gen, potential, metric, z, eps,
                           max_depth=algorithm.max_depth,
                           min_delta=algorithm.min_delta, step_fn=fused_step)


def _fused(state: WarmupState, step_factory: Optional[Callable],
           transition_factory: Optional[Callable]):
    """The window's fused step and whole-tree transition, built from its
    metric."""
    fused_step = (step_factory(state.metric)
                  if step_factory is not None else None)
    fused_trans = (transition_factory(state.metric, state.z.q.shape[0])
                   if transition_factory is not None else None)
    return dict(metric=state.metric, fused_step=fused_step,
                fused_trans=fused_trans)


class TuningResult(NamedTuple):
    state: WarmupState
    draws: torch.Tensor    # [N, C, D]
    stats: TreeStats       # [N, C] fields
    eps_log: torch.Tensor  # [N] or [N, C] step sizes used


def _stack_stats(stats) -> TreeStats:
    return TreeStats(*(torch.stack(f) for f in zip(*stats)))


def run_tuning(gen: torch.Generator, potential: Callable, stage: TuningNUTS,
               algorithm: NUTS, state: WarmupState,
               pooled: bool = False,
               step_factory: Optional[Callable] = None,
               transition_factory: Optional[Callable] = None) -> TuningResult:
    """One tuning window: ``stage.n`` NUTS transitions with a dual-averaging
    update after each, then the optional metric re-estimate from the
    window's draws."""
    if state.log_eps is None:
        raise ValueError("TuningNUTS requires an initial eps")
    n = stage.n
    adapting = isinstance(stage.stepsize_adaptation, DualAveraging)
    eps0 = torch.exp(state.log_eps)
    da = da_init(stage.stepsize_adaptation, eps0) if adapting else None
    z = state.z
    draws = torch.empty((n,) + tuple(z.q.shape), dtype=z.q.dtype,
                        device=z.q.device)
    stats, eps_log = [], []
    kw = _fused(state, step_factory, transition_factory)
    for i in range(n):
        eps = da_current_eps(da) if adapting else eps0
        z, st = _one_transition(gen, z, eps, potential=potential,
                                algorithm=algorithm, **kw)
        if adapting:
            a = st.acceptance_rate
            da = da_update(stage.stepsize_adaptation, da,
                           torch.mean(a) if pooled else a)
        draws[i] = z.q
        stats.append(st)
        eps_log.append(eps)
    return TuningResult(
        state=finalize_tuning(stage, state, z, da, draws, pooled),
        draws=draws, stats=_stack_stats(stats), eps_log=torch.stack(eps_log))


def finalize_tuning(stage: TuningNUTS, state: WarmupState, z: EvalPoint, da,
                    draws: torch.Tensor, pooled: bool = False) -> WarmupState:
    """Close a tuning window: the final eps from the dual-averaging state and
    the metric re-estimate over the window's draws ``[N, C, D]``."""
    metric = state.metric
    if stage.metric == "diag":
        metric = estimate_diag_metric(draws, stage.lam_value, pooled=pooled)
    elif stage.metric == "dense":
        metric = estimate_dense_metric(draws, stage.lam_value, pooled=pooled)
    log_eps = torch.log(da_final_eps(da)) if da is not None else state.log_eps
    return WarmupState(z=z, metric=metric, log_eps=log_eps)


class SamplingResult(NamedTuple):
    z: EvalPoint
    draws: torch.Tensor   # [N, C, D]
    stats: TreeStats      # [N, C]


def run_sampling(gen: torch.Generator, potential: Callable, algorithm: NUTS,
                 state: WarmupState, n_draws: int,
                 step_factory: Optional[Callable] = None,
                 transition_factory: Optional[Callable] = None
                 ) -> SamplingResult:
    """The post-warmup loop: fixed eps and metric, ``n_draws`` transitions,
    positions and tree statistics recorded."""
    eps = torch.exp(state.log_eps)
    z = state.z
    draws = torch.empty((n_draws,) + tuple(z.q.shape), dtype=z.q.dtype,
                        device=z.q.device)
    stats = []
    kw = _fused(state, step_factory, transition_factory)
    for i in range(n_draws):
        z, st = _one_transition(gen, z, eps, potential=potential,
                                algorithm=algorithm, **kw)
        draws[i] = z.q
        stats.append(st)
    return SamplingResult(z=z, draws=draws, stats=_stack_stats(stats))
