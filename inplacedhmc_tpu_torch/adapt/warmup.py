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
rebuilds the closure.  A whole-tree transition built with ``padded_io``
carries a :class:`SweepRunner`, and the sampling loop then runs its kernel's
persistent padded loop, ``n_sweep`` transitions per launch.  Not ported
yet: streamed metric moments, chunked tuning windows, work-sorted
scheduling and split-moment sampling.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..config import (DualAveraging, FindLocalOptimum, InitialStepsizeSearch,
                      NUTS, TuningNUTS)
from ..core.hamiltonian import evaluate
from ..core.metric import (Metric, estimate_dense_metric, estimate_diag_metric,
                           identity_metric, sample_momentum)
from ..core.state import EvalPoint, PhasePoint, TreeStats, WarmupState
from ..nuts.tree import nuts_transition
from ..ops.common import chain_tiles
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
    draws: torch.Tensor   # [N, C, D] (or [N, C, len(keep_dims)])
    stats: TreeStats      # [N, C]


class SweepRunner(NamedTuple):
    """Sweep metadata a transition factory attaches (as ``_sweep``) to the
    per-transition function when the whole-tree kernel was built with
    ``padded_io``: :func:`run_sampling` then drives the persistent padded
    loop instead of the per-transition path."""

    run_padded: Callable   # (gen, q_pad, eps_col, valid_col) -> (q, lp, g, st)
    n_sweep: int           # transitions per kernel launch
    block_c: int           # chain tile: C is padded up to a multiple of it


def _run_sampling_swept(gen: torch.Generator, potential: Callable,
                        state: WarmupState, n_draws: int, sweep: SweepRunner,
                        thin: int, kd: Optional[torch.Tensor]
                        ) -> SamplingResult:
    """Sampling through the kernel's padded persistent loop: the state is one
    ``[cpad, D]`` block, and each launch runs ``n_sweep`` sequential
    transitions from it; the last transition of its draws is the next
    launch's start.  Semantics match the per-transition path: with
    ``thin``, every ``thin``-th transition's draw and stats are recorded.
    Between launches the loop only copies the recorded rows out of the
    launch's buffers."""
    q = state.z.q
    c, dim = q.shape
    dev = q.device
    dt = torch.float32 if dev.type == "cuda" else q.dtype
    cpad, _ = chain_tiles(c, sweep.block_c)
    k = sweep.n_sweep
    kr = k // thin                       # draws recorded per launch
    n_launch = (n_draws * thin) // k

    eps = torch.exp(state.log_eps).to(dt)
    eps_col = torch.zeros((cpad,), dtype=dt, device=dev)
    eps_col[:c] = eps.expand(c)
    valid_col = torch.zeros((cpad,), dtype=torch.int32, device=dev)
    valid_col[:c] = 1
    q_pad = torch.zeros((cpad, dim), dtype=dt, device=dev)
    q_pad[:c] = q
    n_rec = dim if kd is None else kd.numel()
    draws = torch.empty((n_draws, c, n_rec), dtype=q.dtype, device=dev)
    stats = TreeStats(*(torch.empty((n_draws, c), dtype=dtype, device=dev)
                        for dtype in (q.dtype, q.dtype) + (torch.int32,) * 5))
    for i in range(n_launch):
        q_draws, _, _, st = sweep.run_padded(gen, q_pad, eps_col, valid_col)
        rows = slice(i * kr, (i + 1) * kr)
        rec = q_draws[thin - 1::thin, :c]
        draws[rows] = rec if kd is None else rec.index_select(2, kd)
        for dst, src in zip(stats, st):
            dst[rows] = src[thin - 1::thin, :c]
        q_pad = q_draws[-1]
    # logp and grad of the final state, once: the loop carries q only (a
    # copy: q_pad is a view of the runner's buffers)
    z = evaluate(potential, q_pad[:c].to(q.dtype, copy=True))
    return SamplingResult(z=z, draws=draws, stats=stats)


def run_sampling(gen: torch.Generator, potential: Callable, algorithm: NUTS,
                 state: WarmupState, n_draws: int,
                 step_factory: Optional[Callable] = None,
                 transition_factory: Optional[Callable] = None,
                 thin: int = 1,
                 keep_dims: Optional[Sequence[int]] = None
                 ) -> SamplingResult:
    """The post-warmup loop: fixed eps and metric, ``n_draws`` recorded
    transitions.  ``thin > 1`` runs ``thin`` transitions per recorded draw
    (keeping the last, with its statistics); ``keep_dims`` records only
    those coordinates (the state still advances in every one).

    When the whole-tree transition carries a :class:`SweepRunner` and the
    loop divides evenly (``n_sweep % thin == 0`` and ``n_draws * thin %
    n_sweep == 0``), the loop runs ``n_sweep`` transitions per launch on a
    padded persistent state; otherwise one transition at a time."""
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    eps = torch.exp(state.log_eps)
    z = state.z
    kd = None if keep_dims is None else torch.as_tensor(
        list(keep_dims), dtype=torch.int64, device=z.q.device)
    kw = _fused(state, step_factory, transition_factory)
    sweep = getattr(kw["fused_trans"], "_sweep", None)
    if (sweep is not None and sweep.n_sweep % thin == 0
            and (n_draws * thin) % sweep.n_sweep == 0):
        return _run_sampling_swept(gen, potential, state, n_draws, sweep,
                                   thin, kd)
    n_rec = z.q.shape[1] if kd is None else kd.numel()
    draws = torch.empty((n_draws, z.q.shape[0], n_rec), dtype=z.q.dtype,
                        device=z.q.device)
    stats = []
    for i in range(n_draws):
        for _ in range(thin):
            z, st = _one_transition(gen, z, eps, potential=potential,
                                    algorithm=algorithm, **kw)
        draws[i] = z.q if kd is None else z.q.index_select(1, kd)
        stats.append(st)
    return SamplingResult(z=z, draws=draws, stats=_stack_stats(stats))
