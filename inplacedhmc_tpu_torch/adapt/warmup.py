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
persistent padded loop, ``n_sweep`` transitions per launch.

A ``post_step(gen, z) -> z`` hook (a posterior-invariant kernel such as
``models/stoch_vol.py::make_asis_hook``) runs after every transition of the
tuning and sampling loops.  A window with ``TuningNUTS.stream`` carries
:class:`StreamMoments` instead of its draws; :func:`run_tuning_chunk` runs
part of a window with the dual-averaging and moment carries passed in and
out (``sample.py``'s ``tuning_chunk``), and :func:`finalize_tuning`
closes it.  The sampling loop can accumulate :class:`SplitMoments`, each
chain's two halves' sums over every coordinate, for split R-hat without
stored draws.
Not ported yet: work-sorted scheduling.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..config import (DualAveraging, FindLocalOptimum, InitialStepsizeSearch,
                      NUTS, TuningNUTS)
from ..core.hamiltonian import evaluate
from ..core.metric import (Metric, dense_metric, diag_metric,
                           estimate_dense_metric, estimate_diag_metric,
                           identity_metric, moments_cov, moments_variance,
                           sample_momentum)
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
                    fused_step: Optional[Callable],
                    post_step: Optional[Callable] = None):
    """One NUTS transition: through the whole-tree transition when there is
    one, else the lockstep tree (with the fused leapfrog as its ``step_fn``
    when there is one); then the ``post_step`` hook, on the same generator.
    The single definition shared by the tuning and the sampling loops."""
    if fused_trans is not None:
        z2, stats = fused_trans(gen, z, eps)
    else:
        z2, stats = nuts_transition(gen, potential, metric, z, eps,
                                    max_depth=algorithm.max_depth,
                                    min_delta=algorithm.min_delta,
                                    step_fn=fused_step)
    if post_step is not None:
        z2 = post_step(gen, z2)
    return z2, stats


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


class StreamMoments(NamedTuple):
    """Running moments of a tuning window, centred on the window-start mean
    position so that the one-pass form stays safe
    (``core/metric.py::moments_variance``)."""

    qref: torch.Tensor   # [D] centre
    cnt: torch.Tensor    # scalar: draws so far
    s1: torch.Tensor     # [D] sum of the centred draws
    s2: torch.Tensor     # [D] (diag) or [D, D] (dense) sums of squares


def _streams(stage: TuningNUTS) -> bool:
    return bool(stage.stream and stage.metric is not None)


def init_stream_moments(stage: TuningNUTS,
                        z: EvalPoint) -> Optional[StreamMoments]:
    """Empty moments centred on the mean of ``z.q``, or ``None`` when the
    window does not stream."""
    if not _streams(stage):
        return None
    q = z.q
    d = q.shape[-1]
    kw = dict(dtype=q.dtype, device=q.device)
    s2 = torch.zeros((d,) if stage.metric == "diag" else (d, d), **kw)
    return StreamMoments(qref=torch.mean(q, dim=0), cnt=torch.zeros((), **kw),
                         s1=torch.zeros((d,), **kw), s2=s2)


def _update_moments(mom: Optional[StreamMoments], stage: TuningNUTS,
                    q: torch.Tensor) -> Optional[StreamMoments]:
    """The moments with the draws ``q [C, D]`` added.  The dense Gram
    ``c^T c`` is one plain product (IEEE float32 under the entry points'
    ``f32_matmuls``)."""
    if mom is None:
        return None
    c = q - mom.qref
    s1 = mom.s1 + torch.sum(c, dim=0)
    if stage.metric == "diag":
        s2 = mom.s2 + torch.sum(c * c, dim=0)
    else:
        s2 = mom.s2 + c.transpose(0, 1) @ c
    return mom._replace(cnt=mom.cnt + q.shape[0], s1=s1, s2=s2)


def _metric_from_moments(stage: TuningNUTS, mom: StreamMoments,
                         lam=None) -> Metric:
    """The window's metric from its moments; ``lam`` overrides
    ``stage.lam_value``."""
    lam = stage.lam_value if lam is None else lam
    if stage.metric == "diag":
        return diag_metric(moments_variance(mom.cnt, mom.s1, mom.s2, lam))
    return dense_metric(moments_cov(mom.cnt, mom.s1, mom.s2, lam))


class TuningChunkResult(NamedTuple):
    z: EvalPoint
    da: Optional[tuple]            # dual-averaging carry (None: not adapting)
    draws: Optional[torch.Tensor]  # [n, C, D]; None when the window streams
    stats: TreeStats
    eps_log: torch.Tensor
    mom: Optional[StreamMoments] = None   # streamed-moment carry


def _stack_stats(stats) -> TreeStats:
    return TreeStats(*(torch.stack(f) for f in zip(*stats)))


def cat_stats(parts) -> TreeStats:
    """Tree statistics of consecutive parts, joined along the draws."""
    return TreeStats(*(torch.cat(f, dim=0) for f in zip(*parts)))


def init_dual_averaging(stage: TuningNUTS, state: WarmupState):
    """The window's dual-averaging carry, or ``None`` when it does not
    adapt the step size."""
    if state.log_eps is None:
        raise ValueError("TuningNUTS requires an initial eps")
    if not isinstance(stage.stepsize_adaptation, DualAveraging):
        return None
    return da_init(stage.stepsize_adaptation, torch.exp(state.log_eps))


def run_tuning_chunk(gen: torch.Generator, potential: Callable,
                     stage: TuningNUTS, algorithm: NUTS, state: WarmupState,
                     da, n: int, pooled: bool = False,
                     step_factory: Optional[Callable] = None,
                     transition_factory: Optional[Callable] = None,
                     mom: Optional[StreamMoments] = None,
                     post_step: Optional[Callable] = None
                     ) -> TuningChunkResult:
    """``n`` transitions of a tuning window from ``state.z``, with the
    dual-averaging carry ``da`` (``init_dual_averaging``) and, for a
    streaming window, the moments ``mom`` passed in and out; each
    transition is followed by ``post_step``.  The window's metric is
    estimated once, by :func:`finalize_tuning`.  One generator drawn in
    order: a window run in chunks draws what it draws in one piece."""
    eps0 = torch.exp(state.log_eps)
    z = state.z
    draws = None if _streams(stage) else torch.empty(
        (n,) + tuple(z.q.shape), dtype=z.q.dtype, device=z.q.device)
    stats, eps_log = [], []
    kw = _fused(state, step_factory, transition_factory)
    for i in range(n):
        eps = da_current_eps(da) if da is not None else eps0
        z, st = _one_transition(gen, z, eps, potential=potential,
                                algorithm=algorithm, post_step=post_step,
                                **kw)
        if da is not None:
            a = st.acceptance_rate
            da = da_update(stage.stepsize_adaptation, da,
                           torch.mean(a) if pooled else a)
        mom = _update_moments(mom, stage, z.q)
        if draws is not None:
            draws[i] = z.q
        stats.append(st)
        eps_log.append(eps)
    return TuningChunkResult(z=z, da=da, draws=draws,
                             stats=_stack_stats(stats),
                             eps_log=torch.stack(eps_log), mom=mom)


def finalize_tuning(stage: TuningNUTS, state: WarmupState, z: EvalPoint, da,
                    draws: Optional[torch.Tensor], pooled: bool = False,
                    mom: Optional[StreamMoments] = None) -> WarmupState:
    """Close a tuning window: the final eps from the dual-averaging state and
    the metric re-estimate over the window's draws ``[N, C, D]``, or for a
    streaming window from its moments ``mom``."""
    metric = state.metric
    if _streams(stage):
        metric = _metric_from_moments(stage, mom)
    elif stage.metric == "diag":
        metric = estimate_diag_metric(draws, stage.lam_value, pooled=pooled)
    elif stage.metric == "dense":
        metric = estimate_dense_metric(draws, stage.lam_value, pooled=pooled)
    log_eps = torch.log(da_final_eps(da)) if da is not None else state.log_eps
    return WarmupState(z=z, metric=metric, log_eps=log_eps)


class SplitMoments(NamedTuple):
    """Split-chain moments accumulated while sampling: enough for split
    R-hat over every coordinate without the ``[N, C, D]`` draws.  Each
    half's sums are centred on the chain's sampling-start position."""

    qref: torch.Tensor   # [C, D] per-chain centre
    cnt: torch.Tensor    # [2] draws per half
    s1: torch.Tensor     # [2, C, D] sum (q - qref)
    s2: torch.Tensor     # [2, C, D] sum (q - qref)^2


def init_split_moments(q: torch.Tensor) -> SplitMoments:
    c, d = q.shape
    kw = dict(dtype=q.dtype, device=q.device)
    return SplitMoments(qref=q.clone(), cnt=torch.zeros((2,), **kw),
                        s1=torch.zeros((2, c, d), **kw),
                        s2=torch.zeros((2, c, d), **kw))


def _copy_split(mom: Optional[SplitMoments]) -> Optional[SplitMoments]:
    """The moments' sums copied, for a loop that adds to them in place (the
    centre is shared)."""
    if mom is None:
        return None
    return mom._replace(cnt=mom.cnt.clone(), s1=mom.s1.clone(),
                        s2=mom.s2.clone())


def _add_split_(mom: SplitMoments, rec: torch.Tensor, first: int,
                total: int) -> None:
    """Add the recorded draws ``rec [n, C, D]`` to ``mom`` in place: the
    draw of index ``first + i`` of the run (of ``total`` draws) goes to the
    second half when ``first + i >= total // 2``."""
    n = rec.shape[0]
    n_lo = min(max(total // 2 - first, 0), n)
    c = rec.to(mom.qref.dtype) - mom.qref
    for half, part in ((0, c[:n_lo]), (1, c[n_lo:])):
        if part.shape[0]:
            mom.cnt[half] += part.shape[0]
            mom.s1[half] += torch.sum(part, dim=0)
            mom.s2[half] += torch.sum(part * part, dim=0)


class SamplingResult(NamedTuple):
    z: EvalPoint
    draws: torch.Tensor   # [N, C, D] (or [N, C, len(keep_dims)])
    stats: TreeStats      # [N, C]
    moments: Optional[SplitMoments] = None


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
                        thin: int, kd: Optional[torch.Tensor],
                        mom: Optional[SplitMoments], moment_offset: int,
                        total: int) -> SamplingResult:
    """Sampling through the kernel's padded persistent loop: the state is one
    ``[cpad, D]`` block, and each launch runs ``n_sweep`` sequential
    transitions from it; the last transition of its draws is the next
    launch's start.  Semantics match the per-transition path: with
    ``thin``, every ``thin``-th transition's draw and stats are recorded,
    and split moments ``mom`` (a copy, added to in place) take every
    recorded draw over all coordinates, in the same halves.  Between
    launches the loop only copies the recorded rows out of the launch's
    buffers."""
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
        if mom is not None:
            _add_split_(mom, rec, moment_offset + i * kr, total)
        q_pad = q_draws[-1]
    # logp and grad of the final state, once: the loop carries q only (a
    # copy: q_pad is a view of the runner's buffers)
    z = evaluate(potential, q_pad[:c].to(q.dtype, copy=True))
    return SamplingResult(z=z, draws=draws, stats=stats, moments=mom)


def run_sampling(gen: torch.Generator, potential: Callable, algorithm: NUTS,
                 state: WarmupState, n_draws: int,
                 step_factory: Optional[Callable] = None,
                 transition_factory: Optional[Callable] = None,
                 thin: int = 1,
                 keep_dims: Optional[Sequence[int]] = None,
                 post_step: Optional[Callable] = None,
                 moments0: Optional[SplitMoments] = None,
                 moment_offset: int = 0,
                 moment_total: Optional[int] = None) -> SamplingResult:
    """The post-warmup loop: fixed eps and metric, ``n_draws`` recorded
    transitions, each followed by ``post_step``.  ``thin > 1`` runs
    ``thin`` transitions per recorded draw (keeping the last, with its
    statistics); ``keep_dims`` records only those coordinates (the state
    still advances in every one).  ``moments0`` (:class:`SplitMoments`)
    accumulates every recorded draw over all coordinates into the returned
    ``moments``; ``moment_offset`` and ``moment_total`` (default
    ``n_draws``) place this call's draws inside the whole run, so that a
    run sampled in blocks splits its halves where one piece would.

    When the whole-tree transition carries a :class:`SweepRunner`, there is
    no ``post_step`` (a hook acts between transitions) and the loop divides
    evenly (``n_sweep % thin == 0`` and ``n_draws * thin % n_sweep == 0``),
    the loop runs ``n_sweep`` transitions per launch on a padded persistent
    state; otherwise one transition at a time."""
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    eps = torch.exp(state.log_eps)
    z = state.z
    total = n_draws if moment_total is None else moment_total
    mom = _copy_split(moments0)
    kd = None if keep_dims is None else torch.as_tensor(
        list(keep_dims), dtype=torch.int64, device=z.q.device)
    kw = _fused(state, step_factory, transition_factory)
    sweep = getattr(kw["fused_trans"], "_sweep", None)
    if (sweep is not None and post_step is None and sweep.n_sweep % thin == 0
            and (n_draws * thin) % sweep.n_sweep == 0):
        return _run_sampling_swept(gen, potential, state, n_draws, sweep,
                                   thin, kd, mom, moment_offset, total)
    n_rec = z.q.shape[1] if kd is None else kd.numel()
    draws = torch.empty((n_draws, z.q.shape[0], n_rec), dtype=z.q.dtype,
                        device=z.q.device)
    stats = []
    for i in range(n_draws):
        for _ in range(thin):
            z, st = _one_transition(gen, z, eps, potential=potential,
                                    algorithm=algorithm, post_step=post_step,
                                    **kw)
        draws[i] = z.q if kd is None else z.q.index_select(1, kd)
        if mom is not None:
            _add_split_(mom, z.q[None], moment_offset + i, total)
        stats.append(st)
    return SamplingResult(z=z, draws=draws, stats=_stack_stats(stats),
                          moments=mom)
