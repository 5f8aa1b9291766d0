"""High-level sampling drivers.

The port's counterpart of ``inplacedhmc_tpu/sample.py``:

* :class:`NUTSKernel` holds one (model, algorithm, adaptation) configuration
  and picks the kernels by ``use_pallas``, with the JAX package's meanings
  (``inplacedhmc_tpu/sample.py:258-268, 297-316``).  ``"auto"`` (the
  default) is JAX's "auto" policy: the fused logistic potential for
  ``structure["kind"] == "logistic"``; for ``"diag_gaussian"`` the
  whole-tree kernel where it takes the problem and the lockstep tree with
  the fused Gaussian leapfrog elsewhere; for ``"dense_gaussian"`` (``mvn``)
  and ``"tile_logp"`` models whose physics has a device function (eight
  schools, the funnel, stochastic volatility) the whole-tree kernel where
  it takes the problem and autograd on the lockstep tree elsewhere;
  autograd of ``model.logp`` otherwise.  ``"tree"`` forces the whole-tree
  kernel wherever the metric qualifies, from one chain, and adds logistic
  regression to its kinds;
  ``"on"`` runs the fused potential and leapfrog and no whole tree;
  ``"off"`` autograd on the lockstep tree.  The whole-tree kernel takes one
  shared float32 metric, diagonal or dense.
* :func:`mcmc_with_warmup` runs the windowed warmup, then sampling.
* :func:`sample` is the pooled-adaptation entry point.

Every entry point takes ``device=`` (``"cuda"`` by default; the CPU only when
the caller asks for it) and a seed or a ``torch.Generator`` on that device;
no global RNG state is used.

``thin`` and ``keep_dims`` thin the recorded draws and keep some of their
coordinates.  ``tree_opts`` configure the whole-tree kernel as in the JAX
package: ``refresh_inside`` (the kernel draws the momentum and the
directions), ``padded_io`` (the sampling loop runs the kernel's persistent
padded state; implies ``refresh_inside``), ``n_sweep`` (transitions per
launch while sampling) and ``block_c`` (the chain tile the state is padded
to); for logistic regression also ``physics_mode`` (``"chunked"`` or
``"vjp"``: both run the one hand-written physics, which computes the
function of both), ``grad_bf16`` (read under ``"chunked"`` only, as in
JAX) and ``block_n``
(``ops/tree.py::make_logistic_tree_transition``).  A route that runs no
whole tree ignores them, as in JAX.

``ckpt_bf16`` stores the kernel's two checkpoint stacks in bfloat16 (the
turn checks read the rounded values), halving their shared memory.

``fused_opts`` reach the fused logistic potential on the routes that run it
(``use_pallas`` ``"auto"`` and ``"on"``), as in JAX: ``fwd_precision``,
``bwd_precision``, ``grad_bf16``, ``block_c`` and ``block_n``, checked as
JAX checks them; ``fwd_precision="packed"`` runs K2, the packed split-bf16
forward (``ops/logistic.py::make_logistic_potential`` says how each maps to
the card).  Other models and routes ignore them, as in JAX.

``post_step(gen, z) -> z`` runs after every transition of the warmup and
sampling loops (``models/stoch_vol.py::make_asis_hook``);
``tuning_chunk`` runs each tuning window in pieces of at most that many
transitions (the metric estimated once per window, from its draws or from
its streamed moments under ``TuningNUTS.stream``); ``draw_block`` samples
in blocks of at most that many draws; ``collect_moments`` accumulates
split-chain moments over every coordinate (``MCMCResult.sample_moments``,
for ``diagnostics.split_rhat_from_moments``); ``sync_blocks`` fetches one
small value after every chunk and block (:func:`value_fence`).

Not ported yet, and refused with ``NotImplementedError``: meshes,
checkpoints, sketches, ``store_draws``, work-sorted scheduling, the
option ``use_kernels``, ``use_pallas="interpret"``
(JAX's Pallas interpreter: on a CPU tensor the port runs its plain
versions already), the whole tree where its kernel does not take the
problem (``ops.tree.takes``: above D = 256 for eight schools, the funnel
and logistic regression, above 2,048 or past the shared-memory bound for
the others), and ``tree_opts`` on tile physics without a device
function.  The whole-tree kernel is ported, with a
diagonal and a dense metric, for ``diag_gaussian``, ``dense_gaussian`` and
``logistic`` models and the ``"eight_schools"``, ``"funnel"`` and
``"stoch_vol"`` tile physics; the Gaussian, the dense Gaussian and
stochastic volatility run it above D = 256 too (one chain per block of
warps).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .adapt import warmup as W
from .config import (DualAveraging, FindLocalOptimum, InitialStepsizeSearch,
                     NUTS, StepsizeCollapseError, TuningNUTS,
                     default_warmup_stages)
from .core.hamiltonian import batched_logdensity_and_grad
from .core.metric import DenseMetric, DiagMetric, Metric
from .core.state import Termination, TreeStats, WarmupState
from .models.base import Model
from .ops.leapfrog import make_fused_gaussian_leapfrog
from .ops.logistic import make_logistic_potential
from .ops.tile_physics import PHYSICS, logistic_data
from .ops.tree import LOGISTIC_BLOCK_C
from .ops.tree import make_tree_transition
from .ops.tree import refusal as tree_refusal
from .ops.tree import takes as tree_takes

#: ``tree_opts`` keys of the whole-tree kernel (``inplacedhmc_tpu/sample.py``)
TREE_OPTS = ("block_c", "ckpt_bf16", "refresh_inside", "padded_io", "n_sweep")
#: the ``tree_opts`` of the logistic physics alone (JAX's ``_by_kind``)
LOGISTIC_TREE_OPTS = ("physics_mode", "grad_bf16", "block_n")
#: the model kinds each ``use_pallas`` sends to the whole tree (JAX's
#: ``auto_kinds`` and ``tree_kinds``, ``inplacedhmc_tpu/sample.py:308-316``)
TREE_KINDS = {"auto": ("diag_gaussian", "dense_gaussian", "tile_logp"),
              "tree": ("diag_gaussian", "dense_gaussian", "tile_logp",
                       "logistic")}
#: the values of ``use_pallas``
USE_PALLAS = ("auto", "on", "tree", "off", "interpret")
#: model kinds with a whole-tree kernel in the JAX package that the port
#: runs only where it has a device function (``"tile_logp"``: JAX
#: differentiates any ``tile_logp`` in its kernel, the port writes each
#: physics out by hand), with what a model of that kind lacks
_TREE_NOT_PORTED = {"tile_logp": "the port has no hand-written device "
                                 "function of this physics in "
                                 "ops/tile_physics.py and csrc/"}


class MCMCResult(NamedTuple):
    """Chain output: ``draws`` is ``[n_draws, n_chains, dim]``; ``stats`` are
    per-transition :class:`TreeStats` (``[n_draws, n_chains]`` fields);
    ``warmup_state`` holds the adapted metric and eps; ``sample_moments``
    the split-chain moments over every coordinate when the run asked for
    ``collect_moments`` (for ``diagnostics.split_rhat_from_moments``)."""

    draws: torch.Tensor
    stats: TreeStats
    warmup_state: WarmupState
    warmup_stats: Optional[TreeStats] = None
    sample_moments: Optional[W.SplitMoments] = None


class NoProgressReport:
    """Silent reporter.  A reporter gets ``start_stage(name, total_steps)``
    and ``end_stage(**info)`` around every warmup stage and the sampling
    loop."""

    def start_stage(self, name: str, total_steps: int = 0):
        pass

    def end_stage(self, **info):
        pass


def value_fence(x) -> float:
    """Wait for ``x`` (a tensor, or an ``EvalPoint``: its ``logp``) by
    fetching its sum: the fence of ``sync_blocks``, one small copy to the
    host, so that at most one block's work is queued at a time."""
    x = getattr(x, "logp", x)
    return float(torch.sum(x))


@contextlib.contextmanager
def f32_matmuls():
    """Run with TF32 off for matmuls and cuDNN.  The dense metric's q-update
    (p#), the kinetic energy and the log density must stay f32-grade
    (docs/DESIGN.md sections 13-14.1: a 1-pass product there collapsed dual
    averaging); TF32 keeps about three decimal digits.  Set inside the entry
    points and restored after, never globally at import."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def make_generator(seed: Union[int, torch.Generator],
                   device="cuda") -> torch.Generator:
    """A generator on ``device``: ``seed`` itself when it is one (it must
    live on ``device``), else a new one seeded with it."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(f"generator on {seed.device}, run on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


#: sanity bounds on the tuned step size, checked at every window boundary
EPS_COLLAPSE_MIN = 1e-10
EPS_SANE_MAX = 1e10


def _check_eps_sane(log_eps, where: str, stats: Optional[TreeStats] = None):
    """Raise :class:`StepsizeCollapseError` when eps left the sane range, with
    the window's acceptance and divergence summary."""
    eps = torch.exp(torch.atleast_1d(log_eps))
    lo, hi = float(eps.min()), float(eps.max())
    if math.isfinite(lo) and math.isfinite(hi) \
            and lo >= EPS_COLLAPSE_MIN and hi <= EPS_SANE_MAX:
        return
    detail = ""
    if stats is not None:
        acc = stats.acceptance_rate
        div = (stats.termination == Termination.DIVERGENCE).float().mean()
        detail = (f"; window acceptance mean={float(acc.mean()):.4g} "
                  f"min={float(acc.min()):.4g}, "
                  f"divergent fraction={float(div):.4g}")
    raise StepsizeCollapseError(
        f"step size out of sane bounds after {where}: eps in "
        f"[{lo:.3g}, {hi:.3g}] (allowed [{EPS_COLLAPSE_MIN:g}, "
        f"{EPS_SANE_MAX:g}]){detail}")


def _tree_physics(st: Optional[dict], use_pallas: str = "auto",
                  logistic_opts: Optional[dict] = None):
    """``(physics, data)`` of the model's whole-tree kernel on the route
    ``use_pallas`` takes: the Gaussian for ``"diag_gaussian"``, the dense
    Gaussian for ``"dense_gaussian"``, the named physics for a
    ``"tile_logp"`` model whose physics has a device function (its rows and
    scalars in one dict), and under ``"tree"`` logistic regression's
    physics on the padded data (``logistic_opts``: its ``tree_opts``);
    ``None`` for every other model and route."""
    kind = None if st is None else st.get("kind")
    if kind not in TREE_KINDS.get(use_pallas, ()):
        return None
    if kind == "logistic":
        return "logistic", logistic_data(st["x"], st["y"], st["inv_var"],
                                         **(logistic_opts or {}))
    if kind == "diag_gaussian":
        return "gaussian", {"lam": st["precision"]}
    if kind == "dense_gaussian":
        return "dense_gaussian", {"prec": st["precision"]}
    if kind == "tile_logp" and st.get("physics") in PHYSICS:
        return st["physics"], {**st["data"], **st.get("scalars", {})}
    return None


def _f32_diag(metric: Metric) -> bool:
    """One shared float32 diagonal metric: what the fused leapfrog takes."""
    return (isinstance(metric, DiagMetric) and metric.inv.ndim == 1
            and metric.inv.dtype == torch.float32)


def _f32_shared(metric: Metric) -> bool:
    """One shared float32 metric, diagonal ``[D]`` or dense ``[D, D]``: what
    the whole-tree kernel takes (JAX ``sample.py:364-370``)."""
    return _f32_diag(metric) or (isinstance(metric, DenseMetric)
                                 and metric.inv.ndim == 2
                                 and metric.inv.dtype == torch.float32)


class NUTSKernel:
    """Sampling for one (model, algorithm, adaptation) configuration.

    The kernels follow ``use_pallas`` as in the JAX package
    (``inplacedhmc_tpu/sample.py:258-268``); each wrapper runs its CUDA
    kernel on the card and its plain version on the CPU.  ``"auto"`` (the
    default) is JAX's "auto" policy:

    * ``structure["kind"] == "logistic"``: the fused potential
      (``ops/logistic.py``, with ``fused_opts``) on the lockstep tree;
    * ``"diag_gaussian"``: with a shared float32 metric (diagonal or
      dense), the whole-tree transition (``ops/tree.py``, Gaussian physics)
      when there are at least ``TREE_MIN_CHAINS`` chains and the kernel
      takes the problem (``ops.tree.takes``: the dimension, and above
      D = 256 the shared memory at ``max_depth``); else, with a shared
      float32 diagonal metric, the lockstep tree with the fused Gaussian
      leapfrog
      (``ops/leapfrog.py``) as its ``step_fn``, and autograd on the lockstep
      tree otherwise;
    * ``"dense_gaussian"`` (``mvn``), and ``"tile_logp"`` whose ``physics``
      has a device function (``ops/tile_physics.py``: eight schools, the
      funnel, stochastic volatility; ``csrc/tree_<physics>.cu``): with a
      shared float32 metric, diagonal or dense, the whole-tree transition
      with that physics from ``TREE_MIN_CHAINS_BY_PHYSICS[physics]``
      chains where the kernel takes the problem, else autograd of
      ``model.logp`` on the lockstep tree;
    * any other model: autograd of ``model.logp``.

    ``"tree"`` forces the whole-tree transition wherever the metric
    qualifies (a shared float32 metric), from one chain, for those kinds
    and for ``"logistic"`` (the ``logistic`` physics,
    ``csrc/tree_logistic.cu``), with autograd of ``model.logp`` as the
    potential of the warmup's other stages, as in JAX; a problem its kernel
    does not take (``ops.tree.takes``) raises ``NotImplementedError``
    naming the bound and the ROADMAP item that lifts it.  ``"on"``: the
    fused logistic potential and the fused Gaussian leapfrog, no whole
    tree.  ``"off"``:
    autograd on the lockstep tree.  ``"interpret"`` (JAX's Pallas
    interpreter) raises ``NotImplementedError``: on a CPU tensor every
    wrapper runs its plain version already.

    The factories are called once per tuning window (or chunk of one) and
    for the sampling loop (or block of it), with that stage's metric.
    ``tree_opts`` configure the whole-tree kernel; with ``padded_io`` the
    factory builds an ``n_sweep = 1`` transition for the tuning windows and
    attaches a :class:`~.adapt.warmup.SweepRunner` to it for the sampling
    loop.  ``post_step(gen, z) -> z`` runs after every transition (the
    sampling loop then takes one transition at a time).
    """

    #: chains from which a ``diag_gaussian`` model runs the whole-tree
    #: kernel.  Set from the crossover measured on the card by
    #: ``chip_smoke.py`` (PERF.md), not from the TPU's 4096: the whole tree
    #: was faster at every chain count timed, down to one chain.
    TREE_MIN_CHAINS = 1
    #: the same for each tile physics, from its own crossover against
    #: autograd on the lockstep tree (``chip_smoke.py``, PERF.md)
    TREE_MIN_CHAINS_BY_PHYSICS = {"eight_schools": 1, "funnel": 1,
                                  "dense_gaussian": 1, "stoch_vol": 1}

    def __init__(self, model: Model, algorithm: NUTS = NUTS(),
                 pooled: bool = True, tree_opts: Optional[dict] = None,
                 use_pallas: str = "auto",
                 post_step: Optional[Callable] = None,
                 fused_opts: Optional[dict] = None):
        if use_pallas == "interpret":
            raise NotImplementedError(
                "use_pallas='interpret' runs the JAX package's Pallas "
                "interpreter; inplacedhmc_tpu_torch has none: on a CPU "
                "tensor every kernel wrapper already runs its plain version "
                "(pass device='cpu')")
        if use_pallas not in USE_PALLAS:
            raise ValueError(f"unknown use_pallas {use_pallas!r} "
                             f"(have {USE_PALLAS})")
        self.model = model
        self.algorithm = algorithm
        self.pooled = pooled
        self.use_pallas = use_pallas
        self.post_step = post_step
        self.step_factory = None
        self.transition_factory = None
        st = model.structure
        kind = None if st is None else st.get("kind")
        fused = use_pallas in ("auto", "on")
        if kind == "logistic" and fused:
            self.potential = make_logistic_potential(
                st["x"], st["y"], st["inv_var"], **(fused_opts or {}))
        else:
            self.potential = batched_logdensity_and_grad(model.logp)
        topts = _tree_options(st, use_pallas, tree_opts)
        tree = _tree_physics(st, use_pallas, {
            k: topts.pop(k) for k in LOGISTIC_TREE_OPTS if k in topts})
        forced = use_pallas == "tree"
        if tree is not None:
            physics, data = tree
            bf16 = bool(topts.get("ckpt_bf16", False))
            takes = tree_takes(model.dim, algorithm.max_depth, physics, bf16)
            if forced and not takes:
                raise NotImplementedError(
                    "use_pallas='tree': " + tree_refusal(
                        model.dim, algorithm.max_depth, physics, bf16))
            # padded/sweep options drive the sampling loop only (tuning
            # adapts eps per transition, which an in-kernel sweep cannot)
            sweep_k = int(topts.pop("n_sweep", 1))
            padded = bool(topts.pop("padded_io", sweep_k > 1))
            if sweep_k > 1 and not padded:
                raise ValueError("n_sweep > 1 requires padded_io")
            if padded:
                topts["refresh_inside"] = True
            if physics == "logistic":
                topts.setdefault("block_c", LOGISTIC_BLOCK_C)

            def transition_factory(metric, n_chains):
                if not (_f32_shared(metric)
                        and (forced
                             or n_chains >= self.tree_min_chains(physics))
                        and takes):
                    return None

                def build(**extra):
                    return make_tree_transition(
                        physics, data, model.dim, metric,
                        max_depth=algorithm.max_depth,
                        min_delta=algorithm.min_delta, **topts, **extra)

                if not padded:
                    return build()
                ptrans, run_padded = build(padded_io=True, n_sweep=sweep_k)
                # a sweep-shaped transition returns stacked draws; the
                # tuning windows need the single one
                trans = ptrans if sweep_k == 1 else build()
                trans._sweep = W.SweepRunner(run_padded=run_padded,
                                             n_sweep=sweep_k,
                                             block_c=run_padded.block_c)
                return trans

            self.transition_factory = transition_factory
        if kind == "diag_gaussian" and fused:
            prec = st["precision"]

            def step_factory(metric):
                if not _f32_diag(metric):
                    return None
                step = make_fused_gaussian_leapfrog(prec, metric.inv)
                return lambda q, p, g, lp, e: step(q, p, e)

            self.step_factory = step_factory

    def tree_min_chains(self, physics: str) -> int:
        """Chains from which ``physics`` runs the whole-tree kernel."""
        return self.TREE_MIN_CHAINS_BY_PHYSICS.get(physics,
                                                   self.TREE_MIN_CHAINS)

    def warmup(self, gen: torch.Generator, state: WarmupState,
               stages: Sequence, reporter=None,
               tuning_chunk: Optional[int] = None, sync_blocks: bool = False,
               chunk_hook: Optional[Callable] = None
               ) -> Tuple[WarmupState, list]:
        """Run the stage sequence; returns the adapted state and the tuning
        windows' tree statistics.

        ``tuning_chunk`` runs each tuning window in chunks of at most that
        many transitions, with a check of the step size after each; the
        dual-averaging and streamed-moment carries thread across the
        chunks, and the metric is estimated once per window.
        ``chunk_hook(gen, z) -> z``, a posterior-invariant kernel, runs
        after every chunk (after every window without ``tuning_chunk``).
        ``sync_blocks`` fetches a small value after every chunk."""
        if tuning_chunk is not None and tuning_chunk < 1:
            raise ValueError(f"tuning_chunk must be >= 1, got {tuning_chunk}")
        reporter = reporter or NoProgressReport()
        warmup_stats = []
        for stage in stages:
            if stage is None:
                continue
            if isinstance(stage, FindLocalOptimum):
                reporter.start_stage("find local optimum")
                state = W.run_local_optimum(gen, self.potential, stage, state)
                reporter.end_stage()
            elif isinstance(stage, InitialStepsizeSearch):
                reporter.start_stage("initial stepsize search")
                state = W.run_stepsize_search(gen, self.potential, stage,
                                              state, pooled=self.pooled)
                _check_eps_sane(state.log_eps, "initial stepsize search")
                reporter.end_stage(
                    eps=float(torch.exp(torch.atleast_1d(state.log_eps))[0]))
            elif isinstance(stage, TuningNUTS):
                reporter.start_stage(
                    f"tuning {stage.n} steps"
                    + (f" + {stage.metric} metric" if stage.metric else ""),
                    stage.n)
                if state.log_eps is None:
                    raise ValueError(
                        "TuningNUTS stage needs an eps: provide `eps=` or "
                        "keep InitialStepsizeSearch in the schedule")
                state, stats = self._tuning_window(
                    gen, stage, state, tuning_chunk, sync_blocks, chunk_hook)
                warmup_stats.append(stats)
                _check_eps_sane(state.log_eps, f"tuning window ({stage.n})",
                                stats)
                reporter.end_stage(
                    eps=float(torch.exp(torch.atleast_1d(state.log_eps))[0]))
            else:
                raise TypeError(f"unknown warmup stage {stage!r}")
        return state, warmup_stats

    def _tuning_window(self, gen: torch.Generator, stage: TuningNUTS,
                       state: WarmupState, tuning_chunk, sync_blocks: bool,
                       chunk_hook):
        """One tuning window in chunks of ``tuning_chunk`` transitions (one
        chunk of ``stage.n`` without it); returns the closed window's state
        and its tree statistics."""
        fused = dict(pooled=self.pooled, step_factory=self.step_factory,
                     transition_factory=self.transition_factory,
                     post_step=self.post_step)
        step = tuning_chunk or stage.n
        da = W.init_dual_averaging(stage, state)
        mom = W.init_stream_moments(stage, state.z)
        z, done, parts = state.z, 0, []
        while done < stage.n:
            nb = min(step, stage.n - done)
            res = W.run_tuning_chunk(gen, self.potential, stage,
                                     self.algorithm, state._replace(z=z), da,
                                     nb, mom=mom, **fused)
            z, da, mom = res.z, res.da, res.mom
            if chunk_hook is not None:
                z = chunk_hook(gen, z)
            parts.append(res)
            done += nb
            if da is not None:
                # the step size checked once per chunk inside the window
                _check_eps_sane(torch.log(W.da_current_eps(da)),
                                f"tuning chunk {done}/{stage.n}", res.stats)
            if sync_blocks:
                value_fence(z)
        draws = None if parts[0].draws is None else _cat0(
            [r.draws for r in parts])
        state = W.finalize_tuning(stage, state, z, da, draws, self.pooled,
                                  mom)
        return state, W.cat_stats([r.stats for r in parts])

    def run(self, gen: torch.Generator, n_draws: int, n_chains: int = 1, *,
            warmup_stages: Optional[Sequence] = None,
            q: Optional[torch.Tensor] = None,
            metric: Optional[Metric] = None,
            eps: Optional[float] = None,
            dtype=torch.float32,
            device="cuda",
            reporter=None,
            thin: int = 1,
            keep_dims: Optional[Sequence[int]] = None,
            draw_block: Optional[int] = None,
            tuning_chunk: Optional[int] = None,
            collect_moments: bool = False,
            sync_blocks: bool = False) -> MCMCResult:
        """Warmup, then ``n_draws`` recorded draws, ``thin`` transitions
        each; ``keep_dims`` records only those coordinates.  ``draw_block``
        samples in blocks of at most that many draws (the state, and the
        moments, carried from block to block); ``tuning_chunk`` runs the
        tuning windows in chunks (:meth:`warmup`); ``collect_moments``
        accumulates split-chain
        moments over every coordinate into ``sample_moments``;
        ``sync_blocks`` fetches a small value after every chunk and
        block."""
        reporter = reporter or NoProgressReport()
        if warmup_stages is None:
            warmup_stages = default_warmup_stages()
        with f32_matmuls():
            state = W.init_warmup_state(gen, self.potential, self.model.dim,
                                        n_chains, dtype, device, q=q,
                                        metric=metric, eps=eps)
            state, warmup_stats = self.warmup(
                gen, state, warmup_stages, reporter,
                tuning_chunk=tuning_chunk, sync_blocks=sync_blocks)
            reporter.start_stage(f"sampling {n_draws} draws x "
                                 f"{state.z.q.shape[0]} chains", n_draws)
            out = self._sample(gen, state, n_draws, thin, keep_dims,
                               draw_block, collect_moments, sync_blocks)
            reporter.end_stage()
        ws = W.cat_stats(warmup_stats) if warmup_stats else None
        return MCMCResult(
            draws=out.draws, stats=out.stats,
            warmup_state=WarmupState(z=out.z, metric=state.metric,
                                     log_eps=state.log_eps),
            warmup_stats=ws, sample_moments=out.moments)

    def _sample(self, gen: torch.Generator, state: WarmupState,
                n_draws: int, thin: int, keep_dims, draw_block,
                collect_moments: bool, sync_blocks: bool):
        """The sampling loop in blocks of ``draw_block`` draws (one block of
        ``n_draws`` without it)."""
        if draw_block is not None and draw_block < 1:
            raise ValueError(f"draw_block must be >= 1, got {draw_block}")
        mom = W.init_split_moments(state.z.q) if collect_moments else None
        kw = dict(step_factory=self.step_factory,
                  transition_factory=self.transition_factory, thin=thin,
                  keep_dims=keep_dims, post_step=self.post_step)
        block = draw_block or n_draws
        blocks, done, z = [], 0, state.z
        while done < n_draws:
            nb = min(block, n_draws - done)
            blk = W.run_sampling(gen, self.potential, self.algorithm,
                                 state._replace(z=z), nb, moments0=mom,
                                 moment_offset=done, moment_total=n_draws,
                                 **kw)
            z, mom = blk.z, blk.moments
            blocks.append(blk)
            done += nb
            if sync_blocks:
                value_fence(z)
        return W.SamplingResult(
            z=z, draws=_cat0([b.draws for b in blocks]),
            stats=W.cat_stats([b.stats for b in blocks]), moments=mom)


def _cat0(parts):
    """Consecutive parts joined along the draws (the one part itself)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


#: options of the JAX drivers that the port does not run yet
_NOT_PORTED = ("warmup_checkpoint_path", "sample_checkpoint_path",
               "collect_sketch", "store_draws", "checkpoint_throttle_s",
               "schedule", "use_kernels")


def _tree_options(st: Optional[dict], use_pallas: str,
                  tree_opts: Optional[dict]) -> dict:
    """Check ``tree_opts`` as the JAX package does on the routes that run
    the whole tree (``TREE_KINDS``): unknown keys raise ``ValueError``
    (``physics_mode``, ``grad_bf16`` and ``block_n`` are logistic
    regression's alone, as JAX's ``_by_kind``); what the port has not
    ported raises ``NotImplementedError``.  A route without a whole tree
    ignores them, as in JAX."""
    topts = dict(tree_opts or {})
    kind = None if st is None else st.get("kind")
    if not topts or kind not in TREE_KINDS.get(use_pallas, ()):
        return {}
    if kind in _TREE_NOT_PORTED and st.get("physics") not in PHYSICS:
        raise NotImplementedError(
            f"tree_opts: the whole-tree kernel for {kind!r} models with "
            f"physics {st.get('physics')!r} is not ported to "
            f"inplacedhmc_tpu_torch ({_TREE_NOT_PORTED[kind]})")
    allowed = TREE_OPTS + (LOGISTIC_TREE_OPTS if kind == "logistic" else ())
    unknown = set(topts) - set(allowed)
    if unknown:
        raise ValueError(
            f"tree_opts {sorted(unknown)} not supported for model kind "
            f"{kind!r} (allowed: {sorted(allowed)})")
    return topts


def _refuse(options: dict):
    for name in options:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"{name!r} is not ported to inplacedhmc_tpu_torch yet")
        raise TypeError(f"unexpected keyword argument {name!r}")


def mcmc_with_warmup(seed: Union[int, torch.Generator], model: Model,
                     n_draws: int, n_chains: int = 1, *,
                     delta: float = 0.8,
                     algorithm: NUTS = NUTS(),
                     warmup_stages: Optional[Sequence] = None,
                     pooled: Optional[bool] = None,
                     q: Optional[torch.Tensor] = None,
                     metric: Optional[Metric] = None,
                     eps: Optional[float] = None,
                     dtype=torch.float32,
                     device="cuda",
                     reporter=None,
                     thin: int = 1,
                     keep_dims: Optional[Sequence[int]] = None,
                     tree_opts: Optional[dict] = None,
                     use_pallas: str = "auto",
                     fused_opts: Optional[dict] = None,
                     post_step: Optional[Callable] = None,
                     draw_block: Optional[int] = None,
                     tuning_chunk: Optional[int] = None,
                     collect_moments: bool = False,
                     sync_blocks: bool = False,
                     **not_ported) -> MCMCResult:
    """NUTS with the default windowed warmup on ``device``.  ``delta`` is the
    dual-averaging target acceptance rate; ``pooled`` defaults to
    ``n_chains > 1``; ``seed`` is an int or a ``torch.Generator`` on
    ``device``; ``thin``, ``keep_dims``, ``tree_opts``, ``use_pallas``,
    ``fused_opts``, ``post_step``, ``draw_block``, ``tuning_chunk``,
    ``collect_moments`` and ``sync_blocks`` as in the JAX package (see the
    module docstring, :class:`NUTSKernel` and :meth:`NUTSKernel.run`)."""
    _refuse(not_ported)
    if pooled is None:
        pooled = n_chains > 1
    if warmup_stages is None:
        warmup_stages = default_warmup_stages(
            stepsize_adaptation=DualAveraging(delta=delta))
    kern = NUTSKernel(model, algorithm, pooled, tree_opts=tree_opts,
                      use_pallas=use_pallas, post_step=post_step,
                      fused_opts=fused_opts)
    return kern.run(make_generator(seed, device), n_draws, n_chains,
                    warmup_stages=warmup_stages, q=q, metric=metric, eps=eps,
                    dtype=dtype, device=device, reporter=reporter, thin=thin,
                    keep_dims=keep_dims, draw_block=draw_block,
                    tuning_chunk=tuning_chunk,
                    collect_moments=collect_moments, sync_blocks=sync_blocks)


def sample(seed: Union[int, torch.Generator], model: Model, n_draws: int,
           n_chains: int, *, delta: float = 0.8, mesh=None,
           **kw) -> MCMCResult:
    """The pooled-adaptation entry point: one step size and one metric
    adapted across all chains.  Sharding over a mesh is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported to "
                                  "inplacedhmc_tpu_torch yet")
    return mcmc_with_warmup(seed, model, n_draws, n_chains, delta=delta,
                            pooled=True, **kw)
