"""High-level sampling drivers.

The port's counterpart of ``inplacedhmc_tpu/sample.py``:

* :class:`NUTSKernel` holds one (model, algorithm, adaptation) configuration
  and picks the potential: the fused logistic kernel for a model whose
  ``structure`` is ``{"kind": "logistic", ...}``, autograd otherwise.
* :func:`mcmc_with_warmup` runs the windowed warmup, then sampling.
* :func:`sample` is the pooled-adaptation entry point.

Every entry point takes ``device=`` (``"cuda"`` by default; the CPU only when
the caller asks for it) and a seed or a ``torch.Generator`` on that device;
no global RNG state is used.

Not ported yet, and refused with ``NotImplementedError``: meshes,
checkpoints, sketches and streamed moments, chunked tuning and blocked
sampling, thinning, ``keep_dims``, ``post_step`` hooks, work-sorted
scheduling, and the whole-tree kernel (``use_kernels`` / ``tree_opts``).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .adapt import warmup as W
from .config import (DualAveraging, FindLocalOptimum, InitialStepsizeSearch,
                     NUTS, StepsizeCollapseError, TuningNUTS,
                     default_warmup_stages)
from .core.hamiltonian import batched_logdensity_and_grad
from .core.metric import Metric
from .core.state import Termination, TreeStats, WarmupState
from .models.base import Model
from .ops.logistic import make_logistic_potential


class MCMCResult(NamedTuple):
    """Chain output: ``draws`` is ``[n_draws, n_chains, dim]``; ``stats`` are
    per-transition :class:`TreeStats` (``[n_draws, n_chains]`` fields);
    ``warmup_state`` holds the adapted metric and eps."""

    draws: torch.Tensor
    stats: TreeStats
    warmup_state: WarmupState
    warmup_stats: Optional[TreeStats] = None


class NoProgressReport:
    """Silent reporter.  A reporter gets ``start_stage(name, total_steps)``
    and ``end_stage(**info)`` around every warmup stage and the sampling
    loop."""

    def start_stage(self, name: str, total_steps: int = 0):
        pass

    def end_stage(self, **info):
        pass


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


class NUTSKernel:
    """Sampling for one (model, algorithm, adaptation) configuration.

    A logistic-regression model (``structure["kind"] == "logistic"``) is
    evaluated through the fused kernel wrapper (``ops/logistic.py``: the CUDA
    kernel on the card, its plain version on the CPU), as the JAX "auto"
    policy keeps logistic on the lockstep tree with the fused potential; any
    other model through autograd of ``model.logp``.
    """

    def __init__(self, model: Model, algorithm: NUTS = NUTS(),
                 pooled: bool = True):
        self.model = model
        self.algorithm = algorithm
        self.pooled = pooled
        st = model.structure
        if st is not None and st.get("kind") == "logistic":
            self.potential = make_logistic_potential(st["x"], st["y"],
                                                     st["inv_var"])
        else:
            self.potential = batched_logdensity_and_grad(model.logp)

    def warmup(self, gen: torch.Generator, state: WarmupState,
               stages: Sequence, reporter=None) -> Tuple[WarmupState, list]:
        """Run the stage sequence; returns the adapted state and the tuning
        windows' tree statistics."""
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
                res = W.run_tuning(gen, self.potential, stage, self.algorithm,
                                   state, pooled=self.pooled)
                state = res.state
                warmup_stats.append(res.stats)
                _check_eps_sane(state.log_eps, f"tuning window ({stage.n})",
                                res.stats)
                reporter.end_stage(
                    eps=float(torch.exp(torch.atleast_1d(state.log_eps))[0]))
            else:
                raise TypeError(f"unknown warmup stage {stage!r}")
        return state, warmup_stats

    def run(self, gen: torch.Generator, n_draws: int, n_chains: int = 1, *,
            warmup_stages: Optional[Sequence] = None,
            q: Optional[torch.Tensor] = None,
            metric: Optional[Metric] = None,
            eps: Optional[float] = None,
            dtype=torch.float32,
            device="cuda",
            reporter=None) -> MCMCResult:
        """Warmup, then ``n_draws`` transitions."""
        reporter = reporter or NoProgressReport()
        if warmup_stages is None:
            warmup_stages = default_warmup_stages()
        with f32_matmuls():
            state = W.init_warmup_state(gen, self.potential, self.model.dim,
                                        n_chains, dtype, device, q=q,
                                        metric=metric, eps=eps)
            state, warmup_stats = self.warmup(gen, state, warmup_stages,
                                              reporter)
            reporter.start_stage(f"sampling {n_draws} draws x "
                                 f"{state.z.q.shape[0]} chains", n_draws)
            out = W.run_sampling(gen, self.potential, self.algorithm, state,
                                 n_draws)
            reporter.end_stage()
        ws = None
        if warmup_stats:
            ws = TreeStats(*(torch.cat(f, dim=0)
                             for f in zip(*warmup_stats)))
        return MCMCResult(
            draws=out.draws, stats=out.stats,
            warmup_state=WarmupState(z=out.z, metric=state.metric,
                                     log_eps=state.log_eps),
            warmup_stats=ws)


#: options of the JAX drivers that the port does not run yet
_NOT_PORTED = ("thin", "draw_block", "tuning_chunk", "warmup_checkpoint_path",
               "sample_checkpoint_path", "keep_dims", "collect_moments",
               "collect_sketch", "store_draws", "sync_blocks",
               "checkpoint_throttle_s", "fused_opts", "tree_opts",
               "post_step", "schedule", "use_kernels")


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
                     **not_ported) -> MCMCResult:
    """NUTS with the default windowed warmup on ``device``.  ``delta`` is the
    dual-averaging target acceptance rate; ``pooled`` defaults to
    ``n_chains > 1``; ``seed`` is an int or a ``torch.Generator`` on
    ``device``."""
    _refuse(not_ported)
    if pooled is None:
        pooled = n_chains > 1
    if warmup_stages is None:
        warmup_stages = default_warmup_stages(
            stepsize_adaptation=DualAveraging(delta=delta))
    kern = NUTSKernel(model, algorithm, pooled)
    return kern.run(make_generator(seed, device), n_draws, n_chains,
                    warmup_stages=warmup_stages, q=q, metric=metric, eps=eps,
                    dtype=dtype, device=device, reporter=reporter)


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
