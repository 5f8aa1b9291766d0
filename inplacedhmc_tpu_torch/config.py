"""Typed option structs: the port's copy of ``inplacedhmc_tpu/config.py``.

Frozen dataclasses with the same fields and defaults as the JAX package's
``NUTS``, ``DualAveraging``, ``FixedStepsize``, ``InitialStepsizeSearch``,
``FindLocalOptimum`` and ``TuningNUTS``, plus ``default_warmup_stages``.
The port keeps its own copy so that it never imports the JAX package.

``TuningNUTS.stream`` estimates a window's metric from streamed moments
(``adapt/warmup.py::StreamMoments``) instead of its stored draws.  Not
ported yet: the low-rank metric (``TuningNUTS.rank``) and the fixed-step
schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class NUTS:
    """NUTS algorithm configuration.  ``max_depth`` is capped at 30 by the
    32-bit direction word; ``min_delta`` is the divergence threshold."""

    max_depth: int = 10
    min_delta: float = -1000.0

    def __post_init__(self):
        if not 0 < self.max_depth <= 30:
            raise ValueError("max_depth must be in (0, 30]")
        if not self.min_delta < 0:
            raise ValueError("min_delta must be negative")


@dataclasses.dataclass(frozen=True)
class DualAveraging:
    """Hoffman-Gelman (2014) Algorithm 6 parameters."""

    delta: float = 0.8   # target acceptance rate
    gamma: float = 0.05  # regularization scale
    kappa: float = 0.75  # relaxation exponent
    t0: int = 10         # offset

    def __post_init__(self):
        if not (0 < self.delta < 1 and self.gamma > 0
                and 0.5 < self.kappa <= 1 and self.t0 >= 0):
            raise ValueError(f"invalid dual-averaging parameters {self}")


@dataclasses.dataclass(frozen=True)
class FixedStepsize:
    """No-op step-size adaptation."""


@dataclasses.dataclass(frozen=True)
class InitialStepsizeSearch:
    """Bracket-then-bisect initial step-size finder: per-chain eps whose local
    acceptance ratio lies in ``[a_min, a_max]``."""

    a_min: float = 0.25
    a_max: float = 0.75
    eps0: float = 1.0
    c: float = 2.0
    maxiter_crossing: int = 400
    maxiter_bisect: int = 400

    def __post_init__(self):
        if not (0 < self.a_min < self.a_max < 1 and self.eps0 > 0
                and self.c > 1):
            raise ValueError(f"invalid step-size search parameters {self}")


@dataclasses.dataclass(frozen=True)
class FindLocalOptimum:
    """Penalized L-BFGS warmup initializer: at most ``iterations`` steps on
    ``logp(q) - 0.5 * magnitude_penalty * ||q||^2``; chains that end at a
    non-finite density restart from fresh random positions with a doubled
    penalty, up to ``max_retries`` times."""

    magnitude_penalty: float = 1e-4
    iterations: int = 50
    max_retries: int = 10


@dataclasses.dataclass(frozen=True)
class TuningNUTS:
    """A step-size (and metric) tuning window of ``n`` transitions.

    ``metric`` selects the end-of-window re-estimate: ``"diag"``, ``"dense"``
    or ``None`` (unchanged).  ``lam`` is the shrinkage regularizer, ``5/n``
    by default.  ``stream`` estimates the metric from moments streamed over
    the window (O(D) or O(D^2) memory) instead of its stored ``[N, C, D]``
    draws: the memory-bounded mode of large chain counts times dimensions.
    """

    n: int
    stepsize_adaptation: Union[DualAveraging, FixedStepsize] = DualAveraging()
    metric: Optional[str] = "diag"
    lam: Optional[float] = None
    stream: bool = False

    def __post_init__(self):
        if self.metric == "low_rank":
            raise NotImplementedError(
                "the low-rank metric is not ported yet")
        if self.metric not in (None, "diag", "dense"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.n <= 0:
            raise ValueError("a tuning window needs n > 0")

    @property
    def lam_value(self) -> float:
        return 5.0 / self.n if self.lam is None else self.lam


WarmupStage = Union[FindLocalOptimum, InitialStepsizeSearch, TuningNUTS, None]


class StepsizeCollapseError(RuntimeError):
    """Adaptation drove the step size out of sane bounds.  Raised by the
    driver at every window boundary, with the window's acceptance and
    divergence summary."""


def default_warmup_stages(
    local_optimization: Optional[FindLocalOptimum] = FindLocalOptimum(),
    stepsize_search: Optional[InitialStepsizeSearch] = InitialStepsizeSearch(),
    metric: str = "diag",
    stepsize_adaptation: DualAveraging = DualAveraging(),
    init_steps: int = 75,
    middle_steps: int = 25,
    doubling_stages: int = 5,
    terminating_steps: int = 50,
    stream: bool = False,
) -> Tuple[WarmupStage, ...]:
    """The default windowed schedule: optimum, step-size search, 75, then
    (25, 50, 100, 200, 400) with metric re-estimates, then 50: 900 warmup
    transitions by default.  ``stream=True`` estimates the metrics from
    streamed moments instead of the windows' stored draws."""
    middle = tuple(
        TuningNUTS(n=middle_steps << i, stepsize_adaptation=stepsize_adaptation,
                   metric=metric, stream=stream)
        for i in range(doubling_stages)
    )
    return tuple(
        s for s in (
            local_optimization,
            stepsize_search,
            TuningNUTS(n=init_steps, stepsize_adaptation=stepsize_adaptation,
                       metric=None),
            *middle,
            TuningNUTS(n=terminating_steps,
                       stepsize_adaptation=stepsize_adaptation, metric=None),
        ) if s is not None
    )
