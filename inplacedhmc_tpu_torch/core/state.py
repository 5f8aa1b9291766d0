"""Phase-space and sampler state, batched over a leading chains axis.

The port's counterpart of ``inplacedhmc_tpu/core/state.py``: the same named
tuples, holding ``torch.Tensor`` fields instead of JAX arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class EvalPoint(NamedTuple):
    """A position with its cached log density and gradient: ``q``/``grad``
    are ``[C, D]``, ``logp`` is ``[C]``."""

    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class PhasePoint(NamedTuple):
    """Position plus momentum."""

    Q: EvalPoint
    p: torch.Tensor


class Termination:
    """Reason a NUTS trajectory stopped; the integer codes in ``TreeStats``.
    The values are those of the JAX package, so the two compare directly."""

    MAX_DEPTH = 0
    DIVERGENCE = 1
    TURNING = 2


class TreeStats(NamedTuple):
    """Per-transition diagnostics, every field ``[C]``."""

    energy: torch.Tensor          # log density (negative energy) at the proposal
    acceptance_rate: torch.Tensor
    termination: torch.Tensor     # Termination.* codes, int32
    term_left: torch.Tensor       # left end of the invalid subtree, int32
    term_right: torch.Tensor      # right end of the invalid subtree, int32
    depth: torch.Tensor           # successful doublings, int32
    steps: torch.Tensor           # leapfrog steps taken, int32


class WarmupState(NamedTuple):
    """Adaptation state between warmup stages.  ``log_eps`` is ``None`` before
    the initial step-size search; ``metric`` is a ``DiagMetric`` or a
    ``DenseMetric``."""

    z: EvalPoint
    metric: NamedTuple
    log_eps: Optional[torch.Tensor]  # [C] (per chain) or scalar (pooled)
