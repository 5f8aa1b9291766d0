"""Model interface.

The port's counterpart of ``inplacedhmc_tpu/models/base.py``: a model is a
batched ``logp(q: [..., D]) -> [...]`` written in torch, plus its dimension.
Gradients come from autograd, or from a hand-written kernel where
``structure`` names a model kind that has one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """A target density on an unconstrained ``R^dim``.

    ``logp`` must accept any leading batch shape and be defined on all of
    ``R^dim`` (return ``-inf``/NaN outside the support; the sampler maps
    non-finite values to divergences).  ``structure`` optionally describes
    the model for a fused kernel (``{"kind": "logistic", ...}``).  Models
    compare and hash by identity.
    """

    name: str
    dim: int
    logp: Callable
    constrain: Optional[Callable] = None
    structure: Optional[dict] = None
