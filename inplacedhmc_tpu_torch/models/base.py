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
    the model for a fused kernel.  Its ``"kind"``:

    * ``"logistic"``: ``x``, ``y``, ``inv_var`` (the fused potential);
    * ``"diag_gaussian"``: ``precision [D]`` (the Gaussian kernels);
    * ``"dense_gaussian"``: ``precision [D, D]``, symmetric (the
      whole-tree kernel's ``dense_gaussian`` physics);
    * ``"tile_logp"``: ``physics``, the name of a hand-written value and
      gradient in ``ops/tile_physics.py`` (``"eight_schools"``,
      ``"funnel"``, ``"stoch_vol"``; each has a device function for the
      whole-tree kernel); ``data``, its rows (``[D]`` float32 tensors on
      the model's device, zero past its lanes: eight schools' ``y``,
      ``sig``, ``obs_mask``, the funnel's ``x_mask``, stochastic
      volatility's ``r2``, ``h_mask``, ``ar_mask``); ``scalars``, its
      floats (the funnel's ``k``, ``inv_s2``; stochastic volatility's
      ``t``).  A physics the port has no device function for runs on
      autograd and the lockstep tree.

    Models compare and hash by identity.
    """

    name: str
    dim: int
    logp: Callable
    constrain: Optional[Callable] = None
    structure: Optional[dict] = None
