"""Per-chain mask helpers.

All NUTS state is batched over a leading chains axis and advanced in
lockstep; chains whose trajectory ended keep computing but have every state
update masked out.  The port's counterpart of
``inplacedhmc_tpu/utils/masking.py``.
"""

from __future__ import annotations

import torch


def bcast_where(mask: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with ``mask`` of shape ``[C]`` against ``[C, ...]``."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def tree_where(mask: torch.Tensor, new, old):
    """:func:`bcast_where` over matching named tuples of tensors."""
    return type(new)(*(bcast_where(mask, n, o) for n, o in zip(new, old)))
