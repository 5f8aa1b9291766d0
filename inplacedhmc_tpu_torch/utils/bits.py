"""Bit arithmetic for the iterative NUTS tree, in masked int64.

The port's counterpart of ``inplacedhmc_tpu/utils/bits.py``.  torch has no
unsigned 32-bit shifts and no popcount, so every function works on int64
holding values in ``[0, 2^32)``.  Each takes a Python int (the tree's leaf
index, known on the host) or an integer tensor.

Checkpoint-slot scheme: leaf ``n`` of a subtree is the right edge of the
``2^k``-leaf node ``[n - 2^k + 1, n]`` for every ``k in 1..trailing_ones(n)``;
every such node's left edge ``l`` is even and keeps its data in slot
``popcount(l >> 1)``.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def popcount(x):
    """Number of set bits of a 32-bit value."""
    if isinstance(x, int):
        return bin(x & _MASK32).count("1")
    x = x.to(torch.int64) & _MASK32
    count = torch.zeros_like(x)
    for _ in range(32):
        count += x & 1
        x = x >> 1
    return count


def trailing_ones(x):
    """Number of contiguous low-order one bits: the popcount of the mask of
    bits that flip when incrementing."""
    if isinstance(x, int):
        x &= _MASK32
        return popcount((~x & (x + 1)) - 1)
    x = x.to(torch.int64) & _MASK32
    return popcount((~x & (x + 1)) - 1)


def checkpoint_slot(n):
    """Stack slot used when (even) leaf ``n`` is stored as a left edge."""
    return popcount(n >> 1)


def direction_bit(flags: torch.Tensor, d: int) -> torch.Tensor:
    """Doubling direction for depth ``d`` from the 32-bit direction words
    ``flags`` (int64 holding ``[0, 2^32)``): bit 0 drives the first doubling.
    ``True`` means forward."""
    return ((flags.to(torch.int64) & _MASK32) >> d) & 1 == 1
