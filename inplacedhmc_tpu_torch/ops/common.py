"""Argument checks shared by the kernels' wrappers, and the chain padding.

The port's counterpart of ``inplacedhmc_tpu/ops/common.py``.  The CUDA
kernels take unpadded tensors and mask their ragged edges themselves; what
the wrappers share is the check of what they hand to a kernel as a raw
pointer.  The JAX module's padding arithmetic (``round_up``,
``chain_tiles``) carries over for the whole-tree sampling loop, which pads
its chains to ``block_c`` tiles as the JAX package does.
"""

from __future__ import annotations

import torch


def check_tensor(kernel: str, name: str, t: torch.Tensor, shape,
                 device: torch.device, dtype=torch.float32) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``: the layout a kernel reads through a raw
    pointer."""
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def chain_tiles(c: int, block_c: int):
    """``(cpad, bc)`` for a batch of ``c`` chains tiled into blocks of at most
    ``block_c`` rows, as the JAX package pads them for its whole-tree kernel:
    ``bc`` divides ``cpad`` exactly, both are multiples of 8.  Small batches
    shrink the tile to the batch.  The CUDA kernel has no tile of chains;
    a sampling loop pads its state to ``cpad`` rows all the same, with the
    padded rows not valid, so that ``block_c`` means what it means in
    JAX."""
    if block_c % 8 != 0:
        raise ValueError(f"block_c must be a multiple of 8, got {block_c}")
    cpad = round_up(max(c, 8), min(block_c, round_up(c, 8)))
    bc = min(block_c, cpad)
    cpad = round_up(cpad, bc)
    return cpad, bc
