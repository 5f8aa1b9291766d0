"""Argument checks shared by the kernels' wrappers.

The port's counterpart of ``inplacedhmc_tpu/ops/common.py``.  The JAX module
holds the padding arithmetic of the Pallas kernels (``round_up``,
``chain_tiles``); the CUDA kernels take unpadded tensors and mask their
ragged edges themselves, so none of it carries over.  What the wrappers
share instead is the check of what they hand to a kernel as a raw pointer.
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
