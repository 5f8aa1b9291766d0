"""The card's line and the H100 SXM peaks that the port's measurements set
their times against (``chip_smoke.py``, ``tools/roofline_torch.py``)."""

from __future__ import annotations

import subprocess

PEAK_FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_TC = 989e12             # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_TC = 495e12             # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
# special functions (expf, logf, log1pf, cosf, sqrtf: one MUFU instruction
# each at the core of each) on an H100 SXM: 16 results per clock per SM
# (CUDA C Programming Guide, throughput table, compute capability 9.0),
# 132 SMs at the 1,980 MHz boost clock
PEAK_SFU = 132 * 16 * 1.98e9


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
