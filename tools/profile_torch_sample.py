#!/usr/bin/env python3
"""Where the time of the port's sampling loop goes, on one NVIDIA card.

Runs the logistic-regression main path of ``chip_smoke.py`` (10,000 x 50
data, 8192 chains, dense metric, the short warmup schedule), then traces
``--transitions`` sampling transitions with ``torch.profiler`` and prints:
the wall time, the device time by kernel (top entries), the device busy
share (summed kernel time over wall; kernels do not overlap on one stream),
and K1's share of device time and of wall.  Usage::

    python3 tools/profile_torch_sample.py [--transitions 16]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transitions", type=int, default=16)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from inplacedhmc_tpu_torch import default_warmup_stages
    from inplacedhmc_tpu_torch.adapt import warmup as W
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              synthetic_data)
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG
    from inplacedhmc_tpu_torch.sample import NUTSKernel, f32_matmuls

    if not torch.cuda.is_available():
        print("profile_torch_sample: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    x, y, _ = synthetic_data(chip_smoke.SEED, chip_smoke.N, chip_smoke.D)
    model = logistic_regression(x, y)
    kern = NUTSKernel(model)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    stages = default_warmup_stages(init_steps=50, middle_steps=50,
                                   doubling_stages=2, terminating_steps=50,
                                   metric="dense")
    with f32_matmuls():
        state = W.init_warmup_state(gen, kern.potential, model.dim,
                                    chip_smoke.C)
        state, _ = kern.warmup(gen, state, stages)
        W.run_sampling(gen, kern.potential, kern.algorithm, state, 2)  # warm
        torch.cuda.synchronize()
        LOGISTIC_VG.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = W.run_sampling(gen, kern.potential, kern.algorithm, state,
                                 args.transitions)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = LOGISTIC_VG.launches

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    dev_total_s = sum(r[0] for r in rows) / 1e6
    k1_s = sum(r[0] for r in rows if "logistic_vg" in r[2]) / 1e6
    steps = int(out.stats.steps.sum())
    print(f"[profile] {card}: {args.transitions} transitions, wall "
          f"{wall:.4f} s, {launches} K1 launches "
          f"({wall / max(launches, 1) * 1e3:.4f} ms wall per lockstep leaf), "
          f"{steps / wall:.4g} chain leapfrog steps/s (under the profiler)")
    print(f"[profile] device busy {dev_total_s:.4f} s = "
          f"{dev_total_s / wall:.4f} of wall; K1 {k1_s:.4f} s = "
          f"{k1_s / max(dev_total_s, 1e-12):.4f} of device time, "
          f"{k1_s / wall:.4f} of wall, "
          f"{k1_s / max(launches, 1) * 1e3:.4f} ms per launch")
    for dev_us, count, key in rows[:12]:
        print(f"[profile]   {dev_us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
