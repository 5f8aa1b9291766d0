#!/usr/bin/env python3
"""Where the time of the port's sampling loop goes, on one NVIDIA card.

Runs one main path of ``chip_smoke.py`` through its warmup, then traces
``--transitions`` sampling transitions with ``torch.profiler`` and prints:
the wall time, the device time by kernel (top entries), the device busy
share (summed kernel time over wall; kernels do not overlap on one stream),
and the path's hand-written kernel's share of device time and of wall.
``--model logistic`` (the default): 10,000 x 50 data, 8192 chains, dense
metric, the short warmup schedule, K1 once per lockstep leaf.  ``--model
std_normal``: the 100-D standard normal at 10,240 chains, the default
warmup, K5 once per transition; with ``--tree-opts`` (a JSON object of
``sample()``'s ``tree_opts``, e.g. the flagship path's
``'{"refresh_inside": true, "padded_io": true, "n_sweep": 16}'``) K5 runs as
those options ask, once per ``n_sweep`` sampling transitions.  Usage::

    python3 tools/profile_torch_sample.py [--model logistic|std_normal]
        [--transitions 16] [--tree-opts JSON]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transitions", type=int, default=16)
    ap.add_argument("--model", choices=("logistic", "std_normal"),
                    default="logistic")
    ap.add_argument("--tree-opts", type=json.loads, default=None,
                    help="tree_opts of the std_normal run, as JSON")
    args = ap.parse_args()
    if args.tree_opts and args.model != "std_normal":
        ap.error("--tree-opts applies to --model std_normal")

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from inplacedhmc_tpu_torch import default_warmup_stages
    from inplacedhmc_tpu_torch.adapt import warmup as W
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              std_normal, synthetic_data)
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG
    from inplacedhmc_tpu_torch.ops.tree import TREE_GAUSSIAN
    from inplacedhmc_tpu_torch.sample import NUTSKernel, f32_matmuls

    if not torch.cuda.is_available():
        print("profile_torch_sample: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    if args.model == "logistic":
        x, y, _ = synthetic_data(chip_smoke.SEED, chip_smoke.N, chip_smoke.D)
        model = logistic_regression(x, y)
        n_chains, kernel, label, unit = chip_smoke.C, LOGISTIC_VG, "K1", \
            "lockstep leaf"
        stages = default_warmup_stages(init_steps=50, middle_steps=50,
                                       doubling_stages=2,
                                       terminating_steps=50, metric="dense")
    else:
        model = std_normal(chip_smoke.G_DIM)
        n_chains, kernel, label = chip_smoke.G_CHAINS, TREE_GAUSSIAN, "K5"
        unit = "launch" if args.tree_opts else "transition"
        stages = default_warmup_stages()
    kern = NUTSKernel(model, tree_opts=args.tree_opts)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    factories = dict(step_factory=kern.step_factory,
                     transition_factory=kern.transition_factory)
    with f32_matmuls():
        state = W.init_warmup_state(gen, kern.potential, model.dim, n_chains)
        state, _ = kern.warmup(gen, state, stages)
        W.run_sampling(gen, kern.potential, kern.algorithm, state,
                       args.transitions, **factories)  # warm, same path
        torch.cuda.synchronize()
        kernel.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = W.run_sampling(gen, kern.potential, kern.algorithm, state,
                                 args.transitions, **factories)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = kernel.launches

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    dev_total_s = sum(r[0] for r in rows) / 1e6
    stem = os.path.splitext(kernel.source)[0]
    k_s = sum(r[0] for r in rows if stem in r[2]) / 1e6
    steps = int(out.stats.steps.sum())
    print(f"[profile] {card}: {args.model}, {n_chains} chains, tree_opts "
          f"{args.tree_opts}, {args.transitions} transitions, wall "
          f"{wall:.4f} s ({wall / args.transitions * 1e3:.4f} ms per "
          f"transition), {launches} {label} launches "
          f"({wall / max(launches, 1) * 1e3:.4f} ms wall per {unit}), "
          f"{steps / wall:.4g} chain leapfrog steps/s (under the profiler)")
    print(f"[profile] device busy {dev_total_s:.4f} s = "
          f"{dev_total_s / wall:.4f} of wall; {label} {k_s:.4f} s = "
          f"{k_s / max(dev_total_s, 1e-12):.4f} of device time, "
          f"{k_s / wall:.4f} of wall, "
          f"{k_s / max(launches, 1) * 1e3:.4f} ms per launch")
    for dev_us, count, key in rows[:12]:
        print(f"[profile]   {dev_us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
