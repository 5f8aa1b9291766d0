#!/usr/bin/env python3
"""Roofline harness of the port's bare kernels on one NVIDIA card.

The port's counterpart of ``benchmarks/roofline.py``: each kernel runs a
long chain of dependent launches, timed with CUDA events, best of 3, and
its achieved rate is set against the card's peak:

* K3, the fused Gaussian leapfrog (``ops/leapfrog.py::
  fused_gaussian_leapfrog``): 10,240 chains x 100, 512 chained steps;
  achieved bytes/s over 6 [C, D] float32 arrays a step (q, p in; q', p',
  grad', p#' out; the row sums are small);
* K4, the multi-step leapfrog (``multi_step_leapfrog``): 10,240 x 100,
  64 steps a launch, 16 chained launches; its bound (8 C D k flops at the
  fp32 rate, above its 4 [C, D] arrays at the memory rate), and JAX's
  ratio of the single step's memory ideal to the time of a step
  (``single_step_hbm_ideal_us / step_us``) at the port's unpadded D;
* K1, the logistic value and gradient (``logistic_value_and_grad``):
  2048 chains x 10,000 x 50, 64 chained evaluations (q += 1e-6 grad), the
  plane of the data made once, as the potential makes it; achieved FLOP/s
  over the two products' 4 C N D, against the fp32 rate and against the
  rate of the float32-grade products as three TF32 passes on the tensor
  cores (the lesser time of the two, ``chip_smoke.py::logistic_bound``).

The host queues each chain of launches behind a sleep of the stream, so
the events time the device's work, not Python's launch overhead.  Every
line carries the card's name and power limit (``nvidia-smi``) and the
launches the kernel counted.  It prints one JSON line per kernel.

Run on a machine with a card, from the root of a checkout::

    python3 tools/roofline_torch.py [--quick]

``--quick`` divides the chains of launches as JAX's ``--quick`` does (by 8,
K4's by 4).  Without a CUDA device it raises: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tools.card import (PEAK_BYTES, PEAK_FP32_FLOPS,  # noqa: E402
                        PEAK_TF32_TC, card_line)

# the stream sleeps this many cycles per queued launch (and at least
# MIN_SLEEP, as chip_smoke.py's cuda_time_ms) before the first of them runs: a
# chain of 512 launches takes the host longer to queue than that one sleep
SLEEP_PER_LAUNCH, MIN_SLEEP = 200_000, 50_000_000


def best_ms(chain, n_launches: int, reps: int = 3) -> float:
    """The best of ``reps`` device times of ``chain()``, a run of
    ``n_launches`` dependent launches, in ms, by CUDA events; one run
    first as a warm-up."""
    chain()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(max(MIN_SLEEP, SLEEP_PER_LAUNCH * n_launches))
        start.record()
        chain()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def bench_fused_leapfrog(card: str, n_chains=10_240, dim=100, iters=512):
    """K3: ``iters`` chained steps; traffic model 6 [C, D] arrays a step."""
    from inplacedhmc_tpu_torch.ops.leapfrog import (LEAPFROG_GAUSSIAN,
                                                    fused_gaussian_leapfrog)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q0 = torch.randn((n_chains, dim), generator=gen, device="cuda")
    p0 = torch.randn((n_chains, dim), generator=gen, device="cuda")
    lam = torch.ones((dim,), device="cuda")
    minv = torch.ones((dim,), device="cuda")
    eps = torch.full((n_chains,), 0.01, device="cuda")

    def chain():
        q, p = q0, p0
        for _ in range(iters):
            q, p = fused_gaussian_leapfrog(q, p, eps, lam, minv)[:2]
        return q

    LEAPFROG_GAUSSIAN.launches = 0
    ms = best_ms(chain, iters)
    if not bool(torch.isfinite(chain()).all()):
        raise RuntimeError("K3's chained steps are not finite")
    step_bytes = 6 * n_chains * dim * 4
    gbps = step_bytes * iters / (ms * 1e-3) / 1e9
    return {"kernel": "fused_gaussian_leapfrog", "chains": n_chains,
            "dim": dim, "steps": iters, "ms": ms,
            "step_us": ms * 1e3 / iters, "achieved_GBps": gbps,
            "peak_GBps": PEAK_BYTES / 1e9, "roofline_frac":
            gbps * 1e9 / PEAK_BYTES, "launches": LEAPFROG_GAUSSIAN.launches,
            "card": card}


def bench_multistep_leapfrog(card: str, n_chains=10_240, dim=100,
                             k_steps=64, launches=16):
    """K4: ``launches`` chained launches of ``k_steps`` steps each."""
    from inplacedhmc_tpu_torch.ops.leapfrog import (LEAPFROG_MULTISTEP,
                                                    multi_step_leapfrog)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q0 = torch.randn((n_chains, dim), generator=gen, device="cuda")
    p0 = torch.randn((n_chains, dim), generator=gen, device="cuda")
    lam = torch.ones((dim,), device="cuda")
    minv = torch.ones((dim,), device="cuda")
    eps = torch.full((n_chains,), 0.001, device="cuda")

    def chain():
        q, p = q0, p0
        for _ in range(launches):
            q, p = multi_step_leapfrog(q, p, eps, lam, minv, k_steps)
        return q

    LEAPFROG_MULTISTEP.launches = 0
    ms = best_ms(chain, launches)
    if not bool(torch.isfinite(chain()).all()):
        raise RuntimeError("K4's chained launches are not finite")
    launch_us = ms * 1e3 / launches
    step_us = launch_us / k_steps
    flops = 8.0 * n_chains * dim * k_steps
    nbytes = 4.0 * n_chains * dim * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    bound_us = max(t_ops, t_bytes) * 1e6
    # JAX's figure of merit: the single-step kernel's memory ideal (6
    # [C, D] arrays a step) against the time of one of these steps
    ideal_us = 6 * n_chains * dim * 4 / PEAK_BYTES * 1e6
    return {"kernel": f"multi_step_leapfrog_k{k_steps}", "chains": n_chains,
            "dim": dim, "launches_chained": launches, "ms": ms,
            "launch_us": launch_us, "step_us": step_us,
            "bound_us": bound_us,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "achieved_TFLOPs": flops / (launch_us * 1e-6) / 1e12,
            "peak_TFLOPs_f32": PEAK_FP32_FLOPS / 1e12,
            "roofline_frac": bound_us / launch_us,
            "single_step_hbm_ideal_us": ideal_us,
            "ideal_over_step": ideal_us / step_us,
            "launches": LEAPFROG_MULTISTEP.launches, "card": card}


def bench_logistic(card: str, n_chains=2048, n_obs=10_000, n_feat=50,
                   iters=64):
    """K1: ``iters`` chained evaluations, each feeding the next."""
    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (LOGISTIC_VG,
                                                    logistic_planes,
                                                    logistic_value_and_grad)
    x, y, _ = synthetic_data(0, n_obs, n_feat, device="cuda")
    w = torch.ones_like(y)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q0 = 0.1 * torch.randn((n_chains, n_feat), generator=gen, device="cuda")
    plane = logistic_planes(x, y, w)

    def chain():
        q = q0
        for _ in range(iters):
            _, g = logistic_value_and_grad(q, x, y, w, 0.01, planes=plane)
            q = q + 1e-6 * g
        return q

    LOGISTIC_VG.launches = 0
    ms = best_ms(chain, 2 * iters)
    if not bool(torch.isfinite(chain()).all()):
        raise RuntimeError("K1's chained evaluations are not finite")
    flops = 4.0 * n_chains * n_obs * n_feat
    tflops = flops * iters / (ms * 1e-3) / 1e12
    return {"kernel": "fused_logistic_value_grad", "chains": n_chains,
            "obs": n_obs, "dim": n_feat, "evaluations": iters, "ms": ms,
            "eval_ms": ms / iters, "achieved_TFLOPs": tflops,
            "peak_TFLOPs_f32": PEAK_FP32_FLOPS / 1e12,
            "peak_TFLOPs_tf32_3pass": PEAK_TF32_TC / 3 / 1e12,
            "roofline_frac": tflops * 1e12 / max(PEAK_FP32_FLOPS,
                                                 PEAK_TF32_TC / 3),
            "launches": LOGISTIC_VG.launches, "card": card}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="shorter chains of launches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("roofline_torch: no CUDA device (the harness "
                           "measures the card; it has no CPU fallback)")
    card = card_line()
    scale = 8 if args.quick else 1
    out = [bench_fused_leapfrog(card, iters=512 // scale),
           bench_multistep_leapfrog(card, launches=16 // min(scale, 4)),
           bench_logistic(card, iters=64 // scale)]
    for o in out:
        print(json.dumps(o), flush=True)
    return out


if __name__ == "__main__":
    main()
