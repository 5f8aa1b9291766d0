#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``inplacedhmc_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed with its wall time:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build every kernel of the main path from ``inplacedhmc_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together);
2. hold each kernel against its plain PyTorch version at the main path's
   full width and time the kernel, the plain version and one library
   composition of the same function, beside the card's bound;
3. ``sample()`` on BASELINE config 3 (logistic regression, 10,000 x 50 data
   from a seed, 8192 chains, dense metric, a short warmup schedule, 128
   draws) with every kernel's launch count reset just before and read just
   after, and the posterior checked (finite draws, split R-hat, acceptance,
   agreement of the posterior mean with the true coefficients).

It prints a ``{"kernels": [...]}`` line, the card's line, and as its last
line ``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero; without a CUDA device, or without the package beside it, it
exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20261017
C, N, D = 8192, 10_000, 50        # chains, observations, features
N_DRAWS = 128
# K1 sums N = 1e4 f32 terms per chain in another order than the float64
# reference: a random-walk rounding error of about sqrt(N) * 2^-24 = 6e-6 of
# sum_n |term_n|, so logp is held to 1e-5 of that sum.  The gradient's
# components cancel (resid * x of both signs), so its error is held against
# max |grad| with ten times the room.
LOGP_TOL = 1e-5   # |logp - ref| / sum_n |term_n|
GRAD_TOL = 1e-4   # |grad - ref| / max |ref grad|
PEAK_FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels():
    """Build every kernel of the main path (K1, one nvcc call)."""
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG
    LOGISTIC_VG.build()
    print(f"[build] {LOGISTIC_VG.source}: {LOGISTIC_VG.build_seconds:.2f} s")
    for line in LOGISTIC_VG.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")
    return [LOGISTIC_VG]


def _library_logistic(q, x, y, w, s2):
    """One library composition of the same function: cuBLAS products and
    PyTorch's fused BCE-with-logits.  A yardstick only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    eta = torch.matmul(q, x.T)
    nll = F.binary_cross_entropy_with_logits(
        eta, y.expand_as(eta), weight=w, reduction="none").sum(1)
    logp = -nll - 0.5 * s2 * (q * q).sum(1)
    grad = torch.addmm(q, (y - torch.sigmoid(eta)) * w, x, beta=-s2)
    return logp, grad


def check_logistic_kernel(card: str) -> dict:
    """K1 against its plain version at C x N x D, with one NaN chain."""
    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, logistic_value_and_grad, logistic_value_and_grad_plain)

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = beta + 0.1 * torch.randn((C, D), generator=gen, device="cuda")
    q[1, 3] = float("nan")
    w = torch.ones_like(y)
    s2 = 0.01
    before = LOGISTIC_VG.launches
    logp, grad = logistic_value_and_grad(q, x, y, w, s2)
    torch.cuda.synchronize()
    if LOGISTIC_VG.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K1 on a CUDA tensor")

    # reference: the plain version on the same inputs, in float64
    q64, x64, y64, w64 = (t.double() for t in (q, x, y, w))
    lp_ref, g_ref = logistic_value_and_grad_plain(q64, x64, y64, w64, s2)
    eta = q64 @ x64.T
    scale = (w64 * (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta))
             ).abs().sum(1) + 0.5 * s2 * (q64 * q64).sum(1)
    ok = torch.isfinite(lp_ref)
    if not (torch.equal(torch.isfinite(logp), ok) and logp[1] == -torch.inf
            and bool((grad[1] == 0).all())):
        raise RuntimeError("K1 guard: the NaN chain must give -inf and a "
                           "zero gradient, and only it")
    lp_err = ((logp.double() - lp_ref).abs()[ok] / scale[ok]).max().item()
    g_err = ((grad.double() - g_ref).abs().max()
             / g_ref.abs().max()).item()
    abs_err = max((logp.double() - lp_ref).abs()[ok].max().item(),
                  (grad.double() - g_ref).abs().max().item())
    print(f"[k1] logp err / sum|terms| = {lp_err:.3e} (tol {LOGP_TOL:g}), "
          f"grad err / max|grad| = {g_err:.3e} (tol {GRAD_TOL:g}), "
          f"max abs err {abs_err:.3e}")
    if not (lp_err <= LOGP_TOL and g_err <= GRAD_TOL):
        raise RuntimeError("K1 disagrees with its plain version")

    qf = q.clone()
    qf[1, 3] = 0.0
    ms = cuda_time_ms(lambda: logistic_value_and_grad(qf, x, y, w, s2))
    plain_ms = cuda_time_ms(
        lambda: logistic_value_and_grad_plain(qf, x, y, w, s2))
    library_ms = cuda_time_ms(lambda: _library_logistic(qf, x, y, w, s2))
    flops = 4.0 * C * N * D
    nbytes = 4.0 * (C * D + N * D + 2 * N) + 4.0 * (C + C * D)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = ("operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES
                else "bytes")
    print(f"[k1] {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"name": "logistic_value_and_grad", "route": "cuda",
            "source": "inplacedhmc_tpu_torch/csrc/logistic_vg.cu",
            "replaces": "inplacedhmc_tpu/ops/logistic_pallas.py:71",
            "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


class StageTimer:
    """Reporter that records each stage's wall time, synchronising the card
    at both ends."""

    def __init__(self):
        self.stages = []

    def start_stage(self, name, total_steps=0):
        import torch
        torch.cuda.synchronize()
        self._name, self._t0 = name, time.perf_counter()

    def end_stage(self, **info):
        import torch
        torch.cuda.synchronize()
        self.stages.append((self._name, time.perf_counter() - self._t0))


def run_sample(card: str, kernels) -> dict:
    """``sample()`` at full width through K1, with the posterior checked."""
    import torch

    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              synthetic_data)

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    model = logistic_regression(x, y, device="cuda")
    stages = default_warmup_stages(init_steps=50, middle_steps=50,
                                   doubling_stages=2, terminating_steps=50,
                                   metric="dense")
    timer = StageTimer()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = sample(SEED, model, N_DRAWS, C, warmup_stages=stages,
                 reporter=timer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.source: k.launches for k in kernels}

    for name, sec in timer.stages:
        print(f"[sample] {name}: {sec:.2f} s on {card}")
    print(f"[sample] total {wall:.2f} s on {card}")
    sample_s = timer.stages[-1][1]

    stats, wstats = res.stats, res.warmup_stats
    # every lockstep transition runs at least its longest chain's steps,
    # one K1 launch each
    min_launches = int(stats.steps.amax(dim=1).sum() +
                       wstats.steps.amax(dim=1).sum())
    print(f"[sample] K1 launches {launches['logistic_vg.cu']} "
          f"(lockstep leapfrog steps >= {min_launches})")
    if launches["logistic_vg.cu"] < min_launches:
        raise RuntimeError("the main path did not go through K1")

    draws = res.draws
    if tuple(draws.shape) != (N_DRAWS, C, D) \
            or not bool(torch.isfinite(draws).all()):
        raise RuntimeError("draws are not finite or not [n_draws, C, D]")
    rhat = diag.split_rhat(draws.double()).max().item()
    ess = diag.ess_bulk(draws.double(), cap=False)
    accept = stats.acceptance_rate.double().mean().item()
    post_mean = draws.double().mean(dim=(0, 1))
    corr = torch.corrcoef(torch.stack([post_mean, beta.double()]))[0, 1].item()
    chain_steps = int(stats.steps.sum())
    print(f"[sample] eps {torch.exp(res.warmup_state.log_eps).item():.5g}, "
          f"split R-hat max {rhat:.4f}, acceptance mean {accept:.4f}, "
          f"corr(posterior mean, beta_true) {corr:.5f}")
    print(f"[sample] {card}: {chain_steps / sample_s:.4g} leapfrog steps/s "
          f"(chain steps while sampling / sampling wall), "
          f"ess_bulk min {ess.min().item():.4g} -> "
          f"{ess.min().item() / sample_s:.4g} ESS/s")
    print(diag.summarize_tree_statistics(stats))
    if not rhat < 1.05:
        raise RuntimeError(f"split R-hat {rhat} >= 1.05")
    if not 0.6 <= accept <= 0.95:
        raise RuntimeError(f"mean acceptance {accept} outside [0.6, 0.95]")
    if not corr > 0.95:
        raise RuntimeError(f"posterior mean vs beta_true corr {corr} <= 0.95")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import inplacedhmc_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    kernels = build_kernels()
    print(f"[phase] build {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    k1 = check_logistic_kernel(card)
    print(f"[phase] kernel check {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches = run_sample(card, kernels)
    print(f"[phase] sample {time.perf_counter() - t:.2f} s")
    k1["launches"] = launches["logistic_vg.cu"]
    print(f"[sample] K1 device time about {k1['launches']} x {k1['ms']:.4f} "
          f"ms = {k1['launches'] * k1['ms'] / 1e3:.2f} s of sample()'s wall")
    print(f"[phase] total {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
