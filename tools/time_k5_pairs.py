#!/usr/bin/env python3
"""Time kernels of two checkouts against each other on one card.

Builds the sources of this checkout and of the checkout ``--old`` (an
older launcher without an argument this checkout's has, the ``ckpt_bf16``
of K5's or the ``grad_bf16`` of K1's, is called without it, and this
checkout's then runs with it 0), then for each case launches both on the
same inputs (their outputs must be equal bit for bit) in ``--pairs``
alternating pairs, old then new, new then old, each side timed with CUDA
events as the mean of ``--reps`` launches queued back to back after one
warm-up (``chip_smoke.cuda_time_ms``).  Prints each pair, the medians,
the spread of each side's own times and the median of new / old.  Cases:

* ``logistic``: K5-logistic's dense launcher, BASELINE config 3 (8,192
  chains x 10,000 x 50, ``chip_smoke.logistic_problem``), dense M^-1 the
  Laplace covariance, eps half the stability limit, start drawn about the
  truth;
* ``stoch_vol``: K5-stoch_vol's dense launcher at T = 100 (1,024 x 102),
  start ``chip_smoke.tile_start``, an SPD M^-1 (``chip_smoke._spd``),
  eps 0.02;
* ``stoch_vol_wide``: the same at T = 1,000 (1,024 x 1,002: the wide
  form, which an ``--old`` checkout must have too);
* ``k1``: K1 (``csrc/logistic_vg.cu``) at config 3's shape, chains about
  the true coefficients;
* ``k3``: K3 (``csrc/leapfrog_gaussian.cu``) at 64 x 1000 (the lockstep
  1000-D run's step) and at 10,240 x 100.

The K5 cases run max_depth 10, one transition drawing its momentum,
direction and uniforms, the momentum through ``mass_chol``::

    python3 tools/time_k5_pairs.py --old DIR [--cases logistic k1 k3]
        [--pairs 12] [--reps 5]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CASES = ("logistic", "stoch_vol", "stoch_vol_wide", "k1", "k3")


def _case(name: str):
    """(physics, phys, q0, minv, eps) of a K5 case, on the card."""
    import torch

    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 70)
    if name == "logistic":
        _, _, beta, h, cov, data = cs.logistic_problem()
        chol = torch.linalg.cholesky(cov)
        limit = 2.0 / torch.linalg.eigvalsh(chol.T @ h @ chol).max() \
            .item() ** 0.5
        q0 = (beta.double() + torch.randn(
            (cs.C, cs.D), generator=gen, dtype=torch.float64,
            device="cuda") @ chol.T).float().contiguous()
        return ("logistic", cs._physics("logistic", data), q0,
                cov.float().contiguous(), 0.5 * limit)
    t = cs.SV_WIDE_T if name == "stoch_vol_wide" else cs.SV_T
    st = cs.tile_model("stoch_vol", t).structure
    phys = cs._physics("stoch_vol", {**st["data"], **st["scalars"]})
    q0 = cs.tile_start("stoch_vol", cs.E_CHAINS, gen, sv_t=t)
    return ("stoch_vol", phys, q0, cs._spd(t + 2, gen).contiguous(), 0.02)


def _leaf_cases(names):
    """(label, attribute of ``ops.logistic`` or ``ops.leapfrog`` holding the
    kernel, its module, call) of the K1 and K3 cases, on the card."""
    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops import leapfrog, logistic
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 80)
    cases = []
    if "k1" in names:
        x, y, beta = synthetic_data(cs.SEED, cs.N, cs.D, device="cuda")
        q = beta + 0.1 * torch.randn((cs.C, cs.D), generator=gen,
                                     device="cuda")
        w = torch.ones_like(y)
        cases.append((f"k1, {cs.C} x {cs.N} x {cs.D}", "LOGISTIC_VG",
                      logistic, lambda: logistic.logistic_value_and_grad(
                          q, x, y, w, cs.INV_VAR)))
    if "k3" in names:
        for c, d in ((cs.S_CHAINS, cs.W_DIM), (cs.G_CHAINS, cs.G_DIM)):
            lam = 0.5 + torch.rand((d,), generator=gen, device="cuda")
            minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
            q3 = torch.randn((c, d), generator=gen, device="cuda")
            p3 = torch.randn((c, d), generator=gen, device="cuda")
            e = torch.full((c,), 0.3, device="cuda")
            cases.append((
                f"k3, {c} x {d}", "LEAPFROG_GAUSSIAN", leapfrog,
                lambda q3=q3, p3=p3, e=e, lam=lam, minv=minv:
                    leapfrog.fused_gaussian_leapfrog(q3, p3, e, lam, minv)))
    return cases


def time_pairs(label: str, run_old, run_new, pairs: int, reps: int,
               card: str) -> None:
    """Time ``run_old()`` and ``run_new()`` in ``pairs`` alternating pairs
    (old first, then new first), each side the mean of ``reps`` calls
    queued back to back after one warm-up (``chip_smoke.cuda_time_ms``);
    print each pair, the medians, each side's spread and the median of new
    / old, under ``label`` (which names the case and its shape)."""
    import chip_smoke as cs
    times = {"old": [], "new": []}
    runs = {"old": run_old, "new": run_new}
    for i in range(pairs):
        order = ("old", "new") if i % 2 == 0 else ("new", "old")
        for side in order:
            times[side].append(cs.cuda_time_ms(runs[side], iters=reps,
                                               warmup=1))
        print(f"[pairs] {label} pair {i} ({order[0]} first): old "
              f"{times['old'][-1]:.4f} ms, new {times['new'][-1]:.4f} ms")
    mo, mn = (statistics.median(times[s]) for s in ("old", "new"))
    ratio = statistics.median(n / o for o, n in zip(times["old"],
                                                    times["new"]))
    print(f"[pairs] {label}, outputs equal bit for bit, on {card}: old "
          f"median {mo:.4f} ms (spread {min(times['old']):.4f}-"
          f"{max(times['old']):.4f}), new median {mn:.4f} ms (spread "
          f"{min(times['new']):.4f}-{max(times['new']):.4f}); new / old "
          f"median {ratio:.4f} over {pairs} pairs")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="the earlier checkout")
    ap.add_argument("--cases", nargs="+", default=["logistic", "stoch_vol"],
                    choices=CASES)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops import logistic, tree
    from inplacedhmc_tpu_torch.ops.cuda_build import CudaKernel, build_all

    old_dir = os.path.abspath(args.old)

    def old_has(source: str, word: str) -> bool:
        with open(os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                               source)) as f:
            return word in f.read()

    # arguments an older launcher may lack: its place among the arguments,
    # before the stream (and K5's min_delta)
    lacks = {k.symbol: len(k.argtypes) - 3
             for k in tree.TREE_DENSE_KERNELS.values()
             if not old_has("tree_kernel.cuh", "ckpt_bf16")}
    if not old_has("logistic_vg.cu", "grad_bf16"):
        lacks[logistic.LOGISTIC_VG.symbol] = \
            len(logistic.LOGISTIC_VG.argtypes) - 2

    class OldKernel(CudaKernel):
        def __init__(self, new: CudaKernel):
            self.at = lacks.get(new.symbol)
            types = list(new.argtypes)
            if self.at is not None:
                del types[self.at]
            super().__init__(new.source, new.symbol, types)

        @property
        def source_path(self) -> str:
            return os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                                self.source)

        def launch(self, *a):
            if self.at is not None:
                if a[self.at]:
                    raise ValueError(f"the old {self.symbol} lacks an "
                                     f"argument this call sets")
                a = a[:self.at] + a[self.at + 1:]
            super().launch(*a)

    k5_cases = [c for c in args.cases if c not in ("k1", "k3")]
    physics = sorted({"logistic" if c == "logistic" else "stoch_vol"
                      for c in k5_cases})
    new = {p: tree.TREE_DENSE_KERNELS[p] for p in physics}
    leaves = _leaf_cases(args.cases)
    new.update({attr: getattr(module, attr) for _, attr, module, _ in leaves})
    old = {key: OldKernel(k) for key, k in new.items()}
    build_all(list(new.values()))   # one nvcc per source and checkout
    build_all(list(old.values()))
    card = cs.card_line()
    key = cs._key(cs.SEED + 71)
    for name in k5_cases:
        p, phys, q0, minv, eps = _case(name)
        e = torch.full((q0.shape[0],), eps, device="cuda")
        scale = dense_metric(minv).mass_chol.T.contiguous()

        def run(kernel):
            tree.TREE_DENSE_KERNELS[p] = kernel
            try:
                return tree.tree_sweep(q0, e, phys, minv, cs.MAX_DEPTH,
                                       -1000.0, key=key, sqrt_mass=scale)
            finally:
                tree.TREE_DENSE_KERNELS[p] = new[p]

        a, b = run(old[p]), run(new[p])
        differ = [f for f in tree.TreeOut._fields
                  if not torch.equal(getattr(a, f), getattr(b, f))]
        if differ:
            raise RuntimeError(f"{name}: old and new differ in {differ}")
        steps = float(b.steps.sum())
        time_pairs(f"{name}, {q0.shape[0]} x {q0.shape[1]}, eps {eps:.4g}, "
                   f"{steps:.0f} steps", lambda: run(old[p]),
                   lambda: run(new[p]), args.pairs, args.reps, card)
    for label, attr, module, call in leaves:
        def run(kernel, attr=attr, module=module, call=call):
            setattr(module, attr, kernel)
            try:
                return call()
            finally:
                setattr(module, attr, new[attr])

        a, b = run(old[attr]), run(new[attr])
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise RuntimeError(f"{label}: old and new differ")
        time_pairs(label, lambda: run(old[attr]), lambda: run(new[attr]),
                   args.pairs, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
