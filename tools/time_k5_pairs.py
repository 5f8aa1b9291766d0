#!/usr/bin/env python3
"""Time K5's launchers of two checkouts against each other on one card.

Builds ``tree_<physics>.cu`` of this checkout and of the checkout
``--old`` (the C interface ``TREE_LAUNCH_PARAMS``; an older checkout whose
launchers take no ``ckpt_bf16`` argument is called without it, and this
checkout's launches then run float32 stacks as it does), then for each
case launches both on the same inputs (the same key: their outputs must be
equal bit for bit) in ``--pairs`` alternating pairs, old then new, new
then old, each side timed with CUDA events as the mean of ``--reps``
launches queued back to back after one warm-up (``chip_smoke.cuda_time_ms``).  Prints each pair, the medians, the spread of
each side's own times and the median of new / old.  Cases (max_depth 10,
one transition drawing its momentum, direction and uniforms, the momentum
through ``mass_chol``):

* ``logistic``: K5-logistic, BASELINE config 3 (8,192 chains x 10,000 x
  50, ``chip_smoke.logistic_problem``), dense M^-1 the Laplace
  covariance, eps half the stability limit, start drawn about the truth;
* ``stoch_vol``: K5-stoch_vol's dense launcher at T = 100 (1,024 x 102),
  start ``chip_smoke.tile_start``, an SPD M^-1 (``chip_smoke._spd``),
  eps 0.02;
* ``stoch_vol_wide``: the same at T = 1,000 (1,024 x 1,002: the wide
  form, which an ``--old`` checkout must have too)::

    python3 tools/time_k5_pairs.py --old DIR [--cases logistic stoch_vol]
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


def _case(name: str):
    """(physics, phys, q0, minv, eps) of a case, on the card."""
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="the earlier checkout")
    ap.add_argument("--cases", nargs="+", default=["logistic", "stoch_vol"],
                    choices=["logistic", "stoch_vol", "stoch_vol_wide"])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops import tree
    from inplacedhmc_tpu_torch.ops.cuda_build import CudaKernel, build_all

    old_dir = os.path.abspath(args.old)
    with open(os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                           "tree_kernel.cuh")) as f:
        old_takes_bf16 = "ckpt_bf16" in f.read()
    # the ckpt_bf16 argument's place among the launcher's arguments: before
    # min_delta and the stream
    at = len(tree.TREE_DENSE_KERNELS["stoch_vol"].argtypes) - 3

    class OldKernel(CudaKernel):
        @property
        def source_path(self) -> str:
            return os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                                self.source)

        def launch(self, *a):
            if not old_takes_bf16:
                if a[at]:
                    raise ValueError("the old checkout has no bf16 stacks")
                a = a[:at] + a[at + 1:]
            super().launch(*a)

    physics = sorted({"logistic" if c == "logistic" else "stoch_vol"
                      for c in args.cases})
    new = {p: tree.TREE_DENSE_KERNELS[p] for p in physics}
    old = {p: OldKernel(k.source, k.symbol,
                        k.argtypes if old_takes_bf16
                        else k.argtypes[:at] + k.argtypes[at + 1:])
           for p, k in new.items()}
    build_all(list(new.values()))   # one nvcc per source and checkout
    build_all(list(old.values()))
    card = cs.card_line()
    key = cs._key(cs.SEED + 71)
    for name in args.cases:
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
        times = {"old": [], "new": []}
        for i in range(args.pairs):
            order = ("old", "new") if i % 2 == 0 else ("new", "old")
            for side in order:
                kern = old[p] if side == "old" else new[p]
                times[side].append(cs.cuda_time_ms(
                    lambda: run(kern), iters=args.reps, warmup=1))
            print(f"[pairs] {name} pair {i} ({order[0]} first): old "
                  f"{times['old'][-1]:.4f} ms, new {times['new'][-1]:.4f} ms")
        mo, mn = (statistics.median(times[s]) for s in ("old", "new"))
        ratio = statistics.median(n / o for o, n in zip(times["old"],
                                                        times["new"]))
        print(f"[pairs] {name}, {q0.shape[0]} x {q0.shape[1]}, eps "
              f"{eps:.4g}, {steps:.0f} steps, outputs equal bit for bit, on "
              f"{card}: old median {mo:.4f} ms (spread "
              f"{min(times['old']):.4f}-{max(times['old']):.4f}), new "
              f"median {mn:.4f} ms (spread {min(times['new']):.4f}-"
              f"{max(times['new']):.4f}); new / old median {ratio:.4f} over "
              f"{args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
