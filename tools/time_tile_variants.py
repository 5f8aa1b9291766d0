#!/usr/bin/env python3
"""Time variants of K5-logistic's tile form at BASELINE config 3.

Each variant is a copy of this checkout's package under ``--out`` with
``csrc/tree_logistic.cu`` or ``csrc/tree_kernel.cuh`` patched (the
``VARIANTS`` table: text replaced, each replacement checked to apply).
All are built at once (one process each), then timed in separate
processes, in order and again in reverse order, on config 3's data
(``chip_smoke.logistic_problem``: 8,192 chains x 10,000 x 50), chains
drawn about the coefficients from the Laplace covariance, eps 0.637, with
the momentum and direction words given and the uniforms drawn in the
kernel:

* max_depth 1, the dense launcher (its M^-1 the covariance) and the
  diagonal one (its diagonal): three evaluations of the tile's physics
  each (the start, one leaf, the final gradient), so a third of the time
  is an evaluation of all chains, whatever a variant does to the
  trajectories; the difference of the two launchers bounds what the dense
  metric's ``[D, D]`` products of one leaf and one start cost;
* max_depth 10, the dense launcher (the ``base`` variant only: the others
  may change the trajectories), with the trees' depths;
* both with float32 products and under ``grad_bf16``.

Each line names the card (``nvidia-smi``'s name and power limit)::

    python3 tools/time_tile_variants.py [--out DIR] [VARIANT ...]

Variants: ``base`` (this checkout), ``bt3`` and ``bt2`` (at most 3 or 2
observation tiles a batch: the ring's size), ``acc1`` (the forward's three
passes in one sum), ``tc8x2`` (tiles of 8 chains, two blocks an SM: the
plan sized to half an SM's shared memory, 128 registers a thread).  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, L = "tree_kernel.cuh", "tree_logistic.cu"
VARIANTS = {
    "base": [],
    "bt3": [(K, "constexpr int MAX_BATCH_TILES = 4;",
             "constexpr int MAX_BATCH_TILES = 3;")],
    "bt2": [(K, "constexpr int MAX_BATCH_TILES = 4;",
             "constexpr int MAX_BATCH_TILES = 2;")],
    "acc1": [(L, "mma_tf32(elh, al, bh0, bh1);",
              "mma_tf32(ehh, al, bh0, bh1);"),
             (L, "mma_tf32(ehl, ah, word(st + OFF_LO, o)",
              "mma_tf32(ehh, ah, word(st + OFF_LO, o)")],
    "tc8x2": [(L, "kTileChains = NV > 4 ? 8 : 16;", "kTileChains = 8;"),
              (K, "        if (bytes <= SMEM_LIMIT) {\n"
                  "          *out = {PATH_REGISTER, tc, P::ring_stages",
               "        if (bytes <= SM_SMEM / 2 - BLOCK_RESERVED) {\n"
               "          *out = {PATH_REGISTER, tc, P::ring_stages"),
              (K, "T::kWide || T::kTile || P::kNV > 4 || "
                  "kStagedOf<T, P, kDense> ? 1 : 4)",
               "T::kWide || P::kNV > 4 || kStagedOf<T, P, kDense> ? 1 "
               ": T::kTile ? 2 : 4)")],
}


def make(out: str, name: str) -> str:
    """The variant's copy of the package under ``out``; returns its root."""
    d = os.path.join(out, name)
    if os.path.exists(d):
        shutil.rmtree(d)
    shutil.copytree(os.path.join(HERE, "inplacedhmc_tpu_torch"),
                    os.path.join(d, "inplacedhmc_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for f, old, new in VARIANTS[name]:
        p = os.path.join(d, "inplacedhmc_tpu_torch", "csrc", f)
        with open(p) as fh:
            s = fh.read()
        if old not in s:
            raise ValueError(f"variant {name}: {old!r} not in {f}")
        with open(p, "w") as fh:
            fh.write(s.replace(old, new))
    return d


BUILD = ("from inplacedhmc_tpu_torch.ops.tree import TREE_DENSE_KERNELS as K;"
         "from inplacedhmc_tpu_torch.ops.cuda_build import build_all;"
         "build_all([K['logistic']])")


def time_one(name: str) -> None:
    """The timings of the variant whose package comes first on the path."""
    import torch

    import chip_smoke as cs
    import inplacedhmc_tpu_torch
    from inplacedhmc_tpu_torch.ops import tree
    print(f"{name}: package {os.path.dirname(inplacedhmc_tpu_torch.__file__)}"
          f", plan {tree.plan_on_card('logistic', cs.D, 10, True)}")
    x, y, beta, h, cov, data = cs.logistic_problem()
    card = cs.card_line()
    for bf16 in (False, True):
        phys = tree.bind("logistic", {**data, "grad_bf16": float(bf16)},
                         "cuda", torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(7)
        q0 = cs._laplace_draws(beta, cov, cs.C, 7)
        e = torch.full((cs.C,), 0.637, device="cuda")
        chol = torch.linalg.cholesky(torch.linalg.inv(cov)).float()
        p0 = (torch.randn((cs.C, cs.D), generator=gen, device="cuda")
              @ chol.T).contiguous()
        d32 = tree.direction_words_int32(torch.randint(
            0, 2 ** 32, (cs.C,), generator=gen, dtype=torch.int64,
            device="cuda"))
        key = cs._key(9)
        dense = cov.float().contiguous()
        diag = torch.diagonal(dense).contiguous()
        res = []
        for metric, m in (("dense", dense), ("diagonal", diag)):
            def one(m=m):
                return tree.tree_transition(q0, p0, e, d32, None, phys, m, 1,
                                            -1000.0, key=key)
            one()
            torch.cuda.synchronize()
            ms = cs.cuda_time_ms(one, 10, 2)
            res.append(f"max_depth 1, {metric}: {ms:.4f} ms "
                       f"({ms / 3:.4f} an evaluation)")
        if name == "base":
            def full():
                return tree.tree_transition(q0, p0, e, d32, None, phys,
                                            dense, 10, -1000.0, key=key)
            out = full()
            torch.cuda.synchronize()
            ms = cs.cuda_time_ms(full, 5, 1)
            tiles = out.steps.view(-1, 16).amax(1).double()
            res.append(f"max_depth 10, dense: {ms:.4f} ms (depth mean "
                       f"{out.depth.double().mean():.3f}, steps max "
                       f"{int(out.steps.max())}, a tile's most steps mean "
                       f"{tiles.mean():.2f})")
        print(f"[variant] {name}, grad_bf16 {bf16}, 8192 x 10,000 x 50, on "
              f"{card}: " + "; ".join(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", help=f"of {list(VARIANTS)} "
                    f"(default all)")
    ap.add_argument("--out", default=os.path.join(HERE, "_cmp", "var"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        time_one(args.one)
        return 0
    names = args.variants or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    dirs = {n: make(args.out, n) for n in names}
    builds = {n: subprocess.Popen([sys.executable, "-c", BUILD],
                                  env={**os.environ, "PYTHONPATH": d}, cwd=d)
              for n, d in dirs.items()}
    if any(p.wait() for p in builds.values()):
        raise RuntimeError("a variant did not build")
    for order in (names, names[::-1]):
        for n in order:
            # the variant's package first, this checkout after it (for
            # chip_smoke and tools.card)
            env = {**os.environ,
                   "PYTHONPATH": os.pathsep.join([dirs[n], HERE])}
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", n], env=env, cwd=dirs[n], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
