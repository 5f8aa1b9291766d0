#!/usr/bin/env python3
"""Time the sampling loop of the default route of a standard normal.

``sample()`` without ``tree_opts`` runs one whole-tree transition per NUTS
transition while it samples: host draws of the momentum and the direction
words, one K5 launch, and the statistics.  This script times that loop
(``adapt.warmup.run_sampling`` with ``NUTSKernel``'s factories) on the
``--dim``-D standard normal (100 by default) at the identity metric and eps
0.3, from the same normal start, at each of ``--chains``: ``--transitions``
transitions, synchronised at both ends, best of ``--repeats``.  It prints
the wall per transition and checks that each transition launched K5 once;
where the route is the lockstep tree with K3 (outside K5's bound,
``ops.tree.takes``), it checks that K3 ran and K5 did not.

``--root DIR`` imports ``inplacedhmc_tpu_torch`` from the checkout at
``DIR`` instead of this one (for example an earlier commit unpacked with
``git archive``), so that two versions are timed by the same script::

    python3 tools/time_sampling_loop.py [--root DIR] [--chains 64 10240]
        [--transitions 200] [--repeats 5] [--dim 100]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose inplacedhmc_tpu_torch is timed")
    ap.add_argument("--chains", type=int, nargs="+", default=[64, 10_240])
    ap.add_argument("--transitions", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dim", type=int, default=None,
                    help="the normal's dimension (default chip_smoke's "
                         "G_DIM, 100); above 256 K5's wide form")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("time_sampling_loop: no CUDA device", file=sys.stderr)
        return 1
    import inplacedhmc_tpu_torch as pkg
    from inplacedhmc_tpu_torch import NUTS
    from inplacedhmc_tpu_torch.adapt import warmup as W
    from inplacedhmc_tpu_torch.models import std_normal
    from inplacedhmc_tpu_torch.ops.leapfrog import LEAPFROG_GAUSSIAN
    from inplacedhmc_tpu_torch.ops.tree import TREE_GAUSSIAN
    from inplacedhmc_tpu_torch.sample import NUTSKernel, f32_matmuls

    card = chip_smoke.card_line()
    dim = args.dim or chip_smoke.G_DIM
    kern = NUTSKernel(std_normal(dim, device="cuda"), NUTS())
    print(f"[sampling loop] package {os.path.dirname(pkg.__file__)} on "
          f"{card}")
    for c in args.chains:
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + c)
        n = args.transitions
        with f32_matmuls():
            state = W.init_warmup_state(gen, kern.potential, dim, c,
                                        device="cuda", eps=0.3)

            def run(k):
                return W.run_sampling(
                    gen, kern.potential, kern.algorithm, state, k,
                    step_factory=kern.step_factory,
                    transition_factory=kern.transition_factory)

            run(2)
            torch.cuda.synchronize()
            before = TREE_GAUSSIAN.launches
            k3_before = LEAPFROG_GAUSSIAN.launches
            best = float("inf")
            for _ in range(args.repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(n)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
        k5 = TREE_GAUSSIAN.launches - before
        k3 = LEAPFROG_GAUSSIAN.launches - k3_before
        if kern.transition_factory(state.metric, c) is None:
            if k5 or not k3:
                raise RuntimeError("the lockstep loop did not run on K3 alone")
        elif k5 != args.repeats * n:
            raise RuntimeError("the loop did not launch K5 once a transition")
        print(f"[sampling loop] {dim}-D, {c} chains, eps 0.3 on {card}: "
              f"{best / n * 1e3:.4f} ms of wall per transition (best of "
              f"{args.repeats} x {n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
