#!/usr/bin/env python3
"""Compare the machine code of K5's instantiations in two checkouts.

Builds every ``tree_<physics>.cu`` of ``inplacedhmc_tpu_torch/csrc`` in the
checkouts ``--old`` and ``--new`` with the port's own ``nvcc`` flags (one
process per source, all started together), dumps their SASS with
``cuobjdump -sass`` and matches each ``tree_kernel`` instantiation of one
to the other's by its physics, its NV, its metric form (diagonal or
dense) and its team (one warp, a block of warps: the wide form, a
cluster of such blocks: the wide form's cluster path, or a tile of chains
in lockstep: the tile form), read
from the mangled names, whatever else the names hold.  For each pair it
prints whether the instruction streams are identical (addresses and
encodings stripped) and, where not, how many instructions each has and how
many lines differ; beside it, ptxas's registers and spill bytes of each.
Exits 1 if a pair differs, with ``--expect-same``.  An instantiation that
only one checkout has is listed as new or gone::

    python3 tools/compare_sass.py --old DIR --new DIR [--expect-same]
        [--out DIR]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import difflib
import glob
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from inplacedhmc_tpu_torch.ops.cuda_build import NVCC_FLAGS, find_nvcc  # noqa: E402

_KEY = re.compile(r"tree_kernel.*?\d+([A-Za-z]+)ILi(\d+)EEELb([01])E")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/")


def _key(name: str):
    """(physics, NV, metric, team) of a mangled tree_kernel name, or None."""
    m = _KEY.search(name)
    if m is None:
        return None
    team = "block" if "5BlockE" in name or "tree_kernel_wide" in name \
        else "cluster" if "7ClusterE" in name \
        else "tile" if "4TileE" in name else "warp"
    return (m.group(1), int(m.group(2)),
            "dense" if m.group(3) == "1" else "diagonal", team)


def _build(src: str, out: str):
    """The library of ``src`` under ``out``, its ptxas report and SASS."""
    lib = os.path.join(out, os.path.basename(src) + ".so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    return proc.stdout + proc.stderr, sass


def _functions(log: str, sass: str) -> dict:
    """{key: (instruction lines, registers, spill bytes)} of one source."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[name] = [None, int(st) + int(ld)]
        elif name and "Used" in line and "registers" in line:
            usage.setdefault(name, [None, None])[0] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        key = _key(name)
        if key is None:
            continue
        code = [_ADDR.sub("", ln).strip() for ln in block.splitlines()[1:]]
        code = [ln for ln in code if ln and not ln.startswith(".")]
        regs, spill = usage.get(name, (None, None))
        out[key] = (code, regs, spill)
    return out


def _all(root: str, out: str) -> dict:
    srcs = sorted(glob.glob(os.path.join(root, "inplacedhmc_tpu_torch",
                                         "csrc", "tree_*.cu")))
    os.makedirs(out, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda s: _build(s, out), srcs))
    funcs = {}
    for log, sass in built:
        funcs.update(_functions(log, sass))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="the earlier checkout")
    ap.add_argument("--new", default=HERE, help="the later checkout")
    ap.add_argument("--out", default=None, help="build directory")
    ap.add_argument("--expect-same", action="store_true",
                    help="exit 1 if a pair's instructions differ")
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp(prefix="compare_sass_")
    old = _all(args.old, os.path.join(out, "old"))
    new = _all(args.new, os.path.join(out, "new"))
    differ = 0
    for key in sorted(set(old) | set(new)):
        label = "%s<NV %d>, %s metric, %s" % key
        if key not in old or key not in new:
            print(f"[sass] {label}: {'new' if key in new else 'gone'}")
            continue
        (a, ra, sa), (b, rb, sb) = old[key], new[key]
        regs = f"registers {ra} -> {rb}, spill bytes {sa} -> {sb}"
        if a == b:
            print(f"[sass] {label}: identical ({len(a)} instructions; "
                  f"{regs})")
            continue
        differ += 1
        n = sum(1 for ln in difflib.unified_diff(a, b, lineterm="", n=0)
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---"))
        print(f"[sass] {label}: DIFFERENT ({len(a)} -> {len(b)} "
              f"instructions, {n} lines differ; {regs})")
    print(f"[sass] {differ} pairs differ")
    return 1 if args.expect_same and differ else 0


if __name__ == "__main__":
    sys.exit(main())
