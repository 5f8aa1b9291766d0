"""The 3xTF32 products of the logistic kernel (``csrc/logistic_vg.cu``) and
the layout its launch depends on, on the CPU: ``ops/logistic.py``'s
``split_tf32`` against a float64 numpy rounding that mirrors
``cvt.rna.tf32.f32`` (nearest, ties away from zero), the halves' error,
the kernel's 3xTF32 products (modelled here on those halves) against
float64, the split plan (``launch_splits``, and the kernel's ranges of
tiles) and the planes (``logistic_planes``) against the data they hold,
and the tile constants against the source's.
No JAX: the kernel's CUDA tests are in ``tests/test_torch_cuda.py``."""

import itertools
import math
import os
import re

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (every xdist worker collects every test file, and the
    JAX suite's longest module sits a few memory mappings under the
    per-process limit, which torch's libraries would push it over)."""
    global torch, L
    import torch
    import inplacedhmc_tpu_torch.ops.logistic as L
    torch.set_num_threads(1)


def _rna_reference(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to tf32 (1 + 10 significand bits, float32's
    exponent range; subnormals keep float32's top 10 fraction bits) to
    nearest with ties away from zero, computed in float64 from the value
    and not from its bits; infinities and NaNs as they are."""
    v = v.astype(np.float32)
    out = v.astype(np.float64).copy()
    fin = np.isfinite(v) & (v != 0)
    a = np.abs(out[fin])
    _, e = np.frexp(a)                       # a = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, np.maximum(e - 11, -136))
    r = np.floor(a / ulp + 0.5) * ulp        # ties away from zero
    r = np.where(r >= 2.0 ** 128, np.inf, r)
    out[fin] = np.sign(out[fin]) * r
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _values(seed=0):
    """Values across float32's range, with exact ties and their
    neighbours, signed zeros, subnormals, the largest finite values (which
    round to infinity), infinities and a NaN."""
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(2000) * 10.0 ** rng.integers(-38, 38, 2000)]
    bits = rng.integers(0, 2 ** 31, 2000, dtype=np.uint32) & 0x7F7FE000
    for low in (0x1000, 0x0FFF, 0x1001, 0x0000, 0x1FFF):
        b = (bits | low).astype(np.uint32)
        vals += [b.view(np.float32), (b | 0x80000000).view(np.float32)]
    sub = rng.integers(1, 2 ** 23, 200, dtype=np.uint32)
    vals += [sub.view(np.float32), (sub | 0x1000).view(np.float32)]
    vals.append(np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                          np.float32(3.4028235e38), 2.0 ** -126,
                          1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11],
                         dtype=np.float32))
    return np.concatenate([v.astype(np.float32) for v in vals])


def _tf32x3_matmul(a, b):
    """``a @ b`` as the kernel's 3xTF32 products form it, in float32:
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` from ``split_tf32``'s halves
    (each product of two tf32 values exact in float32), the lo.lo term
    dropped."""
    (ah, al), (bh, bl) = L.split_tf32(a), L.split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _split_tiles(tiles, splits, s):
    """The tiles ``[t0, t1)`` of split ``s``, as the kernel computes them
    (``logistic_vg_kernel``'s t0, t1)."""
    return tiles * s // splits, tiles * (s + 1) // splits


def test_split_tf32_mirrors_cvt_rna_bit_for_bit():
    """``split_tf32``'s hi, and its lo from the float32 remainder, equal the
    float64 reference rounding bit for bit, ties included; every half has
    its 13 low bits clear."""
    v = _values()
    hi, lo = L.split_tf32(torch.as_tensor(v))
    want_hi = _rna_reference(v)
    same = np.isnan(want_hi) | (hi.numpy().view(np.uint32)
                                == want_hi.view(np.uint32))
    assert same.all()
    with np.errstate(invalid="ignore", over="ignore"):
        rem = (v - want_hi).astype(np.float32)
    want_lo = _rna_reference(rem)
    same = np.isnan(want_lo) | (lo.numpy().view(np.uint32)
                                == want_lo.view(np.uint32))
    assert same.all()
    fin = np.isfinite(hi.numpy())
    assert not (hi.numpy()[fin].view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy()[np.isfinite(lo.numpy())].view(np.uint32)
                & 0x1FFF).any()
    # the ties: a low half of exactly 0x1000 rounds away from zero
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    assert L.split_tf32(torch.as_tensor(tie))[0].tolist() \
        == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_split_tf32_halves_sum_within_2e_minus_22():
    """``hi + lo`` is within ``2^-22 |a|`` of a normal float32 ``a``: the
    3xTF32 products drop only the lo.lo term and what this leaves."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(20000)
         * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    hi, lo = (t.double().numpy() for t in L.split_tf32(torch.as_tensor(a)))
    a64 = a.astype(np.float64)
    assert (np.abs(a64 - hi - lo) <= 2.0 ** -22 * np.abs(a64)).all()
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(a64)).all()


@pytest.mark.parametrize("m,k,n", [(3, 7, 5), (16, 50, 8), (33, 300, 9),
                                   (16, 10000, 8)])
def test_tf32x3_matmul_within_its_bound_of_float64(m, k, n):
    """The products' model against float64: within
    ``(3 2^-22 + (k + 2) 2^-23) sum_k |a||b|`` (the three dropped or rounded
    halves' terms, and float32 sums of k terms and two more adds); where
    the sums' term does not dominate, one TF32 pass alone is outside it."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    bound = (3 * 2.0 ** -22 + (k + 2) * 2.0 ** -23) * scale
    got = _tf32x3_matmul(ta, tb).double().numpy()
    assert (np.abs(got - exact) <= bound).all()
    if k <= 300:
        one = (L.split_tf32(ta)[0] @ L.split_tf32(tb)[0]).double().numpy()
        assert (np.abs(one - exact) > bound).any()


def test_split_plan_covers_every_tile_once():
    """``launch_splits`` fills the card with the chains' blocks times the
    splits (one wave where the chains allow), gives each split at least
    ``MIN_SPLIT_TILES`` tiles where there are enough, and
    the kernel cuts the tiles into contiguous ranges in order, each
    tile in exactly one range."""
    for c, n, (blocks_per_sm, sms) in itertools.product(
            (0, 1, 31, 64, 65, 1000, 8192, 100000), (0, 1, 63, 65, 10000),
            ((3, 132), (2, 132), (4, 114), (1, 1))):
        s = L.launch_splits(c, n, blocks_per_sm, sms)
        tiles = math.ceil(n / L.TILE_OBS)
        chain_blocks = max(math.ceil(c / L.BLOCK_CHAINS), 1)
        assert 1 <= s <= 65535
        assert s == 1 or s * chain_blocks <= blocks_per_sm * sms
        assert s == 1 or tiles / s >= L.MIN_SPLIT_TILES
        ranges = [_split_tiles(tiles, s, i) for i in range(s)]
        assert ranges[0][0] == 0 and ranges[-1][1] == tiles
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(t1 - t0 >= (1 if tiles >= s else 0) for t0, t1 in ranges)
    # config 3: 128 chain blocks x 3 splits = 384 blocks of 396 places
    assert L.launch_splits(8192, 10000, 3, 132) == 3


def test_split_plan_prefers_more_splits_for_fewer_chains():
    """At config 3's data, fewer chains spread over more splits: 1 and 64
    chains take the most (two tiles each), 1,024 chains 24."""
    got = [L.launch_splits(c, 10000, 3, 132) for c in (1, 64, 1024, 8192)]
    assert got == [156, 156, 24, 3]


def _words(p, a, b):
    return p[..., a:b].contiguous().view(torch.int32)


@pytest.mark.parametrize("n,d,form", [
    (n, d, form) for n, d in ((1, 1), (63, 17), (65, 64), (100, 65),
                              (33, 300))
    for form in ("f32", "grad_bf16", "packed")
    if form != "packed" or d <= 64])
def test_planes_hold_the_data(n, d, form):
    """Each tile of a plane holds, at the words the kernel reads, X's tf32
    halves (``split_tf32``'s, bit for bit), y and w, and the form's own
    (grad_bf16: X in bfloat16, dimension-major in observation pairs;
    packed: the given bfloat16 halves), zero past N and D."""
    g = torch.Generator().manual_seed(n * 1000 + d)
    x = torch.randn((n, d), generator=g)
    y = (torch.rand(n, generator=g) < 0.5).float()
    w = torch.rand(n, generator=g)
    xh, xl = L.split_bf16(x)
    p = L.logistic_planes(x, y, w, form, xh, xl)
    assert tuple(p.shape) == L.plane_shape(n, d, form)
    assert p.dtype == torch.float32 and p.is_contiguous()
    t, nc, _ = p.shape
    bn, xs, dc = L.TILE_OBS, L.ROW_WORDS, L.CHUNK_DIMS
    xp = torch.zeros((t * bn, nc * dc))
    xp[:n, :d] = x
    want_hi, want_lo = L.split_tf32(xp)

    def unrows(a):    # [t, nc, bn * xs] -> [t bn, nc dc]
        return a.reshape(t, nc, bn, xs)[..., :dc].permute(0, 2, 1, 3) \
            .reshape(t * bn, nc * dc)

    for k, want in enumerate((want_hi, want_lo)):
        got = unrows(_words(p, k * bn * xs, (k + 1) * bn * xs))
        assert torch.equal(got, want.view(torch.int32))
        pad = p[..., k * bn * xs:(k + 1) * bn * xs].reshape(
            t, nc, bn, xs)[..., dc:]
        assert not pad.any()
    off = 2 * bn * xs
    for k, v in enumerate((y, w)):
        got = p[..., off + k * bn:off + (k + 1) * bn]
        for j in range(nc):
            assert torch.equal(got[:, j].reshape(-1)[:n], v)
            assert not got[:, j].reshape(-1)[n:].any()
    off += 2 * bn
    if form == "grad_bf16":
        pw = L.PAIR_WORDS
        got = _words(p, off, off + dc * pw).reshape(t, nc, dc, pw)
        assert not got[..., bn // 2:].any()
        xb = got[..., :bn // 2].contiguous().view(torch.bfloat16) \
            .reshape(t, nc, dc, bn).permute(0, 3, 1, 2).reshape(t * bn, -1)
        assert torch.equal(xb, xp.to(torch.bfloat16))
    elif form == "packed":
        hw = L.HALF_WORDS
        for k, half in enumerate((xh, xl)):
            got = _words(p, off + k * bn * hw, off + (k + 1) * bn * hw) \
                .reshape(t, bn, hw)
            assert not got[..., dc // 2:].any()
            hb = got[..., :dc // 2].contiguous().view(torch.bfloat16) \
                .reshape(t * bn, dc)
            want = torch.zeros((t * bn, dc), dtype=torch.bfloat16)
            want[:n, :d] = half
            assert torch.equal(hb, want)
    assert p.shape[-1] == off + {"f32": 0, "grad_bf16": dc * L.PAIR_WORDS,
                                 "packed": 2 * bn * L.HALF_WORDS}[form]


def test_tile_constants_match_the_kernel_source():
    """The layout the planes and the split plan mirror is the one
    ``csrc/logistic_mma.cuh`` (the tiles, shared with the whole-tree
    kernel) and ``csrc/logistic_vg.cu`` declare (their ``constexpr int``
    lines, evaluated in order), and a tile is a whole number of 16-byte
    units, as a bulk copy moves."""
    csrc = os.path.join(os.path.dirname(L.__file__), "..", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in ("logistic_mma.cuh", "logistic_vg.cu"))
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 text, re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    assert env["BC"] == L.BLOCK_CHAINS and env["BN"] == L.TILE_OBS
    assert env["DC"] == L.CHUNK_DIMS and env["XS"] == L.ROW_WORDS
    assert env["XBW"] == L.PAIR_WORDS and env["XPW"] == L.HALF_WORDS
    assert env["PACKED_DIM"] == L.PACKED_MAX_DIM
    extra = {"f32": 0, "grad_bf16": env["DC"] * env["XBW"],
             "packed": 2 * env["BN"] * env["XPW"]}
    for form, words in extra.items():
        tile = env["OFF_EXTRA"] + words
        assert L.plane_shape(1, 1, form)[2] == tile and tile % 4 == 0
