"""K5-logistic's tile form on the CPU: the plan's Python mirror
(``ops.tree.tile_plan``, ``tile_layout``) against the CUDA source
(``csrc/tree_logistic.cu``'s ``tile_layout``, ``csrc/tree_kernel.cuh``'s
``tile_plan_of``, evaluated here from their text); a model of the tile's
leaf physics (3xTF32 products on the plane's tiles of 32 observations and
chunks of 64 dimensions, summed as the kernel sums them) against JAX's
chunked ``tile_vg`` (as ``make_logistic_tree_transition`` hands it to
``make_tree_transition``) and float64, within the bound the card's checks
use; the kernel's plane of a bound physics; and the chains padded to the
tile, whose padded rows start inactive and return their inputs, while the
real chains' records do not depend on the padding.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.ops import tree_pallas as jtp


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (every xdist worker collects every test file, and the
    JAX suite's longest module sits a few memory mappings under the
    per-process limit, which torch's libraries would push it over); one
    torch thread."""
    global torch, tree, tp, L
    import torch
    import inplacedhmc_tpu_torch.ops.logistic as L
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    torch.set_num_threads(1)


INV_VAR = 0.01
U = 2.0 ** -24
CSRC = os.path.join(os.path.dirname(__file__), "..", "inplacedhmc_tpu_torch",
                    "csrc")


def _source(name):
    return open(os.path.join(CSRC, name)).read()


def _c_to_py(expr: str) -> str:
    """A C expression of the layout's code as Python: ``a ? b : c`` (right
    associative) as ``(b if a else c)``, integer division, no ``LL``
    suffixes or ``lvg::`` qualifiers, ``L.x`` as ``L_x``."""
    expr = " ".join(expr.replace("lvg::", "").replace("L.", "L_").split())
    expr = re.sub(r"(\d+)LL", r"\1", expr)
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr.replace("/", "//")
    depth, nested = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            nested += 1
        elif depth == 0 and ch == ":":
            if nested == 0:
                return (f"(({_c_to_py(expr[q + 1:i])}) if "
                        f"({_c_to_py(expr[:q])}) else "
                        f"({_c_to_py(expr[i + 1:])}))")
            nested -= 1
    raise ValueError(expr)


def _source_layout(d, tc, bt, sets, grad_bf16):
    """``tree_logistic.cu::tile_layout`` evaluated from its text, with
    ``conflict_free``, ``up16`` and ``tile_words`` as the source and the
    plane define them."""
    src = _source("tree_logistic.cu")
    body = src[src.index("TileLayout tile_layout("):]
    body = body[body.index("{") + 1:body.index("return L;")]
    cf = src[src.index("constexpr int conflict_free(int w)"):]
    cf = cf[:cf.index("\n}")]
    assert "r % 32 != 8 && r % 32 != 24" in cf and "(w + 7) / 8 * 8" in cf
    env = {"D": d, "tc": tc, "bt": bt, "sets": sets, "opt": int(grad_bf16),
           "DC": L.CHUNK_DIMS, "conflict_free": tree._conflict_free,
           "up16": lambda b: -(-b // 16) * 16,
           "TW_BF16": L.plane_shape(1, 1, "grad_bf16")[2],
           "TW_F32": L.plane_shape(1, 1, "f32")[2]}
    for name, expr in re.findall(r"L\.(\w+) = ([^;]+);", body, re.S):
        expr = expr.replace("lvg::", "") \
            .replace("tile_words<kGradBf16>()", "TW_BF16") \
            .replace("tile_words<kF32>()", "TW_F32")
        env["L_" + name] = eval(_c_to_py(expr), {}, env)
    return {f: env["L_" + f] for f in tree.TileLayout._fields}


def test_tile_constants_match_the_kernel_source():
    """The plan's constants are the source's: ``MAX_BATCH_TILES``,
    ``SMEM_LIMIT``, the chains a tile by registers (``kTileChains``: 16, 8
    at NV = 8, D > 128), two sets of the ring before one, the tile's
    physics the register path only; the logistic physics takes the tile
    form and no other physics does."""
    k = _source("tree_kernel.cuh")
    lg = _source("tree_logistic.cu")
    assert f"constexpr int MAX_BATCH_TILES = {tree.MAX_BATCH_TILES};" in k
    assert f"constexpr int SMEM_LIMIT = {tree.SMEM_LIMIT};" in k
    assert (f"kTileChains = NV > 4 ? {tree.TILE_CHAINS // 2} : "
            f"{tree.TILE_CHAINS};") in lg
    assert "for (int sets = 2; sets >= 1; --sets)" in k
    assert "static constexpr bool kTile = true;" in lg
    for name in tp.PHYSICS:
        src = _source(f"tree_{name}.cu")
        assert ("kTile = true" in src) == (name in tree.TILED_PHYSICS)


@pytest.mark.parametrize("d", [1, 7, 8, 17, 50, 64, 65, 128, 129, 200, 256])
@pytest.mark.parametrize("grad_bf16", [False, True])
def test_tile_layout_mirrors_the_source(d, grad_bf16):
    """``ops.tree.tile_layout`` is the source's ``tile_layout`` (evaluated
    from its text) at every D's chunks and n-tiles, chains 1 to 16, one to
    four tiles a batch, one or two sets; every region 16-byte aligned (a
    bulk copy's destination), every row stride free of bank conflicts (8
    or 24 words mod 32), a stage a whole number of 16-byte units."""
    for tc in (1, 5, 8, 16):
        for bt in (1, 3, 4):
            for sets in (1, 2):
                got = tree.tile_layout(d, tc, bt, sets, grad_bf16)
                assert got._asdict() == _source_layout(d, tc, bt, sets,
                                                       grad_bf16)
                assert all(v % 16 == 0 for v in (got.ring, got.q, got.r,
                                                 got.gp, got.bytes))
                assert {got.qs % 32, got.rs % 32, got.gs % 32} <= {8, 24}
                assert (4 * got.tw) % 16 == 0 and got.qs >= 16 * got.ndn
                assert got.gs >= 8 * got.ndn and got.rs >= 32 * bt
                assert 1 <= got.groups <= max(tc // got.ndn, 1)
                # LP [tc][16] lives in R's words after a walk
                assert got.rs >= 16


@pytest.mark.parametrize("md", [1, 5, 10, 13, 20, 30])
@pytest.mark.parametrize("ckpt_bf16", [False, True])
def test_tile_plan_fits_every_shape_the_kernel_takes(md, ckpt_bf16):
    """At every D the kernel takes (1 to 256) and max_depth 1 to 30, both
    stack types and both forms, a plan fits one block's shared memory; it
    is the first that fits in the source's order (the most chains, two
    sets before one, the most tiles a batch), as ``stage_plan`` and the
    launcher report it, on the register path."""
    for d in (1, 2, 17, 50, 64, 65, 100, 128, 129, 200, 255, 256):
        for grad_bf16 in (False, True):
            assert tree.takes(d, md, "logistic", ckpt_bf16)
            plan = tree.tile_plan(d, md, ckpt_bf16, grad_bf16)
            assert plan == tree.stage_plan(d, md, "logistic", True, False,
                                           ckpt_bf16, grad_bf16=grad_bf16)
            stack = tree.stack_bytes(d, md, ckpt_bf16)
            most = tree.TILE_CHAINS if d <= 128 else tree.TILE_CHAINS // 2
            order = [(tc, sets, bt) for tc in range(most, 0, -1)
                     for sets in (2, 1)
                     for bt in range(tree.MAX_BATCH_TILES, 0, -1)]
            fits = [o for o in order if _tc_bytes(d, stack, *o, grad_bf16)
                    <= tree.SMEM_LIMIT]
            tc, sets, bt = fits[0]
            lay = tree.tile_layout(d, tc, bt, sets, grad_bf16)
            assert plan == tree.StagePlan("register", tc, lay.stages, bt,
                                          tc * stack + lay.bytes)
            assert plan.smem_bytes <= tree.SMEM_LIMIT
            assert plan.in_flight(d) == 0


def _tc_bytes(d, stack, tc, sets, bt, grad_bf16):
    return tc * stack + tree.tile_layout(d, tc, bt, sets, grad_bf16).bytes


@pytest.mark.parametrize("path", ["resident", "ring", "fast"])
def test_tile_plan_refuses_other_paths(path):
    """The tile form admits the register path alone: ``stage_plan``
    refuses the staged paths (and an unknown one) for logistic
    regression."""
    with pytest.raises(ValueError):
        tree.stage_plan(50, 10, "logistic", True, False, False, path)
    assert tree.stage_plan(50, 10, "logistic", True, path="register") \
        == tree.tile_plan(50, 10)


def test_tile_plan_at_config_3():
    """Config 3 (D = 50, max_depth 10, float32 stacks): a tile of 16
    chains, two sets of four observation tiles (8 stages, 17,664 bytes
    each), two groups of warps for the gradient's 7 n-tiles; under
    grad_bf16 (22,784-byte tiles) three tiles a batch."""
    plan = tree.tile_plan(50, 10)
    assert (plan.warps, plan.stages, plan.rows) == (16, 8, 4)
    lay = tree.tile_layout(50, 16, 4, 2)
    assert (lay.tw * 4, lay.ndn, lay.groups, lay.nc) == (17664, 7, 2, 1)
    assert plan.smem_bytes == 16 * 4000 + lay.bytes <= tree.SMEM_LIMIT
    bf = tree.tile_plan(50, 10, grad_bf16=True)
    assert (bf.warps, bf.stages, bf.rows) == (16, 6, 3)


# the tile's leaf physics, modelled in float32 torch


def _split(a):
    return L.split_tf32(a)


def _x3(a, b):
    """``a @ b`` as the kernel's three passes form it from the tf32
    halves, each pass summed apart: (lo.hi + hi.lo) + hi.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _tile_model(q, x, y, w, inv_var, grad_bf16):
    """The tile's value and gradient as the kernel forms them, float32:
    eta a chunk of 64 dimensions at a time as three TF32 passes (the
    chunks added in float32); K1's obs_term per observation; the backward
    a tile of 32 observations at a time (3xTF32, or under ``grad_bf16``
    one pass of the residual and x rounded to bfloat16), the tiles' sums
    added in float32 in order; the prior last."""
    n, d = x.shape
    eta = torch.zeros((q.shape[0], n), dtype=torch.float32)
    for c0 in range(0, d, 64):
        eta = eta + _x3(q[:, c0:c0 + 64], x[:, c0:c0 + 64].T)
    t = torch.exp(-eta.abs())
    ll = y * eta - (torch.clamp(eta, min=0.0) + torch.log1p(t))
    inv1pt = 1.0 / (1.0 + t)
    r = (y - torch.where(eta >= 0, inv1pt, t * inv1pt)) * w
    g = torch.zeros_like(q)
    for n0 in range(0, n, 32):
        rs, xs = r[:, n0:n0 + 32], x[n0:n0 + 32]
        if grad_bf16:
            g = g + L._bf16(rs) @ L._bf16(xs)
        else:
            g = g + _x3(rs, xs)
    logp = (ll * w).sum(1) - 0.5 * inv_var * (q * q).sum(1)
    return logp, g - inv_var * q


def _gam(m):
    return m * U / (1 - m * U)


def _bounds(q, x, y, inv_var, side="tile", grad_bf16=False):
    """Per chain (the log density) and per gradient component, the distance
    from the float64 value allowed (``chip_smoke.py::grad_bound``'s terms):
    eta within ``e_f`` of its terms' magnitudes, carried into the log
    density (slope at most 1) and the gradient (through the sigmoid, slope
    at most 1/4); the backward sum within ``e_b`` of its terms (each
    residual at most 1); the log density's float32 sum of N terms and a
    few roundings of each term.  ``side`` ``"tile"``: the kernel's
    products, ``e_f = t_f = 3 2^-22 + (k + 2) 2^-23 + n_c u`` (k = min(D,
    64)), ``e_b = t_b = 3 2^-22 + 34 2^-23 + gamma_(ceil(N / 32) + 18)``
    (the 3 2^-22 dropped under ``grad_bf16``); ``"plain"``: float32 sums,
    ``e_f = gamma_D``, ``e_b = gamma_N``."""
    q64, x64 = q.double(), x.double()
    n, d = x.shape
    if side == "tile":
        e_f = 3 * 2.0 ** -22 + (min(d, 64) + 2) * 2.0 ** -23 \
            + math.ceil(d / 64) * U
        e_b = (0.0 if grad_bf16 else 3 * 2.0 ** -22) + 34 * 2.0 ** -23 \
            + _gam(math.ceil(n / 32) + 18)
    else:
        e_f, e_b = _gam(d), _gam(n)
    qx = q64.abs() @ x64.abs().T                       # [C, N]
    eta = q64 @ x64.T
    ll = y.double() * eta - torch.as_tensor(np.logaddexp(0.0, eta.numpy()))
    lp_terms = ll.abs().sum(1) + 0.5 * inv_var * (q64 * q64).sum(1)
    logp_b = e_f * qx.sum(1) + (_gam(n + d) + 16 * U) * (lp_terms
                                                         + qx.sum(1))
    a = 0.25 * (x64.abs().T @ x64.abs())
    grad_b = e_f * (q64.abs() @ a) + (e_b + 6 * U) * x64.abs().sum(0) \
        + 4 * U * inv_var * q64.abs()
    return logp_b, grad_b, e_f


def _problem(seed, n, d, c=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) * 2.0 / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ beta))).astype(
        np.float32)
    q = (beta + 0.3 * rng.normal(size=(c, d))).astype(np.float32)
    return q, x, y


def _jax_tile_vg(x, y, q, grad_bf16, block_n, monkeypatch):
    """JAX's chunked ``tile_vg`` on ``q`` and the data as
    ``make_logistic_tree_transition`` hands them to ``make_tree_transition``
    (captured), padded as the kernel's refs are (128 lanes, 8 rows)."""
    seen = {}

    def spy(tile_logp, data, dim, metric_inv, **kw):
        seen.update(data=data, tile_vg=kw["tile_value_grad"])
        return None

    monkeypatch.setattr(jtp, "make_tree_transition", spy)
    d = x.shape[1]
    jtp.make_logistic_tree_transition(
        jnp.asarray(x), jnp.asarray(y), INV_VAR, jnp.ones(d), interpret=True,
        grad_bf16=grad_bf16, block_n=block_n)
    dp = -(-d // 128) * 128
    refs = {}
    for name, arr in seen["data"].items():
        arr = jnp.asarray(arr, jnp.float32)
        arr = arr[None, :] if arr.ndim == 1 else arr
        r, cols = -(-arr.shape[0] // 8) * 8, -(-arr.shape[1] // 128) * 128
        refs[name] = jnp.zeros((r, cols), jnp.float32).at[
            :arr.shape[0], :arr.shape[1]].set(arr)
    qp = jnp.zeros((q.shape[0], dp), jnp.float32).at[:, :d].set(q)
    lp, g = seen["tile_vg"](qp, refs)
    return (torch.as_tensor(np.array(lp)[:, 0]).double(),
            torch.as_tensor(np.array(g)[:, :d]).double())


SHAPES = [(65, 1), (100, 17), (333, 64), (250, 65), (97, 200), (40, 256),
          (2049, 50)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_tile_physics_model_within_its_bound(n, d, monkeypatch):
    """The tile's leaf physics (``_tile_model``: the kernel's products on
    the plane's tiles, summed as the kernel sums them) against float64
    within ``_bounds``, and against JAX's chunked ``tile_vg`` (float32 on
    the CPU) within that and JAX's own float32 sums' bound; at observation
    counts off the tiles of 32 and D across the chunks of 64."""
    q, x, y = _problem(n + d, n, d)
    tq, tx, ty = (torch.as_tensor(a) for a in (q, x, y))
    lp, g = _tile_model(tq, tx, ty, torch.ones(n), INV_VAR, False)
    lp_b, g_b, _ = _bounds(tq, tx, ty, INV_VAR)
    lp_p, g_p, _ = _bounds(tq, tx, ty, INV_VAR, "plain")
    lp64, g64 = L.logistic_value_and_grad_plain(
        tq.double(), tx.double(), ty.double(), torch.ones(n).double(),
        INV_VAR)
    assert ((lp.double() - lp64).abs() <= lp_b).all()
    assert ((g.double() - g64).abs() <= g_b).all()
    jlp, jg = _jax_tile_vg(x, y, q, False, 128, monkeypatch)
    assert ((lp.double() - jlp).abs() <= lp_b + lp_p).all()
    assert ((g.double() - jg).abs() <= g_b + g_p).all()


@pytest.mark.parametrize("n,d", SHAPES)
def test_tile_physics_model_grad_bf16(n, d, monkeypatch):
    """Under ``grad_bf16``: the log density as without it; the backward of
    the model's own residual, rounded to bfloat16 with x, against its
    exact float64 sum within the tensor cores' sums (34 2^-23 and the
    float32 adds of the tiles); against JAX's ``tile_vg`` with
    ``grad_bf16``, within the bounds of both sides and one bfloat16 step
    (2^-7 |r|) of each residual that lies within the two sides' residual
    difference of a rounding tie (and so may round either way); and not
    the float32 gradient."""
    q, x, y = _problem(n + d + 1, n, d)
    tq, tx, ty = (torch.as_tensor(a) for a in (q, x, y))
    w = torch.ones(n)
    lp, g = _tile_model(tq, tx, ty, w, INV_VAR, True)
    lp32, g32 = _tile_model(tq, tx, ty, w, INV_VAR, False)
    assert torch.equal(lp, lp32) and not torch.equal(g, g32)
    # the model's residual (as _tile_model forms it) and its backward
    eta = torch.zeros((q.shape[0], n))
    for c0 in range(0, d, 64):
        eta = eta + _x3(tq[:, c0:c0 + 64], tx[:, c0:c0 + 64].T)
    t = torch.exp(-eta.abs())
    inv1pt = 1.0 / (1.0 + t)
    r = ty - torch.where(eta >= 0, inv1pt, t * inv1pt)
    rb, xb = L._bf16(r).double(), L._bf16(tx).double()
    exact = rb @ xb - INV_VAR * tq.double()
    room = (34 * 2.0 ** -23 + _gam(math.ceil(n / 32) + 18)) \
        * (rb.abs() @ xb.abs()) + 4 * U * INV_VAR * tq.double().abs()
    assert ((g.double() - exact).abs() <= room).all()
    lp_b, g_b, e_f = _bounds(tq, tx, ty, INV_VAR, grad_bf16=True)
    lp_p, g_p, e_p = _bounds(tq, tx, ty, INV_VAR, "plain")
    jlp, jg = _jax_tile_vg(x, y, q, True, 128, monkeypatch)
    assert ((lp.double() - jlp).abs() <= lp_b + lp_p).all()
    # residuals within the two sides' difference of a bfloat16 tie
    dr = 0.25 * (e_f + e_p) * (tq.double().abs() @ tx.double().abs().T) \
        + 8 * U * (r.double().abs() + 1)
    r64 = r.double()
    tie = (L._bf16(r64 + dr) != L._bf16(r64)) \
        | (L._bf16(r64 - dr) != L._bf16(r64))
    flips = 2.0 ** -7 * (tie.double() @ xb.abs())
    assert ((g.double() - jg).abs() <= g_b + g_p + flips).all()


def test_tile_model_needs_three_passes():
    """One TF32 pass of eta (the hi halves alone) is outside the forward's
    bound where 3xTF32 is inside it: the bound tells the grades apart."""
    q, x, y = _problem(7, 500, 50)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    exact = tq.double() @ tx.double().T
    scale = tq.double().abs() @ tx.double().abs().T
    t_f = 3 * 2.0 ** -22 + 52 * 2.0 ** -23 + U
    three = _x3(tq, tx.T).double()
    one = (_split(tq)[0] @ _split(tx.T)[0]).double()
    assert ((three - exact).abs() <= t_f * scale).all()
    assert not ((one - exact).abs() <= t_f * scale).all()


# the plane a bound physics carries, and the chains padded to the tile


@pytest.mark.parametrize("grad_bf16", [False, True])
def test_tile_plane_trims_the_padding(grad_bf16):
    """``ops.tree.tile_plane``: the plane of the physics' data up to its
    last observation of nonzero weight (``logistic_data`` pads to
    ``block_n``), in the form of its ``grad_bf16``."""
    q, x, y = _problem(3, 70, 5)
    data = tp.logistic_data(torch.as_tensor(x), torch.as_tensor(y), INV_VAR,
                            grad_bf16=grad_bf16, block_n=64)
    phys = tp.bind("logistic", data)
    plane, n = tree.tile_plane(phys)
    assert n == 70 and data["x"].shape[0] == 128
    form = "grad_bf16" if grad_bf16 else "f32"
    want = L.logistic_planes(torch.as_tensor(x), torch.as_tensor(y),
                             torch.ones(70), form)
    assert torch.equal(plane.view(torch.int32), want.view(torch.int32))
    assert plane.shape == L.plane_shape(70, 5, form)
    # on the CPU the bound physics carries none; ops.tree.bind adds it on
    # a CUDA device only
    assert "plane" not in tree.bind("logistic", data).data


def _sample_state(c, d, seed=0):
    q, x, y = _problem(seed, 120, d, c)
    data = tp.logistic_data(torch.as_tensor(x).double(),
                            torch.as_tensor(y).double(), INV_VAR,
                            block_n=64)
    return torch.as_tensor(q).double(), data


def test_padded_rows_start_inactive_and_return_their_inputs():
    """Rows with ``valid = 0`` (the padding of the tile) take no leaf: the
    records of an empty tree (term 0, term_left 1, term_right 0, depth 0,
    steps 0), their start as the proposal, its log density and gradient;
    the valid rows' records are those of a launch without the padded
    rows."""
    q, data = _sample_state(5, 4)
    phys = tp.bind("logistic", data)
    c = 5
    pad = torch.zeros((3, 4), dtype=torch.float64)
    qp = torch.cat([q, pad + 0.25])
    valid = torch.tensor([1] * c + [0] * 3, dtype=torch.int32)
    key = torch.tensor([11, 12], dtype=torch.int64)
    minv = torch.full((4,), 0.3, dtype=torch.float64)
    eps = torch.full((8,), 0.2, dtype=torch.float64)
    out = tree.tree_sweep(qp, eps, phys, minv, 6, -1000.0, 2, key=key,
                          sqrt_mass=1 / minv.sqrt(), valid=valid)
    lp0, g0 = phys(qp[c:])
    for s in range(2):
        assert torch.equal(out.q[s, c:], qp[c:])
        assert torch.equal(out.logp[s, c:], lp0)
        assert out.steps[s, c:].eq(0).all() and out.depth[s, c:].eq(0).all()
        assert out.term[s, c:].eq(0).all()
        assert out.term_left[s, c:].eq(1).all()
        assert out.term_right[s, c:].eq(0).all()
    assert torch.equal(out.grad[c:], g0)
    real = tree.tree_sweep(q, eps[:c], phys, minv, 6, -1000.0, 2, key=key,
                           sqrt_mass=1 / minv.sqrt())
    for f in tree.TreeOut._fields:
        a, b = getattr(out, f), getattr(real, f)
        a = a[:c] if f == "grad" else a[:, :c]
        if f in ("term", "term_left", "term_right", "depth", "steps"):
            assert torch.equal(a, b), f
        else:
            assert torch.allclose(a, b, rtol=1e-12, atol=1e-12), f


@pytest.mark.parametrize("c,block_c,cpad", [(5, 8, 8), (9, 8, 16),
                                            (16, 8, 16), (20, 128, 24)])
@pytest.mark.parametrize("n_sweep", [1, 3])
def test_transition_pads_chains_to_the_tile(monkeypatch, c, block_c, cpad,
                                            n_sweep):
    """``make_logistic_tree_transition``'s transition pads the chains to
    ``chain_tiles(c, block_c)`` rows as JAX pads them to its ``block_c``
    tiles, the padded rows not valid, and returns the real chains' rows:
    the same records as a launch on the real chains alone, at any
    padding."""
    q, data = _sample_state(c, 3, seed=c)
    x, y = data["x"][:120], data["y"][:120]
    seen = []
    real_sweep = tree.tree_sweep_plain

    def spy(q0, *a, **kw):
        seen.append((q0.shape[0], kw.get("valid")))
        return real_sweep(q0, *a, **kw)

    monkeypatch.setattr(tree, "tree_sweep_plain", spy)
    minv = torch.full((3,), 0.4, dtype=torch.float64)
    outs = []
    for bc in (block_c, 8 * block_c):
        trans = tree.make_logistic_tree_transition(
            x, y, INV_VAR, minv, block_c=bc, block_n=64, max_depth=5,
            refresh_inside=True, n_sweep=n_sweep)
        z = tree.EvalPoint(q=q, logp=torch.zeros(c), grad=torch.zeros_like(q))
        gen = torch.Generator().manual_seed(4)
        outs.append(trans(gen, z, 0.3))
    rows, valid = seen[0]
    assert rows == cpad
    if cpad == c:
        assert valid is None
    else:
        assert valid.tolist() == [1] * c + [0] * (cpad - c)
    stats = [o[-1] for o in outs]
    for f in ("termination", "term_left", "term_right", "depth", "steps"):
        assert torch.equal(getattr(stats[0], f), getattr(stats[1], f))
        assert getattr(stats[0], f).shape[-1] == c
    z0, z1 = outs[0][0], outs[1][0]
    assert torch.allclose(z0.q, z1.q, rtol=1e-12, atol=1e-12)
    assert torch.allclose(z0.grad, z1.grad, rtol=1e-12, atol=1e-12)
