"""K5's wide form with its ``[D, D]`` products on a thread-block cluster,
on the CPU.

Above D = 256 (``csrc/tree_kernel.cuh``'s ``Cluster``) a chain's product
``v M`` is split by output columns across a cluster of K = 4 or 8 blocks:
block ``r`` sums the columns of its panel, each over ``i = 0 .. D-1`` in
order with one rounding per product and per sum, from the matrix's column
panels ``[K, D, wk]`` that the wrapper packs once per matrix
(``ops.tree.cluster_panels``).  The launcher plans each cluster's ring
(``cluster_fit``); the wrapper asks for a cluster where the last launch of
the shape waited on its deepest chain (``ops.tree.cluster_of``,
``chains_in_flight``).  Here: a float32 model of the column split is
bit-equal to the register path's in-order product (K = 1) at every D and
K, and both are within the float32 bound of the plain version's product;
the packing round-trips and its panels and stages are 16-byte units for
the bulk copies; the source's constants and ``cluster_fit``, evaluated
from its text, fit one block's shared memory at every shape the wide form
takes; the choice of K follows the chains in flight as the card measured
it; the CPU launch checks a forced cluster path.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py -k cluster``,
``chip_smoke.py``)."""

import os
import re

import numpy as np
import pytest

DIMS = [257, 300, 512, 1002, 2048]
KS = [1, 2, 4, 8]
U = 2.0 ** -24
CSRC = os.path.join(os.path.dirname(__file__), "..", "inplacedhmc_tpu_torch",
                    "csrc")


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (``tests/test_torch_cuda.py`` says why); one torch
    thread."""
    global torch, tree, dense_metric
    import torch
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    torch.set_num_threads(1)


def _source():
    return open(os.path.join(CSRC, "tree_kernel.cuh")).read()


def _in_order(m, v):
    """``v m`` in float32, each column summed over the rows in order, each
    product and each sum rounded on its own (no fused multiply-add): the
    register path's arithmetic (``Block::matvec``)."""
    acc = np.zeros(m.shape[1], np.float32)
    for i in range(m.shape[0]):
        acc = acc + m[i] * v[i]
    return acc


def _column_split(panels, v, d):
    """The cluster's product: block ``r`` sums its panel's columns in
    order (``Cluster::columns``), the blocks' columns side by side, the
    padding past D dropped."""
    k, _, wk = panels.shape
    out = np.zeros(k * wk, np.float32)
    for r in range(k):
        out[r * wk:(r + 1) * wk] = _in_order(panels[r], v)
    return out[:d]


def _symmetric(rng, d):
    a = rng.standard_normal((d, d)).astype(np.float32)
    return (0.5 * (a + a.T)).astype(np.float32)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("k", KS)
def test_column_split_is_the_register_paths_product(d, k):
    """A float32 model of the column-split product over the wrapper's
    panels equals the register path's in-order product bit for bit (each
    column's sum is the same sum, whichever block takes it), and both are
    within gamma_D sum_i |M_ij v_i| of the float64 product, as the plain
    version's product (``ops.tree.psharp``, torch's matmul, which sums in
    another order) is."""
    rng = np.random.default_rng(10 * d + k)
    m = _symmetric(rng, d)
    v = rng.standard_normal(d).astype(np.float32)
    panels = tree.cluster_panels(torch.from_numpy(m), k).numpy()
    got = _column_split(panels, v, d)
    want = _in_order(m, v)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    ref = v.astype(np.float64) @ m.astype(np.float64)
    gamma = d * U / (1 - d * U)
    bound = gamma * (np.abs(v).astype(np.float64) @ np.abs(m))
    plain = tree.psharp(torch.from_numpy(m),
                        torch.from_numpy(v)[None])[0].numpy()
    for out in (got, plain):
        assert bool((np.abs(out - ref) <= bound).all())


def _matrices(d, seed):
    """The three matrices a wide launch may stream: an SPD ``M^-1``, its
    momentum scale ``mass_chol^T`` (the refresh's) and a dense Gaussian's
    Wishart precision ``P``."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((d, d)) / np.sqrt(d)
    minv = torch.as_tensor(0.5 * np.eye(d) + 0.5 * (b @ b.T),
                           dtype=torch.float32)
    minv = (0.5 * (minv + minv.T)).contiguous()
    scale = dense_metric(minv).mass_chol.T.contiguous()
    x = rng.standard_normal((d, 2 * d))
    prec = torch.as_tensor(x @ x.T / (2 * d), dtype=torch.float32)
    return {"minv": minv, "sqrt_mass": scale,
            "matrix": (0.5 * (prec + prec.T)).contiguous()}


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", ["minv", "sqrt_mass", "matrix"])
def test_panels_round_trip_in_16_byte_units(d, k, name):
    """``cluster_panels`` of M^-1, the refresh's scale and the dense
    Gaussian's P: ``[K, D, wk]`` with ``wk = panel_cols(D, K)`` a multiple
    of 4 floats, covering D with no empty block; unpacked back bit for
    bit, zero past column D; each panel starts 16-byte aligned and is a
    multiple of 16 bytes, as is each stage of the launcher's ring
    (``rows`` rows of the panel, ``cluster_fit`` from the source) and each
    row; packed once while the matrix is unchanged, anew after an in-place
    change."""
    wk = tree.panel_cols(d, k)
    assert wk % 4 == 0 and k * wk >= d > (k - 1) * wk
    m = _matrices(d, d + k)[name]
    p = tree.cluster_panels(m, k)
    assert p.shape == (k, d, wk) and p.is_contiguous()
    flat = p.transpose(0, 1).reshape(d, k * wk)
    assert torch.equal(flat[:, :d], m)
    assert not bool(flat[:, d:].any())
    assert p.data_ptr() % 16 == 0
    assert (4 * d * wk) % 16 == 0 and (4 * wk) % 16 == 0
    for md, bf16 in ((6, False), (10, False), (10, True), (13, False)):
        fit = _source_cluster_fit(d, md, bf16, k)
        if fit is None:
            continue
        plan = tree.StagePlan(tree.PATHS[fit[0]], *fit[1:])
        assert plan.cluster == k
        assert (4 * plan.rows * wk) % 16 == 0
        assert plan.in_flight(d) == 4 * (plan.stages - 1) * plan.rows * wk
    assert tree.cluster_panels(m, k) is p
    m.add_(0.0)
    q = tree.cluster_panels(m, k)
    assert q is not p and torch.equal(q, p)


def _const(src, name):
    """The value of ``constexpr int name = <int>;`` in the source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _body(src, head):
    """The body of the function whose text starts with ``head``."""
    at = src.index(head)
    body = src[src.index("{", at) + 1:]
    depth, end = 1, 0
    for i, ch in enumerate(body):
        depth += (ch == "{") - (ch == "}")
        if depth == 0:
            end = i
            break
    return body[:end]


def _py(expr):
    """A C integer expression of the plan's code as Python: casts and
    ``LL`` suffixes dropped, ``/`` as floor division (every operand is
    non-negative), ``a ? b : c`` as ``(b if a else c)`` (one level)."""
    expr = re.sub(r"\(int64_t\)|\(int\)", "", " ".join(expr.split()))
    expr = re.sub(r"(\d+)LL", r"\1", expr).replace("/", "//")
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if m:
        cond, yes, no = m.groups()
        expr = f"(({_py(yes)}) if ({cond}) else ({_py(no)}))"
    return expr


def _returns(src, head):
    """The expression that the one-line function starting with ``head``
    returns, as Python."""
    return _py(_body(src, head).split("return")[1].split(";")[0])


def _source_cluster_fit(d, md, bf16, k):
    """``tree_kernel.cuh::cluster_fit`` evaluated from its text, statement
    by statement: its plan ``(path, warps, stages, rows, bytes)`` or None
    where it returns false."""
    src = _source()
    env = {"D": d, "md": md, "bf16": bf16, "K": k,
           **{n: _const(src, n) for n in (
               "WARP_DIM", "SMEM_LIMIT", "MAX_PANEL_COLS", "CLUSTER_STAGES",
               "ROW_BATCH", "PATH_CLUSTER")},
           "panel_cols": tree.panel_cols,
           "round16": lambda b: -(-b // 16) * 16,
           "cluster_base": lambda dd, mm, bb: -(-tree.wide_smem_bytes(
               dd, mm, bb) // 16) * 16}
    body = _body(src, "inline bool cluster_fit(")
    for stmt in body.split(";"):
        stmt = " ".join(stmt.split())
        if not stmt or stmt == "return true":
            continue
        m = re.fullmatch(r"if \((.+)\) return false", stmt)
        if m:
            if eval(_py(m.group(1)), {}, env):
                return None
            continue
        m = re.fullmatch(r"if \(([^()]+)\) (\w+) = (.+)", stmt)
        if m:
            if eval(_py(m.group(1)), {}, env):
                env[m.group(2)] = eval(_py(m.group(3)), {}, env)
            continue
        m = re.fullmatch(r"\*out = \{(.+)\}", stmt)
        if m:
            return tuple(eval(_py(x), {}, env) for x in m.group(1).split(","))
        m = re.fullmatch(r"(?:const )?(?:int64_t|int) (\w+) = (.+)", stmt)
        assert m, stmt
        env[m.group(1)] = eval(_py(m.group(2)), {}, env)
    raise AssertionError("cluster_fit has no *out = {...}")


def test_cluster_constants_match_the_kernel_source():
    """The cluster paths' constants and small functions are the source's:
    the paths' numbers (``PATH_CLUSTER``, ``CLUSTER_PATHS`` and the blocks
    of each: ``cluster_size``, 4 and 8), the panel's columns
    (``panel_cols``) at every D of the wide form and K, and the limits the
    wrapper's packing and plan read (``WARP_DIM``, ``SMEM_LIMIT``)."""
    src = _source()
    first = tree.PATHS.index(tree.CLUSTER_PATHS[0])
    assert _const(src, "PATH_CLUSTER") == first
    assert _const(src, "CLUSTER_PATHS") == len(tree.CLUSTER_PATHS)
    assert tree.CLUSTER_PATHS == tree.PATHS[first:] == ("cluster4",
                                                          "cluster8")
    assert _const(src, "WARP_DIM") == tree.WARP_DIM
    assert _const(src, "SMEM_LIMIT") == tree.SMEM_LIMIT == 232448
    size = _returns(src, "constexpr int cluster_size(int path)")
    cols = _returns(src, "constexpr int panel_cols(int D, int K)")
    for i, path in enumerate(tree.PATHS):
        assert eval(size, {}, {"path": i, "PATH_CLUSTER": first}) \
            == tree.cluster_size(path)
    assert [tree.cluster_size(p) for p in tree.CLUSTER_PATHS] == [4, 8]
    for d in range(1, tree.MAX_DIM + 1):
        for k in (4, 8):
            assert eval(cols, {}, {"D": d, "K": k}) == tree.panel_cols(d, k)


@pytest.mark.parametrize("d", DIMS + [513, 1000, 1536])
@pytest.mark.parametrize("md", [6, 10, 13, 20, 26])
@pytest.mark.parametrize("bf16", [False, True])
def test_cluster_ring_fits_a_block(d, md, bf16):
    """At each shape the wide form takes, each cluster's plan as the
    launcher makes it (``cluster_fit`` evaluated from the source's text,
    with the source's constants): the block (the wide form's shared
    memory, the ring's barriers and its ``CLUSTER_STAGES`` stages of
    ``rows`` panel rows) fits one block's 227 KB, the ring holds at most
    what a product needs, its stages are whole batches of ``ROW_BATCH``
    rows where there are that many, and a thread sums at most
    ``MAX_PANEL_COLS`` columns.  A stage of one row fits everywhere but at
    D = 2,048 with stacks too deep for it.  The Python mirror
    (``stage_plan``) plans the wide form's register path and leaves the
    clusters to the launcher; under a diagonal metric no cluster is
    admitted."""
    src = _source()
    stages, batch = _const(src, "CLUSTER_STAGES"), _const(src, "ROW_BATCH")
    most_cols = _const(src, "MAX_PANEL_COLS")
    for physics, dense, refresh in (("gaussian", True, False),
                                    ("gaussian", True, True),
                                    ("dense_gaussian", True, True),
                                    ("stoch_vol", True, True)):
        if not tree.takes(d, md, physics, bf16):
            continue
        for path in tree.CLUSTER_PATHS:
            k = tree.cluster_size(path)
            got = _source_cluster_fit(d, md, bf16, k)
            head = tree._round16(tree.wide_smem_bytes(d, md, bf16)) \
                + tree._round16(8 * stages)
            wk = tree.panel_cols(d, k)
            if got is None:
                assert head + 4 * stages * wk > tree.SMEM_LIMIT, (d, md, k)
                assert d == tree.MAX_DIM, (d, md, k)
            else:
                index, warps, n_stages, rows, smem = got
                assert (tree.PATHS[index], warps, n_stages) \
                    == (path, 1, stages)
                assert smem == head + 4 * stages * rows * wk
                assert smem <= tree.SMEM_LIMIT == 232448
                assert 1 <= rows <= -(-d // stages)
                assert rows < batch or rows % batch == 0
                assert -(-wk // (32 * -(-d // tree.WARP_DIM))) <= most_cols
            with pytest.raises(ValueError, match="does not admit"):
                tree.stage_plan(d, md, physics, dense, refresh, bf16, path)
        assert tree.stage_plan(d, md, physics, dense, refresh,
                               bf16).path == "register"
        for diag in ("gaussian", "dense_gaussian"):
            for path in tree.CLUSTER_PATHS:
                with pytest.raises(ValueError, match="does not admit"):
                    tree._check_path(d, md, diag, False, refresh, bf16, path)


@pytest.mark.parametrize("d,spread,k", [
    (256, 1.0, 1), (257, 1.0, 4), (512, 1.0, 4), (767, 63.9, 4),
    (768, 1.0, 8), (1002, 1.0, 8), (2048, 1.0, 8),
    (1002, 38354 / 1023, 8), (1002, 16875 / 255, 1), (1002, 17865 / 182, 1),
    (512, 52112 / 435, 1), (512, 3840 / 15, 1), (2048, 1815 / 50, 1),
    (1024, 63.9, 8), (1024, 64.0, 1), (2048, 15.9, 8), (2048, 16.0, 1)])
def test_cluster_of_follows_the_chains_in_flight(d, spread, k):
    """The wrapper's K by D and the last launch's chains in flight: a
    cluster (4 below D = 768, 8 from it) below ``TAIL_CHAINS`` chains in
    flight (64, falling as 1 / D^2 above D = 1,024), else one block a
    chain; the one-warp form never.  The cases are the card's
    measurements (``PERF.md`` section 6): a lone chain, config 5's tuned
    state (38,354 leaves, the deepest 1,023) take a cluster; 1,024 chains
    at D = 512 (52,112 leaves, 435), stochastic volatility at eps 0.02
    (17,865, 182), the dense Gaussian's 256 x 512 (3,840, 15) and D =
    2,048 (1,815, 50), each measured slower on a cluster, keep one block a
    chain, as does D = 1,002 at 66 chains in flight (0.85 on a cluster of
    8), a little above the bound."""
    assert tree.cluster_of(d, spread) == k


def test_chains_in_flight():
    """All leaves over the deepest chain's, each chain's leaves summed over
    a sweep: ``[C]`` and ``[K, C]`` records; rows that took no step (not
    valid) count nothing; a launch with no step counts its C."""
    steps = torch.tensor([3, 1, 0, 4], dtype=torch.int32)
    assert tree.chains_in_flight(steps) == 8 / 4
    sweep = torch.tensor([[3, 1, 0, 4], [5, 1, 0, 0]], dtype=torch.int32)
    assert tree.chains_in_flight(sweep) == 14 / 8
    assert tree.chains_in_flight(torch.zeros((2, 5),
                                             dtype=torch.int32)) == 5.0


def test_cpu_launch_checks_a_forced_cluster_path():
    """On the CPU a forced cluster path is checked and the plain version
    runs: at D = 300 under a dense metric the outputs equal the unforced
    call's; a cluster under a diagonal metric, a cluster in the one-warp
    form and a cluster of 2 (not a path) raise before anything runs."""
    from inplacedhmc_tpu_torch.ops import tile_physics as tp
    d, c, md = 300, 3, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn((c, d), generator=g)
    minv = _matrices(d, 1)["minv"]
    phys = tp.bind("gaussian", {"lam": torch.ones(d)})
    e = torch.full((c,), 0.2)
    key = torch.tensor([3, 4], dtype=torch.int64)
    scale = dense_metric(minv).mass_chol.T.contiguous()
    a = tree.tree_sweep(q, e, phys, minv, md, -1000.0, key=key,
                        sqrt_mass=scale, path="cluster8")
    b = tree.tree_sweep(q, e, phys, minv, md, -1000.0, key=key,
                        sqrt_mass=scale)
    for f in tree.TreeOut._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="does not admit"):
        tree.tree_sweep(q, e, phys, torch.diagonal(minv).contiguous(), md,
                        -1000.0, key=key, sqrt_mass=torch.ones(d),
                        path="cluster4")
    small = tp.bind("gaussian", {"lam": torch.ones(100)})
    with pytest.raises(ValueError, match="does not admit"):
        tree.tree_sweep(q[:, :100].contiguous(), e, small, torch.eye(100),
                        md, -1000.0, key=key, sqrt_mass=torch.eye(100),
                        path="cluster8")
    with pytest.raises(ValueError, match="path must be one of"):
        tree.tree_sweep(q, e, phys, minv, md, -1000.0, key=key,
                        sqrt_mass=scale, path="cluster2")
