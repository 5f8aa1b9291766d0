"""Tests of the port that need an NVIDIA card: the CUDA kernels K1
(``csrc/logistic_vg.cu``, with and without ``grad_bf16``), K2
(the same body's packed split-bf16 forward, and
``sample(fused_opts={"fwd_precision": "packed"})`` through it), K3 and K4
(``csrc/leapfrog_gaussian.cu``: one fused step, and k steps per launch
against k launches of K3) and K5
(``csrc/tree_gaussian.cu``: its three drawing forms, its sweeps and its
generator; ``csrc/tree_eight_schools.cu`` and ``csrc/tree_funnel.cu``, its
tile physics; K5-dense, each source's dense-metric launcher, and
``csrc/tree_dense_gaussian.cu``; K5-logistic, ``csrc/tree_logistic.cu``,
with and without ``grad_bf16``, which ``physics_mode="vjp"`` does not read;
K5-stoch_vol, ``csrc/tree_stoch_vol.cu``) against their plain torch
versions, the flagship ``sample(tree_opts=...)`` path through K5, and
``sample()`` on eight schools, the funnel, an ``mvn``, a logistic
regression (``use_pallas="tree"``) and stochastic volatility through their
kernels.

They carry the ``cuda`` marker and skip, inside the test, where there is no
card.  This file imports neither JAX nor the JAX package, so on a machine
with a card and no JAX it runs on its own::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

INV_VAR = 0.01


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file: every xdist worker of the CPU suite collects every
    test file, and the JAX suite's longest module (tests/test_sampling.py)
    peaks within a few memory mappings of the per-process limit
    (vm.max_map_count), which torch's libraries would push it over."""
    global torch, LOGISTIC_VG, L, logistic_value_and_grad
    global logistic_value_and_grad_plain, lf, tree, philox, tp, models
    import torch
    import inplacedhmc_tpu_torch.models as models
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.leapfrog as lf
    import inplacedhmc_tpu_torch.ops.tree as tree
    import inplacedhmc_tpu_torch.utils.philox as philox
    import inplacedhmc_tpu_torch.ops.logistic as L
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, logistic_value_and_grad, logistic_value_and_grad_plain)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _data(seed, c, n, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) * 0.5 / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ beta))).astype(np.float32)
    q = (beta + 0.3 * rng.normal(size=(c, d)) / np.sqrt(d)).astype(np.float32)
    q[5, 2] = np.nan
    return (torch.as_tensor(a, device="cuda") for a in (x, y, q))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", [(33, 300, 7), (70, 1000, 100),
                                   (40, 129, 256)])
def test_cuda_kernel_matches_plain_version(c, n, d):
    """K1 against its plain version in float64 on ragged shapes (C not a
    multiple of the 32-chain block, N not of the 64-observation tile), one
    shape for each of the kernel's dimension bounds (64, 128, 256), with a
    NaN chain: logp to 1e-5 of sum|terms|, grad to 1e-4 of max|grad|, the
    tolerances of ``chip_smoke.py`` for f32 sums of up to 1e4 terms."""
    _needs_card()
    x, y, q = _data(4, c, n, d)
    w = torch.ones(n, device="cuda")
    before = LOGISTIC_VG.launches
    lp, g = logistic_value_and_grad(q, x, y, w, INV_VAR)
    torch.cuda.synchronize()
    assert LOGISTIC_VG.launches == before + 1
    lp_ref, g_ref = logistic_value_and_grad_plain(
        q.double(), x.double(), y.double(), w.double(), INV_VAR)
    assert lp[5] == -torch.inf and bool((g[5] == 0).all())
    ok = torch.isfinite(lp_ref)
    assert torch.equal(torch.isfinite(lp), ok)
    eta = q.double() @ x.double().T
    scale = (y.double() * eta - torch.logaddexp(torch.zeros_like(eta), eta)
             ).abs().sum(1)
    assert ((lp.double() - lp_ref).abs()[ok] / scale[ok]).max() < 1e-5
    assert ((g.double() - g_ref).abs().max() / g_ref.abs().max()) < 1e-4


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _needs_card()
    x, y, q = _data(5, 8, 64, 7)
    w = torch.ones(64, device="cuda")
    before = LOGISTIC_VG.launches
    with pytest.raises(ValueError):
        logistic_value_and_grad(q.double(), x, y, w, INV_VAR)
    with pytest.raises(ValueError):
        logistic_value_and_grad(q.t().contiguous().t(), x, y, w, INV_VAR)
    with pytest.raises(ValueError):
        logistic_value_and_grad(q, x.cpu(), y, w, INV_VAR)
    # a plane of another form or shape than the launch reads
    for form, xs in (("grad_bf16", x), ("f32", x[:32])):
        plane = L.logistic_planes(xs, y[:len(xs)], w[:len(xs)], form)
        with pytest.raises(ValueError):
            logistic_value_and_grad(q, x, y, w, INV_VAR, planes=plane)
    assert LOGISTIC_VG.launches == before


def _gaussian(seed, c, d, max_depth=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    q = torch.randn((c, d), **kw)
    p = torch.randn((c, d), **kw)
    lam = 0.5 + torch.rand((d,), **kw)
    minv = 0.5 + torch.rand((d,), **kw)
    out = dict(q=q, p=p, lam=lam, minv=minv)
    if max_depth is not None:
        out["dirs"] = torch.randint(0, 2 ** 32, (c,), dtype=torch.int64, **kw)
        out["unif"] = torch.rand((tree.n_uniforms(max_depth), c), **kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(1, 1), (37, 7), (300, 100), (9, 257),
                                 (64, 1000)])
def test_cuda_leapfrog_matches_plain_version(c, d):
    """K3 against its plain version on ragged C (not a multiple of the
    8-row block) and D (not a multiple of the 32 lanes; K3 has no
    compile-time bound on D): the vectors are the same f32 operations in
    the same order, so they are equal; the two row sums are taken in
    another order, so they agree to 1e-5 of the sum of |terms|."""
    _needs_card()
    x = _gaussian(1, c, d)
    eps = torch.where(torch.arange(c, device="cuda") % 2 == 0, 0.3, -0.2)
    before = lf.LEAPFROG_GAUSSIAN.launches
    got = lf.fused_gaussian_leapfrog(x["q"], x["p"], eps, x["lam"],
                                     x["minv"])
    torch.cuda.synchronize()
    assert lf.LEAPFROG_GAUSSIAN.launches == before + 1
    want = lf.fused_gaussian_leapfrog_plain(x["q"], x["p"], eps, x["lam"],
                                            x["minv"])
    q_new, p_new = want[0], want[1]
    scales = ((x["lam"] * q_new * q_new).abs().sum(1),
              (p_new * x["minv"] * p_new).abs().sum(1))
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (3, 4):
            assert bool(((g - w).abs() <= 1e-5 * scales[i - 3]).all())
        else:
            assert torch.equal(g, w), i


INT_OUT = ("term", "term_left", "term_right", "depth", "steps")


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(37, 7), (70, 64), (45, 65), (33, 128),
                                 (40, 129), (21, 256)])
@pytest.mark.parametrize("eps", [0.25, 2.4, 0.004])
def test_cuda_tree_matches_plain_version(c, d, eps):
    """K5 against its plain version, one warp per chain against the lockstep
    form, on ragged C and on D at and around each compile-time bound (64,
    128, 256), at a mixed, a divergent and a max-depth step size
    (max_depth 6): equal integer fields on all chains but at most one in
    twenty (a U-turn statistic within rounding of 0 can flip, the row sums
    being taken in another order), and on the chains that agree the float
    fields to 1e-4 relative."""
    _needs_card()
    md = 6
    x = _gaussian(2, c, d, md)
    e = torch.full((c,), eps, device="cuda")
    before = tree.TREE_GAUSSIAN.launches
    got = tree.gaussian_tree_transition(
        x["q"], x["p"], e, tree.direction_words_int32(x["dirs"]), x["unif"],
        x["lam"], x["minv"], md, -1000.0)
    torch.cuda.synchronize()
    assert tree.TREE_GAUSSIAN.launches == before + 1
    want = tree.gaussian_tree_transition_plain(
        x["q"], x["p"], e, x["dirs"], x["unif"], x["lam"], x["minv"], md,
        -1000.0)
    bad = torch.zeros(c, dtype=torch.bool, device="cuda")
    for f in INT_OUT:
        bad |= getattr(got, f) != getattr(want, f)
    assert int(bad.sum()) <= c // 20
    ok = ~bad
    for f in ("q", "logp", "grad", "energy", "log_sum_alpha"):
        g, w = getattr(got, f)[ok], getattr(want, f)[ok]
        same = (g == w) | ((g - w).abs() <= 1e-4 * (1 + w.abs()))
        assert bool(same.all()), f
    if eps == 0.004:
        assert bool((want.depth == md).all())
    if eps == 2.4:
        assert bool((want.term == 1).any())


@pytest.mark.cuda
def test_cuda_gaussian_wrappers_refuse_what_the_kernels_do_not_take():
    """D above the tree kernel's bound, a CPU tensor beside CUDA ones, a
    float64 or non-contiguous input, and uniforms of the wrong shape raise
    before anything is launched."""
    _needs_card()
    md = 4
    x = _gaussian(3, 16, 9, md)
    e = torch.full((16,), 0.3, device="cuda")
    dirs = tree.direction_words_int32(x["dirs"])
    lf_before = lf.LEAPFROG_GAUSSIAN.launches
    tr_before = tree.TREE_GAUSSIAN.launches
    with pytest.raises(ValueError):
        lf.fused_gaussian_leapfrog(x["q"], x["p"], e, x["lam"].cpu(),
                                   x["minv"])
    with pytest.raises(ValueError):
        lf.fused_gaussian_leapfrog(x["q"].double(), x["p"], e, x["lam"],
                                   x["minv"])
    with pytest.raises(ValueError):
        lf.fused_gaussian_leapfrog(x["q"].t().contiguous().t(), x["p"], e,
                                   x["lam"], x["minv"])
    wide = _gaussian(4, 4, tree.MAX_DIM + 1, md)
    with pytest.raises(ValueError):
        tree.gaussian_tree_transition(
            wide["q"], wide["p"], e[:4],
            tree.direction_words_int32(wide["dirs"]), wide["unif"],
            wide["lam"], wide["minv"], md, -1000.0)
    with pytest.raises(ValueError):
        tree.gaussian_tree_transition(x["q"], x["p"], e, dirs,
                                      x["unif"].cpu(), x["lam"], x["minv"],
                                      md, -1000.0)
    with pytest.raises(ValueError):
        tree.gaussian_tree_transition(x["q"], x["p"], e, x["dirs"],
                                      x["unif"], x["lam"], x["minv"], md,
                                      -1000.0)
    with pytest.raises(ValueError):
        tree.gaussian_tree_transition(x["q"], x["p"], e, dirs,
                                      x["unif"][1:], x["lam"], x["minv"], md,
                                      -1000.0)
    assert lf.LEAPFROG_GAUSSIAN.launches == lf_before
    assert tree.TREE_GAUSSIAN.launches == tr_before


def _key(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return philox.draw_key(g)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,md,k", [(37, 7, 5, 3), (300, 100, 10, 2)])
def test_cuda_generator_matches_plain_philox(c, d, md, k):
    """The kernel's ``__device__`` Philox (the source's second launcher)
    against ``utils/philox.py`` run on the card on the same key: direction
    words and uniforms bit for bit; the Box-Muller normals within 16 ulp of
    max(1, |x|) (``logf``, ``cosf`` and torch's ``log``, ``cos`` may round
    differently; ``sqrt(-2 log u1)`` is at most 5.8)."""
    _needs_card()
    key = _key(c)
    before = tree.PHILOX_DRAWS.launches
    normals, dirs, unif = tree.philox_draws(key, c, d, md, k)
    torch.cuda.synchronize()
    assert tree.PHILOX_DRAWS.launches == before + 1
    rows = torch.arange(c, dtype=torch.int64, device="cuda")
    for s in range(k):
        want_dirs = tree.direction_words_int32(
            philox.direction_words(key, rows, s))
        assert torch.equal(dirs[s], want_dirs)
        assert torch.equal(unif[s], philox.uniforms(
            key, rows, s, range(tree.n_uniforms(md))))
        want = philox.normals(key, rows, s, d)
        ulp = 2.0 ** -23 * torch.clamp(want.abs(), min=1.0)
        assert bool(((normals[s] - want).abs() <= 16 * ulp).all())
    assert bool((unif >= 0).all() and (unif < 1).all())
    assert float(normals.abs().max()) <= philox.MAX_NORMAL


def _compare_tree_fields(got, want, c, allowed):
    """At most ``allowed`` chains differ in an integer field; on the others
    the float fields agree to 1e-4 relative (row sums in another order)."""
    bad = torch.zeros(c, dtype=torch.bool, device="cuda")
    for f in INT_OUT:
        bad |= (getattr(got, f).reshape(c) != getattr(want, f))
    assert int(bad.sum()) <= allowed
    ok = ~bad
    for f in ("q", "logp", "energy", "log_sum_alpha"):
        g = getattr(got, f).reshape(1, c, -1)
        w = getattr(want, f).reshape(1, c, -1)
        same = (g == w) | ((g - w).abs() <= 1e-4 * (1 + w.abs()))
        assert bool(same[:, ok].all()), f


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["prng", "refresh"])
@pytest.mark.parametrize("c,d", [(37, 7), (45, 65), (21, 256)])
@pytest.mark.parametrize("eps", [0.25, 2.4])
def test_cuda_tree_drawing_forms_match_plain(form, c, d, eps):
    """K5 drawing its own uniforms (``prng``: momentum and directions given)
    or everything (``refresh``: the momentum as sqrt-mass times its
    normals), with one row in five not valid, against the plain version fed
    the draws of the kernel's own generator: as in
    ``test_cuda_tree_matches_plain_version``; the invalid rows keep the
    records of an empty tree."""
    _needs_card()
    md = 6
    x = _gaussian(5, c, d, md)
    e = torch.full((c,), eps, device="cuda")
    valid = (torch.arange(c, device="cuda") % 5 != 3).to(torch.int32)
    key = _key(d)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    sqrt_mass = 1.0 / torch.sqrt(x["minv"])
    q_state = x["q"].clone()
    before = tree.TREE_GAUSSIAN.launches
    if form == "prng":
        got = tree.gaussian_tree_sweep(
            q_state, e, x["lam"], x["minv"], md, -1000.0,
            momentum=x["p"][None], dirs=dirs, key=key, valid=valid)
        p0 = x["p"]
    else:
        got = tree.gaussian_tree_sweep(
            q_state, e, x["lam"], x["minv"], md, -1000.0, key=key,
            sqrt_mass=sqrt_mass, valid=valid)
        p0 = sqrt_mass * xi[0]
    torch.cuda.synchronize()
    assert tree.TREE_GAUSSIAN.launches == before + 1
    want = tree.gaussian_tree_transition_plain(
        x["q"], p0, e, dirs[0], unif[0], x["lam"], x["minv"], md, -1000.0,
        valid)
    _compare_tree_fields(got, want, c, c // 20)
    assert torch.equal(q_state, x["q"])  # the start is only read
    assert torch.equal(got.grad, -(x["lam"] * got.q[0]))
    off = valid == 0
    assert bool((got.term[0][off] == 0).all() and (got.term_left[0][off] == 1)
                .all() and (got.term_right[0][off] == 0).all())
    assert bool((got.depth[0][off] == 0).all()
                and (got.steps[0][off] == 0).all())
    assert torch.equal(got.q[0][off], x["q"][off])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 100])
def test_cuda_sweep_bit_identical_to_single_launches(d):
    """One launch of K = 5 transitions drawing everything itself, against 5
    launches of one transition fed what the generator draws for that key
    (momentum ``sqrt_mass * xi``): every field equal bit for bit."""
    _needs_card()
    c, md, k = 70, 7, 5
    x = _gaussian(6, c, d, md)
    e = torch.full((c,), 0.3, device="cuda")
    valid = (torch.arange(c, device="cuda") < 64).to(torch.int32)
    key = _key(7)
    sqrt_mass = 1.0 / torch.sqrt(x["minv"])
    q_state = x["q"].clone()
    swept = tree.gaussian_tree_sweep(q_state, e, x["lam"], x["minv"], md,
                                     -1000.0, k, key=key,
                                     sqrt_mass=sqrt_mass, valid=valid)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    q = x["q"]
    for s in range(k):
        one = tree.gaussian_tree_sweep(
            q, e, x["lam"], x["minv"], md, -1000.0,
            momentum=(sqrt_mass * xi[s])[None], dirs=dirs[s:s + 1],
            unif=unif[s:s + 1], valid=valid)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (s, f)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)
    assert torch.equal(swept.q[-1], q)
    assert torch.equal(q_state, x["q"])  # the start is only read

    # the carry may be the output buffer's last transition: the next launch
    # from it into the same buffers equals one from a copy into new ones
    ref = tree.gaussian_tree_sweep(swept.q[-1].clone(), e, x["lam"],
                                   x["minv"], md, -1000.0, k, key=key,
                                   sqrt_mass=sqrt_mass, valid=valid)
    again = tree.gaussian_tree_sweep(swept.q[-1], e, x["lam"], x["minv"], md,
                                     -1000.0, k, key=key, sqrt_mass=sqrt_mass,
                                     valid=valid, out=swept)
    for f in tree.TreeOut._fields:
        assert torch.equal(getattr(again, f), getattr(ref, f)), f"carry {f}"


@pytest.mark.cuda
def test_cuda_sweep_wrapper_refuses_what_the_kernel_does_not_take():
    """No key where the kernel must draw, a key of the wrong type, stacks of
    the wrong depth and an int64 ``valid`` raise before anything is
    launched."""
    _needs_card()
    c, d, md = 16, 9, 4
    x = _gaussian(8, c, d, md)
    e = torch.full((c,), 0.3, device="cuda")
    sm = 1.0 / torch.sqrt(x["minv"])
    key = _key(9)
    dirs = tree.direction_words_int32(x["dirs"])[None]
    before = tree.TREE_GAUSSIAN.launches
    cases = [dict(sqrt_mass=sm),
             dict(sqrt_mass=sm, key=key.to(torch.int32)),
             dict(momentum=x["p"][None], dirs=dirs, key=key,
                  unif=x["unif"][None][:, 1:]),
             dict(momentum=x["p"].expand(2, c, d).contiguous(), dirs=dirs,
                  key=key),
             dict(sqrt_mass=sm, key=key, valid=torch.ones(c, device="cuda",
                                                           dtype=torch.int64))]
    for kw in cases:
        with pytest.raises(ValueError):
            tree.gaussian_tree_sweep(x["q"].clone(), e, x["lam"], x["minv"],
                                     md, -1000.0, **kw)
    assert tree.TREE_GAUSSIAN.launches == before


@pytest.mark.cuda
def test_cuda_flagship_sample_sweeps_through_the_kernel():
    """``sample()`` with ``tree_opts={"refresh_inside", "padded_io",
    "n_sweep": 8}``, ``thin=2`` and ``keep_dims`` on a 6-D standard normal at
    100 chains (padded to 104 by ``block_c=8``): one K5 launch per tuning
    transition and one per 8 sampling transitions; the recorded moments
    within 5 Monte Carlo standard errors."""
    _needs_card()
    from inplacedhmc_tpu_torch import TuningNUTS, default_warmup_stages
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch import sample
    from inplacedhmc_tpu_torch.models import std_normal
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=3, terminating_steps=25)
    n_warm = sum(s.n for s in stages if isinstance(s, TuningNUTS))
    tree.TREE_GAUSSIAN.launches = 0
    res = sample(3, std_normal(6), 256, 100, warmup_stages=stages,
                 tree_opts={"refresh_inside": True, "padded_io": True,
                            "n_sweep": 8, "block_c": 8},
                 thin=2, keep_dims=(0, 3, 5))
    torch.cuda.synchronize()
    assert tree.TREE_GAUSSIAN.launches == n_warm + 256 * 2 // 8
    x = res.draws.double()
    assert x.shape == (256, 100, 3) and bool(torch.isfinite(x).all())
    ess = diag.ess_bulk(x, cap=False)
    assert bool((x.mean(dim=(0, 1)).abs() < 5 * torch.sqrt(1 / ess)).all())
    assert float(diag.split_rhat(x).max()) < 1.05
    assert res.stats.steps.shape == (256, 100)


def _tile(name, seed, c, max_depth):
    """A tile physics bound on the card, with positions, momentum, direction
    words and uniforms for ``c`` chains of its 10-D model."""
    m = models.eight_schools() if name == "eight_schools" \
        else models.funnel(10)
    st = m.structure
    phys = tp.bind(st["physics"], {**st["data"], **st["scalars"]}, "cuda",
                   torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    q = torch.randn((c, 10), **kw)
    if name == "eight_schools":
        q[:, 0] = 5.0 + 4.0 * q[:, 0]
    minv = 0.5 + torch.rand((10,), **kw)
    return dict(phys=phys, q=q, minv=minv,
                p=torch.randn((c, 10), **kw) / minv.sqrt(),
                dirs=torch.randint(0, 2 ** 32, (c,), dtype=torch.int64, **kw),
                unif=torch.rand((tree.n_uniforms(max_depth), c), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eight_schools", "funnel"])
@pytest.mark.parametrize("c,eps", [(37, 0.05), (300, 0.4), (300, 2.5)])
def test_cuda_tile_tree_matches_plain_version(name, c, eps):
    """K5 with each tile physics against its plain version
    (``ops/tile_physics.py`` in the plain tree), max_depth 7, at a deep, a
    mixed and a divergent step size: the rule of
    ``test_cuda_tree_matches_plain_version`` (integer fields equal on all
    chains but one in twenty, float fields to 1e-4 relative on the rest);
    the physics' gradient holds row sums taken in another order on the
    card, so trajectories agree to f32 round-off, not bit for bit."""
    _needs_card()
    md = 7
    x = _tile(name, 8, c, md)
    e = torch.full((c,), eps, device="cuda")
    kern = tree.TREE_KERNELS[name]
    before = kern.launches
    got = tree.tree_transition(
        x["q"], x["p"], e, tree.direction_words_int32(x["dirs"]), x["unif"],
        x["phys"], x["minv"], md, -1000.0)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tree.tree_transition_plain(
        x["q"], x["p"], e, x["dirs"], x["unif"], x["phys"], x["minv"], md,
        -1000.0)
    bad = torch.zeros(c, dtype=torch.bool, device="cuda")
    for f in INT_OUT:
        bad |= getattr(got, f) != getattr(want, f)
    assert int(bad.sum()) <= c // 20
    ok = ~bad
    for f in ("q", "logp", "grad", "energy", "log_sum_alpha"):
        g, w = getattr(got, f)[ok], getattr(want, f)[ok]
        same = (g == w) | ((g - w).abs() <= 1e-4 * (1 + w.abs()))
        assert bool(same.all()), f
    for f in ("q", "logp", "grad", "energy"):
        assert bool(torch.isfinite(getattr(got, f)).all()), f
    if eps == 2.5:
        assert bool((want.term == 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eight_schools", "funnel"])
def test_cuda_tile_sweep_bit_identical_to_single_launches(name):
    """One launch of K = 5 transitions of a tile physics drawing everything
    itself, against 5 launches of one transition fed what the generator
    draws for that key: every field equal bit for bit."""
    _needs_card()
    c, md, k = 70, 7, 5
    x = _tile(name, 9, c, md)
    e = torch.full((c,), 0.3, device="cuda")
    key = _key(10)
    sqrt_mass = 1.0 / torch.sqrt(x["minv"])
    swept = tree.tree_sweep(x["q"], e, x["phys"], x["minv"], md, -1000.0, k,
                            key=key, sqrt_mass=sqrt_mass)
    xi, dirs, unif = tree.philox_draws(key, c, 10, md, k)
    q = x["q"]
    for s in range(k):
        one = tree.tree_sweep(
            q, e, x["phys"], x["minv"], md, -1000.0,
            momentum=(sqrt_mass * xi[s])[None], dirs=dirs[s:s + 1],
            unif=unif[s:s + 1])
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (s, f)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)


@pytest.mark.cuda
def test_cuda_tile_wrapper_refuses_what_the_kernel_does_not_take():
    """A data row in float64 or of the wrong length, or eight schools at
    D = 1 (its kernel reads mu and log_tau from lanes 0 and 1), raise
    before anything is launched."""
    _needs_card()
    md = 5
    x = _tile("eight_schools", 11, 16, md)
    e = torch.full((16,), 0.3, device="cuda")
    d32 = tree.direction_words_int32(x["dirs"])
    kern = tree.TREE_KERNELS["eight_schools"]
    before = kern.launches
    for bad in ({"y": x["phys"].data["y"].double()},
                {"sig": x["phys"].data["sig"][:9].contiguous()}):
        phys = tp.Bound("eight_schools", {**x["phys"].data, **bad})
        with pytest.raises(ValueError):
            tree.tree_transition(x["q"], x["p"], e, d32, x["unif"], phys,
                                 x["minv"], md, -1000.0)
    one = tp.bind("eight_schools", {k: v[:1] for k, v in
                                    x["phys"].data.items()}, "cuda",
                  torch.float32)
    with pytest.raises(RuntimeError):
        tree.tree_transition(x["q"][:, :1].contiguous(), x["p"][:, :1]
                             .contiguous(), e, d32, x["unif"], one,
                             x["minv"][:1].contiguous(), md, -1000.0)
    assert kern.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eight_schools", "funnel"])
def test_cuda_tile_sample_goes_through_its_kernel(name):
    """``sample()`` on eight schools or the funnel at 64 chains, a short
    warmup and 200 draws: one launch of the model's K5 per transition and
    none of another kernel; finite draws."""
    _needs_card()
    from inplacedhmc_tpu_torch import (DualAveraging, FindLocalOptimum,
                                       TuningNUTS, default_warmup_stages,
                                       sample)
    m = models.eight_schools() if name == "eight_schools" \
        else models.funnel(10)
    stages = default_warmup_stages(
        local_optimization=None if name == "funnel" else FindLocalOptimum(),
        stepsize_adaptation=DualAveraging(delta=0.9 if name == "funnel"
                                          else 0.8),
        init_steps=40, middle_steps=25, doubling_stages=2,
        terminating_steps=25)
    n_warm = sum(s.n for s in stages if isinstance(s, TuningNUTS))
    kernels = list(tree.TREE_KERNELS.values()) + [lf.LEAPFROG_GAUSSIAN,
                                                  LOGISTIC_VG]
    for k in kernels:
        k.launches = 0
    res = sample(1, m, 200, 64, warmup_stages=stages, device="cuda")
    torch.cuda.synchronize()
    counts = {k.source: k.launches for k in kernels}
    assert counts.pop(f"tree_{name}.cu") == n_warm + 200, counts
    assert not any(counts.values()), counts
    assert bool(torch.isfinite(res.draws).all())



def _dense(seed, c, d, physics, metric):
    """Inputs of K5-dense: positions, the physics' data (the Gaussian's
    precision row, or a dense Wishart precision), and the metric, a dense
    ``M^-1`` of eigenvalues in about [0.5, 2.5] or a diagonal row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    q = 0.5 * torch.randn((c, d), **kw)
    if physics == "gaussian":
        data = {"lam": 0.5 + torch.rand((d,), **kw)}
    else:
        x = torch.randn((d, 2 * d), **kw)
        p = x @ x.T / (2 * d)
        data = {"prec": (0.5 * (p + p.T)).contiguous()}
    b = torch.randn((d, d), **kw) / d ** 0.5
    minv = 0.5 * torch.eye(d, device="cuda") + 0.5 * (b @ b.T)
    minv = (0.5 * (minv + minv.T)).contiguous()
    if metric == "diag":
        minv = torch.diagonal(minv).contiguous()
    return q, tp.bind(physics, data, "cuda", torch.float32), minv


def _scale(minv):
    """The momentum's scale: the sqrt-mass row, or ``mass_chol^T``."""
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    if minv.ndim == 1:
        return 1.0 / torch.sqrt(minv)
    return dense_metric(minv).mass_chol.T.contiguous()


def _compare_any_field(got, want, c, allowed, lsa_bound=False):
    """At most ``allowed`` chains differ in an integer field or in a float
    field beyond 1e-4 relative: the dense products (the metric's and the
    dense Gaussian's P q) add their D terms in another order than torch's
    matmul, so a proposal's log-uniform test or a U-turn statistic within
    rounding of its threshold can decide the other way.  ``lsa_bound``
    (a log density summed over more than 256 coordinates, whose energies
    run to thousands): ``log_sum_alpha``, a log of a sum of
    ``exp(min(delta, 0))`` with each ``delta`` a difference of two joint
    energies, also agrees within 4 e, e the largest energy difference of
    the chains that agree in their integer fields (``chip_smoke.py::
    compare_tree``'s rule)."""
    bad = torch.zeros(c, dtype=torch.bool, device="cuda")
    for f in INT_OUT:
        bad |= (getattr(got, f).reshape(c) != getattr(want, f))
    e = (got.energy.reshape(c) - want.energy)[~bad].abs()
    e = e[torch.isfinite(e)]
    for f in ("q", "logp", "energy", "log_sum_alpha"):
        g = getattr(got, f).reshape(c, -1)
        w = getattr(want, f).reshape(c, -1)
        same = (g == w) | ((g - w).abs() <= 1e-4 * (1 + w.abs()))
        if f == "log_sum_alpha" and lsa_bound and len(e):
            same |= (g - w).abs() <= 4 * float(e.max())
        bad |= ~same.all(dim=1)
    assert int(bad.sum()) <= allowed, int(bad.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("physics,metric", [
    ("gaussian", "dense"), ("dense_gaussian", "diag"),
    ("dense_gaussian", "dense")])
@pytest.mark.parametrize("c,d", [(37, 7), (45, 65), (21, 200)])
@pytest.mark.parametrize("eps", [0.25, "unstable"])
@pytest.mark.parametrize("form", ["prng", "refresh"])
def test_cuda_dense_tree_matches_plain_version(physics, metric, c, d, eps,
                                               form):
    """K5-dense against its plain version fed the kernel's own draws: the
    Gaussian physics under a dense metric, and the dense Gaussian's physics
    under a diagonal and under a dense metric, on ragged C and on D within
    each compile-time bound, at a mixed step size and at four times the
    leapfrog's stability limit 2 / sqrt(lambda_max(M^-1 P)), where chains
    diverge (max_depth 6), the uniforms drawn in the kernel and, with
    ``refresh``, the momentum too (``xi mass_chol^T`` for a dense metric):
    at most one chain in twenty differs (``_compare_any_field``)."""
    _needs_card()
    md = 6
    q, phys, minv = _dense(6, c, d, physics, metric)
    if eps == "unstable":
        prec = phys.matrix() if phys.matrix() is not None \
            else torch.diag(phys.data["lam"])
        m = minv if minv.ndim == 2 else torch.diag(minv)
        lam_max = float(torch.linalg.eigvals(
            (m @ prec).double()).real.max())
        eps = 4 * 2.0 / lam_max ** 0.5
    e = torch.full((c,), eps, device="cuda")
    key = _key(c + d)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    scale = _scale(minv)
    kern = (tree.TREE_DENSE_KERNELS if metric == "dense"
            else tree.TREE_KERNELS)[physics]
    before = kern.launches
    if form == "prng":
        p0 = tree.refresh_momentum(scale, torch.randn(
            (c, d), generator=torch.Generator(device="cuda").manual_seed(7),
            device="cuda")).contiguous()
        got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                                   -1000.0, key=key)
    else:
        p0 = tree.refresh_momentum(scale, xi[0])
        got = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                                   -1000.0, key=key, sqrt_mass=scale)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    _compare_any_field(got, want, c, c // 20)
    if eps > 0.25:
        assert bool((want.term == 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["gaussian", "dense_gaussian"])
def test_cuda_dense_sweep_bit_identical_to_single_launches(physics):
    """Under a dense metric, one launch of 5 transitions drawing everything
    equals 5 one-transition launches fed what its generator draws, the
    momentum ``xi mass_chol^T`` taken in the kernel's order (over i in
    order, each product and sum rounded on its own), bit for bit."""
    _needs_card()
    c, d, md, k = 40, 70, 6, 5
    q, phys, minv = _dense(8, c, d, physics, "dense")
    scale = _scale(minv)
    e = torch.full((c,), 0.3, device="cuda")
    key = _key(9)
    swept = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                            sqrt_mass=scale)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    for s in range(k):
        p = torch.zeros_like(xi[s])
        for i in range(d):
            p = p + xi[s][:, i:i + 1] * scale[i]
        one = tree.tree_sweep(q, e, phys, minv, md, -1000.0, momentum=p[None],
                              dirs=dirs[s:s + 1], unif=unif[s:s + 1])
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (f, s)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)


@pytest.mark.cuda
def test_cuda_dense_wrapper_refuses_what_the_kernel_does_not_take():
    """A dense metric with a sqrt-mass row, a float64 or wrongly shaped
    ``M^-1`` or precision raise before anything is launched."""
    _needs_card()
    c, d, md = 16, 9, 4
    q, phys, minv = _dense(10, c, d, "dense_gaussian", "dense")
    e = torch.full((c,), 0.3, device="cuda")
    key = _key(11)
    kern = tree.TREE_DENSE_KERNELS["dense_gaussian"]
    before = kern.launches
    with pytest.raises(ValueError):
        tree.tree_transition(q, None, e, None, None, phys, minv, md, -1000.0,
                             key=key, sqrt_mass=torch.ones(d, device="cuda"))
    with pytest.raises(ValueError):
        tree.tree_transition(q, None, e, None, None, phys, minv.double(), md,
                             -1000.0, key=key, sqrt_mass=_scale(minv))
    bad = tp.Bound("dense_gaussian",
                   {"prec": phys.data["prec"][:, :d - 1].contiguous()})
    with pytest.raises(ValueError):
        tree.tree_transition(q, None, e, None, None, bad, minv, md, -1000.0,
                             key=key, sqrt_mass=_scale(minv))
    assert kern.launches == before


@pytest.mark.cuda
def test_cuda_mvn_sample_goes_through_dense_k5():
    """``sample()`` on a 30-D ``mvn`` at 64 chains with dense windows: K5
    with the dense Gaussian's physics, its diagonal launcher until the first
    dense window closes and its dense one after, no other kernel; finite
    draws."""
    _needs_card()
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 45))
    m = models.mvn(np.linalg.inv(x @ x.T))
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=2, terminating_steps=25,
                                   metric="dense")
    kernels = [*tree.TREE_KERNELS.values(), *tree.TREE_DENSE_KERNELS.values(),
               lf.LEAPFROG_GAUSSIAN, LOGISTIC_VG]
    for k in kernels:
        k.launches = 0
    res = sample(2, m, 100, 64, warmup_stages=stages, device="cuda")
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    assert counts.pop("tree_dense_gaussian_launch") == 40 + 25, counts
    assert counts.pop("tree_dense_gaussian_dense_launch") == 50 + 25 + 100
    assert not any(counts.values()), counts
    assert bool(torch.isfinite(res.draws).all())


def _logistic_tree(seed, c, d, metric, n=1000, block_n=333, grad_bf16=False):
    """Inputs of K5-logistic: a logistic regression of ``n`` observations
    (``block_n`` 333 pads 1,000 to 1,332 rows, so the kernel's last step of
    eight observations is ragged), positions from the Laplace
    approximation at the coefficients, the metric its covariance (dense) or
    the diagonal of it, and the leapfrog's stability limit 2 /
    sqrt(lambda_max(M^-1 H))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    beta = rng.normal(size=d) * 2.0 / np.sqrt(d)
    s = 1.0 / (1.0 + np.exp(-x @ beta))
    y = (rng.uniform(size=n) < s).astype(np.float32)
    h = (x.T * (s * (1 - s))) @ x + INV_VAR * np.eye(d)
    cov = np.linalg.inv(h)
    cov = 0.5 * (cov + cov.T)
    m = cov if metric == "dense" else np.diag(np.diag(cov))
    chol = np.linalg.cholesky(m)
    limit = 2.0 / np.linalg.eigvalsh(chol.T @ h @ chol).max() ** 0.5
    q = beta + rng.normal(size=(c, d)) @ np.linalg.cholesky(cov).T
    data = tp.logistic_data(torch.as_tensor(x, dtype=torch.float32,
                                            device="cuda"),
                            torch.as_tensor(y, device="cuda"), INV_VAR,
                            grad_bf16=grad_bf16, block_n=block_n)
    minv = torch.as_tensor(cov if metric == "dense" else np.diag(cov),
                           dtype=torch.float32, device="cuda").contiguous()
    return (torch.as_tensor(q, dtype=torch.float32, device="cuda"),
            tp.bind("logistic", data), minv, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("c,d", [(37, 7), (45, 50), (21, 65)])
@pytest.mark.parametrize("eps", [0.5, 4.0])
@pytest.mark.parametrize("form", ["prng", "refresh"])
def test_cuda_logistic_tree_matches_plain_version(metric, c, d, eps, form):
    """K5-logistic (``csrc/tree_logistic.cu``) against its plain version fed
    the kernel's own draws, at D = 7, 50 and 65 (one, two and four
    registers a lane), 1,000 observations padded to 1,332, under a
    diagonal and a dense metric, at half the step size's stability limit
    and at four times it (chains diverge), the uniforms drawn in the kernel
    and, with ``refresh``, the momentum too: at most one chain in twenty
    differs (``_compare_any_field``: the sums of 1,000 terms are taken in
    another order)."""
    _needs_card()
    md = 6
    q, phys, minv, limit = _logistic_tree(20 + d, c, d, metric)
    e = torch.full((c,), eps * limit, device="cuda")
    key = _key(c + d + 1)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    scale = _scale(minv)
    kern = (tree.TREE_DENSE_KERNELS if metric == "dense"
            else tree.TREE_KERNELS)["logistic"]
    before = kern.launches
    if form == "prng":
        p0 = tree.refresh_momentum(scale, torch.randn(
            (c, d), generator=torch.Generator(device="cuda").manual_seed(3),
            device="cuda")).contiguous()
        got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                                   -1000.0, key=key)
    else:
        p0 = tree.refresh_momentum(scale, xi[0])
        got = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                                   -1000.0, key=key, sqrt_mass=scale)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    _compare_any_field(got, want, c, c // 20)
    assert bool(torch.isfinite(got.q).all() and torch.isfinite(got.grad).all())
    if eps > 1:
        assert bool((want.term == 1).any())
    else:
        assert float(want.depth.double().mean()) >= 1.5


@pytest.mark.cuda
def test_cuda_logistic_grad_bf16():
    """Under ``grad_bf16`` the kernel rounds the residual and x to bfloat16
    before the backward product, as the plain version does: the gradient
    of a transition's proposal agrees with the plain physics' on that
    proposal within the bfloat16 rounding of one residual, 2^-8 max |x|,
    beside f32 sums of 1,000 terms, and differs from the float32
    gradient.  The transition agrees with the plain version fed its draws
    in all but a fifth of the chains: a residual within the two sides'
    f32 rounding of a bfloat16 tie (about 1e-7 / 2^-8, 3e-5 of them) rounds
    to either side and moves a gradient component by up to 2^-8 |x|; with
    1,000 residuals at each of about 15 leaves a third of the chains meet
    one, and in some of those the trajectories part by more than 1e-4 (4
    of these 45 chains on an H100)."""
    _needs_card()
    c, d, md = 45, 50, 6
    q, phys, minv, limit = _logistic_tree(31, c, d, "dense", grad_bf16=True)
    e = torch.full((c,), 0.5 * limit, device="cuda")
    key = _key(32)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    scale = _scale(minv)
    got = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                               -1000.0, key=key, sqrt_mass=scale)
    want = tree.tree_transition_plain(q, tree.refresh_momentum(scale, xi[0]),
                                      e, dirs[0], unif[0], phys, minv, md,
                                      -1000.0)
    _compare_any_field(got, want, c, c // 5)
    _, g_plain = phys(got.q)
    xmax = float(phys.data["x"].abs().max())
    assert bool(((got.grad - g_plain).abs()
                 <= 2.0 ** -8 * xmax + 1e-4 * (1 + g_plain.abs())).all())
    f32 = tp.bind("logistic", {**phys.data, "grad_bf16": 0.0})
    assert not torch.allclose(f32(got.q)[1], got.grad, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_logistic_overflow_diverges():
    """A step size of 1e36, far past the stability limit, throws the first
    leaf's eta and momentum past float32's range (the log density or the
    kinetic energy is non-finite): every chain diverges there and keeps its
    start, with a finite log density and gradient; no NaN reaches a
    draw."""
    _needs_card()
    c, d, md = 33, 9, 5
    q, phys, minv, limit = _logistic_tree(41, c, d, "diag")
    e = torch.full((c,), 1e36, device="cuda")
    got = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                               -1000.0, key=_key(42),
                               sqrt_mass=_scale(minv))
    assert bool((got.term == 1).all() and (got.steps == 1).all())
    assert torch.equal(got.q, q)
    assert bool(torch.isfinite(got.logp).all()
                and torch.isfinite(got.grad).all())


@pytest.mark.cuda
def test_cuda_logistic_sweep_bit_identical_to_single_launches():
    """K5-logistic under a dense metric: one launch of 5 transitions
    drawing everything equals 5 one-transition launches fed what its
    generator draws (the momentum ``xi mass_chol^T`` in the kernel's order
    of operations), bit for bit."""
    _needs_card()
    c, d, md, k = 40, 50, 6, 5
    q, phys, minv, limit = _logistic_tree(51, c, d, "dense")
    scale = _scale(minv)
    e = torch.full((c,), 0.5 * limit, device="cuda")
    key = _key(52)
    swept = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                            sqrt_mass=scale)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    for s in range(k):
        p = torch.zeros_like(xi[s])
        for i in range(d):
            p = p + xi[s][:, i:i + 1] * scale[i]
        one = tree.tree_sweep(q, e, phys, minv, md, -1000.0, momentum=p[None],
                              dirs=dirs[s:s + 1], unif=unif[s:s + 1])
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (f, s)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)


@pytest.mark.cuda
def test_cuda_logistic_sample_goes_through_k5():
    """``sample(..., use_pallas="tree")`` on a logistic regression of 2,000
    x 10 at 64 chains with dense windows: K5-logistic's diagonal launcher
    until the first dense window closes and its dense one after, no other
    kernel (K1 not once); finite draws.  Without ``use_pallas`` the same
    model runs K1 and no K5."""
    _needs_card()
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    x, y, _ = models.synthetic_data(5, 2000, 10, device="cuda")
    m = models.logistic_regression(x, y, device="cuda")
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=2, terminating_steps=25,
                                   metric="dense")
    kernels = [*tree.TREE_KERNELS.values(), *tree.TREE_DENSE_KERNELS.values(),
               lf.LEAPFROG_GAUSSIAN, LOGISTIC_VG]
    for use_pallas in ("tree", "auto"):
        for k in kernels:
            k.launches = 0
        res = sample(2, m, 100, 64, warmup_stages=stages, device="cuda",
                     use_pallas=use_pallas)
        torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in kernels}
        if use_pallas == "tree":
            assert counts.pop("tree_logistic_launch") == 40 + 25, counts
            assert counts.pop("tree_logistic_dense_launch") == 50 + 25 + 100
        else:
            assert counts.pop("logistic_vg_launch") > 0
        assert not any(counts.values()), counts
        assert bool(torch.isfinite(res.draws).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_cuda_logistic_vjp_ignores_grad_bf16(metric):
    """Under ``physics_mode="vjp"`` ``grad_bf16`` is not read, as in JAX
    (whose ``vjp`` form differentiates its float32 ``tile_logp``): the data
    carry ``grad_bf16 = 0``, and a transition of the kernel equals the one
    built without ``grad_bf16`` bit for bit; its proposal's gradient is the
    float32 physics' within the f32 sums' rounding (1e-4 relative)."""
    _needs_card()
    c, d, md = 45, 50, 6
    q, phys, minv, limit = _logistic_tree(31, c, d, metric)
    e = torch.full((c,), 0.5 * limit, device="cuda")
    key, scale = _key(33), _scale(minv)
    data = tp.logistic_data(phys.data["x"][:1000], phys.data["y"][:1000],
                            INV_VAR, physics_mode="vjp", grad_bf16=True,
                            block_n=333)
    assert data["grad_bf16"] == 0.0
    vjp = tp.bind("logistic", data)
    got = tree.tree_transition(q, None, e, None, None, vjp, minv, md,
                               -1000.0, key=key, sqrt_mass=scale)
    f32 = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                               -1000.0, key=key, sqrt_mass=scale)
    for f in tree.TreeOut._fields:
        assert torch.equal(getattr(got, f), getattr(f32, f)), f
    _, g_plain = phys(got.q)
    assert bool(((got.grad - g_plain).abs()
                 <= 1e-4 * (1 + g_plain.abs())).all())


def _sv(seed, c, t, metric, saturate=False):
    """Inputs of K5-stoch_vol: a series of ``t`` returns drawn from the
    model (phi 0.9, s 0.3), positions about the truth (0.2 on the
    hyperparameters, 0.3 on each h_t; with ``saturate`` every fourth chain
    at ``raw_phi = 10``, where float32 ``tanh`` is 1), the physics on the
    card, and a metric: ``0.5 + U(0, 1)`` with the hyperparameters' entries
    a tenth of that, or dense, that diagonal plus a small symmetric part."""
    rng = np.random.default_rng(seed)
    phi, s = 0.9, 0.3
    h = np.zeros(t)
    h[0] = rng.normal() * s / np.sqrt(1 - phi * phi)
    for i in range(1, t):
        h[i] = phi * h[i - 1] + s * rng.normal()
    r = rng.normal(size=t) * np.exp(0.5 * h)
    q = np.concatenate([np.arctanh(phi) + 0.2 * rng.normal(size=(c, 1)),
                        np.log(s) + 0.2 * rng.normal(size=(c, 1)),
                        h + 0.3 * rng.normal(size=(c, t))], axis=1)
    if saturate:
        q[::4, 0] = 10.0
    m = models.stoch_vol(r.astype(np.float32))
    st = m.structure
    phys = tp.bind("stoch_vol", {**st["data"], **st["scalars"]})
    d = t + 2
    diag = 0.5 + rng.uniform(size=d)
    diag[:2] *= 0.1
    if metric == "dense":
        b = rng.normal(size=(d, d)) * 0.05 / np.sqrt(d)
        minv = np.diag(diag) + 0.5 * (b @ b.T) * np.sqrt(np.outer(diag, diag))
        minv = 0.5 * (minv + minv.T)
    else:
        minv = diag
    return (torch.as_tensor(q, dtype=torch.float32, device="cuda"), phys,
            torch.as_tensor(minv, dtype=torch.float32,
                            device="cuda").contiguous(), m)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("t", [5, 30, 31, 100, 254])
@pytest.mark.parametrize("eps", [0.01, 0.05, 0.4])
def test_cuda_stoch_vol_tree_matches_plain_version(metric, t, eps):
    """K5-stoch_vol (``csrc/tree_stoch_vol.cu``) against its plain version
    fed the kernel's own draws, at T = 5, 30, 31, 100 and 254 (D = 7, 32,
    33, 102 and 256: the AR(1) neighbour shifts inside one register, at its
    end, one past it, ending inside the fourth, and at the kernel's cap),
    under a diagonal and a dense metric, at a deep, a mixed and a divergent
    step size, the uniforms drawn in the kernel: at most one chain in
    twenty differs (``_compare_any_field``: the three row sums, and a dense
    metric's products, add their terms in another order); every state is
    finite."""
    _needs_card()
    c, md = 40, 7
    q, phys, minv, _ = _sv(60 + t, c, t, metric)
    d = t + 2
    e = torch.full((c,), eps, device="cuda")
    key = _key(t + 61)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    p0 = tree.refresh_momentum(_scale(minv), xi[0]).contiguous()
    kern = (tree.TREE_DENSE_KERNELS if metric == "dense"
            else tree.TREE_KERNELS)["stoch_vol"]
    before = kern.launches
    got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                               -1000.0, key=key)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    _compare_any_field(got, want, c, c // 20)
    for f in ("q", "logp", "grad", "energy"):
        assert bool(torch.isfinite(getattr(got, f)).all()), f
    if eps == 0.4:
        assert bool((want.term == 1).any())
    elif eps == 0.01:
        assert float(want.depth.double().mean()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_cuda_stoch_vol_saturated_start_diverges(metric):
    """Every fourth chain starts at ``raw_phi = 10``: float32 ``tanh`` is
    1, the log density ``-inf`` and ``d/draw_phi`` NaN, on the card as in
    the plain version and in JAX.  Those chains diverge at their first leaf
    and keep their start with its ``-inf`` log density and NaN gradient
    component; the kernel's records equal the plain version's on them, and
    the other chains agree as in the test above."""
    _needs_card()
    c, t, md = 40, 100, 7
    q, phys, minv, _ = _sv(70, c, t, metric, saturate=True)
    e = torch.full((c,), 0.05, device="cuda")
    key = _key(71)
    xi, dirs, unif = tree.philox_draws(key, c, t + 2, md)
    p0 = tree.refresh_momentum(_scale(minv), xi[0]).contiguous()
    got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                               -1000.0, key=key)
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    sat = q[:, 0] == 10.0
    for out in (got, want):
        assert bool((out.term[sat] == 1).all() and (out.steps[sat] == 1).all())
        assert torch.equal(out.q[sat], q[sat])
        assert bool(torch.isneginf(out.logp[sat]).all())
        assert bool(torch.isnan(out.grad[sat, 0]).all())
    rest = ~sat
    sub = tree.TreeOut(*(t_[rest] for t_ in got))
    ref = tree.TreeOut(*(t_[rest] for t_ in want))
    _compare_any_field(sub, ref, int(rest.sum()), int(rest.sum()) // 20)
    assert bool(torch.isfinite(got.q).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_cuda_stoch_vol_sweep_bit_identical_to_single_launches(metric):
    """K5-stoch_vol at T = 100: one launch of 5 transitions drawing
    everything equals 5 one-transition launches fed what its generator
    draws (under a dense metric the momentum ``xi mass_chol^T`` in the
    kernel's order of operations), bit for bit."""
    _needs_card()
    c, t, md, k = 70, 100, 7, 5
    q, phys, minv, _ = _sv(80, c, t, metric)
    d = t + 2
    e = torch.full((c,), 0.02, device="cuda")
    key, scale = _key(81), _scale(minv)
    swept = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                            sqrt_mass=scale)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    for s in range(k):
        if metric == "dense":
            p = torch.zeros_like(xi[s])
            for i in range(d):
                p = p + xi[s][:, i:i + 1] * scale[i]
        else:
            p = scale * xi[s]
        one = tree.tree_sweep(q, e, phys, minv, md, -1000.0,
                              momentum=p[None], dirs=dirs[s:s + 1],
                              unif=unif[s:s + 1])
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (s, f)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)


@pytest.mark.cuda
def test_cuda_stoch_vol_sample_goes_through_k5():
    """``sample()`` on stochastic volatility at T = 100 (config 5's recipe
    with a short schedule: delta 0.9, dense windows, no L-BFGS start) at
    64 chains and 100 draws: K5-stoch_vol's diagonal launcher until the
    first dense window closes and its dense one after, once per
    transition, and no other kernel; finite draws."""
    _needs_card()
    from inplacedhmc_tpu_torch import (DualAveraging, default_warmup_stages,
                                       sample)
    gen = torch.Generator(device="cuda").manual_seed(9)
    m = models.stoch_vol(models.synthetic_returns(gen, 100, 0.97, 0.15))
    stages = default_warmup_stages(
        local_optimization=None,
        stepsize_adaptation=DualAveraging(delta=0.9), init_steps=40,
        middle_steps=25, doubling_stages=2, terminating_steps=25,
        metric="dense")
    kernels = [*tree.TREE_KERNELS.values(), *tree.TREE_DENSE_KERNELS.values(),
               lf.LEAPFROG_GAUSSIAN, LOGISTIC_VG]
    for k in kernels:
        k.launches = 0
    res = sample(2, m, 100, 64, warmup_stages=stages, device="cuda")
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    assert counts.pop("tree_stoch_vol_launch") == 40 + 25, counts
    assert counts.pop("tree_stoch_vol_dense_launch") == 50 + 25 + 100
    assert not any(counts.values()), counts
    assert bool(torch.isfinite(res.draws).all())


# K5's wide form (D above 256: one chain per block of ceil(D / 256) warps):
# one past each warp's 256 coordinates, within a warp, at a warp's end, one
# past two warps, BASELINE config 5's T = 1,000 and the largest D
WIDE_DIMS = [257, 288, 511, 512, 513, 1002, 2048]


def _unstable_eps(phys, minv):
    """Four times the leapfrog's stability limit 2 / sqrt(lambda_max(M^-1
    P)) of a Gaussian physics: its chains diverge."""
    prec = phys.matrix() if phys.matrix() is not None \
        else torch.diag(phys.data["lam"])
    m = minv if minv.ndim == 2 else torch.diag(minv)
    lam_max = float(torch.linalg.eigvals((m @ prec).double()).real.max())
    return 4 * 2.0 / lam_max ** 0.5


def _wide_case(q, phys, minv, eps, form, md, seed):
    """One launch of the kernel of ``phys`` under ``minv`` and its plain
    version fed its draws: ``prng`` (momentum and directions given, the
    uniforms drawn) or ``refresh`` (everything drawn, the momentum through
    the metric's scale).  Returns both outputs."""
    c, d = q.shape
    e = torch.full((c,), eps, device="cuda")
    key = _key(seed)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    scale = _scale(minv)
    kern = (tree.TREE_DENSE_KERNELS if minv.ndim == 2
            else tree.TREE_KERNELS)[phys.name]
    before = kern.launches
    if form == "prng":
        p0 = tree.refresh_momentum(scale, torch.randn(
            (c, d), generator=torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")).contiguous()
        got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                                   -1000.0, key=key)
    else:
        p0 = tree.refresh_momentum(scale, xi[0])
        got = tree.tree_transition(q, None, e, None, None, phys, minv, md,
                                   -1000.0, key=key, sqrt_mass=scale)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("eps,form", [(0.25, "refresh"), ("unstable", "prng")])
def test_cuda_wide_gaussian_matches_plain_version(metric, d, eps, form):
    """K5's wide form with the Gaussian physics against its plain version
    fed the kernel's own draws, at D one past a warp, within one, at a
    warp's end, one past two warps, 1,002 and 2,048, under a diagonal and a
    dense metric (the block's mat-vec through shared memory, the refresh's
    ``xi mass_chol^T`` too), at a mixed step size drawing everything and at
    four times the stability limit (divergences) with the momentum given
    (max_depth 6): at most one chain in twenty differs
    (``_compare_any_field``: the row sums add their terms in another
    order); every state is finite."""
    _needs_card()
    c, md = 40, 6
    q, phys, minv = _dense(90 + d, c, d, "gaussian", metric)
    if eps == "unstable":
        eps = _unstable_eps(phys, minv)
    got, want = _wide_case(q, phys, minv, eps, form, md, d)
    _compare_any_field(got, want, c, c // 20, lsa_bound=True)
    assert bool(torch.isfinite(got.q).all())
    if eps > 0.25:
        assert bool((want.term == 1).any())
    else:
        assert float(want.depth.double().mean()) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("d", [257, 512])
def test_cuda_wide_dense_gaussian_matches_plain_version(metric, d):
    """K5's wide form with the dense Gaussian's physics (its ``P q`` a
    block's mat-vec through shared memory) against its plain version at
    D = 257 and 512, under a diagonal and a dense metric, everything drawn
    in the kernel, at a mixed step size: ``_compare_any_field``."""
    _needs_card()
    c, md = 40, 6
    q, phys, minv = _dense(95 + d, c, d, "dense_gaussian", metric)
    got, want = _wide_case(q, phys, minv, 0.25, "refresh", md, d + 1)
    _compare_any_field(got, want, c, c // 20, lsa_bound=True)
    assert bool(torch.isfinite(got.q).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("eps", [0.02, 0.4])
def test_cuda_wide_stoch_vol_matches_plain_version(metric, d, eps):
    """K5's wide form with stochastic volatility's physics at T = D - 2
    for each D of ``WIDE_DIMS``: the AR(1) neighbours cross every warp edge
    through shared memory (h_t from the warp before, innov_{t+1} from the
    warp after), raw_phi, log_s and h_1 reach every warp from the first,
    nothing is read past D.  Against its plain version fed the kernel's own
    draws, under a diagonal and a dense metric, at a deep and a divergent
    step size (max_depth 6): ``_compare_any_field``; every state finite."""
    _needs_card()
    c, md = 40, 6
    q, phys, minv, _ = _sv(100 + d, c, d - 2, metric)
    got, want = _wide_case(q, phys, minv, eps, "prng", md, d + 2)
    _compare_any_field(got, want, c, c // 20, lsa_bound=True)
    for f in ("q", "logp", "grad", "energy"):
        assert bool(torch.isfinite(getattr(got, f)).all()), f
    if eps == 0.4:
        assert bool((want.term == 1).any())
    else:
        assert float(want.depth.double().mean()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_cuda_wide_sweep_bit_identical_to_single_launches(metric):
    """K5's wide form at D = 1,002 (stochastic volatility at T = 1,000):
    one launch of 16 transitions drawing everything equals 16
    one-transition launches fed what its generator draws (under a dense
    metric the momentum ``xi mass_chol^T`` in the kernel's order of
    operations), bit for bit, every tenth row padded."""
    _needs_card()
    c, t, md, k = 40, 1000, 6, 16
    q, phys, minv, _ = _sv(110, c, t, metric)
    d = t + 2
    e = torch.full((c,), 0.02, device="cuda")
    valid = (torch.arange(c, device="cuda") % 10 != 9).to(torch.int32)
    key, scale = _key(111), _scale(minv)
    swept = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                            sqrt_mass=scale, valid=valid)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    for s in range(k):
        if metric == "dense":
            p = torch.zeros_like(xi[s])
            for i in range(d):
                p = p + xi[s][:, i:i + 1] * scale[i]
        else:
            p = scale * xi[s]
        one = tree.tree_sweep(q, e, phys, minv, md, -1000.0,
                              momentum=p[None], dirs=dirs[s:s + 1],
                              unif=unif[s:s + 1], valid=valid)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)[0]), \
                    (s, f)
        q = one.q[0]
    assert torch.equal(swept.grad, one.grad)
    assert int(swept.steps[:, 9::10].sum()) == 0


@pytest.mark.cuda
def test_cuda_wide_wrapper_refuses_what_the_kernel_does_not_take():
    """Past the wide form's bounds the wrapper raises before anything is
    launched: D = 2,049; D = 2,048 at max_depth 14, whose stacks pass the
    shared memory of one block; the funnel's physics at D = 300 (no wide
    form).  At D = 2,048 and max_depth 13 it launches."""
    _needs_card()
    x = _gaussian(120, 4, 2049, 14)
    e = torch.full((4,), 0.3, device="cuda")
    before = tree.TREE_GAUSSIAN.launches
    with pytest.raises(ValueError, match="D <= 2048"):
        tree.gaussian_tree_transition(
            x["q"], x["p"], e, tree.direction_words_int32(x["dirs"]),
            None, x["lam"], x["minv"], 10, -1000.0, key=_key(121))
    y = {k: v[..., :2048].contiguous() for k, v in x.items()
         if k in ("q", "p", "lam", "minv")}
    dirs = tree.direction_words_int32(x["dirs"])
    with pytest.raises(ValueError, match="shared memory"):
        tree.gaussian_tree_transition(y["q"], y["p"], e, dirs, None,
                                      y["lam"], y["minv"], 14, -1000.0,
                                      key=_key(122))
    assert tree.TREE_GAUSSIAN.launches == before
    st = models.funnel(300).structure
    phys = tp.bind("funnel", {**st["data"], **st["scalars"]})
    kern = tree.TREE_KERNELS["funnel"]
    f_before = kern.launches
    with pytest.raises(ValueError, match="item 1 \\(g\\)"):
        tree.tree_transition(y["q"][:, :300].contiguous(),
                             y["p"][:, :300].contiguous(), e, dirs, None,
                             phys, y["minv"][:300].contiguous(), 6, -1000.0,
                             key=_key(123))
    assert kern.launches == f_before
    out = tree.gaussian_tree_transition(y["q"], y["p"], e, dirs, None,
                                        y["lam"], y["minv"], 13, -1000.0,
                                        key=_key(124))
    torch.cuda.synchronize()
    assert tree.TREE_GAUSSIAN.launches == before + 1
    assert bool(torch.isfinite(out.q).all())


# the staged [D, D] products at the shapes whose plan
# tests/test_torch_staging.py holds: eight schools' and the funnel's D, logistic regression's, config 1's,
# stochastic volatility's T = 100, each side of the one-warp form's register
# bounds, the dense Gaussian's mvn, one past a warp, config 5's T = 1,000
# and the largest D
STAGING_DIMS = [10, 50, 100, 102, 128, 129, 200, 250, 256, 257, 1002, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("d", STAGING_DIMS)
@pytest.mark.parametrize("physics,metric,form", [
    ("gaussian", "dense", "prng"), ("dense_gaussian", "diag", "refresh"),
    ("dense_gaussian", "dense", "refresh")])
def test_cuda_staged_paths_bit_equal(d, physics, metric, form):
    """Every path the plan admits at the shape (the register path, the
    resident matrices, the ring), forced through the launch's hook: outputs
    equal bit for bit across paths (the same arithmetic in the same order), the
    plan's own path among them; each launch by ``_compare_any_field``
    against the plain version fed the kernel's draws; the launcher's plan
    (``plan_on_card``) equal to the Python mirror (``stage_plan``) for each
    path, and refusing the paths the mirror refuses.  The Gaussian under a
    dense metric (M^-1 staged), the dense Gaussian under a diagonal one (P)
    and under a dense one with the refresh (M^-1, mass_chol^T and P), at
    max_depth 6 and 10."""
    _needs_card()
    c = 24
    dense = metric == "dense"
    refresh = form == "refresh"
    q, phys, minv = _dense(170 + d, c, d, physics, metric)
    e = torch.full((c,), 0.25, device="cuda")
    key = _key(171 + d)
    scale = _scale(minv)
    for md in (10, 13):
        # the mirror's paths (the wide form's clusters are the launcher's
        # to plan: test_cuda_cluster_paths_bit_equal)
        for path in (None,) + tuple(p for p in tree.PATHS
                                    if p not in tree.CLUSTER_PATHS):
            try:
                want = tree.stage_plan(d, md, physics, dense, refresh, False,
                                       path)
            except ValueError:
                with pytest.raises(RuntimeError):
                    tree.plan_on_card(physics, d, md, dense, refresh,
                                      path=path)
                continue
            got, _ = tree.plan_on_card(physics, d, md, dense, refresh,
                                       path=path)
            assert got == want, (md, path, got, want)
    md = 6
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    p0 = tree.refresh_momentum(scale, xi[0]).contiguous()
    runs = ["register"]
    for path in ("resident", "ring"):
        try:
            tree.stage_plan(d, md, physics, dense, refresh, False, path)
        except ValueError:
            continue
        runs.append(path)
    runs.append(None)
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0)
    outs = []
    for path in runs:
        if refresh:
            got = tree.tree_transition(q, None, e, None, None, phys, minv,
                                       md, -1000.0, key=key, sqrt_mass=scale,
                                       path=path)
        else:
            got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv,
                                       md, -1000.0, key=key, path=path)
        torch.cuda.synchronize()
        outs.append((path, got))
        _compare_any_field(got, want, c, c // 20, lsa_bound=d > 256)
        assert bool(torch.isfinite(got.q).all())
    ref = outs[0][1]
    for run, got in outs[1:]:
        for f in tree.TreeOut._fields:
            a, b = getattr(got, f), getattr(ref, f)
            if a.dtype == torch.float32:   # bit for bit, NaN payloads too
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (run, f)


# the wide form's cluster paths (a chain's [D, D] products split by output
# columns across a cluster of 4 or 8 blocks, csrc/tree_kernel.cuh's
# Cluster): one past a warp, config 5's T = 1,000 and the largest D, and
# the physics whose wide launches have a dense M^-1
CLUSTER_DIMS = [257, 1002, 2048]
CLUSTER_CASES = [("gaussian", "dense"), ("dense_gaussian", "dense"),
                 ("stoch_vol", "dense")]


def _wide_matrix_case(physics, metric, d, c, seed):
    """Positions, the bound physics and the metric of a wide launch with a
    ``[D, D]`` product (stochastic volatility at T = D - 2)."""
    if physics == "stoch_vol":
        q, phys, minv, _ = _sv(seed, c, d - 2, metric)
        return q, phys, minv
    return _dense(seed, c, d, physics, metric)


def _kernel_momentum(xi, scale):
    """The refresh's momentum as the kernel computes it: ``xi`` times the
    scale row (diagonal), or ``xi mass_chol^T`` summed over i in order,
    each product and sum rounded on its own (dense)."""
    if scale.ndim == 1:
        return scale * xi
    p = torch.zeros_like(xi)
    for i in range(scale.shape[0]):
        p = p + xi[:, i:i + 1] * scale[i]
    return p


def _bits_equal(a, b):
    if a.dtype == torch.float32:   # bit for bit, NaN payloads too
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", CLUSTER_DIMS)
@pytest.mark.parametrize("physics,metric", CLUSTER_CASES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("form", ["refresh", "prng"])
def test_cuda_cluster_paths_bit_equal(d, physics, metric, bf16, form):
    """Every cluster (4 and 8 blocks a chain, forced through the launch's
    hook) and the wrapper's own choice against the register path (one
    block a chain, K = 1): every output and integer record equal bit for
    bit (each output column summed over i in order with the same
    operations), with the momentum and directions drawn in the kernel
    (``refresh``: its ``mass_chol^T`` product too) or given (``prng``),
    every seventh row padded (``valid`` 0: no steps), float32 and bfloat16
    stacks; the launcher admits both clusters at these shapes (its plan's
    path, one chain a block, ``CLUSTER_STAGES`` stages, within
    ``SMEM_LIMIT``); each launch counted, each cluster's in
    ``CLUSTER_LAUNCHES``.  The register path against the plain version fed
    the same momentum, directions and the kernel's uniforms
    (``_compare_any_field``: the row sums and products add in other
    orders)."""
    _needs_card()
    c, md = 24, 6
    dense = metric == "dense"
    refresh = form == "refresh"
    q, phys, minv = _wide_matrix_case(physics, metric, d, c, 180 + d)
    e = torch.full((c,), 0.02 if physics == "stoch_vol" else 0.25,
                   device="cuda")
    valid = (torch.arange(c, device="cuda") % 7 != 6).to(torch.int32)
    key, scale = _key(181 + d), _scale(minv)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    p0 = _kernel_momentum(xi[0], scale).contiguous()
    kern = (tree.TREE_DENSE_KERNELS if dense
            else tree.TREE_KERNELS)[physics]
    runs = {}
    for path in ("register",) + tree.CLUSTER_PATHS + (None,):
        if path is not None:
            got, _ = tree.plan_on_card(physics, d, md, dense, refresh, bf16,
                                       path)
            assert (got.path, got.warps) == (path, 1), got
            assert 0 < got.smem_bytes <= tree.SMEM_LIMIT
        before = kern.launches
        clustered = tree.CLUSTER_LAUNCHES.get(kern.symbol, 0)
        if refresh:
            runs[path] = tree.tree_transition(
                q, None, e, None, None, phys, minv, md, -1000.0, key=key,
                sqrt_mass=scale, valid=valid, ckpt_bf16=bf16, path=path)
        else:
            runs[path] = tree.tree_transition(
                q, p0, e, dirs[0], None, phys, minv, md, -1000.0, key=key,
                valid=valid, ckpt_bf16=bf16, path=path)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        if path in tree.CLUSTER_PATHS:
            assert tree.CLUSTER_LAUNCHES[kern.symbol] == clustered + 1
    ref = runs["register"]
    for path, got in runs.items():
        for f in tree.TreeOut._fields:
            assert _bits_equal(getattr(got, f), getattr(ref, f)), (path, f)
    assert int(ref.steps[valid == 0].sum()) == 0
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0, valid=valid,
                                      ckpt_bf16=bf16)
    _compare_any_field(ref, want, c, c // 20, lsa_bound=True)
    assert bool(torch.isfinite(ref.q).all())


@pytest.mark.cuda
@pytest.mark.parametrize("physics,metric", CLUSTER_CASES)
def test_cuda_cluster_sweep_bit_equal_to_the_register_path(physics, metric):
    """A sweep of 16 transitions in one launch at D = 257 (``n_sweep``, the
    momentum and directions drawn, every fifth row padded), float32 and
    bfloat16 stacks: every cluster path and the wrapper's own choice equal
    to the register path bit for bit; the padded rows take no step."""
    _needs_card()
    c, md, k, d = 24, 6, 16, 257
    dense = metric == "dense"
    q, phys, minv = _wide_matrix_case(physics, metric, d, c, 190)
    e = torch.full((c,), 0.02 if physics == "stoch_vol" else 0.25,
                   device="cuda")
    valid = (torch.arange(c, device="cuda") % 5 != 4).to(torch.int32)
    key, scale = _key(191), _scale(minv)
    for bf16 in (False, True):
        ref = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                              sqrt_mass=scale, valid=valid, ckpt_bf16=bf16,
                              path="register")
        for path in tree.CLUSTER_PATHS + (None,):
            got = tree.tree_sweep(q, e, phys, minv, md, -1000.0, k, key=key,
                                  sqrt_mass=scale, valid=valid,
                                  ckpt_bf16=bf16, path=path)
            torch.cuda.synchronize()
            for f in tree.TreeOut._fields:
                assert _bits_equal(getattr(got, f), getattr(ref, f)), \
                    (bf16, path, f)
        assert int(ref.steps[:, valid == 0].sum()) == 0
        assert float(ref.depth[:, valid == 1].double().mean()) >= 1


# K5's bfloat16 checkpoint stacks (ckpt_bf16): inside one register, one
# warp's fourth, one past a warp (the wide form), config 5's T = 1,000 and
# the largest D
BF16_DIMS = [32, 100, 257, 1002, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("d", BF16_DIMS)
def test_cuda_ckpt_bf16_matches_plain_version(metric, d):
    """K5 with bfloat16 checkpoint stacks against its plain version with
    them (each store rounded to bfloat16, to nearest even, the turn checks
    on the rounded values), stochastic volatility at T = D - 2 under a
    diagonal and a dense metric, at a deep step size (max_depth 7), the
    uniforms drawn in the kernel: ``_compare_any_field`` (a rounding of the
    same float32 value is the same on both sides; the row sums differ as
    with float32 stacks); every launch counted as a bfloat16 one; the
    termination agrees with float32 stacks on at least 90 % of chains
    (``tests/test_tree_pallas.py``'s check of the JAX kernel)."""
    _needs_card()
    c, md = 40, 7
    q, phys, minv, _ = _sv(130 + d, c, d - 2, metric)
    e = torch.full((c,), 0.02, device="cuda")
    key = _key(d + 131)
    xi, dirs, unif = tree.philox_draws(key, c, d, md)
    p0 = tree.refresh_momentum(_scale(minv), xi[0]).contiguous()
    kern = (tree.TREE_DENSE_KERNELS if metric == "dense"
            else tree.TREE_KERNELS)["stoch_vol"]
    before = tree.CKPT_BF16_LAUNCHES.get(kern.symbol, 0)
    got = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                               -1000.0, key=key, ckpt_bf16=True)
    torch.cuda.synchronize()
    assert tree.CKPT_BF16_LAUNCHES[kern.symbol] == before + 1
    want = tree.tree_transition_plain(q, p0, e, dirs[0], unif[0], phys, minv,
                                      md, -1000.0, ckpt_bf16=True)
    _compare_any_field(got, want, c, c // 20, lsa_bound=d > 256)
    for f in ("q", "logp", "grad", "energy"):
        assert bool(torch.isfinite(getattr(got, f)).all()), f
    assert float(want.depth.double().mean()) >= 3
    f32 = tree.tree_transition(q, p0, e, dirs[0], None, phys, minv, md,
                               -1000.0, key=key)
    agree = ((got.term == f32.term) & (got.depth == f32.depth)).double()
    assert float(agree.mean()) >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 100, 300])
def test_cuda_ckpt_bf16_rounding_decides_turns(d):
    """On inputs where the rounding decides turns (those of
    ``tests/test_torch_ckpt_bf16.py``: max_depth 8, eps 0.005, M^-1 1e-6
    past coordinate 0, standard normal momenta), 1,024 chains in the
    one-warp form (D = 1, 100) and the wide form (D = 300): the kernel's
    integer records with bfloat16 stacks differ from its float32 ones on
    some chains, and on each of those equal the plain version's with
    bfloat16 stacks; the launch agrees with that plain version by
    ``_compare_any_field``.  A kernel that skipped the rounding, or cut the
    mantissa, ends those chains otherwise."""
    _needs_card()
    c, md = 1024, 8
    x = _gaussian(150 + d, c, d, md)
    x["minv"][1:] = 1e-6
    e = torch.full((c,), 0.005, device="cuda")
    dirs = tree.direction_words_int32(x["dirs"])
    args = (x["q"], x["p"], e, dirs, x["unif"], x["lam"], x["minv"], md,
            -1000.0)
    got = tree.gaussian_tree_transition(*args, ckpt_bf16=True)
    got32 = tree.gaussian_tree_transition(*args)
    want = tree.gaussian_tree_transition_plain(*args, ckpt_bf16=True)

    def ints_differ(a, b):
        bad = torch.zeros((c,), dtype=torch.bool, device="cuda")
        for f in INT_OUT:
            bad |= getattr(a, f) != getattr(b, f)
        return bad

    flip = ints_differ(got, got32)
    assert int(flip.sum()) >= 1
    assert int((flip & ints_differ(got, want)).sum()) == 0
    _compare_any_field(got, want, c, c // 100, lsa_bound=d > 256)


@pytest.mark.cuda
def test_cuda_ckpt_bf16_lifts_the_wide_bound():
    """At D = 2,048 the wrapper refuses max_depth 14 with float32 stacks
    and launches it, and max_depth 26, with bfloat16 ones (half the
    shared memory); max_depth 27 is refused with both.  The bfloat16
    launch at max_depth 14 agrees with its plain version.  The occupancy
    query answers for both stack types at config 5's D = 1,002."""
    _needs_card()
    x = _gaussian(140, 16, 2048, 14)
    e = torch.full((16,), 0.3, device="cuda")
    dirs = tree.direction_words_int32(x["dirs"])
    key = _key(141)
    args = (x["q"], x["p"], e, dirs, None, x["lam"], x["minv"])
    with pytest.raises(ValueError, match="shared memory"):
        tree.gaussian_tree_transition(*args, 14, -1000.0, key=key)
    with pytest.raises(ValueError, match="shared memory"):
        tree.gaussian_tree_transition(*args, 27, -1000.0, key=key,
                                      ckpt_bf16=True)
    got = tree.gaussian_tree_transition(*args, 14, -1000.0, key=key,
                                        ckpt_bf16=True)
    _, _, unif = tree.philox_draws(key, 16, 2048, 14)
    want = tree.gaussian_tree_transition_plain(
        x["q"], x["p"], e, dirs, unif[0], x["lam"], x["minv"], 14, -1000.0,
        ckpt_bf16=True)
    _compare_any_field(got, want, 16, 0, lsa_bound=True)
    deep = tree.gaussian_tree_transition(*args, 26, -1000.0, key=key,
                                         ckpt_bf16=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(deep.q).all())
    for dense in (False, True):
        blocks = [tree.blocks_per_sm("stoch_vol", 1002, 10, dense, b)
                  for b in (False, True)]
        assert min(blocks) >= 1, blocks


def _packed_inputs(seed, c, n, d):
    """``_data``'s inputs (its NaN chain at q[5, min(2, d - 1)]) with X's
    bfloat16 halves and unit weights."""
    from inplacedhmc_tpu_torch.ops.logistic import split_bf16
    x, y, q = _data(seed, c, n, max(d, 3))
    x, q = x[:, :d].contiguous(), q[:, :d].contiguous()
    q[5, min(2, d - 1)] = float("nan")
    x_hi, x_lo = split_bf16(x)
    return q, x_hi, x_lo, x, y, torch.ones(n, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", [(33, 300, 1), (70, 1000, 17),
                                   (130, 129, 50), (65, 64, 64)])
def test_cuda_packed_matches_plain_version(c, n, d):
    """K2 against its plain version in float64 on the same bf16 halves
    (exact there), on C not a multiple of the 32-chain block and N not of
    the 64-observation tile, with a NaN chain: logp to 1e-5 of sum|terms|,
    each gradient component to 1e-5 of sum_n |resid x| (the kernel's
    float32 sums and its tensor cores' accumulation)."""
    _needs_card()
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_PACKED, logistic_value_and_grad_packed,
        logistic_value_and_grad_packed_plain)
    q, x_hi, x_lo, x, y, w = _packed_inputs(6, c, n, d)
    before = LOGISTIC_PACKED.launches
    lp, g = logistic_value_and_grad_packed(q, x_hi, x_lo, x, y, w, INV_VAR)
    torch.cuda.synchronize()
    assert LOGISTIC_PACKED.launches == before + 1
    lp_ref, g_ref = logistic_value_and_grad_packed_plain(
        q.double(), x_hi, x_lo, x.double(), y.double(), w.double(), INV_VAR)
    ok = torch.isfinite(lp_ref)
    assert torch.equal(torch.isfinite(lp), ok)
    assert bool((g[~ok] == 0).all())
    eta = q.double() @ x.double().T
    scale = (y.double() * eta - torch.logaddexp(torch.zeros_like(eta), eta)
             ).abs().sum(1)
    resid = (y.double() - torch.sigmoid(eta)).abs()
    gscale = resid @ x.double().abs() + INV_VAR * q.double().abs()
    assert ((lp.double() - lp_ref).abs()[ok] / scale[ok]).max() < 1e-5
    assert bool(((g.double() - g_ref).abs()[ok]
                 <= 1e-5 * gscale[ok]).all())


@pytest.mark.cuda
def test_cuda_packed_forward_is_told_apart_from_the_float32_one():
    """On values whose bfloat16 lo halves are 0.45 ulp of their hi halves,
    all positive (y = 0, so logp is about -sum eta), the lo.lo terms that
    the packed forward drops add up to about 1e-5 of logp: K2 sits within
    1e-6 of its plain version, K1's float32 forward ten times farther."""
    _needs_card()
    from inplacedhmc_tpu_torch.ops.logistic import (
        logistic_value_and_grad_packed, logistic_value_and_grad_packed_plain,
        split_bf16)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def loaded(shape):
        hi = (0.5 + 0.0625 * torch.rand(shape, generator=gen,
                                        device="cuda")).to(torch.bfloat16)
        return hi.float() + 0.45 * 2.0 ** -8

    q, x = loaded((70, 16)), loaded((8, 16))
    y = torch.zeros(8, device="cuda")
    w = torch.ones_like(y)
    x_hi, x_lo = split_bf16(x)
    lp2, _ = logistic_value_and_grad_packed(q, x_hi, x_lo, x, y, w, INV_VAR)
    lp1, _ = logistic_value_and_grad(q, x, y, w, INV_VAR)
    ref, _ = logistic_value_and_grad_packed_plain(
        q.double(), x_hi, x_lo, x.double(), y.double(), w.double(), INV_VAR)
    err2 = ((lp2.double() - ref).abs() / ref.abs()).max()
    err1 = ((lp1.double() - ref).abs() / ref.abs()).max()
    assert err2 < 1e-6 and err2 < err1 / 10


@pytest.mark.cuda
def test_cuda_packed_wrapper_refuses_what_the_kernel_does_not_take():
    _needs_card()
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_PACKED, logistic_value_and_grad_packed)
    q, x_hi, x_lo, x, y, w = _packed_inputs(7, 8, 64, 7)
    before = LOGISTIC_PACKED.launches
    for args in ((q.double(), x_hi, x_lo, x), (q, x_hi.float(), x_lo, x),
                 (q, x_hi, x_lo.cpu(), x), (q, x_hi, x_lo, x.double()),
                 (q.t().contiguous().t(), x_hi, x_lo, x)):
        with pytest.raises(ValueError):
            logistic_value_and_grad_packed(*args, y, w, INV_VAR)
    wide = _packed_inputs(7, 8, 64, 65)
    with pytest.raises(ValueError):
        logistic_value_and_grad_packed(*wide, INV_VAR)
    assert LOGISTIC_PACKED.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", [(33, 300, 7), (70, 1000, 100),
                                   (40, 129, 256)])
def test_cuda_grad_bf16_matches_plain_version(c, n, d):
    """K1 with ``grad_bf16`` against its plain version with it in float64
    (the residual and x rounded to bfloat16 from float32, as the kernel
    rounds them): logp as without the option, the gradient to 1e-4 of
    max|grad|; the option moves the gradient by more than that, and it is
    counted apart."""
    _needs_card()
    x, y, q = _data(8, c, n, d)
    w = torch.ones(n, device="cuda")
    before = (LOGISTIC_VG.launches, LOGISTIC_VG.bf16_launches)
    lp, g = logistic_value_and_grad(q, x, y, w, INV_VAR, grad_bf16=True)
    torch.cuda.synchronize()
    assert (LOGISTIC_VG.launches, LOGISTIC_VG.bf16_launches) \
        == (before[0] + 1, before[1] + 1)
    lp_ref, g_ref = logistic_value_and_grad_plain(
        q.double(), x.double(), y.double(), w.double(), INV_VAR,
        grad_bf16=True)
    lp32, g32 = logistic_value_and_grad(q, x, y, w, INV_VAR)
    ok = torch.isfinite(lp_ref)
    assert torch.equal(lp, lp32)
    assert bool((g[~ok] == 0).all())
    top = g_ref[ok].abs().max()
    assert ((g.double() - g_ref).abs()[ok].max() / top) < 1e-4
    assert ((g32.double() - g_ref).abs()[ok].max() / top) > 1e-4


#: the ragged shapes of the redesigned body (64-chain blocks of 4 warps,
#: 32-observation tiles, 8-dimension k-steps up to 64, chunks of 64 above):
#: every D at two (C, N), and every (C, N) at D = 17 and 300
RAGGED_DIMS = (1, 8, 17, 50, 64, 65, 128, 256, 257, 300, 512)
RAGGED_CN = [(c, n) for c in (1, 31, 33, 1000) for n in (1, 63, 65, 10000)]
RAGGED = sorted({(c, n, d) for d in RAGGED_DIMS
                 for c, n in ((33, 65), (1000, 10000))}
                | {(c, n, d) for d in (17, 300) for c, n in RAGGED_CN})


def _ragged(seed, c, n, d):
    """Inputs at c x n x d (``_data``'s scales), one NaN chain where
    c > 1 (chain c // 2) and, at c = 1, a second batch of one NaN chain."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) * 0.5 / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ beta))).astype(np.float32)
    q = (beta + 0.3 * rng.normal(size=(c, d)) / np.sqrt(d)).astype(np.float32)
    if c > 1:
        q[c // 2, min(2, d - 1)] = np.nan
    return (torch.as_tensor(a, device="cuda") for a in (x, y, q))


def _bf16_flips(q64, x64, y64, w64, eta):
    """What ``grad_bf16``'s gradient may differ by where a residual rounds
    to bfloat16 apart on the two sides: the kernel rounds its float32-grade
    residual, the reference its float64 one, so a residual within their
    difference (bounded by 1e-5 of sum_d |q x|, far above the products'
    error) of a rounding boundary between two bfloat16 neighbours may land
    one bfloat16 ulp apart.  Returns [C, D]: the sum over those
    observations of that ulp times |x| rounded to bfloat16."""
    r = (y64 - torch.sigmoid(eta)) * w64
    mag = r.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    frac = (mag / ulp) % 1.0
    near = (frac - 0.5).abs() * ulp <= 1e-5 * (q64.abs() @ x64.abs().T)
    xb = x64.float().to(torch.bfloat16).double().abs()
    return (near * ulp) @ xb


def _ragged_check(form, c, n, d):
    """One form of the body against its float64 plain version: logp to
    ``chip_smoke.py``'s LOGP_TOL (1e-5) of sum|terms|, the gradient to its
    GRAD_TOL (1e-4) of max|grad| (K2: each component to 1e-5 of
    sum_n |resid x|, as ``test_cuda_packed_matches_plain_version``;
    ``grad_bf16``: beside GRAD_TOL, each component by what its residuals'
    bf16 rounding may move it, ``_bf16_flips``, which at N = 10⁴ is below
    GRAD_TOL's room and at N = 65 is not), the guard on the NaN chain; and
    the guard alone on a lone NaN chain."""
    from inplacedhmc_tpu_torch.sample import f32_matmuls
    x, y, q = _ragged(c * 7 + n + d, c, n, d)
    w = torch.ones(n, device="cuda")
    q64, x64, y64, w64 = (t.double() for t in (q, x, y, w))

    def run(qq):
        if form == "packed":
            x_hi, x_lo = L.split_bf16(x)
            got = L.logistic_value_and_grad_packed(qq, x_hi, x_lo, x, y, w,
                                                   INV_VAR)
            with f32_matmuls():
                ref = L.logistic_value_and_grad_packed_plain(
                    qq.double(), x_hi, x_lo, x64, y64, w64, INV_VAR)
            return got, ref
        bf16 = form == "grad_bf16"
        return (logistic_value_and_grad(qq, x, y, w, INV_VAR, grad_bf16=bf16),
                logistic_value_and_grad_plain(qq.double(), x64, y64, w64,
                                              INV_VAR, grad_bf16=bf16))

    (lp, g), (lp_ref, g_ref) = run(q)
    torch.cuda.synchronize()
    ok = torch.isfinite(lp_ref)
    assert torch.equal(torch.isfinite(lp), ok)
    assert bool((lp[~ok] == -torch.inf).all() and (g[~ok] == 0).all())
    assert int((~ok).sum()) == (1 if c > 1 else 0)
    eta = q64 @ x64.T
    scale = (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta)
             ).abs().sum(1) + 0.5 * INV_VAR * (q64 * q64).sum(1)
    assert ((lp.double() - lp_ref).abs()[ok] / scale[ok]).max() < 1e-5
    if form == "packed":
        gscale = (y64 - torch.sigmoid(eta)).abs() @ x64.abs() \
            + INV_VAR * q64.abs()
        assert bool(((g.double() - g_ref).abs()[ok]
                     <= 1e-5 * gscale[ok]).all())
    elif form == "grad_bf16":
        room = 1e-4 * g_ref[ok].abs().max() \
            + _bf16_flips(q64, x64, y64, w64, eta)[ok]
        assert bool(((g.double() - g_ref).abs()[ok] <= room).all())
    else:
        assert ((g.double() - g_ref).abs()[ok].max()
                / g_ref[ok].abs().max()) < 1e-4
    if c == 1:
        nan_q = q.clone()
        nan_q[0, 0] = float("nan")
        (lp, g), _ = run(nan_q)
        assert lp[0] == -torch.inf and bool((g == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", RAGGED)
def test_cuda_k1_ragged_matches_plain_version(c, n, d):
    """K1 (3xTF32 both products) at the ragged shapes, any D."""
    _needs_card()
    before = LOGISTIC_VG.launches
    _ragged_check("f32", c, n, d)
    assert LOGISTIC_VG.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", RAGGED)
def test_cuda_grad_bf16_ragged_matches_plain_version(c, n, d):
    """K1 with ``grad_bf16`` (the backward one bf16 pass) at the ragged
    shapes: its logp is K1's without the option, to the bit."""
    _needs_card()
    before = LOGISTIC_VG.bf16_launches
    _ragged_check("grad_bf16", c, n, d)
    assert LOGISTIC_VG.bf16_launches > before
    x, y, q = _ragged(c * 7 + n + d, c, n, d)
    w = torch.ones(n, device="cuda")
    assert torch.equal(
        logistic_value_and_grad(q, x, y, w, INV_VAR, grad_bf16=True)[0],
        logistic_value_and_grad(q, x, y, w, INV_VAR)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,d", [s for s in RAGGED if s[2] <= 64])
def test_cuda_k2_ragged_matches_plain_version(c, n, d):
    """K2 (the packed forward, D <= 64) at the ragged shapes."""
    _needs_card()
    before = L.LOGISTIC_PACKED.launches
    _ragged_check("packed", c, n, d)
    assert L.LOGISTIC_PACKED.launches > before


@pytest.mark.cuda
def test_cuda_k1_fills_the_card():
    """At config 3 (8,192 chains x 10,000 x 50) the launch keeps more than
    8 warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
    spreads over at least a wave of the card's SMs; the body spills
    nothing at D <= 64."""
    _needs_card()
    for form in ("f32", "grad_bf16", "packed"):
        occ = L.occupancy(form, 50)
        assert occ["warps_per_sm"] > 8 and occ["local_bytes"] == 0
        s = L.launch_splits(8192, 10000, occ["blocks_per_sm"], occ["sms"])
        assert 128 * s >= occ["sms"]


@pytest.mark.cuda
def test_cuda_logistic_sample_at_d300_goes_through_k1():
    """``sample()`` on a 300-D logistic regression (4,000 observations, 64
    chains, a short dense warmup) runs on the card through the lockstep
    tree and K1, which refused D > 256 before: K1 at every density,
    finite draws, acceptance in the tuned band."""
    _needs_card()
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    x, y, _ = models.synthetic_data(11, 4000, 300, device="cuda")
    m = models.logistic_regression(x, y, device="cuda")
    stages = default_warmup_stages(init_steps=30, middle_steps=20,
                                   doubling_stages=2, terminating_steps=20,
                                   metric="dense")
    LOGISTIC_VG.launches = 0
    res = sample(5, m, 50, 64, warmup_stages=stages, device="cuda")
    torch.cuda.synchronize()
    assert LOGISTIC_VG.launches > 0
    assert bool(torch.isfinite(res.draws).all())
    acc = float(res.stats.acceptance_rate.mean())
    assert 0.5 < acc < 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,k", [(1, 1, 1), (37, 7, 3), (64, 1000, 7),
                                   (1000, 100, 64)])
def test_cuda_multistep_matches_plain_and_chained_k3(c, d, k):
    """K4 against its plain version and against ``k`` launches of K3 on the
    same inputs, bit for bit: the same float32 operations in the same
    order, none contracted into an FMA."""
    _needs_card()
    x = _gaussian(2, c, d)
    eps = torch.where(torch.arange(c, device="cuda") % 3 == 0, -0.21, 0.3)
    before = lf.LEAPFROG_MULTISTEP.launches
    got = lf.multi_step_leapfrog(x["q"], x["p"], eps, x["lam"], x["minv"], k)
    torch.cuda.synchronize()
    assert lf.LEAPFROG_MULTISTEP.launches == before + 1
    want = lf.multi_step_leapfrog_plain(x["q"], x["p"], eps, x["lam"],
                                        x["minv"], k)
    chain = (x["q"], x["p"])
    for _ in range(k):
        chain = lf.fused_gaussian_leapfrog(chain[0], chain[1], eps, x["lam"],
                                           x["minv"])[:2]
    for g, w, c3 in zip(got, want, chain):
        assert torch.equal(g, w)
        assert torch.equal(g, c3)


@pytest.mark.cuda
def test_cuda_multistep_wrapper_refuses_what_the_kernel_does_not_take():
    _needs_card()
    x = _gaussian(3, 8, 5)
    eps = torch.full((8,), 0.1, device="cuda")
    args = [x["q"], x["p"], eps, x["lam"], x["minv"]]
    before = lf.LEAPFROG_MULTISTEP.launches
    with pytest.raises(ValueError):
        lf.multi_step_leapfrog(*args, 0)
    for i, bad in ((0, x["q"].double()), (1, x["p"][:4]), (2, eps[:4]),
                   (3, x["lam"].cpu()), (4, x["minv"][:3])):
        with pytest.raises(ValueError):
            lf.multi_step_leapfrog(*args[:i], bad, *args[i + 1:], 2)
    assert lf.LEAPFROG_MULTISTEP.launches == before


@pytest.mark.cuda
def test_cuda_packed_sample_goes_through_k2():
    """``sample(..., fused_opts={"fwd_precision": "packed"})`` on a
    logistic regression of 2,000 x 10 at 64 chains: K2 at every density, K1
    not once, finite draws; with ``{"grad_bf16": True}`` K1 with the option
    at every density."""
    _needs_card()
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_PACKED
    x, y, _ = models.synthetic_data(6, 2000, 10, device="cuda")
    m = models.logistic_regression(x, y, device="cuda")
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=2, terminating_steps=25,
                                   metric="dense")
    for opts in ({"fwd_precision": "packed"}, {"grad_bf16": True}):
        LOGISTIC_PACKED.launches = LOGISTIC_VG.launches = 0
        LOGISTIC_VG.bf16_launches = 0
        res = sample(3, m, 100, 64, warmup_stages=stages, device="cuda",
                     fused_opts=opts)
        torch.cuda.synchronize()
        if "grad_bf16" in opts:
            assert LOGISTIC_PACKED.launches == 0
            assert LOGISTIC_VG.bf16_launches == LOGISTIC_VG.launches > 0
        else:
            assert LOGISTIC_PACKED.launches > 0 and LOGISTIC_VG.launches == 0
        assert bool(torch.isfinite(res.draws).all())
