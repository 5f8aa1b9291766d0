"""Port parity for the dense branch of the whole-tree kernel (K5 with a full
``[D, D]`` M^-1) and the dense Gaussian's physics (``mvn`` models).

Covers ``ops/tile_physics.py::dense_gaussian``, the dense branch of
``ops/tree.py`` (the plain version's products, the dense refresh
``xi @ mass_chol^T``, the factory's metric handling,
``make_dense_gaussian_tree_transition``), ``models/gaussian.py::mvn``,
``convert.mvn_model_from_numpy`` and the routes ``sample.py`` picks for
dense metrics and ``"dense_gaussian"`` models.

On the CPU the kernel's wrapper runs its plain torch version; these tests
hold it against the JAX package on the same numpy inputs: in float64
against the recursive numpy oracle and JAX's lockstep ``nuts_transition``
(integer fields equal, the acceptance to 1e-10 relative), in float32
against JAX's whole-tree kernel in interpret mode, whose dense products are
3-pass split-bf16 (``tree_pallas.py:201-211``): integer fields equal on
these seeds, the acceptance within 5e-4 (``tests/test_tree_pallas.py``'s
bound) and the proposal within 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.models import eight_schools as jeight_schools
from inplacedhmc_tpu.models import mvn as jmvn
from inplacedhmc_tpu.nuts.tree import nuts_transition as jnuts
from inplacedhmc_tpu.ops.tree_pallas import _dense_gaussian_tile_vg
from inplacedhmc_tpu.ops.tree_pallas import \
    make_dense_gaussian_tree_transition as jdense_tree
from inplacedhmc_tpu.ops.tree_pallas import \
    make_gaussian_tree_transition as jgauss_tree
from inplacedhmc_tpu.ops.tree_pallas import make_tree_transition as jtree

from _oracle import oracle_trajectory


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, conv, tp, tree, diag, NUTSKernel, TEval, tnuts, tbl
    global tdense, tdiag, default_warmup_stages, sample, diag_normal, mvn
    global dense_gaussian_model, eight_schools, NUTS
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch import NUTS, default_warmup_stages, sample
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import dense_metric as tdense
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.models import diag_normal, eight_schools, mvn
    from inplacedhmc_tpu_torch.models.gaussian import dense_gaussian_model
    from inplacedhmc_tpu_torch.nuts.tree import nuts_transition as tnuts
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
TERM_NAME = {0: "max_depth", 1: "divergence", 2: "turning"}
# float64 on both sides, the same products in another order
F64_RTOL = 1e-10
# JAX's interpret kernel takes its dense products as 3-pass split-bf16
# (about 2^-16 relative each), the port in f32: the acceptance within
# tests/test_tree_pallas.py's bound, the proposal within 1e-4 relative
ACC_ATOL = 5e-4
Q_RTOL, Q_ATOL = 1e-4, 1e-4


def _wishart_cov(rng, d, df):
    """Hoffman and Gelman's construction: a Wishart precision X X^T with
    ``df`` degrees of freedom, its inverse the covariance."""
    x = rng.standard_normal((d, df))
    return np.linalg.inv(x @ x.T)


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + 0.5 * np.eye(d)


def test_dense_gaussian_physics_matches_jax_and_autograd():
    """``dense_gaussian``'s plain value and gradient on the symmetrized
    precision of JAX's ``mvn``: in float64 against autograd of the port's
    model ``logp`` to 1e-12; in float32 against JAX's
    ``_dense_gaussian_tile_vg`` (the TPU kernel's physics, which accumulates
    its product in float32 whatever its inputs) to f32 round-off of a
    7-term product, 1e-6 relative.  The port's ``mvn`` computes the same
    precision and log density as JAX's from the same covariance."""
    rng = np.random.default_rng(0)
    cov = _wishart_cov(rng, 7, 12)
    jm = jmvn(jnp.asarray(cov))
    prec = np.array(jm.structure["precision"])
    q = rng.normal(size=(9, 7)) * 0.3
    phys = tp.bind("dense_gaussian", {"prec": torch.as_tensor(prec)})
    lp, g = phys(torch.as_tensor(q))
    p32, q32 = prec.astype(np.float32), q.astype(np.float32)
    lp32, g32 = tp.bind("dense_gaussian", {"prec": torch.as_tensor(p32)})(
        torch.as_tensor(q32))
    jlp, jg = _dense_gaussian_tile_vg(jnp.asarray(q32),
                                      {"prec": jnp.asarray(p32)})
    np.testing.assert_allclose(lp32.numpy(), np.asarray(jlp)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g32.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    tm = dense_gaussian_model("t", torch.as_tensor(prec))
    alp, ag = tbl(tm.logp)(torch.as_tensor(q))
    np.testing.assert_allclose(lp.numpy(), alp.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), ag.numpy(), rtol=1e-12,
                               atol=1e-12)
    pm = mvn(torch.as_tensor(cov), device="cpu")
    assert pm.dim == 7 and pm.structure["kind"] == "dense_gaussian"
    np.testing.assert_allclose(pm.structure["precision"].numpy(), prec,
                               rtol=1e-10)
    np.testing.assert_allclose(
        pm.logp(torch.as_tensor(q)).numpy(),
        np.asarray(jax.vmap(jm.logp)(jnp.asarray(q))), rtol=1e-10)


def _dense_inputs(seed, physics, c=16, d=6, max_depth=5):
    rng = np.random.default_rng(seed)
    if physics == "gaussian":
        prec = rng.gamma(2.0, size=d) + 0.3
    else:
        prec = np.linalg.inv(_wishart_cov(rng, d, d + 6))
        prec = 0.5 * (prec + prec.T)
    inv = _spd(rng, d)
    q0 = rng.normal(size=(c, d))
    p0 = rng.normal(size=(c, d)) @ np.linalg.cholesky(np.linalg.inv(inv)).T
    dirs = rng.integers(0, 2 ** 32, size=c, dtype=np.uint32)
    unif = rng.uniform(size=((1 << max_depth) - 1 + max_depth, c))
    return dict(prec=prec, inv=inv, q0=q0, p0=p0, dirs=dirs, unif=unif,
                max_depth=max_depth)


def _data(physics, prec):
    return {"lam": prec} if physics == "gaussian" else {"prec": prec}


def _logp_np(physics, prec):
    def f(q):
        g = -prec * q if physics == "gaussian" else -(prec @ q)
        return 0.5 * float(q @ g), g
    return f


@pytest.mark.parametrize("physics", ["gaussian", "dense_gaussian"])
@pytest.mark.parametrize("eps", [0.05, 0.35, 1.2, 4.0])
def test_dense_tree_plain_matches_oracle_and_jax_lockstep(physics, eps):
    """K5's plain version with a dense M^-1 in float64, the Gaussian and
    the dense Gaussian physics, against the recursive numpy oracle (dense
    ``inv_metric``), JAX's ``nuts_transition`` with ``dense_metric`` and
    the port's own lockstep tree, on the same q0, momentum and direction
    words: termination, depth, steps, term_left and term_right equal, the
    acceptance to 1e-10 relative.  eps 4.0 diverges on the first leaf of
    every chain, 0.05 runs deep."""
    r = _dense_inputs(3, physics)
    md, c = r["max_depth"], r["q0"].shape[0]
    t = {k: torch.as_tensor(r[k]) for k in ("prec", "inv", "q0", "p0",
                                            "unif")}
    phys = tp.bind(physics, _data(physics, t["prec"]))
    out = tree.tree_transition_plain(
        t["q0"], t["p0"], torch.full((c,), eps, dtype=torch.float64),
        torch.as_tensor(r["dirs"].astype(np.int64)), t["unif"], phys,
        t["inv"], md, -1000.0)
    accept = tree.acceptance(out.log_sum_alpha, out.steps)
    logp_np = _logp_np(physics, r["prec"])
    for i in range(c):
        want = oracle_trajectory(logp_np, r["inv"], r["q0"][i], r["p0"][i],
                                 eps, int(r["dirs"][i]), max_depth=md)
        tag = f"{physics} chain {i} eps {eps}"
        assert TERM_NAME[int(out.term[i])] == want["termination"], tag
        assert int(out.depth[i]) == want["depth"], tag
        assert int(out.steps[i]) == want["steps"], tag
        if want["termination"] != "max_depth":
            assert int(out.term_left[i]) == want["term_left"], tag
            assert int(out.term_right[i]) == want["term_right"], tag
        np.testing.assert_allclose(float(accept[i]), want["accept"],
                                   rtol=F64_RTOL, atol=1e-14, err_msg=tag)
    if physics == "gaussian":
        jpot = jbl(lambda q: -0.5 * jnp.sum(jnp.asarray(r["prec"]) * q * q))
    else:
        jpot = jbl(lambda q: -0.5 * q @ jnp.asarray(r["prec"]) @ q)
    lp, g = jpot(jnp.asarray(r["q0"]))
    _, jst = jnuts(jax.random.PRNGKey(0), jpot, jdense(jnp.asarray(r["inv"])),
                   JEval(q=jnp.asarray(r["q0"]), logp=lp, grad=g),
                   jnp.asarray(eps), max_depth=md,
                   directions=jnp.asarray(r["dirs"]),
                   momentum=jnp.asarray(r["p0"]))
    tpot = tbl(lambda q: phys(q)[0])
    tlp, tg = tpot(t["q0"])
    _, tst = tnuts(torch.Generator().manual_seed(0), tpot, tdense(t["inv"]),
                   TEval(q=t["q0"], logp=tlp, grad=tg), eps, max_depth=md,
                   directions=torch.as_tensor(r["dirs"].astype(np.int64)),
                   momentum=t["p0"])
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        for other in (np.asarray(getattr(jst, jf)),
                      getattr(tst, jf).numpy()):
            np.testing.assert_array_equal(getattr(out, f).numpy(), other,
                                          err_msg=f"{f} eps={eps}")
    for other in (np.asarray(jst.acceptance_rate),
                  tst.acceptance_rate.numpy()):
        np.testing.assert_allclose(accept.numpy(), other, rtol=F64_RTOL,
                                   atol=1e-14)
    if eps == 4.0:
        assert bool((out.term == 1).all())


def _jax_interpret(physics, r, eps, tile_model=None):
    md = r["max_depth"]
    q0 = jnp.asarray(r["q0"], jnp.float32)
    jz = JEval(q=q0, logp=jnp.zeros(q0.shape[0]), grad=jnp.zeros_like(q0))
    met = jdense(jnp.asarray(r["inv"], jnp.float32))
    kw = dict(max_depth=md, block_c=16, interpret=True)
    if physics == "gaussian":
        trans = jgauss_tree(jnp.asarray(r["prec"], jnp.float32), met, **kw)
    elif physics == "dense_gaussian":
        trans = jdense_tree(jnp.asarray(r["prec"], jnp.float32), met, **kw)
    else:
        trans = jtree(tile_model.structure["tile_logp"],
                      tile_model.structure["data"], tile_model.dim, met, **kw)
    return trans(jax.random.PRNGKey(0), jz, eps,
                 directions=jnp.asarray(r["dirs"]),
                 momentum=jnp.asarray(r["p0"], jnp.float32),
                 _unif=jnp.asarray(r["unif"], jnp.float32))


def _assert_close_to_jax(out, jz2, jst, tag):
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} {tag}")
    np.testing.assert_allclose(
        tree.acceptance(out.log_sum_alpha, out.steps).numpy(),
        np.asarray(jst.acceptance_rate), atol=ACC_ATOL, err_msg=tag)
    np.testing.assert_allclose(out.q.numpy(), np.asarray(jz2.q), rtol=Q_RTOL,
                               atol=Q_ATOL, err_msg=tag)


def _f32(r):
    return {k: torch.as_tensor(np.asarray(r[k], np.float32))
            for k in ("prec", "inv", "q0", "p0", "unif")}


@pytest.mark.parametrize("physics,seed,eps", [
    ("gaussian", 4, 0.3), ("gaussian", 5, 1.1),
    ("dense_gaussian", 6, 0.25), ("dense_gaussian", 7, 0.9)])
def test_dense_tree_plain_matches_jax_interpret_kernel(physics, seed, eps):
    """The same inputs in float32 through the port's plain K5 and JAX's
    whole-tree kernel in interpret mode (``make_gaussian_tree_transition``
    or ``make_dense_gaussian_tree_transition`` with a ``DenseMetric``,
    ``block_c`` 16, ``max_depth`` 4), with the same uniforms: integer
    fields equal, the acceptance within 5e-4, the proposal within 1e-4
    relative."""
    r = _dense_inputs(seed, physics, max_depth=4)
    jz2, jst = _jax_interpret(physics, r, eps)
    t = _f32(r)
    c = r["q0"].shape[0]
    out = tree.tree_transition(
        t["q0"], t["p0"], torch.full((c,), eps),
        torch.as_tensor(r["dirs"].astype(np.int64)), t["unif"],
        tp.bind(physics, _data(physics, t["prec"])), t["inv"],
        r["max_depth"], -1000.0)
    _assert_close_to_jax(out, jz2, jst, f"{physics} eps {eps}")
    assert int(out.steps.sum()) > c


def test_dense_gaussian_matches_jax_interpret_kernel_above_one_warp():
    """Above D = 256, where the card runs K5's wide form (its ``[D, D]``
    products staged in shared memory), the dense Gaussian's physics under a
    dense metric at D = 300: the port's plain K5 against
    ``make_dense_gaussian_tree_transition(..., DenseMetric, interpret=True,
    block_c=16, max_depth=5)`` on the same inputs, a Wishart precision at
    600 degrees of freedom and half the leapfrog's stability limit 2 /
    sqrt(lambda_max(M^-1 P)), with the bounds above."""
    rng = np.random.default_rng(9)
    c, d, md = 16, 300, 5
    prec = np.linalg.inv(_wishart_cov(rng, d, 2 * d))
    prec = 0.5 * (prec + prec.T)
    inv = _spd(rng, d)
    lam_max = float(np.linalg.eigvals(inv @ prec).real.max())
    eps = 0.5 * 2.0 / lam_max ** 0.5
    r = dict(prec=prec, inv=inv, q0=rng.normal(size=(c, d))
             @ np.linalg.cholesky(np.linalg.inv(prec)).T, max_depth=md,
             p0=rng.normal(size=(c, d))
             @ np.linalg.cholesky(np.linalg.inv(inv)).T,
             dirs=rng.integers(0, 2 ** 32, size=c, dtype=np.uint32),
             unif=rng.uniform(size=((1 << md) - 1 + md, c)))
    jz2, jst = _jax_interpret("dense_gaussian", r, eps)
    t = _f32(r)
    out = tree.tree_transition(
        t["q0"], t["p0"], torch.full((c,), eps),
        torch.as_tensor(r["dirs"].astype(np.int64)), t["unif"],
        tp.bind("dense_gaussian", _data("dense_gaussian", t["prec"])),
        t["inv"], md, -1000.0)
    _assert_close_to_jax(out, jz2, jst, f"dense_gaussian D {d} eps {eps}")
    assert int(out.steps.sum()) > 2 * c


def test_eight_schools_dense_metric_matches_jax_interpret_kernel():
    """Eight schools' physics under a dense metric: the port's plain K5
    against JAX's ``make_tree_transition(tile_logp, ..., DenseMetric,
    interpret=True)`` on the same inputs, with the bounds above."""
    rng = np.random.default_rng(8)
    c, d, md = 16, 10, 4
    q0 = rng.normal(size=(c, d))
    q0[:, 0] = 5.0 + 4.0 * rng.normal(size=c)
    inv = _spd(rng, d)
    r = dict(q0=q0, inv=inv, prec=np.zeros(1), max_depth=md,
             p0=rng.normal(size=(c, d))
             @ np.linalg.cholesky(np.linalg.inv(inv)).T,
             dirs=rng.integers(0, 2 ** 32, size=c, dtype=np.uint32),
             unif=rng.uniform(size=((1 << md) - 1 + md, c)))
    jz2, jst = _jax_interpret("eight_schools", r, 0.3, jeight_schools())
    t = _f32(r)
    st = conv.tile_model_from_numpy(
        "eight_schools", jeight_schools().structure["data"], d,
        device="cpu").structure
    out = tree.tree_transition(
        t["q0"], t["p0"], torch.full((c,), 0.3),
        torch.as_tensor(r["dirs"].astype(np.int64)), t["unif"],
        tp.bind("eight_schools", st["data"]), t["inv"], md, -1000.0)
    _assert_close_to_jax(out, jz2, jst, "eight schools, dense metric")


def _mvn_case(seed, c=12, d=6):
    rng = np.random.default_rng(seed)
    prec = np.linalg.inv(_wishart_cov(rng, d, d + 6))
    prec = (0.5 * (prec + prec.T)).astype(np.float32)
    inv = np.linalg.inv(prec.astype(np.float64)).astype(np.float32)
    met = tdense(torch.as_tensor(0.5 * (inv + inv.T)))
    q0 = torch.as_tensor(rng.normal(size=(c, d)) * 0.2, dtype=torch.float32)
    phys = tp.bind("dense_gaussian", {"prec": torch.as_tensor(prec)})
    return phys, met, q0


def test_dense_refresh_equals_explicit_momentum():
    """The plain ``refresh_inside`` path with a dense metric draws its
    momentum as ``xi @ mass_chol^T``: one transition drawing everything from
    its key equals, bit for bit, the explicit-momentum transition fed the
    same Philox ``xi @ mass_chol^T``, direction words and uniforms."""
    phys, met, q0 = _mvn_case(9)
    c, d = q0.shape
    scale = met.mass_chol.T.contiguous()
    eps = torch.full((c,), 0.4)
    key = torch.tensor([77, 5], dtype=torch.int64)
    drawn = tree.tree_transition(q0, None, eps, None, None, phys, met.inv, 6,
                                 -1000.0, key=key, sqrt_mass=scale)
    xi, dirs, unif = tree.philox_draws(key, c, d, 6)
    given = tree.tree_transition(q0, xi[0] @ scale, eps, dirs[0], unif[0],
                                 phys, met.inv, 6, -1000.0)
    for f in tree.TreeOut._fields:
        assert torch.equal(getattr(drawn, f), getattr(given, f)), f


def test_dense_sweep_bit_identical_to_sequential_transitions():
    """A plain sweep of 3 transitions under a dense metric drawing
    everything from its key equals 3 single transitions fed what the
    generator draws for that key, bit for bit."""
    phys, met, q0 = _mvn_case(10)
    c, d = q0.shape
    scale = met.mass_chol.T.contiguous()
    eps = torch.full((c,), 0.5)
    key = torch.tensor([123, 456], dtype=torch.int64)
    swept = tree.tree_sweep(q0, eps, phys, met.inv, 6, -1000.0, 3, key=key,
                            sqrt_mass=scale)
    xi, dirs, unif = tree.philox_draws(key, c, d, 6, 3)
    q = q0
    for s in range(3):
        one = tree.tree_transition(q, tree.refresh_momentum(scale, xi[s]),
                                   eps, dirs[s], unif[s], phys, met.inv, 6,
                                   -1000.0)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)), f
        q = one.q
    assert torch.equal(swept.grad, one.grad)


def _count_plain(monkeypatch):
    """Record ``(physics, metric form)`` of every plain whole-tree
    transition (the CPU's K5)."""
    calls = []
    plain = tree.tree_transition_plain

    def spy(q0, p0, eps, dirs, unif, phys, minv, *a, **kw):
        calls.append((phys.name, "dense" if minv.ndim == 2 else "diag"))
        return plain(q0, p0, eps, dirs, unif, phys, minv, *a, **kw)

    monkeypatch.setattr(tree, "tree_transition_plain", spy)
    return calls


def _moments_ok(draws, sigma):
    x = draws.double()
    var = torch.diag(sigma)
    ess = diag.ess_bulk(x, cap=False)
    ess_sq = diag.ess_bulk(x * x, cap=False)
    mean = x.mean(dim=(0, 1))
    mean_z = (mean.abs() / torch.sqrt(var / ess)).max()
    var_z = ((x.var(dim=(0, 1)) - var).abs()
             / (var * torch.sqrt(2.0 / ess_sq))).max()
    assert float(mean_z) < 5 and float(var_z) < 5, (mean_z, var_z)
    assert float(diag.split_rhat(x).max()) < 1.05


STAGES = dict(init_steps=30, middle_steps=20, doubling_stages=3,
              terminating_steps=20, metric="dense")


def test_sample_mvn_through_the_dense_route(monkeypatch):
    """``sample()`` on a 6-D ``mvn`` (a Wishart precision, 16 chains, dense
    windows, 150 draws): its tuning and sampling run K5's plain version with
    the ``dense_gaussian`` physics, under the identity diagonal metric until
    the first dense window closes and under the dense metric after; every
    coordinate's mean and variance within 5 Monte Carlo standard errors of
    the truth, split R-hat < 1.05, acceptance near the target."""
    rng = np.random.default_rng(11)
    m = mvn(_wishart_cov(rng, 6, 12), device="cpu")
    calls = _count_plain(monkeypatch)
    res = sample(2, m, 150, 16, warmup_stages=default_warmup_stages(**STAGES),
                 device="cpu")
    n_diag = 30 + 20    # the windows before the first estimate closes
    n_dense = 40 + 80 + 20 + 150
    assert calls.count(("dense_gaussian", "diag")) == n_diag
    assert calls.count(("dense_gaussian", "dense")) == n_dense
    assert len(calls) == n_diag + n_dense
    assert res.draws.shape == (150, 16, 6)
    _moments_ok(res.draws, torch.linalg.inv(
        m.structure["precision"].double()))
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95


def test_diag_gaussian_dense_windows_reach_the_dense_route(monkeypatch):
    """A ``diag_gaussian`` model with dense windows runs K5 with the
    Gaussian physics and a dense metric once its first dense window has
    closed (JAX's tree factory takes a shared float32 dense metric), not
    autograd on the lockstep tree; its moments within Monte Carlo error."""
    var = np.array([4.0, 1.0, 0.25, 2.0, 0.5], np.float32)
    calls = _count_plain(monkeypatch)
    res = sample(3, diag_normal(var, device="cpu"), 150, 16,
                 warmup_stages=default_warmup_stages(
                     init_steps=20, middle_steps=15, doubling_stages=3,
                     terminating_steps=15, metric="dense"), device="cpu")
    assert calls.count(("gaussian", "dense")) == 30 + 60 + 15 + 150
    assert calls.count(("gaussian", "diag")) == 20 + 15
    _moments_ok(res.draws,
                torch.diag(torch.as_tensor(var, dtype=torch.float64)))


def test_tree_opts_accepted_on_mvn(monkeypatch):
    """The flagship ``tree_opts`` on an ``mvn``: accepted, the sampling loop
    runs the swept padded state under the dense metric (``n_sweep`` 4, 8
    chains padded to 16 rows), finite draws of the recorded shape."""
    rng = np.random.default_rng(12)
    m = mvn(_wishart_cov(rng, 5, 10), device="cpu")
    calls = _count_plain(monkeypatch)
    res = sample(4, m, 32, 8, device="cpu",
                 warmup_stages=default_warmup_stages(
                     init_steps=20, middle_steps=15, doubling_stages=2,
                     terminating_steps=15, metric="dense"),
                 tree_opts={"refresh_inside": True, "padded_io": True,
                            "n_sweep": 4, "block_c": 16})
    assert res.draws.shape == (32, 8, 5)
    assert bool(torch.isfinite(res.draws).all())
    assert calls.count(("dense_gaussian", "dense")) == 30 + 15 + 32


def test_mvn_above_the_tree_bound_takes_the_lockstep_tree():
    """An ``mvn`` of D = 2,049 is above K5's D bound (``ops.tree.takes``),
    and one of D = 1,000 at max_depth 29 past its shared-memory bound: their
    route is autograd on the lockstep tree under either metric form, and no
    fused leapfrog; at D = 2,048, and at D = 1,000 with max_depth 28, they
    take the whole tree (one block of warps per chain)."""
    for d, md, tree_route in ((2049, 10, False), (2048, 10, True),
                              (1000, 29, False), (1000, 28, True)):
        kern = NUTSKernel(mvn(torch.eye(d), device="cpu"),
                          NUTS(max_depth=md))
        for met in (tdiag(torch.ones(d)), tdense(torch.eye(d))):
            assert (kern.transition_factory(met, 16) is not None) \
                == tree_route
        assert kern.step_factory is None


def test_mvn_model_from_numpy_carries_jax_precision():
    """``mvn_model_from_numpy`` keeps the symmetrized precision of JAX's
    ``mvn`` bit for bit as float32, and its log density is JAX's on that
    precision; the converted model takes the dense route."""
    rng = np.random.default_rng(13)
    jm = jmvn(jnp.asarray(_wishart_cov(rng, 5, 9)))
    prec = np.array(jm.structure["precision"])
    cm = conv.mvn_model_from_numpy(prec, device="cpu")
    assert cm.structure["kind"] == "dense_gaussian" and cm.dim == 5
    assert cm.structure["precision"].dtype == torch.float32
    np.testing.assert_array_equal(cm.structure["precision"].numpy(),
                                  prec.astype(np.float32))
    q = rng.normal(size=(4, 5))
    p32 = jnp.asarray(prec.astype(np.float32), jnp.float64)
    np.testing.assert_allclose(
        cm.logp(torch.as_tensor(q)).numpy(),
        np.asarray(jax.vmap(lambda x: -0.5 * x @ p32 @ x)(jnp.asarray(q))),
        rtol=1e-12)
    assert NUTSKernel(cm).transition_factory(
        tdense(torch.eye(5)), 4) is not None


def test_dense_factory_takes_each_metric_form():
    """``make_dense_gaussian_tree_transition`` takes a ``DenseMetric`` or a
    ``[D, D]`` M^-1 (and the diagonal forms) and refuses a metric of the
    wrong shape.  Through the factory a dense M^-1 and the ``DenseMetric``
    made from it give the same transition."""
    phys, met, q0 = _mvn_case(14, c=8, d=5)
    prec = phys.data["prec"]
    z = TEval(q=q0, logp=torch.zeros(8), grad=torch.zeros_like(q0))
    outs = []
    for m in (met, met.inv):
        trans = tree.make_dense_gaussian_tree_transition(prec, m, max_depth=5)
        outs.append(trans(torch.Generator().manual_seed(0), z, 0.4))
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][0].q, outs[1][0].q)
    with pytest.raises(ValueError):
        tree.make_dense_gaussian_tree_transition(prec, torch.eye(4))
