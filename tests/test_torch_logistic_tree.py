"""Port parity for the whole-tree kernel with logistic regression's physics
(K5-logistic: ``csrc/tree_logistic.cu``, its plain version
``ops/tile_physics.py::logistic``) and the route that reaches it,
``use_pallas="tree"``.

On the CPU the kernel's wrapper runs its plain torch version; these tests
hold it against the JAX package on the same numpy inputs, at the size of
JAX's own tests (``tests/test_tree_pallas.py:196-266``: a few hundred
observations, 5-7 features, 16 chains, ``max_depth`` 5):

* the physics against the tile functions that JAX's
  ``make_logistic_tree_transition`` builds (its chunked ``tile_vg`` and the
  ``vjp`` form's ``tile_logp`` through ``jax.vjp``), with and without
  ``grad_bf16``, in float32, and against torch autograd of the model's
  ``logp`` in float64;
* one transition of the plain tree against JAX's kernel in interpret mode,
  under a diagonal and a dense metric, at two step sizes, with the same
  momentum, direction words and uniforms;
* a sweep against single transitions, the routes of ``use_pallas`` and the
  checks of the logistic ``tree_opts``, and ``sample()`` through the route.

Tolerances.  Both sides run the same float32 operations on each
observation; their sums (``eta``, the log density, the gradient) add the
same terms in another order.  Over N = 250 terms of magnitude up to a few
units that is about 1e-6 of the sum of the terms' magnitudes, so the
physics is held to 2e-6 of that sum (log density) and of the largest
gradient component's terms' sum, and a transition's float fields to 1e-5
relative to ``1 + |x|`` (a trajectory of up to 32 leaves carries the
difference).  The acceptance sums ``exp(min(delta, 0))``, each delta a
difference of log densities near -120 whose float32 ulp is 7.6e-6: it is
held to 1e-4, about a dozen such ulps.  Under a dense metric JAX's kernel
takes its ``M^-1 p`` products as 3-pass split-bf16 (``tree_pallas.py:
201-211``, about 1e-5 relative), the port in float32: there the float
fields are held to 1e-4 relative and the acceptance to 5e-4, the bounds of
``tests/test_torch_dense.py``.  Under ``grad_bf16`` each residual is
rounded to bfloat16: two positions that differ by such a difference can
round one residual to the two sides of a bfloat16 tie, which moves a
gradient component by up to 2^-8 |x| (the residual is at most 1), so the
gradient is held to that much more.  Integer fields are equal on these
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.metric import diag_metric as jdiag
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.ops import tree_pallas as jtp


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, S, tp, tree, diag, NUTSKernel, tbl, tdense, tdiag, TEval
    global default_warmup_stages, sample, logistic_regression, std_normal
    global Model, conv
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    import importlib
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import dense_metric as tdense
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              std_normal)
    from inplacedhmc_tpu_torch.models.base import Model
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    # the module: the package's ``sample`` is the function of that name
    S = importlib.import_module("inplacedhmc_tpu_torch.sample")
    torch.set_num_threads(1)


INV_VAR = 0.01
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
JAX_INT = ("termination", "depth", "steps", "term_left", "term_right")
PHYS_RTOL = 2e-6   # of the sum of the terms' magnitudes
TREE_RTOL = {"diag": 1e-5, "dense": 1e-4}   # relative to 1 + |x|
ACC_ATOL = {"diag": 1e-4, "dense": 5e-4}
F64_RTOL = 1e-10


def _problem(seed, n=250, d=6):
    """Data of a well-specified logistic regression (numpy, float32) and
    the Laplace approximation's covariance at the true coefficients, the
    metric the transitions run under."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x = (x + 0.3 * x @ rng.normal(size=(d, d)) / np.sqrt(d)).astype(
        np.float32)
    beta = rng.normal(size=d) * 0.5
    s = 1.0 / (1.0 + np.exp(-x @ beta))
    y = (rng.uniform(size=n) < s).astype(np.float32)
    h = (x.T * (s * (1 - s))) @ x + INV_VAR * np.eye(d)
    cov = np.linalg.inv(h)
    return x, y, beta, 0.5 * (cov + cov.T), rng


def _jax_build(x, y, metric, monkeypatch, **kw):
    """JAX's ``make_logistic_tree_transition`` in interpret mode, and what
    it hands ``make_tree_transition``: the tile functions and their
    data."""
    seen = {}
    real = jtp.make_tree_transition

    def spy(tile_logp, data, dim, metric_inv, **kws):
        seen.update(tile_logp=tile_logp, data=data,
                    tile_vg=kws.get("tile_value_grad"))
        return real(tile_logp, data, dim, metric_inv, **kws)

    monkeypatch.setattr(jtp, "make_tree_transition", spy)
    trans = jtp.make_logistic_tree_transition(
        jnp.asarray(x), jnp.asarray(y), INV_VAR, metric, interpret=True,
        **kw)
    return trans, seen


def _jax_physics(seen, q):
    """JAX's tile physics on ``q [C, D]`` (padded to its 128 lanes) and its
    data padded as ``make_tree_transition`` pads them for the kernel (1-D
    rows as ``[1, n]``, then zeros up to (8, 128) tiles): the chunked
    ``tile_vg``, or the ``vjp`` form's ``tile_logp`` through ``jax.vjp``
    (as the kernel differentiates it)."""
    c, d = q.shape
    qp = jnp.zeros((c, 128), jnp.float32).at[:, :d].set(q)
    refs = {}
    for name, arr in seen["data"].items():
        arr = jnp.asarray(arr, jnp.float32)
        arr = arr[None, :] if arr.ndim == 1 else arr
        r, cols = -(-arr.shape[0] // 8) * 8, -(-arr.shape[1] // 128) * 128
        refs[name] = jnp.zeros((r, cols), jnp.float32).at[
            :arr.shape[0], :arr.shape[1]].set(arr)
    if seen["tile_vg"] is not None:
        lp, g = seen["tile_vg"](qp, refs)
    else:
        lp, vjp = jax.vjp(lambda v: seen["tile_logp"](v, refs), qp)
        g, = vjp(jnp.ones_like(lp))
    return np.asarray(lp)[:, 0], np.asarray(g)[:, :d]


def _terms_scale(x, y, q):
    """Per chain, the sum of the magnitudes of the log density's terms,
    and of each gradient component's (float64)."""
    eta = q.astype(np.float64) @ x.T.astype(np.float64)
    ll = y * eta - np.logaddexp(0.0, eta)
    lp = np.abs(ll).sum(1) + 0.5 * INV_VAR * (q * q).sum(1)
    r = np.abs(y - 1.0 / (1.0 + np.exp(-eta)))
    return lp, r @ np.abs(x) + INV_VAR * np.abs(q)


@pytest.mark.parametrize("mode,grad_bf16,block_n", [
    ("chunked", False, 128), ("chunked", True, 128), ("chunked", False, 2048),
    ("vjp", False, 2048), ("vjp", True, 2048)])
def test_logistic_physics_matches_jax_tiles_and_autograd(
        monkeypatch, mode, grad_bf16, block_n):
    """The plain ``logistic`` physics on the data ``logistic_data`` pads
    (N = 250: 6 or 1,798 zero rows) against the tile physics JAX's builder
    makes for the same mode, ``grad_bf16`` and ``block_n``, in float32:
    the log density within 2e-6 of the sum of its terms' magnitudes, each
    gradient component within 2e-6 of its terms'.  With ``grad_bf16`` under
    ``"chunked"`` both round the residual and x to bfloat16 before the
    backward product; under ``"vjp"`` neither reads it (JAX differentiates
    its float32 ``tile_logp``), so the f32 bound holds.  Without rounding,
    in float64, against torch autograd of the port's model ``logp`` to
    1e-10 relative."""
    x, y, beta, cov, rng = _problem(1)
    c, d = 16, x.shape[1]
    q = (beta + rng.normal(size=(c, d)) @ np.linalg.cholesky(cov).T * 2.0
         ).astype(np.float32)
    _, seen = _jax_build(x, y, jdiag(jnp.ones(d, jnp.float32)), monkeypatch,
                         physics_mode=mode, grad_bf16=grad_bf16,
                         block_n=block_n, max_depth=3, block_c=16)
    jlp, jg = _jax_physics(seen, jnp.asarray(q))
    data = tp.logistic_data(torch.as_tensor(x), torch.as_tensor(y), INV_VAR,
                            physics_mode=mode, grad_bf16=grad_bf16,
                            block_n=block_n)
    assert data["x"].shape == (-(-250 // block_n) * block_n, d)
    assert float(data["w"].sum()) == 250.0
    lp, g = tp.bind("logistic", data)(torch.as_tensor(q))
    lp_scale, g_scale = _terms_scale(x, y, q)
    assert (np.abs(lp.numpy() - jlp) <= PHYS_RTOL * lp_scale).all()
    tol = PHYS_RTOL * g_scale
    rounds = grad_bf16 and mode == "chunked"
    assert data["grad_bf16"] == (1.0 if rounds else 0.0)
    if rounds:   # the residual's bfloat16 rounding can differ at a tie
        tol = tol + 2.0 ** -8 * np.abs(x).max()
    assert (np.abs(g.numpy() - jg) <= tol).all()
    if rounds:
        plain = tp.bind("logistic", {**data, "grad_bf16": 0.0})
        assert not torch.equal(plain(torch.as_tensor(q))[1], g)
        return
    q64 = torch.as_tensor(q, dtype=torch.float64)
    lp64, g64 = tp.bind("logistic", data, dtype=torch.float64)(q64)
    model = logistic_regression(x.astype(np.float64), y.astype(np.float64),
                                prior_scale=INV_VAR ** -0.5, device="cpu")
    alp, ag = tbl(model.logp)(q64)
    np.testing.assert_allclose(lp64.numpy(), alp.numpy(), rtol=F64_RTOL)
    np.testing.assert_allclose(g64.numpy(), ag.numpy(), rtol=F64_RTOL,
                               atol=F64_RTOL * float(ag.abs().max()))


def test_padded_observations_contribute_nothing():
    """Observations with weight 0 add exactly zero terms: the plain physics
    on data padded to 256 and to 2,048 rows gives, in float64, the value
    and gradient of the unpadded data to 1e-13 relative (the products only
    add their terms in another blocking), and a non-finite position gives a
    non-finite density (the leaf's sanitisation turns it into a
    divergence)."""
    x, y, beta, _, rng = _problem(2, n=200, d=5)
    q = torch.as_tensor(beta + 0.1 * rng.normal(size=(4, 5)))
    outs = [tp.bind("logistic", tp.logistic_data(
        torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y), INV_VAR,
        block_n=bn), dtype=torch.float64)(q) for bn in (200, 256, 2048)]
    for lp, g in outs[1:]:
        np.testing.assert_allclose(lp.numpy(), outs[0][0].numpy(),
                                   rtol=1e-13)
        np.testing.assert_allclose(g.numpy(), outs[0][1].numpy(), rtol=1e-13,
                                   atol=1e-13 * float(g.abs().max()))
    q[1, 2] = float("inf")
    lp, _ = tp.bind("logistic", tp.logistic_data(
        torch.as_tensor(x), torch.as_tensor(y), INV_VAR))(q.float())
    assert not bool(torch.isfinite(lp[1])) and bool(torch.isfinite(lp[0]))


def _transition_inputs(cov, rng, beta, c=16, md=5):
    d = cov.shape[0]
    chol = np.linalg.cholesky(cov)
    return dict(
        q0=(beta + rng.normal(size=(c, d)) @ chol.T).astype(np.float32),
        xi=rng.normal(size=(c, d)),
        dirs=rng.integers(0, 2 ** 32, size=c, dtype=np.uint32),
        unif=rng.uniform(size=((1 << md) - 1 + md, c)).astype(np.float32),
        md=md)


@pytest.mark.parametrize("metric,grad_bf16", [
    ("diag", False), ("dense", False), ("dense", True), ("diag", True)])
def test_tree_plain_matches_jax_interpret_kernel(monkeypatch, metric,
                                                 grad_bf16):
    """One transition of the port's plain tree with the ``logistic`` physics
    against JAX's ``make_logistic_tree_transition(..., interpret=True)``
    (chunked physics, ``block_n`` 128 over N = 250, ``max_depth`` 5, 16
    chains) under the Laplace covariance as a dense M^-1 or its diagonal,
    at eps 0.35 and 1.1 (the second takes some chains to their step
    size's limit), with the same momentum, direction words and uniforms,
    with and without ``grad_bf16``: the integer fields equal; q, logp,
    grad and energy within ``TREE_RTOL`` relative to 1 + |x| (the gradient
    under ``grad_bf16`` within 2^-8 max |x| more), the acceptance within
    ``ACC_ATOL`` (the module docstring's bounds)."""
    x, y, beta, cov, rng = _problem(3)
    d = x.shape[1]
    minv = (cov if metric == "dense" else np.diag(np.diag(cov))).astype(
        np.float32)
    jmet = jdense(jnp.asarray(minv)) if metric == "dense" \
        else jdiag(jnp.asarray(np.diag(minv)))
    trans, _ = _jax_build(x, y, jmet, monkeypatch, max_depth=5, block_c=16,
                          block_n=128, grad_bf16=grad_bf16)
    r = _transition_inputs(cov, rng, beta)
    p0 = (r["xi"] @ np.linalg.cholesky(np.linalg.inv(minv)).T).astype(
        np.float32)
    c = p0.shape[0]
    phys = tp.bind("logistic", tp.logistic_data(
        torch.as_tensor(x), torch.as_tensor(y), INV_VAR, grad_bf16=grad_bf16,
        block_n=128))
    tminv = torch.as_tensor(minv if metric == "dense"
                            else np.diag(minv).copy())
    depths = []
    for eps in (0.35, 1.1):
        jz = JEval(q=jnp.asarray(r["q0"]), logp=jnp.zeros(c),
                   grad=jnp.zeros_like(jnp.asarray(r["q0"])))
        jz2, jst = trans(jax.random.PRNGKey(0), jz, eps,
                         directions=jnp.asarray(r["dirs"]),
                         momentum=jnp.asarray(p0),
                         _unif=jnp.asarray(r["unif"]))
        out = tree.tree_transition(
            torch.as_tensor(r["q0"]), torch.as_tensor(p0),
            torch.full((c,), eps), torch.as_tensor(r["dirs"].astype(np.int64)),
            torch.as_tensor(r["unif"]), phys, tminv, r["md"], -1000.0)
        tag = f"{metric} metric, eps {eps}, grad_bf16 {grad_bf16}"
        for f, jf in zip(PLAIN_INT, JAX_INT):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(jst, jf)),
                                          err_msg=f"{f}, {tag}")
        for f, got, want in (("q", out.q, jz2.q), ("logp", out.logp, jz2.logp),
                             ("grad", out.grad, jz2.grad),
                             ("energy", out.energy, jst.energy)):
            want = np.asarray(want)
            tol = TREE_RTOL[metric] * (1 + np.abs(want))
            if f == "grad" and grad_bf16:
                tol = tol + 2.0 ** -8 * np.abs(x).max()
            assert (np.abs(got.numpy() - want) <= tol).all(), f"{f}, {tag}"
        np.testing.assert_allclose(
            tree.acceptance(out.log_sum_alpha, out.steps).numpy(),
            np.asarray(jst.acceptance_rate), atol=ACC_ATOL[metric],
            err_msg=tag)
        depths.append(out.depth.double().mean().item())
        assert bool(torch.isfinite(out.q).all())
    assert depths[0] > 1.5 and int(out.steps.sum()) > c


def test_logistic_sweep_bit_identical_to_sequential_transitions():
    """A plain sweep of 3 logistic transitions under a dense metric drawing
    everything from its key (one row of the 12 not valid) equals 3 single
    transitions fed what the generator draws for that key, bit for bit."""
    x, y, beta, cov, rng = _problem(4, n=120, d=5)
    met = tdense(torch.as_tensor(cov, dtype=torch.float32))
    scale = met.mass_chol.T.contiguous()
    phys = tp.bind("logistic", tp.logistic_data(
        torch.as_tensor(x), torch.as_tensor(y), INV_VAR, block_n=64))
    c, d = 12, 5
    q0 = torch.as_tensor(beta + 0.1 * rng.normal(size=(c, d)),
                         dtype=torch.float32)
    eps = torch.full((c,), 0.5)
    valid = torch.ones(c, dtype=torch.int32)
    valid[7] = 0
    key = torch.tensor([31, 7], dtype=torch.int64)
    swept = tree.tree_sweep(q0, eps, phys, met.inv, 5, -1000.0, 3, key=key,
                            sqrt_mass=scale, valid=valid)
    xi, dirs, unif = tree.philox_draws(key, c, d, 5, 3)
    q = q0
    for s in range(3):
        one = tree.tree_transition(q, tree.refresh_momentum(scale, xi[s]),
                                   eps, dirs[s], unif[s], phys, met.inv, 5,
                                   -1000.0, valid=valid)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)), f
        q = one.q
    assert torch.equal(swept.grad, one.grad)
    assert int(swept.steps[:, 7].sum()) == 0 and int(swept.steps.sum()) > 0


def _small_logistic(n=200, d=4):
    x, y, _, _, _ = _problem(5, n=n, d=d)
    return logistic_regression(x, y, device="cpu")


def _record_routes(monkeypatch):
    """Record the physics of every whole-tree transition the factories
    build, and every fused logistic potential."""
    seen = {"tree": [], "k1": 0}
    build, k1 = S.make_tree_transition, S.make_logistic_potential

    def spy_tree(physics, *a, **kw):
        seen["tree"].append(physics)
        return build(physics, *a, **kw)

    def spy_k1(*a, **kw):
        seen["k1"] += 1
        return k1(*a, **kw)

    monkeypatch.setattr(S, "make_tree_transition", spy_tree)
    monkeypatch.setattr(S, "make_logistic_potential", spy_k1)
    return seen


def test_use_pallas_routes(monkeypatch):
    """``use_pallas`` as in JAX: ``"tree"`` sends logistic regression to the
    whole tree with its physics from one chain, under a diagonal and a
    dense float32 metric (not a float64 one), with autograd as the warmup's
    potential; ``"auto"`` (the default) and ``"on"`` keep it on the
    lockstep tree with the fused potential; ``"off"`` runs autograd alone.
    For a ``diag_gaussian`` model ``"on"`` gives the fused leapfrog and no
    whole tree, ``"tree"`` the whole tree from one chain and no fused
    leapfrog."""
    seen = _record_routes(monkeypatch)
    m = _small_logistic()
    f32 = (tdiag(torch.ones(4)), tdense(torch.eye(4)))
    kern = NUTSKernel(m, use_pallas="tree")
    assert seen["k1"] == 0 and kern.step_factory is None
    for met in f32:
        assert kern.transition_factory(met, 1) is not None
    assert seen["tree"] == ["logistic", "logistic"]
    assert kern.transition_factory(
        tdiag(torch.ones(4, dtype=torch.float64)), 64) is None
    for up in ("auto", "on"):
        k = NUTSKernel(m, use_pallas=up)
        assert k.transition_factory is None and k.step_factory is None
    assert seen["k1"] == 2
    off = NUTSKernel(m, use_pallas="off")
    assert off.transition_factory is None and seen["k1"] == 2
    assert NUTSKernel(m).use_pallas == "auto" and seen["k1"] == 3
    g = std_normal(3, device="cpu")
    on = NUTSKernel(g, use_pallas="on")
    assert on.transition_factory is None and on.step_factory is not None
    forced = NUTSKernel(g, use_pallas="tree")
    assert forced.step_factory is None
    monkeypatch.setattr(NUTSKernel, "TREE_MIN_CHAINS", 10 ** 9)
    assert forced.transition_factory(tdiag(torch.ones(3)), 1) is not None
    assert NUTSKernel(g).transition_factory(tdiag(torch.ones(3)), 1) is None


@pytest.mark.parametrize("use_pallas,error", [
    ("interpret", NotImplementedError), ("fused", ValueError),
    ("TREE", ValueError)])
def test_use_pallas_refuses_what_the_port_has_not(use_pallas, error):
    """``"interpret"`` (JAX's Pallas interpreter) is not ported: on a CPU
    tensor the port runs its plain versions already; an unknown value
    raises, from ``sample()`` as from ``NUTSKernel``."""
    with pytest.raises(error):
        NUTSKernel(_small_logistic(), use_pallas=use_pallas)
    with pytest.raises(error):
        sample(0, _small_logistic(), 2, 2, device="cpu",
               use_pallas=use_pallas)


@pytest.mark.parametrize("opts", [
    {"physics_mode": "chunked"}, {"grad_bf16": True}, {"block_n": 128}])
def test_logistic_tree_opts_only_on_logistic(opts):
    """``physics_mode``, ``grad_bf16`` and ``block_n`` are logistic
    regression's (JAX's ``_by_kind``): accepted with it under ``"tree"``,
    ``ValueError`` on a model of any other kind, on the ``"auto"`` and the
    ``"tree"`` route."""
    kern = NUTSKernel(_small_logistic(), use_pallas="tree", tree_opts=opts)
    assert kern.transition_factory(tdiag(torch.ones(4)), 8) is not None
    for up in ("auto", "tree"):
        with pytest.raises(ValueError, match="not supported"):
            NUTSKernel(std_normal(3, device="cpu"), tree_opts=opts,
                       use_pallas=up)


def test_logistic_tree_opts_are_checked():
    """An unknown ``physics_mode`` or a ``block_n`` below 1 raises
    ``ValueError`` (JAX raises on the mode); the ``vjp`` mode builds the
    same physics as the chunked one, and the route's transition is the one
    ``make_logistic_tree_transition`` builds from the model's data; a route
    without the whole tree ignores ``tree_opts``, as in JAX; above D =
    2,048 (the wide form's bound) the forced whole tree is not ported."""
    m = _small_logistic()
    for opts in ({"physics_mode": "dense"}, {"block_n": 0}):
        with pytest.raises(ValueError):
            NUTSKernel(m, use_pallas="tree", tree_opts=opts)
    met = tdiag(torch.ones(4))
    z = TEval(q=torch.zeros((8, 4)), logp=torch.zeros(8),
              grad=torch.zeros((8, 4)))
    outs = []
    for mode in ("chunked", "vjp"):
        kern = NUTSKernel(m, use_pallas="tree", tree_opts={
            "physics_mode": mode, "block_n": 96})
        outs.append(kern.transition_factory(met, 8)(
            torch.Generator().manual_seed(0), z, 0.3))
    st = m.structure
    built = tree.make_logistic_tree_transition(
        st["x"], st["y"], st["inv_var"], met, physics_mode="vjp",
        block_n=96)(torch.Generator().manual_seed(0), z, 0.3)
    for out in outs[1:] + [built]:
        assert torch.equal(outs[0][0].q, out[0].q)
        assert torch.equal(outs[0][1].steps, out[1].steps)
    ignored = NUTSKernel(m, tree_opts={"n_sweep": 4, "block_n": 96})
    assert ignored.transition_factory is None
    wide = Model(name="w", dim=2049, logp=lambda q: -(q * q).sum(-1),
                 structure={"kind": "diag_gaussian",
                            "precision": torch.ones(2049)})
    with pytest.raises(NotImplementedError, match="item 1 \\(h\\)"):
        NUTSKernel(wide, use_pallas="tree")
    assert NUTSKernel(wide).step_factory is not None


def test_sample_logistic_through_the_tree_route(monkeypatch):
    """``sample(..., use_pallas="tree", device="cpu")`` on a small logistic
    regression (N = 200, D = 4, 16 chains) with dense windows and the
    flagship ``tree_opts``: every tuning transition and every launch of
    the swept sampling loop runs K5's plain version with the ``logistic``
    physics (the identity diagonal metric until the first dense window
    closes, the dense one after); finite draws, split R-hat < 1.05,
    acceptance in [0.6, 0.95], the posterior mean near the coefficients
    that made the data."""
    x, y, beta, _, _ = _problem(6, n=400, d=4)
    calls = []
    plain = tree.tree_transition_plain

    def spy(q0, p0, eps, dirs, unif, phys, minv, *a, **kw):
        calls.append((phys.name, "dense" if minv.ndim == 2 else "diag"))
        return plain(q0, p0, eps, dirs, unif, phys, minv, *a, **kw)

    monkeypatch.setattr(tree, "tree_transition_plain", spy)
    st = default_warmup_stages(init_steps=30, middle_steps=20,
                               doubling_stages=2, terminating_steps=20,
                               metric="dense")
    res = sample(7, logistic_regression(x, y, device="cpu"), 96, 16,
                 warmup_stages=st, device="cpu", use_pallas="tree",
                 tree_opts={"refresh_inside": True, "padded_io": True,
                            "n_sweep": 16})
    assert calls.count(("logistic", "diag")) == 30 + 20
    assert calls.count(("logistic", "dense")) == 40 + 20 + 96
    assert len(calls) == 50 + 156
    draws = res.draws.double()
    assert draws.shape == (96, 16, 4) and bool(torch.isfinite(draws).all())
    assert float(diag.split_rhat(draws).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95
    mean = draws.mean(dim=(0, 1)).numpy()
    assert np.corrcoef(mean, beta)[0, 1] > 0.9


def test_model_from_numpy_feeds_the_tree_route():
    """``convert.model_from_numpy`` carries a JAX structure's x, y and
    inv_var across unchanged, which is all the physics needs: its padded
    data equal ``logistic_data`` on the numpy arrays bit for bit."""
    x, y, _, _, _ = _problem(8, n=100, d=3)
    m = conv.model_from_numpy(x, y, INV_VAR, device="cpu")
    phys, data = S._tree_physics(m.structure, "tree", {"block_n": 64})
    want = tp.logistic_data(torch.as_tensor(x), torch.as_tensor(y), INV_VAR,
                            block_n=64)
    assert phys == "logistic"
    for k in ("x", "y", "w"):
        assert torch.equal(data[k], want[k]), k
    assert data["inv_var"] == pytest.approx(INV_VAR, rel=1e-15)
