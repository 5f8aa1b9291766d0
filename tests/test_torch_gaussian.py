"""Port parity for the diagonal-Gaussian slice: the models
(``models/gaussian.py``), the fused Gaussian leapfrog (``ops/leapfrog.py``,
K3), the whole-tree transition (``ops/tree.py``, K5) and ``sample()`` through
each of the two routes ``NUTSKernel`` picks for them.

On the CPU every kernel wrapper runs its plain torch version; these tests
hold that version against the JAX package's Pallas kernels run in interpret
mode on the same numpy inputs (momentum, direction words and proposal
uniforms included), against the recursive numpy oracle and against the
port's own lockstep tree.  Integer fields (termination, depth, steps,
term_left, term_right) must be equal; float fields agree to f32 round-off of
sums taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.config import NUTS as JNUTS
from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.metric import diag_metric as jdiag
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.models import diag_normal as jdiag_normal
from inplacedhmc_tpu.models import std_normal as jstd_normal
from inplacedhmc_tpu.nuts.tree import nuts_transition as jnuts
from inplacedhmc_tpu.ops.leapfrog_pallas import \
    make_fused_gaussian_leapfrog as jleapfrog
from inplacedhmc_tpu.ops.tree_pallas import \
    make_gaussian_tree_transition as jtree
from inplacedhmc_tpu.sample import NUTSKernel as JKernel

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
    global torch, conv, diag, sample, NUTS, NUTSKernel, Termination
    global default_warmup_stages
    global tbl, tdiag, tdense, TEval, tnuts, diag_normal, std_normal
    global LEAPFROG_GAUSSIAN, make_fused_gaussian_leapfrog
    global fused_gaussian_leapfrog_plain, TREE_GAUSSIAN
    global gaussian_tree_transition_plain, make_gaussian_tree_transition
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    from inplacedhmc_tpu_torch import (NUTS, Termination,
                                       default_warmup_stages, sample)
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import dense_metric as tdense
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.models import diag_normal, std_normal
    from inplacedhmc_tpu_torch.nuts.tree import nuts_transition as tnuts
    from inplacedhmc_tpu_torch.ops.leapfrog import (
        LEAPFROG_GAUSSIAN, fused_gaussian_leapfrog_plain,
        make_fused_gaussian_leapfrog)
    from inplacedhmc_tpu_torch.ops.tree import (
        TREE_GAUSSIAN, gaussian_tree_transition_plain,
        make_gaussian_tree_transition)
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
TERM_NAME = {0: "max_depth", 1: "divergence", 2: "turning"}
# f32 inputs on both sides, the same operations in the same order; XLA's CPU
# compiler may contract a multiply and an add into one FMA, and the row sums
# (log density, kinetic energy) add up D = 7 terms in another order: a few
# f32 ulps of values of order 10, compounded over at most 2^5 leaves
F32_RTOL, F32_ATOL = 2e-6, 2e-5


def _inputs(seed, c=16, d=7, max_depth=5, unit_metric=False):
    rng = np.random.default_rng(seed)
    prec = (rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    minv = (np.ones(d) if unit_metric
            else rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    q0 = rng.normal(size=(c, d)).astype(np.float32)
    p0 = rng.normal(size=(c, d)).astype(np.float32)
    dirs = rng.integers(0, 2 ** 32, size=c, dtype=np.uint32)
    unif = rng.uniform(size=((1 << max_depth) - 1 + max_depth, c)) \
        .astype(np.float32)
    return dict(prec=prec, minv=minv, q0=q0, p0=p0, dirs=dirs, unif=unif,
                max_depth=max_depth)


def _jax_point(prec, q0):
    pot = jbl(lambda q: -0.5 * jnp.sum(q * (jnp.asarray(prec) * q)))
    lp, g = pot(jnp.asarray(q0))
    return pot, JEval(q=jnp.asarray(q0), logp=lp, grad=g)


@pytest.mark.parametrize("which", ["std_normal", "diag_normal"])
def test_gaussian_models_match_jax(which):
    """logp and its autograd gradient against the JAX models, at f64; the
    structure carries the JAX model's precision, and converts across."""
    rng = np.random.default_rng(0)
    var = rng.gamma(2.0, size=7) + 0.1
    if which == "std_normal":
        jm, tm = jstd_normal(7), std_normal(7, device="cpu")
    else:
        jm, tm = jdiag_normal(var), diag_normal(torch.as_tensor(var),
                                                device="cpu")
    assert tm.dim == jm.dim == 7
    assert tm.structure["kind"] == jm.structure["kind"] == "diag_gaussian"
    np.testing.assert_allclose(tm.structure["precision"].numpy(),
                               np.asarray(jm.structure["precision"]),
                               rtol=1e-15)
    q = rng.normal(size=(5, 7)) * 2.0
    jlp, jg = jbl(jm.logp)(jnp.asarray(q))
    tlp, tg = tbl(tm.logp)(torch.as_tensor(q))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12)
    cm = conv.gaussian_model_from_numpy(np.asarray(jm.structure["precision"]),
                                        device="cpu")
    assert cm.structure["precision"].dtype == torch.float32
    np.testing.assert_array_equal(
        cm.structure["precision"].numpy(),
        np.asarray(jm.structure["precision"], np.float32))


def test_fused_leapfrog_plain_matches_jax_interpret():
    """K3's plain version against ``make_fused_gaussian_leapfrog(...,
    interpret=True)`` to f32 round-off, and the factory's step equal to the
    plain version."""
    r = _inputs(2, c=24)
    eps = np.where(np.arange(24) % 3 == 0, -0.37, 0.21).astype(np.float32)
    want = jleapfrog(r["prec"], r["minv"], interpret=True)(
        jnp.asarray(r["q0"]), jnp.asarray(r["p0"]), jnp.asarray(eps))
    got = fused_gaussian_leapfrog_plain(
        *(torch.as_tensor(a) for a in (r["q0"], r["p0"], eps, r["prec"],
                                       r["minv"])))
    step = make_fused_gaussian_leapfrog(torch.as_tensor(r["prec"]),
                                        torch.as_tensor(r["minv"]))
    before = LEAPFROG_GAUSSIAN.launches
    via = step(torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
               torch.as_tensor(eps))
    assert LEAPFROG_GAUSSIAN.launches == before   # the CPU runs the plain one
    names = ("q", "p", "grad", "logp", "kin", "psharp")
    for name, w, g, v in zip(names, want, got, via):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(v.numpy(), g.numpy(), err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=name)


# (seed, eps, unit metric): the cases of tests/test_tree_pallas.py, a
# divergent eps (every chain dies on an early leaf) and one so small that
# every tree reaches max_depth 5
TREE_CASES = [(0, 0.1, False), (1, 0.4, False), (2, 1.1, False),
              (3, 0.4, True), (4, 3.0, False), (5, 0.005, False)]


@pytest.mark.parametrize("seed,eps,unit_metric", TREE_CASES)
def test_tree_plain_matches_jax_kernel_and_oracle(seed, eps, unit_metric):
    """K5's plain version against ``make_gaussian_tree_transition(...,
    interpret=True, block_c=16, max_depth=5)`` with the same q0, p0,
    directions and uniforms: integer fields equal; energy, acceptance and
    the proposal to f32 round-off.  The integer fields and the acceptance
    also equal the recursive numpy oracle, and the proposal is a leaf of its
    trajectory."""
    r = _inputs(seed, unit_metric=unit_metric)
    md = r["max_depth"]
    _, jz = _jax_point(r["prec"], r["q0"])
    jz2, jst = jtree(jnp.asarray(r["prec"]), jnp.asarray(r["minv"]),
                     max_depth=md, block_c=16, interpret=True)(
        jax.random.PRNGKey(seed), jz, eps, directions=jnp.asarray(r["dirs"]),
        momentum=jnp.asarray(r["p0"]), _unif=jnp.asarray(r["unif"]))
    c = r["q0"].shape[0]
    out = gaussian_tree_transition_plain(
        torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(r["dirs"].astype(np.int64)),
        torch.as_tensor(r["unif"]), torch.as_tensor(r["prec"]),
        torch.as_tensor(r["minv"]), md, -1000.0)
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} eps={eps}")
    accept = torch.clamp(torch.exp(out.log_sum_alpha)
                         / torch.clamp(out.steps, min=1), max=1.0)
    np.testing.assert_allclose(accept.numpy(), np.asarray(jst.acceptance_rate),
                               rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(jst.energy),
                               rtol=F32_RTOL, atol=F32_ATOL)
    for got, want in ((out.q, jz2.q), (out.logp, jz2.logp),
                      (out.grad, jz2.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)

    prec = r["prec"].astype(np.float64)

    def logp_np(q):
        return -0.5 * float(q @ (prec * q)), -prec * q

    for i in range(c):
        want = oracle_trajectory(logp_np, r["minv"], r["q0"][i], r["p0"][i],
                                 eps, int(r["dirs"][i]), max_depth=md)
        tag = f"chain {i} eps {eps}"
        assert TERM_NAME[int(out.term[i])] == want["termination"], tag
        assert int(out.depth[i]) == want["depth"], tag
        assert int(out.steps[i]) == want["steps"], tag
        if want["termination"] != "max_depth":
            assert int(out.term_left[i]) == want["term_left"], tag
            assert int(out.term_right[i]) == want["term_right"], tag
        # f32 trajectory against the f64 oracle: test_tree_pallas.py's bounds
        np.testing.assert_allclose(float(accept[i]), want["accept"],
                                   atol=2e-4, err_msg=tag)
        leaf_deltas = np.array(list(want["leaves"].values()))
        delta = float(out.energy[i]) - want["pi0"]
        assert np.min(np.abs(leaf_deltas - delta)) < 5e-3, tag
    if eps == 3.0:
        assert np.all(out.term.numpy() == Termination.DIVERGENCE)
    if eps == 0.005:
        assert np.all(out.term.numpy() == Termination.MAX_DEPTH)
        assert np.all(out.depth.numpy() == md)


@pytest.mark.parametrize("seed,eps", [(20, 0.1), (21, 0.02)])
def test_tree_plain_matches_jax_kernel_above_one_warp(seed, eps):
    """Above D = 256, where the card runs K5's wide form (one chain per
    block of warps), its plain version against
    ``make_gaussian_tree_transition(..., interpret=True, block_c=16,
    max_depth=5)`` at D = 300 with the same q0, p0, directions and
    uniforms: integer fields equal, the float fields to ``F32_RTOL`` and
    ``F32_ATOL``.  The acceptance is ``exp(min(delta, 0))`` of a difference
    of two joint energies (about 700 here, a sum of 600 terms), so it is
    held to that tolerance of the energies carried through ``exp`` (whose
    slope is at most 1 there): ``2 (F32_ATOL + F32_RTOL |energy|)``."""
    r = _inputs(seed, c=16, d=300)
    md = r["max_depth"]
    _, jz = _jax_point(r["prec"], r["q0"])
    jz2, jst = jtree(jnp.asarray(r["prec"]), jnp.asarray(r["minv"]),
                     max_depth=md, block_c=16, interpret=True)(
        jax.random.PRNGKey(seed), jz, eps, directions=jnp.asarray(r["dirs"]),
        momentum=jnp.asarray(r["p0"]), _unif=jnp.asarray(r["unif"]))
    c = r["q0"].shape[0]
    out = gaussian_tree_transition_plain(
        torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(r["dirs"].astype(np.int64)),
        torch.as_tensor(r["unif"]), torch.as_tensor(r["prec"]),
        torch.as_tensor(r["minv"]), md, -1000.0)
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} eps={eps}")
    accept = torch.clamp(torch.exp(out.log_sum_alpha)
                         / torch.clamp(out.steps, min=1), max=1.0)
    energy = np.asarray(jst.energy)
    np.testing.assert_array_less(
        np.abs(accept.numpy() - np.asarray(jst.acceptance_rate)),
        2 * (F32_ATOL + F32_RTOL * np.abs(energy)))
    np.testing.assert_allclose(out.energy.numpy(), energy, rtol=F32_RTOL,
                               atol=F32_ATOL)
    for got, want in ((out.q, jz2.q), (out.logp, jz2.logp),
                      (out.grad, jz2.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)
    assert int(out.steps.sum()) > 2 * c   # several leaves


@pytest.mark.parametrize("eps", [0.05, 0.4, 1.3])
def test_tree_plain_matches_port_lockstep_tree(eps):
    """The whole-tree transition and the port's own ``nuts_transition`` with
    the same momentum and directions: equal integer fields (the proposal
    uniforms differ, and no integer field depends on them), at f64."""
    rng = np.random.default_rng(7)
    c, d = 32, 9
    prec = rng.gamma(2.0, size=d) + 0.2
    inv = rng.gamma(2.0, size=d) + 0.2
    q0 = rng.normal(size=(c, d)) * 1.5
    p0 = rng.normal(size=(c, d))
    dirs = torch.as_tensor(rng.integers(0, 2 ** 32, size=c))
    tpot = tbl(lambda q: -0.5 * torch.sum(torch.as_tensor(prec) * q * q,
                                          dim=-1))
    tq = torch.as_tensor(q0)
    lp, g = tpot(tq)
    z = TEval(q=tq, logp=lp, grad=g)
    met = tdiag(torch.as_tensor(inv))
    _, want = tnuts(torch.Generator().manual_seed(1), tpot, met, z, eps,
                    max_depth=7, directions=dirs,
                    momentum=torch.as_tensor(p0))
    trans = make_gaussian_tree_transition(torch.as_tensor(prec), met,
                                          max_depth=7)
    before = TREE_GAUSSIAN.launches
    z2, got = trans(torch.Generator().manual_seed(2), z, eps,
                    directions=dirs, momentum=torch.as_tensor(p0))
    assert TREE_GAUSSIAN.launches == before   # the CPU runs the plain version
    assert z2.q.dtype == torch.float64
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    np.testing.assert_allclose(got.acceptance_rate.numpy(),
                               want.acceptance_rate.numpy(), rtol=1e-10)
    np.testing.assert_allclose(z2.grad.numpy(),
                               -prec * z2.q.numpy(), rtol=1e-15)


def test_routes_follow_metric_and_chain_count(monkeypatch):
    """The whole-tree transition for a float32 shared metric, diagonal or
    dense, at ``TREE_MIN_CHAINS`` chains or more; the fused leapfrog for any
    float32 shared diagonal metric and no other; neither for another
    metric."""
    kern = NUTSKernel(std_normal(3, device="cpu"))
    f32 = tdiag(torch.ones(3))
    dense32 = tdense(torch.eye(3))
    monkeypatch.setattr(NUTSKernel, "TREE_MIN_CHAINS", 64)
    for met in (f32, dense32):
        assert kern.transition_factory(met, 64) is not None
        assert kern.transition_factory(met, 63) is None
    assert kern.step_factory(f32) is not None
    assert kern.step_factory(dense32) is None
    for other in (tdiag(torch.ones(3, dtype=torch.float64)),
                  tdiag(torch.ones((64, 3))),
                  tdense(torch.eye(3, dtype=torch.float64))):
        assert kern.transition_factory(other, 64) is None
        assert kern.step_factory(other) is None
    logistic = NUTSKernel(
        conv.model_from_numpy(np.zeros((4, 3), np.float32),
                              np.zeros(4, np.float32), 1.0, device="cpu"))
    assert logistic.transition_factory is None
    assert logistic.step_factory is None


@pytest.mark.parametrize("dim, n_chains, max_depth, tree", [
    (256, 16, 10, True), (257, 16, 10, True), (2048, 16, 13, True),
    (2048, 16, 14, False), (2049, 16, 10, False),
    (3, 16_371, 14, True), (3, 16_372, 14, True)])
def test_route_follows_what_the_tree_kernel_takes(dim, n_chains, max_depth,
                                                  tree, monkeypatch):
    """The whole-tree route only where its kernel takes the problem: one
    warp per chain up to D = 256, one block of warps per chain up to
    ``ops.tree.MAX_DIM`` (2,048) where the checkpoint stacks fit the shared
    memory (at D = 2,048 up to max_depth 13); elsewhere the lockstep tree
    with the fused leapfrog, which has no such bound.  The kernel draws its
    uniforms itself, so the chain count does not bound it: the 16,372
    chains at max_depth 14 whose ``[2^14 - 1 + 14, C]`` uniform array would
    have passed 1 GiB take the whole tree too (at D = 3).  The choice is
    made when the route is built, whatever the chain-count threshold."""
    monkeypatch.setattr(NUTSKernel, "TREE_MIN_CHAINS", 0)
    kern = NUTSKernel(std_normal(dim, device="cpu"), NUTS(max_depth=max_depth))
    f32 = tdiag(torch.ones(dim))
    assert (kern.transition_factory(f32, n_chains) is not None) == tree
    assert kern.step_factory(f32) is not None


@pytest.mark.parametrize("route", ["tree", "lockstep"])
def test_sample_diag_normal_through_each_route(route, monkeypatch):
    """``sample()`` on a 7-D diagonal normal at 16 chains through the
    whole-tree route (``TREE_MIN_CHAINS`` patched to 0) and the lockstep
    route with the fused leapfrog: every coordinate's mean within 5 Monte
    Carlo standard errors of 0 and its variance within 5 standard errors of
    the truth (errors from the draws' own ESS of q and of q^2; the JAX
    package's fused path meets a looser form of this check in
    ``tests/test_pallas.py``), split R-hat < 1.05, acceptance near the 0.8
    target."""
    monkeypatch.setattr(NUTSKernel, "TREE_MIN_CHAINS",
                        0 if route == "tree" else 10 ** 9)
    var = np.array([4.0, 1.0, 0.25, 1.0, 9.0, 0.5, 2.0], np.float32)
    model = diag_normal(var, device="cpu")
    kern = NUTSKernel(model)
    assert (kern.transition_factory(tdiag(torch.ones(7)), 16) is None) \
        == (route == "lockstep")
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=3, terminating_steps=25)
    res = sample(11, model, 400, 16, warmup_stages=stages, device="cpu")
    draws = res.draws.double()
    assert draws.shape == (400, 16, 7) and bool(torch.isfinite(draws).all())
    ess = diag.ess_bulk(draws, cap=False).numpy()
    ess_sq = diag.ess_bulk(draws * draws, cap=False).numpy()
    mean = draws.mean(dim=(0, 1)).numpy()
    v = draws.var(dim=(0, 1)).numpy()
    assert np.all(np.abs(mean) < 5 * np.sqrt(var / ess)), (mean, ess)
    assert np.all(np.abs(v / var - 1) < 5 * np.sqrt(2 / ess_sq)), \
        (v / var, ess_sq)
    assert float(diag.split_rhat(draws).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95


@pytest.mark.parametrize("route", ["tree", "lockstep"])
def test_one_transition_matches_jax_kernel_route(route, monkeypatch):
    """From one warmup state made in JAX and converted across, one
    transition with the same momentum, directions and uniforms through the
    port's route and JAX's ``NUTSKernel(..., use_pallas="tree")`` (the
    whole-tree kernel, interpret mode on the CPU) or ``"interpret"`` (the
    lockstep tree with the fused leapfrog): equal integer fields."""
    monkeypatch.setattr(NUTSKernel, "TREE_MIN_CHAINS", 0)
    r = _inputs(12, c=16, d=7, max_depth=6)
    var = (1.0 / r["prec"]).astype(np.float32)
    jm = jdiag_normal(var)
    tm = conv.gaussian_model_from_numpy(np.asarray(jm.structure["precision"]),
                                        device="cpu")
    log_eps = np.log(np.float32(0.45))
    jmet = jdiag(jnp.asarray(r["minv"]))
    jpot = jbl(jm.logp)
    lp, g = jpot(jnp.asarray(r["q0"]))
    jz = JEval(q=jnp.asarray(r["q0"]), logp=lp, grad=g)
    tkern = NUTSKernel(tm, NUTS(max_depth=6))
    state = conv.warmup_state_from_numpy(r["q0"], r["minv"], log_eps,
                                         device="cpu",
                                         potential=tkern.potential)
    eps = float(np.exp(log_eps))
    kw = dict(directions=torch.as_tensor(r["dirs"].astype(np.int64)),
              momentum=torch.as_tensor(r["p0"]))
    if route == "tree":
        jkern = JKernel(jm, JNUTS(max_depth=6), use_pallas="tree")
        _, jst = jkern.transition_factory(jmet, 16)(
            jax.random.PRNGKey(0), jz, eps, directions=jnp.asarray(r["dirs"]),
            momentum=jnp.asarray(r["p0"]), _unif=jnp.asarray(r["unif"]))
        trans = tkern.transition_factory(state.metric, 16)
        _, tst = trans(torch.Generator().manual_seed(0), state.z, eps,
                       unif=torch.as_tensor(r["unif"]), **kw)
    else:
        jkern = JKernel(jm, JNUTS(max_depth=6), use_pallas="interpret")
        _, jst = jnuts(jax.random.PRNGKey(0), jpot, jmet, jz,
                       jnp.asarray(eps, jnp.float32), max_depth=6,
                       directions=jnp.asarray(r["dirs"]),
                       momentum=jnp.asarray(r["p0"]),
                       step_fn=jkern.step_factory(jmet))
        _, tst = tnuts(torch.Generator().manual_seed(0), tkern.potential,
                       state.metric, state.z, eps, max_depth=6,
                       step_fn=tkern.step_factory(state.metric), **kw)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{route} {f}")
    np.testing.assert_allclose(tst.acceptance_rate.numpy(),
                               np.asarray(jst.acceptance_rate),
                               rtol=F32_RTOL, atol=F32_ATOL)
