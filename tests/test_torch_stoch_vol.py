"""Port parity for stochastic volatility (BASELINE config 5's model) and the
whole-tree kernel with its hand-written AR(1) physics (K5-stoch_vol:
``csrc/tree_stoch_vol.cu``, its plain version
``ops/tile_physics.py::stoch_vol``).

On the CPU the kernel's wrapper runs its plain torch version; these tests
hold it against the JAX package on the same numpy inputs:

* the physics in float64 against JAX's ``tile_logp`` through ``jax.vjp``
  (as the TPU kernel differentiates it) and against torch autograd of the
  port's centred ``logp``, at T = 5, 30, 31 and 100 (D = 7, 32, 33, 102:
  inside one register of 32 lanes, exactly one, one past, and ending inside
  the fourth, where the neighbour shifts cross registers and stop at D);
* the port's ``logp`` against JAX's ``stoch_vol(returns).logp``, and the
  rows of ``tile_data`` and ``convert.tile_model_from_numpy`` against
  JAX's ``_tile_structure``, bit for bit;
* one float32 transition of the plain tree against JAX's
  ``make_tree_transition(..., interpret=True, block_c=16)`` at T = 21 with
  the same momentum, direction words and uniforms, also from saturated
  starts (``raw_phi = 10``: f32 ``tanh`` is 1, ``log(1 - phi^2)`` is
  ``-inf``), and ``sample()`` through the whole-tree route.

Tolerances.  In float64 both sides compute one density, by hand and by
autodiff, in another order: 1e-12 relative, as ``tests/test_torch_tile.py``.
In float32 the integer records must be equal.  Each side's log density and
gradient are sums of D terms, each within gamma_D = D u / (1 - D u) (u =
2^-24) of the sum of its terms' magnitudes (Higham, Accuracy and Stability
of Numerical Algorithms, section 3.1), and the elementwise functions
(``tanh``, ``exp``, ``log``) of XLA and of torch may round differently;
along a trajectory of up to 2^6 leaves each leaf's difference moves the
next leaf's position.  The float fields are held to ``F32_K`` gamma_D
times their scale: for ``logp`` the sum of the magnitudes of the log
density's terms at the proposal (``_terms``), for ``energy`` that plus the
kinetic energy ``logp - energy`` (a sum of positive terms), for each
gradient component the sum of its terms' magnitudes, for ``q`` ``1 +
|q|``.  ``F32_K`` = 16 covers a few sums and roundings per leaf carried
over the trajectory; these seeds use at most an eighth of it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.models.stoch_vol import _tile_structure
from inplacedhmc_tpu.models.stoch_vol import stoch_vol as jstoch_vol
from inplacedhmc_tpu.ops.tree_pallas import make_tree_transition as jtree


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, conv, tp, tree, NUTS, NUTSKernel, DualAveraging
    global default_warmup_stages, sample, tbl, tdiag
    global stoch_vol, synthetic_returns, Termination
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch import (NUTS, DualAveraging, Termination,
                                       default_warmup_stages, sample)
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.models import stoch_vol, synthetic_returns
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


F64_RTOL, F64_ATOL = 1e-12, 1e-12
F32_K = 16.0
INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
PHI, S = 0.9, 0.3      # the AR(1) that makes the data of the f32 checks


def _gamma(n: int) -> float:
    nu = n * 2.0 ** -24
    return nu / (1.0 - nu)


def _series(t: int, seed: int):
    """The true latents and returns of a series of length ``t`` drawn from
    the model (phi ``PHI``, s ``S``, stationary start), float64."""
    rng = np.random.default_rng(seed)
    h = np.zeros(t)
    h[0] = rng.normal() * S / math.sqrt(1.0 - PHI * PHI)
    for i in range(1, t):
        h[i] = PHI * h[i - 1] + S * rng.normal()
    return h, rng.normal(size=t) * np.exp(0.5 * h), rng


def _positions(h, rng, c: int, spread: float = 0.3):
    """``c`` positions about the truth: ``raw_phi``, ``log_s`` and each
    ``h_t`` ``spread`` (0.2 for the hyperparameters) from it."""
    t = h.shape[0]
    return np.concatenate([
        math.atanh(PHI) + 0.2 * rng.normal(size=(c, 1)),
        math.log(S) + 0.2 * rng.normal(size=(c, 1)),
        h + spread * rng.normal(size=(c, t))], axis=1)


def _rows64(r):
    """The physics' rows in float64 (``r2`` squared in float64, not
    rounded), and JAX's ``[1, D]`` refs of the same numbers."""
    st = _tile_structure(r)
    d = r.shape[0] + 2
    rows = {k: np.asarray(v, np.float64).reshape(d)
            for k, v in st["data"].items()}
    rows["r2"][2:] = np.asarray(r, np.float64) ** 2
    refs = {k: jnp.asarray(v.reshape(1, d)) for k, v in rows.items()}
    return st, rows, refs


@pytest.mark.parametrize("t", [5, 30, 31, 100])
def test_physics_matches_jax_vjp_and_autograd(t):
    """The plain ``stoch_vol`` physics in float64 against JAX's
    ``tile_logp`` differentiated with ``jax.vjp`` on the same rows, and
    against torch autograd of the port's centred ``logp`` (its own shifts,
    independent of the physics), both to 1e-12 relative; the port's
    ``logp`` against JAX's ``stoch_vol(returns).logp``."""
    h, r, rng = _series(t, t)
    q = _positions(h, rng, 9, spread=0.5)
    st, rows, refs = _rows64(r)
    jlp, vjp = jax.vjp(lambda qq: st["tile_logp"](qq, refs), jnp.asarray(q))
    (jg,) = vjp(jnp.ones_like(jlp))
    lp, g = tp.bind("stoch_vol", {**rows, "t": t}, "cpu",
                    torch.float64)(torch.as_tensor(q))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp)[:, 0],
                               rtol=F64_RTOL, atol=F64_ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=F64_RTOL,
                               atol=F64_ATOL * float(np.abs(jg).max()))
    m = stoch_vol(r, device="cpu")
    assert m.dim == t + 2 and m.structure["physics"] == "stoch_vol"
    alp, ag = tbl(m.logp)(torch.as_tensor(q))
    np.testing.assert_allclose(lp.numpy(), alp.numpy(), rtol=F64_RTOL,
                               atol=F64_ATOL)
    np.testing.assert_allclose(g.numpy(), ag.numpy(), rtol=F64_RTOL,
                               atol=F64_ATOL * float(ag.abs().max()))
    jm = jstoch_vol(r)
    np.testing.assert_allclose(
        alp.numpy(), np.asarray(jax.vmap(jm.logp)(jnp.asarray(q))),
        rtol=F64_RTOL, atol=F64_ATOL)
    post = m.constrain(torch.as_tensor(q))
    jpost = jm.constrain(jnp.asarray(q))
    for k in ("phi", "s", "h"):
        np.testing.assert_allclose(post[k].numpy(), np.asarray(jpost[k]),
                                   rtol=F64_RTOL)


@pytest.mark.parametrize("t", [5, 100])
def test_tile_rows_match_jax_structure(t):
    """The rows of the port's model (``tile_data``) and of
    ``tile_model_from_numpy`` on JAX's structure equal JAX's
    ``_tile_structure`` bit for bit (``r2`` squared in float64, then
    rounded to float32); the converted model's ``logp`` is JAX's tile
    density on those float32 rows, to 1e-12 in float64."""
    h, r, rng = _series(t, 40 + t)
    st = _tile_structure(r)
    cm = conv.tile_model_from_numpy("stoch_vol", st["data"], t + 2,
                                    scalars={"t": t}, device="cpu")
    own = stoch_vol(r, device="cpu").structure
    assert own["scalars"] == cm.structure["scalars"] == {"t": float(t)}
    for k, v in st["data"].items():
        want = np.asarray(v, np.float32).reshape(-1)
        for got in (own["data"][k], cm.structure["data"][k]):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    q = _positions(h, rng, 5)
    refs = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in
            st["data"].items()}
    jlp = st["tile_logp"](jnp.asarray(q), refs)[:, 0]
    np.testing.assert_allclose(cm.logp(torch.as_tensor(q)).numpy(),
                               np.asarray(jlp), rtol=F64_RTOL,
                               atol=F64_ATOL)


def _tree_inputs(seed: int, t: int = 21, c: int = 16, md: int = 6,
                 saturate: bool = False, dense: bool = False):
    """One transition's inputs; the metric ``0.5 + U(0, 1)`` with the
    hyperparameters' entries a tenth of that, or with ``dense`` that
    diagonal plus a small symmetric part (the momentum ``N(0, M)``)."""
    h, r, rng = _series(t, seed)
    d = t + 2
    q0 = _positions(h, rng, c).astype(np.float32)
    if saturate:
        q0[::4, 0] = 10.0
    minv = (0.5 + rng.uniform(size=d)).astype(np.float32)
    minv[:2] *= np.float32(0.1)   # the hyperparameters' posterior is narrow
    xi = rng.normal(size=(c, d))
    if dense:
        b = rng.normal(size=(d, d)) * 0.05 / np.sqrt(d)
        m = np.diag(minv) + 0.5 * (b @ b.T) * np.sqrt(np.outer(minv, minv))
        minv = (0.5 * (m + m.T)).astype(np.float32)
        p0 = (xi @ np.linalg.cholesky(np.linalg.inv(
            minv.astype(np.float64))).T).astype(np.float32)
    else:
        p0 = (xi / np.sqrt(minv)).astype(np.float32)
    return dict(r=r.astype(np.float32), q0=q0, p0=p0, minv=minv,
                dirs=rng.integers(0, 2 ** 32, size=c, dtype=np.uint32),
                unif=rng.uniform(size=((1 << md) - 1 + md, c))
                .astype(np.float32), md=md)


def _both_transitions(x, eps):
    """One transition through JAX's interpret kernel and the port's plain
    tree (on the model ``tile_model_from_numpy`` makes of JAX's structure),
    on the same numpy inputs."""
    jm = jstoch_vol(x["r"])
    c, d = x["q0"].shape
    jz = JEval(q=jnp.asarray(x["q0"]), logp=jnp.zeros(c),
               grad=jnp.zeros_like(jnp.asarray(x["q0"])))
    minv = jnp.asarray(x["minv"])
    jz2, jst = jtree(jm.structure["tile_logp"], jm.structure["data"], d,
                     jdense(minv) if minv.ndim == 2 else minv,
                     max_depth=x["md"], block_c=16, interpret=True)(
        jax.random.PRNGKey(0), jz, eps, directions=jnp.asarray(x["dirs"]),
        momentum=jnp.asarray(x["p0"]), _unif=jnp.asarray(x["unif"]))
    cm = conv.tile_model_from_numpy("stoch_vol", jm.structure["data"], d,
                                    scalars={"t": d - 2}, device="cpu")
    st = cm.structure
    phys = tp.bind("stoch_vol", {**st["data"], **st["scalars"]}, "cpu",
                   torch.float32)
    before = tree.TREE_KERNELS["stoch_vol"].launches
    out = tree.tree_transition(
        torch.as_tensor(x["q0"]), torch.as_tensor(x["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(x["dirs"].astype(np.int64)),
        torch.as_tensor(x["unif"]), phys, torch.as_tensor(x["minv"]),
        x["md"], -1000.0)
    assert tree.TREE_KERNELS["stoch_vol"].launches == before  # the plain one
    return jz2, jst, out, st


def _terms(q, data):
    """Per chain (float64, at ``q``): the sum of the magnitudes of the log
    density's terms, and of each gradient component's terms."""
    q = np.asarray(q, np.float64)
    r2 = np.asarray(data["r2"], np.float64)
    hm = np.asarray(data["h_mask"]) != 0
    am = np.asarray(data["ar_mask"]) != 0
    t = float(data["t"])
    raw_phi, log_s = q[:, :1], q[:, 1:2]
    phi, inv_s = np.tanh(raw_phi), np.exp(-log_s)
    u = 1.0 - phi * phi
    z1 = q[:, 2:3] * inv_s
    h = np.where(hm, q, 0.0)
    hprev = np.pad(h[:, :-1], ((0, 0), (1, 0)))
    innov = np.where(am, (q - phi * hprev) * inv_s, 0.0)
    re = r2 * np.exp(-h)
    with np.errstate(divide="ignore"):
        lp = (0.5 * (raw_phi - 1.5) ** 2 + 0.5 * (log_s + 2.0) ** 2
              + 0.5 * np.abs(np.log(u)) + t * np.abs(log_s)
              + 0.5 * u * z1 * z1)[:, 0] + 0.5 * (innov ** 2).sum(1) \
            + np.where(hm, 0.5 * (np.abs(h) + re), 0.0).sum(1)
    nxt = np.abs(np.pad(innov[:, 1:], ((0, 0), (0, 1))))
    g = np.where(hm, 0.5 * re + 0.5 + np.abs(innov) * inv_s
                 + np.abs(phi) * inv_s * nxt, 0.0)
    g[:, 2] += (u * np.abs(z1) * inv_s)[:, 0]
    g[:, 0] = (np.abs(raw_phi - 1.5) + np.abs(phi) + u * (
        np.abs(phi) * z1 * z1
        + inv_s * np.abs(innov * hprev).sum(1, keepdims=True)))[:, 0]
    g[:, 1] = (np.abs(log_s + 2.0) + t + u * z1 * z1)[:, 0] \
        + (innov ** 2).sum(1)
    return lp, g


def _assert_same_transition(jz2, jst, out, st, tag):
    """Integer records equal; the float fields within ``F32_K`` gamma_D of
    their scales (the module docstring); non-finite values equal."""
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} {tag}")
    d = out.q.shape[1]
    gam = F32_K * _gamma(d)
    data = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in
            {**st["data"], **st["scalars"]}.items()}
    want_q = np.asarray(jz2.q, np.float64)
    lp_terms, g_terms = _terms(want_q, data)
    want_lp = np.asarray(jz2.logp, np.float64)
    with np.errstate(invalid="ignore"):   # -inf - -inf on saturated chains
        kin = np.abs(want_lp - np.asarray(jst.energy, np.float64))
    scales = {"q": 1.0 + np.abs(want_q), "logp": lp_terms,
              "grad": g_terms, "energy": lp_terms + kin}
    worst = 0.0
    for f, got, want in (("q", out.q, jz2.q), ("logp", out.logp, jz2.logp),
                         ("grad", out.grad, jz2.grad),
                         ("energy", out.energy, jst.energy)):
        g = got.numpy().astype(np.float64)
        w = np.asarray(want, np.float64)
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        with np.errstate(invalid="ignore"):
            ratio = np.where(same, 0.0, np.abs(g - w) / (gam * scales[f]))
        assert bool(np.isfinite(ratio).all()), f"{f} {tag}"
        worst = max(worst, float(ratio.max()))
        assert float(ratio.max()) <= 1.0, (f, tag, float(ratio.max()))
    print(f"[{tag}] largest difference {worst:.3g} of the bound")
    accept = tree.acceptance(out.log_sum_alpha, out.steps).numpy()
    np.testing.assert_allclose(accept, np.asarray(jst.acceptance_rate),
                               rtol=0, atol=gam * 8, err_msg=tag)
    return worst


@pytest.mark.parametrize("seed,eps", [(0, 0.05), (1, 0.2), (2, 0.6)])
def test_tree_plain_matches_jax_kernel(seed, eps):
    """K5's plain version with the ``stoch_vol`` physics at T = 21 against
    ``make_tree_transition(tile_logp, ..., interpret=True, block_c=16,
    max_depth=6)`` with the same q0, momentum, direction words and
    uniforms, at a deep, a mixed and a divergent step size: integer
    records equal, float fields within the bound of the module
    docstring."""
    x = _tree_inputs(seed)
    jz2, jst, out, st = _both_transitions(x, eps)
    _assert_same_transition(jz2, jst, out, st, f"eps {eps}")
    if eps < 0.5:
        assert int(out.steps.sum()) > 4 * len(x["q0"])   # several leaves


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_tree_plain_matches_jax_kernel_above_one_warp(metric):
    """Above D = 256, where the card runs K5's wide form (one chain per
    block of warps, the AR(1) neighbours exchanged across warp edges), its
    plain version against ``make_tree_transition(tile_logp, ...,
    interpret=True, block_c=16, max_depth=5)`` at T = 298 (D = 300), under
    a diagonal and a dense metric, with the same q0, momentum, direction
    words and uniforms: integer records equal, float fields within the
    bound of the module docstring."""
    x = _tree_inputs(10, t=298, md=5, dense=metric == "dense")
    jz2, jst, out, st = _both_transitions(x, 0.05)
    _assert_same_transition(jz2, jst, out, st, f"T = 298, {metric}")
    assert int(out.steps.sum()) > 4 * len(x["q0"])   # several leaves


def test_saturated_start_diverges_alike():
    """Every fourth chain starts at ``raw_phi = 10``, where f32 ``tanh`` is
    1: its log density is ``-inf`` and ``d/draw_phi`` NaN on both sides.
    Both kernels turn the first leaf into a divergence (the leaf's
    sanitisation), the chain keeps its start, and the records, the ``-inf``
    log density and the NaN gradient component are the same as JAX's; the
    other chains are held to the usual bound."""
    x = _tree_inputs(3, saturate=True)
    jz2, jst, out, st = _both_transitions(x, 0.2)
    _assert_same_transition(jz2, jst, out, st, "saturated")
    sat = x["q0"][:, 0] == 10.0
    assert bool((out.term.numpy()[sat] == int(Termination.DIVERGENCE)).all())
    assert bool((out.steps.numpy()[sat] == 1).all())
    np.testing.assert_array_equal(out.q.numpy()[sat], x["q0"][sat])
    assert bool(np.isneginf(out.logp.numpy()[sat]).all())
    assert bool(np.isnan(out.grad.numpy()[sat, 0]).all())
    assert bool(np.isfinite(out.logp.numpy()[~sat]).all())


def test_sample_through_the_tree_route(monkeypatch):
    """``sample()`` on T = 21 (delta 0.9, dense windows, no L-BFGS start:
    config 5's recipe, a short schedule), 16 chains, 100 draws, on the CPU:
    every transition of the tuning windows and of the sampling loop goes
    through the whole-tree route (K5's plain version with the
    ``stoch_vol`` physics, counted by its calls), the draws are finite and
    the acceptance is near delta."""
    h, r, _ = _series(21, 7)
    m = stoch_vol(r.astype(np.float32), device="cpu")
    calls = []
    real = tree.tree_transition_plain

    def counted(q0, p0, eps, dirs, unif, phys, *a, **kw):
        calls.append(phys.name)
        return real(q0, p0, eps, dirs, unif, phys, *a, **kw)

    monkeypatch.setattr(tree, "tree_transition_plain", counted)
    stages = default_warmup_stages(
        local_optimization=None,
        stepsize_adaptation=DualAveraging(delta=0.9), init_steps=30,
        middle_steps=20, doubling_stages=2, terminating_steps=20,
        metric="dense")
    res = sample(5, m, 100, 16, warmup_stages=stages, device="cpu",
                 algorithm=NUTS(max_depth=6))
    assert calls == ["stoch_vol"] * (30 + 20 + 40 + 20 + 100)
    x = res.draws.double()
    assert x.shape == (100, 16, 23) and bool(torch.isfinite(x).all())
    assert 0.7 <= float(res.stats.acceptance_rate.mean()) <= 0.99


def test_routes_of_the_model():
    """At D <= 256 the model takes the whole-tree route from its chain
    threshold with a float32 metric (diagonal or dense) and autograd on the
    lockstep tree with a float64 one; so it does up to D = 2,048 (T =
    2,046: one block of warps per chain); above it (T = 2,047) autograd on
    the lockstep tree, and ``use_pallas="tree"`` refuses it naming the
    ROADMAP item that lifts the bound.  ``tree_opts`` are taken."""
    m = stoch_vol(np.ones(100, np.float32), device="cpu")
    kern = NUTSKernel(m)
    thr = kern.tree_min_chains("stoch_vol")
    assert kern.transition_factory(tdiag(torch.ones(102)), thr) is not None
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    assert kern.transition_factory(dense_metric(torch.eye(102)),
                                   thr) is not None
    assert kern.transition_factory(
        tdiag(torch.ones(102, dtype=torch.float64)), thr) is None
    assert kern.step_factory is None
    NUTSKernel(m, tree_opts={"refresh_inside": True, "padded_io": True,
                             "n_sweep": 4})
    inside = stoch_vol(np.ones(2046, np.float32), device="cpu")
    assert NUTSKernel(inside).transition_factory(tdiag(torch.ones(2048)),
                                                 thr) is not None
    wide = stoch_vol(np.ones(2047, np.float32), device="cpu")
    assert NUTSKernel(wide).transition_factory(tdiag(torch.ones(2049)),
                                               thr) is None
    with pytest.raises(NotImplementedError, match="item 1 \\(h\\)"):
        NUTSKernel(wide, use_pallas="tree")


def test_synthetic_returns_stationary_init():
    """h_1 has the stationary sd s / sqrt(1 - phi^2): over 400 series the
    sd of r_1 is that of ``N(0, exp(h_1))``, ``sqrt(exp(sigma_h^2 / 2))``
    (``tests/test_stoch_vol.py::test_synthetic_returns_stationary_init``);
    the draws come from the generator alone (the same seed, the same
    series) in its dtype."""
    phi, s = 0.9, 0.2
    gen = torch.Generator().manual_seed(7)
    r1 = np.asarray([float(synthetic_returns(gen, 8, phi, s,
                                             torch.float64)[0])
                     for _ in range(400)])
    sig_h2 = s * s / (1.0 - phi * phi)
    expected_sd = math.sqrt(math.exp(sig_h2 / 2.0))
    assert abs(np.std(r1) - expected_sd) < 0.2 * expected_sd
    a = synthetic_returns(torch.Generator().manual_seed(3), 50)
    b = synthetic_returns(torch.Generator().manual_seed(3), 50)
    assert a.dtype == torch.float32 and a.shape == (50,)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
