"""Port parity, core pieces: bit arithmetic, metrics, Hamiltonian guard and
the leapfrog step of ``inplacedhmc_tpu_torch`` against ``inplacedhmc_tpu``.

Inputs are made with numpy from a seed and handed to both packages; float
comparisons run in float64 on the CPU, where the two must agree to
round-off (rtol 1e-12 unless a comment says otherwise)."""

import jax.numpy as jnp
import numpy as np
import pytest

import inplacedhmc_tpu.core.hamiltonian as jh
import inplacedhmc_tpu.core.metric as jm
import inplacedhmc_tpu.ops.integrator as ji
import inplacedhmc_tpu.utils.bits as jb
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.core.state import PhasePoint as JPhase
from inplacedhmc_tpu.core.state import Termination as JTerm


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, th, tm, ti, tb, TEval, TPhase, TTerm
    import torch
    import inplacedhmc_tpu_torch.core.hamiltonian as th
    import inplacedhmc_tpu_torch.core.metric as tm
    import inplacedhmc_tpu_torch.ops.integrator as ti
    import inplacedhmc_tpu_torch.utils.bits as tb
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.core.state import PhasePoint as TPhase
    from inplacedhmc_tpu_torch.core.state import Termination as TTerm
    torch.set_num_threads(1)


RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + 0.5 * np.eye(d)


# -- bits -------------------------------------------------------------------

def test_bits_match_jax_for_all_n_below_2_10():
    ns = np.arange(1 << 10, dtype=np.int32)
    for jf, tf in ((jb.popcount, tb.popcount),
                   (jb.trailing_ones, tb.trailing_ones),
                   (jb.checkpoint_slot, tb.checkpoint_slot)):
        want = np.asarray(jf(jnp.asarray(ns)))
        np.testing.assert_array_equal(tf(_t(ns)).numpy(), want)
        # the tree calls them with a Python int leaf index
        assert [tf(int(n)) for n in ns] == want.tolist()


def test_direction_bits_match_jax():
    rng = np.random.default_rng(0)
    flags = np.concatenate([rng.integers(0, 2 ** 32, size=64,
                                         dtype=np.uint32),
                            np.array([0, 0xFFFFFFFF], np.uint32)])
    for d in range(32):
        want = np.asarray(jb.direction_bit(jnp.asarray(flags),
                                           jnp.asarray(d, jnp.int32)))
        got = tb.direction_bit(_t(flags.astype(np.int64)), d).numpy()
        np.testing.assert_array_equal(got, want)


def test_termination_codes_match():
    for name in ("MAX_DEPTH", "DIVERGENCE", "TURNING"):
        assert getattr(TTerm, name) == getattr(JTerm, name)


# -- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["diag", "dense", "dense_per_chain"])
def test_kinetic_and_psharp_match_jax(kind):
    rng = np.random.default_rng(1)
    c, d = 9, 6
    p = rng.normal(size=(c, d))
    if kind == "diag":
        inv = rng.gamma(2.0, size=d) + 0.1
        jmet, tmet = jm.diag_metric(jnp.asarray(inv)), tm.diag_metric(_t(inv))
    elif kind == "dense":
        inv = _spd(rng, d)
        jmet, tmet = jm.dense_metric(jnp.asarray(inv)), tm.dense_metric(_t(inv))
    else:
        inv = np.stack([_spd(rng, d) for _ in range(c)])
        jmet, tmet = jm.dense_metric(jnp.asarray(inv)), tm.dense_metric(_t(inv))
    np.testing.assert_allclose(tm.kinetic_energy(tmet, _t(p)).numpy(),
                               np.asarray(jm.kinetic_energy(jmet,
                                                            jnp.asarray(p))),
                               rtol=RTOL)
    np.testing.assert_allclose(tm.psharp(tmet, _t(p)).numpy(),
                               np.asarray(jm.psharp(jmet, jnp.asarray(p))),
                               rtol=RTOL, atol=1e-14)
    if kind != "diag":
        # the momentum factor: A A^T = M = inv^-1, same A as the JAX package
        np.testing.assert_allclose(tmet.mass_chol.numpy(),
                                   np.asarray(jmet.mass_chol),
                                   rtol=1e-10, atol=1e-12)


def test_sample_momentum_has_mass_covariance():
    """p ~ N(0, M) for the dense metric: the empirical covariance of 2e5
    draws is within 3% (about 6 standard errors) of M."""
    rng = np.random.default_rng(2)
    d = 4
    inv = _spd(rng, d)
    met = tm.dense_metric(_t(inv))
    gen = torch.Generator().manual_seed(0)
    p = tm.sample_momentum(met, gen, (200_000, d), torch.float64).numpy()
    mass = np.linalg.inv(inv)
    np.testing.assert_allclose(np.cov(p.T), mass,
                               atol=0.03 * np.abs(mass).max())


@pytest.mark.parametrize("pooled", [True, False])
def test_regularized_estimators_match_jax(pooled):
    rng = np.random.default_rng(3)
    draws = rng.normal(size=(40, 5, 4)) * np.array([1.0, 3.0, 0.2, 1.0]) \
        + 7.0
    lam = 5.0 / 40
    np.testing.assert_allclose(
        tm.regularized_variance(_t(draws), lam, pooled=pooled).numpy(),
        np.asarray(jm.regularized_variance(jnp.asarray(draws), lam,
                                           pooled=pooled)), rtol=RTOL)
    np.testing.assert_allclose(
        tm.regularized_cov(_t(draws), lam, pooled=pooled).numpy(),
        np.asarray(jm.regularized_cov(jnp.asarray(draws), lam,
                                      pooled=pooled)),
        rtol=1e-10, atol=1e-13)
    got = tm.estimate_dense_metric(_t(draws), lam, pooled=pooled)
    want = jm.estimate_dense_metric(jnp.asarray(draws), lam, pooled=pooled)
    np.testing.assert_allclose(got.mass_chol.numpy(),
                               np.asarray(want.mass_chol),
                               rtol=1e-9, atol=1e-12)


# -- Hamiltonian ------------------------------------------------------------

def _special_logp_pair():
    """A density that is finite, NaN, +inf or -inf depending on the chain's
    first coordinate, in both frameworks."""
    def jlogp(q):
        base = -0.5 * jnp.sum(q * q)
        return jnp.where(q[0] > 10, jnp.nan,
                         jnp.where(q[0] > 5, jnp.inf,
                                   jnp.where(q[0] < -5, -jnp.inf, base)))

    def tlogp(q):
        base = -0.5 * torch.sum(q * q, dim=-1)
        return torch.where(q[..., 0] > 10, torch.nan, torch.where(
            q[..., 0] > 5, torch.inf,
            torch.where(q[..., 0] < -5, -torch.inf, base)))

    return jlogp, tlogp


def test_guarded_potential_matches_jax_with_nan_and_inf():
    jlogp, tlogp = _special_logp_pair()
    rng = np.random.default_rng(4)
    q = rng.normal(size=(8, 3))
    q[1, 0], q[2, 0], q[3, 0] = 20.0, 7.0, -7.0   # NaN, +inf, -inf
    jv, jg = jh.batched_logdensity_and_grad(jlogp)(jnp.asarray(q))
    tv, tg = th.batched_logdensity_and_grad(tlogp)(_t(q))
    np.testing.assert_array_equal(np.isfinite(tv.numpy()),
                                  np.isfinite(np.asarray(jv)))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL)
    assert np.all(tv.numpy()[1:4] == -np.inf)
    assert np.all(tg.numpy()[1:4] == 0.0)


def test_joint_logdensity_matches_jax_with_nonfinite_inputs():
    rng = np.random.default_rng(5)
    c, d = 6, 3
    p = rng.normal(size=(c, d))
    p[4, 1] = np.inf
    lp = rng.normal(size=c)
    lp[1], lp[2] = -np.inf, np.nan
    inv = rng.gamma(2.0, size=d) + 0.1
    want = jh.joint_logdensity(jm.diag_metric(jnp.asarray(inv)),
                               jnp.asarray(lp), jnp.asarray(p))
    got = th.joint_logdensity(tm.diag_metric(_t(inv)), _t(lp), _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("dense", [False, True])
def test_leapfrog_matches_jax(dense):
    rng = np.random.default_rng(6)
    c, d = 7, 5
    prec = rng.gamma(2.0, size=d) + 0.1
    q, p = rng.normal(size=(c, d)), rng.normal(size=(c, d))
    eps = rng.uniform(-0.5, 0.5, size=c)
    inv = _spd(rng, d) if dense else rng.gamma(2.0, size=d) + 0.1
    jmet = (jm.dense_metric if dense else jm.diag_metric)(jnp.asarray(inv))
    tmet = (tm.dense_metric if dense else tm.diag_metric)(_t(inv))
    jpot = jh.batched_logdensity_and_grad(
        lambda x: -0.5 * jnp.sum(jnp.asarray(prec) * x * x))
    tpot = th.batched_logdensity_and_grad(
        lambda x: -0.5 * torch.sum(_t(prec) * x * x, dim=-1))
    jz = JPhase(Q=jh.evaluate(jpot, jnp.asarray(q)), p=jnp.asarray(p))
    tz = TPhase(Q=th.evaluate(tpot, _t(q)), p=_t(p))
    jo = ji.leapfrog(jpot, jmet, jz, jnp.asarray(eps))
    to = ti.leapfrog(tpot, tmet, tz, _t(eps))
    for got, want in ((to.Q.q, jo.Q.q), (to.p, jo.p), (to.Q.logp, jo.Q.logp),
                      (to.Q.grad, jo.Q.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                                   atol=1e-13)
    assert isinstance(to.Q, TEval) and isinstance(jo.Q, JEval)
