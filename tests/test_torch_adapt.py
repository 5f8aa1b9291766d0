"""Port parity for adaptation: dual averaging, the initial step-size search
and the batched L-BFGS (``adapt/step_size.py``, ``adapt/optimize.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import inplacedhmc_tpu.adapt.optimize as jo
import inplacedhmc_tpu.adapt.step_size as js
from inplacedhmc_tpu.config import DualAveraging as JDA
from inplacedhmc_tpu.config import InitialStepsizeSearch as JSearch
from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.hamiltonian import evaluate as jeval
from inplacedhmc_tpu.core.metric import identity_metric as jident
from inplacedhmc_tpu.core.state import PhasePoint as JPhase


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, to, ts, TDA, TSearch, tbl, teval, tident, TPhase
    import torch
    import inplacedhmc_tpu_torch.adapt.optimize as to
    import inplacedhmc_tpu_torch.adapt.step_size as ts
    from inplacedhmc_tpu_torch.config import DualAveraging as TDA
    from inplacedhmc_tpu_torch.config import InitialStepsizeSearch as TSearch
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.hamiltonian import evaluate as teval
    from inplacedhmc_tpu_torch.core.metric import identity_metric as tident
    from inplacedhmc_tpu_torch.core.state import PhasePoint as TPhase
    torch.set_num_threads(1)


ACCEPTS = [0.91, 0.2, 0.65, 0.88, 0.79, 0.4]


def test_dual_averaging_matches_hand_computed_sequence_and_jax():
    """The recurrence of tests/test_adapt.py's numpy replica, and the JAX
    package's own, step for step."""
    params = TDA()
    eps0 = 0.37
    s = ts.da_init(params, torch.tensor([eps0, eps0], dtype=torch.float64))
    sj = js.da_init(JDA(), jnp.asarray([eps0, eps0]))
    mu = np.log(10) + np.log(eps0)
    h_bar, log_eps, log_eps_bar, m = 0.0, np.log(eps0), 0.0, 0
    for a in ACCEPTS:
        s = ts.da_update(params, s, torch.tensor([a, a], dtype=torch.float64))
        sj = js.da_update(JDA(), sj, jnp.asarray([a, a]))
        m += 1
        h_bar += (params.delta - a - h_bar) / (m + params.t0)
        log_eps = mu - np.sqrt(m) / params.gamma * h_bar
        log_eps_bar += m ** (-params.kappa) * (log_eps - log_eps_bar)
        for got, want in ((s.log_eps, log_eps), (s.log_eps_bar, log_eps_bar),
                          (s.log_eps, np.asarray(sj.log_eps)),
                          (s.log_eps_bar, np.asarray(sj.log_eps_bar))):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(float(ts.da_current_eps(s)[0]), np.exp(log_eps),
                               rtol=1e-12)
    np.testing.assert_allclose(float(ts.da_final_eps(s)[0]),
                               np.exp(log_eps_bar), rtol=1e-12)


def test_initial_stepsize_search_matches_jax():
    """The search is deterministic given the phase point: the port and the
    JAX package find the same per-chain eps on heterogeneous curvatures, and
    every eps lands in the acceptance band."""
    d, c = 4, 32
    scales = np.array([100.0, 1.0, 0.01, 1.0])
    rng = np.random.default_rng(0)
    q = rng.normal(size=(c, d)) * np.array([0.1, 1.0, 10.0, 1.0])
    p = rng.normal(size=(c, d))
    jpot = jbl(lambda x: -0.5 * jnp.sum(x * x * jnp.asarray(scales)))
    tpot = tbl(lambda x: -0.5 * torch.sum(x * x * torch.as_tensor(scales),
                                          dim=-1))
    jz = JPhase(Q=jeval(jpot, jnp.asarray(q)), p=jnp.asarray(p))
    tz = TPhase(Q=teval(tpot, torch.as_tensor(q)), p=torch.as_tensor(p))
    tmet = tident(d, torch.float64, "cpu")
    want = np.asarray(js.find_initial_stepsize(JSearch(), jpot,
                                               jident(d, jnp.float64), jz))
    got = ts.find_initial_stepsize(TSearch(), tpot, tmet, tz)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    a = ts.local_acceptance_ratio(tpot, tmet, tz)(got).numpy()
    assert np.all((a >= 0.25) & (a <= 0.75)), a


def test_lbfgs_matches_jax_on_batched_quadratics():
    rng = np.random.default_rng(1)
    d, c = 6, 10
    scales = rng.gamma(2.0, size=d) + 0.5
    q0 = rng.normal(size=(c, d)) * 5.0
    jq, jf, _ = jo.lbfgs_batched(
        jax.value_and_grad(lambda q: 0.5 * jnp.sum(jnp.asarray(scales) * q * q)),
        jnp.asarray(q0), iterations=100)
    sc = torch.as_tensor(scales)
    tq, tf, _ = to.lbfgs_batched(
        lambda q: (0.5 * torch.sum(sc * q * q, dim=-1), sc * q),
        torch.as_tensor(q0), iterations=100)
    assert np.all(tf.numpy() < 1e-6)
    np.testing.assert_allclose(tq.numpy(), 0.0, atol=1e-3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-10)


def test_lbfgs_rosenbrock_iterates_match_jax():
    """A curved valley where line searches backtrack and curvature pairs get
    skipped: each chain's path follows the vmapped JAX L-BFGS."""
    def jrosen(q):
        return jnp.sum(100.0 * (q[1:] - q[:-1] ** 2) ** 2 + (1 - q[:-1]) ** 2)

    def trosen(q):
        qq = q.detach().requires_grad_(True)
        with torch.enable_grad():
            f = torch.sum(100.0 * (qq[:, 1:] - qq[:, :-1] ** 2) ** 2
                          + (1 - qq[:, :-1]) ** 2, dim=-1)
            (g,) = torch.autograd.grad(f.sum(), qq)
        return f.detach(), g

    rng = np.random.default_rng(2)
    q0 = rng.uniform(-2, 2, size=(6, 3))
    for iters in (5, 200):
        jq, jf, _ = jo.lbfgs_batched(jax.value_and_grad(jrosen),
                                     jnp.asarray(q0), iterations=iters)
        tq, tf, _ = to.lbfgs_batched(trosen, torch.as_tensor(q0),
                                     iterations=iters)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-7,
                                   atol=1e-9)
    np.testing.assert_allclose(tq.numpy(), 1.0, atol=1e-4)
