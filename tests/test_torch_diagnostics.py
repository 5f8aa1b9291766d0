"""Port parity for diagnostics (``diagnostics.py``) and for the numpy
conversion of model data and sampler state (``convert.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest

import inplacedhmc_tpu.diagnostics as jd
from inplacedhmc_tpu.adapt.warmup import init_warmup_state as jinit
from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.state import TreeStats as JStats
from inplacedhmc_tpu.models.logistic import logistic_regression as jlogistic


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, td, model_from_numpy, warmup_state_from_numpy
    global warmup_state_to_numpy, TStats, NUTSKernel
    import torch
    import inplacedhmc_tpu_torch.diagnostics as td
    from inplacedhmc_tpu_torch.convert import (model_from_numpy,
                                               warmup_state_from_numpy,
                                               warmup_state_to_numpy)
    from inplacedhmc_tpu_torch.core.state import TreeStats as TStats
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


def _ar1_draws(seed=0, n=400, c=6, d=3):
    """AR(1) chains with different correlations per coordinate and an offset
    chain, so R-hat, ESS and the Geyer truncation all have work to do."""
    rng = np.random.default_rng(seed)
    phi = np.array([0.0, 0.6, 0.95])[:d]
    x = np.zeros((n, c, d))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + rng.normal(size=(c, d))
    x[:, 0, :] += 0.3
    return x


@pytest.mark.parametrize("cap", [True, False])
@pytest.mark.parametrize("rank_normalize", [False, True])
def test_ess_bulk_matches_jax(cap, rank_normalize):
    x = _ar1_draws()
    want = np.asarray(jd.ess_bulk(jnp.asarray(x), cap=cap,
                                  rank_normalize=rank_normalize))
    got = td.ess_bulk(torch.as_tensor(x), cap=cap,
                      rank_normalize=rank_normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_split_rhat_and_ebfmi_match_jax():
    x = _ar1_draws(1, n=301)          # odd length: the split drops a draw
    np.testing.assert_allclose(td.split_rhat(torch.as_tensor(x)).numpy(),
                               np.asarray(jd.split_rhat(jnp.asarray(x))),
                               rtol=1e-12)
    e = x[:, :, 2]
    np.testing.assert_allclose(td.ebfmi(torch.as_tensor(e)).numpy(),
                               np.asarray(jd.ebfmi(jnp.asarray(e))),
                               rtol=1e-12)


def test_summarize_tree_statistics_matches_jax():
    rng = np.random.default_rng(2)
    n, c = 50, 8
    fields = dict(
        energy=rng.normal(size=(n, c)),
        acceptance_rate=rng.uniform(size=(n, c)),
        termination=rng.integers(0, 3, size=(n, c)).astype(np.int32),
        term_left=np.zeros((n, c), np.int32),
        term_right=np.zeros((n, c), np.int32),
        depth=rng.integers(0, 6, size=(n, c)).astype(np.int32),
        steps=rng.integers(1, 40, size=(n, c)).astype(np.int32))
    want = jd.summarize_tree_statistics(JStats(**{
        k: jnp.asarray(v) for k, v in fields.items()}))
    got = td.summarize_tree_statistics(TStats(**{
        k: torch.as_tensor(v) for k, v in fields.items()}))
    assert got.termination_counts == want.termination_counts
    assert got.depth_counts == want.depth_counts
    assert got.n == want.n
    np.testing.assert_allclose(got.acceptance_mean, want.acceptance_mean,
                               rtol=1e-12)
    np.testing.assert_allclose(list(got.acceptance_quantiles.values()),
                               list(want.acceptance_quantiles.values()),
                               rtol=1e-12)
    assert str(got).splitlines()[0] == str(want).splitlines()[0]


def test_convert_round_trip_from_jax_state():
    """A JAX model's data and warmup state carried over as numpy arrays give
    the port the same model, positions, metric and step size, and the port's
    potential reproduces the JAX cached log density and gradient."""
    import jax
    rng = np.random.default_rng(3)
    n, d, c = 120, 4, 5
    x = rng.normal(size=(n, d))
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    jm = jlogistic(jnp.asarray(x), jnp.asarray(y), prior_scale=3.0)
    a = rng.normal(size=(d, d))
    inv = a @ a.T / d + 0.5 * np.eye(d)
    js = jinit(jax.random.PRNGKey(0), jbl(jm.logp), d, c, jnp.float64,
               metric=jdense(jnp.asarray(inv)), eps=0.3)
    st = jm.structure
    tm = model_from_numpy(np.asarray(st["x"]), np.asarray(st["y"]),
                          st["inv_var"], device="cpu")
    pot = NUTSKernel(tm).potential
    ts = warmup_state_from_numpy(np.asarray(js.z.q), np.asarray(js.metric.inv),
                                 np.asarray(js.log_eps), device="cpu",
                                 potential=pot)
    np.testing.assert_allclose(tm.structure["inv_var"], st["inv_var"],
                               rtol=1e-15)
    out = warmup_state_to_numpy(ts)
    assert out["dense"]
    np.testing.assert_array_equal(out["q"], np.asarray(js.z.q))
    np.testing.assert_array_equal(out["metric_inv"], inv)
    np.testing.assert_array_equal(out["log_eps"], np.asarray(js.log_eps))
    np.testing.assert_allclose(out["logp"], np.asarray(js.z.logp), rtol=1e-12)
    np.testing.assert_allclose(out["grad"], np.asarray(js.z.grad), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ts.metric.mass_chol.numpy(),
                               np.asarray(js.metric.mass_chol), rtol=1e-10,
                               atol=1e-12)
