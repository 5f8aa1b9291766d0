"""The port's main path as a whole, on the CPU, and its isolation from JAX.

``mcmc_with_warmup(device="cpu")`` on the logistic golden fixture must meet
the JAX package's own 5-standard-error moment pins (tests/test_golden.py);
``sample()`` with the dense-metric schedule of the H100 smoke run must
recover the coefficients at a small size; and the port plus
``chip_smoke.py`` must import with JAX made unimportable."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.models import synthetic_data as jax_synthetic_data


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, default_warmup_stages, mcmc_with_warmup, diag, sample
    global logistic_regression, synthetic_data, LOGISTIC_VG
    import torch
    from inplacedhmc_tpu_torch import default_warmup_stages, mcmc_with_warmup
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch import sample
    from inplacedhmc_tpu_torch.models import logistic_regression, synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG
    torch.set_num_threads(1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_moments(draws, golden_mean, golden_sd, label):
    """tests/test_golden.py's pin: the empirical mean within 5 MC standard
    errors (from the draws' own bulk ESS) plus one f32 ulp of scale."""
    ess = float(diag.ess_bulk(draws[:, :, None].double(), cap=False)[0])
    emp = float(draws.double().mean())
    se = golden_sd / np.sqrt(max(ess, 1.0))
    tol = 5.0 * se + max(abs(golden_mean), golden_sd) * 2.0 ** -23
    assert abs(emp - golden_mean) < tol, \
        f"{label}: emp {emp:.4f} vs golden {golden_mean:.4f} " \
        f"(tol {tol:.4f}, ess {ess:.0f})"


def test_logistic_matches_is_golden():
    with open(os.path.join(REPO, "tests", "golden",
                           "logistic_500x8.json")) as f:
        g = json.load(f)
    x, y, _ = jax_synthetic_data(jax.random.PRNGKey(g["data_key"]),
                                 g["n_obs"], g["n_feat"], jnp.float32)
    model = logistic_regression(np.asarray(x), np.asarray(y),
                                prior_scale=g["prior_scale"], device="cpu")
    before = LOGISTIC_VG.launches
    res = mcmc_with_warmup(5, model, 600, 16, device="cpu")
    assert LOGISTIC_VG.launches == before    # the CPU runs the plain version
    q = res.draws
    assert q.shape == (600, 16, g["n_feat"]) and q.dtype == torch.float32
    for j in range(g["n_feat"]):
        _assert_moments(q[:, :, j], g["beta_mean"][j], g["beta_sd"][j],
                        f"beta_{j}")
        emp_sd = float(q[:, :, j].double().std())
        assert abs(emp_sd - g["beta_sd"][j]) < 0.3 * g["beta_sd"][j], \
            (j, emp_sd, g["beta_sd"][j])


def test_sample_dense_schedule_recovers_coefficients():
    """The smoke run's schedule (dense metric, 50/50/100/50 windows) at 64
    chains on 2000 x 6 data."""
    x, y, beta = synthetic_data(3, 2000, 6, device="cpu")
    model = logistic_regression(x, y, device="cpu")
    stages = default_warmup_stages(init_steps=50, middle_steps=50,
                                   doubling_stages=2, terminating_steps=50,
                                   metric="dense")
    res = sample(4, model, 64, 64, warmup_stages=stages, device="cpu")
    assert bool(torch.isfinite(res.draws).all())
    assert res.warmup_state.metric.inv.shape == (6, 6)
    assert res.warmup_stats.steps.shape == (250, 64)
    assert float(diag.split_rhat(res.draws.double()).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95
    corr = np.corrcoef(res.draws.double().mean(dim=(0, 1)).numpy(),
                       beta.numpy())[0, 1]
    assert corr > 0.95


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"warmup_checkpoint_path": "x"},
    {"collect_sketch": object()}, {"tuning_chunk": 5}, {"thin": 2},
    {"use_kernels": "tree"}])
def test_options_not_ported_are_refused(option):
    model = logistic_regression(np.zeros((4, 2), np.float32),
                                np.zeros(4, np.float32), device="cpu")
    with pytest.raises(NotImplementedError):
        sample(0, model, 2, 2, device="cpu", **option)


def test_entry_points_default_to_cuda():
    import inspect

    from inplacedhmc_tpu_torch.adapt.warmup import init_warmup_state
    from inplacedhmc_tpu_torch.convert import (model_from_numpy,
                                               warmup_state_from_numpy)
    from inplacedhmc_tpu_torch.core.metric import identity_metric
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    for fn in (mcmc_with_warmup, synthetic_data, logistic_regression,
               model_from_numpy, warmup_state_from_numpy, identity_metric,
               init_warmup_state, NUTSKernel.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__


def test_port_imports_without_jax():
    """With ``jax`` and the JAX package unimportable, the port and
    ``chip_smoke.py`` import; and no source of the port names either."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['inplacedhmc_tpu'] = None; "
            "import inplacedhmc_tpu_torch, inplacedhmc_tpu_torch.sample, "
            "inplacedhmc_tpu_torch.convert, inplacedhmc_tpu_torch.diagnostics,"
            " chip_smoke; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    bad = re.compile(r"inplacedhmc_tpu\.|import jax|from jax")
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "inplacedhmc_tpu_torch")):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith((".py", ".cu"))]
    for path in sources:
        with open(path) as f:
            hits = [ln for ln in f if bad.search(ln)]
        assert not hits, (path, hits)
