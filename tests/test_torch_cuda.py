"""Tests of the port that need an NVIDIA card: the CUDA kernel K1
(``csrc/logistic_vg.cu``) against its plain torch version.

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
    global torch, LOGISTIC_VG, MAX_DIM, logistic_value_and_grad
    global logistic_value_and_grad_plain
    import torch
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, MAX_DIM, logistic_value_and_grad,
        logistic_value_and_grad_plain)


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
    wide = torch.zeros((4, MAX_DIM + 1), device="cuda")
    with pytest.raises(ValueError):
        logistic_value_and_grad(wide, torch.zeros((8, MAX_DIM + 1),
                                                  device="cuda"),
                                y[:8], w[:8], INV_VAR)
    assert LOGISTIC_VG.launches == before
