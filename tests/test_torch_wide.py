"""The whole-tree kernel above D = 256 (K5's wide form: one chain per block
of ``ceil(D / 256)`` warps, ``csrc/tree_kernel.cuh``) from the Python side:
what ``ops.tree.takes`` accepts at the bounds its launcher checks (D up to
``MAX_DIM`` for the Gaussian, the dense Gaussian and stochastic volatility,
the checkpoint stacks within the shared memory of one block; 256 for the
other physics), the routes and refusals that follow from it, and a CPU
``sample()`` of a 300-D normal through the whole-tree route, where the
kernel's wrapper runs its plain version.  The plain version against JAX's
interpret kernels at D = 300 is in ``tests/test_torch_gaussian.py``,
``tests/test_torch_dense.py`` and ``tests/test_torch_stoch_vol.py``; the
wide kernel against its plain version on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file: every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    small, JAX workers hold every core."""
    global torch, tree, conv, models, NUTS, NUTSKernel, sample, diag
    global default_warmup_stages, tdiag
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.models as models
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch import NUTS, default_warmup_stages, sample
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


@pytest.mark.parametrize("dim, max_depth, physics, takes", [
    (257, 10, "gaussian", True), (2048, 10, "gaussian", True),
    (2049, 10, "gaussian", False), (2048, 13, "gaussian", True),
    (2048, 14, "gaussian", False), (1000, 28, "dense_gaussian", True),
    (1000, 29, "dense_gaussian", False), (1002, 10, "stoch_vol", True),
    (2048, 14, "stoch_vol", False),
    (256, 30, "eight_schools", True),
    (257, 10, "eight_schools", False), (257, 10, "funnel", False),
    (257, 10, "logistic", False)])
def test_takes_at_the_kernel_bounds(dim, max_depth, physics, takes):
    """``takes(dim, max_depth, physics)`` at the launcher's bounds: any
    physics up to 256; above it only the three with a wide form, up to
    2,048, while ``4 (2 max_depth D + 2 D + 64)`` bytes (the stacks, the
    mat-vec's staging rows, the row sums' scratch) fit the 232,448 of one
    block (at D = 2,048 up to max_depth 13, at D = 1,000 up to 28);
    ``refusal`` names the bound and its ROADMAP item."""
    assert tree.takes(dim, max_depth, physics) == takes
    if dim <= tree.MAX_DIM:
        assert (tree.wide_smem_bytes(dim, max_depth) <= tree.SMEM_LIMIT) \
            == (max_depth <= {2048: 13, 1000: 28}.get(dim, max_depth))
    if not takes:
        why = tree.refusal(dim, max_depth, physics)
        item = "(g)" if physics not in tree.WIDE_PHYSICS else "(h)"
        assert f"item 1 {item}" in why, why
        if physics in tree.WIDE_PHYSICS and dim <= tree.MAX_DIM:
            assert "shared memory" in why and str(tree.SMEM_LIMIT) in why


def _funnel_300():
    return models.funnel(300, device="cpu")


def _logistic_300():
    rng = np.random.default_rng(0)
    return conv.model_from_numpy(rng.normal(size=(40, 300)).astype(np.float32),
                                 (rng.uniform(size=40) < 0.5)
                                 .astype(np.float32), 1.0, device="cpu")


@pytest.mark.parametrize("make", [_funnel_300, _logistic_300])
def test_physics_without_a_wide_form_refuse_above_one_warp(make):
    """The funnel and logistic regression keep K5 to D <= 256 (their wide
    forms are not ported): at D = 300 ``use_pallas="tree"`` raises
    ``NotImplementedError`` naming ROADMAP queue 2 item 1 (g), and the
    default route runs no whole tree."""
    model = make()
    with pytest.raises(NotImplementedError, match="item 1 \\(g\\)"):
        NUTSKernel(model, use_pallas="tree")
    kern = NUTSKernel(model)
    assert kern.transition_factory is None or kern.transition_factory(
        tdiag(torch.ones(300)), 16) is None


def test_sample_normal_above_one_warp_through_the_tree_route(monkeypatch):
    """``sample()`` on the 300-D standard normal, 16 chains, a short
    schedule, on the CPU: every transition of the tuning windows and of the
    sampling loop goes through the whole-tree route (K5's plain version,
    counted by its calls), as it runs K5's wide form on the card; the draws
    are finite, every coordinate's mean and variance within 5 Monte Carlo
    standard errors of 0 and 1 (from the draws' own ESS of q and of q^2),
    split R-hat < 1.05 and the acceptance near its 0.8 target."""
    calls = []
    real = tree.tree_transition_plain

    def counted(q0, *a, **kw):
        calls.append(q0.shape)
        return real(q0, *a, **kw)

    monkeypatch.setattr(tree, "tree_transition_plain", counted)
    stages = default_warmup_stages(init_steps=30, middle_steps=20,
                                   doubling_stages=2, terminating_steps=20)
    res = sample(3, models.std_normal(300, device="cpu"), 100, 16,
                 warmup_stages=stages, device="cpu",
                 algorithm=NUTS(max_depth=6))
    assert calls == [(16, 300)] * (30 + 20 + 40 + 20 + 100)
    x = res.draws.double()
    assert x.shape == (100, 16, 300) and bool(torch.isfinite(x).all())
    ess = diag.ess_bulk(x, cap=False)
    ess_sq = diag.ess_bulk(x * x, cap=False)
    mean = x.mean(dim=(0, 1))
    var = (x * x).mean(dim=(0, 1)) - mean ** 2
    assert float((mean.abs() * ess.sqrt()).max()) < 5
    assert float(((var - 1).abs() / (2.0 / ess_sq).sqrt()).max()) < 5
    assert float(diag.split_rhat(x).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95
