"""Port parity for the fused logistic potential (``ops/logistic.py``, the
module that holds the CUDA kernel K1).

On the CPU the wrapper runs the kernel's plain version; it is held against
the JAX Pallas kernel in interpret mode and against JAX autodiff of
``model.logp``, on ragged shapes (C=33, N=300, D=7) with a NaN chain.  The
kernel itself runs only on the card: its tests are in
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad
from inplacedhmc_tpu.models.logistic import logistic_regression as jlogistic
from inplacedhmc_tpu.ops.logistic_pallas import make_logistic_potential as jmake


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, tlogistic, check_tensor, LOGISTIC_VG, logistic_value_and_grad
    global logistic_value_and_grad_plain, make_logistic_potential, NUTSKernel
    global tbatched_logdensity_and_grad, tlogistic_ops
    import torch
    import inplacedhmc_tpu_torch.ops.logistic as tlogistic_ops
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbatched_logdensity_and_grad
    from inplacedhmc_tpu_torch.models.logistic import \
        logistic_regression as tlogistic
    from inplacedhmc_tpu_torch.ops.common import check_tensor
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, logistic_value_and_grad, logistic_value_and_grad_plain,
        make_logistic_potential)
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


C, N, D = 33, 300, 7
INV_VAR = 0.01


def _data(seed=0, dtype=np.float32, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(dtype)
    beta = rng.normal(size=d) * 0.5 * min(1.0, np.sqrt(D / d))
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-x @ beta))).astype(dtype)
    q = (beta + 0.3 * min(1.0, np.sqrt(D / d))
         * rng.normal(size=(C, d))).astype(dtype)
    q[5, 2] = np.nan
    return x, y, q


def _plain_against_pallas_interpret(d):
    x, y, q = _data(d=d)
    jpot = jmake(jnp.asarray(x), jnp.asarray(y), INV_VAR, block_c=64,
                 block_n=256, interpret=True)
    jlp, jg = (np.asarray(a) for a in jpot(jnp.asarray(q)))
    tlp, tg = logistic_value_and_grad_plain(
        torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(y),
        torch.ones(N), INV_VAR)
    tlp, tg = tlp.numpy(), tg.numpy()
    assert tlp[5] == -np.inf and jlp[5] == -np.inf
    assert np.all(tg[5] == 0) and np.all(jg[5] == 0)
    np.testing.assert_allclose(tlp, jlp, rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(tg, jg, atol=2e-3 * np.abs(jg).max())


def test_plain_matches_pallas_interpret_kernel():
    """f32 on both sides.  The Pallas kernel's forward is a 3-pass
    split-bf16 product (f32-grade eta) and its backward a 1-pass bf16
    product, so: logp to 2e-5 relative + 2e-3 absolute (f32 sums of 300
    terms), grad to 2e-3 of its largest component (the bf16 backward),
    the bounds of the JAX package's own kernel test."""
    _plain_against_pallas_interpret(D)


def test_plain_matches_pallas_interpret_kernel_at_d300():
    """The same at D = 300, above the 256 that the port's kernel once
    refused (JAX's pads D to 384 lanes and takes any D); the coefficients
    and the chains' spread are scaled by sqrt(7 / 300), so that eta keeps
    the scale of the D = 7 case."""
    _plain_against_pallas_interpret(300)


def test_potential_takes_d300():
    """``make_logistic_potential`` at D = 300 refuses nothing: on the CPU
    it evaluates the plain version, and the plane that the card's launch
    reads (any D: chunks of 64 dimensions) is made for it and holds X."""
    x, y, q = _data(6, d=300)
    q[5, 2] = 0.3
    pot = make_logistic_potential(torch.as_tensor(x), torch.as_tensor(y),
                                  INV_VAR)
    lp, g = pot(torch.as_tensor(q))
    want = logistic_value_and_grad_plain(
        torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(y),
        torch.ones(N), INV_VAR)
    torch.testing.assert_close(lp, want[0], rtol=0, atol=0)
    torch.testing.assert_close(g, want[1], rtol=0, atol=0)
    assert not hasattr(tlogistic_ops, "MAX_DIM")
    for form in ("f32", "grad_bf16"):
        plane = tlogistic_ops.logistic_planes(
            torch.as_tensor(x), torch.as_tensor(y), torch.ones(N), form)
        assert tuple(plane.shape) == tlogistic_ops.plane_shape(N, 300, form)
        assert plane.shape[:2] == (10, 5)   # 300 rows in tiles of 32, 5
        #                                     chunks of 64 dimensions


def test_plain_matches_jax_autodiff_in_float64():
    """In float64 the plain version and autodiff of the JAX model's logp are
    the same function to round-off."""
    x, y, q = _data(1, np.float64)
    jmodel = jlogistic(jnp.asarray(x), jnp.asarray(y), prior_scale=10.0)
    jlp, jg = (np.asarray(a) for a in batched_logdensity_and_grad(
        jmodel.logp)(jnp.asarray(q)))
    pot = make_logistic_potential(torch.as_tensor(x), torch.as_tensor(y),
                                  INV_VAR)
    tlp, tg = (a.numpy() for a in pot(torch.as_tensor(q)))
    np.testing.assert_array_equal(np.isfinite(tlp), np.isfinite(jlp))
    np.testing.assert_allclose(tlp, jlp, rtol=1e-12)
    np.testing.assert_allclose(tg, jg, rtol=1e-10, atol=1e-10)


def test_port_model_logp_matches_jax_model():
    """The port's model density (its autograd path) equals the JAX one."""
    x, y, q = _data(2, np.float64)
    q[5, 2] = 0.1
    jm = jlogistic(jnp.asarray(x), jnp.asarray(y))
    tm = tlogistic(x, y, device="cpu")
    np.testing.assert_allclose(tm.logp(torch.as_tensor(q)).numpy(),
                               np.asarray(jax.vmap(jm.logp)(jnp.asarray(q))),
                               rtol=1e-12)
    assert tm.dim == jm.dim and tm.structure["kind"] == "logistic"


def test_kernel_routes_logistic_to_fused_potential_equal_to_autograd():
    """``NUTSKernel`` evaluates a logistic model through the fused wrapper
    (no autograd graph); in float64 it agrees with autograd of the model's
    logp, the NaN chain's guard included."""
    x, y, q = _data(5, np.float64)
    model = tlogistic(x, y, device="cpu")
    fused = NUTSKernel(model).potential(torch.as_tensor(q))
    auto = tbatched_logdensity_and_grad(model.logp)(torch.as_tensor(q))
    assert fused[0][5] == -torch.inf and auto[0][5] == -torch.inf
    assert not fused[0].requires_grad
    for a, b in zip(fused, auto):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-10)


def test_cpu_tensor_takes_plain_version_without_launching():
    x, y, q = (torch.as_tensor(a) for a in _data(3))
    before = LOGISTIC_VG.launches
    got = logistic_value_and_grad(q, x, y, torch.ones(N), INV_VAR)
    want = logistic_value_and_grad_plain(q, x, y, torch.ones(N), INV_VAR)
    assert LOGISTIC_VG.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_check_refuses_what_a_kernel_cannot_read():
    """The check every kernel wrapper makes before it hands a raw pointer
    to a kernel: dtype, shape, contiguity and device."""
    cpu = torch.device("cpu")
    good = torch.zeros((3, 4))
    check_tensor("k", "q", good, (3, 4), cpu)
    for bad, shape, dev in ((good.double(), (3, 4), cpu),
                            (good, (4, 3), cpu),
                            (torch.zeros((4, 3)).t(), (3, 4), cpu),
                            (good, (3, 4), torch.device("meta"))):
        with pytest.raises(ValueError):
            check_tensor("k", "q", bad, shape, dev)
