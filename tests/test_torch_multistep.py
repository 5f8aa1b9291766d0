"""Port parity for the multi-step leapfrog (K4,
``ops/leapfrog.py::multi_step_leapfrog``).

On the CPU the wrapper runs its plain version, held against JAX's
``multi_step_leapfrog(..., interpret=True)`` (its inputs lane-padded to 128
as JAX pads them) and against ``k`` chained plain steps of K3
(``fused_gaussian_leapfrog_plain``) bit for bit.  The kernel runs only on
the card: its tests are in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.ops.leapfrog_pallas import \
    multi_step_leapfrog as jmulti


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, lf
    import torch
    import inplacedhmc_tpu_torch.ops.leapfrog as lf
    torch.set_num_threads(1)


C = 16
#: K3's parity tolerances against JAX (tests/test_torch_gaussian.py)
F32_RTOL, F32_ATOL = 2e-6, 2e-5


def _inputs(seed, d, c=C):
    """q, p, signed per-chain step sizes of both signs, a precision and a
    diagonal M^-1, float32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c, d)).astype(np.float32)
    p = rng.normal(size=(c, d)).astype(np.float32)
    eps = (np.where(rng.uniform(size=c) < 0.5, -1.0, 1.0)
           * rng.uniform(0.05, 0.4, size=c)).astype(np.float32)
    lam = rng.gamma(2.0, size=d).astype(np.float32) + 0.1
    minv = (0.5 + rng.uniform(size=d)).astype(np.float32)
    return q, p, eps, lam, minv


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


@pytest.mark.parametrize("d", [7, 100])
@pytest.mark.parametrize("k", [1, 7])
def test_plain_matches_jax_interpret_and_chained_steps(d, k):
    """K4's plain version against ``k`` chained plain K3 steps bit for bit
    in float32 (the same operations in the same order), and against JAX's
    interpret kernel on the same lane-padded inputs to float32 round-off:
    XLA on the CPU fuses the step and contracts its multiply-adds into FMAs,
    so each step may differ by an ulp or two, held to the K3 parity
    tolerances of ``tests/test_torch_gaussian.py`` with the relative part
    scaled by ``k`` (JAX's ``p_mid - half (lam q')`` is the plain
    version's ``p_mid + half (-(lam q'))``: negation is exact).  The lanes
    past D stay zero on the JAX side."""
    q, p, eps, lam, minv = _inputs(d + k, d)
    got = lf.multi_step_leapfrog(*(torch.as_tensor(a)
                                   for a in (q, p, eps, lam, minv)), k)
    jq, jp = (np.asarray(a) for a in jmulti(
        jnp.asarray(_pad(q, C, 128)), jnp.asarray(_pad(p, C, 128)),
        jnp.asarray(eps[:, None]), jnp.asarray(_pad(lam[None], 1, 128)),
        jnp.asarray(_pad(minv[None], 1, 128)), k, block_c=8,
        interpret=True))
    chain = [torch.as_tensor(a) for a in (q, p)]
    for _ in range(k):
        chain = lf.fused_gaussian_leapfrog_plain(
            chain[0], chain[1], torch.as_tensor(eps), torch.as_tensor(lam),
            torch.as_tensor(minv))[:2]
    for name, g, j, c in zip(("q", "p"), got, (jq, jp), chain):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), j[:, :d], rtol=F32_RTOL * k,
                                   atol=F32_ATOL, err_msg=name)
        assert not np.any(j[:, d:]), name
        np.testing.assert_array_equal(g.numpy(), c.numpy(), err_msg=name)


def test_cpu_tensor_takes_plain_version_without_launching():
    q, p, eps, lam, minv = (torch.as_tensor(a) for a in _inputs(3, 5))
    before = lf.LEAPFROG_MULTISTEP.launches
    got = lf.multi_step_leapfrog(q, p, eps, lam, minv, np.int64(3))
    want = lf.multi_step_leapfrog_plain(q, p, eps, lam, minv, 3)
    assert lf.LEAPFROG_MULTISTEP.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0, -2, 2.0, True])
def test_refuses_step_counts_below_one_or_not_integers(k):
    """``k_steps`` must be an integer >= 1 on every device (JAX's
    ``fori_loop`` would return the inputs for 0)."""
    q, p, eps, lam, minv = (torch.as_tensor(a) for a in _inputs(4, 3))
    with pytest.raises(ValueError, match="k_steps"):
        lf.multi_step_leapfrog(q, p, eps, lam, minv, k)


def test_float64_plain_is_the_same_recursion():
    """In float64 the plain version is the velocity-Verlet recursion written
    out in numpy, to 1e-14 relative: the same operations in the same order
    (a check of the formula, independent of JAX)."""
    q, p, eps, lam, minv = (a.astype(np.float64) for a in _inputs(5, 9))
    k = 5
    got = lf.multi_step_leapfrog_plain(
        *(torch.as_tensor(a) for a in (q, p, eps, lam, minv)), k)
    e = eps[:, None]
    for _ in range(k):
        p_mid = p - 0.5 * e * lam * q
        q = q + e * minv * p_mid
        p = p_mid - 0.5 * e * lam * q
    np.testing.assert_allclose(got[0].numpy(), q, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(got[1].numpy(), p, rtol=1e-14, atol=1e-14)
