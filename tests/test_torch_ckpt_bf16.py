"""Port parity for K5's bfloat16 checkpoint stacks (``tree_opts``
``ckpt_bf16``; JAX's ``_make_kernel(..., ckpt_bf16=True)``).

On the CPU the kernel's wrapper runs its plain version, where a store
rounds the momentum sum and ``p#`` to bfloat16 and the turn checks read the
rounded values.  These tests hold it against JAX's interpret-mode kernels
built with ``ckpt_bf16=True`` on the same positions, momenta, direction
words and uniforms: the Gaussian's ``make_gaussian_tree_transition`` at
D = 7 and, where the card runs the wide form, at D = 300; stochastic
volatility's ``make_tree_transition`` with its ``tile_logp`` under a
diagonal and a dense metric.  Integer records must be equal; the float
fields are held to the bounds of the f32 tests of the same kernels
(``tests/test_torch_gaussian.py``: ``F32_RTOL``, ``F32_ATOL``;
``tests/test_torch_stoch_vol.py``: ``F32_K`` gamma_D of each field's
scale; ``tests/test_torch_dense.py`` for what JAX's split-bf16 dense
products move).  A bfloat16 rounding of the same float32 value is the same on both
sides (round to nearest even), so the stacks add no tolerance of their
own.  Also: the shared-memory bound with bfloat16 stacks (at D = 2,048,
max_depth up to 26 against 13) and the routes that take the option."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.models.stoch_vol import stoch_vol as jstoch_vol
from inplacedhmc_tpu.ops.tree_pallas import \
    make_gaussian_tree_transition as jgauss_tree
from inplacedhmc_tpu.ops.tree_pallas import make_tree_transition as jtree


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (see tests/test_torch_stoch_vol.py).  One torch
    thread: the tensors are tiny."""
    global torch, tree, tp, conv, NUTS, NUTSKernel, std_normal, stoch_vol
    global tdiag
    import torch
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch import NUTS, NUTSKernel
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.models import std_normal, stoch_vol
    torch.set_num_threads(1)


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
F32_RTOL, F32_ATOL = 2e-6, 2e-5     # tests/test_torch_gaussian.py
F32_K = 16.0                        # tests/test_torch_stoch_vol.py
DENSE_ACC_ATOL, DENSE_Q_TOL = 5e-4, 1e-4   # tests/test_torch_dense.py
PHI, S = 0.9, 0.3


def _gamma(n: int) -> float:
    nu = n * 2.0 ** -24
    return nu / (1.0 - nu)


def _assert_ints(out, jst, tag):
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} {tag}")


def _gauss_inputs(seed: int, c: int, d: int, md: int):
    rng = np.random.default_rng(seed)
    prec = (rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    minv = (rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    return dict(prec=prec, minv=minv,
                q0=rng.normal(size=(c, d)).astype(np.float32),
                p0=rng.normal(size=(c, d)).astype(np.float32),
                dirs=rng.integers(0, 2 ** 32, size=c, dtype=np.uint32),
                unif=rng.uniform(size=((1 << md) - 1 + md, c))
                .astype(np.float32), md=md)


def _gauss_both(r, eps, bf16: bool):
    """One transition through JAX's interpret kernel and the port's plain
    K5, both with or without bfloat16 stacks."""
    md, c = r["md"], r["q0"].shape[0]
    pot = jbl(lambda q: -0.5 * jnp.sum(q * (jnp.asarray(r["prec"]) * q)))
    lp, g = pot(jnp.asarray(r["q0"]))
    jz = JEval(q=jnp.asarray(r["q0"]), logp=lp, grad=g)
    jz2, jst = jgauss_tree(jnp.asarray(r["prec"]), jnp.asarray(r["minv"]),
                           max_depth=md, block_c=16, interpret=True,
                           ckpt_bf16=bf16)(
        jax.random.PRNGKey(0), jz, eps, directions=jnp.asarray(r["dirs"]),
        momentum=jnp.asarray(r["p0"]), _unif=jnp.asarray(r["unif"]))
    out = tree.gaussian_tree_transition(
        torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(r["dirs"].astype(np.int64)),
        torch.as_tensor(r["unif"]), torch.as_tensor(r["prec"]),
        torch.as_tensor(r["minv"]), md, -1000.0, ckpt_bf16=bf16)
    return jz2, jst, out


@pytest.mark.parametrize("seed,eps,d", [(0, 0.4, 7), (1, 0.1, 7),
                                        (2, 0.02, 7), (3, 0.05, 300)])
def test_gaussian_plain_matches_jax_kernel(seed, eps, d):
    """The plain K5 with ``ckpt_bf16`` against
    ``make_gaussian_tree_transition(..., interpret=True, ckpt_bf16=True,
    block_c=16, max_depth=5)``, at D = 7 and D = 300 (the card's wide
    form), at a mixed, a long and a deep step size: integer records equal,
    the float fields to ``F32_RTOL`` / ``F32_ATOL`` (the acceptance, a sum
    of exponentials of energy differences, to that of the energies)."""
    r = _gauss_inputs(seed, 16, d, 5)
    jz2, jst, out = _gauss_both(r, eps, True)
    _assert_ints(out, jst, f"eps {eps}, D = {d}")
    energy = np.asarray(jst.energy)
    np.testing.assert_allclose(out.energy.numpy(), energy, rtol=F32_RTOL,
                               atol=F32_ATOL)
    accept = tree.acceptance(out.log_sum_alpha, out.steps).numpy()
    np.testing.assert_array_less(
        np.abs(accept - np.asarray(jst.acceptance_rate)),
        2 * (F32_ATOL + F32_RTOL * np.abs(energy)))
    for got, want in ((out.q, jz2.q), (out.logp, jz2.logp),
                      (out.grad, jz2.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)
    assert int(out.steps.sum()) > 2 * len(r["q0"])


def test_bf16_stacks_agree_with_f32_stacks_in_termination():
    """Over 256 chains at D = 7 (max_depth 6, a long step size so that most
    trees end in U-turns), the trees with bfloat16 stacks end as the
    float32 ones do on at least 90 % of chains (the JAX package's own
    check, ``tests/test_tree_pallas.py``), and JAX's interpret kernel with
    bfloat16 stacks ends exactly as the port's plain version with them."""
    r = _gauss_inputs(7, 256, 7, 6)
    eps = 0.25
    _, jst, out = _gauss_both(r, eps, True)
    _assert_ints(out, jst, "bf16, 256 chains")
    f32 = tree.gaussian_tree_transition(
        torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
        torch.full((256,), eps, dtype=torch.float32),
        torch.as_tensor(r["dirs"].astype(np.int64)),
        torch.as_tensor(r["unif"]), torch.as_tensor(r["prec"]),
        torch.as_tensor(r["minv"]), 6, -1000.0)
    same = (out.term == f32.term) & (out.depth == f32.depth)
    assert float(same.double().mean()) >= 0.9
    assert int((out.term == 2).sum()) > 128


def _ints(out) -> np.ndarray:
    return np.stack([getattr(out, f).numpy() for f in PLAIN_INT])


def _jints(jst) -> np.ndarray:
    return np.stack([np.asarray(getattr(jst, f)) for f in INT_FIELDS])


@pytest.mark.parametrize("d", [1, 100])
def test_bf16_rounding_decides_turns_as_jax_kernel(d):
    """Inputs on which the rounding decides turns: 32 chains, max_depth 8
    and eps 0.005 (deep trees of many small subtrees, where a checkpoint's
    momentum sum is large against the sum the check subtracts it from),
    at D = 1 and at D = 100 with M^-1 1e-6 past coordinate 0 (so that
    coordinate 0 decides the turns, as at D = 1).  The plain K5's records
    with bfloat16 stacks differ from its float32 ones on some chains; JAX's
    interpret kernel with ``ckpt_bf16`` ends every chain as the plain
    version with it does (integer records equal, so on exactly those
    chains JAX's bfloat16 and float32 kernels differ too), and the floats
    agree to ``F32_RTOL`` / ``F32_ATOL``.  A version that skipped the
    rounding, or cut the mantissa instead of rounding it to nearest, ends
    some of those chains otherwise."""
    r = _gauss_inputs(0, 32, d, 8)
    r["minv"][1:] = 1e-6
    eps = 0.005
    jz2, jst, out = _gauss_both(r, eps, True)
    _, jst32, out32 = _gauss_both(r, eps, False)
    _assert_ints(out, jst, f"bf16, D = {d}")
    _assert_ints(out32, jst32, f"f32, D = {d}")
    flip = (_ints(out) != _ints(out32)).any(axis=0)
    assert int(flip.sum()) >= 1
    np.testing.assert_array_equal(
        (_jints(jst) != _jints(jst32)).any(axis=0), flip)
    for got, want in ((out.q, jz2.q), (out.logp, jz2.logp),
                      (out.grad, jz2.grad), (out.energy, jst.energy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)


def test_stack_store_rounds_to_nearest_even_as_jax():
    """``ops.tree.stack_store`` with ``ckpt_bf16``, bit for bit against
    JAX's ``astype(jnp.bfloat16)`` widened back (the TPU kernel's store),
    on halfway cases (ties to even, both ways, both signs), values just
    above and below a tie, float32 subnormals, signed zeros, the largest
    float32 values (which round to infinity) and infinities; and the two
    ties by hand: 1 + 2^-8 rounds down to 1, 1 + 3 * 2^-8 up to 1 + 2^-6,
    where cutting the mantissa gives 1 + 2^-7.  Without ``ckpt_bf16`` the
    value itself."""
    tie = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 3 * 2.0 ** -9, 255.5, 256.5 * 4]
    vals = np.array(
        tie + [-v for v in tie]
        + [1 + 2.0 ** -8 + 2.0 ** -20, 1 + 2.0 ** -8 - 2.0 ** -20,
           1e-40, -1e-40, 2.0 ** -149, 2.0 ** -126 * (1 + 2.0 ** -8),
           0.0, -0.0, 3.39e38, -3.4028235e38, np.inf, -np.inf,
           0.1, -123.456, 65504.0], dtype=np.float32)
    got = tree.stack_store(torch.as_tensor(vals), True).numpy()
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == 1.0 and got[1] == 1 + 2.0 ** -6
    same = tree.stack_store(torch.as_tensor(vals), False).numpy()
    np.testing.assert_array_equal(same.view(np.int32), vals.view(np.int32))


def _series(t: int, seed: int):
    rng = np.random.default_rng(seed)
    h = np.zeros(t)
    h[0] = rng.normal() * S / math.sqrt(1.0 - PHI * PHI)
    for i in range(1, t):
        h[i] = PHI * h[i - 1] + S * rng.normal()
    return h, rng.normal(size=t) * np.exp(0.5 * h), rng


def _sv_inputs(seed: int, t: int, c: int, md: int, dense: bool):
    """One transition's inputs, as tests/test_torch_stoch_vol.py draws
    them: positions about the truth, M^-1 ``0.5 + U(0, 1)`` (a tenth on the
    hyperparameters) or that plus a small symmetric part."""
    h, r, rng = _series(t, seed)
    d = t + 2
    q0 = np.concatenate([
        math.atanh(PHI) + 0.2 * rng.normal(size=(c, 1)),
        math.log(S) + 0.2 * rng.normal(size=(c, 1)),
        h + 0.3 * rng.normal(size=(c, t))], axis=1).astype(np.float32)
    minv = (0.5 + rng.uniform(size=d)).astype(np.float32)
    minv[:2] *= np.float32(0.1)
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


def _sv_scales(q, data, logp, energy):
    """``tests/test_torch_stoch_vol.py::_terms``: per chain (float64) the
    magnitudes of the log density's terms, of each gradient component's,
    and ``1 + |q|``; the energy's adds the kinetic energy."""
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
    kin = np.abs(np.asarray(logp, np.float64)
                 - np.asarray(energy, np.float64))
    return {"q": 1.0 + np.abs(q), "logp": lp, "grad": g, "energy": lp + kin}


@pytest.mark.parametrize("dense", [False, True])
def test_stoch_vol_plain_matches_jax_kernel(dense):
    """The plain K5 with the ``stoch_vol`` physics and ``ckpt_bf16``
    against ``make_tree_transition(tile_logp, ..., interpret=True,
    ckpt_bf16=True, block_c=16, max_depth=6)`` at T = 21, under a diagonal
    and a dense metric, with the same q0, momentum, direction words and
    uniforms: integer records equal; under the diagonal metric the float
    fields within ``F32_K`` gamma_D of their scales; under the dense one,
    whose products JAX takes as 3-pass split-bf16, the proposal and the
    acceptance by ``tests/test_torch_dense.py``'s rule and the log density
    and energy within ``F32_K`` gamma_D of their scales."""
    x = _sv_inputs(4, 21, 16, 6, dense)
    eps = 0.05
    jm = jstoch_vol(x["r"])
    c, d = x["q0"].shape
    jz = JEval(q=jnp.asarray(x["q0"]), logp=jnp.zeros(c),
               grad=jnp.zeros_like(jnp.asarray(x["q0"])))
    minv = jnp.asarray(x["minv"])
    jz2, jst = jtree(jm.structure["tile_logp"], jm.structure["data"], d,
                     jdense(minv) if dense else minv, max_depth=x["md"],
                     block_c=16, interpret=True, ckpt_bf16=True)(
        jax.random.PRNGKey(0), jz, eps, directions=jnp.asarray(x["dirs"]),
        momentum=jnp.asarray(x["p0"]), _unif=jnp.asarray(x["unif"]))
    cm = conv.tile_model_from_numpy("stoch_vol", jm.structure["data"], d,
                                    scalars={"t": d - 2}, device="cpu")
    st = cm.structure
    data = {**st["data"], **st["scalars"]}
    phys = tp.bind("stoch_vol", data, "cpu", torch.float32)
    out = tree.tree_transition(
        torch.as_tensor(x["q0"]), torch.as_tensor(x["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(x["dirs"].astype(np.int64)),
        torch.as_tensor(x["unif"]), phys, torch.as_tensor(x["minv"]),
        x["md"], -1000.0, ckpt_bf16=True)
    _assert_ints(out, jst, f"stoch_vol dense={dense}")
    gam = F32_K * _gamma(d)
    scales = _sv_scales(np.asarray(jz2.q), {k: np.asarray(v) if not
                                           isinstance(v, float) else v
                                           for k, v in data.items()},
                        np.asarray(jz2.logp), np.asarray(jst.energy))
    fields = [("logp", out.logp, jz2.logp), ("energy", out.energy,
                                              jst.energy)]
    if dense:
        # JAX's dense products are 3-pass split-bf16, about 2^-16 relative
        # each: tests/test_torch_dense.py's rule for the proposal and the
        # acceptance
        np.testing.assert_allclose(out.q.numpy(), np.asarray(jz2.q),
                                   rtol=DENSE_Q_TOL, atol=DENSE_Q_TOL)
        np.testing.assert_allclose(
            tree.acceptance(out.log_sum_alpha, out.steps).numpy(),
            np.asarray(jst.acceptance_rate), atol=DENSE_ACC_ATOL)
    else:
        fields += [("q", out.q, jz2.q), ("grad", out.grad, jz2.grad)]
    for f, got, want in fields:
        g = got.numpy().astype(np.float64)
        w = np.asarray(want, np.float64)
        ratio = np.abs(g - w) / (gam * scales[f])
        assert float(ratio.max()) <= 1.0, (f, float(ratio.max()))
    assert int(out.steps.sum()) > 4 * c


@pytest.mark.parametrize("md,f32,bf16", [(13, True, True), (14, False, True),
                                         (26, False, True),
                                         (27, False, False)])
def test_takes_and_refusal_at_2048(md, f32, bf16):
    """At D = 2,048 the wide form's block holds float32 stacks up to
    max_depth 13 and bfloat16 ones up to 26 (``wide_smem_bytes`` <= the
    232,448 bytes of a block's shared memory); the refusal names the bytes,
    the stack type and ROADMAP item 1 (h)."""
    for physics in ("gaussian", "dense_gaussian", "stoch_vol"):
        assert tree.takes(2048, md, physics) is f32
        assert tree.takes(2048, md, physics, ckpt_bf16=True) is bf16
    assert not tree.takes(2048, md, "funnel", ckpt_bf16=True)
    for stacks in (False, True):
        if not tree.takes(2048, md, "gaussian", ckpt_bf16=stacks):
            msg = tree.refusal(2048, md, "gaussian", ckpt_bf16=stacks)
            assert str(tree.wide_smem_bytes(2048, md, stacks)) in msg
            assert ("bfloat16" if stacks else "float32") in msg
            assert "item 1 (h)" in msg
    assert tree.wide_smem_bytes(2048, md, True) \
        == 2 * md * 2048 * 2 + 4 * (64 + 2 * 2048)
    # the stacks' region rounds up to 16 bytes: 2 md D x 2 at D = 257,
    # md = 5 is 5,140 bytes, 5,152 with the rounding
    assert tree.stack_bytes(257, 5, True) == 5152
    assert tree.stack_bytes(257, 5, False) == 10288


def test_routes_take_ckpt_bf16():
    """``tree_opts={"ckpt_bf16": True}`` reaches the whole-tree transition
    (the plain K5 then stores bfloat16), and lifts the bound of the route:
    at D = 2,048 and max_depth 20 ``use_pallas="tree"`` takes the normal
    with bfloat16 stacks and refuses it without them."""
    m = std_normal(2048, device="cpu")
    with pytest.raises(NotImplementedError, match="item 1 \\(h\\)"):
        NUTSKernel(m, NUTS(max_depth=20), use_pallas="tree")
    kern = NUTSKernel(m, NUTS(max_depth=20), use_pallas="tree",
                      tree_opts={"ckpt_bf16": True})
    assert kern.transition_factory(tdiag(torch.ones(2048)), 4) is not None
    small = NUTSKernel(std_normal(5, device="cpu"), NUTS(max_depth=4),
                       tree_opts={"ckpt_bf16": True})
    seen = []
    real = tree.tree_transition_plain

    def spy(*a, **kw):
        seen.append(a[10])
        return real(*a, **kw)

    tree.tree_transition_plain = spy
    try:
        trans = small.transition_factory(tdiag(torch.ones(5)), 3)
        from inplacedhmc_tpu_torch.core.state import EvalPoint
        q = torch.zeros((3, 5))
        trans(torch.Generator().manual_seed(0),
              EvalPoint(q, torch.zeros(3), q), torch.tensor(0.3))
    finally:
        tree.tree_transition_plain = real
    assert seen == [True]
