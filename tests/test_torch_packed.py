"""Port parity for the packed split-bf16 logistic forward (K2,
``ops/logistic.py::logistic_value_and_grad_packed``), K1's ``grad_bf16`` and
the ``fused_opts`` that reach them.

On the CPU the wrappers run their plain versions; they are held against
JAX's ``make_logistic_potential(..., interpret=True)`` with the same
options, against a float64 numpy evaluation of the same three products, and
one lockstep transition with the packed potential against JAX's
``nuts_transition`` over JAX's packed potential.  The kernels run only on
the card: their tests are in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import inplacedhmc_tpu.ops.logistic_pallas as jlp
from inplacedhmc_tpu.core.metric import diag_metric as jdiag
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.nuts.tree import nuts_transition as jnuts


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, L, NUTSKernel, tdiag, TEval, tnuts
    global default_warmup_stages, sample
    global logistic_regression, std_normal
    import torch
    import inplacedhmc_tpu_torch.ops.logistic as L
    from inplacedhmc_tpu_torch import default_warmup_stages, sample
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.models import logistic_regression, std_normal
    from inplacedhmc_tpu_torch.nuts.tree import nuts_transition as tnuts
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


C, N = 40, 500
INV_VAR = 0.01
PACKED = {"fwd_precision": "packed"}
#: JAX's interpret-mode potentials, built once per (D, options) for the
#: module: each is a compile
_JAX_POTENTIALS: dict = {}


def _data(seed, d, n=N, c=C, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    beta = rng.normal(size=d) * 0.5 / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ beta))).astype(dtype)
    q = (beta + 0.3 * rng.normal(size=(c, d)) / np.sqrt(d)).astype(dtype)
    return x, y, q


def _jax_potential(x, y, d, **opts):
    key = (d, x.shape[0], tuple(sorted(opts.items())))
    if key not in _JAX_POTENTIALS:
        _JAX_POTENTIALS[key] = jlp.make_logistic_potential(
            jnp.asarray(x), jnp.asarray(y), INV_VAR, block_c=64, block_n=256,
            interpret=True, **opts)
    return _JAX_POTENTIALS[key]


def _port_potential(x, y, **opts):
    return L.make_logistic_potential(torch.as_tensor(x), torch.as_tensor(y),
                                     INV_VAR, **opts)


def _bits(a):
    """The 16-bit words of a bfloat16 array (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _awkward(shape, rng):
    """float32 values with bfloat16 ties (low 16 bits 0x8000, with even and
    odd upper halves), ties of the remainder, zeros of both signs and large
    magnitudes, among normals.  No subnormals: XLA on the CPU flushes them
    to zero (the remainder of 1e-39 is +0 there, -0 in torch and on the
    card)."""
    v = rng.normal(size=shape).astype(np.float32)
    bits = v.view(np.uint32)
    flat = bits.reshape(-1)
    k = flat.size
    flat[0:k:7] = (flat[0:k:7] & 0xFFFF0000) | 0x8000      # hi ties
    flat[1:k:11] = (flat[1:k:11] & 0xFFFF0000) | 0x0080    # lo ties
    v = bits.view(np.float32)
    vf = v.reshape(-1)
    vf[2:k:13] = 0.0
    vf[3:k:17] = -0.0
    vf[4:k:19] = 3.0e38
    vf[5:k:23] = -1.5e37
    return v


def test_split_and_packed_layouts_equal_jax_bit_for_bit(monkeypatch):
    """The port's bfloat16 halves of q and X equal the operands JAX's
    packed kernel is handed (``qp = [q_hi | q_lo]``, ``xp = [x_hi | x_hi]``,
    ``xl = [x_lo | 0]`` over 128 lanes, captured at the call), bit for bit,
    on values with bf16 ties, signed zeros and large magnitudes."""
    rng = np.random.default_rng(0)
    d, c, n = 19, C, N   # the shapes of a case below: one compile for both
    x = _awkward((n, d), rng)
    q = _awkward((c, d), rng)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    seen = {}
    real = jlp._logistic_value_and_grad_packed

    def spy(q_p, qp, xp, xl, *rest, **kw):
        seen.update(qp=np.asarray(qp), xp=np.asarray(xp), xl=np.asarray(xl))
        return real(q_p, qp, xp, xl, *rest, **kw)

    monkeypatch.setattr(jlp, "_logistic_value_and_grad_packed", spy)
    jpot = jlp.make_logistic_potential(jnp.asarray(x), jnp.asarray(y),
                                       INV_VAR, block_c=64, block_n=256,
                                       interpret=True, fwd_precision="packed")
    jpot(jnp.asarray(q))
    x_hi, x_lo = L.split_bf16(torch.as_tensor(x))
    q_hi, q_lo = L.split_bf16(torch.as_tensor(q))

    def lanes(shape, *parts):
        out = torch.zeros(shape, dtype=torch.bfloat16)
        for lane, a in parts:
            out[:a.shape[0], lane:lane + d] = a
        return out

    want = {"xp": lanes(seen["xp"].shape, (0, x_hi), (64, x_hi)),
            "xl": lanes(seen["xl"].shape, (0, x_lo)),
            "qp": lanes(seen["qp"].shape, (0, q_hi), (64, q_lo))}
    for name, a in want.items():
        np.testing.assert_array_equal(_bits(a), _bits(seen[name]),
                                      err_msg=name)
    # and against JAX's own split of the same arrays
    for got, arr in ((x_hi, x), (q_hi, q)):
        jhi, jlo = jlp._split_bf16(jnp.asarray(arr))
        np.testing.assert_array_equal(_bits(got), _bits(jhi))
    np.testing.assert_array_equal(_bits(x_lo),
                                  _bits(jlp._split_bf16(jnp.asarray(x))[1]))


@pytest.mark.parametrize("d", [1, 19, 50, 64])
def test_packed_plain_matches_jax_packed_interpret(d):
    """The port's packed potential (its plain version, on the CPU) against
    JAX's ``fwd_precision="packed"`` kernel in interpret mode, float32 on
    both sides, with a NaN chain: logp to 2e-5 relative + 2e-3 absolute,
    grad to 2e-3 of its largest component, the tolerances of
    ``tests/test_torch_logistic.py`` (both sides sum exact bf16 products in
    float32, in other orders)."""
    x, y, q = _data(10 + d, d)
    q[5, 0] = np.nan
    spy = []
    real = L.logistic_value_and_grad_packed_plain

    def count(*a, **kw):
        spy.append(1)
        return real(*a, **kw)

    jlp_, jg = (np.asarray(a) for a in _jax_potential(x, y, d, **PACKED)(
        jnp.asarray(q)))
    L.logistic_value_and_grad_packed_plain = count
    try:
        tlp, tg = (a.numpy() for a in _port_potential(x, y, **PACKED)(
            torch.as_tensor(q)))
    finally:
        L.logistic_value_and_grad_packed_plain = real
    assert spy == [1]
    assert tlp[5] == -np.inf and jlp_[5] == -np.inf
    assert np.all(tg[5] == 0) and np.all(jg[5] == 0)
    np.testing.assert_allclose(tlp, jlp_, rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(tg, jg, atol=2e-3 * np.abs(jg).max())


@pytest.mark.parametrize("d", [7, 64])
def test_packed_plain_float64_equals_the_three_products(d):
    """In float64 the plain version on the widened bf16 operands is a
    numpy float64 evaluation of ``q_hi x_hi + q_lo x_hi + q_hi x_lo`` and the
    rest of the density, to 1e-12 relative (the halves are exact in
    float64)."""
    x, y, q = _data(3 + d, d, c=12, n=200)
    qt, xt = torch.as_tensor(q), torch.as_tensor(x)
    x_hi, x_lo = L.split_bf16(xt)
    q_hi, q_lo = (t.double().numpy() for t in L.split_bf16(qt))
    xh, xl = x_hi.double().numpy(), x_lo.double().numpy()
    q64, x64, y64 = (a.astype(np.float64) for a in (q, x, y))
    eta = q_hi @ xh.T + q_lo @ xh.T + q_hi @ xl.T
    ll = y64 * eta - np.logaddexp(0.0, eta)
    want_lp = ll.sum(1) - 0.5 * INV_VAR * (q64 * q64).sum(1)
    resid = y64 - 1.0 / (1.0 + np.exp(-eta))
    want_g = resid @ x64 - INV_VAR * q64
    lp, g = L.logistic_value_and_grad_packed_plain(
        qt.double(), x_hi, x_lo, xt.double(), torch.as_tensor(y64),
        torch.ones(200, dtype=torch.float64), INV_VAR)
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-12,
                               atol=1e-12 * np.abs(want_g).max())
    # the split keeps q to its last bit but the dropped lo.lo term: the
    # packed eta is f32-grade, not the float32 product itself
    exact = q64 @ x64.T
    assert np.abs(eta - exact).max() <= 2.0 ** -14 * np.abs(exact).max()


def test_grad_bf16_plain_matches_jax_interpret():
    """``grad_bf16=True`` (K1 with the backward product's inputs rounded to
    bfloat16) against JAX's interpret kernel with ``grad_bf16=True``: logp
    as the tests above, and the gradient within a fifth of the rounding's
    own effect on it (a backward that ignored the option would be off by
    all of it)."""
    d = 19
    x, y, q = _data(21, d)
    jlp_, jg = (np.asarray(a) for a in _jax_potential(
        x, y, d, grad_bf16=True)(jnp.asarray(q)))
    tlp, tg = (a.numpy() for a in _port_potential(x, y, grad_bf16=True)(
        torch.as_tensor(q)))
    _, tg32 = (a.numpy() for a in _port_potential(x, y)(torch.as_tensor(q)))
    np.testing.assert_allclose(tlp, jlp_, rtol=2e-5, atol=2e-3)
    err = np.abs(tg - jg).max()
    shift = np.abs(tg - tg32).max()
    assert err <= 2e-3 * np.abs(jg).max()
    assert err < 0.2 * shift, (err, shift)


@pytest.mark.parametrize("opts,err", [
    ({"fwd_precision": "packed"}, "D=65"),
    ({"fwd_precision": "packed", "grad_bf16": True}, "grad_bf16=True"),
    ({"fwd_precision": "packed", "bwd_precision": "high"}, "'high'"),
    ({"fwd_precision": "packed", "bwd_precision": "high3"}, "'high'"),
    ({"fwd_precision": "high5"}, "fwd_precision"),
    ({"bwd_precision": "packed"}, "bwd_precision"),
    ({"block_c": 0}, "block_c"),
])
def test_options_refused_as_jax_refuses_them(opts, err):
    """The refusals of JAX's ``make_logistic_potential`` with its error
    type and message (the packed D bound at D = 65, with ``grad_bf16``, with
    a backward precision other than ``"default"``, unknown precisions), and
    tiles that are not positive integers."""
    d = 65 if err == "D=65" else 8
    x, y, _ = _data(1, d, n=20, c=2)
    with pytest.raises(ValueError, match=err) as got:
        _port_potential(x, y, **opts)
    if "block_c" not in opts:   # JAX does not check its tiles
        with pytest.raises(ValueError) as want:
            jlp.make_logistic_potential(jnp.asarray(x), jnp.asarray(y),
                                        INV_VAR, interpret=True, **opts)
        assert str(got.value) == str(want.value)


def test_ablate_trans_and_foreign_keys_refused_and_other_models_ignore():
    """``_ablate_trans`` (a wrong density by design) raises
    ``NotImplementedError``; a key JAX's potential does not take raises
    ``TypeError`` as in JAX; a model that is not logistic regression, and
    a route without the fused potential, ignore ``fused_opts``."""
    x, y, _ = _data(2, 4, n=30, c=2)
    with pytest.raises(NotImplementedError, match="_ablate_trans"):
        _port_potential(x, y, _ablate_trans=True)
    model = logistic_regression(x, y, device="cpu")
    with pytest.raises(TypeError):
        NUTSKernel(model, fused_opts={"interpret": True})
    with pytest.raises(NotImplementedError):
        NUTSKernel(model, fused_opts={"_ablate_trans": True})
    bad = {"fwd_precision": "nonsense", "block_c": -1}
    NUTSKernel(std_normal(3, device="cpu"), fused_opts=bad)
    NUTSKernel(model, use_pallas="off", fused_opts=bad)
    NUTSKernel(model, use_pallas="tree", fused_opts=bad)
    with pytest.raises(ValueError):
        NUTSKernel(model, use_pallas="on", fused_opts=bad)


def test_sample_with_packed_reaches_the_packed_plain_version(monkeypatch):
    """``sample(..., device="cpu", fused_opts={"fwd_precision":
    "packed"})`` evaluates every density through the packed plain version
    and never through K1's; the draws are finite."""
    calls = {"packed": 0, "k1": 0}
    packed, k1 = (L.logistic_value_and_grad_packed_plain,
                  L.logistic_value_and_grad_plain)

    def spy_packed(*a, **kw):
        calls["packed"] += 1
        return packed(*a, **kw)

    def spy_k1(*a, **kw):
        calls["k1"] += 1
        return k1(*a, **kw)

    monkeypatch.setattr(L, "logistic_value_and_grad_packed_plain", spy_packed)
    monkeypatch.setattr(L, "logistic_value_and_grad_plain", spy_k1)
    x, y, _ = _data(4, 5, n=200)
    st = default_warmup_stages(init_steps=10, middle_steps=10,
                               doubling_stages=1, terminating_steps=10)
    res = sample(2, logistic_regression(x, y, device="cpu"), 8, 4,
                 warmup_stages=st, device="cpu", fused_opts=PACKED)
    assert calls["packed"] > 0 and calls["k1"] == 0
    assert res.draws.shape == (8, 4, 5)
    assert bool(torch.isfinite(res.draws).all())


def test_one_lockstep_transition_with_packed_matches_jax():
    """One lockstep transition over the packed potential, on the same
    positions, momenta and direction words as JAX's ``nuts_transition``
    over its packed interpret potential, in float32: the integer fields
    equal, the acceptance statistic to 1e-4 (the two potentials differ in
    float32 summation order; the proposal draws differ by package)."""
    d, c = 6, 16
    x, y, q = _data(8, d, c=c, n=300)
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(c, d)).astype(np.float32)
    dirs = rng.integers(0, 2 ** 32, size=c, dtype=np.uint32)
    inv = (0.05 + 0.05 * rng.uniform(size=d)).astype(np.float32)
    eps = 0.15
    jpot = _jax_potential(x, y, d, **PACKED)
    lp, g = jpot(jnp.asarray(q))
    _, jst = jnuts(jax.random.PRNGKey(0), jpot, jdiag(jnp.asarray(inv)),
                   JEval(q=jnp.asarray(q), logp=lp, grad=g),
                   jnp.asarray(eps, jnp.float32), max_depth=6,
                   directions=jnp.asarray(dirs), momentum=jnp.asarray(p0))
    tpot = _port_potential(x, y, **PACKED)
    tq = torch.as_tensor(q)
    tlp, tg = tpot(tq)
    _, tst = tnuts(torch.Generator().manual_seed(0), tpot,
                   tdiag(torch.as_tensor(inv)), TEval(q=tq, logp=tlp, grad=tg),
                   eps, max_depth=6,
                   directions=torch.as_tensor(dirs.astype(np.int64)),
                   momentum=torch.as_tensor(p0))
    for f in ("termination", "depth", "steps", "term_left", "term_right"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    assert int(tst.depth.max()) >= 2
    np.testing.assert_allclose(tst.acceptance_rate.numpy(),
                               np.asarray(jst.acceptance_rate), atol=1e-4)
