"""Port parity for stochastic volatility's ASIS hook
(``models/stoch_vol.py``: ``_whiten``, ``_reconstruct``,
``_make_anc_logp``, ``asis_mh`` and ``make_asis_hook``), held against the
JAX package's on the same numpy inputs.

Tolerances.  ``_whiten`` and the ancillary density compute the JAX
package's elementwise operations in its order; ``_reconstruct`` takes the
same scan of affine maps by recursive doubling where JAX's
``lax.associative_scan`` adds along another tree.  Each ``h_t`` is a sum
of up to T products ``phi^k b_j``, so in float64 the two orders agree to
``RTOL64`` times ``1 + |h|`` plus ``RTOL64`` of the sum of the terms'
magnitudes (``_scan_scale``: the latents rebuilt from ``|b|`` and
``|phi|``), 1e-10 being far above ``gamma_T`` at T = 100.  In float32
the same bound with ``F32_K gamma_T`` (gamma_n = n u / (1 - n u), u =
2^-24; Higham, Accuracy and Stability of Numerical Algorithms, section
3.1): each of the two orders is within ``gamma_T`` of the exact sum, and
``tanh``, ``exp`` and ``sqrt`` of XLA and of torch may round an ulp apart
(``F32_K`` = 8 leaves room for that).  Near saturation ``1 - phi^2``
cancels: an ulp of ``tanh`` moves it by ``2 u phi^2``, relative ``2 u
cond`` with ``cond = phi^2 / (1 - phi^2)`` (floored as the code floors
it), and ``sqrt(1 - phi^2)`` scales ``eps_1`` and every latent through
``h_1``; so each value is also allowed ``4 u cond`` of its magnitude and
scale (``_cond``; u = 2^-53 or 2^-24).  The hook's MH decisions compare
``log(u)`` with a difference of two ancillary densities; given the same
draws the decisions must be equal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.models.stoch_vol import _make_anc_logp as j_anc
from inplacedhmc_tpu.models.stoch_vol import _reconstruct as j_reconstruct
from inplacedhmc_tpu.models.stoch_vol import _whiten as j_whiten


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (see tests/test_torch_stoch_vol.py): torch's libraries
    would push the JAX suite's longest module over the per-process limit of
    memory mappings.  One torch thread: the tensors are tiny."""
    global torch, sv, EvalPoint
    import importlib

    import torch
    # the module, not the model function that the models package exports
    # under the same name
    sv = importlib.import_module("inplacedhmc_tpu_torch.models.stoch_vol")
    from inplacedhmc_tpu_torch.core.state import EvalPoint
    torch.set_num_threads(1)


RTOL64 = 1e-10
F32_K = 8.0
PHI, S = 0.9, 0.3


def _gamma(n: int) -> float:
    nu = n * 2.0 ** -24
    return nu / (1.0 - nu)


def _case(t: int, c: int, seed: int):
    """Returns, positions about the truth (every third chain at ``raw_phi``
    up to 10, where float32 ``tanh`` saturates) and innovations, float64."""
    rng = np.random.default_rng(seed)
    h = np.zeros(t)
    h[0] = rng.normal() * S / math.sqrt(1 - PHI * PHI)
    for i in range(1, t):
        h[i] = PHI * h[i - 1] + S * rng.normal()
    r = rng.normal(size=t) * np.exp(0.5 * h)
    q = np.concatenate([
        math.atanh(PHI) + 0.3 * rng.normal(size=(c, 1)),
        math.log(S) + 0.3 * rng.normal(size=(c, 1)),
        h + 0.3 * rng.normal(size=(c, t))], axis=1)
    q[::3, 0] = np.linspace(3.0, 10.0, len(q[::3, 0]))
    eps = rng.normal(size=(c, t))
    return r, q, eps


def _scan_scale(raw_phi, log_s, eps):
    """Per latent, the sum of the magnitudes of the terms of the scan
    (float64): the latents rebuilt from ``|phi|`` and ``|s eps|``."""
    phi = np.abs(np.tanh(raw_phi))
    b = np.exp(log_s)[:, None] * np.abs(eps)
    b[:, 0] /= np.sqrt(np.maximum(1.0 - np.tanh(raw_phi) ** 2, 1e-12))
    out = np.empty_like(b)
    out[:, 0] = b[:, 0]
    for i in range(1, b.shape[1]):
        out[:, i] = phi * out[:, i - 1] + b[:, i]
    return out


def _cond(raw_phi, unit):
    """Per chain ``4 u cond`` (the module docstring), float64, as a column
    for ``[C, T]`` values."""
    phi2 = np.tanh(np.asarray(raw_phi, np.float64)) ** 2
    return (4.0 * unit * phi2 / np.maximum(1.0 - phi2, 1e-12))[:, None]


def _close(got, want, tol, scale=0.0, cond=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    bound = tol * (1.0 + np.abs(want) + scale) \
        + cond * (np.abs(want) + scale)
    ok = same | (np.abs(got - want) <= bound)
    assert bool(ok.all()), float(np.nanmax(np.abs(got - want) / bound))


@pytest.mark.parametrize("t", [7, 32, 33, 100])
def test_whiten_reconstruct_anc_logp_match_jax_float64(t):
    """``_whiten``, ``_reconstruct`` and the ancillary density against
    JAX's in float64 at T = 7, 32, 33 and 100, ``raw_phi`` up to 10: within
    ``RTOL64`` of the scale of the module docstring; the round trip
    reconstruct(whiten(h)) gives back h."""
    r, q, eps = _case(t, 12, t)
    raw_phi, log_s, h = q[:, 0], q[:, 1], q[:, 2:]
    cond = _cond(raw_phi, 2.0 ** -53)
    tq = torch.as_tensor(q)
    w = sv._whiten(tq[:, 0], tq[:, 1], tq[:, 2:])
    jw = j_whiten(jnp.asarray(raw_phi), jnp.asarray(log_s), jnp.asarray(h))
    _close(w.numpy(), np.asarray(jw), RTOL64, cond=cond)
    rec = sv._reconstruct(tq[:, 0], tq[:, 1], torch.as_tensor(eps))
    jrec = j_reconstruct(jnp.asarray(raw_phi), jnp.asarray(log_s),
                         jnp.asarray(eps))
    scale = _scan_scale(raw_phi, log_s, eps)
    _close(rec.numpy(), np.asarray(jrec), RTOL64, scale, cond)
    back = sv._reconstruct(tq[:, 0], tq[:, 1], w)
    _close(back.numpy(), h, RTOL64, _scan_scale(raw_phi, log_s, w.numpy()),
           cond)
    theta = tq[:, :2]
    lp = sv._make_anc_logp(torch.as_tensor(r))(theta, torch.as_tensor(eps))
    jlp = j_anc(r)(jnp.asarray(q[:, :2]), jnp.asarray(eps))
    obs = 0.5 * (np.abs(rec.numpy()) + r[None] ** 2
                 * np.exp(-rec.numpy())).sum(1)
    _close(lp.numpy(), np.asarray(jlp), RTOL64, obs + scale.sum(1),
           cond[:, 0] * (obs + scale.sum(1)))


@pytest.mark.parametrize("t", [7, 33, 100])
def test_whiten_reconstruct_anc_logp_match_jax_float32(t):
    """The same in float32, within ``F32_K gamma_T`` of the same scales
    and the conditioning term, and no NaN where ``tanh`` saturates (the
    1e-12 floors; a latent rebuilt through the floor may be large enough
    that ``exp(-h)`` overflows, and the density is then ``-inf`` on both
    sides)."""
    r, q, eps = _case(t, 12, 50 + t)
    q32, e32 = q.astype(np.float32), eps.astype(np.float32)
    cond = _cond(q32[:, 0], 2.0 ** -24)
    tq = torch.as_tensor(q32)
    tol = F32_K * _gamma(t)
    w = sv._whiten(tq[:, 0], tq[:, 1], tq[:, 2:])
    jw = j_whiten(jnp.asarray(q32[:, 0]), jnp.asarray(q32[:, 1]),
                  jnp.asarray(q32[:, 2:]))
    _close(w.numpy(), np.asarray(jw), tol, cond=cond)
    rec = sv._reconstruct(tq[:, 0], tq[:, 1], torch.as_tensor(e32))
    jrec = j_reconstruct(jnp.asarray(q32[:, 0]), jnp.asarray(q32[:, 1]),
                         jnp.asarray(e32))
    scale = _scan_scale(q32[:, 0], q32[:, 1], e32)
    _close(rec.numpy(), np.asarray(jrec), tol, scale, cond)
    lp = sv._make_anc_logp(torch.as_tensor(r))(tq[:, :2],
                                               torch.as_tensor(e32))
    jlp = j_anc(r)(jnp.asarray(q32[:, :2]), jnp.asarray(e32))
    obs = 0.5 * (np.abs(rec.numpy()) + r[None] ** 2
                 * np.exp(-rec.numpy())).sum(1)
    _close(lp.numpy(), np.asarray(jlp), tol, obs + scale.sum(1),
           cond[:, 0] * (obs + scale.sum(1)))
    for x in (w, rec, lp):   # -inf where exp(-h) overflows, never NaN
        assert not bool(torch.isnan(x).any())
    assert float(torch.tanh(tq[-1 - (len(q) - 1) % 3, 0])) == 1.0


def _jax_mh(r, theta, eps, scale, normals, uniforms, per_coord):
    """The hook's MH sub-steps written with JAX's ``_make_anc_logp`` on the
    given draws, in numpy: ``(theta, moved, decisions)``."""
    anc = j_anc(r)
    theta = np.array(theta)
    lp = np.asarray(anc(jnp.asarray(theta), jnp.asarray(eps)))
    moved = np.zeros(len(theta), bool)
    decisions = []
    for i in range(normals.shape[0]):
        subs = [(j, normals[i, j], uniforms[i, j]) for j in range(2)] \
            if per_coord else [(None, normals[i], uniforms[i, 0])]
        for j, z, u in subs:
            prop = theta.copy()
            if j is None:
                prop = theta + (np.asarray(scale, theta.dtype)[:, None]
                                * z).T
            else:
                prop[:, j] = theta[:, j] + theta.dtype.type(scale[j]) * z
            lp_p = np.asarray(anc(jnp.asarray(prop), jnp.asarray(eps)))
            with np.errstate(invalid="ignore"):
                accept = np.log(u) < (lp_p - lp)
            theta = np.where(accept[:, None], prop, theta)
            lp = np.where(accept, lp_p, lp)
            moved |= accept
            decisions.append(accept)
    return theta, moved, np.stack(decisions)


@pytest.mark.parametrize("per_coord", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mh_steps_match_jax_on_the_same_draws(per_coord, dtype):
    """``asis_mh`` against the same sub-steps composed from JAX's
    ``_make_anc_logp`` on the same normals and uniforms (drawn by the
    port's ``asis_draws``) at T = 40: every accept decision equal, and so
    the hyperparameters, bit for bit (the proposals are the same float
    operations on the same numbers)."""
    r, q, _ = _case(40, 24, 7)
    q = q.astype(dtype)
    q[::3, 0] = np.arctanh(PHI) + 0.05 * np.arange(len(q[::3]))
    tq = torch.as_tensor(q)
    eps = sv._whiten(tq[:, 0], tq[:, 1], tq[:, 2:])
    anc = sv._make_anc_logp(torch.as_tensor(r))
    scale = (0.06, 0.1)
    normals, uniforms = sv.asis_draws(torch.Generator().manual_seed(3), 10,
                                      len(q), per_coord, tq.dtype, "cpu")
    assert normals.shape == (10, 2, len(q))
    assert uniforms.shape == (10, 2 if per_coord else 1, len(q))
    theta, _, moved = sv.asis_mh(anc, tq[:, :2], eps, anc(tq[:, :2], eps),
                                 scale, normals, uniforms, per_coord)
    jtheta, jmoved, jdec = _jax_mh(r, q[:, :2], eps.numpy(), scale,
                                   normals.numpy(), uniforms.numpy(),
                                   per_coord)
    np.testing.assert_array_equal(moved.numpy(), jmoved)
    np.testing.assert_array_equal(theta.numpy(), jtheta)
    assert 0 < int(jdec.sum()) < jdec.size   # some taken, some refused


def test_hook_step_matches_jax_composition():
    """One hook step (per coordinate, 10 sub-steps) of the port in float64
    at T = 40 against the same step composed from JAX's ``_whiten``,
    ``_make_anc_logp`` and ``_reconstruct`` on the draws the hook took
    (``asis_draws`` on the same seed): which chains moved equal, the
    hyperparameters bit for bit, the rebuilt latents within ``RTOL64`` of
    the scan's scale."""
    r, q, _ = _case(40, 24, 17)
    q[:, 0] = np.arctanh(PHI) + 0.1 * np.arange(24) / 24
    tq = torch.as_tensor(q)
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad
    pot = batched_logdensity_and_grad(sv._centered_logp(torch.as_tensor(r)))
    lp0, g0 = pot(tq)
    hook = sv.make_asis_hook(torch.as_tensor(r), per_coord=True, n_steps=10)
    out = hook(torch.Generator().manual_seed(5), EvalPoint(tq, lp0, g0))
    normals, uniforms = sv.asis_draws(torch.Generator().manual_seed(5), 10,
                                      24, True, tq.dtype, "cpu")
    jq = jnp.asarray(q)
    jeps = j_whiten(jq[:, 0], jq[:, 1], jq[:, 2:])
    jtheta, jmoved, _ = _jax_mh(r, q[:, :2], np.asarray(jeps), (0.06, 0.1),
                                normals.numpy(), uniforms.numpy(), True)
    jh = np.asarray(j_reconstruct(jnp.asarray(jtheta[:, 0]),
                                  jnp.asarray(jtheta[:, 1]), jeps))
    want = np.where(jmoved[:, None],
                    np.concatenate([jtheta, jh], axis=1), q)
    moved = ~torch.all(out.q == tq, dim=1)
    np.testing.assert_array_equal(moved.numpy(), jmoved)
    assert bool(jmoved.any())
    np.testing.assert_array_equal(out.q[:, :2].numpy(), want[:, :2])
    _close(out.q[:, 2:].numpy(), want[:, 2:], RTOL64,
           _scan_scale(jtheta[:, 0], jtheta[:, 1], np.asarray(jeps)))


def _potential(tr):
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad
    return batched_logdensity_and_grad(sv._centered_logp(tr))


def test_hook_keeps_rejected_chains_bit_for_bit():
    """One per-coordinate hook step with long proposals (sd 2 and 3), about
    half of them refused: a chain whose every proposal was refused keeps
    its ``q``, ``logp`` and ``grad`` bit for bit (here marked values that
    the potential would not give); a chain that moved gets the potential's
    ``logp`` and ``grad`` at its new ``q``, whose latents are rebuilt from
    the same innovations."""
    r, q, _ = _case(30, 16, 11)
    q[:, 0] = math.atanh(PHI)
    q = q.astype(np.float32)
    tq = torch.as_tensor(q)
    tr = torch.as_tensor(r.astype(np.float32))
    pot = _potential(tr)
    lp0, g0 = pot(tq)
    z = EvalPoint(q=tq, logp=lp0 + 0.25, grad=g0 + 0.5)
    scale = (2.0, 3.0)
    hook = sv.make_asis_hook(tr, per_coord=True, n_steps=1, scale=scale)
    out = hook(torch.Generator().manual_seed(0), z)
    normals, uniforms = sv.asis_draws(torch.Generator().manual_seed(0), 1,
                                      len(q), True, tq.dtype, "cpu")
    eps = sv._whiten(tq[:, 0], tq[:, 1], tq[:, 2:])
    anc = sv._make_anc_logp(tr)
    theta, _, moved = sv.asis_mh(anc, tq[:, :2], eps, anc(tq[:, :2], eps),
                                 scale, normals, uniforms, True)
    kept = ~moved
    assert bool(kept.any()) and bool(moved.any())
    assert torch.equal(out.q[kept], tq[kept])
    assert torch.equal(out.logp[kept], z.logp[kept])
    assert torch.equal(out.grad[kept], z.grad[kept])
    assert torch.equal(out.q[moved, :2], theta[moved])
    h = sv._reconstruct(theta[:, 0], theta[:, 1], eps)
    assert torch.equal(out.q[moved, 2:], h[moved])
    lp1, g1 = pot(out.q)
    assert torch.equal(out.logp[moved], lp1[moved])
    assert torch.equal(out.grad[moved], g1[moved])


def test_hook_never_moves_to_a_nan_state():
    """From ``raw_phi = 10`` (f32 ``tanh`` is 1: the centred density is
    ``-inf``) with large proposal steps: whatever the MH steps take, no
    NaN reaches ``q``; a chain that stays keeps its ``-inf`` density."""
    r, q, _ = _case(20, 9, 13)
    q = q.astype(np.float32)
    q[:, 0] = 10.0
    tq = torch.as_tensor(q)
    tr = torch.as_tensor(r.astype(np.float32))
    lp0, g0 = _potential(tr)(tq)
    assert bool(torch.isneginf(lp0).all())
    hook = sv.make_asis_hook(tr, per_coord=True, n_steps=10,
                             scale=(2.0, 0.5))
    out = hook(torch.Generator().manual_seed(1), EvalPoint(tq, lp0, g0))
    assert not bool(torch.isnan(out.q).any())
    assert not bool(torch.isnan(out.logp).any())
    stay = torch.all(out.q == tq, dim=1)
    assert bool(torch.isneginf(out.logp[stay]).all())
