"""Port parity for the streamed and chunked adaptation and the blocked
sampling of config 5's recipe: ``core/metric.py::moments_variance`` and
``moments_cov``, ``adapt/warmup.py``'s ``StreamMoments`` windows,
``run_tuning_chunk`` and ``SplitMoments``, ``sample.py``'s
``tuning_chunk``, ``draw_block``, ``collect_moments``, ``sync_blocks`` and
``post_step``, and ``diagnostics.split_rhat_from_moments``, held against
the JAX package on the same numpy inputs.

Tolerances: in float64 the streamed moments and the R-hat from moments
compute the JAX package's operations in its order (the Gram ``c^T c`` one
product on each side), so they agree to 1e-12 relative; R-hat from moments
against R-hat of the stored draws (a one-pass against a two-pass variance)
to 1e-10.  A window run in chunks draws from one generator what it draws
in one piece, so it must equal the unchunked window bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import inplacedhmc_tpu.adapt.warmup as JW
from inplacedhmc_tpu import mcmc_with_warmup as j_mcmc
from inplacedhmc_tpu.config import TuningNUTS as JTuning
from inplacedhmc_tpu.core.metric import moments_cov as j_moments_cov
from inplacedhmc_tpu.core.metric import moments_variance as j_moments_var
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.diagnostics import split_rhat_from_moments as j_rhat_mom
from inplacedhmc_tpu.models.gaussian import std_normal as j_std_normal


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file (see tests/test_torch_stoch_vol.py).  One torch
    thread: the tensors are tiny."""
    global torch, W, metric, diag, EvalPoint, TuningNUTS
    global NUTS, NUTSKernel, DualAveraging, default_warmup_stages, sample
    global std_normal, stoch_vol, make_asis_hook, make_generator
    import torch
    import inplacedhmc_tpu_torch.adapt.warmup as W
    import inplacedhmc_tpu_torch.core.metric as metric
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch import (NUTS, DualAveraging, NUTSKernel,
                                       TuningNUTS, default_warmup_stages,
                                       sample)
    from inplacedhmc_tpu_torch.core.state import EvalPoint
    from inplacedhmc_tpu_torch.models import std_normal, stoch_vol
    from inplacedhmc_tpu_torch.models.stoch_vol import make_asis_hook
    from inplacedhmc_tpu_torch.sample import make_generator
    torch.set_num_threads(1)


RTOL = 1e-12


def _draws(n: int, c: int, d: int, seed: int):
    """Correlated draws ``[n, C, D]`` about a mean far from 0, float64."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) / np.sqrt(d) + np.eye(d)
    return 5.0 + rng.normal(size=(n, c, d)) @ a.T


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_streamed_window_matches_jax(kind):
    """A window's streamed moments (``init_stream_moments`` on the start,
    ``_update_moments`` per transition, ``_metric_from_moments``) against
    JAX's on the same draws in float64: the moments and the metric to
    1e-12; and ``moments_variance`` / ``moments_cov`` against JAX's on
    the same sums, also where a variance cancels to below the 1e-10 clamp
    (a coordinate that never moved)."""
    n, c, d = 9, 6, 5
    x = _draws(n, c, d, 3)
    x[..., 2] = 1.25           # a coordinate without variance
    q0 = x[0] - 0.5
    stage = TuningNUTS(n=n, metric=kind, stream=True)
    jstage = JTuning(n=n, metric=kind, stream=True)
    tq0 = torch.as_tensor(q0)
    mom = W.init_stream_moments(stage, EvalPoint(tq0, tq0[:, 0], tq0))
    jq0 = jnp.asarray(q0)
    jmom = JW.init_stream_moments(jstage, JEval(jq0, jq0[:, 0], jq0))
    for i in range(n):
        mom = W._update_moments(mom, stage, torch.as_tensor(x[i]))
        jmom = JW._update_moments(jmom, jstage, jnp.asarray(x[i]))
    for f in ("qref", "cnt", "s1", "s2"):
        np.testing.assert_allclose(getattr(mom, f).numpy(),
                                   np.asarray(getattr(jmom, f)), rtol=RTOL,
                                   atol=RTOL)
    m = W._metric_from_moments(stage, mom)
    jm = JW._metric_from_moments(jstage, jmom, None)
    np.testing.assert_allclose(m.inv.numpy(), np.asarray(jm.inv), rtol=RTOL,
                               atol=RTOL)
    fn, jfn = ((metric.moments_variance, j_moments_var) if kind == "diag"
               else (metric.moments_cov, j_moments_cov))
    for lam in (0.0, 0.3):
        got = fn(mom.cnt, mom.s1, mom.s2, lam)
        want = jfn(jmom.cnt, jmom.s1, jmom.s2, lam)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL)
    # the two-pass estimate of the stored draws, to the one-pass rounding
    # (the dense one with the guards: the diagonal clamp at 1e-10 and the
    # jitter of 1e-6 of the mean variance, before the shrinkage)
    flat = torch.as_tensor(x).reshape(-1, d)
    if kind == "diag":
        two = metric.regularized_variance(torch.as_tensor(x),
                                          stage.lam_value, pooled=True)
    else:
        cov = metric.regularized_cov(torch.as_tensor(x), 0.0, pooled=True)
        cov = cov + torch.diag(torch.clamp(1e-10 - torch.diagonal(cov),
                                           min=0.0))
        cov = cov + 1e-6 * torch.diagonal(cov).mean() * torch.eye(
            d, dtype=cov.dtype)
        two = metric._regularize(cov, float(flat.shape[0]), stage.lam_value,
                                 target=1e-3 * torch.eye(d,
                                                         dtype=cov.dtype))
    np.testing.assert_allclose(m.inv.numpy(), two.numpy(), rtol=1e-9,
                               atol=1e-9)


def _kernel_and_state(seed: int = 0):
    model = std_normal(5, device="cpu")
    kern = NUTSKernel(model, NUTS(max_depth=5))
    gen = make_generator(seed, "cpu")
    state = W.init_warmup_state(gen, kern.potential, 5, 8, torch.float64,
                                "cpu", eps=0.4)
    return kern, gen, state


@pytest.mark.parametrize("stream", [False, True])
def test_chunked_window_equals_unchunked(stream):
    """``NUTSKernel.warmup`` with ``tuning_chunk=7`` equals it without, bit
    for bit, on one generator: positions, step size, metric and every
    statistic, for stored-draw and streamed dense windows, with a
    ``post_step`` after every transition and ``sync_blocks``."""
    stages = default_warmup_stages(local_optimization=None,
                                   stepsize_search=None, init_steps=10,
                                   middle_steps=9, doubling_stages=2,
                                   terminating_steps=6, metric="dense",
                                   stream=stream)
    out = []
    for chunk in (None, 7):
        kern, gen, state = _kernel_and_state(1)
        calls = []

        def hook(g, z):
            calls.append(1)
            return z._replace(q=z.q + 0.0 * torch.rand(z.q.shape, generator=g,
                                                       dtype=z.q.dtype))

        kern.post_step = hook
        st, stats = kern.warmup(gen, state, stages, tuning_chunk=chunk,
                                sync_blocks=True)
        assert len(calls) == 10 + 9 + 18 + 6
        out.append((st, stats, torch.rand((3,), generator=gen)))
    (a, sa, ra), (b, sb, rb) = out
    assert torch.equal(a.z.q, b.z.q) and torch.equal(a.log_eps, b.log_eps)
    assert torch.equal(a.metric.inv, b.metric.inv)
    assert torch.equal(ra, rb)        # the generators drew the same
    for x, y in zip(sa, sb):
        for f, g in zip(x, y):
            assert torch.equal(f, g)


def test_split_rhat_from_moments_matches_jax_and_draws():
    """R-hat from split moments against JAX's on the same moments, to
    1e-12; the moments the sampling loop accumulates over an even number of
    draws give ``split_rhat`` of the same draws, to 1e-10; a run whose
    second half is empty reads NaN."""
    n, c, d = 12, 5, 4
    x = torch.as_tensor(_draws(n, c, d, 9))
    mom = W.init_split_moments(x[0] - 0.3)
    mom = W._copy_split(mom)
    for i in range(n):
        W._add_split_(mom, x[i][None], i, n)
    assert mom.cnt.tolist() == [6.0, 6.0]
    got = diag.split_rhat_from_moments(mom)
    want = j_rhat_mom(JW.SplitMoments(*(jnp.asarray(t.numpy())
                                        for t in mom)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), diag.split_rhat(x).numpy(),
                               rtol=1e-10)
    half = W._copy_split(W.init_split_moments(x[0]))
    W._add_split_(half, x[:4], 0, n)
    assert bool(torch.isnan(diag.split_rhat_from_moments(half)).all())


def test_blocked_moment_halves_match_jax():
    """``draw_block=4`` over an odd 11 draws with ``collect_moments``: the
    draws of index 5 and on go to the second half, the moments' counts are
    JAX's exactly ([5, 6]), and R-hat from the moments of the blocked run
    equals that of one piece on the same generator (the blocks draw what
    one piece draws)."""
    n = 11
    jres = j_mcmc(jax.random.PRNGKey(0), j_std_normal(2), n, 4,
                  warmup_stages=(), eps=0.5, draw_block=4,
                  collect_moments=True)
    out = []
    for block in (4, None):
        res = sample(0, std_normal(2, device="cpu"), n, 4, warmup_stages=(),
                     eps=0.5, draw_block=block, collect_moments=True,
                     sync_blocks=True, device="cpu", dtype=torch.float64)
        out.append(res)
    np.testing.assert_array_equal(out[0].sample_moments.cnt.numpy(),
                                  np.asarray(jres.sample_moments.cnt))
    assert out[0].sample_moments.cnt.tolist() == [5.0, 6.0]
    for f in ("cnt", "s1", "s2"):
        assert torch.equal(getattr(out[0].sample_moments, f),
                           getattr(out[1].sample_moments, f))
    assert torch.equal(out[0].draws, out[1].draws)


def _returns(t: int, seed: int):
    rng = np.random.default_rng(seed)
    h = np.zeros(t)
    h[0] = rng.normal() * 0.3 / np.sqrt(1 - 0.81)
    for i in range(1, t):
        h[i] = 0.9 * h[i - 1] + 0.3 * rng.normal()
    return (rng.normal(size=t) * np.exp(0.5 * h)).astype(np.float32)


def test_stoch_vol_sample_with_the_whole_recipe(monkeypatch):
    """Config 5's whole recipe on the CPU at T = 16, 8 chains: streamed
    dense windows, ``tuning_chunk``, ``draw_block``, ``sync_blocks``,
    ``collect_moments``, the per-coordinate ASIS hook after every
    transition and bfloat16 checkpoint stacks, through K5's plain version.
    Every transition goes through the whole tree with ``ckpt_bf16`` and is
    followed by the hook; the draws are finite; R-hat from
    ``sample_moments`` equals R-hat of the stored draws to 1e-5 (float32
    sums of 15 draws a half)."""
    import inplacedhmc_tpu_torch.ops.tree as tree
    r = _returns(16, 2)
    calls, hooks = [], []
    real = tree.tree_transition_plain

    def counted(*a, **kw):
        calls.append(kw.get("ckpt_bf16", a[10] if len(a) > 10 else False))
        return real(*a, **kw)

    monkeypatch.setattr(tree, "tree_transition_plain", counted)
    asis = make_asis_hook(torch.as_tensor(r), per_coord=True, n_steps=10)

    def hook(gen, z):
        hooks.append(1)
        return asis(gen, z)

    stages = default_warmup_stages(
        local_optimization=None,
        stepsize_adaptation=DualAveraging(delta=0.9), init_steps=20,
        middle_steps=10, doubling_stages=2, terminating_steps=10,
        metric="dense", stream=True)
    res = sample(1, stoch_vol(r, device="cpu"), 30, 8, warmup_stages=stages,
                 device="cpu", post_step=hook, tuning_chunk=7, draw_block=7,
                 sync_blocks=True, collect_moments=True,
                 tree_opts={"ckpt_bf16": True}, algorithm=NUTS(max_depth=6))
    n_trans = 20 + 10 + 20 + 10 + 30
    assert calls == [True] * n_trans and len(hooks) == n_trans
    assert res.draws.shape == (30, 8, 18)
    assert bool(torch.isfinite(res.draws).all())
    assert res.warmup_stats.steps.shape == (60, 8)
    assert type(res.warmup_state.metric).__name__ == "DenseMetric"
    assert res.sample_moments.cnt.tolist() == [15.0, 15.0]
    np.testing.assert_allclose(
        diag.split_rhat_from_moments(res.sample_moments).double().numpy(),
        diag.split_rhat(res.draws.double()).numpy(), rtol=1e-5)
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.99


def test_swept_loop_collects_split_moments():
    """The swept sampling loop (``padded_io``, ``n_sweep`` 4, ``thin`` 2)
    adds every recorded draw over all coordinates to the split moments, in
    the halves of the whole run (``moment_offset``, ``moment_total``): the
    same sums as adding the loop's own draws one by one; with a
    ``post_step`` the loop takes one transition at a time and the hook runs
    after each."""
    kern = NUTSKernel(std_normal(6, device="cpu"), NUTS(max_depth=5),
                      tree_opts={"block_c": 8, "n_sweep": 4,
                                 "padded_io": True})
    state = W.init_warmup_state(torch.Generator().manual_seed(0),
                                kern.potential, 6, 10, torch.float32, "cpu",
                                eps=0.45)
    mom0 = W.init_split_moments(state.z.q)
    res = W.run_sampling(torch.Generator().manual_seed(1), kern.potential,
                         NUTS(max_depth=5), state, 8,
                         transition_factory=kern.transition_factory, thin=2,
                         moments0=mom0, moment_offset=4, moment_total=20)
    assert torch.equal(mom0.cnt, torch.zeros(2))     # the carry is copied
    want = W._copy_split(mom0)
    for i in range(8):
        W._add_split_(want, res.draws[i][None], 4 + i, 20)
    assert res.moments.cnt.tolist() == [6.0, 2.0]
    for f in ("cnt", "s1", "s2"):
        torch.testing.assert_close(getattr(res.moments, f),
                                   getattr(want, f), rtol=1e-6, atol=1e-6)
    calls = []

    def hook(gen, z):
        calls.append(1)
        return z

    res = W.run_sampling(torch.Generator().manual_seed(1), kern.potential,
                         NUTS(max_depth=5), state, 8,
                         transition_factory=kern.transition_factory, thin=2,
                         post_step=hook, moments0=mom0)
    assert len(calls) == 16 and res.moments.cnt.tolist() == [4.0, 4.0]


def test_chunk_hook_runs_after_every_chunk():
    """``NUTSKernel.warmup``'s ``chunk_hook`` runs after every chunk of a
    window run in chunks, and after the window where it runs in one piece
    (a window no longer than ``tuning_chunk``, or without it), on the
    warmup's generator; the state it returns is the next chunk's start."""
    stages = default_warmup_stages(local_optimization=None,
                                   stepsize_search=None, init_steps=10,
                                   middle_steps=9, doubling_stages=2,
                                   terminating_steps=6, metric="diag")
    for chunk, n_calls in ((7, 2 + 2 + 3 + 1), (None, 4)):
        kern, gen, state = _kernel_and_state(2)
        calls = []

        def chunk_hook(g, z):
            # q -> -q leaves the standard normal invariant
            calls.append(int(z.q.shape[0]))
            return z._replace(q=-z.q, grad=-z.grad)

        st, _ = kern.warmup(gen, state, stages, tuning_chunk=chunk,
                            chunk_hook=chunk_hook)
        assert calls == [8] * n_calls
        assert bool(torch.isfinite(st.z.q).all())
    with pytest.raises(ValueError, match="tuning_chunk"):
        kern.warmup(gen, state, stages, tuning_chunk=0)
