"""Port parity for the flagship whole-tree path: the Philox generator
(``utils/philox.py``), the whole-tree kernel's sweeps, valid rows and drawn
randomness (``ops/tree.py``), the swept sampling loop
(``adapt/warmup.py``) and ``sample(tree_opts=...)`` (``sample.py``).

On the CPU the kernel's wrapper runs its plain torch version.  These tests
hold it against the JAX package's interpret-mode kernel on the same numpy
stacks (momentum, direction words, proposal uniforms), against sequential
transitions of its own, and the swept loop against a hand loop over the
same launches.  Integer fields must be equal; float fields agree to f32
round-off of row sums taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.ops.tree_pallas import \
    make_gaussian_tree_transition as jtree


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, W, NUTS, NUTSKernel, Model, TEval, TuningNUTS
    global default_warmup_stages, mcmc_with_warmup, sample, diag
    global std_normal, logistic_regression, tree, philox, chain_tiles
    import torch
    import inplacedhmc_tpu_torch.adapt.warmup as W
    import inplacedhmc_tpu_torch.ops.tree as tree
    import inplacedhmc_tpu_torch.utils.philox as philox
    from inplacedhmc_tpu_torch import (NUTS, TuningNUTS,
                                       default_warmup_stages,
                                       mcmc_with_warmup, sample)
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.models import logistic_regression, std_normal
    from inplacedhmc_tpu_torch.models.base import Model
    from inplacedhmc_tpu_torch.ops.common import chain_tiles
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
# f32 on both sides, the same operations; the row sums over D = 7 terms in
# another order: a few ulps of values of order 10 (test_torch_gaussian.py)
F32_RTOL, F32_ATOL = 2e-6, 2e-5

# Random123's known answers (Salmon et al., SC'11): counter ; key -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32(counter, key)
    assert tuple(int(w) for w in got) == want
    # the same from a [2] int64 key tensor, as the kernel reads it
    got_t = philox.philox4x32(counter, torch.tensor(key, dtype=torch.int64))
    assert tuple(int(w) for w in got_t) == want


def test_philox_draws_in_range_and_independent_of_neighbours():
    """Uniforms in [0, 1) with the moments of U(0, 1) and normals with those
    of N(0, 1) (within 5 standard errors over 65,536 draws), every direction
    word in [0, 2^32); and a chain's draws are the same whichever other
    chains are drawn beside it."""
    key = (123, 456)
    rows = torch.arange(64, dtype=torch.int64)
    u = philox.uniforms(key, rows, 3, range(1024), torch.float64)
    assert bool((u >= 0).all() and (u < 1).all())
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / n)
    xi = philox.normals(key, rows, 1, 1024, torch.float64)
    assert abs(float(xi.mean())) < 5 / np.sqrt(n)
    assert abs(float(xi.var()) - 1) < 5 * np.sqrt(2 / n)
    assert float(xi.abs().max()) <= philox.MAX_NORMAL
    dw = philox.direction_words(key, rows, 0)
    assert bool((dw >= 0).all() and (dw < 2 ** 32).all())
    sub = torch.tensor([5, 40], dtype=torch.int64)
    assert torch.equal(philox.uniforms(key, sub, 3, range(1024),
                                       torch.float64), u[:, sub])
    assert torch.equal(philox.normals(key, sub, 1, 1024, torch.float64),
                       xi[sub])
    assert torch.equal(philox.direction_words(key, sub, 0), dw[sub])
    # another transition of the sweep, another stream, another key: others
    assert not torch.equal(philox.uniforms(key, rows, 4, range(1024),
                                           torch.float64), u)
    assert not torch.equal(philox.uniforms((124, 456), rows, 3, range(1024),
                                           torch.float64), u)


def _stacks(seed, c=16, d=7, max_depth=5, k=3):
    rng = np.random.default_rng(seed)
    prec = (rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    minv = (rng.gamma(2.0, size=d) + 0.3).astype(np.float32)
    q0 = rng.normal(size=(c, d)).astype(np.float32)
    p = rng.normal(size=(k, c, d)).astype(np.float32)
    dirs = rng.integers(0, 2 ** 32, size=(k, c), dtype=np.uint32)
    unif = rng.uniform(size=(k, tree.n_uniforms(max_depth), c)) \
        .astype(np.float32)
    return dict(prec=prec, minv=minv, q0=q0, p=p, dirs=dirs, unif=unif)


def _tz(prec, q0):
    q = torch.as_tensor(q0)
    lam = torch.as_tensor(prec)
    return TEval(q=q, logp=-0.5 * torch.sum(lam * q * q, dim=1), grad=-lam * q)


@pytest.mark.parametrize("seed,eps", [(3, 0.3), (4, 0.9), (5, 0.02)])
def test_sweep_matches_jax_interpret_sweep(seed, eps):
    """The port's ``n_sweep = 3`` transition with explicit stacks against
    ``make_gaussian_tree_transition(..., interpret=True, n_sweep=3)`` fed the
    same stacks (``tests/test_tree_pallas.py``'s sweep test): every
    transition's integer fields equal, energies, acceptances and draws to
    f32 round-off, and the final point's logp and gradient."""
    k, md = 3, 5
    r = _stacks(seed, k=k, max_depth=md)
    jpot = jbl(lambda q: -0.5 * jnp.sum(q * (jnp.asarray(r["prec"]) * q)))
    lp, g = jpot(jnp.asarray(r["q0"]))
    jz = JEval(q=jnp.asarray(r["q0"]), logp=lp, grad=g)
    jtr = jtree(jnp.asarray(r["prec"]), jnp.asarray(r["minv"]), max_depth=md,
                block_c=16, interpret=True, n_sweep=k)
    jzf, jdraws, jst = jtr(
        jax.random.PRNGKey(99), jz, eps, directions=jnp.asarray(r["dirs"]),
        momentum=jnp.asarray(r["p"]),
        _unif=jnp.asarray(r["unif"].reshape(k * tree.n_uniforms(md), 16)))
    trk = tree.make_gaussian_tree_transition(
        torch.as_tensor(r["prec"]), torch.as_tensor(r["minv"]),
        max_depth=md, n_sweep=k)
    zf, draws, st = trk(torch.Generator().manual_seed(0),
                        _tz(r["prec"], r["q0"]), eps,
                        directions=torch.as_tensor(r["dirs"].astype(np.int64)),
                        momentum=torch.as_tensor(r["p"]),
                        unif=torch.as_tensor(r["unif"]))
    assert draws.shape == (k, 16, 7) and draws.dtype == torch.float32
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{f} eps={eps}")
    for got, want in ((st.energy, jst.energy),
                      (st.acceptance_rate, jst.acceptance_rate),
                      (draws, jdraws), (zf.q, jzf.q), (zf.logp, jzf.logp),
                      (zf.grad, jzf.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("form", ["explicit", "drawn"])
def test_sweep_bit_identical_to_sequential_transitions(form):
    """K = 4 transitions in one sweep equal 4 single transitions fed the same
    draws, bit for bit: with explicit stacks through the factory's
    transitions, and with everything drawn from one key (momentum, directions,
    uniforms; one row in four not valid) against single transitions fed
    what ``ops.tree.philox_draws`` says the generator draws."""
    k, md, c, d = 4, 5, 16, 7
    r = _stacks(11, c=c, d=d, max_depth=md, k=k)
    prec, minv = torch.as_tensor(r["prec"]), torch.as_tensor(r["minv"])
    z0 = _tz(r["prec"], r["q0"])
    eps = torch.full((c,), 0.35)
    if form == "explicit":
        dirs = torch.as_tensor(r["dirs"].astype(np.int64))
        trk = tree.make_gaussian_tree_transition(prec, minv, max_depth=md,
                                                 n_sweep=k)
        zf, draws, st = trk(torch.Generator(), z0, 0.35, directions=dirs,
                            momentum=torch.as_tensor(r["p"]),
                            unif=torch.as_tensor(r["unif"]))
        tr1 = tree.make_gaussian_tree_transition(prec, minv, max_depth=md)
        z = z0
        for s in range(k):
            z, st1 = tr1(torch.Generator(), z, 0.35, directions=dirs[s],
                         momentum=torch.as_tensor(r["p"][s]),
                         unif=torch.as_tensor(r["unif"][s]))
            assert torch.equal(draws[s], z.q)
            for f in st._fields:
                assert torch.equal(getattr(st, f)[s], getattr(st1, f)), f
        for f in ("q", "logp", "grad"):
            assert torch.equal(getattr(zf, f), getattr(z, f)), f
        return
    key = torch.tensor([2024, 77], dtype=torch.int64)
    valid = (torch.arange(c) % 4 != 1).to(torch.int32)
    sqrt_mass = 1.0 / torch.sqrt(minv)
    q_state = z0.q.clone()
    swept = tree.gaussian_tree_sweep(q_state, eps, prec, minv, md, -1000.0, k,
                                     key=key, sqrt_mass=sqrt_mass,
                                     valid=valid)
    xi, dirs, unif = tree.philox_draws(key, c, d, md, k)
    q = z0.q
    for s in range(k):
        one = tree.gaussian_tree_transition(q, sqrt_mass * xi[s], eps,
                                            dirs[s], unif[s], prec, minv, md,
                                            -1000.0, valid=valid)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)), f
        q = one.q
    assert torch.equal(swept.grad, one.grad)
    assert torch.equal(swept.q[-1], q)
    assert torch.equal(q_state, z0.q)  # the start is only read
    # the generator's uniforms drawn lazily by depth are the same numbers
    lazy = tree.gaussian_tree_transition(z0.q, sqrt_mass * xi[0], eps,
                                         dirs[0], None, prec, minv, md,
                                         -1000.0, key=key, valid=valid)
    assert torch.equal(lazy.q, swept.q[0])
    assert torch.equal(lazy.steps, swept.steps[0])


def test_padded_rows_keep_jax_constants():
    """Rows with ``valid = 0`` leave the records of an empty tree, as JAX's
    padded rows do: term ``MAX_DEPTH``, ``(term_left, term_right) = (1, 0)``,
    depth 0, steps 0, acceptance 0, and their position unchanged.  Held
    against JAX's ``padded_io`` runner in interpret mode on a state with
    padded rows."""
    md, c, cpad, d = 5, 13, 16, 7
    r = _stacks(2, c=cpad, d=d, max_depth=md, k=1)
    _, jrun = jtree(jnp.asarray(r["prec"]), jnp.asarray(r["minv"]),
                    max_depth=md, block_c=16, interpret=True, padded_io=True)
    q0 = np.zeros((cpad, 128), np.float32)
    q0[:c, :d] = r["q0"][:c]
    valid = np.zeros((cpad, 1), np.int32)
    valid[:c] = 1
    _, _, _, jst = jrun(jax.random.PRNGKey(5), jnp.asarray(q0),
                        jnp.full((cpad, 1), 0.4, jnp.float32),
                        jnp.asarray(valid))
    _, run_padded = tree.make_gaussian_tree_transition(
        torch.as_tensor(r["prec"]), torch.as_tensor(r["minv"]), max_depth=md,
        block_c=16, refresh_inside=True, padded_io=True)
    q_state = torch.zeros((cpad, d))
    q_state[:c] = torch.as_tensor(r["q0"][:c])
    tvalid = torch.as_tensor(valid[:, 0])
    q_draws, _, _, st = run_padded(torch.Generator().manual_seed(1), q_state,
                                   torch.full((cpad,), 0.4), tvalid)
    pad = slice(c, cpad)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f)[0, pad].numpy(),
                                      np.asarray(getattr(jst, f))[pad],
                                      err_msg=f)
    want = dict(termination=0, term_left=1, term_right=0, depth=0, steps=0)
    for f, v in want.items():
        assert bool((getattr(st, f)[0, pad] == v).all()), f
    assert bool((st.acceptance_rate[0, pad] == 0).all())
    np.testing.assert_array_equal(np.asarray(jst.acceptance_rate)[pad], 0)
    assert bool((q_draws[0, pad] == 0).all() and (q_state[pad] == 0).all())
    assert bool((st.steps[0, :c] > 0).all())


def test_swept_run_sampling_matches_hand_loop():
    """The swept sampling path (``run_sampling`` through the
    ``SweepRunner``) is exactly the hand loop over ``run_padded`` with the
    same generator: thinning of draws and stats, ``keep_dims``, the padding
    of 21 chains to 24 by ``block_c = 8``, and the final state recomputed
    from the carried position (``tests/test_tree_pallas.py``'s counterpart;
    its split moments: ``tests/test_torch_stream.py``)."""
    k, thin, n_draws, c, dim = 4, 2, 8, 21, 6
    kern = NUTSKernel(std_normal(dim, device="cpu"), NUTS(max_depth=5),
                      tree_opts={"block_c": 8, "n_sweep": k,
                                 "padded_io": True})
    state = W.init_warmup_state(torch.Generator().manual_seed(0),
                                kern.potential, dim, c, torch.float32, "cpu",
                                eps=0.45)
    sweep = kern.transition_factory(state.metric, c)._sweep
    assert sweep.n_sweep == k and sweep.block_c == 8
    res = W.run_sampling(torch.Generator().manual_seed(42), kern.potential,
                         NUTS(max_depth=5), state, n_draws,
                         transition_factory=kern.transition_factory,
                         thin=thin, keep_dims=(0, 2))
    assert res.draws.shape == (n_draws, c, 2)

    cpad, _ = chain_tiles(c, sweep.block_c)
    assert cpad == 24
    gen = torch.Generator().manual_seed(42)
    eps_col = torch.full((cpad,), 0.45)
    valid = (torch.arange(cpad) < c).to(torch.int32)
    q_pad = torch.zeros((cpad, dim))
    q_pad[:c] = state.z.q
    rec, steps_rec, acc_rec = [], [], []
    for _ in range(n_draws * thin // k):
        q_draws, _, _, st = sweep.run_padded(gen, q_pad, eps_col, valid)
        rec.append(q_draws[thin - 1::thin, :c].clone())
        steps_rec.append(st.steps[thin - 1::thin, :c].clone())
        acc_rec.append(st.acceptance_rate[thin - 1::thin, :c].clone())
        assert bool((st.steps[:, c:] == 0).all())
        q_pad = q_draws[-1]
    rec = torch.cat(rec)
    assert torch.equal(res.draws, rec[:, :, [0, 2]])
    assert torch.equal(res.stats.steps, torch.cat(steps_rec))
    assert torch.equal(res.stats.acceptance_rate, torch.cat(acc_rec))
    assert torch.equal(res.z.q, rec[-1])
    assert torch.equal(res.z.grad, -rec[-1])


def test_swept_padded_io_statistical_correctness():
    """``padded_io`` + ``n_sweep`` through ``mcmc_with_warmup`` (the
    counterpart of ``tests/test_tree_pallas.py``'s test, same bounds):
    the moments of a 6-D standard normal, the stats' shapes, acceptance."""
    res = mcmc_with_warmup(8, std_normal(6, device="cpu"), 512, 64, eps=0.5,
                           warmup_stages=[], device="cpu",
                           tree_opts={"block_c": 32, "n_sweep": 8,
                                      "padded_io": True})
    d = res.draws.numpy()
    assert d.shape == (512, 64, 6)
    assert abs(d.mean()) < 0.05
    assert abs(d.var() - 1.0) < 0.1
    assert res.stats.steps.shape == (512, 64)
    assert float(res.stats.acceptance_rate.mean()) > 0.5


@pytest.mark.parametrize("n_draws,thin,swept", [
    (8, 2, True), (6, 1, False), (4, 3, False)])
def test_sweep_engages_only_when_the_loop_divides(n_draws, thin, swept,
                                                  monkeypatch):
    """As in JAX: the swept loop runs when ``n_sweep % thin == 0`` and
    ``n_draws * thin % n_sweep == 0``; otherwise the per-transition path
    runs the factory's single transition, with the same thinning and
    ``keep_dims``."""
    calls = []
    real = W._run_sampling_swept
    monkeypatch.setattr(W, "_run_sampling_swept",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kern = NUTSKernel(std_normal(5, device="cpu"), NUTS(max_depth=5),
                      tree_opts={"n_sweep": 4, "padded_io": True,
                                 "block_c": 8})
    state = W.init_warmup_state(torch.Generator().manual_seed(0),
                                kern.potential, 5, 12, torch.float32, "cpu",
                                eps=0.5)
    res = W.run_sampling(torch.Generator().manual_seed(1), kern.potential,
                         NUTS(max_depth=5), state, n_draws,
                         transition_factory=kern.transition_factory,
                         thin=thin, keep_dims=(4,))
    assert bool(calls) == swept
    assert res.draws.shape == (n_draws, 12, 1)
    assert res.stats.steps.shape == (n_draws, 12)
    assert bool(torch.isfinite(res.draws).all())
    assert bool((res.stats.steps > 0).all())


def test_sample_flagship_options_on_the_cpu():
    """``sample()`` with the flagship options, ``thin`` and ``keep_dims`` at a
    small size: the recorded coordinates' moments within 5 Monte Carlo
    standard errors, split R-hat < 1.05, acceptance near the target; the
    warmup statistics from the per-transition kernel."""
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=3, terminating_steps=25)
    n_warm = sum(s.n for s in stages if isinstance(s, TuningNUTS))
    res = sample(6, std_normal(6, device="cpu"), 256, 20,
                 warmup_stages=stages, device="cpu", thin=2,
                 keep_dims=(1, 4),
                 tree_opts={"refresh_inside": True, "padded_io": True,
                            "n_sweep": 8})
    x = res.draws.double()
    assert x.shape == (256, 20, 2) and bool(torch.isfinite(x).all())
    assert res.warmup_stats.steps.shape == (n_warm, 20)
    ess = diag.ess_bulk(x, cap=False)
    ess_sq = diag.ess_bulk(x * x, cap=False)
    assert bool((x.mean(dim=(0, 1)).abs() < 5 * torch.sqrt(1 / ess)).all())
    assert bool(((x.var(dim=(0, 1)) - 1).abs()
                 < 5 * torch.sqrt(2 / ess_sq)).all())
    assert float(diag.split_rhat(x).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95
    assert res.warmup_state.z.q.shape == (20, 6)


@pytest.mark.parametrize("opts,error", [
    ({"nsweep": 4}, ValueError),
    ({"n_sweep": 4, "padded_io": False}, ValueError),
    ({"ckpt_bf16": True, "grad_bf16": True}, ValueError),
    ({"block_c": 12, "padded_io": True}, ValueError)])
def test_tree_opts_are_checked(opts, error):
    """Unknown keys and ``n_sweep > 1`` without ``padded_io`` raise
    ``ValueError`` as in JAX; beside ``ckpt_bf16``, which the port takes, a
    key of logistic regression's alone is refused for a Gaussian; a
    ``block_c`` that is not a multiple of 8 is refused when the route is
    built."""
    model = std_normal(3, device="cpu")
    with pytest.raises(error):
        kern = NUTSKernel(model, tree_opts=opts)
        kern.transition_factory(
            W.identity_metric(3, torch.float32, "cpu"), 16)


def test_tree_opts_refused_where_the_kernel_is_not_ported():
    """``tree_opts`` on models whose whole-tree kernel the port lacks (a
    tile model whose physics has no hand-written device function) raise
    ``NotImplementedError`` saying what they lack; without ``tree_opts``
    those models run as before.  Logistic regression's kernel is ported:
    its ``tree_opts`` configure it under ``use_pallas="tree"``, and the
    default route, which runs no whole tree for it, ignores them as JAX's
    does."""
    logistic = logistic_regression(np.zeros((4, 2), np.float32),
                                   np.zeros(4, np.float32), device="cpu")
    opts = {"n_sweep": 2}
    assert NUTSKernel(logistic, tree_opts=opts).transition_factory is None
    assert NUTSKernel(logistic, tree_opts=opts, use_pallas="tree") \
        .transition_factory(W.identity_metric(2, torch.float32, "cpu"),
                            2)._sweep.n_sweep == 2
    m = Model(name="tile_logp", dim=2, logp=lambda q: -(q * q).sum(-1),
              structure={"kind": "tile_logp"})
    with pytest.raises(NotImplementedError,
                       match="no hand-written device function"):
        NUTSKernel(m, tree_opts={"block_c": 8})
    assert NUTSKernel(m).transition_factory is None


def test_padded_io_draws_inside_the_kernel():
    """``padded_io`` implies ``refresh_inside``: the tuning transition the
    factory builds draws its momentum and directions itself and refuses
    explicit ones; a ``padded_io`` build without ``refresh_inside`` is
    refused."""
    kern = NUTSKernel(std_normal(3, device="cpu"),
                      tree_opts={"padded_io": True})
    met = W.identity_metric(3, torch.float32, "cpu")
    trans = kern.transition_factory(met, 8)
    assert trans._sweep.n_sweep == 1
    z = _tz(np.ones(3, np.float32), np.zeros((8, 3), np.float32))
    with pytest.raises(ValueError):
        trans(torch.Generator(), z, 0.3, momentum=torch.zeros((8, 3)))
    z2, st = trans(torch.Generator(), z, 0.3)
    assert z2.q.shape == (8, 3) and st.steps.shape == (8,)
    with pytest.raises(ValueError):
        tree.make_gaussian_tree_transition(torch.ones(3), torch.ones(3),
                                           padded_io=True)
