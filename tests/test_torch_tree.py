"""Port parity for the lockstep NUTS tree (``nuts/tree.py``).

With the momentum, the direction words and eps fixed, everything but the
proposal choice is deterministic: depth, steps, the termination code and
``term_left``/``term_right`` must equal the JAX ``nuts_transition`` and the
recursive numpy oracle exactly, and the acceptance statistic to f64
round-off.  The proposal draws different random numbers in the two
packages, so it is checked statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.metric import dense_metric as jdense
from inplacedhmc_tpu.core.metric import diag_metric as jdiag
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.nuts.tree import nuts_transition as jnuts

from _oracle import oracle_trajectory


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, tbl, tdense, tdiag, TEval, Termination, tnuts, TERM_NAME
    import torch
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import dense_metric as tdense
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.core.state import EvalPoint as TEval
    from inplacedhmc_tpu_torch.core.state import Termination
    from inplacedhmc_tpu_torch.nuts.tree import nuts_transition as tnuts
    torch.set_num_threads(1)
    TERM_NAME = {Termination.MAX_DEPTH: "max_depth",
                 Termination.DIVERGENCE: "divergence",
                 Termination.TURNING: "turning"}


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")


def _quadratic(prec):
    jpot = jbl(lambda q: -0.5 * jnp.sum(jnp.asarray(prec) * q * q))
    tpot = tbl(lambda q: -0.5 * torch.sum(torch.as_tensor(prec) * q * q,
                                          dim=-1))
    return jpot, tpot


def _both(seed, eps, dense=False, c=16, d=5, max_depth=6):
    rng = np.random.default_rng(seed)
    prec = rng.gamma(2.0, size=d) + 0.1
    q0 = rng.normal(size=(c, d)) * 1.5
    p0 = rng.normal(size=(c, d))
    dirs = rng.integers(0, 2 ** 32, size=c, dtype=np.uint32)
    if dense:
        a = rng.normal(size=(d, d))
        inv = a @ a.T / d + 0.5 * np.eye(d)
        jmet, tmet = jdense(jnp.asarray(inv)), tdense(torch.as_tensor(inv))
    else:
        inv = rng.gamma(2.0, size=d) + 0.2
        jmet, tmet = jdiag(jnp.asarray(inv)), tdiag(torch.as_tensor(inv))
    jpot, tpot = _quadratic(prec)
    lp, g = jpot(jnp.asarray(q0))
    jz, jst = jnuts(jax.random.PRNGKey(seed), jpot, jmet,
                    JEval(q=jnp.asarray(q0), logp=lp, grad=g),
                    jnp.asarray(eps), max_depth=max_depth,
                    directions=jnp.asarray(dirs), momentum=jnp.asarray(p0))
    tq = torch.as_tensor(q0)
    tlp, tg = tpot(tq)
    gen = torch.Generator().manual_seed(seed)
    tz, tst = tnuts(gen, tpot, tmet, TEval(q=tq, logp=tlp, grad=tg), eps,
                    max_depth=max_depth,
                    directions=torch.as_tensor(dirs.astype(np.int64)),
                    momentum=torch.as_tensor(p0))
    return dict(prec=prec, q0=q0, p0=p0, dirs=dirs, inv=inv, jst=jst,
                tst=tst, tz=tz, max_depth=max_depth)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("eps", [0.05, 0.3, 0.9, 2.5, 40.0])
def test_tree_integer_fields_equal_jax(eps, dense):
    """eps=40 diverges on the first leaf of every chain; 0.05 runs deep."""
    r = _both(11, eps, dense=dense)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(r["tst"], f).numpy(),
                                      np.asarray(getattr(r["jst"], f)),
                                      err_msg=f"{f} eps={eps}")
    np.testing.assert_allclose(r["tst"].acceptance_rate.numpy(),
                               np.asarray(r["jst"].acceptance_rate),
                               rtol=1e-10, atol=1e-12)
    if eps == 40.0:
        assert np.all(r["tst"].termination.numpy() == Termination.DIVERGENCE)
        np.testing.assert_array_equal(r["tz"].q.numpy(), r["q0"])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("eps", [0.05, 0.9, 2.5])
def test_tree_matches_oracle(seed, eps):
    r = _both(seed, eps)
    prec = r["prec"]

    def logp_np(q):
        return -0.5 * float(q @ (prec * q)), -prec * q

    st = r["tst"]
    for i in range(r["q0"].shape[0]):
        want = oracle_trajectory(logp_np, r["inv"], r["q0"][i], r["p0"][i],
                                 eps, int(r["dirs"][i]),
                                 max_depth=r["max_depth"])
        tag = f"chain {i} seed {seed} eps {eps}"
        assert TERM_NAME[int(st.termination[i])] == want["termination"], tag
        assert int(st.depth[i]) == want["depth"], tag
        assert int(st.steps[i]) == want["steps"], tag
        if want["termination"] != "max_depth":
            assert int(st.term_left[i]) == want["term_left"], tag
            assert int(st.term_right[i]) == want["term_right"], tag
        np.testing.assert_allclose(float(st.acceptance_rate[i]),
                                   want["accept"], atol=1e-8, err_msg=tag)
        # the proposal is a leaf of the final trajectory
        delta = float(st.energy[i]) - want["pi0"]
        assert any(abs(w - delta) < 1e-8 for w in want["leaves"].values()), \
            tag


def test_proposals_follow_multinomial_weights():
    """One chain, one fixed trajectory, 4000 repeated transitions on the
    batch axis: the proposal lands on each leaf of the oracle trajectory
    with the frequency its weight implies under biased progressive sampling
    (computed exactly below).  Chi-square against the exact law."""
    d, reps, eps = 2, 4000, 0.35
    prec = np.array([1.0, 2.0])
    inv = np.array([1.0, 0.7])
    q0 = np.array([[0.8, -0.4]])
    p0 = np.array([[0.3, 0.9]])
    dirs = np.uint32(0b0101)
    _, tpot = _quadratic(prec)

    def logp_np(q):
        return -0.5 * float(q @ (prec * q)), -prec * q

    want = oracle_trajectory(logp_np, inv, q0[0], p0[0], eps, int(dirs),
                             max_depth=4)
    assert want["termination"] in ("turning", "max_depth")
    tq = torch.as_tensor(np.repeat(q0, reps, 0))
    lp, g = tpot(tq)
    z, st = tnuts(torch.Generator().manual_seed(7), tpot,
                  tdiag(torch.as_tensor(inv)), TEval(q=tq, logp=lp, grad=g),
                  eps, max_depth=4,
                  directions=torch.full((reps,), int(dirs), dtype=torch.int64),
                  momentum=torch.as_tensor(np.repeat(p0, reps, 0)))
    assert len(set(st.depth.tolist())) == 1
    depth = int(st.depth[0])

    # exact proposal law of biased progressive sampling over the doublings
    # that completed: leaves in build order, grouped by doubling
    pos_w = want["leaves"]
    groups, i_l, i_r = [[0]], 0, 0
    for dd in range(depth):
        fwd = (int(dirs) >> dd) & 1
        n = 1 << dd
        if fwd:
            groups.append(list(range(i_r + 1, i_r + n + 1)))
            i_r += n
        else:
            groups.append(list(range(i_l - 1, i_l - n - 1, -1)))
            i_l -= n
    prob = {0: 1.0}
    omega = 0.0
    for grp in groups[1:]:
        w = np.array([pos_w[i] for i in grp])
        om_sub = np.logaddexp.reduce(w)
        take = min(1.0, np.exp(om_sub - omega))
        prob = {k: v * (1 - take) for k, v in prob.items()}
        for i, wi in zip(grp, w):
            prob[i] = take * np.exp(wi - om_sub)
        omega = np.logaddexp(omega, om_sub)

    delta = (st.energy.numpy() - want["pi0"])
    keys = sorted(prob)
    counts = np.zeros(len(keys))
    for dl in delta:
        j = int(np.argmin([abs(pos_w[k] - dl) for k in keys]))
        counts[j] += 1
    expected = np.array([prob[k] for k in keys]) * reps
    keep = expected > 5
    chi2 = float(((counts[keep] - expected[keep]) ** 2
                  / expected[keep]).sum())
    # 99.9% quantile of chi-square with up to 15 degrees of freedom is 37.7
    assert chi2 < 37.7, (chi2, counts, expected)


def test_max_depth_range_is_enforced():
    _, tpot = _quadratic(np.ones(2))
    q = torch.zeros((2, 2), dtype=torch.float64)
    lp, g = tpot(q)
    for md in (0, 31):
        with pytest.raises(ValueError):
            tnuts(torch.Generator(), tpot, tdiag(torch.ones(2,
                                                            dtype=torch.float64)),
                  TEval(q=q, logp=lp, grad=g), 0.5, max_depth=md)


def test_max_depth_sentinel():
    """A fine step on a flat target reaches max_depth with the (1, 0)
    sentinel and 2^md - 1 steps."""
    _, tpot = _quadratic(np.full(2, 1e-4))
    q = torch.zeros((3, 2), dtype=torch.float64)
    lp, g = tpot(q)
    _, st = tnuts(torch.Generator().manual_seed(1), tpot,
                  tdiag(torch.ones(2, dtype=torch.float64)),
                  TEval(q=q, logp=lp, grad=g), 0.01, max_depth=4)
    assert np.all(st.termination.numpy() == Termination.MAX_DEPTH)
    assert np.all(st.depth.numpy() == 4) and np.all(st.steps.numpy() == 15)
    assert np.all(st.term_left.numpy() == 1)
    assert np.all(st.term_right.numpy() == 0)
