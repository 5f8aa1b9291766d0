"""Port parity for the tile physics of the whole-tree kernel: eight schools
(BASELINE config 4) and Neal's funnel (config 2).

Covers ``ops/tile_physics.py`` (each model's hand-written value and
gradient), the whole-tree transition over a physics (``ops/tree.py``), the
models (``models/eight_schools.py``, ``models/funnel.py``), the bijectors
(``models/transforms.py``), ``convert.tile_model_from_numpy``, the routes
``sample.py`` picks for ``"tile_logp"`` models, and the build hash's cover
of included headers (``ops/cuda_build.py``).

On the CPU the kernel's wrapper runs its plain torch version; these tests
hold it against the JAX package on the same numpy inputs: the physics
against ``tile_logp`` with ``jax.vjp``, one transition against
``make_tree_transition(..., interpret=True)`` with the same momentum,
direction words and uniforms.  Integer records must be equal; float fields
agree within the stated f32 bound."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacedhmc_tpu.core.hamiltonian import batched_logdensity_and_grad as jbl
from inplacedhmc_tpu.core.state import EvalPoint as JEval
from inplacedhmc_tpu.models import eight_schools as jeight_schools
from inplacedhmc_tpu.models import funnel as jfunnel
from inplacedhmc_tpu.models import transforms as jtf
from inplacedhmc_tpu.ops.tree_pallas import make_tree_transition as jtree

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "eight_schools.json")


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not when pytest
    collects the file.  Every xdist worker collects every test file, and the
    JAX suite's longest module (tests/test_sampling.py) peaks within a few
    memory mappings of the per-process limit (vm.max_map_count), which
    torch's libraries would push it over.  One torch thread: the tensors are
    tiny, JAX workers hold every core, and OpenMP's spinning threads would
    slow every process of the run tenfold."""
    global torch, conv, tp, tree, cuda_build, tf, diag, W
    global NUTS, NUTSKernel, Model, Termination, DualAveraging
    global default_warmup_stages, sample, tbl, tdiag
    global eight_schools, funnel, funnel_nc
    import torch
    import inplacedhmc_tpu_torch.adapt.warmup as W
    import inplacedhmc_tpu_torch.convert as conv
    import inplacedhmc_tpu_torch.models.transforms as tf
    import inplacedhmc_tpu_torch.ops.cuda_build as cuda_build
    import inplacedhmc_tpu_torch.ops.tile_physics as tp
    import inplacedhmc_tpu_torch.ops.tree as tree
    from inplacedhmc_tpu_torch import (NUTS, DualAveraging, Termination,
                                       default_warmup_stages, sample)
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.core.hamiltonian import \
        batched_logdensity_and_grad as tbl
    from inplacedhmc_tpu_torch.core.metric import diag_metric as tdiag
    from inplacedhmc_tpu_torch.models import eight_schools, funnel, funnel_nc
    from inplacedhmc_tpu_torch.models.base import Model
    from inplacedhmc_tpu_torch.sample import NUTSKernel
    torch.set_num_threads(1)


INT_FIELDS = ("termination", "depth", "steps", "term_left", "term_right")
PLAIN_INT = ("term", "depth", "steps", "term_left", "term_right")
# f64 on both sides, the same density differentiated by hand and by
# autodiff: the sums and products of terms of order 10 in another order
F64_RTOL, F64_ATOL = 1e-12, 1e-12
# One transition in f32 through the port's plain tree and JAX's interpret
# kernel: the physics' gradient is the same function written out by hand
# here and differentiated by jax.vjp there, so each leaf's position differs
# by a few f32 ulps, compounded over at most 2^5 leaves of a trajectory
# whose values are of order 10 (eight schools' mu and y).
F32_RTOL, F32_ATOL = 1e-4, 1e-4
FUNNEL_SCALARS = {"k": 9.0, "inv_s2": 1.0 / 9.0}


def _jax_refs(data, dim):
    """The JAX tile_logp's refs: each row ``[1, dim]``."""
    return {k: jnp.asarray(np.asarray(v, np.float64).reshape(1, dim))
            for k, v in data.items()}


def _models():
    """(name, JAX model, port model from the JAX structure's numpy rows,
    the port's own model)"""
    je, jf = jeight_schools(), jfunnel(10)
    return {
        "eight_schools": (je, conv.tile_model_from_numpy(
            "eight_schools", je.structure["data"], je.dim, device="cpu"),
            eight_schools(device="cpu")),
        "funnel": (jf, conv.tile_model_from_numpy(
            "funnel", jf.structure["data"], jf.dim, scalars=FUNNEL_SCALARS,
            device="cpu"), funnel(10, device="cpu")),
    }


def _positions(name, c, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c, 10)) * scale
    if name == "eight_schools":
        q[:, 0] = 5.0 + 4.0 * rng.normal(size=c)    # mu near its posterior
    return q


@pytest.mark.parametrize("name", ["eight_schools", "funnel"])
def test_physics_matches_jax_vjp_and_autograd(name):
    """Each physics' plain value and gradient in float64 against JAX's
    ``tile_logp`` with ``jax.vjp`` on the same rows (as the TPU kernel
    differentiates it) and against autograd of the port's own model
    ``logp``: both to 1e-12 relative.  The port's model carries the JAX
    structure's rows, and ``tile_model_from_numpy`` converts them bit for
    bit."""
    jm, cm, tm = _models()[name]
    q = _positions(name, 9, 1, scale=1.5)
    st = tm.structure
    phys = tp.bind(st["physics"], {**st["data"], **st["scalars"]}, "cpu",
                   torch.float64)
    lp, g = phys(torch.as_tensor(q))
    refs = _jax_refs(jm.structure["data"], jm.dim)
    jlp, vjp = jax.vjp(lambda qq: jm.structure["tile_logp"](qq, refs),
                       jnp.asarray(q))
    (jg,) = vjp(jnp.ones_like(jlp))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp)[:, 0],
                               rtol=F64_RTOL, atol=F64_ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=F64_RTOL,
                               atol=F64_ATOL)
    alp, ag = tbl(tm.logp)(torch.as_tensor(q))
    np.testing.assert_allclose(lp.numpy(), alp.numpy(), rtol=F64_RTOL,
                               atol=F64_ATOL)
    np.testing.assert_allclose(g.numpy(), ag.numpy(), rtol=F64_RTOL,
                               atol=F64_ATOL)
    # the model's logp against JAX's, and the converted model's rows
    np.testing.assert_allclose(
        alp.numpy(), np.asarray(jax.vmap(jm.logp)(jnp.asarray(q))),
        rtol=F64_RTOL, atol=F64_ATOL)
    for k, v in jm.structure["data"].items():
        np.testing.assert_array_equal(cm.structure["data"][k].numpy(),
                                      np.asarray(v, np.float32).reshape(-1))
        np.testing.assert_array_equal(st["data"][k].numpy(),
                                      np.asarray(v, np.float32).reshape(-1))
    np.testing.assert_allclose(cm.logp(torch.as_tensor(q)).numpy(),
                               lp.numpy(), rtol=F64_RTOL, atol=F64_ATOL)


def _tree_inputs(name, seed, c=16, max_depth=5, v_shift=0.0):
    rng = np.random.default_rng(seed)
    d = 10
    q0 = _positions(name, c, seed + 100).astype(np.float32)
    q0[:, 0] += np.float32(v_shift)
    minv = (rng.gamma(3.0, size=d) * 0.5 + 0.5).astype(np.float32)
    p0 = (rng.normal(size=(c, d)) / np.sqrt(minv)).astype(np.float32)
    dirs = rng.integers(0, 2 ** 32, size=c, dtype=np.uint32)
    unif = rng.uniform(size=((1 << max_depth) - 1 + max_depth, c)) \
        .astype(np.float32)
    return dict(q0=q0, p0=p0, minv=minv, dirs=dirs, unif=unif,
                max_depth=max_depth)


def _both_transitions(name, r, eps):
    """One transition through JAX's interpret kernel and the port's plain
    tree, on the same numpy inputs."""
    jm, cm, _ = _models()[name]
    md = r["max_depth"]
    jz = JEval(q=jnp.asarray(r["q0"]), logp=jnp.zeros(len(r["q0"])),
               grad=jnp.zeros_like(jnp.asarray(r["q0"])))
    jz2, jst = jtree(jm.structure["tile_logp"], jm.structure["data"],
                     jm.dim, jnp.asarray(r["minv"]), max_depth=md,
                     block_c=16, interpret=True)(
        jax.random.PRNGKey(0), jz, eps, directions=jnp.asarray(r["dirs"]),
        momentum=jnp.asarray(r["p0"]), _unif=jnp.asarray(r["unif"]))
    st = cm.structure
    phys = tp.bind(st["physics"], {**st["data"], **st["scalars"]}, "cpu",
                   torch.float32)
    c = r["q0"].shape[0]
    before = tree.TREE_KERNELS[name].launches
    out = tree.tree_transition(
        torch.as_tensor(r["q0"]), torch.as_tensor(r["p0"]),
        torch.full((c,), eps, dtype=torch.float32),
        torch.as_tensor(r["dirs"].astype(np.int64)),
        torch.as_tensor(r["unif"]), phys, torch.as_tensor(r["minv"]), md,
        -1000.0)
    assert tree.TREE_KERNELS[name].launches == before  # CPU: plain version
    return jz2, jst, out


def _assert_same_transition(jz2, jst, out, tag):
    for f, jf in zip(PLAIN_INT, INT_FIELDS):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(jst, jf)),
                                      err_msg=f"{f} {tag}")
    accept = tree.acceptance(out.log_sum_alpha, out.steps)
    np.testing.assert_allclose(accept.numpy(), np.asarray(jst.acceptance_rate),
                               rtol=F32_RTOL, atol=F32_ATOL, err_msg=tag)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(jst.energy),
                               rtol=F32_RTOL, atol=F32_ATOL, err_msg=tag)
    for f, got, want in (("q", out.q, jz2.q), ("logp", out.logp, jz2.logp),
                         ("grad", out.grad, jz2.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=f"{f} {tag}")


@pytest.mark.parametrize("name,seed,eps", [
    ("eight_schools", 0, 0.15), ("eight_schools", 1, 0.6),
    ("funnel", 2, 0.1), ("funnel", 3, 0.5)])
def test_tree_plain_matches_jax_kernel(name, seed, eps):
    """K5's plain version with each tile physics against
    ``make_tree_transition(tile_logp, ..., interpret=True, block_c=16,
    max_depth=5)`` (``tests/test_tree_pallas.py``'s shape) with the same
    q0, momentum, direction words and uniforms: integer records equal,
    energy, acceptance, the proposal, its logp and gradient within the f32
    bound."""
    r = _tree_inputs(name, seed)
    jz2, jst, out = _both_transitions(name, r, eps)
    _assert_same_transition(jz2, jst, out, f"{name} eps {eps}")
    assert int(out.steps.sum()) > len(r["q0"])   # trees of several leaves


def test_funnel_divergent_step_matches_jax_and_stays_finite():
    """The funnel started in its neck (v about -4) at eps 2.5: nearly every
    chain diverges (an energy error below -1000, or a density that
    overflows), the records equal JAX's, and every state the transition
    returns is finite: the leaf's sanitisation keeps non-finite values out,
    as in JAX."""
    r = _tree_inputs("funnel", 4, v_shift=-4.0)
    jz2, jst, out = _both_transitions("funnel", r, 2.5)
    _assert_same_transition(jz2, jst, out, "funnel eps 2.5")
    assert int((out.term == Termination.DIVERGENCE).sum()) >= 14
    for f in ("q", "logp", "grad", "energy"):
        assert bool(torch.isfinite(getattr(out, f)).all()), f


def test_tile_sweep_bit_identical_to_sequential_transitions():
    """Eight schools: one plain sweep of 3 transitions drawing everything
    from its key equals 3 single transitions fed what the generator draws
    for that key, bit for bit."""
    m = eight_schools(device="cpu")
    st = m.structure
    phys = tp.bind(st["physics"], st["data"], "cpu", torch.float32)
    q0 = torch.as_tensor(_positions("eight_schools", 12, 5),
                         dtype=torch.float32)
    minv = torch.full((10,), 0.7)
    sqrt_mass = 1.0 / torch.sqrt(minv)
    eps = torch.full((12,), 0.3)
    key = torch.tensor([123, 456], dtype=torch.int64)
    swept = tree.tree_sweep(q0, eps, phys, minv, 6, -1000.0, 3, key=key,
                            sqrt_mass=sqrt_mass)
    xi, dirs, unif = tree.philox_draws(key, 12, 10, 6, 3)
    q = q0
    for s in range(3):
        one = tree.tree_transition(q, sqrt_mass * xi[s], eps, dirs[s],
                                   unif[s], phys, minv, 6, -1000.0)
        for f in tree.TreeOut._fields:
            if f != "grad":
                assert torch.equal(getattr(swept, f)[s], getattr(one, f)), f
        q = one.q
    assert torch.equal(swept.grad, one.grad)


BIJECTORS = [("identity", lambda m: m.identity(3)),
             ("positive", lambda m: m.positive(3)),
             ("interval", lambda m: m.interval(-1.0, 2.5, 3)),
             ("lower_bounded", lambda m: m.lower_bounded(0.5, 3)),
             ("simplex", lambda m: m.simplex(3))]


@pytest.mark.parametrize("which", [b[0] for b in BIJECTORS])
def test_transforms_match_jax(which):
    """Each bijector's forward map, log-Jacobian and inverse in float64
    against the JAX package's (per row there, batched here), and the
    inverse undoing the forward map."""
    make = dict(BIJECTORS)[which]
    jb, tb = make(jtf), make(tf)
    assert (tb.size, tb.out_size) == (jb.size, jb.out_size)
    y = np.random.default_rng(6).normal(size=(5, jb.size))
    x = tb.forward(torch.as_tensor(y))
    np.testing.assert_allclose(x.numpy(),
                               np.asarray(jax.vmap(jb.forward)(y)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tb.log_jac(torch.as_tensor(y)).numpy(),
        np.asarray(jax.vmap(lambda r: jnp.asarray(jb.log_jac(r)))(y)),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tb.inverse(x).numpy(),
                               np.asarray(jax.vmap(jb.inverse)(
                                   np.asarray(x))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tb.inverse(x).numpy(), y, rtol=1e-9,
                               atol=1e-10)


def test_transformed_model_matches_jax():
    """A model on natural parameters (a location, a scale, a probability,
    weights on a simplex): its ``logp``, autograd gradient and ``constrain``
    against the JAX package's ``transformed_model``; it carries no
    ``structure``, so it runs on autograd and the lockstep tree."""
    def spec(m):
        return {"mu": m.identity(), "sigma": m.positive(),
                "p": m.interval(0.0, 1.0), "w": m.simplex(2)}

    def jlogp_nat(pr):
        return (-0.5 * pr["mu"] ** 2 - pr["sigma"] + jnp.log(pr["p"])
                + jnp.sum(jnp.log(pr["w"])))

    def tlogp_nat(pr):
        return (-0.5 * pr["mu"] ** 2 - pr["sigma"] + torch.log(pr["p"])
                + torch.sum(torch.log(pr["w"]), dim=-1))

    jm = jtf.transformed_model("t", spec(jtf), jlogp_nat)
    tm = tf.transformed_model("t", spec(tf), tlogp_nat)
    assert tm.dim == jm.dim == 5 and tm.structure is None
    q = np.random.default_rng(7).normal(size=(6, 5))
    jlp, jg = jbl(jm.logp)(jnp.asarray(q))
    tlp, tg = tbl(tm.logp)(torch.as_tensor(q))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    jc, tc = jm.constrain(jnp.asarray(q)), tm.constrain(torch.as_tensor(q))
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-12, atol=1e-14)
    kern = NUTSKernel(tm)
    assert kern.transition_factory is None and kern.step_factory is None


def _golden():
    import json
    with open(GOLDEN) as f:
        return json.load(f)


def test_sample_eight_schools_through_the_tree_route():
    """``sample()`` on eight schools, 16 chains, a short warmup and 300
    draws, through the whole-tree route (K5's plain version with the
    ``eight_schools`` physics): finite draws, split R-hat < 1.05, acceptance
    near the 0.8 target, and the means of mu and log_tau within 5 Monte
    Carlo standard errors of the quadrature golden
    (``tests/golden/eight_schools.json``)."""
    m = eight_schools(device="cpu")
    kern = NUTSKernel(m)
    assert kern.transition_factory(tdiag(torch.ones(10)), 16) is not None
    stages = default_warmup_stages(init_steps=40, middle_steps=25,
                                   doubling_stages=2, terminating_steps=25)
    res = sample(3, m, 300, 16, warmup_stages=stages, device="cpu")
    x = res.draws.double()
    assert x.shape == (300, 16, 10) and bool(torch.isfinite(x).all())
    assert float(diag.split_rhat(x).max()) < 1.05
    assert 0.6 <= float(res.stats.acceptance_rate.mean()) <= 0.95
    g = _golden()
    ess = diag.ess_bulk(x, cap=False)
    for j, mean, sd in ((0, g["mu_mean"], g["mu_sd"]),
                        (1, g["log_tau_mean"], g["log_tau_sd"])):
        se = sd / float(ess[j]) ** 0.5
        assert abs(float(x[..., j].mean()) - mean) < 5 * se, (j, se)


@pytest.mark.parametrize("which", ["funnel", "funnel_nc"])
def test_sample_funnel_through_the_tree_route(which):
    """``sample()`` on the 10-D funnel (``delta`` 0.9, no L-BFGS start,
    ``max_depth`` 5 to keep the CPU run short), 16 chains, 200 draws:
    the centred form through K5's plain version with the ``funnel``
    physics, the non-centred one with the Gaussian physics.  Finite draws,
    the divergences counted; ``v``'s mean within 5 Monte Carlo standard
    errors of 0, and for the non-centred form R-hat < 1.05."""
    m = funnel(10, device="cpu") if which == "funnel" \
        else funnel_nc(10, device="cpu")
    stages = default_warmup_stages(
        local_optimization=None,
        stepsize_adaptation=DualAveraging(delta=0.9), init_steps=30,
        middle_steps=20, doubling_stages=2, terminating_steps=20)
    res = sample(4, m, 200, 16, warmup_stages=stages, device="cpu",
                 algorithm=NUTS(max_depth=5))
    x = res.draws.double()
    assert x.shape == (200, 16, 10) and bool(torch.isfinite(x).all())
    v = x[..., 0] if which == "funnel" else m.constrain(x)["v"]
    ess = float(diag.ess_bulk(v[..., None], cap=False)[0])
    assert abs(float(v.mean())) < 5 * 3.0 / ess ** 0.5, ess
    n_div = int((res.stats.termination == Termination.DIVERGENCE).sum())
    assert n_div >= 0
    if which == "funnel_nc":
        assert float(diag.split_rhat(x).max()) < 1.05
        assert res.warmup_state.z.q.shape == (16, 10)


def test_routes_of_tile_models(monkeypatch):
    """A ``"tile_logp"`` model whose physics has a device function takes the
    whole-tree route with a float32 diagonal metric from its own chain
    threshold (``TREE_MIN_CHAINS_BY_PHYSICS``), and autograd on the lockstep
    tree below it or with another metric; no model but a ``diag_gaussian``
    one gets the fused leapfrog.  ``funnel_nc`` is a ``diag_gaussian``
    model.  A physics without a device function runs on autograd."""
    f32 = tdiag(torch.ones(10))
    for m in (eight_schools(device="cpu"), funnel(10, device="cpu")):
        kern = NUTSKernel(m)
        monkeypatch.setitem(NUTSKernel.TREE_MIN_CHAINS_BY_PHYSICS,
                            m.structure["physics"], 64)
        assert kern.transition_factory(f32, 64) is not None
        assert kern.transition_factory(f32, 63) is None
        assert kern.transition_factory(
            tdiag(torch.ones(10, dtype=torch.float64)), 64) is None
        assert kern.step_factory is None
    nc = NUTSKernel(funnel_nc(10, device="cpu"))
    assert nc.transition_factory(f32, 1) is not None
    assert nc.step_factory(f32) is not None
    other = Model(name="t", dim=2, logp=lambda q: -(q * q).sum(-1),
                  structure={"kind": "tile_logp", "physics": "no_device"})
    kern = NUTSKernel(other)
    assert kern.transition_factory is None and kern.step_factory is None


@pytest.mark.parametrize("opts,error,match", [
    ({"n_sweep": 2, "padded_io": False}, ValueError, "padded_io"),
    ({"nsweep": 2}, ValueError, "not supported"),
    ({"ckpt_bf16": True, "grad_bf16": True}, ValueError, "not supported")])
def test_tree_opts_on_tile_models(opts, error, match):
    """``tree_opts`` on a tile model with a device physics are checked as
    for Gaussians (``ckpt_bf16`` taken, a key of logistic regression's alone
    refused); on one without, refused, saying what it lacks."""
    with pytest.raises(error, match=match):
        NUTSKernel(eight_schools(device="cpu"), tree_opts=opts)
    other = Model(name="t", dim=2, logp=lambda q: -(q * q).sum(-1),
                  structure={"kind": "tile_logp", "physics": "no_device"})
    with pytest.raises(NotImplementedError,
                       match="no hand-written device function"):
        NUTSKernel(other, tree_opts={"refresh_inside": True})


def test_tile_sample_with_flagship_tree_opts():
    """The flagship options on a tile model: eight schools sampled with
    ``refresh_inside``, ``padded_io`` and ``n_sweep`` 4 through the swept
    loop (chains padded to the ``block_c`` tile): finite draws of the
    recorded shape, acceptance near the target."""
    stages = default_warmup_stages(init_steps=30, middle_steps=20,
                                   doubling_stages=2, terminating_steps=20)
    res = sample(5, eight_schools(device="cpu"), 64, 12,
                 warmup_stages=stages, device="cpu",
                 tree_opts={"refresh_inside": True, "padded_io": True,
                            "n_sweep": 4, "block_c": 8})
    x = res.draws
    assert x.shape == (64, 12, 10) and bool(torch.isfinite(x).all())
    assert 0.5 <= float(res.stats.acceptance_rate.mean()) <= 0.97


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """The library of a source is named by a hash that covers every file it
    includes, nested includes too: changing the bytes of ``tree_kernel.cuh``
    in a copy of the sources moves every whole-tree kernel's library path,
    and only theirs; changing the source alone moves its own; changing
    ``bulk_copy.cuh``, which ``tree_kernel.cuh`` and ``logistic_vg.cu``
    include, moves them all."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    kernels = list(tree.TREE_KERNELS.values()) + [
        cuda_build.CudaKernel("logistic_vg.cu", "x", [])]
    before = [k.library_path() for k in kernels]
    assert len(set(before)) == len(before)
    header = src / "tree_kernel.cuh"
    assert [os.path.basename(p) for p in
            cuda_build.source_files(str(src / "tree_funnel.cu"))] \
        == ["tree_funnel.cu", "tree_kernel.cuh", "bulk_copy.cuh"]
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    after = [k.library_path() for k in kernels]
    assert [a != b for a, b in zip(after, before)] == \
        [True] * len(tree.TREE_KERNELS) + [False]
    funnel_cu = src / "tree_funnel.cu"
    funnel_cu.write_bytes(funnel_cu.read_bytes() + b"\n")
    again = [k.library_path() for k in kernels]
    assert [a != b for a, b in zip(again, after)] == \
        [name == "funnel" for name in tree.TREE_KERNELS] + [False]
    copies = src / "bulk_copy.cuh"
    copies.write_bytes(copies.read_bytes() + b"\n")
    last = [k.library_path() for k in kernels]
    assert all(a != b for a, b in zip(last, again))
