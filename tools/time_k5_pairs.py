#!/usr/bin/env python3
"""Time kernels of two checkouts against each other on one card.

Builds the sources of this checkout and of the checkout ``--old`` (an
older launcher without an argument this checkout's has, K5's ``path`` or
``ckpt_bf16``, K1's ``grad_bf16``, is called without it, and this
checkout's then runs with it at its default), then for each case launches
both on the same inputs (their outputs must be equal bit for bit) in
``--pairs`` alternating pairs, old then new, new then old, each side timed
with CUDA events as the mean of ``--reps`` launches queued back to back
after one warm-up (``chip_smoke.cuda_time_ms``).  Prints each pair, the medians,
the spread of each side's own times, the median of new / old, the pairs in
which new was faster, and for K5 the plan this checkout's launcher makes
(``ops.tree.plan_on_card``) and the time per ``[D, D]`` product on the
longest chain.  Cases:

* ``gauss_dense``: the Gaussian's dense launcher at 10,240 x 100 (config
  1's dense windows), an SPD M^-1 (``chip_smoke._spd``), eps 0.3;
* ``stoch_vol``: K5-stoch_vol's dense launcher at T = 100 (1,024 x 102),
  start ``chip_smoke.tile_start``, an SPD M^-1, eps 0.02;
* ``stoch_vol_wide``: the same at T = 1,000 (1,024 x 1,002: the wide
  form), with float32 and with bfloat16 stacks; ``stoch_vol_wide_one``:
  one chain at eps 0.002 (one cluster streaming the 4 MB M^-1);
  ``stoch_vol_wide_eps``: 1,024 chains at eps 0.2 (shallow trees) and
  0.002 (deep ones for every chain), float32 stacks;
* ``dense_gaussian_wide``: the dense Gaussian's wide form at 256 x 512
  (``chip_smoke.py``'s Wishart precision at the 250-D target's ratio of
  degrees of freedom) under its diagonal metric at half the stability
  limit (``P q`` alone) and under its dense M^-1 at eps 0.3;
* ``cluster_dims``: stochastic volatility at T = D - 2 for D = 257, 512,
  1,002 and 2,048 under an SPD M^-1, 1,024 chains at eps 0.02 and one
  chain at eps 0.002 (with ``--paths``: each cluster of the wide form
  against the register path, and the clusters the card holds at once);
* ``mvn``: the dense Gaussian at 1,024 x 250 (``chip_smoke.mvn_target``)
  under its dense M^-1 (eps 0.3) and under its diagonal, which times
  ``P q`` alone (eps half the stability limit);
* ``dims``: the dense Gaussian (a Wishart precision) at 1,024 chains
  under an SPD M^-1, eps 0.25, at each D of ``DIMS``;
* ``small``: the dense launchers of eight schools and the funnel at their
  D = 10 (1,024 chains, ``chip_smoke.tile_start``, an SPD M^-1, eps 0.3
  and 0.2), and the dense Gaussian as ``dims`` at each D of
  ``SMALL_DIMS``;
* ``diag``: the diagonal launchers of the Gaussian (10,240 x 100, eps
  0.3), stochastic volatility (1,024 chains at T = 100 and 1,000, eps
  0.02) and logistic regression (the ``logistic`` case under its
  covariance's diagonal), M^-1 ``0.5 + U(0, 1)`` but for logistic;
* ``moved``: the instantiations whose SASS ``tools/compare_sass.py``
  found moved by PR 17's tile form (their source unchanged in effect),
  beside those the cases above take: the Gaussian's diagonal launcher at
  D = 10, 50 and 200 (1,024 chains, eps 0.3), its wide form at 1,024 x
  1,000 under a diagonal and an SPD M^-1, the dense Gaussian's wide form
  at 256 x 512 (a Wishart precision) under its diagonal and an SPD M^-1,
  and stochastic volatility's diagonal launcher at T = 21 and 50;
* ``logistic``: K5-logistic's dense launcher, BASELINE config 3 (8,192
  chains x 10,000 x 50, ``chip_smoke.logistic_problem``), dense M^-1 the
  Laplace covariance, eps half the stability limit, start drawn about the
  truth;
* ``k1``, ``k1_bf16``, ``k2``: K1 (``csrc/logistic_vg.cu``), K1 with
  ``grad_bf16`` and K2 (the packed forward) at config 3's data (10,000 x
  50), chains about the true coefficients, at 1, 64, 1,024 and 8,192
  chains; both sides held against the float64 plain version within
  ``chip_smoke.py``'s tolerances (the two bodies sum in other orders, so
  their outputs are not compared bit for bit), an older body called
  through its own argument list; ``k1`` also at D = 300 (1,024 chains),
  this checkout alone (an older body may refuse D > 256);
* ``k3``: K3 (``csrc/leapfrog_gaussian.cu``) at 64 x 1000 (the lockstep
  1000-D run's step) and at 10,240 x 100.

The K5 and K3 cases' outputs must be equal bit for bit, but for
K5-logistic against an older one-warp body (``old_rows``): both sides are
then held against the plain version (``chip_smoke.compare_tree``).  In
the wide form under a dense metric, where this checkout's wrapper asks for
a cluster of blocks if the launch's chains in flight are few
(``ops.tree.cluster_of``; each label prints them and the wrapper's K), an
older checkout, which has none, runs its register path.  The K5 cases run
max_depth 10, one transition drawing its momentum,
direction and uniforms, the momentum through ``mass_chol`` (the refresh).
With ``--paths`` the K5 cases time this checkout alone, forced through
every staged path their shape admits, each output equal bit for bit to
the plan's own.  With ``--tail`` they time this checkout alone with every
chain valid against only the deepest chain valid (the launch's ``valid``
column; an invalid row skips its tree at once), and print the time per
``[D, D]`` product of that chain alone: a launch whose time is that of its
deepest chain is bound by that chain's serial products, one far above it
by what all chains share (L2's bandwidth)::

    python3 tools/time_k5_pairs.py --old DIR [--cases mvn k1 k1_bf16 k2 k3]
        [--pairs 12] [--reps 5] [--paths | --tail]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CASES = ("gauss_dense", "stoch_vol", "stoch_vol_wide", "stoch_vol_wide_one",
         "stoch_vol_wide_eps", "dense_gaussian_wide", "cluster_dims", "mvn", "dims", "small",
         "logistic", "diag", "moved", "k1", "k1_bf16", "k2", "k3")
#: the logistic cases (K1, K1 with grad_bf16, K2) and their chain counts
LOGISTIC_LEAVES = ("k1", "k1_bf16", "k2")
LEAF_CHAINS = (1, 64, 1024, 8192)
#: the ``dims`` case's D: each side of the one-warp form's register bounds
#: and of the plan's ring bound, and the largest one-warp D
DIMS = (128, 129, 200, 256)
#: the ``small`` case's D: the one-warp form's first two register counts
SMALL_DIMS = (32, 50, 64)
#: the ``cluster_dims`` case's D: one past a warp, two warps, config 5's
#: T = 1,000 and the largest D
CLUSTER_DIMS = (257, 512, 1002, 2048)


def _cases(name: str) -> list:
    """The runs of a K5 case, on the card: dicts of the physics, its bound
    data (``phys``), q0, the metric ``minv`` (``[D, D]``, or ``[D]``: the
    diagonal launcher), eps and the stack type."""
    import torch

    import chip_smoke as cs
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 70)
    if name == "logistic":
        _, _, beta, h, cov, data = cs.logistic_problem()
        chol = torch.linalg.cholesky(cov)
        limit = 2.0 / torch.linalg.eigvalsh(chol.T @ h @ chol).max() \
            .item() ** 0.5
        q0 = (beta.double() + torch.randn(
            (cs.C, cs.D), generator=gen, dtype=torch.float64,
            device="cuda") @ chol.T).float().contiguous()
        return [dict(physics="logistic", phys=cs._physics("logistic", data),
                     q0=q0, minv=cov.float().contiguous(), eps=0.5 * limit)]
    if name == "gauss_dense":
        d = cs.G_DIM
        return [dict(physics="gaussian",
                     phys=cs._physics("gaussian", {
                         "lam": torch.ones((d,), device="cuda")}),
                     q0=torch.randn((cs.G_CHAINS, d), generator=gen,
                                    device="cuda"),
                     minv=cs._spd(d, gen).contiguous(), eps=0.3)]
    if name == "mvn":
        model, sigma = cs.mvn_target()
        prec = model.structure["precision"]
        chol = torch.linalg.cholesky(sigma)
        var = torch.diag(sigma)
        pre = prec.double() * torch.sqrt(var[:, None] * var[None, :])
        limit = 2.0 / float(torch.linalg.eigvalsh(pre).max()) ** 0.5
        q0 = (torch.randn((cs.MVN_CHAINS, cs.MVN_DIM), generator=gen,
                          dtype=torch.float64, device="cuda")
              @ chol.T).float().contiguous()
        sigma32 = sigma.float()
        phys = cs._physics("dense_gaussian", {"prec": prec})
        return [dict(physics="dense_gaussian", phys=phys, q0=q0,
                     minv=(0.5 * (sigma32 + sigma32.T)).contiguous(),
                     eps=0.3),
                dict(physics="dense_gaussian", phys=phys, q0=q0,
                     minv=var.float().contiguous(), eps=0.5 * limit)]
    if name in ("dims", "small"):
        runs = []
        if name == "small":
            for tile, eps in (("eight_schools", 0.3), ("funnel", 0.2)):
                st = cs.tile_model(tile).structure
                runs.append(dict(
                    physics=tile,
                    phys=cs._physics(tile, {**st["data"], **st["scalars"]}),
                    q0=cs.tile_start(tile, cs.E_CHAINS, gen),
                    minv=cs._spd(10, gen).contiguous(), eps=eps))
        for d in DIMS if name == "dims" else SMALL_DIMS:
            x = torch.randn((d, 2 * d), generator=gen, device="cuda")
            prec = x @ x.T / (2 * d)
            runs.append(dict(
                physics="dense_gaussian",
                phys=cs._physics("dense_gaussian",
                                 {"prec": (0.5 * (prec + prec.T))
                                  .contiguous()}),
                q0=0.5 * torch.randn((cs.MVN_CHAINS, d), generator=gen,
                                     device="cuda"),
                minv=cs._spd(d, gen).contiguous(), eps=0.25))
        return runs
    if name == "diag":
        # the diagonal launchers of physics without a matrix: the
        # Gaussian, stochastic volatility at T = 100 and 1,000, logistic
        runs = [dict(physics="gaussian",
                     phys=cs._physics("gaussian", {
                         "lam": torch.ones((cs.G_DIM,), device="cuda")}),
                     q0=torch.randn((cs.G_CHAINS, cs.G_DIM), generator=gen,
                                    device="cuda"),
                     minv=0.5 + torch.rand((cs.G_DIM,), generator=gen,
                                           device="cuda"), eps=0.3)]
        for t in (cs.SV_T, cs.SV_WIDE_T):
            st = cs.tile_model("stoch_vol", t).structure
            runs.append(dict(
                physics="stoch_vol",
                phys=cs._physics("stoch_vol",
                                 {**st["data"], **st["scalars"]}),
                q0=cs.tile_start("stoch_vol", cs.E_CHAINS, gen, sv_t=t),
                minv=0.5 + torch.rand((t + 2,), generator=gen,
                                      device="cuda"), eps=0.02))
        log = _cases("logistic")[0]
        return runs + [{**log, "minv": torch.diagonal(log["minv"])
                        .contiguous()}]
    if name == "dense_gaussian_wide":
        # the dense Gaussian's wide form at 256 x 512 (chip_smoke.py's
        # MVN_WIDE case: a Wishart precision at the 250-D target's ratio of
        # degrees of freedom), under its diagonal metric at half the
        # stability limit (P q alone) and under its dense M^-1 at eps 0.3
        model, sigma = cs.mvn_target(cs.MVN_WIDE_DIM, cs.MVN_WIDE_DF)
        prec = model.structure["precision"]
        var = torch.diag(sigma)
        pre = prec.double() * torch.sqrt(var[:, None] * var[None, :])
        limit = 2.0 / float(torch.linalg.eigvalsh(pre).max()) ** 0.5
        q0 = (torch.randn((cs.MVN_WIDE_CHAINS, cs.MVN_WIDE_DIM),
                          generator=gen, dtype=torch.float64, device="cuda")
              @ torch.linalg.cholesky(sigma).T).float().contiguous()
        sigma32 = sigma.float()
        phys = cs._physics("dense_gaussian", {"prec": prec})
        return [dict(physics="dense_gaussian", phys=phys, q0=q0,
                     minv=var.float().contiguous(), eps=0.5 * limit),
                dict(physics="dense_gaussian", phys=phys, q0=q0,
                     minv=(0.5 * (sigma32 + sigma32.T)).contiguous(),
                     eps=0.3)]
    if name == "cluster_dims":
        # stochastic volatility at T = D - 2 under an SPD M^-1, 1,024
        # chains at eps 0.02 (stoch_vol_wide's) and one chain at 0.002
        runs = []
        for d in CLUSTER_DIMS:
            st = cs.tile_model("stoch_vol", d - 2).structure
            phys = cs._physics("stoch_vol", {**st["data"], **st["scalars"]})
            minv = cs._spd(d, gen).contiguous()
            for c, eps in ((cs.E_CHAINS, 0.02), (1, 0.002)):
                runs.append(dict(physics="stoch_vol", phys=phys, minv=minv,
                                 q0=cs.tile_start("stoch_vol", c, gen,
                                                  sv_t=d - 2), eps=eps))
        return runs
    if name == "moved":
        runs = []
        for d in (10, 50, 200, 1000):
            phys = cs._physics("gaussian",
                               {"lam": torch.ones((d,), device="cuda")})
            q0 = torch.randn((cs.E_CHAINS, d), generator=gen, device="cuda")
            runs.append(dict(physics="gaussian", phys=phys, q0=q0,
                             minv=0.5 + torch.rand((d,), generator=gen,
                                                   device="cuda"), eps=0.3))
            if d == 1000:
                runs.append(dict(physics="gaussian", phys=phys, q0=q0,
                                 minv=cs._spd(d, gen).contiguous(),
                                 eps=0.3))
        d = 512
        x = torch.randn((d, 2 * d), generator=gen, device="cuda")
        prec = (x @ x.T / (2 * d)).contiguous()
        phys = cs._physics("dense_gaussian",
                           {"prec": (0.5 * (prec + prec.T)).contiguous()})
        q0 = 0.5 * torch.randn((256, d), generator=gen, device="cuda")
        runs += [dict(physics="dense_gaussian", phys=phys, q0=q0,
                      minv=(1.0 / torch.diagonal(prec)).contiguous(),
                      eps=0.25),
                 dict(physics="dense_gaussian", phys=phys, q0=q0,
                      minv=cs._spd(d, gen).contiguous(), eps=0.25)]
        for t in (21, 50):
            st = cs.tile_model("stoch_vol", t).structure
            runs.append(dict(
                physics="stoch_vol",
                phys=cs._physics("stoch_vol",
                                 {**st["data"], **st["scalars"]}),
                q0=cs.tile_start("stoch_vol", cs.E_CHAINS, gen, sv_t=t),
                minv=0.5 + torch.rand((t + 2,), generator=gen,
                                      device="cuda"), eps=0.02))
        return runs
    t = cs.SV_WIDE_T if name.startswith("stoch_vol_wide") else cs.SV_T
    st = cs.tile_model("stoch_vol", t).structure
    phys = cs._physics("stoch_vol", {**st["data"], **st["scalars"]})
    c = 1 if name == "stoch_vol_wide_one" else cs.E_CHAINS
    q0 = cs.tile_start("stoch_vol", c, gen, sv_t=t)
    minv = cs._spd(t + 2, gen).contiguous()
    run = dict(physics="stoch_vol", phys=phys, q0=q0, minv=minv, eps=0.02)
    if name == "stoch_vol_wide_one":
        return [{**run, "eps": 0.002}]
    if name == "stoch_vol_wide_eps":
        return [{**run, "eps": 0.2}, {**run, "eps": 0.002}]
    return [run] + ([{**run, "bf16": True}] if name == "stoch_vol_wide"
                    else [])


def _leaf_cases(names):
    """(label, attribute of ``ops.leapfrog`` holding the kernel, its
    module, call) of the K3 cases, on the card."""
    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.ops import leapfrog
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 80)
    cases = []
    if "k3" in names:
        for c, d in ((cs.S_CHAINS, cs.W_DIM), (cs.G_CHAINS, cs.G_DIM)):
            lam = 0.5 + torch.rand((d,), generator=gen, device="cuda")
            minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
            q3 = torch.randn((c, d), generator=gen, device="cuda")
            p3 = torch.randn((c, d), generator=gen, device="cuda")
            e = torch.full((c,), 0.3, device="cuda")
            cases.append((
                f"k3, {c} x {d}", "LEAPFROG_GAUSSIAN", leapfrog,
                lambda q3=q3, p3=p3, e=e, lam=lam, minv=minv:
                    leapfrog.fused_gaussian_leapfrog(q3, p3, e, lam, minv)))
    return cases


def _logistic_pairs(names, old_dir: str, pairs: int, reps: int,
                    card: str) -> None:
    """The ``k1``, ``k1_bf16`` and ``k2`` cases: at each of
    ``LEAF_CHAINS`` this checkout's wrapper (its plane made once, as the
    potential makes it) and the older body's launcher, each held against
    the float64 plain version (logp to ``LOGP_TOL`` of sum|terms|; K1's
    gradient to ``GRAD_TOL`` of max|grad|, K2's each component to
    ``LOGP_TOL`` of sum_n |resid x|), then timed in alternating pairs;
    ``k1`` at D = 300 this checkout alone.  An older body that takes X
    itself (no plane) is called with its own arguments."""
    import ctypes

    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops import logistic as L
    from inplacedhmc_tpu_torch.ops.cuda_build import CudaKernel, build_all
    from inplacedhmc_tpu_torch.sample import f32_matmuls

    with open(os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                           "logistic_vg.cu")) as f:
        old_planes = "const float* plane" in f.read()

    class Old(CudaKernel):
        @property
        def source_path(self) -> str:
            return os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                                self.source)

    vp, f32, i64, i32 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
                         ctypes.c_int)
    if old_planes:
        old = {"vg": Old(L.LOGISTIC_VG.source, L.LOGISTIC_VG.symbol,
                         L.LOGISTIC_VG.argtypes),
               "packed": Old(L.LOGISTIC_PACKED.source,
                             L.LOGISTIC_PACKED.symbol,
                             L.LOGISTIC_PACKED.argtypes),
               "occupancy": Old(L.LOGISTIC_OCCUPANCY.source,
                                L.LOGISTIC_OCCUPANCY.symbol,
                                L.LOGISTIC_OCCUPANCY.argtypes)}
    else:
        old = {"vg": Old("logistic_vg.cu", "logistic_vg_launch",
                         [vp] * 4 + [f32, vp, vp, i64, i64, i32, i32, vp]),
               "packed": Old("logistic_vg.cu", "logistic_packed_launch",
                             [vp] * 6 + [f32, vp, vp, i64, i64, i32, vp])}
    build_all([L.LOGISTIC_VG, old["vg"]])
    n, d, s2 = cs.N, cs.D, cs.INV_VAR
    x, y, beta = synthetic_data(cs.SEED, n, d, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 80)
    q_all = beta + 0.1 * torch.randn((max(LEAF_CHAINS), d), generator=gen,
                                     device="cuda")
    w = torch.ones_like(y)
    x_hi, x_lo = L.split_bf16(x)

    def old_call(form, q):
        c = q.shape[0]
        logp = torch.empty((c,), device="cuda")
        grad = torch.empty((c, d), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if old_planes:
            out = (ctypes.c_int * len(L.OCCUPANCY_FIELDS))()
            old["occupancy"].call(L.FORMS["packed" if form == "packed"
                                         else "f32"], d,
                                  ctypes.addressof(out))
            splits = L.launch_splits(c, n, out[0], out[2])
            part = torch.empty((splits * c * (d + 1),), device="cuda")
            plane = planes[form]
            head = (q.data_ptr(), plane.data_ptr(), s2, logp.data_ptr(),
                    grad.data_ptr(), part.data_ptr(), c, n, d)
            if form == "packed":
                old["packed"].launch(*head, splits, stream)
            else:
                old["vg"].launch(*head, int(form == "grad_bf16"), splits,
                                 stream)
        elif form == "packed":
            old["packed"].launch(q.data_ptr(), x_hi.data_ptr(),
                                 x_lo.data_ptr(), x.data_ptr(), y.data_ptr(),
                                 w.data_ptr(), s2, logp.data_ptr(),
                                 grad.data_ptr(), c, n, d, stream)
        else:
            old["vg"].launch(q.data_ptr(), x.data_ptr(), y.data_ptr(),
                             w.data_ptr(), s2, logp.data_ptr(),
                             grad.data_ptr(), c, n, d,
                             int(form == "grad_bf16"), stream)
        return logp, grad

    def new_call(form, q, xx=x, yy=y, ww=w, plane=None):
        plane = planes[form] if plane is None else plane
        if form == "packed":
            return L.logistic_value_and_grad_packed(
                q, x_hi, x_lo, xx, yy, ww, s2, planes=plane)
        return L.logistic_value_and_grad(q, xx, yy, ww, s2,
                                         grad_bf16=form == "grad_bf16",
                                         planes=plane)

    def check(label, form, q, out, xx=x, yy=y, ww=w):
        q64, x64, y64, w64 = (t.double() for t in (q, xx, yy, ww))
        if form == "packed":
            with f32_matmuls():
                lp_ref, g_ref = L.logistic_value_and_grad_packed_plain(
                    q64, x_hi, x_lo, x64, y64, w64, s2)
        else:
            lp_ref, g_ref = L.logistic_value_and_grad_plain(
                q64, x64, y64, w64, s2, grad_bf16=form == "grad_bf16")
        eta = q64 @ x64.T
        scale = (w64 * (y64 * eta - torch.logaddexp(torch.zeros_like(eta),
                                                    eta))).abs().sum(1) \
            + 0.5 * s2 * (q64 * q64).sum(1)
        lp_err = ((out[0].double() - lp_ref).abs() / scale).max().item()
        if form == "packed":
            gscale = ((y64 - torch.sigmoid(eta)) * w64).abs() @ x64.abs() \
                + s2 * q64.abs()
            g_err = ((out[1].double() - g_ref).abs() / gscale).max().item()
            g_tol = cs.LOGP_TOL
        else:
            g_err = ((out[1].double() - g_ref).abs().max()
                     / g_ref.abs().max()).item()
            g_tol = cs.GRAD_TOL
        print(f"[pairs] {label}: logp err / sum|terms| {lp_err:.3e} (tol "
              f"{cs.LOGP_TOL:g}), grad err {g_err:.3e} (tol {g_tol:g})")
        if not (lp_err <= cs.LOGP_TOL and g_err <= g_tol):
            raise RuntimeError(f"{label} disagrees with the plain version")

    forms = {"k1": "f32", "k1_bf16": "grad_bf16", "k2": "packed"}
    planes = {f: L.logistic_planes(x, y, w, f, x_hi, x_lo)
              for f in forms.values()}
    for name in (k for k in LOGISTIC_LEAVES if k in names):
        form = forms[name]
        for c in LEAF_CHAINS:
            q = q_all[:c].contiguous()
            label = f"{name}, {c} x {n} x {d}"
            check(f"{label}, old", form, q, old_call(form, q))
            check(f"{label}, new", form, q, new_call(form, q))
            time_pairs(label, lambda: old_call(form, q),
                       lambda: new_call(form, q), pairs, reps, card,
                       same="each within the tolerances of the plain "
                            "version")
    if "k1" in names:
        c, nw, dw = cs.K1_WIDE
        xw, yw, bw = synthetic_data(cs.SEED + 5, nw, dw, device="cuda")
        ww = torch.ones_like(yw)
        q = (bw + 0.1 * torch.randn((c, dw), generator=gen,
                                    device="cuda")).contiguous()
        plane = L.logistic_planes(xw, yw, ww)
        label = f"k1, {c} x {nw} x {dw}, new alone"
        run = lambda: new_call("f32", q, xw, yw, ww, plane)  # noqa: E731
        check(label, "f32", q, run(), xw, yw, ww)
        times = [cs.cuda_time_ms(run, reps, 1) for _ in range(pairs)]
        print(f"[pairs] {label}: median {statistics.median(times):.4f} ms "
              f"(spread {min(times):.4f}-{max(times):.4f}), "
              f"{cs.logistic_bound(c, nw, dw)['text']}, on {card}")


def _products(physics: str, dense: bool, n_leaf: int) -> int:
    """The ``[D, D]`` products of a chain of ``n_leaf`` leaves in one
    refreshing transition: two a leaf, one at the start and one for the
    momentum under a dense metric; the dense Gaussian's one a leaf, at the
    start and for the final gradient."""
    return (physics == "dense_gaussian") * (n_leaf + 2) \
        + dense * (2 * n_leaf + 2)


def _time_paths(label, run, kernel, physics, d, dense, bf16, n_prod, ref,
                card, reps) -> None:
    """This checkout's launch forced through each path its shape admits:
    outputs equal bit for bit to the plan's own (``ref``); each timed
    (``chip_smoke.cuda_time_ms``, ``reps`` launches after one warm-up)
    with its microseconds per product on the longest chain and the blocks
    an SM holds."""
    import chip_smoke as cs
    from inplacedhmc_tpu_torch.ops import tree
    print(f"[paths] {label}")
    for path in tree.PATHS:
        try:
            plan, blocks = tree.plan_on_card(physics, d, cs.MAX_DEPTH, dense,
                                             True, bf16, path)
        except RuntimeError:
            continue
        out = run(kernel, path)
        if not all(cs.bits_equal(getattr(out, f), getattr(ref, f))
                   for f in tree.TreeOut._fields):
            raise RuntimeError(f"{label}: the {path} path differs from the "
                               f"plan's own")
        ms = cs.cuda_time_ms(lambda: run(kernel, path), reps, 1)
        clusters = ""
        if plan.cluster > 1:
            held = tree.active_clusters(physics, d, cs.MAX_DEPTH, dense,
                                        True, bf16, path)
            clusters = f", {held} clusters of {plan.cluster} at once"
        print(f"[paths]   {path}, {plan.stages} stages of {plan.rows} rows "
              f"({plan.in_flight(d)} bytes in flight), {plan.warps} chains "
              f"a block, {plan.smem_bytes} bytes, {blocks} blocks an SM"
              f"{clusters}: {ms:.4f} ms, {ms / n_prod * 1e3:.2f} us per "
              f"product on the longest chain, on {card}; outputs equal")


def _label(name, r, b, plan, blocks, n_prod) -> str:
    """A K5 case's label: its shape, metric, stacks, step size, steps, its
    longest chain, its chains in flight and this checkout's plan (in the
    wide form under a dense metric, the wrapper's K for them)."""
    from inplacedhmc_tpu_torch.ops import tree
    c, d = r["q0"].shape
    dense = r["minv"].ndim == 2
    spread = tree.chains_in_flight(b.steps)
    wide = f", the wrapper's K {tree.cluster_of(d, spread)}" \
        if dense and d > tree.WARP_DIM else ""
    return (f"{name}, {c} x {d}, {'dense' if dense else 'diagonal'} "
            f"metric, {'bf16' if r.get('bf16', False) else 'f32'} stacks, "
            f"eps {r['eps']:.4g}, {float(b.steps.sum()):.0f} steps, longest "
            f"chain {int(b.steps.max())} leaves ({n_prod} products), "
            f"{spread:.1f} chains in flight{wide}; new: "
            f"{plan.path}, {plan.warps} chains a block, {plan.stages} stages "
            f"of {plan.rows} rows ({plan.in_flight(d)} bytes in flight), "
            f"{blocks} blocks an SM")


def _time_alone(args, name, r, run, kernel, physics, dense, bf16, b,
                card) -> None:
    """``--paths`` or ``--tail`` for one K5 case of this checkout: ``b``
    is its launch with every chain valid."""
    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.ops import tree
    c, d = r["q0"].shape
    plan, blocks = tree.plan_on_card(physics, d, cs.MAX_DEPTH, dense, True,
                                     bf16)
    n_prod = _products(physics, dense, int(b.steps.max()))
    label = _label(name, r, b, plan, blocks, n_prod)
    if args.paths:
        _time_paths(label, run, kernel, physics, d, dense, bf16, n_prod, b,
                    card, args.reps)
        return
    deep = int(torch.argmax(b.steps[0]))
    valid = torch.zeros((c,), dtype=torch.int32, device="cuda")
    valid[deep] = 1
    one = run(kernel, valid=valid)
    for f in tree.TreeOut._fields:
        got, want = getattr(one, f), getattr(b, f)
        got, want = (got[:, deep], want[:, deep]) if f != "grad" \
            else (got[deep], want[deep])
        if not cs.bits_equal(got, want):
            raise RuntimeError(f"{name}: the deepest chain alone differs in "
                               f"{f} from its run beside the others")
    times = {"all": [], "deepest": []}
    for i in range(args.pairs):
        order = ("all", "deepest") if i % 2 == 0 else ("deepest", "all")
        for side in order:
            v = None if side == "all" else valid
            times[side].append(cs.cuda_time_ms(
                lambda v=v: run(kernel, valid=v), args.reps, 1))
    ma, md = (statistics.median(times[s]) for s in ("all", "deepest"))
    n_alone = _products(physics, dense, int(one.steps.max()))
    print(f"[tail] {label}, on {card}: every chain valid median {ma:.4f} ms "
          f"(spread {min(times['all']):.4f}-{max(times['all']):.4f}), the "
          f"deepest chain (row {deep}) alone median {md:.4f} ms (spread "
          f"{min(times['deepest']):.4f}-{max(times['deepest']):.4f}), "
          f"alone / all {md / ma:.4f} over {args.pairs} pairs; "
          f"{md / n_alone * 1e3:.2f} us per product on that chain alone "
          f"({n_alone} products); its records equal bit for bit")


def time_pairs(label: str, run_old, run_new, pairs: int, reps: int,
               card: str, n_prod: int = 0,
               same: str = "outputs equal bit for bit") -> None:
    """Time ``run_old()`` and ``run_new()`` in ``pairs`` alternating pairs
    (old first, then new first), each side the mean of ``reps`` calls
    queued back to back after one warm-up (``chip_smoke.cuda_time_ms``);
    print each pair, the medians, each side's spread and the median of new
    / old, under ``label`` (which names the case and its shape)."""
    import chip_smoke as cs
    times = {"old": [], "new": []}
    runs = {"old": run_old, "new": run_new}
    for i in range(pairs):
        order = ("old", "new") if i % 2 == 0 else ("new", "old")
        for side in order:
            times[side].append(cs.cuda_time_ms(runs[side], iters=reps,
                                               warmup=1))
        print(f"[pairs] {label} pair {i} ({order[0]} first): old "
              f"{times['old'][-1]:.4f} ms, new {times['new'][-1]:.4f} ms")
    mo, mn = (statistics.median(times[s]) for s in ("old", "new"))
    ratio = statistics.median(n / o for o, n in zip(times["old"],
                                                    times["new"]))
    per = f"; per product on the longest chain old " \
        f"{mo / n_prod * 1e3:.2f} us, new {mn / n_prod * 1e3:.2f} us" \
        if n_prod else ""
    print(f"[pairs] {label}, {same}, on {card}: old "
          f"median {mo:.4f} ms (spread {min(times['old']):.4f}-"
          f"{max(times['old']):.4f}), new median {mn:.4f} ms (spread "
          f"{min(times['new']):.4f}-{max(times['new']):.4f}); new / old "
          f"median {ratio:.4f} over {pairs} pairs; faster in "
          f"{sum(n < o for o, n in zip(times['old'], times['new']))} of "
          f"{pairs}{per}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="the earlier checkout (not read with "
                    "--paths or --tail)")
    ap.add_argument("--cases", nargs="+", default=["logistic", "stoch_vol"],
                    choices=CASES)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--paths", action="store_true",
                    help="time this checkout's K5 cases through every "
                         "path their shape admits instead")
    ap.add_argument("--tail", action="store_true",
                    help="time this checkout's K5 cases with every chain "
                         "valid against the deepest chain alone instead")
    args = ap.parse_args()
    alone = args.paths or args.tail
    if not alone and not args.old:
        ap.error("--old is needed unless --paths or --tail")

    import torch

    import chip_smoke as cs
    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops import tree
    from inplacedhmc_tpu_torch.ops.cuda_build import CudaKernel, build_all

    old_dir = os.path.abspath(args.old or HERE)

    def old_has(source: str, word: str) -> bool:
        with open(os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                               source)) as f:
            return word in f.read()

    # arguments an older launcher may lack: their places among the
    # arguments, before the stream (and K5's min_delta): K5's path (the
    # staged products), and before it its ckpt_bf16; K1's grad_bf16.  An
    # old launcher is called without them, and this checkout's then runs
    # with them at their defaults (a path of -1, the plan's own, is not
    # sent)
    lacks = {}
    for k in (*tree.TREE_KERNELS.values(),
              *tree.TREE_DENSE_KERNELS.values()):
        n = len(k.argtypes)
        if not old_has("tree_kernel.cuh", "PATH_RESIDENT"):
            lacks[k.symbol] = {n - 3: -1}
        if not old_has("tree_kernel.cuh", "ckpt_bf16"):
            lacks[k.symbol][n - 4] = 0

    # an older logistic body of one warp a chain (before the tile form)
    # reads x, y and w, not the plane this checkout's launch passes: its
    # launch gets them back in their places (obs_mat, obs_row0, obs_row1,
    # n_obs), and its outputs, in another arithmetic, are held with this
    # checkout's against the plain version, not compared bit for bit
    old_rows = not old_has("tree_logistic.cu", "kTile")

    class OldKernel(CudaKernel):
        def __init__(self, new: CudaKernel):
            self.at = lacks.get(new.symbol, {})
            self.obs = None
            types = [t for i, t in enumerate(new.argtypes)
                     if i not in self.at]
            super().__init__(new.source, new.symbol, types)

        @property
        def source_path(self) -> str:
            return os.path.join(old_dir, "inplacedhmc_tpu_torch", "csrc",
                                self.source)

        def launch(self, *a):
            for i, default in self.at.items():
                if a[i] != default:
                    raise ValueError(f"the old {self.symbol} lacks an "
                                     f"argument this call sets")
            if self.obs is not None:
                a = list(a)
                a[11:15] = [*(t.data_ptr() for t in self.obs),
                            self.obs[0].shape[0]]
            super().launch(*(x for i, x in enumerate(a) if i not in self.at))

    k5_runs = [(name, run) for name in args.cases
               if name not in (*LOGISTIC_LEAVES, "k3")
               for run in _cases(name)]

    def kernels_of(run):
        """the launcher's dictionary and key: the dense one, or the
        diagonal one for a [D] metric"""
        return (tree.TREE_DENSE_KERNELS if run["minv"].ndim == 2
                else tree.TREE_KERNELS), run["physics"]

    new = {}
    for _, run in k5_runs:
        table, p = kernels_of(run)
        new[table[p].symbol] = table[p]
    leaves = _leaf_cases(args.cases)
    new.update({attr: getattr(module, attr) for _, attr, module, _ in leaves})
    old = {} if alone else {key: OldKernel(k) for key, k in new.items()}
    build_all(list(new.values()))   # one nvcc per source and checkout
    build_all(list(old.values()))
    card = cs.card_line()
    if not alone:
        _logistic_pairs(args.cases, old_dir, args.pairs, args.reps, card)
    key = cs._key(cs.SEED + 71)
    for name, r in k5_runs:
        table, p = kernels_of(r)
        sym = table[p].symbol
        q0, minv, phys = r["q0"], r["minv"], r["phys"]
        e = torch.full((q0.shape[0],), r["eps"], device="cuda")
        dense = minv.ndim == 2
        scale = dense_metric(minv).mass_chol.T.contiguous() if dense \
            else (1.0 / torch.sqrt(minv)).contiguous()
        bf16 = r.get("bf16", False)

        def run(kernel, path=None, valid=None):
            table[p] = kernel
            try:
                return tree.tree_sweep(q0, e, phys, minv, cs.MAX_DEPTH,
                                       -1000.0, key=key, sqrt_mass=scale,
                                       ckpt_bf16=bf16, path=path,
                                       valid=valid)
            finally:
                table[p] = new[sym]

        if alone:
            b = run(new[sym])
            _time_alone(args, name, r, run, new[sym], p, dense, bf16, b,
                        card)
            continue
        rows = old_rows and p in tree.TILED_PHYSICS
        if rows:
            old[sym].obs = tuple(phys.data[k] for k in ("x", "y", "w"))
        # an older launcher knows no cluster path: in the wide form under a
        # dense metric, where this checkout's wrapper may ask for one, the
        # older one runs its register path (one block a chain) on the
        # matrices as they are, not on their panels
        old_path = "register" if dense and q0.shape[1] > tree.WARP_DIM \
            else None
        a, b = run(old[sym], old_path), run(new[sym])
        if rows:
            plain = cs._first(tree.tree_sweep_plain(
                q0, e, phys, minv, cs.MAX_DEPTH, -1000.0, key=key,
                sqrt_mass=scale, ckpt_bf16=bf16))
            for side, out in (("old", a), ("new", b)):
                cs.compare_tree(cs._first(out), plain, f"{name}, {side}",
                                cs.grad_bound(phys),
                                lsa_bound=cs._long_sums(phys, q0.shape[1]))
        else:
            differ = [f for f in tree.TreeOut._fields
                      if not cs.bits_equal(getattr(a, f), getattr(b, f))]
            if differ:
                raise RuntimeError(f"{name}: old and new differ in {differ}")
        plan, blocks = tree.plan_on_card(p, q0.shape[1], cs.MAX_DEPTH,
                                         dense, True, bf16)
        n_prod = _products(p, dense, int(b.steps.max()))
        label = _label(name, r, b, plan, blocks, n_prod)
        time_pairs(label, lambda: run(old[sym], old_path),
                   lambda: run(new[sym]), args.pairs, args.reps, card,
                   n_prod)
    for label, attr, module, call in ([] if alone else leaves):
        def run(kernel, attr=attr, module=module, call=call):
            setattr(module, attr, kernel)
            try:
                return call()
            finally:
                setattr(module, attr, new[attr])

        a, b = run(old[attr]), run(new[attr])
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise RuntimeError(f"{label}: old and new differ")
        time_pairs(label, lambda: run(old[attr]), lambda: run(new[attr]),
                   args.pairs, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
