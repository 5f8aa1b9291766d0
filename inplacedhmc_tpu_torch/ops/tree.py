"""The whole NUTS transition in one kernel, for diagonal-Gaussian targets.

The port's counterpart of ``inplacedhmc_tpu/ops/tree_pallas.py`` in the form
``make_gaussian_tree_transition`` builds with explicit momentum, direction
words and proposal uniforms (``_make_kernel`` with ``dense=False`` and the
interpret-mode uniform layout).  For targets with ``grad = -Lambda q`` and a
diagonal ``M^-1`` the transition is the lockstep tree's (``nuts/tree.py``),
field for field: the momentum-refresh energy, the doubling loop, the leapfrog
leaves, the generalized U-turn checks on the checkpoint stack, the
progressive and biased proposals, divergence at ``delta < min_delta``, the
acceptance sum ``sum exp(min(delta, 0))`` and the termination records.

The proposal uniforms are an explicit ``[2^md - 1 + md, C]`` array: leaf
``n`` of the subtree of depth ``d`` reads row ``2^d - 1 + n``, the merge at
depth ``d`` row ``2^md - 1 + d``.  So a chain's result depends on its own
column only, whichever chains run beside it.

On a CUDA tensor :func:`gaussian_tree_transition` launches the hand-written
kernel ``csrc/tree_gaussian.cu`` (one warp per chain); on a CPU tensor it
runs :func:`gaussian_tree_transition_plain`, the lockstep form over all
chains in plain torch.  There is no other path: a CUDA tensor launches the
kernel or raises.

Not ported yet: the dense-metric branch, logistic and other model physics,
in-kernel random numbers (``refresh_inside``), persistent padded state,
sweeps and bf16 checkpoint stacks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.metric import DiagMetric, diag_metric, sample_momentum
from ..core.state import EvalPoint, Termination, TreeStats
from ..utils.bits import checkpoint_slot, direction_bit, trailing_ones
from .common import check_tensor
from .cuda_build import CudaKernel

#: the kernel of ``csrc/tree_gaussian.cu``; ``TREE_GAUSSIAN.launches`` counts
#: its launches
TREE_GAUSSIAN = CudaKernel(
    "tree_gaussian.cu", "tree_gaussian_launch",
    [ctypes.c_void_p] * 17 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_void_p])

#: largest dimension the kernel's register tiles take (32 lanes x 8)
MAX_DIM = 256
#: largest uniform array one transition draws, in bytes: 1 GiB takes md 10
#: up to 259,860 chains, md 14 up to 16,371.  In-kernel random numbers
#: (ROADMAP queue 2, item 1 (b)) remove the array and this limit.
MAX_UNIFORM_BYTES = 1 << 30


class TreeOut(NamedTuple):
    """What one transition returns for every chain: the proposal's ``q``,
    ``logp`` and ``grad``, ``energy = pi0 + delta`` of the proposal,
    ``log_sum_alpha = log sum exp(min(delta, 0))`` over the visited leaves,
    and the int32 records ``term``, ``term_left``, ``term_right``,
    ``depth`` and ``steps``."""

    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    energy: torch.Tensor
    log_sum_alpha: torch.Tensor
    term: torch.Tensor
    term_left: torch.Tensor
    term_right: torch.Tensor
    depth: torch.Tensor
    steps: torch.Tensor


def n_uniforms(max_depth: int) -> int:
    """Rows of the uniform array: one per leaf position, one per merge."""
    return (1 << max_depth) - 1 + max_depth


def takes(dim: int, n_chains: int, max_depth: int) -> bool:
    """Whether the kernel takes this problem: ``dim <= MAX_DIM`` and a
    float32 uniform array of at most ``MAX_UNIFORM_BYTES``."""
    return (dim <= MAX_DIM
            and 4 * n_uniforms(max_depth) * n_chains <= MAX_UNIFORM_BYTES)


def _check_max_depth(max_depth: int) -> None:
    if not 1 <= max_depth <= 30:
        # 32-bit direction words: beyond 30 the 2^d subtree length overflows
        raise ValueError(f"max_depth must be in [1, 30], got {max_depth}")


def gaussian_tree_transition_plain(q0, p0, eps, dirs, unif, lam, minv,
                                   max_depth: int, min_delta: float
                                   ) -> TreeOut:
    """Plain torch version of the kernel, in ``q0``'s dtype and on its device:
    every chain in lockstep, each update masked by the chain's own state.
    ``q0, p0 [C, D]``; ``eps [C]``; ``dirs [C]`` 32-bit direction words
    (any integer dtype); ``unif [2^md - 1 + md, C]``; ``lam, minv [D]``."""
    _check_max_depth(max_depth)
    c, dim = q0.shape
    dt, dev = q0.dtype, q0.device
    md = max_depth
    i32 = dict(dtype=torch.int32, device=dev)
    col = dict(dtype=dt, device=dev)
    eps = torch.as_tensor(eps, **col).expand(c)

    def rowsum(t):
        return torch.sum(t, dim=1)

    def where(m, a, b):
        return torch.where(m[:, None] if a.ndim == 2 else m, a, b)

    logp0 = -0.5 * rowsum(lam * q0 * q0)
    g0 = -(lam * q0)
    pi0 = logp0 - 0.5 * rowsum(p0 * minv * p0)
    left = right = (q0, p0, g0)
    ps_l = ps_r = minv * p0
    rho = p0
    prop_q, prop_delta, prop_logp = q0, torch.zeros((c,), **col), logp0
    sub_q, sub_delta, sub_logp = q0, torch.zeros((c,), **col), logp0
    omega = torch.zeros((c,), **col)
    sum_alpha = torch.zeros((c,), **col)
    i_left = torch.zeros((c,), **i32)
    i_right = torch.zeros((c,), **i32)
    steps = torch.zeros((c,), **i32)
    depth = torch.zeros((c,), **i32)
    term = torch.full((c,), Termination.MAX_DEPTH, **i32)
    tl = torch.ones((c,), **i32)    # REACHED_MAX_DEPTH sentinel (1, 0)
    tr = torch.zeros((c,), **i32)
    die_l = torch.zeros((c,), **i32)
    die_r = torch.zeros((c,), **i32)
    active = torch.ones((c,), dtype=torch.bool, device=dev)
    ckpt_s = torch.zeros((c, md, dim), **col)
    ckpt_ps = torch.zeros((c, md, dim), **col)

    for d in range(md):
        if not bool(active.any()):
            break
        isf = direction_bit(dirs, d)
        signi = torch.where(isf, 1, -1).to(torch.int32)
        eps_signed = torch.where(isf, 1.0, -1.0).to(dt) * eps
        half = (0.5 * eps_signed)[:, None]
        i_base = torch.where(isf, i_right, i_left)
        cur_q, cur_p, cur_g = (where(isf, r, l) for r, l in zip(right, left))
        s_cum = torch.zeros((c, dim), **col)
        omega_sub = torch.full((c,), -torch.inf, **col)
        alive = active
        died_div = torch.zeros_like(active)
        died_turn = torch.zeros_like(active)

        for n in range(1 << d):
            if not bool(alive.any()):
                break
            mask = alive
            p_mid = cur_p + half * cur_g
            q_new = cur_q + eps_signed[:, None] * (minv * p_mid)
            lq = lam * q_new
            logp_new = -0.5 * rowsum(lq * q_new)
            g_new = -lq
            p_new = p_mid + half * g_new
            ps_new = minv * p_new
            kin_new = 0.5 * rowsum(p_new * minv * p_new)
            joint = logp_new - torch.where(torch.isfinite(kin_new), kin_new,
                                           torch.inf)
            joint = torch.where(torch.isfinite(joint), joint, -torch.inf)
            delta = joint - pi0
            delta = torch.where(torch.isnan(delta), -torch.inf, delta)
            divergent = delta < min_delta
            q_new = torch.where(torch.isfinite(q_new), q_new, cur_q)
            p_new = torch.where(torch.isfinite(p_new), p_new, cur_p)
            g_new = torch.where(torch.isfinite(g_new), g_new, cur_g)
            ps_new = torch.where(torch.isfinite(ps_new), ps_new, 0.0)
            i_new = i_base + (n + 1) * signi

            sum_alpha = torch.where(
                mask, sum_alpha + torch.exp(torch.clamp(delta, max=0.0)),
                sum_alpha)
            steps = steps + mask.to(torch.int32)
            if n % 2 == 0:
                slot = checkpoint_slot(n)
                ckpt_s[:, slot] = s_cum
                ckpt_ps[:, slot] = ps_new
            s_cum = where(mask, s_cum + p_new, s_cum)

            turning = torch.zeros_like(active)
            turn_pos = torch.zeros((c,), **i32)
            idx_max = checkpoint_slot(n)
            for m in range(trailing_ones(n)):
                j = idx_max - m
                rho_node = s_cum - ckpt_s[:, j]
                t = (rowsum(rho_node * ckpt_ps[:, j]) < 0) \
                    | (rowsum(rho_node * ps_new) < 0)
                l_pos = i_base + (n - (2 << m) + 2) * signi
                turn_pos = torch.where(t & ~turning, l_pos, turn_pos)
                turning = turning | t
            turning = turning & ~divergent

            omega_new = torch.logaddexp(omega_sub, delta)
            u = unif[(1 << d) - 1 + n]
            upd = mask & ~divergent
            take = upd & (torch.log(u) < (delta - omega_new))
            sub_q = where(take, q_new, sub_q)
            sub_delta = torch.where(take, delta, sub_delta)
            sub_logp = torch.where(take, logp_new, sub_logp)
            omega_sub = torch.where(upd, omega_new, omega_sub)

            cur_q, cur_p, cur_g = (where(mask, a, b) for a, b in
                                   ((q_new, cur_q), (p_new, cur_p),
                                    (g_new, cur_g)))
            dd = mask & divergent
            dtn = mask & turning
            die_l = torch.where(dd, i_new, torch.where(
                dtn, torch.minimum(turn_pos, i_new), die_l))
            die_r = torch.where(dd, i_new, torch.where(
                dtn, torch.maximum(turn_pos, i_new), die_r))
            died_div = died_div | dd
            died_turn = died_turn | dtn
            alive = mask & ~(dd | dtn)

        # merge the subtree into the trajectory
        ok = alive
        u2 = unif[(1 << md) - 1 + d]
        take2 = ok & (torch.log(u2) < (omega_sub - omega))
        prop_q = where(take2, sub_q, prop_q)
        prop_delta = torch.where(take2, sub_delta, prop_delta)
        prop_logp = torch.where(take2, sub_logp, prop_logp)
        omega = torch.where(ok, torch.logaddexp(omega, omega_sub), omega)
        ps_end = minv * cur_p
        grow_r = ok & isf
        grow_l = ok & ~isf
        cur = (cur_q, cur_p, cur_g)
        right = tuple(where(grow_r, a, b) for a, b in zip(cur, right))
        left = tuple(where(grow_l, a, b) for a, b in zip(cur, left))
        ps_r = where(grow_r, ps_end, ps_r)
        ps_l = where(grow_l, ps_end, ps_l)
        i_end = i_base + (1 << d) * signi
        i_right = torch.where(grow_r, i_end, i_right)
        i_left = torch.where(grow_l, i_end, i_left)
        rho = where(ok, rho + s_cum, rho)
        depth = torch.where(ok, d + 1, depth).to(torch.int32)
        turn_top = (rowsum(rho * ps_l) < 0) | (rowsum(rho * ps_r) < 0)
        died_top = ok & turn_top
        term = torch.where(died_div, Termination.DIVERGENCE, term)
        term = torch.where(died_turn | died_top, Termination.TURNING,
                           term).to(torch.int32)
        inner = died_div | died_turn
        tl = torch.where(inner, die_l, torch.where(died_top, i_left, tl))
        tr = torch.where(inner, die_r, torch.where(died_top, i_right, tr))
        active = ok & ~turn_top

    return TreeOut(q=prop_q, logp=prop_logp, grad=-(lam * prop_q),
                   energy=prop_delta + pi0,
                   log_sum_alpha=torch.log(sum_alpha), term=term,
                   term_left=tl, term_right=tr, depth=depth, steps=steps)


def gaussian_tree_transition(q0: torch.Tensor, p0: torch.Tensor,
                             eps: torch.Tensor, dirs: torch.Tensor,
                             unif: torch.Tensor, lam: torch.Tensor,
                             minv: torch.Tensor, max_depth: int,
                             min_delta: float) -> TreeOut:
    """One transition for every chain.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/tree_gaussian.cu`` on the current stream
    (float32 and contiguous, ``dirs`` int32, ``D <= 256``) or raise."""
    if q0.device.type == "cpu":
        return gaussian_tree_transition_plain(q0, p0, eps, dirs, unif, lam,
                                              minv, max_depth, min_delta)
    if q0.device.type != "cuda":
        raise ValueError(f"tree kernel: unsupported device {q0.device}")
    _check_max_depth(max_depth)
    if q0.ndim != 2:
        raise ValueError("tree kernel: q0 must be 2-D")
    c, d = q0.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"tree kernel: D={d} outside [1, {MAX_DIM}]")
    checks = [("q0", q0, (c, d), torch.float32),
              ("p0", p0, (c, d), torch.float32),
              ("eps", eps, (c,), torch.float32),
              ("dirs", dirs, (c,), torch.int32),
              ("unif", unif, (n_uniforms(max_depth), c), torch.float32),
              ("lam", lam, (d,), torch.float32),
              ("minv", minv, (d,), torch.float32)]
    for name, t, shape, dtype in checks:
        check_tensor("tree kernel", name, t, shape, q0.device, dtype)
    f32 = dict(dtype=torch.float32, device=q0.device)
    i32 = dict(dtype=torch.int32, device=q0.device)
    out = TreeOut(q=torch.empty((c, d), **f32), logp=torch.empty((c,), **f32),
                  grad=torch.empty((c, d), **f32),
                  energy=torch.empty((c,), **f32),
                  log_sum_alpha=torch.empty((c,), **f32),
                  term=torch.empty((c,), **i32),
                  term_left=torch.empty((c,), **i32),
                  term_right=torch.empty((c,), **i32),
                  depth=torch.empty((c,), **i32),
                  steps=torch.empty((c,), **i32))
    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        TREE_GAUSSIAN.launch(
            q0.data_ptr(), p0.data_ptr(), eps.data_ptr(), dirs.data_ptr(),
            unif.data_ptr(), lam.data_ptr(), minv.data_ptr(),
            *(t.data_ptr() for t in out), c, d, max_depth, float(min_delta),
            stream)
    return out


def direction_words_int32(dirs: torch.Tensor) -> torch.Tensor:
    """32-bit direction words (int64 in ``[0, 2^32)``) as the int32 bit
    patterns the kernel reads."""
    d = dirs.to(torch.int64) & 0xFFFFFFFF
    return torch.where(d >= 2 ** 31, d - 2 ** 32, d).to(torch.int32)


def make_gaussian_tree_transition(precision, metric_inv, *,
                                  max_depth: int = 10,
                                  min_delta: float = -1000.0):
    """The whole-tree transition for ``grad = -precision * q`` targets with
    the diagonal ``metric_inv`` (a ``[D]`` tensor or a :class:`DiagMetric`).

    Returns ``transition(gen, z, eps, *, directions=None, momentum=None,
    unif=None) -> (EvalPoint, TreeStats)`` with the semantics of
    :func:`inplacedhmc_tpu_torch.nuts.tree.nuts_transition`.  ``gen`` draws,
    in this order, the momentum, the ``[C]`` direction words and the
    ``[2^md - 1 + md, C]`` proposal uniforms, each unless given.  The
    transition runs on ``z.q``'s device, in float32 on the card and in its
    dtype on the CPU."""
    _check_max_depth(max_depth)
    metric = metric_inv if isinstance(metric_inv, DiagMetric) \
        else diag_metric(torch.as_tensor(metric_inv))

    def transition(gen: torch.Generator, z: EvalPoint, eps, *,
                   directions=None, momentum=None, unif=None):
        q = z.q
        c = q.shape[0]
        dev = q.device
        dt = torch.float32 if dev.type == "cuda" else q.dtype

        def cast(t):
            return torch.as_tensor(t, device=dev).to(dt).contiguous()

        if momentum is None:
            momentum = sample_momentum(metric, gen, q.shape, q.dtype)
        if directions is None:
            directions = torch.randint(0, 2 ** 32, (c,), generator=gen,
                                       dtype=torch.int64, device=dev)
        if unif is None:
            unif = torch.rand((n_uniforms(max_depth), c), generator=gen,
                              dtype=dt, device=dev)
        out = gaussian_tree_transition(
            cast(q), cast(momentum),
            torch.as_tensor(eps, dtype=dt, device=dev).expand(c).contiguous(),
            direction_words_int32(torch.as_tensor(directions, device=dev)),
            cast(unif), cast(precision), cast(metric.inv), max_depth,
            min_delta)
        steps = out.steps
        accept = torch.exp(out.log_sum_alpha) \
            / torch.clamp(steps, min=1).to(out.log_sum_alpha.dtype)
        stats = TreeStats(
            energy=out.energy.to(q.dtype),
            acceptance_rate=torch.clamp(accept, max=1.0).to(q.dtype),
            termination=out.term, term_left=out.term_left,
            term_right=out.term_right, depth=out.depth, steps=steps)
        return (EvalPoint(q=out.q.to(q.dtype), logp=out.logp.to(q.dtype),
                          grad=out.grad.to(q.dtype)), stats)

    return transition
