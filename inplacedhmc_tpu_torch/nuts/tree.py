"""Iterative multinomial NUTS with generalized U-turn termination.

The port's counterpart of ``inplacedhmc_tpu/nuts/tree.py``, in eager torch:
one Python loop over doublings and, inside it, one over the ``2^d`` leaves of
the subtree being built.  Every leaf iteration is one leapfrog step for every
chain in lockstep; chains whose trajectory ended keep computing under a mask.
The leaf index is a Python int, so the checkpoint slots and the number of
U-turn checks at a leaf are known on the host; the only device-to-host sync
is one ``.any()`` per doubling.

The algorithm is the JAX package's, field for field:

* leaf weight ``Delta = logp(q) - K(p) - pi0``;
* within a subtree, progressive multinomial proposals: leaf ``n`` replaces
  the running proposal with probability ``exp(Delta_n - logaddexp(w_sub,
  Delta_n))``;
* at each doubling, biased progressive sampling: the new subtree's proposal
  is taken with probability ``min(1, exp(w_sub - w_traj))``;
* generalized U-turn ``(rho . p#_a < 0) | (rho . p#_b < 0)`` on every node,
  through the checkpoint stack (``utils/bits.py``), and on the whole
  trajectory after each doubling;
* divergence at ``Delta < min_delta``;
* acceptance statistic ``logaddexp`` of ``min(Delta, 0)`` over every leaf.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.hamiltonian import joint_logdensity
from ..core.metric import Metric, kinetic_energy, psharp, sample_momentum
from ..core.state import EvalPoint, PhasePoint, Termination, TreeStats
from ..ops.integrator import leapfrog
from ..utils.bits import checkpoint_slot, direction_bit, trailing_ones
from ..utils.masking import bcast_where, tree_where


class _Leaf(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    logp: torch.Tensor


class _Proposal(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    delta: torch.Tensor


def _chain_dot(a, b):
    return torch.sum(a * b, dim=-1)


def nuts_transition(
    gen: torch.Generator,
    potential: Callable,
    metric: Metric,
    z: EvalPoint,
    eps,
    *,
    max_depth: int = 10,
    min_delta: float = -1000.0,
    directions: Optional[torch.Tensor] = None,
    momentum: Optional[torch.Tensor] = None,
    step_fn: Optional[Callable] = None,
) -> Tuple[EvalPoint, TreeStats]:
    """One NUTS transition for all chains.

    ``z``: the current evaluated positions ``[C, D]``; ``eps``: scalar or
    ``[C]`` step sizes; ``gen``: the generator on ``z``'s device that draws
    the momentum, the direction words and the proposal uniforms;
    ``directions``: optional ``[C]`` 32-bit direction words (fixed values
    make the tree deterministic for testing); ``momentum``: optional
    ``[C, D]`` override of the refreshed momentum; ``step_fn``: optional
    fused integrator ``(q, p, grad, logp, eps_signed) -> (q', p', grad',
    logp', kin', p#')``.

    Returns the next evaluated positions and per-chain :class:`TreeStats`.
    """
    if not 1 <= max_depth <= 30:
        # 32-bit direction words: beyond 30 the shifts and the 2^d subtree
        # length overflow
        raise ValueError(f"max_depth must be in [1, 30], got {max_depth}")
    q0 = z.q
    c, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    md = max_depth
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    if momentum is None:
        p0 = sample_momentum(metric, gen, q0.shape, dtype)
    else:
        p0 = torch.as_tensor(momentum, dtype=dtype, device=dev)
    if directions is None:
        directions = torch.randint(0, 2 ** 32, (c,), generator=gen,
                                   dtype=torch.int64, device=dev)
    else:
        directions = torch.as_tensor(directions, dtype=torch.int64,
                                     device=dev).expand(c)

    pi0 = joint_logdensity(metric, z.logp, p0)
    psharp0 = psharp(metric, p0)

    if step_fn is None:
        def step_fn(q, p, grad, logp, eps_signed):
            znew = leapfrog(potential, metric,
                            PhasePoint(Q=EvalPoint(q=q, logp=logp, grad=grad),
                                       p=p), eps_signed)
            return (znew.Q.q, znew.p, znew.Q.grad, znew.Q.logp,
                    kinetic_energy(metric, znew.p), psharp(metric, znew.p))

    left = right = _Leaf(q=q0, p=p0, grad=z.grad, logp=z.logp)
    psharp_left = psharp_right = psharp0
    i_left = torch.zeros((c,), **i32)
    i_right = torch.zeros((c,), **i32)
    rho = p0
    omega = torch.zeros((c,), dtype=dtype, device=dev)
    prop = _Proposal(q=q0, logp=z.logp, grad=z.grad, delta=omega)
    active = torch.ones((c,), dtype=torch.bool, device=dev)
    ckpt_s = torch.zeros((c, md, dim), dtype=dtype, device=dev)
    ckpt_psharp = torch.zeros((c, md, dim), dtype=dtype, device=dev)
    term_type = torch.full((c,), Termination.MAX_DEPTH, **i32)
    term_left = torch.ones((c,), **i32)     # REACHED_MAX_DEPTH sentinel (1, 0)
    term_right = torch.zeros((c,), **i32)
    depth_final = torch.zeros((c,), **i32)
    log_sum_alpha = torch.full((c,), -torch.inf, dtype=dtype, device=dev)
    steps = torch.zeros((c,), **i32)

    for d in range(md):
        if not bool(active.any()):
            break
        is_fwd = direction_bit(directions, d)
        sign = torch.where(is_fwd, 1, -1).to(torch.int32)
        eps_signed = torch.where(is_fwd, 1.0, -1.0).to(dtype) * eps
        i_base = torch.where(is_fwd, i_right, i_left)
        cur = tree_where(is_fwd, right, left)
        subtree_len = 1 << d

        alive = active
        s_cum = torch.zeros((c, dim), dtype=dtype, device=dev)
        sub_prop = prop
        omega_sub = torch.full((c,), -torch.inf, dtype=dtype, device=dev)
        died_div_any = torch.zeros((c,), dtype=torch.bool, device=dev)
        died_turn_any = torch.zeros((c,), dtype=torch.bool, device=dev)
        die_l = torch.zeros((c,), **i32)
        die_r = torch.zeros((c,), **i32)

        for n in range(subtree_len):
            mask = alive
            qn, pn, gn, lpn, kin, psharp_new = step_fn(
                cur.q, cur.p, cur.grad, cur.logp, eps_signed)
            leaf = _Leaf(q=qn, p=pn, grad=gn, logp=lpn)
            joint = lpn - torch.where(torch.isfinite(kin), kin,
                                      torch.full_like(kin, torch.inf))
            joint = torch.where(torch.isfinite(joint), joint, neg_inf)
            delta = joint - pi0
            delta = torch.where(torch.isnan(delta), neg_inf, delta)
            divergent = delta < min_delta
            i_new = i_base + (n + 1) * sign

            # visited statistics: every leaf counts
            log_sum_alpha = torch.where(
                mask, torch.logaddexp(log_sum_alpha,
                                      torch.clamp(delta, max=0.0)),
                log_sum_alpha)
            steps = steps + mask.to(torch.int32)

            # even leaves are left edges: store their data for the checks of
            # the nodes they open (the pre-leaf momentum sum, as the JAX tree)
            if n % 2 == 0:
                slot = checkpoint_slot(n)
                ckpt_s[:, slot] = s_cum
                ckpt_psharp[:, slot] = psharp_new
            s_cum = bcast_where(mask, s_cum + leaf.p, s_cum)

            # U-turn checks of the nodes [n - 2^k + 1, n] closed by this leaf,
            # k = 1..trailing_ones(n), innermost first
            turning = torch.zeros((c,), dtype=torch.bool, device=dev)
            turn_left_pos = torch.zeros((c,), **i32)
            idx_max = checkpoint_slot(n)
            for m in range(trailing_ones(n)):
                j = idx_max - m
                rho_node = s_cum - ckpt_s[:, j]
                turn = (_chain_dot(rho_node, ckpt_psharp[:, j]) < 0) \
                    | (_chain_dot(rho_node, psharp_new) < 0)
                l_pos = i_base + (n - (1 << (m + 1)) + 2) * sign
                turn_left_pos = torch.where(turn & ~turning, l_pos,
                                            turn_left_pos)
                turning = turning | turn
            turning = turning & ~divergent

            # progressive within-subtree proposal (unbiased multinomial)
            omega_new = torch.logaddexp(omega_sub, delta)
            u_sub = torch.rand((c,), generator=gen, dtype=dtype, device=dev)
            take_new = torch.log(u_sub) < (delta - omega_new)
            upd = mask & ~divergent
            sub_prop = tree_where(upd & take_new,
                                  _Proposal(q=leaf.q, logp=leaf.logp,
                                            grad=leaf.grad, delta=delta),
                                  sub_prop)
            omega_sub = torch.where(upd, omega_new, omega_sub)

            # an invalid subtree takes the chain out of the lockstep
            died_div = mask & divergent
            died_turn = mask & turning
            die_l = torch.where(died_div, i_new, torch.where(
                died_turn, torch.minimum(turn_left_pos, i_new), die_l))
            die_r = torch.where(died_div, i_new, torch.where(
                died_turn, torch.maximum(turn_left_pos, i_new), die_r))
            alive = mask & ~(died_div | died_turn)
            cur = tree_where(mask, leaf, cur)
            died_div_any = died_div_any | died_div
            died_turn_any = died_turn_any | died_turn

        # merge the subtree into the trajectory
        m_ok = alive
        u2 = torch.rand((c,), generator=gen, dtype=dtype, device=dev)
        take2 = m_ok & (torch.log(u2) < (omega_sub - omega))
        prop = tree_where(take2, sub_prop, prop)
        omega = torch.where(m_ok, torch.logaddexp(omega, omega_sub), omega)

        psharp_end = psharp(metric, cur.p)
        grow_r = m_ok & is_fwd
        grow_l = m_ok & ~is_fwd
        i_end = i_base + subtree_len * sign
        right = tree_where(grow_r, cur, right)
        left = tree_where(grow_l, cur, left)
        psharp_right = bcast_where(grow_r, psharp_end, psharp_right)
        psharp_left = bcast_where(grow_l, psharp_end, psharp_left)
        i_right = torch.where(grow_r, i_end, i_right)
        i_left = torch.where(grow_l, i_end, i_left)

        rho = bcast_where(m_ok, rho + s_cum, rho)
        depth_final = torch.where(m_ok, torch.full_like(depth_final, d + 1),
                                  depth_final)

        turn_top = (_chain_dot(rho, psharp_left) < 0) \
            | (_chain_dot(rho, psharp_right) < 0)
        died_top = m_ok & turn_top

        term_type = torch.where(died_div_any, Termination.DIVERGENCE,
                                term_type).to(torch.int32)
        term_type = torch.where(died_turn_any | died_top, Termination.TURNING,
                                term_type).to(torch.int32)
        inner_died = died_div_any | died_turn_any
        term_left = torch.where(inner_died, die_l,
                                torch.where(died_top, i_left, term_left))
        term_right = torch.where(inner_died, die_r,
                                 torch.where(died_top, i_right, term_right))
        active = m_ok & ~turn_top

    accept = torch.exp(log_sum_alpha) / torch.clamp(steps, min=1).to(dtype)
    stats = TreeStats(
        energy=pi0 + prop.delta,
        acceptance_rate=torch.clamp(accept, max=1.0),
        termination=term_type,
        term_left=term_left,
        term_right=term_right,
        depth=depth_final,
        steps=steps,
    )
    return EvalPoint(q=prop.q, logp=prop.logp, grad=prop.grad), stats
