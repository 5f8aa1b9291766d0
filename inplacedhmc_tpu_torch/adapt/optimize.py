"""L-BFGS for the typical-set warmup initializer, batched over chains.

The port's counterpart of ``inplacedhmc_tpu/adapt/optimize.py``, which writes
one chain's L-BFGS and ``vmap``s it.  Here every tensor carries the chains
axis: the curvature history is ``[C, M, D]`` with a per-chain ring cursor, and
each chain's loop and line search stop on their own conditions under masks,
exactly as the vmapped ``while_loop``s do.  One batched objective evaluation
serves all chains at each line-search trial.

Limited-memory BFGS with the two-loop recursion and a backtracking Armijo
line search; a non-finite trial shrinks the step, and the curvature pair is
skipped when ``y . s`` is not positive.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[c, idx[c]]`` for every chain ``c``."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop(g, s_hist, y_hist, rho, head, count, memory):
    """Search direction ``-H g`` per chain from the ring of curvature
    pairs."""
    q = g
    alphas = torch.zeros(rho.shape, dtype=g.dtype, device=g.device)
    for i in range(memory):
        idx = (head - 1 - i) % memory
        valid = i < count
        a = torch.where(valid, _rows(rho, idx) * _dot(_rows(s_hist, idx), q),
                        0.0)
        q = q - (a * valid.to(g.dtype))[:, None] * _rows(y_hist, idx)
        alphas[torch.arange(g.shape[0], device=g.device), idx] = a

    # initial Hessian scaling gamma = s.y / y.y of the most recent pair
    last = (head - 1) % memory
    y_last = _rows(y_hist, last)
    yy = _dot(y_last, y_last)
    rho_last = _rows(rho, last)
    sy = 1.0 / torch.where(rho_last != 0, rho_last, 1.0)
    gamma = torch.where((count > 0) & (yy > 0),
                        sy / torch.clamp(yy, min=1e-30), 1.0)
    r = gamma[:, None] * q
    for i in range(memory):
        idx = (head - count + i) % memory
        valid = i < count
        b = torch.where(valid, _rows(rho, idx) * _dot(_rows(y_hist, idx), r),
                        0.0)
        r = r + ((_rows(alphas, idx) - b) * valid.to(g.dtype))[:, None] \
            * _rows(s_hist, idx)
    return -r


def lbfgs_batched(value_and_grad: Callable, q0: torch.Tensor, iterations: int,
                  memory: int = 8, max_ls: int = 20, tol: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize a batched objective ``q [C, D] -> (f [C], g [C, D])`` for
    every chain; returns ``(q, f, g)``.  A chain stops after ``iterations``
    steps, when ``max|g| <= tol``, when ``f`` is not finite, or when its line
    search fails."""
    c, d = q0.shape
    dt, dev = q0.dtype, q0.device
    q = q0
    f, g = value_and_grad(q0)
    s_hist = torch.zeros((c, memory, d), dtype=dt, device=dev)
    y_hist = torch.zeros((c, memory, d), dtype=dt, device=dev)
    rho = torch.zeros((c, memory), dtype=dt, device=dev)
    head = torch.zeros((c,), dtype=torch.int64, device=dev)
    count = torch.zeros((c,), dtype=torch.int64, device=dev)
    it = torch.zeros((c,), dtype=torch.int64, device=dev)
    rows = torch.arange(c, device=dev)

    while True:
        running = (it < iterations) & (torch.amax(torch.abs(g), dim=-1) > tol) \
            & torch.isfinite(f)
        if not bool(running.any()):
            break
        direction = _two_loop(g, s_hist, y_hist, rho, head, count, memory)
        dg = _dot(direction, g)
        # fall back to steepest descent if not a descent direction
        bad = ~torch.isfinite(dg) | (dg >= 0)
        direction = torch.where(bad[:, None], -g, direction)
        dg = torch.where(bad, -_dot(g, g), dg)

        # backtracking line search; stopped chains start out done
        step = torch.ones((c,), dtype=dt, device=dev)
        ok = torch.zeros((c,), dtype=torch.bool, device=dev)
        searching = running.clone()
        f_new, g_new, q_new = f, g, q
        for _ in range(max_ls):
            if not bool(searching.any()):
                break
            q_try = q + step[:, None] * direction
            f_try, g_try = value_and_grad(q_try)
            # the gradient must be finite too, or a NaN would enter the carry
            good = torch.isfinite(f_try) & torch.all(torch.isfinite(g_try),
                                                     dim=-1) \
                & (f_try <= f + 1e-4 * step * dg)
            f_new = torch.where(searching, f_try, f_new)
            g_new = torch.where(searching[:, None], g_try, g_new)
            q_new = torch.where((searching & good)[:, None], q_try, q_new)
            ok = torch.where(searching, good, ok)
            step = torch.where(searching & ~good, 0.5 * step, step)
            searching = searching & ~good

        # curvature pair update (skipped when the search failed or y.s <= 0)
        s_vec = q_new - q
        y_vec = g_new - g
        ys = _dot(y_vec, s_vec)
        store = running & ok & (ys > 1e-12)
        slot = torch.where(store, head, 0)
        keep = store[:, None]
        s_hist[rows, slot] = torch.where(keep, s_vec, s_hist[rows, slot])
        y_hist[rows, slot] = torch.where(keep, y_vec, y_hist[rows, slot])
        rho[rows, slot] = torch.where(store, 1.0 / torch.where(store, ys, 1.0),
                                      rho[rows, slot])
        head = torch.where(store, (head + 1) % memory, head)
        count = torch.where(store, torch.clamp(count + 1, max=memory), count)

        # a failed line search ends the chain's optimization
        accept = running & ok
        q = torch.where(accept[:, None], q_new, q)
        f = torch.where(accept, f_new, f)
        g = torch.where(accept[:, None], g_new, g)
        it = it + torch.where(running, torch.where(ok, 1, iterations), 0)
    return q, f, g
