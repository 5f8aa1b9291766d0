"""Stochastic volatility, BASELINE config 5's model.

The port's counterpart of ``inplacedhmc_tpu/models/stoch_vol.py``: an AR(1)
latent log-volatility,

    h_1 ~ N(0, s^2 / (1 - phi^2)),   h_t = phi h_{t-1} + s eps_t,
    r_t | h_t ~ N(0, exp(h_t)),

sampled in the centred parameterisation ``q = (raw_phi, log_s, h_1..h_T)``
with ``phi = tanh(raw_phi)`` and ``s = exp(log_s)``.  Its ``structure``
names the ``"stoch_vol"`` tile physics (``ops/tile_physics.py``), whose
hand-written value and gradient the whole-tree kernel runs
(``csrc/tree_stoch_vol.cu``) where the kernel takes the problem
(``ops.tree.takes``): one warp per chain up to ``T + 2 = 256``, and above
it, the BASELINE's T = 1,000 among them, one chain per block of warps up to
``T + 2 = 2,048`` within the kernel's shared-memory bound.  A wider model
runs on autograd and the lockstep tree.

:func:`make_asis_hook` is the ancillary-sufficiency interleaving of the
hyperparameters (Yu and Meng 2011), a ``post_step`` hook of the warmup and
sampling loops: after each centred transition it re-expresses the latents
as AR(1) innovations (``_whiten``), runs random-walk Metropolis updates of
``(raw_phi, log_s)`` with the innovations held fixed (``_make_anc_logp``)
and maps back (``_reconstruct``, a log-depth doubling scan).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model


def synthetic_returns(gen: torch.Generator, n_steps: int = 1000,
                      phi: float = 0.98, s: float = 0.15,
                      dtype=torch.float32) -> torch.Tensor:
    """Draw ``r_1..r_T`` from the documented model on ``gen``'s device:
    innovations ``eps ~ N(0, s^2)``, the stationary start ``h_1 = eps_1 /
    sqrt(1 - phi^2)`` (sd ``s / sqrt(1 - phi^2)``), ``h_t = phi h_{t-1} +
    eps_t`` for ``t >= 2``, then ``r = z exp(h / 2)`` with ``z`` standard
    normal.  The JAX package's recipe, not its random numbers."""
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    eps = torch.randn((n_steps,), **kw) * s
    h = torch.empty_like(eps)
    h[0] = eps[0] / math.sqrt(1.0 - phi * phi)
    for t in range(1, n_steps):
        h[t] = phi * h[t - 1] + eps[t]
    return torch.randn((n_steps,), **kw) * torch.exp(0.5 * h)


def _theta_prior(raw_phi, log_s):
    """The hyperparameters' priors: ``raw_phi ~ N(1.5, 1)``, ``log_s ~
    N(-2, 1)``."""
    return -0.5 * (raw_phi - 1.5) ** 2 - 0.5 * (log_s + 2.0) ** 2


def _obs_term(h, r2):
    """Each latent's observation log density, up to a constant: ``r_t |
    h_t ~ N(0, exp(h_t))``."""
    return -0.5 * (h + r2 * torch.exp(-h))


def tile_data(returns, device="cuda"):
    """The tile physics' data rows, ``[T + 2]`` float32 each on the layout
    ``[raw_phi, log_s, h_1..h_T]``, as ``_tile_structure`` lays them out:
    ``r2`` (the squared returns on the h lanes ``2..T+1``, squared in
    float64 and then rounded), ``h_mask`` (1 on the h lanes) and
    ``ar_mask`` (1 on the lanes with a predecessor, ``3..T+1``)."""
    r = np.asarray(torch.as_tensor(returns).detach().cpu(), np.float64)
    dim = 2 + r.shape[0]
    rows = {k: np.zeros(dim, np.float32) for k in ("r2", "h_mask",
                                                   "ar_mask")}
    rows["r2"][2:] = r ** 2
    rows["h_mask"][2:] = 1.0
    rows["ar_mask"][3:] = 1.0
    return {k: torch.as_tensor(v, device=device) for k, v in rows.items()}


def _centered_logp(returns: torch.Tensor):
    """The centred log density of ``q = (raw_phi, log_s, h_1..h_T)``,
    batched over leading axes, with the AR(1) prior written with the shifts
    ``h[1:]`` and ``h[:-1]`` (autograd of it checks the hand-written
    gradient of the tile physics, and is the ASIS hook's potential)."""
    t = returns.shape[0]

    def logp(q):
        raw_phi, log_s, h = q[..., 0], q[..., 1], q[..., 2:]
        phi = torch.tanh(raw_phi)
        s = torch.exp(log_s)
        r = returns.to(q.dtype)
        one_m_phi2 = 1.0 - phi * phi
        lp = _theta_prior(raw_phi, log_s)
        lp = lp + 0.5 * torch.log(one_m_phi2) - t * log_s
        lp = lp - 0.5 * one_m_phi2 * (h[..., 0] / s) ** 2
        innov = (h[..., 1:] - phi[..., None] * h[..., :-1]) / s[..., None]
        lp = lp - 0.5 * torch.sum(innov * innov, dim=-1)
        return lp + torch.sum(_obs_term(h, r * r), dim=-1)

    return logp


def stoch_vol(returns, device="cuda") -> Model:
    """The centred posterior of ``returns [T]`` (a tensor or a numpy array,
    placed on ``device``; a numpy array keeps its dtype): ``logp`` is
    :func:`_centered_logp`; the data rows of ``structure`` live on
    ``device``, with the scalar ``t = T``."""
    returns = torch.as_tensor(returns, device=device)
    t = returns.shape[0]
    dim = 2 + t
    logp = _centered_logp(returns)

    def constrain(q):
        return {"phi": torch.tanh(q[..., 0]), "s": torch.exp(q[..., 1]),
                "h": q[..., 2:]}

    return Model(name=f"stoch_vol_{t}", dim=dim, logp=logp,
                 constrain=constrain,
                 structure={"kind": "tile_logp", "physics": "stoch_vol",
                            "data": tile_data(returns, device),
                            "scalars": {"t": float(t)}})


#: the floor on ``1 - phi^2`` of the whitening and its inverse: float32
#: ``tanh`` is exactly 1 from about ``|raw_phi| > 9``
ONE_M_PHI2_FLOOR = 1e-12


def _whiten(raw_phi, log_s, h):
    """Centred latents to AR(1) innovations, batched over leading axes:
    ``eps_1 = h_1 sqrt(1 - phi^2) / s``, ``eps_t = (h_t - phi h_{t-1}) /
    s``.  ``1 - phi^2`` is floored as in :func:`_reconstruct`, so that the
    round trip stays exact where ``tanh`` saturates."""
    phi = torch.tanh(raw_phi)[..., None]
    inv_s = torch.exp(-log_s)[..., None]
    one_m_phi2 = torch.clamp(1.0 - phi * phi, min=ONE_M_PHI2_FLOOR)
    e1 = h[..., :1] * torch.sqrt(one_m_phi2) * inv_s
    rest = (h[..., 1:] - phi * h[..., :-1]) * inv_s
    return torch.cat([e1, rest], dim=-1)


def _reconstruct(raw_phi, log_s, eps):
    """Innovations to centred latents: the recurrence ``h_t = phi h_{t-1} +
    s eps_t`` (``h_1 = s eps_1 / sqrt(1 - phi^2)``), as the inclusive scan
    of the affine maps ``(a_t, b_t)`` under ``(a, b) o (a', b') = (a a',
    a b' + b)``, by recursive doubling: ``ceil(log2 T)`` steps, each one
    vectorised over ``[..., T]`` (about ten at T = 1,000; a step-by-step
    loop would be a thousand).  The JAX package takes the same scan with
    ``lax.associative_scan``, whose tree adds in another order.  Never the
    closed form with ``phi^-t``, which overflows float32 near ``|phi| = 1``.
    ``1 - phi^2`` is floored at ``ONE_M_PHI2_FLOOR``."""
    phi = torch.tanh(raw_phi)[..., None]
    s = torch.exp(log_s)[..., None]
    one_m_phi2 = torch.clamp(1.0 - phi * phi, min=ONE_M_PHI2_FLOOR)
    b = s * eps
    b = torch.cat([b[..., :1] / torch.sqrt(one_m_phi2), b[..., 1:]], dim=-1)
    a = phi.expand(eps.shape)
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    t = eps.shape[-1]
    off = 1
    while off < t:
        # element t composes the map of t - off before it with its own
        b = torch.cat([b[..., :off], a[..., off:] * b[..., :-off]
                       + b[..., off:]], dim=-1)
        a = torch.cat([a[..., :off], a[..., off:] * a[..., :-off]], dim=-1)
        off *= 2
    return b


def _make_anc_logp(returns):
    """The ASIS target, ``theta [..., 2], eps [..., T] -> [...]``: the
    hyperparameters' prior and the observation terms of the reconstructed
    latents.  The posterior in ``(theta, eps)`` is this plus the
    theta-free ``-0.5 |eps|^2`` (the Jacobian ``s^T / sqrt(1 - phi^2)``
    cancels the AR(1) normalisation), which drops from the ratios.  The
    squared returns are squared in float64 and rounded to the latents'
    dtype."""
    r2_64 = torch.as_tensor(returns).detach().double() ** 2
    cache = {}

    def anc_logp(theta, eps):
        raw_phi, log_s = theta[..., 0], theta[..., 1]
        h = _reconstruct(raw_phi, log_s, eps)
        key = (h.device, h.dtype)
        if key not in cache:
            cache[key] = r2_64.to(device=h.device, dtype=h.dtype)
        return _theta_prior(raw_phi, log_s) \
            + torch.sum(_obs_term(h, cache[key]), dim=-1)

    return anc_logp


def asis_draws(gen: torch.Generator, n_steps: int, c: int,
               per_coord: bool, dtype, device):
    """The hook's random numbers, in the order it takes them: per sub-step
    and hyperparameter one standard normal ``[C]`` and then one uniform
    ``[C]`` (``per_coord``); jointly, per sub-step the two normals and one
    uniform.  Returns ``normals [n_steps, 2, C]`` and ``uniforms
    [n_steps, 2 or 1, C]``."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    normals, uniforms = [], []
    for _ in range(n_steps):
        if per_coord:
            for _ in range(2):
                normals.append(torch.randn((c,), **kw))
                uniforms.append(torch.rand((c,), **kw))
        else:
            normals += [torch.randn((c,), **kw) for _ in range(2)]
            uniforms.append(torch.rand((c,), **kw))
    return (torch.stack(normals).reshape(n_steps, 2, c),
            torch.stack(uniforms).reshape(n_steps, -1, c))


def asis_mh(anc_logp, theta, eps, lp, scale, normals, uniforms,
            per_coord: bool):
    """The random-walk Metropolis sub-steps of ASIS on ``theta [C, 2]``
    with the innovations ``eps [C, T]`` held fixed, from the ancillary
    density ``lp [C]``, on the given draws (:func:`asis_draws`): a
    proposal ``theta + scale * normal`` (one coordinate at a time under
    ``per_coord``) is taken where ``log(u) < lp_p - lp``.  Returns
    ``theta``, ``lp`` and ``moved [C]``, whether any proposal was
    taken."""
    sc = torch.as_tensor(scale, dtype=theta.dtype, device=theta.device)
    moved = torch.zeros(lp.shape, dtype=torch.bool, device=lp.device)
    for i in range(normals.shape[0]):
        if per_coord:
            subs = [(j, sc[j] * normals[i, j], uniforms[i, j])
                    for j in range(2)]
        else:
            subs = [(None, sc[:, None] * normals[i], uniforms[i, 0])]
        for j, step, u in subs:
            if j is None:
                prop = theta + step.T
            else:
                prop = theta.clone()
                prop[:, j] = theta[:, j] + step
            lp_p = anc_logp(prop, eps)
            accept = torch.log(u) < (lp_p - lp)
            theta = torch.where(accept[:, None], prop, theta)
            lp = torch.where(accept, lp_p, lp)
            moved = moved | accept
    return theta, lp, moved


def make_asis_hook(returns, *, scale=(0.06, 0.1), n_steps: int = 3,
                   potential=None, per_coord: bool = False):
    """ASIS for the hyperparameters, as a ``post_step`` hook ``hook(gen, z)
    -> z``: the latents of ``z.q [C, D]`` are whitened into innovations,
    ``n_steps`` random-walk Metropolis updates of ``theta = (raw_phi,
    log_s)`` run on the ancillary density with the innovations fixed
    (:func:`asis_mh`, steps of sd ``scale``), and the latents are rebuilt.
    Both kernels leave the posterior invariant; the composition moves the
    hyperparameters that the centred sampler moves slowly.  ``per_coord``
    proposes and accepts each hyperparameter on its own (at T = 1,000 the
    ancillary conditional of ``log_s`` is far tighter than ``raw_phi``'s,
    and a joint proposal lets it veto the other).  ``potential`` refreshes
    the log density and gradient of the chains that moved (by default
    autograd of the centred log density); a chain whose every proposal was
    rejected keeps its exact ``q``, ``logp`` and ``grad``.  The draws come
    from ``gen`` (:func:`asis_draws`).  Use as
    ``sample(..., post_step=make_asis_hook(returns, per_coord=True,
    n_steps=10))``: the round-5 recipe of config 5."""
    from ..core.hamiltonian import batched_logdensity_and_grad
    from ..core.state import EvalPoint

    returns = torch.as_tensor(returns)
    pots = {}
    anc_logp = _make_anc_logp(returns)

    def pot_on(dev):
        if potential is not None:
            return potential
        if dev not in pots:
            pots[dev] = batched_logdensity_and_grad(
                _centered_logp(returns.to(dev)))
        return pots[dev]

    def hook(gen: torch.Generator, z):
        q = z.q
        theta = q[:, :2]
        eps = _whiten(theta[:, 0], theta[:, 1], q[:, 2:])
        lp = anc_logp(theta, eps)
        normals, uniforms = asis_draws(gen, n_steps, q.shape[0], per_coord,
                                       q.dtype, q.device)
        theta, _, moved = asis_mh(anc_logp, theta, eps, lp, scale, normals,
                                  uniforms, per_coord)
        h_new = _reconstruct(theta[:, 0], theta[:, 1], eps)
        q_new = torch.where(moved[:, None], torch.cat([theta, h_new], dim=1),
                            q)
        logp_new, grad_new = pot_on(q.device)(q_new)
        return EvalPoint(q=q_new,
                         logp=torch.where(moved, logp_new, z.logp),
                         grad=torch.where(moved[:, None], grad_new, z.grad))

    return hook
