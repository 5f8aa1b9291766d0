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

Not ported yet: ``make_asis_hook`` and its helpers ``_whiten``,
``_reconstruct`` and ``_make_anc_logp`` (the ancillary-sufficiency
interleaving of the hyperparameters), which need the warmup's ``post_step``
hooks (ROADMAP queue 1 item 4).
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


def stoch_vol(returns, device="cuda") -> Model:
    """The centred posterior of ``returns [T]`` (a tensor or a numpy array,
    placed on ``device``; a numpy array keeps its dtype).  ``logp`` writes
    the AR(1) prior with the shifts ``h[1:]`` and ``h[:-1]`` (autograd of
    it checks the hand-written gradient of the tile physics); the data rows
    of ``structure`` live on ``device``, with the scalar ``t = T``."""
    returns = torch.as_tensor(returns, device=device)
    t = returns.shape[0]
    dim = 2 + t

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

    def constrain(q):
        return {"phi": torch.tanh(q[..., 0]), "s": torch.exp(q[..., 1]),
                "h": q[..., 2:]}

    return Model(name=f"stoch_vol_{t}", dim=dim, logp=logp,
                 constrain=constrain,
                 structure={"kind": "tile_logp", "physics": "stoch_vol",
                            "data": tile_data(returns, device),
                            "scalars": {"t": float(t)}})
