"""Constrained parameters through bijectors with their log-Jacobians.

The port's counterpart of ``inplacedhmc_tpu/models/transforms.py``: the
sampler works on an unconstrained ``R^D``; a model written on natural
parameters maps a flat unconstrained vector through bijectors and adds the
total ``log|dx/dy|``.  Usage::

    spec = {"mu": identity(), "sigma": positive(), "theta": interval(0, 1)}
    model = transformed_model("my_model", spec, logp_natural)

As everywhere in the port, positions are batched: a bijector maps ``y
[..., size]`` to ``x [..., out_size]`` and its ``log_jac`` returns ``[...]``;
``logp_natural(params)`` gets each parameter with the batch axes leading
(a size-1 parameter without its own axis) and returns ``[...]``.  Such
models carry no ``structure``: they run on autograd and the lockstep tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .base import Model


def _softplus(y):
    """``logaddexp(0, y)``"""
    return torch.logaddexp(torch.zeros_like(y), y)


@dataclasses.dataclass(frozen=True)
class Bijector:
    """``y`` (unconstrained, ``size`` values) -> ``x`` (natural,
    ``out_size`` values, by default ``size``); ``log_jac(y)`` is the total
    ``log|dx/dy|`` over the last axis."""

    name: str
    forward: Callable
    log_jac: Callable
    inverse: Callable
    size: int = 1
    out_size: Optional[int] = None

    def __post_init__(self):
        if self.out_size is None:
            object.__setattr__(self, "out_size", self.size)


def _sum(y):
    return torch.sum(y, dim=-1)


def identity(size: int = 1) -> Bijector:
    return Bijector("identity", lambda y: y,
                    lambda y: torch.zeros_like(y[..., 0]), lambda x: x, size)


def positive(size: int = 1) -> Bijector:
    """``x = exp(y)``: scales and variances."""
    return Bijector("positive", torch.exp, _sum, torch.log, size)


def interval(lo: float, hi: float, size: int = 1) -> Bijector:
    """``x = lo + (hi - lo) sigmoid(y)``: probabilities, AR coefficients,
    correlations."""
    if not hi > lo:
        # a swapped pair would only show as log(negative) = NaN in every logp
        raise ValueError(f"interval requires hi > lo, got ({lo}, {hi})")
    width = hi - lo

    def fwd(y):
        return lo + width / (1.0 + torch.exp(-y))

    def log_jac(y):
        # log(width) + log sigmoid(y) + log sigmoid(-y), summed
        return _sum(math.log(width) - _softplus(-y) - _softplus(y))

    def inv(x):
        u = (x - lo) / width
        return torch.log(u) - torch.log1p(-u)

    return Bijector("interval", fwd, log_jac, inv, size)


def lower_bounded(lo: float, size: int = 1) -> Bijector:
    """``x = lo + exp(y)``."""
    return Bijector("lower_bounded", lambda y: lo + torch.exp(y), _sum,
                    lambda x: torch.log(x - lo), size)


def simplex(k_unconstrained: int) -> Bijector:
    """Stick-breaking: ``k`` unconstrained values -> ``k + 1`` simplex
    weights (Stan's parameterisation, with its log-Jacobian)."""
    k = k_unconstrained

    def offsets(y):
        return torch.log(torch.arange(k, 0, -1, dtype=y.dtype,
                                      device=y.device))

    def fwd(y):
        z = 1.0 / (1.0 + torch.exp(-(y - offsets(y))))
        cum = torch.cumprod(1.0 - z, dim=-1)
        rem = torch.cat([torch.ones_like(z[..., :1]), cum[..., :-1]], dim=-1)
        return torch.cat([z * rem, cum[..., -1:]], dim=-1)

    def log_jac(y):
        ys = y - offsets(y)
        log_z = -_softplus(-ys)
        log_1mz = -_softplus(ys)
        cum_log_rem = torch.cat([torch.zeros_like(ys[..., :1]),
                                 torch.cumsum(log_1mz[..., :-1], dim=-1)],
                                dim=-1)
        # log|J| = sum_k log z_k + log(1 - z_k) + log rem_k
        return _sum(log_z + log_1mz + cum_log_rem)

    def inv(x):
        cum = torch.cat([torch.zeros_like(x[..., :1]),
                         torch.cumsum(x[..., :-1], dim=-1)], dim=-1)[..., :k]
        z = x[..., :k] / (1.0 - cum)
        return torch.log(z) - torch.log1p(-z) + offsets(x)

    return Bijector("simplex", fwd, log_jac, inv, k, out_size=k + 1)


Spec = Dict[str, Bijector]


def transformed_model(name: str, spec: Spec, logp_natural: Callable) -> Model:
    """A :class:`Model` from a bijector spec and a natural-space log
    density.  The unconstrained dimension is the sum of the bijectors'
    sizes, in the spec's order; ``constrain`` maps draws back to natural
    parameters."""
    offsets, dim = {}, 0
    for pname, bij in spec.items():
        offsets[pname] = dim
        dim += bij.size

    def natural(q):
        out = {}
        for pname, bij in spec.items():
            x = bij.forward(q[..., offsets[pname]:offsets[pname] + bij.size])
            out[pname] = x[..., 0] if bij.size == bij.out_size == 1 else x
        return out

    def logp(q):
        jac = sum(bij.log_jac(q[..., offsets[p]:offsets[p] + bij.size])
                  for p, bij in spec.items())
        return logp_natural(natural(q)) + jac

    return Model(name=name, dim=dim, logp=logp, constrain=natural)
