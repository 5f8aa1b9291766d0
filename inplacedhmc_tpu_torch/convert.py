"""Carry the JAX package's model data and sampler state across as numpy.

This system has no weights: a logistic model's data and a warmup state
(positions, metric, step size) take their place.  :func:`model_from_numpy`
and :func:`warmup_state_from_numpy` turn the numpy arrays of a JAX
``Model.structure`` and ``WarmupState`` into the port's objects;
:func:`warmup_state_to_numpy` goes back.  This module imports nothing of the
JAX package: the caller converts with ``numpy.asarray``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .core.hamiltonian import evaluate
from .core.metric import DenseMetric, dense_metric, diag_metric
from .core.state import WarmupState
from .models.base import Model
from .models.logistic import logistic_regression


def model_from_numpy(x, y, inv_var: float, device="cuda") -> Model:
    """The port's logistic-regression model from the arrays of a JAX
    ``structure`` (``x [N, D]``, ``y [N]``, ``inv_var``)."""
    return logistic_regression(np.asarray(x), np.asarray(y),
                               prior_scale=float(inv_var) ** -0.5,
                               device=device)


def warmup_state_from_numpy(q, metric_inv, log_eps, device="cuda", *,
                            potential: Callable) -> WarmupState:
    """A :class:`WarmupState` from positions ``q [C, D]``, the metric's
    ``M^-1`` (``[D]`` diagonal, ``[D, D]`` or ``[C, D, D]`` dense) and
    ``log_eps`` (scalar, ``[C]`` or ``None``).  The log density and gradient
    at ``q`` are evaluated by the port's ``potential``, so the cached values
    are the port's own."""
    q = torch.as_tensor(np.asarray(q), device=device)
    inv = torch.as_tensor(np.asarray(metric_inv), device=device,
                          dtype=q.dtype)
    metric = diag_metric(inv) if inv.ndim == 1 else dense_metric(inv)
    le = None if log_eps is None else torch.as_tensor(
        np.asarray(log_eps), device=device, dtype=q.dtype)
    return WarmupState(z=evaluate(potential, q), metric=metric, log_eps=le)


def warmup_state_to_numpy(state: WarmupState) -> Dict[str, np.ndarray]:
    """``{"q", "logp", "grad", "metric_inv", "log_eps"}`` as numpy arrays;
    the inverse of :func:`warmup_state_from_numpy`."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    return {"q": host(state.z.q), "logp": host(state.z.logp),
            "grad": host(state.z.grad), "metric_inv": host(state.metric.inv),
            "log_eps": host(state.log_eps),
            "dense": isinstance(state.metric, DenseMetric)}
