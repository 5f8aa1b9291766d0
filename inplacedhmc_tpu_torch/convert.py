"""Carry the JAX package's model data and sampler state across as numpy.

This system has no weights: a model's data (a logistic model's design and
labels, a Gaussian model's precision) and a warmup state (positions, metric,
step size) take their place.  :func:`model_from_numpy`,
:func:`gaussian_model_from_numpy`, :func:`mvn_model_from_numpy`,
:func:`tile_model_from_numpy` and :func:`warmup_state_from_numpy` turn the
numpy arrays of a JAX ``Model.structure`` and ``WarmupState`` into the
port's objects; :func:`warmup_state_to_numpy` goes back.  This module
imports nothing of the JAX package: the caller converts with
``numpy.asarray``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .core.hamiltonian import evaluate
from .core.metric import DenseMetric, dense_metric, diag_metric
from .core.state import WarmupState
from .models.base import Model
from .models.gaussian import dense_gaussian_model, diag_gaussian_model
from .models.logistic import logistic_regression
from .ops import tile_physics


def model_from_numpy(x, y, inv_var: float, device="cuda") -> Model:
    """The port's logistic-regression model from the arrays of a JAX
    ``structure`` (``x [N, D]``, ``y [N]``, ``inv_var``).  They are all the
    whole-tree route needs: under ``use_pallas="tree"`` the physics pads
    them itself (``ops/tile_physics.py::logistic_data``), as JAX's
    ``make_logistic_tree_transition`` does."""
    return logistic_regression(np.asarray(x), np.asarray(y),
                               prior_scale=float(inv_var) ** -0.5,
                               device=device)


def gaussian_model_from_numpy(precision, device="cuda") -> Model:
    """The port's diagonal-Gaussian model from the ``precision [D]`` of a JAX
    ``{"kind": "diag_gaussian"}`` structure, kept bit for bit (a numpy array
    becomes float32)."""
    prec = torch.as_tensor(np.array(precision, dtype=np.float32),
                           device=device)
    return diag_gaussian_model(f"diag_gaussian_{prec.shape[0]}", prec)


def mvn_model_from_numpy(precision, device="cuda") -> Model:
    """The port's dense-Gaussian model from the symmetrized ``precision [D,
    D]`` of a JAX ``{"kind": "dense_gaussian"}`` structure (``mvn``), kept
    bit for bit (a numpy array becomes float32): both packages then sample
    the same density."""
    prec = torch.as_tensor(np.array(precision, dtype=np.float32),
                           device=device)
    return dense_gaussian_model(f"mvn_{prec.shape[0]}", prec)


def tile_model_from_numpy(physics: str, data, dim: int, *, scalars=None,
                          device="cuda") -> Model:
    """The port's model for a JAX ``{"kind": "tile_logp"}`` structure whose
    tile physics the port writes out as ``physics``
    (``ops/tile_physics.py``): ``data`` the structure's rows (numpy, ``[D]``
    or ``[1, D]``; kept bit for bit as float32), ``scalars`` the constants
    the JAX ``tile_logp`` closes over (the funnel's ``k`` and ``inv_s2``).
    Its ``logp`` is the physics' own value, so autograd of it and the
    physics' hand-written gradient describe the same density.  For JAX's
    ``stoch_vol(returns)``: ``tile_model_from_numpy("stoch_vol",
    structure["data"], T + 2, scalars={"t": T})`` has its density (the
    rows ``r2``, ``h_mask``, ``ar_mask`` as JAX rounds them, and
    ``_make_tile_logp``'s ``T``)."""
    rows = {k: torch.as_tensor(np.array(v, dtype=np.float32).reshape(dim),
                               device=device) for k, v in data.items()}
    scalars = {k: float(v) for k, v in (scalars or {}).items()}
    phys = tile_physics.bind(physics, {**rows, **scalars})

    def logp(q):
        bound = tile_physics.bind(physics, phys.data, q.device, q.dtype)
        return bound(q.reshape(-1, dim))[0].reshape(q.shape[:-1])

    return Model(name=f"{physics}_{dim}", dim=dim, logp=logp,
                 structure={"kind": "tile_logp", "physics": physics,
                            "data": rows, "scalars": scalars})


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
