"""Tile physics of the whole-tree kernel: each model's log density and
gradient in closed form.

The port's counterpart of the ``tile_logp`` functions that
``inplacedhmc_tpu/ops/tree_pallas.py::make_tree_transition`` differentiates
inside its kernel with ``jax.vjp`` (``tree_pallas.py:899-912``).  CUDA C++
has no autodiff, so each physics here is written out by hand, value and
gradient together, in the order of the device function of the same name
(``csrc/tree_gaussian.cu``, ``csrc/tree_eight_schools.cu``,
``csrc/tree_funnel.cu``, ``csrc/tree_dense_gaussian.cu``): the same
elementwise operations, each rounded on its own; only the row sums and the
matrix products are taken in another order there (a per-lane sum and a warp
butterfly; a warp mat-vec).  These are the plain versions that the whole-tree
transition's CPU path (``ops/tree.py``) calls at the start of a transition,
at every leaf and for the final gradient.

A physics takes ``q [C, D]`` and ``data``, a dict of its rows (``[D]``
tensors in ``q``'s dtype and on its device, zero past the model's lanes),
its matrix if it has one (``[D, D]``, likewise) and its scalars (Python
floats), and returns ``(logp [C], grad [C, D])``.  The port's
kernels take no padded lanes, so JAX's masking of ``q`` before the physics
and of the gradient after it has nothing to mask here; on the card, lanes
past D read zero rows and get a zero gradient.

* ``"gaussian"`` (``diag_gaussian`` models, ``tree_pallas.py:1103``):
  rows ``lam`` (the precision); ``logp = -0.5 sum lam q^2``,
  ``grad = -lam q``.
* ``"eight_schools"`` (``models/eight_schools.py``): lanes ``[mu, log_tau,
  z_1..z_8]``; rows ``y``, ``sig``, ``obs_mask`` (the data on the z lanes,
  ``obs_mask`` 1 there).  With ``r_j = (y_j - mu - tau z_j) / sig_j``:
  ``d/dz_j = -z_j + tau r_j / sig_j``, ``d/dmu = -mu/100 + sum r_j/sig_j``,
  ``d/dlog_tau = 1 - 2 sigmoid(2 (log_tau - log 5)) + tau sum z_j r_j /
  sig_j``; ``logaddexp(0, x)`` as JAX computes it, ``max(x, 0) +
  log1p(exp(-|x|))``.
* ``"funnel"`` (``models/funnel.py``): lanes ``[v, x_1..x_{D-1}]``; row
  ``x_mask`` (1 on the x lanes), scalars ``k = D - 1`` and ``inv_s2 =
  1 / scale^2``.  With ``S = sum x_i^2`` and ``e = exp(-v)``: ``logp =
  -0.5 (inv_s2 v^2 + S e + k v)``, ``d/dv = 0.5 S e - inv_s2 v - 0.5 k``,
  ``d/dx_i = -e x_i``.  A non-finite ``e`` is left to the leaf's
  sanitisation, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

#: log(5), the half-Cauchy scale of eight schools' tau
LOG5 = math.log(5.0)


def _rowsum(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t, dim=1)


def gaussian(q: torch.Tensor, data: dict):
    lq = data["lam"] * q
    return -0.5 * _rowsum(lq * q), -lq


def eight_schools(q: torch.Tensor, data: dict):
    obs = data["obs_mask"] != 0
    sig = torch.where(obs, data["sig"], 1.0)
    mu, log_tau = q[:, 0], q[:, 1]
    tau = torch.exp(log_tau)
    z = torch.where(obs, q, 0.0)
    r = torch.where(obs, (data["y"] - (mu[:, None] + tau[:, None] * z))
                    / sig, 0.0)
    rs = r / sig
    ss = _rowsum(z * z + r * r)
    x = 2.0 * (log_tau - LOG5)
    softplus = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    sigmoid = 1.0 / (1.0 + torch.exp(-x))
    mu10 = mu / 10.0
    logp = -0.5 * (mu10 * mu10) - softplus + log_tau - 0.5 * ss
    grad = torch.where(obs, tau[:, None] * rs - z, 0.0)
    grad[:, 0] = _rowsum(rs) - mu10 / 10.0
    grad[:, 1] = (1.0 - 2.0 * sigmoid) + tau * _rowsum(z * rs)
    return logp, grad


def funnel(q: torch.Tensor, data: dict):
    xm = data["x_mask"] != 0
    k, inv_s2 = data["k"], data["inv_s2"]
    v = q[:, 0]
    e = torch.exp(-v)
    x = torch.where(xm, q, 0.0)
    s = _rowsum(x * x)
    logp = -0.5 * (inv_s2 * v * v + s * e + k * v)
    grad = torch.where(xm, -(e[:, None] * x), 0.0)
    grad[:, 0] = 0.5 * (s * e) - inv_s2 * v - 0.5 * k
    return logp, grad


def dense_gaussian(q: torch.Tensor, data: dict):
    g = -(q @ data["prec"])
    return 0.5 * _rowsum(g * q), g


class Spec(NamedTuple):
    """A physics: its plain value and gradient, and the names of its data
    rows, scalars and ``[D, D]`` matrix (or ``None``) in the order its
    kernel's launcher takes them."""

    value_and_grad: Callable
    rows: Tuple[str, ...]
    scalars: Tuple[str, ...] = ()
    matrix: Optional[str] = None


#: every physics with a device function, by name
PHYSICS: Dict[str, Spec] = {
    "gaussian": Spec(gaussian, ("lam",)),
    "eight_schools": Spec(eight_schools, ("y", "sig", "obs_mask")),
    "funnel": Spec(funnel, ("x_mask",), ("k", "inv_s2")),
    "dense_gaussian": Spec(dense_gaussian, (), matrix="prec"),
}


class Bound(NamedTuple):
    """A physics bound to its data: ``bound(q) -> (logp, grad)``.  The rows
    and the matrix must already be in ``q``'s dtype and on its device
    (:func:`bind`)."""

    name: str
    data: dict

    def __call__(self, q: torch.Tensor):
        return PHYSICS[self.name].value_and_grad(q, self.data)

    def rows(self):
        return [self.data[n] for n in PHYSICS[self.name].rows]

    def scalars(self):
        return [float(self.data[n]) for n in PHYSICS[self.name].scalars]

    def matrix(self):
        name = PHYSICS[self.name].matrix
        return None if name is None else self.data[name]


def bind(name: str, data: dict, device=None, dtype=None) -> Bound:
    """``name``'s physics on ``data`` (its rows, scalars and matrix), the
    rows and the matrix cast to ``dtype`` on ``device`` and made contiguous
    (``None``: as given).  Raises on an unknown physics or a missing
    entry."""
    if name not in PHYSICS:
        raise ValueError(f"no tile physics {name!r} (have {sorted(PHYSICS)})")
    spec = PHYSICS[name]
    tensors = spec.rows + ((spec.matrix,) if spec.matrix else ())
    missing = set(tensors + spec.scalars) - set(data)
    if missing:
        raise ValueError(f"physics {name!r} needs {sorted(missing)}")
    cast = {n: torch.as_tensor(data[n], device=device,
                               dtype=dtype).contiguous()
            for n in tensors}
    cast.update({n: float(data[n]) for n in spec.scalars})
    return Bound(name, cast)
