"""Tile physics of the whole-tree kernel: each model's log density and
gradient in closed form.

The port's counterpart of the ``tile_logp`` functions that
``inplacedhmc_tpu/ops/tree_pallas.py::make_tree_transition`` differentiates
inside its kernel with ``jax.vjp`` (``tree_pallas.py:899-912``).  CUDA C++
has no autodiff, so each physics here is written out by hand, value and
gradient together, in the order of the device function of the same name
(``csrc/tree_gaussian.cu``, ``csrc/tree_eight_schools.cu``,
``csrc/tree_funnel.cu``, ``csrc/tree_dense_gaussian.cu``,
``csrc/tree_logistic.cu``, ``csrc/tree_stoch_vol.cu``): the same
elementwise operations, each rounded on its own; only the row sums and the
matrix products are taken in another order there (a per-lane sum and a
warp butterfly; a warp mat-vec; for logistic regression a reduce-scatter
over eight observations at a time).  These are the plain versions that
the whole-tree transition's CPU path (``ops/tree.py``) calls at the start
of a transition, at every leaf and for the final gradient.

A physics takes ``q [C, D]`` and ``data``, a dict of its tensors (in
``q``'s dtype and on its device, zero past the model's lanes; shapes
below), its scalars and settings (Python numbers), and returns
``(logp [C], grad [C, D])``.  The port's
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
* ``"dense_gaussian"`` (``mvn`` models, ``tree_pallas.py:1118``): matrix
  ``prec`` (the symmetric precision P); ``grad = -(q P)``, ``logp = 0.5 sum
  grad q``.
* ``"logistic"`` (BASELINE config 3, JAX's ``make_logistic_tree_transition``
  with its chunked ``tile_vg``, ``tree_pallas.py:1242-1275``; its ``vjp``
  form computes the same function): the observation matrix ``x [npad, D]``
  (obs-major, zero rows past the N observations), the observation rows
  ``y`` and ``w [npad]`` (the labels, and the weights: 1 on the real
  observations, 0 on the padding), the scalars ``inv_var`` (the prior
  precision) and ``grad_bf16`` (1.0 or 0.0) and the setting ``block_n``
  (``npad`` is a multiple of it; the plain version sums chunk by chunk over
  it, as JAX's ``tile_vg`` does).  Per chunk: ``eta = q x^T``, one ``t =
  exp(-|eta|)`` shared by ``ll = y eta - (max(eta, 0) + log1p(t))`` and the
  sigmoid ``where(eta >= 0, 1 / (1 + t), t / (1 + t))``, ``resid = (y -
  sig) w``; ``logp = -0.5 inv_var |q|^2 + sum w ll``, ``grad = -inv_var q
  + resid x``.  Under ``grad_bf16`` ``resid`` and ``x`` are rounded to
  bfloat16 before the backward product (exact in float32) and the sum stays
  in ``q``'s dtype; the log density is never rounded.  :func:`logistic_data`
  sets ``grad_bf16`` only under ``physics_mode="chunked"``, as JAX reads it
  only there.  Observations with
  ``w = 0`` contribute exactly nothing.  :func:`logistic_data` builds the
  data.
* ``"stoch_vol"`` (BASELINE config 5's model, ``models/stoch_vol.py``;
  JAX's ``_make_tile_logp``, ``inplacedhmc_tpu/models/stoch_vol.py:61-93``):
  lanes ``[raw_phi, log_s, h_1..h_T]``; rows ``r2`` (the squared returns on
  the h lanes), ``h_mask`` (1 on the h lanes ``2..T+1``) and ``ar_mask``
  (1 on ``3..T+1``, the lanes with a predecessor); scalar ``t = T``.  With
  ``phi = tanh(raw_phi)``, ``inv_s = exp(-log_s)``, ``u = 1 - phi^2``,
  ``z1 = h_1 inv_s``, ``h`` the q of the h lanes (0 elsewhere), ``h'_l =
  h_{l-1}`` (0 at lane 0) and ``innov_l = (q_l - phi h'_l) inv_s`` on the
  ``ar_mask`` lanes (0 elsewhere): ``logp = -0.5 (raw_phi - 1.5)^2 - 0.5
  (log_s + 2)^2 + 0.5 log u - T log_s - 0.5 u z1^2 - 0.5 sum innov^2 + sum
  -0.5 (h + r2 e^-h)`` over the h lanes; on an h lane ``d/dh_l = 0.5 r2
  e^-h - 0.5 - innov_l inv_s + phi inv_s innov_{l+1}``, and ``- u z1
  inv_s`` more on lane 2 (h_1); ``d/draw_phi = -(raw_phi - 1.5) + u (-phi
  / u + phi z1^2 + inv_s sum innov_l h'_l)`` (``tanh' = u``; JAX's vjp
  takes the cotangent times ``(1 + phi)(1 - phi)``, the same to rounding,
  and both give NaN where ``tanh`` saturates and ``u = 0``, where the log
  density is ``-inf``); ``d/dlog_s = -(log_s + 2) - T + u z1^2 + sum
  innov^2``.  Three row sums: ``sum innov^2``, ``sum innov h'`` and the
  observation terms'.  Needs D >= 3.

Data shapes (:class:`Spec`): ``rows`` are ``[D]``, ``matrix`` ``[D, D]``,
``obs_matrix`` ``[npad, D]`` and ``obs_rows`` ``[npad]`` (``npad`` the
padded observation count), ``scalars`` Python floats that the kernel
receives, ``settings`` Python ints that only the plain version reads.
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


def logistic(q: torch.Tensor, data: dict):
    x, y, w = data["x"], data["y"], data["w"]
    pk, bn = data["inv_var"], data["block_n"]
    bf16 = data["grad_bf16"] != 0
    logp = -0.5 * pk * _rowsum(q * q)
    grad = -pk * q
    for j in range(0, x.shape[0], bn):
        xs, ys, ws = x[j:j + bn], y[j:j + bn], w[j:j + bn]
        eta = q @ xs.transpose(0, 1)
        t = torch.exp(-torch.abs(eta))
        ll = ys * eta - (torch.clamp(eta, min=0.0) + torch.log1p(t))
        logp = logp + _rowsum(ll * ws)
        inv1pt = 1.0 / (1.0 + t)
        sig = torch.where(eta >= 0.0, inv1pt, t * inv1pt)
        resid = (ys - sig) * ws
        if bf16:
            resid = resid.to(torch.bfloat16).to(q.dtype)
            xs = xs.to(torch.bfloat16).to(q.dtype)
        grad = grad + resid @ xs
    return logp, grad


def stoch_vol(q: torch.Tensor, data: dict):
    hm, am = data["h_mask"] != 0, data["ar_mask"] != 0
    r2, t = data["r2"], data["t"]
    raw_phi, log_s = q[:, 0], q[:, 1]
    phi = torch.tanh(raw_phi)
    inv_s = torch.exp(-log_s)
    u = 1.0 - phi * phi
    z1 = q[:, 2] * inv_s
    z1z1 = z1 * z1
    uz2 = u * z1z1
    h = torch.where(hm, q, 0.0)
    hprev = torch.nn.functional.pad(h[:, :-1], (1, 0))
    innov = torch.where(am, (q - phi[:, None] * hprev) * inv_s[:, None], 0.0)
    re = r2 * torch.exp(-h)
    s_ii = _rowsum(innov * innov)
    s_ih = _rowsum(innov * hprev)
    s_obs = _rowsum(torch.where(hm, -0.5 * (h + re), 0.0))
    innov_next = torch.nn.functional.pad(innov[:, 1:], (0, 1))
    grad = torch.where(hm, (0.5 * re - 0.5) - innov * inv_s[:, None]
                       + (phi * inv_s)[:, None] * innov_next, 0.0)
    grad[:, 2] = grad[:, 2] - (u * z1) * inv_s
    a, b = raw_phi - 1.5, log_s + 2.0
    grad[:, 0] = -a + u * ((-(phi / u) + phi * z1z1) + inv_s * s_ih)
    grad[:, 1] = ((-b - t) + uz2) + s_ii
    logp = -0.5 * (a * a) - 0.5 * (b * b) + 0.5 * torch.log(u) \
        - t * log_s - 0.5 * uz2 - 0.5 * s_ii + s_obs
    return logp, grad


#: the physics modes of JAX's ``make_logistic_tree_transition``: both run
#: the one hand-written physics, which computes their common function
LOGISTIC_MODES = ("chunked", "vjp")


def logistic_data(x, y, inv_var: float, *, physics_mode: str = "chunked",
                  grad_bf16: bool = False, block_n: int = 2048) -> dict:
    """The ``"logistic"`` physics' data from a model's ``x [N, D]``, ``y
    [N]`` and ``inv_var``, laid out as ``tree_pallas.py:1281-1285`` lays
    out its ``xobs``/``yw``: ``x`` with zero rows up to ``npad =
    round_up(N, block_n)``, ``y`` and the weights ``w`` (1 on the N
    observations, 0 on the padding) padded alike, on ``x``'s device in its
    dtype.  ``physics_mode`` ``"chunked"`` and ``"vjp"`` compute the same
    function and give the same data, but for ``grad_bf16``: JAX's ``"vjp"``
    form differentiates its float32 ``tile_logp`` and never reads it
    (``tree_pallas.py:1202-1222``), so under ``"vjp"`` the scalar is 0 and
    the gradient stays in ``x``'s dtype.  ``block_n`` must be positive."""
    if physics_mode not in LOGISTIC_MODES:
        raise ValueError(f"unknown physics_mode {physics_mode!r} "
                         f"(have {LOGISTIC_MODES})")
    block_n = int(block_n)
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    x = torch.as_tensor(x)
    n, d = x.shape
    npad = -(-n // block_n) * block_n
    kw = dict(dtype=x.dtype, device=x.device)
    xo = torch.zeros((npad, d), **kw)
    xo[:n] = x
    yo = torch.zeros((npad,), **kw)
    yo[:n] = torch.as_tensor(y, **kw)
    wo = torch.zeros((npad,), **kw)
    wo[:n] = 1.0
    return {"x": xo, "y": yo, "w": wo, "inv_var": float(inv_var),
            "grad_bf16": 1.0 if grad_bf16 and physics_mode != "vjp" else 0.0,
            "block_n": block_n}


class Spec(NamedTuple):
    """A physics: its plain value and gradient, and the names of its data
    in the order its kernel's launcher takes them: ``[D]`` rows, scalars,
    the ``[D, D]`` matrix (or ``None``), the ``[npad, D]`` observation
    matrix (or ``None``) and ``[npad]`` observation rows; ``settings`` are
    read by the plain version only."""

    value_and_grad: Callable
    rows: Tuple[str, ...]
    scalars: Tuple[str, ...] = ()
    matrix: Optional[str] = None
    obs_matrix: Optional[str] = None
    obs_rows: Tuple[str, ...] = ()
    settings: Tuple[str, ...] = ()

    def tensors(self) -> Tuple[str, ...]:
        return self.rows + tuple(n for n in (self.matrix, self.obs_matrix)
                                 if n) + self.obs_rows


#: every physics with a device function, by name
PHYSICS: Dict[str, Spec] = {
    "gaussian": Spec(gaussian, ("lam",)),
    "eight_schools": Spec(eight_schools, ("y", "sig", "obs_mask")),
    "funnel": Spec(funnel, ("x_mask",), ("k", "inv_s2")),
    "dense_gaussian": Spec(dense_gaussian, (), matrix="prec"),
    "logistic": Spec(logistic, (), ("inv_var", "grad_bf16"),
                     obs_matrix="x", obs_rows=("y", "w"),
                     settings=("block_n",)),
    "stoch_vol": Spec(stoch_vol, ("r2", "h_mask", "ar_mask"), ("t",)),
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

    def obs_matrix(self):
        name = PHYSICS[self.name].obs_matrix
        return None if name is None else self.data[name]

    def obs_rows(self):
        return [self.data[n] for n in PHYSICS[self.name].obs_rows]


def bind(name: str, data: dict, device=None, dtype=None) -> Bound:
    """``name``'s physics on ``data`` (its tensors, scalars and settings),
    the tensors cast to ``dtype`` on ``device`` and made contiguous
    (``None``: as given).  Raises on an unknown physics or a missing
    entry."""
    if name not in PHYSICS:
        raise ValueError(f"no tile physics {name!r} (have {sorted(PHYSICS)})")
    spec = PHYSICS[name]
    tensors = spec.tensors()
    missing = set(tensors + spec.scalars + spec.settings) - set(data)
    if missing:
        raise ValueError(f"physics {name!r} needs {sorted(missing)}")
    cast = {n: torch.as_tensor(data[n], device=device,
                               dtype=dtype).contiguous()
            for n in tensors}
    cast.update({n: float(data[n]) for n in spec.scalars})
    cast.update({n: int(data[n]) for n in spec.settings})
    return Bound(name, cast)
