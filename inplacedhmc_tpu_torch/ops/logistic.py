"""Fused value and gradient of Bayesian logistic regression.

The port's counterpart of ``inplacedhmc_tpu/ops/logistic_pallas.py``: for
chains ``q [C, D]`` over data ``X [N, D]`` the log density and its gradient are

    eta  = q X^T                                        [C, N]
    logp = sum_n w_n (y_n eta_n - log(1 + e^eta_n)) - s2/2 ||q||^2
    grad = (w (y - sigmoid(eta))) X - s2 q

Two launchers of one kernel body, ``csrc/logistic_vg.cu``, compute it,
each with a plain torch version beside it:

* :func:`logistic_value_and_grad` launches K1, the float32 forward, and
  with ``grad_bf16`` the backward product on bfloat16-rounded inputs;
* :func:`logistic_value_and_grad_packed` launches K2: the forward as JAX's
  packed split-bf16 product ``(q_hi x_hi + q_lo x_hi) + q_hi x_lo`` on the
  tensor cores, D <= 64.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version.  There is no other path.
:func:`make_logistic_potential` takes the options of JAX's
``make_logistic_potential`` (``fused_opts``) and picks between them.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .common import check_tensor
from .cuda_build import CudaKernel

#: K1, ``csrc/logistic_vg.cu``'s float32-forward launcher;
#: ``LOGISTIC_VG.launches`` counts its launches, ``LOGISTIC_VG.bf16_launches``
#: those of them with ``grad_bf16``
LOGISTIC_VG = CudaKernel(
    "logistic_vg.cu", "logistic_vg_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
LOGISTIC_VG.bf16_launches = 0
#: K2, the same source's packed-forward launcher
LOGISTIC_PACKED = CudaKernel(
    "logistic_vg.cu", "logistic_packed_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int, ctypes.c_void_p])

#: largest dimension K1's register tiles take
MAX_DIM = 256
#: largest dimension of the packed forward (JAX's: the halves share 128
#: lanes)
PACKED_MAX_DIM = 64
#: the precisions JAX's ``make_logistic_potential`` accepts
FWD_PRECISIONS = ("default", "high", "high3", "highest", "packed")
BWD_PRECISIONS = ("default", "high", "high3", "highest")


def _guard_kernel_outputs(logp, grad):
    """The fused potential's guard: a non-finite logp becomes ``-inf`` and
    zeroes its chain's gradient; a non-finite gradient component becomes 0."""
    ok = torch.isfinite(logp)
    logp = torch.where(ok, logp, torch.full_like(logp, -torch.inf))
    grad = torch.where(ok[:, None] & torch.isfinite(grad), grad,
                       torch.zeros_like(grad))
    return logp, grad


def _bf16(t):
    """``t`` rounded to bfloat16 (to nearest even) from its float32 value, in
    ``t``'s dtype: what the kernels do to a float32 value."""
    return t.to(torch.float32).to(torch.bfloat16).to(t.dtype)


def split_bf16(a):
    """``(hi, lo)``: the bfloat16 halves of ``a`` taken as float32, as JAX's
    ``_split_bf16``: ``hi`` is ``a`` rounded to nearest even, ``lo`` the
    exact float32 remainder ``a - hi`` rounded the same way."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _value_and_grad_from_eta(eta, q, x, y, w, s2: float,
                             grad_bf16: bool = False):
    """Both kernels' work after the forward product: the shared
    ``t = exp(-|eta|)`` for the stable ``log1p`` and the sigmoid, the
    backward product (its inputs rounded to bfloat16 under ``grad_bf16``),
    the prior and the guard."""
    t = torch.exp(-torch.abs(eta))
    ll = y * eta - (torch.clamp(eta, min=0.0) + torch.log1p(t))
    logp = torch.sum(ll * w, dim=1) - 0.5 * s2 * torch.sum(q * q, dim=1)
    inv1pt = 1.0 / (1.0 + t)
    sig = torch.where(eta >= 0.0, inv1pt, t * inv1pt)
    resid = (y - sig) * w
    if grad_bf16:
        resid, x = _bf16(resid), _bf16(x)
    grad = resid @ x - s2 * q
    return _guard_kernel_outputs(logp, grad)


def logistic_value_and_grad_plain(q, x, y, w, s2: float,
                                  grad_bf16: bool = False):
    """Plain torch version of K1, in ``q``'s dtype and on its device."""
    return _value_and_grad_from_eta(q @ x.transpose(0, 1), q, x, y, w, s2,
                                    grad_bf16)


def logistic_value_and_grad(q: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            w: torch.Tensor, s2: float,
                            grad_bf16: bool = False):
    """``(logp [C], grad [C, D])`` for chains ``q [C, D]``, data ``x [N, D]``,
    labels ``y [N]``, observation weights ``w [N]`` and prior precision
    ``s2``; ``grad_bf16`` rounds the backward product's inputs (the
    residual and ``x``) to bfloat16, its sum staying float32.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/logistic_vg.cu`` on
    the current stream (float32, contiguous, ``D <= 256``) or raise."""
    if q.device.type == "cpu":
        return logistic_value_and_grad_plain(q, x, y, w, s2, grad_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"logistic kernel: unsupported device {q.device}")
    if q.ndim != 2 or x.ndim != 2:
        raise ValueError("logistic kernel: q and x must be 2-D")
    c, d = q.shape
    n = x.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"logistic kernel: D={d} outside [1, {MAX_DIM}]")
    for name, t, shape in (("q", q, (c, d)), ("x", x, (n, d)),
                           ("y", y, (n,)), ("w", w, (n,))):
        check_tensor("logistic kernel", name, t, shape, q.device)
    logp = torch.empty((c,), dtype=torch.float32, device=q.device)
    grad = torch.empty((c, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LOGISTIC_VG.launch(q.data_ptr(), x.data_ptr(), y.data_ptr(),
                           w.data_ptr(), float(s2), logp.data_ptr(),
                           grad.data_ptr(), c, n, d, int(bool(grad_bf16)),
                           stream)
    if grad_bf16:
        LOGISTIC_VG.bf16_launches += 1
    return logp, grad


def logistic_value_and_grad_packed_plain(q, x_hi, x_lo, x, y, w, s2: float):
    """Plain torch version of K2, in ``q``'s dtype and on its device: ``q``
    split into bfloat16 halves (:func:`split_bf16`), the three products on
    the halves widened to that dtype, the first two in one product over the
    packed operands ``[q_hi | q_lo] . [x_hi | x_hi]`` as JAX's
    ``_make_packed_kernel`` forms them, then K1's work on ``eta`` with the
    float32 ``x``."""
    q_hi, q_lo = (t.to(q.dtype) for t in split_bf16(q))
    xh, xl = x_hi.to(q.dtype), x_lo.to(q.dtype)
    eta = (torch.cat([q_hi, q_lo], dim=1) @ torch.cat([xh, xh], dim=1).T
           + q_hi @ xl.T)
    return _value_and_grad_from_eta(eta, q, x, y, w, s2)


def logistic_value_and_grad_packed(q: torch.Tensor, x_hi: torch.Tensor,
                                   x_lo: torch.Tensor, x: torch.Tensor,
                                   y: torch.Tensor, w: torch.Tensor,
                                   s2: float):
    """K2: ``(logp [C], grad [C, D])`` with the packed split-bf16 forward,
    for ``q [C, D]``, the bfloat16 halves ``x_hi, x_lo [N, D]`` of the
    float32 data ``x [N, D]`` (:func:`split_bf16`), ``y``, ``w [N]`` and
    ``s2``.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/logistic_vg.cu``'s packed form on the current stream (q, x, y, w float32,
    the halves bfloat16, all contiguous, ``D <= 64``) or raise."""
    if q.device.type == "cpu":
        return logistic_value_and_grad_packed_plain(q, x_hi, x_lo, x, y, w,
                                                    s2)
    if q.device.type != "cuda":
        raise ValueError(f"packed logistic kernel: unsupported device "
                         f"{q.device}")
    if q.ndim != 2 or x.ndim != 2:
        raise ValueError("packed logistic kernel: q and x must be 2-D")
    c, d = q.shape
    n = x.shape[0]
    if not 1 <= d <= PACKED_MAX_DIM:
        raise ValueError(f"packed logistic kernel: D={d} outside "
                         f"[1, {PACKED_MAX_DIM}]")
    for name, t, shape, dt in (("q", q, (c, d), torch.float32),
                               ("x_hi", x_hi, (n, d), torch.bfloat16),
                               ("x_lo", x_lo, (n, d), torch.bfloat16),
                               ("x", x, (n, d), torch.float32),
                               ("y", y, (n,), torch.float32),
                               ("w", w, (n,), torch.float32)):
        check_tensor("packed logistic kernel", name, t, shape, q.device, dt)
    logp = torch.empty((c,), dtype=torch.float32, device=q.device)
    grad = torch.empty((c, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LOGISTIC_PACKED.launch(q.data_ptr(), x_hi.data_ptr(),
                               x_lo.data_ptr(), x.data_ptr(), y.data_ptr(),
                               w.data_ptr(), float(s2), logp.data_ptr(),
                               grad.data_ptr(), c, n, d, stream)
    return logp, grad


def _check_options(d: int, block_c, block_n, grad_bf16: bool,
                   _ablate_trans: bool, fwd_precision: str,
                   bwd_precision: str) -> str:
    """JAX's checks of ``make_logistic_potential``'s options, with its error
    types and messages; returns the forward ``"packed"`` or ``"f32"``."""
    if fwd_precision not in FWD_PRECISIONS:
        raise ValueError(f"fwd_precision {fwd_precision!r} not in "
                         f"{FWD_PRECISIONS}")
    if bwd_precision not in BWD_PRECISIONS:
        raise ValueError(f"bwd_precision {bwd_precision!r} not in "
                         f"{BWD_PRECISIONS}")
    if bwd_precision == "high3":
        bwd_precision = "high"
    packed_ok = d <= PACKED_MAX_DIM and not grad_bf16 \
        and bwd_precision == "default"
    if fwd_precision == "packed" and not packed_ok:
        raise ValueError("packed forward needs D <= 64, grad_bf16=False, "
                         "bwd_precision='default' "
                         f"(got D={d}, grad_bf16={grad_bf16}, "
                         f"bwd_precision={bwd_precision!r})")
    for name, v in (("block_c", block_c), ("block_n", block_n)):
        if isinstance(v, bool) or not isinstance(v, numbers.Integral) \
                or v < 1:
            raise ValueError(f"{name} must be a positive integer, got {v!r}")
    if _ablate_trans:
        raise NotImplementedError(
            "_ablate_trans (a measurement hook of the TPU kernel that "
            "computes a wrong density) is not ported to "
            "inplacedhmc_tpu_torch")
    return "packed" if fwd_precision == "packed" else "f32"


def make_logistic_potential(x: torch.Tensor, y: torch.Tensor, inv_var: float,
                            block_c: int = 512, block_n: int = 1024,
                            grad_bf16: bool = False,
                            _ablate_trans: bool = False,
                            fwd_precision: str = "high",
                            bwd_precision: str = "default"):
    """A batched potential ``q [C, D] -> (logp [C], grad [C, D])``.  The
    data stays where it is given; the potential evaluates on ``q``'s device,
    in float32 on the card and in ``q``'s dtype on the CPU.

    The keywords are those of JAX's ``make_logistic_potential`` (the
    ``fused_opts`` of :func:`~inplacedhmc_tpu_torch.sample.sample`),
    checked as JAX checks them, and map so:

    * ``fwd_precision="packed"`` (D <= 64, no ``grad_bf16``,
      ``bwd_precision="default"``): K2, :func:`logistic_value_and_grad_packed`.
      The data's bfloat16 halves are made once, here.
    * ``grad_bf16=True``: K1 with the backward product's inputs rounded to
      bfloat16, float32 sums: what JAX's kernel does by an explicit
      ``astype`` on every platform.
    * ``"default"``, ``"high"`` (alias ``"high3"``) and ``"highest"``, of
      the forward or the backward: K1's IEEE float32 products.  On the CPU
      JAX's ``"default"`` and ``"highest"`` are float32 too, and its
      ``"high"`` the 3-pass split, which drops the lo.lo term: float32
      grade.  The TPU's 1-pass bfloat16 ``"default"`` is not reproduced:
      JAX's own docstring calls it a perturbation of the target density.
    * ``block_c``, ``block_n``: tiles of the TPU kernel, which change no
      output; checked as positive integers and not read.  The port's
      kernels keep their own tiles.
    * ``_ablate_trans``, JAX's measurement hook that computes a wrong
      density, raises ``NotImplementedError``.
    """
    d = x.shape[1]
    form = _check_options(d, block_c, block_n, grad_bf16, _ablate_trans,
                          fwd_precision, bwd_precision)
    w = torch.ones_like(y)
    if form == "packed":
        x_hi, x_lo = split_bf16(x)

    def potential(q):
        if q.shape[-1] != d:
            raise ValueError(f"dim mismatch: {q.shape[-1]} != {d}")
        dt = torch.float32 if q.device.type == "cuda" else q.dtype
        args = (x.to(dt), y.to(dt), w.to(dt), inv_var)
        if form == "packed":
            logp, grad = logistic_value_and_grad_packed(
                q.to(dt).contiguous(), x_hi, x_lo, *args)
        else:
            logp, grad = logistic_value_and_grad(q.to(dt).contiguous(),
                                                 *args, grad_bf16=grad_bf16)
        return logp.to(q.dtype), grad.to(q.dtype)

    return potential
