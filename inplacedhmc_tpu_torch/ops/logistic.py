"""Fused value and gradient of Bayesian logistic regression.

The port's counterpart of ``inplacedhmc_tpu/ops/logistic_pallas.py``: for
chains ``q [C, D]`` over data ``X [N, D]`` the log density and its gradient are

    eta  = q X^T                                        [C, N]
    logp = sum_n w_n (y_n eta_n - log(1 + e^eta_n)) - s2/2 ||q||^2
    grad = (w (y - sigmoid(eta))) X - s2 q

On a CUDA tensor :func:`logistic_value_and_grad` launches the hand-written
kernel ``csrc/logistic_vg.cu``, which never stores ``eta``; on a CPU tensor it
runs :func:`logistic_value_and_grad_plain`, the same arithmetic in plain
torch.  There is no other path: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .common import check_tensor
from .cuda_build import CudaKernel

#: the kernel of ``csrc/logistic_vg.cu``; ``LOGISTIC_VG.launches`` counts its
#: launches
LOGISTIC_VG = CudaKernel(
    "logistic_vg.cu", "logistic_vg_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])

#: largest dimension the kernel's register tiles take
MAX_DIM = 256


def _guard_kernel_outputs(logp, grad):
    """The fused potential's guard: a non-finite logp becomes ``-inf`` and
    zeroes its chain's gradient; a non-finite gradient component becomes 0."""
    ok = torch.isfinite(logp)
    logp = torch.where(ok, logp, torch.full_like(logp, -torch.inf))
    grad = torch.where(ok[:, None] & torch.isfinite(grad), grad,
                       torch.zeros_like(grad))
    return logp, grad


def logistic_value_and_grad_plain(q, x, y, w, s2: float):
    """Plain torch version of the kernel, in ``q``'s dtype and on its device:
    the same shared ``t = exp(-|eta|)`` for the stable ``log1p`` and the
    sigmoid, the same guard."""
    eta = q @ x.transpose(0, 1)
    t = torch.exp(-torch.abs(eta))
    ll = y * eta - (torch.clamp(eta, min=0.0) + torch.log1p(t))
    logp = torch.sum(ll * w, dim=1) - 0.5 * s2 * torch.sum(q * q, dim=1)
    inv1pt = 1.0 / (1.0 + t)
    sig = torch.where(eta >= 0.0, inv1pt, t * inv1pt)
    grad = ((y - sig) * w) @ x - s2 * q
    return _guard_kernel_outputs(logp, grad)


def logistic_value_and_grad(q: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            w: torch.Tensor, s2: float):
    """``(logp [C], grad [C, D])`` for chains ``q [C, D]``, data ``x [N, D]``,
    labels ``y [N]``, observation weights ``w [N]`` and prior precision
    ``s2``.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/logistic_vg.cu`` on the current stream (float32, contiguous,
    ``D <= 256``) or raise."""
    if q.device.type == "cpu":
        return logistic_value_and_grad_plain(q, x, y, w, s2)
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
                           grad.data_ptr(), c, n, d, stream)
    return logp, grad


def make_logistic_potential(x: torch.Tensor, y: torch.Tensor, inv_var: float):
    """A batched potential ``q [C, D] -> (logp [C], grad [C, D])`` through
    :func:`logistic_value_and_grad`.  The data stays where it is given; the
    potential evaluates on ``q``'s device, in float32 on the card and in
    ``q``'s dtype on the CPU."""
    w = torch.ones_like(y)
    d = x.shape[1]

    def potential(q):
        if q.shape[-1] != d:
            raise ValueError(f"dim mismatch: {q.shape[-1]} != {d}")
        dt = torch.float32 if q.device.type == "cuda" else q.dtype
        logp, grad = logistic_value_and_grad(
            q.to(dt).contiguous(), x.to(dt), y.to(dt), w.to(dt), inv_var)
        return logp.to(q.dtype), grad.to(q.dtype)

    return potential
