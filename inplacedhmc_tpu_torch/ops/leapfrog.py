"""Fused leapfrog step for diagonal-Gaussian targets (``grad = -Lambda q``).

The port's counterpart of ``inplacedhmc_tpu/ops/leapfrog_pallas.py``
(``_kernel`` and ``make_fused_gaussian_leapfrog``).  One velocity-Verlet step
with a diagonal ``M^-1``::

    p_mid = p - (eps/2) (Lambda q)
    q'    = q + eps (Minv p_mid)
    grad' = -(Lambda q'),  p' = p_mid + (eps/2) grad',  p#' = Minv p'
    logp' = -1/2 sum (Lambda q') q',  kin' = 1/2 sum p' p#'

On a CUDA tensor :func:`fused_gaussian_leapfrog` launches the hand-written
kernel ``csrc/leapfrog_gaussian.cu``: one pass that reads q and p and writes
the four vectors and the two row sums.  On a CPU tensor it runs
:func:`fused_gaussian_leapfrog_plain`, the same arithmetic in plain torch.
There is no other path: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .common import check_tensor
from .cuda_build import CudaKernel

#: the kernel of ``csrc/leapfrog_gaussian.cu``;
#: ``LEAPFROG_GAUSSIAN.launches`` counts its launches
LEAPFROG_GAUSSIAN = CudaKernel(
    "leapfrog_gaussian.cu", "leapfrog_gaussian_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def fused_gaussian_leapfrog_plain(q, p, eps_signed, lam, minv):
    """Plain torch version of the kernel, in ``q``'s dtype and on its device:
    ``(q', p', grad', logp', kin', p#')`` for ``q, p [C, D]``, ``eps_signed
    [C]`` and the ``[D]`` rows ``lam`` (precision) and ``minv``."""
    eps = eps_signed[:, None]
    half = 0.5 * eps
    p_mid = p - half * (lam * q)
    q_new = q + eps * (minv * p_mid)
    grad_new = -(lam * q_new)
    p_new = p_mid + half * grad_new
    psharp_new = minv * p_new
    logp = -0.5 * torch.sum(lam * q_new * q_new, dim=1)
    kin = 0.5 * torch.sum(p_new * psharp_new, dim=1)
    return q_new, p_new, grad_new, logp, kin, psharp_new


def fused_gaussian_leapfrog(q: torch.Tensor, p: torch.Tensor,
                            eps_signed: torch.Tensor, lam: torch.Tensor,
                            minv: torch.Tensor):
    """``(q', p', grad', logp', kin', p#')``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/leapfrog_gaussian.cu`` on the current
    stream (float32, contiguous) or raise."""
    if q.device.type == "cpu":
        return fused_gaussian_leapfrog_plain(q, p, eps_signed, lam, minv)
    if q.device.type != "cuda":
        raise ValueError(f"leapfrog kernel: unsupported device {q.device}")
    if q.ndim != 2:
        raise ValueError("leapfrog kernel: q must be 2-D")
    c, d = q.shape
    for name, t, shape in (("q", q, (c, d)), ("p", p, (c, d)),
                           ("eps_signed", eps_signed, (c,)),
                           ("lam", lam, (d,)), ("minv", minv, (d,))):
        check_tensor("leapfrog kernel", name, t, shape, q.device)
    vec = [torch.empty((c, d), dtype=torch.float32, device=q.device)
           for _ in range(4)]
    col = [torch.empty((c,), dtype=torch.float32, device=q.device)
           for _ in range(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LEAPFROG_GAUSSIAN.launch(
            q.data_ptr(), p.data_ptr(), eps_signed.data_ptr(), lam.data_ptr(),
            minv.data_ptr(), *(t.data_ptr() for t in vec + col), c, d,
            stream)
    q_new, p_new, grad_new, psharp_new = vec
    logp, kin = col
    return q_new, p_new, grad_new, logp, kin, psharp_new


def make_fused_gaussian_leapfrog(precision, metric_inv):
    """A fused step for ``grad = -precision * q`` targets:
    ``step(q, p, eps_signed) -> (q', p', grad', logp', kin', p#')`` with
    ``q, p [C, D]`` and ``eps_signed [C]``.  ``metric_inv`` is the diagonal
    ``M^-1`` ``[D]``; rebuild the closure when the metric adapts.  The step
    runs on the inputs' device, in float32 on the card and in their dtype on
    the CPU."""

    def step(q, p, eps_signed):
        dt = torch.float32 if q.device.type == "cuda" else q.dtype

        def cast(t):
            return torch.as_tensor(t, device=q.device).to(dt).contiguous()

        eps = torch.as_tensor(eps_signed, dtype=dt, device=q.device)
        out = fused_gaussian_leapfrog(
            cast(q), cast(p), eps.expand(q.shape[0]).contiguous(),
            cast(precision), cast(metric_inv))
        return tuple(t.to(q.dtype) for t in out)

    return step
