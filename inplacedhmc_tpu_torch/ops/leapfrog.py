"""Fused leapfrog step for diagonal-Gaussian targets (``grad = -Lambda q``).

The port's counterpart of ``inplacedhmc_tpu/ops/leapfrog_pallas.py``
(``_kernel`` and ``make_fused_gaussian_leapfrog``).  One velocity-Verlet step
with a diagonal ``M^-1``::

    p_mid = p - (eps/2) (Lambda q)
    q'    = q + eps (Minv p_mid)
    grad' = -(Lambda q'),  p' = p_mid + (eps/2) grad',  p#' = Minv p'
    logp' = -1/2 sum (Lambda q') q',  kin' = 1/2 sum p' p#'

On a CUDA tensor :func:`fused_gaussian_leapfrog` launches the hand-written
kernel ``csrc/leapfrog_gaussian.cu`` (K3): one pass that reads q and p and
writes the four vectors and the two row sums.  On a CPU tensor it runs
:func:`fused_gaussian_leapfrog_plain`, the same arithmetic in plain torch.
There is no other path: a CUDA tensor launches the kernel or raises.

:func:`multi_step_leapfrog` (K4, the second launcher of the same source) is
the counterpart of JAX's ``multi_step_leapfrog``: ``k_steps`` dependent
steps in one launch, q and p held on chip, q' and p' written.  Its one
caller is the roofline harness ``tools/roofline_torch.py``.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .common import check_tensor
from .cuda_build import CudaKernel

#: the kernel of ``csrc/leapfrog_gaussian.cu``;
#: ``LEAPFROG_GAUSSIAN.launches`` counts its launches
LEAPFROG_GAUSSIAN = CudaKernel(
    "leapfrog_gaussian.cu", "leapfrog_gaussian_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
#: the multi-step kernel of the same source; ``LEAPFROG_MULTISTEP.launches``
#: counts its launches
LEAPFROG_MULTISTEP = CudaKernel(
    "leapfrog_gaussian.cu", "leapfrog_multistep_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])


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


def multi_step_leapfrog_plain(q, p, eps_signed, lam, minv, k_steps: int):
    """Plain torch version of K4, in ``q``'s dtype and on its device:
    ``(q', p')`` after ``k_steps`` steps, each the operations of
    :func:`fused_gaussian_leapfrog_plain` in its order, so that the result
    equals ``k_steps`` chained plain steps bit for bit."""
    eps = eps_signed[:, None]
    half = 0.5 * eps
    for _ in range(k_steps):
        p_mid = p - half * (lam * q)
        q = q + eps * (minv * p_mid)
        p = p_mid + half * (-(lam * q))
    return q, p


def multi_step_leapfrog(q: torch.Tensor, p: torch.Tensor,
                        eps_signed: torch.Tensor, lam: torch.Tensor,
                        minv: torch.Tensor, k_steps: int):
    """``(q', p')`` after ``k_steps`` (>= 1) dependent steps with one signed
    step size per chain, ``eps_signed [C]``, and the ``[D]`` rows ``lam``
    (precision) and ``minv``, unpadded as K3 takes them.  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/leapfrog_gaussian.cu``'s
    multi-step kernel on the current stream (float32, contiguous) or
    raise."""
    if isinstance(k_steps, bool) or not isinstance(k_steps, numbers.Integral) \
            or not 1 <= k_steps < 2 ** 31:
        raise ValueError(f"multi-step leapfrog: k_steps must be an integer "
                         f"in [1, 2^31), got {k_steps!r}")
    k_steps = int(k_steps)
    if q.device.type == "cpu":
        return multi_step_leapfrog_plain(q, p, eps_signed, lam, minv,
                                         k_steps)
    if q.device.type != "cuda":
        raise ValueError(f"multi-step leapfrog: unsupported device "
                         f"{q.device}")
    if q.ndim != 2:
        raise ValueError("multi-step leapfrog: q must be 2-D")
    c, d = q.shape
    for name, t, shape in (("q", q, (c, d)), ("p", p, (c, d)),
                           ("eps_signed", eps_signed, (c,)),
                           ("lam", lam, (d,)), ("minv", minv, (d,))):
        check_tensor("multi-step leapfrog", name, t, shape, q.device)
    q_new = torch.empty((c, d), dtype=torch.float32, device=q.device)
    p_new = torch.empty((c, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LEAPFROG_MULTISTEP.launch(
            q.data_ptr(), p.data_ptr(), eps_signed.data_ptr(),
            lam.data_ptr(), minv.data_ptr(), q_new.data_ptr(),
            p_new.data_ptr(), c, d, k_steps, stream)
    return q_new, p_new


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
