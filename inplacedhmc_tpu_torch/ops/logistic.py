"""Fused value and gradient of Bayesian logistic regression.

The port's counterpart of ``inplacedhmc_tpu/ops/logistic_pallas.py``: for
chains ``q [C, D]`` over data ``X [N, D]`` the log density and its gradient are

    eta  = q X^T                                        [C, N]
    logp = sum_n w_n (y_n eta_n - log(1 + e^eta_n)) - s2/2 ||q||^2
    grad = (w (y - sigmoid(eta))) X - s2 q

Two launchers of one kernel body, ``csrc/logistic_vg.cu``, compute it,
each with a plain torch version beside it:

* :func:`logistic_value_and_grad` launches K1: both products float32-grade
  (3xTF32 on the tensor cores), and with ``grad_bf16`` the backward one
  bfloat16 pass on rounded inputs;
* :func:`logistic_value_and_grad_packed` launches K2: the forward as JAX's
  packed split-bf16 product ``(q_hi x_hi + q_lo x_hi) + q_hi x_lo`` on the
  tensor cores, D <= 64.

The kernel reads X from a *plane* (:func:`logistic_planes`): X's tf32
halves, y and w, laid out in the tiles that the kernel copies into shared
memory whole, made once per potential.  It splits the observations of each
block of chains across ``launch_splits`` blocks, whose partial sums a second
kernel adds in a fixed order.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version.  There is no other path.
:func:`make_logistic_potential` takes the options of JAX's
``make_logistic_potential`` (``fused_opts``) and picks between them.
"""

from __future__ import annotations

import ctypes
import math
import numbers

import torch
import torch.nn.functional as F

from .common import check_tensor
from .cuda_build import CudaKernel

#: K1, ``csrc/logistic_vg.cu``'s launcher of the float32-grade forms;
#: ``LOGISTIC_VG.launches`` counts its launches, ``LOGISTIC_VG.bf16_launches``
#: those of them with ``grad_bf16``
LOGISTIC_VG = CudaKernel(
    "logistic_vg.cu", "logistic_vg_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
LOGISTIC_VG.bf16_launches = 0
#: K2, the same source's packed-forward launcher
LOGISTIC_PACKED = CudaKernel(
    "logistic_vg.cu", "logistic_packed_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
#: the same source's occupancy query (no launch)
LOGISTIC_OCCUPANCY = CudaKernel(
    "logistic_vg.cu", "logistic_occupancy",
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: largest dimension of the packed forward (JAX's: the halves share 128
#: lanes)
PACKED_MAX_DIM = 64
#: the precisions JAX's ``make_logistic_potential`` accepts
FWD_PRECISIONS = ("default", "high", "high3", "highest", "packed")
BWD_PRECISIONS = ("default", "high", "high3", "highest")

# The kernel's tiles (csrc/logistic_vg.cu, which holds the same numbers):
#: chains a block (16 a warp, 4 warps)
BLOCK_CHAINS = 64
#: observations a tile, dimensions a chunk
TILE_OBS, CHUNK_DIMS = 32, 64
#: row strides in 32-bit words: X's tf32 halves [TILE_OBS][ROW_WORDS];
#: grad_bf16's X, d-major bf16 observation pairs [CHUNK_DIMS][PAIR_WORDS];
#: the packed forward's bf16 halves [TILE_OBS][HALF_WORDS]
ROW_WORDS = CHUNK_DIMS + 4
PAIR_WORDS = TILE_OBS // 2 + 4
HALF_WORDS = CHUNK_DIMS // 2 + 4
#: a split takes at least this many tiles
MIN_SPLIT_TILES = 2
#: the launchers' forms (csrc/logistic_vg.cu's Form)
FORMS = {"f32": 0, "grad_bf16": 1, "packed": 2}
OCCUPANCY_FIELDS = ("blocks_per_sm", "warps_per_sm", "sms", "registers",
                    "local_bytes", "smem_bytes", "stages", "tile_words")


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


def _rna_tf32(a):
    """``a`` (float32) rounded to tf32, to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: the 13 low bits of the float32 pattern
    dropped after adding half of them; infinities and NaNs as they are."""
    bits = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isfinite(a), (bits + 0x1000) & 0xFFFFE000, bits)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32) \
        .view(torch.float32)


def split_tf32(a):
    """``(hi, lo)``, float32 tensors of tf32 values: ``hi`` is ``a`` rounded
    to tf32 (:func:`_rna_tf32`, the kernel's ``cvt.rna.tf32.f32``), ``lo``
    the exact float32 remainder ``a - hi`` rounded the same way, so that
    ``|a - hi - lo| <= 2^-22 |a|``: the halves of the 3xTF32 products."""
    a = a.to(torch.float32).contiguous()
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a - hi)


def plane_shape(n: int, d: int, form: str = "f32"):
    """The shape ``[tiles, chunks, words]`` of :func:`logistic_planes`'s
    plane for ``n`` observations of ``d`` dimensions."""
    words = 2 * TILE_OBS * ROW_WORDS + 2 * TILE_OBS + {
        "f32": 0, "grad_bf16": CHUNK_DIMS * PAIR_WORDS,
        "packed": 2 * TILE_OBS * HALF_WORDS}[form]
    return (math.ceil(n / TILE_OBS), math.ceil(d / CHUNK_DIMS), words)


def logistic_planes(x, y, w, form: str = "f32", x_hi=None, x_lo=None):
    """X, y and w laid out for ``csrc/logistic_vg.cu``'s form ``form``
    (``"f32"``, ``"grad_bf16"`` or ``"packed"``): a float32 tensor of
    :func:`plane_shape`, on ``x``'s device, whose ``[t, j]`` word row is
    the tile that one bulk copy brings into shared memory for observations
    ``[32 t, 32 t + 32)`` and dimensions ``[64 j, 64 j + 64)``:

    * X's tf32 halves (:func:`split_tf32`), each ``[TILE_OBS][ROW_WORDS]``,
      observation-major (the 4 words past each row's 64 are padding);
    * y and w, ``[TILE_OBS]`` each (the same in every chunk);
    * ``"grad_bf16"``: X rounded to bfloat16, dimension-major, two
      observations a word (the lower half the even one),
      ``[CHUNK_DIMS][PAIR_WORDS]``;
    * ``"packed"`` (``d <= 64``): the given bfloat16 halves ``x_hi``,
      ``x_lo`` (:func:`split_bf16`), each ``[TILE_OBS][HALF_WORDS]``,
      observation-major, two dimensions a word.

    Observations past ``n`` carry ``x = y = w = 0``, dimensions past ``d``
    ``x = 0``: they add nothing.  Made once per potential
    (:func:`make_logistic_potential`)."""
    n, d = x.shape
    t, nc, _ = plane_shape(n, d, form)
    npad, dpad = t * TILE_OBS, nc * CHUNK_DIMS
    dev = x.device

    def tiles(a):  # [npad, dpad] int32 -> [t, nc, TILE_OBS * ROW_WORDS]
        a = a.reshape(t, TILE_OBS, nc, CHUNK_DIMS).permute(0, 2, 1, 3)
        return F.pad(a, (0, ROW_WORDS - CHUNK_DIMS)).reshape(t, nc, -1)

    xp = torch.zeros((npad, dpad), dtype=torch.float32, device=dev)
    xp[:n, :d] = x
    hi, lo = split_tf32(xp)
    yw = [torch.zeros(npad, dtype=torch.float32, device=dev)
          for _ in range(2)]
    yw[0][:n], yw[1][:n] = y, w
    parts = [tiles(hi.view(torch.int32)), tiles(lo.view(torch.int32))]
    parts += [v.view(torch.int32).reshape(t, 1, TILE_OBS).expand(t, nc, -1)
              for v in yw]
    if form == "grad_bf16":
        xb = xp.to(torch.bfloat16).reshape(t, TILE_OBS, nc, CHUNK_DIMS) \
            .permute(0, 2, 3, 1).contiguous().view(torch.int32)
        parts.append(F.pad(xb, (0, PAIR_WORDS - TILE_OBS // 2))
                     .reshape(t, nc, -1))
    elif form == "packed":
        if nc != 1:
            raise ValueError(f"packed plane: D={d} outside "
                             f"[1, {PACKED_MAX_DIM}]")
        for half in (x_hi, x_lo):
            hp = torch.zeros((npad, dpad), dtype=torch.bfloat16, device=dev)
            hp[:n, :d] = half
            hw = hp.view(torch.int32).reshape(t, TILE_OBS, CHUNK_DIMS // 2)
            parts.append(F.pad(hw, (0, HALF_WORDS - CHUNK_DIMS // 2))
                         .reshape(t, 1, -1))
    elif form != "f32":
        raise ValueError(f"unknown plane form {form!r} (have {tuple(FORMS)})")
    return torch.cat(parts, dim=-1).contiguous().view(torch.float32)


def launch_splits(c: int, n: int, blocks_per_sm: int, sms: int) -> int:
    """The blocks across which a launch splits the observation tiles of
    each block of ``BLOCK_CHAINS`` chains: enough that the chains' blocks
    times the splits fill ``sms`` SMs at ``blocks_per_sm`` (one wave), at
    least ``MIN_SPLIT_TILES`` tiles a split, at least 1.  The kernel gives
    split s of S the tiles ``[T s // S, T (s + 1) // S)`` of the T."""
    tiles = math.ceil(n / TILE_OBS)
    chain_blocks = max(math.ceil(c / BLOCK_CHAINS), 1)
    want = max(1, blocks_per_sm * sms // chain_blocks)
    return max(1, min(want, tiles // MIN_SPLIT_TILES, 65535))


_OCCUPANCY = {}


def occupancy(form: str, d: int, device=None) -> dict:
    """``OCCUPANCY_FIELDS`` of the instantiation that a launch of ``form``
    at dimension ``d`` takes, on ``device`` (a CUDA device): blocks and
    warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the
    card's SMs, registers and local (spill) bytes a thread, shared memory
    a block, ring stages and words a tile.  Cached per device."""
    dev = torch.device("cuda" if device is None else device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, form, min(math.ceil(d / 8), 9))   # the instantiation
    if key not in _OCCUPANCY:
        out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
        with torch.cuda.device(idx):
            LOGISTIC_OCCUPANCY.call(FORMS[form], d, ctypes.addressof(out))
        _OCCUPANCY[key] = dict(zip(OCCUPANCY_FIELDS, out))
    return _OCCUPANCY[key]


def _splits(form: str, c: int, n: int, d: int, device) -> int:
    """:func:`launch_splits` on ``device`` at ``form``'s occupancy (K1's
    float32 form for both K1 forms: ``grad_bf16`` then sums logp as
    without it, to the bit)."""
    occ = occupancy("packed" if form == "packed" else "f32", d, device)
    return launch_splits(c, n, occ["blocks_per_sm"], occ["sms"])


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
                            grad_bf16: bool = False, planes=None):
    """``(logp [C], grad [C, D])`` for chains ``q [C, D]``, data ``x [N, D]``,
    labels ``y [N]``, observation weights ``w [N]`` and prior precision
    ``s2``; ``grad_bf16`` rounds the backward product's inputs (the
    residual and ``x``) to bfloat16, its sum staying float32.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/logistic_vg.cu`` on
    the current stream (float32, contiguous, any D) or raise.  ``planes``
    is :func:`logistic_planes` of ``x, y, w`` in the form the launch takes
    (``"grad_bf16"`` with the option, else ``"f32"``), made here when not
    given."""
    if q.device.type == "cpu":
        return logistic_value_and_grad_plain(q, x, y, w, s2, grad_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"logistic kernel: unsupported device {q.device}")
    if q.ndim != 2 or x.ndim != 2:
        raise ValueError("logistic kernel: q and x must be 2-D")
    c, d = q.shape
    n = x.shape[0]
    if d < 1:
        raise ValueError(f"logistic kernel: D={d} < 1")
    for name, t, shape in (("q", q, (c, d)), ("x", x, (n, d)),
                           ("y", y, (n,)), ("w", w, (n,))):
        check_tensor("logistic kernel", name, t, shape, q.device)
    form = "grad_bf16" if grad_bf16 else "f32"
    if planes is None:
        planes = logistic_planes(x, y, w, form)
    check_tensor("logistic kernel", "planes", planes,
                 plane_shape(n, d, form), q.device)
    splits = _splits(form, c, n, d, q.device)
    logp = torch.empty((c,), dtype=torch.float32, device=q.device)
    grad = torch.empty((c, d), dtype=torch.float32, device=q.device)
    part = torch.empty((splits * c * (d + 1),), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LOGISTIC_VG.launch(q.data_ptr(), planes.data_ptr(), float(s2),
                           logp.data_ptr(), grad.data_ptr(), part.data_ptr(),
                           c, n, d, int(bool(grad_bf16)), splits, stream)
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
                                   s2: float, planes=None):
    """K2: ``(logp [C], grad [C, D])`` with the packed split-bf16 forward,
    for ``q [C, D]``, the bfloat16 halves ``x_hi, x_lo [N, D]`` of the
    float32 data ``x [N, D]`` (:func:`split_bf16`), ``y``, ``w [N]`` and
    ``s2``.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/logistic_vg.cu``'s packed form on the current stream (q, x, y, w
    float32, the halves bfloat16, all contiguous, ``D <= 64``) or raise.
    ``planes`` is :func:`logistic_planes` of form ``"packed"``, made here
    when not given."""
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
    if planes is None:
        planes = logistic_planes(x, y, w, "packed", x_hi, x_lo)
    check_tensor("packed logistic kernel", "planes", planes,
                 plane_shape(n, d, "packed"), q.device)
    splits = _splits("packed", c, n, d, q.device)
    logp = torch.empty((c,), dtype=torch.float32, device=q.device)
    grad = torch.empty((c, d), dtype=torch.float32, device=q.device)
    part = torch.empty((splits * c * (d + 1),), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LOGISTIC_PACKED.launch(q.data_ptr(), planes.data_ptr(), float(s2),
                               logp.data_ptr(), grad.data_ptr(),
                               part.data_ptr(), c, n, d, splits, stream)
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
      the forward or the backward: K1's float32-grade products, 3xTF32 on
      the card (within about 2^-21 of each product, as JAX's 3-pass
      ``"high"``, which also drops the lo.lo term), float32 in the plain
      version.  On the CPU JAX's ``"default"``
      and ``"highest"`` are float32 too: float32 grade.  The TPU's 1-pass
      bfloat16 ``"default"`` is not reproduced: JAX's own docstring calls
      it a perturbation of the target density, and no 1-pass TF32 product
      is used either.
    * Any D on the card (K2 to 64).  The kernel's plane of the data
      (:func:`logistic_planes`) is made once per device, on the first
      evaluation there.
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
    x_hi = x_lo = None
    if form == "packed":
        x_hi, x_lo = split_bf16(x)
    plane_form = form if form == "packed" else \
        ("grad_bf16" if grad_bf16 else "f32")
    planes = {}   # device -> the kernel's plane of the data

    def potential(q):
        if q.shape[-1] != d:
            raise ValueError(f"dim mismatch: {q.shape[-1]} != {d}")
        dt = torch.float32 if q.device.type == "cuda" else q.dtype
        args = (x.to(dt), y.to(dt), w.to(dt), inv_var)
        plane = None
        if q.device.type == "cuda":
            if q.device not in planes:
                planes[q.device] = logistic_planes(
                    args[0], args[1], args[2], plane_form, x_hi,
                    x_lo).to(q.device)
            plane = planes[q.device]
        if form == "packed":
            logp, grad = logistic_value_and_grad_packed(
                q.to(dt).contiguous(), x_hi, x_lo, *args, planes=plane)
        else:
            logp, grad = logistic_value_and_grad(
                q.to(dt).contiguous(), *args, grad_bf16=grad_bf16,
                planes=plane)
        return logp.to(q.dtype), grad.to(q.dtype)

    return potential
