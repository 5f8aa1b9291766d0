"""Philox4x32-10, the counter-based generator of the whole-tree kernel.

The plain torch version of what ``csrc/tree_gaussian.cu`` draws inside the
kernel: the port's counterpart of the TPU kernel's ``pltpu.prng_seed`` and
``_uniform_from_bits`` / ``_gauss_from_bits``
(``inplacedhmc_tpu/ops/tree_pallas.py``).  The TPU's bits cannot be
reproduced; Philox (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11) is its stand-in, with the same conversions to floats.

One launch has a key of two 32-bit words.  Every draw has its own counter
``(chain, s, stream, slot)``: ``s`` is the transition's index within a sweep,
``stream`` one of :data:`STREAM_MOMENTUM` (slot: the coordinate),
:data:`STREAM_DIRECTION` (slot 0) and :data:`STREAM_UNIFORM` (slot: the row
of the ``[2^md - 1 + md]`` proposal uniforms: leaf ``n`` of the subtree of
depth ``d`` reads ``2^d - 1 + n``, the merge at depth ``d`` reads
``2^md - 1 + d``).  So a draw depends on its own chain and slot only,
whichever chains run beside it, and a draw that a chain never reads costs
nothing.

torch has no unsigned 32-bit type with wrapping products, so everything here
is int64 holding values in ``[0, 2^32)``, masked where an operation could
leave that range; the 32 x 32 -> 64-bit products of the rounds are taken
with the multiplier in 16-bit halves, so that no partial product overflows
int64.  The key may be a pair of Python ints or an int64 tensor ``[2]`` (as
the kernel reads it).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10

STREAM_MOMENTUM, STREAM_DIRECTION, STREAM_UNIFORM = 0, 1, 2

#: 2 pi rounded to float32, the constant the kernel multiplies by
TWO_PI_F32 = 6.2831854820251465
#: 2^-24: a 24-bit integer times this is exact in float32
TWO_M24 = 1.0 / (1 << 24)


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * x`` for a constant 32-bit ``m`` and
    int64 ``x`` in ``[0, 2^32)``, from the 16-bit halves of ``m``: each
    partial product is below ``2^48``, and ``m x = t + (b >> 16) 2^32`` with
    ``t = x m_lo + (b mod 2^16) 2^16`` and ``b = x m_hi``."""
    b = x * (m >> 16)
    t = x * (m & 0xFFFF) + ((b & 0xFFFF) << 16)   # < 2^49
    return (t >> 32) + (b >> 16), t & MASK32


def _key_words(key):
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(k) & MASK32 for k in key)
    return k0, k1


def philox4x32(counter, key):
    """Philox4x32-10 of the four counter words (int64 tensors of one
    broadcast shape, or ints) under ``key``; returns the four output words
    as int64 tensors in ``[0, 2^32)``."""
    dev = next((c.device for c in counter if isinstance(c, torch.Tensor)),
               None)
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=dev)
                      & MASK32 for c in counter)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = _key_words(key)
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def _counter(rows: torch.Tensor, s: int, stream: int, slots: torch.Tensor):
    """Counters ``[len(slots), len(rows)]`` for the given chain rows."""
    return (rows[None, :], s, stream, slots[:, None])


def uniform_from_bits(bits: torch.Tensor, dtype=torch.float32):
    """``(bits >> 8) * 2^-24`` in ``[0, 1)``, from unsigned 32-bit words."""
    return (bits >> 8).to(dtype) * TWO_M24


def uniforms(key, rows: torch.Tensor, s: int, slots,
             dtype=torch.float32) -> torch.Tensor:
    """Proposal uniforms ``[len(slots), len(rows)]``: slot ``slots[i]`` of
    chain row ``rows[j]`` in transition ``s``."""
    slots = torch.as_tensor(slots, dtype=torch.int64, device=rows.device)
    w0, _, _, _ = philox4x32(_counter(rows, s, STREAM_UNIFORM, slots), key)
    return uniform_from_bits(w0, dtype)


def direction_words(key, rows: torch.Tensor, s: int) -> torch.Tensor:
    """The 32-bit direction words ``[len(rows)]`` (int64 in ``[0, 2^32)``)
    of transition ``s``: bit ``d`` drives doubling ``d``."""
    zero = torch.zeros((1,), dtype=torch.int64, device=rows.device)
    w0, _, _, _ = philox4x32(_counter(rows, s, STREAM_DIRECTION, zero), key)
    return w0[0]


def normals(key, rows: torch.Tensor, s: int, dim: int,
            dtype=torch.float32) -> torch.Tensor:
    """Standard normals ``[len(rows), dim]`` of transition ``s``: Box-Muller
    on the first two words of coordinate ``j``'s counter,
    ``u = ((bits >> 8) + 0.5) 2^-24`` (strictly inside (0, 1), so the log is
    finite), ``sqrt(-2 log u1) cos(2 pi u2)`` in ``dtype``."""
    slots = torch.arange(dim, dtype=torch.int64, device=rows.device)
    w0, w1, _, _ = philox4x32(_counter(rows, s, STREAM_MOMENTUM, slots), key)
    u1 = ((w0 >> 8).to(dtype) + 0.5) * TWO_M24
    u2 = ((w1 >> 8).to(dtype) + 0.5) * TWO_M24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return (r * torch.cos(TWO_PI_F32 * u2)).T.contiguous()


def draw_key(gen: torch.Generator) -> torch.Tensor:
    """A launch's key: two 32-bit words from ``gen``, as an int64 tensor
    ``[2]`` on the generator's device (the kernel reads it there, so no
    value crosses to the host)."""
    return torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64,
                         device=gen.device)


#: the largest value ``normals`` can return, ``sqrt(-2 log(0.5 2^-24))``
MAX_NORMAL = math.sqrt(-2.0 * math.log(0.5 * TWO_M24))
