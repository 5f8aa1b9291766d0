// The logistic body's tiles and tensor-core products, shared by the kernels
// that read X from the plane of ops/logistic.py::logistic_planes:
// logistic_vg.cu (K1 and K2, chains in blocks of 64) and tree_logistic.cu
// (K5-logistic, a tile of chains that walks its leaves in lockstep).
//
// A tile of the plane is BN observations by DC dimensions: X's tf32 hi and
// lo halves [BN][XS] (row stride XS = DC + 4 words: the forward's and the
// backward's fragment loads are free of bank conflicts), y and w [BN], and
// a form's own words (kGradBf16: X's bf16 values d-major in observation
// pairs [DC][XBW]; kPacked: X's bf16 halves [BN][XPW] each).  The products
// are mma.sync: 3xTF32 for the float32-grade ones (each operand a = a_hi +
// a_lo, a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a - a_hi); a.b ~ a_lo
// b_hi + a_hi b_lo + a_hi b_hi, the small terms first, float32
// accumulation), one bf16 pass for grad_bf16's backward (the residual and
// X rounded to bfloat16, nearest even: exact products, float32 sums).
// The C fragment of an eta product (16 chains x 8 observations) is the A
// fragment of the backward as it stands: for m16n8k8 tf32 the A
// fragment's column t4 / t4 + 4 takes C's columns 2 t4 / 2 t4 + 1, so the
// backward's B side reads the observations of each group of 8 in the order
// (0, 2, 4, 6, 1, 3, 5, 7); for m16n8k16 bf16 two C fragments of 8
// observations are one A fragment of 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lvg {

enum Form { kF32, kGradBf16, kPacked };

constexpr int BN = 32;                  // observations per tile
constexpr int DC = 64;                  // dimensions per chunk
constexpr int KS = DC / 8;              // tf32 k-steps (or n-tiles) a chunk
constexpr int XS = DC + 4;              // row stride (words), tf32 halves
constexpr int XBW = BN / 2 + 4;         // row stride (words), kGradBf16 pairs
constexpr int XPW = DC / 2 + 4;         // row stride (words), kPacked halves
// word offsets in a tile
constexpr int OFF_HI = 0;
constexpr int OFF_LO = BN * XS;
constexpr int OFF_Y = 2 * BN * XS;
constexpr int OFF_W = OFF_Y + BN;
constexpr int OFF_EXTRA = OFF_W + BN;

template <int FORM>
__host__ __device__ constexpr int tile_words() {
  return OFF_EXTRA + (FORM == kGradBf16 ? DC * XBW
                      : FORM == kPacked ? 2 * BN * XPW
                                        : 0);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v's tf32 halves: hi = cvt.rna(v), lo = cvt.rna(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_index,
                                         __nv_bfloat16 hi_index) {
  return (uint32_t)__bfloat16_as_ushort(lo_index) |
         ((uint32_t)__bfloat16_as_ushort(hi_index) << 16);
}
__device__ __forceinline__ uint32_t pack_rn(float lo_index, float hi_index) {
  return pack(__float2bfloat16_rn(lo_index), __float2bfloat16_rn(hi_index));
}

// d += a . b on the tensor cores, a 16 x 8 tf32 (row), b 8 x 8 tf32 (col),
// d 16 x 8 float32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a . b from the halves, the small products first
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// d += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one observation's term of logp, added to lacc, and its residual
// w (y - sigmoid(eta))
__device__ __forceinline__ float obs_term(float e, float yv, float wv,
                                          float& lacc) {
  const float t = expf(-fabsf(e));
  lacc = fmaf(wv, yv * e - (fmaxf(e, 0.f) + log1pf(t)), lacc);
  const float inv1pt = 1.f / (1.f + t);
  return (yv - (e >= 0.f ? inv1pt : t * inv1pt)) * wv;
}

__device__ __forceinline__ uint32_t word(const float* p, int i) {
  return __float_as_uint(p[i]);
}

// The k-steps (or n-tiles) of 8 dimensions a product takes: all NK of them
// (RAGGED = false: no branch, so the compiler schedules across them), or
// (RAGGED, the wide form's last chunk) the first nks, by a uniform branch
template <bool RAGGED>
__device__ __forceinline__ bool takes(int k, int nks) {
  return !RAGGED || k < nks;
}

// inner += r . X for the warp's 16 chains over n-tile j's 8 observations
// (tf32, 3 passes), into n-tiles of 8 dimensions: the residual's C
// fragment r is the A fragment {r0, r2, r1, r3}, so k-step row t4 is
// observation 2 t4 and t4 + 4 is 2 t4 + 1
template <int NK, bool RAGGED>
__device__ __forceinline__ void backward_tf32(float (&inner)[NK][4],
                                              const float (&r)[4], int j,
                                              const float* xh, const float* xl,
                                              int nks, int g, int t4) {
  uint32_t ah[4], al[4];
  split(r[0], ah[0], al[0]);
  split(r[2], ah[1], al[1]);
  split(r[1], ah[2], al[2]);
  split(r[3], ah[3], al[3]);
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    if (takes<RAGGED>(dn, nks)) {
      const int o = (8 * j + 2 * t4) * XS + 8 * dn + g;
      mma_3x(inner[dn], ah, al, word(xh, o), word(xh, o + XS), word(xl, o),
             word(xl, o + XS));
    }
  }
}

// inner += bf16(r) . bf16(X) over the 16 observations of n-tiles 2 p and
// 2 p + 1 (one bf16 pass): their two C fragments are one A fragment
template <int NK, bool RAGGED>
__device__ __forceinline__ void backward_bf16(float (&inner)[NK][4],
                                              const float (&r0)[4],
                                              const float (&r1)[4], int p,
                                              const uint32_t* xb, int nks,
                                              int g, int t4) {
  const uint32_t a[4] = {pack_rn(r0[0], r0[1]), pack_rn(r0[2], r0[3]),
                         pack_rn(r1[0], r1[1]), pack_rn(r1[2], r1[3])};
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    if (takes<RAGGED>(dn, nks)) {
      const int o = (8 * dn + g) * XBW + 8 * p + t4;
      mma_bf16(inner[dn], a, xb[o], xb[o + 4]);
    }
  }
}

// the backward of the residuals e (n-tiles 2 p, 2 p + 1) in the form's
// grade, into inner
template <int FORM, int NK, bool RAGGED>
__device__ __forceinline__ void backward(float (&inner)[NK][4],
                                         const float (&e)[2][4], int p,
                                         const float* tile, int nks, int g,
                                         int t4) {
  if constexpr (FORM == kGradBf16) {
    backward_bf16<NK, RAGGED>(
        inner, e[0], e[1], p,
        reinterpret_cast<const uint32_t*>(tile + OFF_EXTRA), nks, g, t4);
  } else {
    backward_tf32<NK, RAGGED>(inner, e[0], 2 * p, tile + OFF_HI,
                              tile + OFF_LO, nks, g, t4);
    backward_tf32<NK, RAGGED>(inner, e[1], 2 * p + 1, tile + OFF_HI,
                              tile + OFF_LO, nks, g, t4);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[k][e] = 0.f;
}

}  // namespace lvg
