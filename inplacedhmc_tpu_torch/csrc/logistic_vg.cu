// Fused logistic-regression log density and gradient for a batch of chains.
//
// Replaces the TPU kernels inplacedhmc_tpu/ops/logistic_pallas.py::
// _make_fused_kernel (K1, launched by _logistic_value_and_grad_padded) and
// _make_packed_kernel (K2, launched by _logistic_value_and_grad_packed),
// both built by make_logistic_potential.  For chains q [C, D] over data
// X [N, D], labels y [N] and weights w [N] it computes, without ever
// storing eta:
//
//   eta[c, n] = sum_d q[c, d] X[n, d]
//   t         = exp(-|eta|)                        (one t serves both uses)
//   logp[c]   = sum_n w (y eta - max(eta, 0) - log1p(t)) - s2/2 |q_c|^2
//   sig       = eta >= 0 ? 1/(1+t) : t/(1+t)
//   grad[c,:] = sum_n w (y - sig) X[n, :] - s2 q_c
//
// and maps a non-finite logp to -inf with a zero gradient (and zeroes any
// non-finite gradient component), as make_logistic_potential does.  One
// body, three forms of it (the template parameter FORM):
//
//  * kF32 (logistic_vg_launch, grad_bf16 = 0): both products in float32.
//  * kGradBf16 (logistic_vg_launch, grad_bf16 = 1;
//    make_logistic_potential(..., grad_bf16=True)): the residual
//    w (y - sig) and the X tile are rounded to bfloat16 (round to nearest
//    even) before the backward product, whose sum stays float32, as the
//    TPU kernel's astype does (_make_fused_kernel, `if grad_bf16:`): each
//    product of two bf16 values is exact in float32.  logp is not touched.
//  * kPacked (logistic_packed_launch, D <= 64;
//    make_logistic_potential(..., fwd_precision="packed")): the forward is
//    the packed split-bf16 product.  With bfloat16 halves a = a_hi + a_lo
//    (a_hi = a rounded to nearest even, a_lo = (a - a_hi) rounded; X's
//    halves given, q's split here, in registers),
//
//      eta = (sum_d q_hi x_hi + sum_d q_lo x_hi) + sum_d q_hi x_lo
//
//    the first two sums in one accumulator, as the TPU kernel sums them in
//    one MXU product ([q_hi | q_lo] . [x_hi | x_hi] over 128 lanes), the
//    third in a second one added after.  Each bf16 product is exact in
//    float32, so the result differs from the plain version
//    (ops/logistic.py::logistic_value_and_grad_packed_plain) only in the
//    order of the float32 sums.  The backward is the float32 one.
//
// Bound on an H100 SXM at C = 8192, N = 1e4, D = 50 (4 C N D = 16.4 GFLOP
// and 2 C N transcendentals per evaluation; the bytes, q, X, y, w in and
// logp, grad out, are about 5 MB, and X at 2 MB stays resident in the
// 50 MB L2, so the kernel is compute-bound):
//  * kF32: both products on the fp32 FMA pipe, 16.4 GFLOP / 67 TFLOP/s =
//    0.24 ms.
//  * kGradBf16 and kPacked: one product is a bf16 one that the tensor cores
//    could take (989 TFLOP/s: the backward's 8.2 GFLOP 0.008 ms, the packed
//    forward's three products 24.6 GFLOP 0.025 ms); the float32 product,
//    8.2 GFLOP, plus about 12 C N elementwise flops, 9.2 GFLOP at
//    67 TFLOP/s, 0.137 ms, sets the bound.
//
// The TPU kernel packs because D <= 64 pads to 128 MXU lanes, so the lo
// halves ride in lanes that are paid for anyway.  mma.sync.m16n8k16 pads the
// contraction only to 16: at D = 50 each product is 4 k-steps, the three
// products 12, the packed pair plus the third product also 12.  The packing
// buys nothing here; kPacked computes the same three products.
//
// Design (a simple, right kernel first; wgmma, TMA and a persistent grid
// are later work):
//  * Each block of 4 warps owns BC = 32 chains and walks the whole N axis
//    itself, in shared-memory tiles of BN = 64 observations, so every
//    chain's logp and gradient is summed by exactly one block in a fixed
//    order: deterministic, no atomics, no second pass.  (The TPU kernel
//    walks N as a sequential grid axis and accumulates across grid steps
//    instead.)
//  * No padding to 128 lanes: D stays D.  The gradient accumulators are
//    sized by a compile-time bound DP >= D (64, 128 or 256).
//  * The float32 forward gives each thread a 4 chains x 4 observations
//    micro-tile of eta in full-f32 FMA: eta is f32-grade without the TPU's
//    split-bf16 3-pass product.  The packed forward runs on the tensor cores
//    with mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: warp w owns
//    chains 16 (w & 1) .. + 15 (the A operand, split into bf16 halves once,
//    in registers, for the whole N loop) against observations
//    32 (w >> 1) .. + 31 in 4 fragments of 8 (the B operand, 32-bit loads
//    from row-major bf16 tiles whose row stride of 36 words keeps them
//    free of bank conflicts); the 4 fragments' products are all in flight
//    before their 16 residuals per thread are formed, as the float32
//    forward forms its 16 (one fragment at a time cost 12 % more).
//  * Either forward turns eta into logp partial sums (kept in registers for
//    the whole N loop; expf, log1pf and the division are the precise, non
//    fast-math versions) and a residual tile in shared memory; the backward
//    gives each thread 4 chains x DP/16 dims of the gradient, accumulated
//    in registers across all tiles.  The d-major X tile has a padded row
//    stride, so both float32 passes read it without bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Form { kF32, kGradBf16, kPacked };

constexpr int BC = 32;        // chains per block
constexpr int BN = 64;        // observations per shared-memory tile
constexpr int THREADS = 128;  // 4 warps: 8 chain quads x 16 lanes
constexpr int XS = BN + 1;    // padded row stride of the d-major X tile
constexpr int PACKED_DP = 64;          // the contraction kPacked holds
constexpr int XB = PACKED_DP + 8;      // row stride (bf16) of its X halves

// the residual tile's row stride: kPacked's fragments write it a chain at a
// time, and 4 words of padding spread those writes over all 32 banks
template <int FORM>
__host__ __device__ constexpr int rt_stride() {
  return FORM == kPacked ? BC + 4 : BC;
}

template <int DP, int FORM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (DP * BC + DP * XS + BN * rt_stride<FORM>() +
                          2 * BN + BC) +
         (FORM == kPacked
              ? sizeof(float) * 2 * BC + sizeof(uint16_t) * 2 * BN * XB
              : 0);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_index,
                                         __nv_bfloat16 hi_index) {
  return (uint32_t)__bfloat16_as_ushort(lo_index) |
         ((uint32_t)__bfloat16_as_ushort(hi_index) << 16);
}

// d += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

// chain c's logp from its summed terms: the prior, over the d-major tile
__device__ __forceinline__ float with_prior(float terms, const float* qT,
                                            int c, int D, float s2) {
  float qq = 0.f;
  for (int d = 0; d < D; ++d) qq = fmaf(qT[d * BC + c], qT[d * BC + c], qq);
  return terms - 0.5f * s2 * qq;
}

template <int DP, int FORM>
__global__ void __launch_bounds__(THREADS)
logistic_vg_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const uint16_t* __restrict__ x_hi,
                   const uint16_t* __restrict__ x_lo,
                   const float* __restrict__ y, const float* __restrict__ w,
                   float s2, float* __restrict__ logp,
                   float* __restrict__ grad, int64_t C, int64_t N, int D) {
  constexpr int RS = rt_stride<FORM>();
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [DP][BC] chain tile, d-major
  float* xT = qT + DP * BC;    // [DP][XS] observation tile, d-major
  float* rT = xT + DP * XS;    // [BN][RS] residual tile, n-major
  float* ys = rT + BN * RS;    // [BN]
  float* ws = ys + BN;         // [BN]
  float* lp = ws + BN;         // [BC] raw logp, for the gradient's guard
  float* lpart = lp + BC;      // kPacked: [2][BC] logp by observation half
  uint16_t* xh = reinterpret_cast<uint16_t*>(lpart + 2 * BC);  // [BN][XB]
  uint16_t* xl = xh + BN * XB;                                  // [BN][XB]

  constexpr int KD = DP / 16;  // gradient dims per thread
  constexpr int KSTEPS = DP / 16;
  const int tid = threadIdx.x;
  const int cq = tid >> 4;     // chains 4*cq .. 4*cq+3 in both passes
  const int ln = tid & 15;     // observations ln + 16 j; dims ln + 16 k
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row, column
  const int mt = warp & 1, nh = warp >> 1;  // kPacked: chain, obs. halves
  const int64_t c0 = (int64_t)blockIdx.x * BC;

  for (int i = tid; i < BC * DP; i += THREADS) {
    const int c = i / DP, d = i % DP;
    qT[d * BC + c] = (c0 + c < C && d < D) ? q[(c0 + c) * D + d] : 0.f;
  }

  // kPacked's A operands: q's bf16 halves for this warp's 16 chains
  constexpr int QK = FORM == kPacked ? KSTEPS : 1;
  uint32_t qh[QK][4], ql[QK][4];
  if constexpr (FORM == kPacked) {
    __syncthreads();
    const int r0 = 16 * mt + g, r1 = r0 + 8;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k0 = 16 * ks + 2 * t4;
      const int rows[4] = {r0, r1, r0, r1};
      const int cols[4] = {k0, k0, k0 + 8, k0 + 8};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat16 h[2], l[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = qT[(cols[j] + e) * BC + rows[j]];
          h[e] = __float2bfloat16_rn(v);
          l[e] = __float2bfloat16_rn(v - __bfloat162float(h[e]));
        }
        qh[ks][j] = pack(h[0], h[1]);
        ql[ks][j] = pack(l[0], l[1]);
      }
    }
  }
  const int nks = (D + 15) / 16;  // k-steps that hold a dimension

  float lacc[4] = {0.f, 0.f, 0.f, 0.f};
  float gacc[4][KD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KD; ++k) gacc[i][k] = 0.f;

  for (int64_t n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * DP; i += THREADS) {
      const int n = i / DP, d = i % DP;
      const bool in = n0 + n < N && d < D;
      xT[d * XS + n] = in ? x[(n0 + n) * D + d] : 0.f;
      if constexpr (FORM == kPacked) {
        xh[n * XB + d] = in ? x_hi[(n0 + n) * D + d] : (uint16_t)0;
        xl[n * XB + d] = in ? x_lo[(n0 + n) * D + d] : (uint16_t)0;
      }
    }
    if (tid < BN) {
      const bool in = n0 + tid < N;  // padded rows weigh nothing
      ys[tid] = in ? y[n0 + tid] : 0.f;
      ws[tid] = in ? w[n0 + tid] : 0.f;
    }
    __syncthreads();

    if constexpr (FORM == kPacked) {
      // forward on the tensor cores: this warp's 4 fragments of 8
      // observations, all in flight, then their 16 residuals per thread
      float acc[4][4], acl[4][4];  // q_hi x_hi + q_lo x_hi; q_hi x_lo
#pragma unroll
      for (int fi = 0; fi < 4; ++fi)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[fi][j] = acl[fi][j] = 0.f;
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        const int row = (8 * (4 * nh + fi) + g) * XB + 2 * t4;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          if (ks < nks) {  // the same on every lane: a uniform branch
            const int o = row + 16 * ks;
            const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(&xh[o]);
            const uint32_t bh1 =
                *reinterpret_cast<const uint32_t*>(&xh[o + 8]);
            const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(&xl[o]);
            const uint32_t bl1 =
                *reinterpret_cast<const uint32_t*>(&xl[o + 8]);
            mma_bf16(acc[fi], qh[ks], bh0, bh1);
            mma_bf16(acc[fi], ql[ks], bh0, bh1);
            mma_bf16(acl[fi], qh[ks], bl0, bl1);
          }
        }
      }
      // acc[fi][j]: chain 16 mt + g + 8 (j >> 1), observation
      // 8 (4 nh + fi) + 2 t4 + (j & 1)
#pragma unroll
      for (int fi = 0; fi < 4; ++fi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 16 * mt + g + 8 * (j >> 1);
          const int n = 8 * (4 * nh + fi) + 2 * t4 + (j & 1);
          rT[n * RS + c] = obs_term(acc[fi][j] + acl[fi][j], ys[n], ws[n],
                                    lacc[j >> 1]);
        }
    } else {
      // forward in float32: eta for 4 chains x 4 observations
      float eta[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) eta[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qT[d * BC + 4 * cq]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = xT[d * XS + ln + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) eta[i][j] = fmaf(qa[i], xv, eta[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = ln + 16 * j;
        const float yv = ys[n], wv = ws[n];
        float r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r[i] = obs_term(eta[i][j], yv, wv, lacc[i]);
          if (FORM == kGradBf16) r[i] = bf16_round(r[i]);
        }
        *reinterpret_cast<float4*>(&rT[n * RS + 4 * cq]) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    }
    __syncthreads();
    if (FORM == kGradBf16) {
      // the forward is done with the float32 tile: round it in place
      for (int i = tid; i < DP * XS; i += THREADS) xT[i] = bf16_round(xT[i]);
      __syncthreads();
    }

    // backward: grad += resid X for 4 chains x KD dims
    for (int n = 0; n < BN; ++n) {
      const float4 rv = *reinterpret_cast<const float4*>(&rT[n * RS + 4 * cq]);
      const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float xv = xT[(ln + 16 * k) * XS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[i][k] = fmaf(ra[i], xv, gacc[i][k]);
      }
    }
  }

  // logp: sum the lanes that share a chain, add the prior, guard
  if constexpr (FORM == kPacked) {
    // the 4 lanes of a quad (one row of the mma fragments), then the two
    // warps that hold a chain's two observation halves
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        lacc[i] += __shfl_xor_sync(0xffffffffu, lacc[i], off);
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lpart[nh * BC + 16 * mt + g + 8 * i] = lacc[i];
    }
    __syncthreads();
    if (tid < BC)
      lp[tid] = with_prior(lpart[tid] + lpart[BC + tid], qT, tid, D, s2);
  } else {
    // the 16 lanes that share a chain quad (one half-warp)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lacc[i] += __shfl_xor_sync(0xffffffffu, lacc[i], off);
    if (ln == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lp[4 * cq + i] = with_prior(lacc[i], qT, 4 * cq + i, D, s2);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * cq + i;
    if (c0 + c >= C) continue;
    const bool ok = isfinite(lp[c]);
    if (ln == 0) logp[c0 + c] = ok ? lp[c] : -INFINITY;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int d = ln + 16 * k;
      if (d < D) {
        const float gv = gacc[i][k] - s2 * qT[d * BC + c];
        grad[(c0 + c) * D + d] = (ok && isfinite(gv)) ? gv : 0.f;
      }
    }
  }
}

template <int DP, int FORM>
cudaError_t launch(const float* q, const float* x, const uint16_t* x_hi,
                   const uint16_t* x_lo, const float* y, const float* w,
                   float s2, float* logp, float* grad, int64_t C, int64_t N,
                   int D, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DP, FORM>();
  cudaError_t err = cudaFuncSetAttribute(
      logistic_vg_kernel<DP, FORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (C + BC - 1) / BC;
  logistic_vg_kernel<DP, FORM><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      q, x, x_hi, x_lo, y, w, s2, logp, grad, C, N, D);
  return cudaGetLastError();
}

// the float32-forward instantiation whose register tiles take D
template <int FORM>
cudaError_t launch_dim(const float* q, const float* x, const float* y,
                       const float* w, float s2, float* logp, float* grad,
                       int64_t C, int64_t N, int D, cudaStream_t s) {
  if (D <= 64)
    return launch<64, FORM>(q, x, nullptr, nullptr, y, w, s2, logp, grad, C,
                            N, D, s);
  if (D <= 128)
    return launch<128, FORM>(q, x, nullptr, nullptr, y, w, s2, logp, grad, C,
                             N, D, s);
  if (D <= 256)
    return launch<256, FORM>(q, x, nullptr, nullptr, y, w, s2, logp, grad, C,
                             N, D, s);
  return cudaErrorInvalidValue;
}

// the checks both launchers make: the error already pending, or
// cudaErrorInvalidValue for what the kernel cannot take
int refuse(int64_t C, int64_t N, int D, int max_dim) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || N < 0 || D < 1 || D > max_dim ||
      (C + BC - 1) / BC > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous float32: q [C, D], x [N, D],
// y [N], w [N], logp [C], grad [C, D].  D must be in [1, 256]; grad_bf16
// (0 or 1) rounds the backward product's inputs to bfloat16.
extern "C" int logistic_vg_launch(const float* q, const float* x,
                                  const float* y, const float* w, float s2,
                                  float* logp, float* grad, int64_t C,
                                  int64_t N, int D, int grad_bf16,
                                  void* stream) {
  if (int rc = refuse(C, N, D, 256)) return rc;
  if (C == 0) return 0;  // nothing to launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(grad_bf16
                   ? launch_dim<kGradBf16>(q, x, y, w, s2, logp, grad, C, N,
                                           D, s)
                   : launch_dim<kF32>(q, x, y, w, s2, logp, grad, C, N, D,
                                      s));
}

// The packed split-bf16 forward (K2).  Pointers are device pointers to
// contiguous arrays: q [C, D] float32, x_hi, x_lo [N, D] bfloat16 (as 16-bit
// words), x [N, D], y [N], w [N] float32; outputs logp [C], grad [C, D]
// float32.  D must be in [1, 64].
extern "C" int logistic_packed_launch(const float* q, const uint16_t* x_hi,
                                      const uint16_t* x_lo, const float* x,
                                      const float* y, const float* w,
                                      float s2, float* logp, float* grad,
                                      int64_t C, int64_t N, int D,
                                      void* stream) {
  if (int rc = refuse(C, N, D, PACKED_DP)) return rc;
  if (C == 0) return 0;  // nothing to launch
  return (int)launch<PACKED_DP, kPacked>(q, x, x_hi, x_lo, y, w, s2, logp,
                                         grad, C, N, D,
                                         static_cast<cudaStream_t>(stream));
}
