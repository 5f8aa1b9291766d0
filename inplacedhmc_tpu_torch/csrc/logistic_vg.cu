// Fused logistic-regression log density and gradient for a batch of chains.
//
// Replaces the TPU kernel inplacedhmc_tpu/ops/logistic_pallas.py::
// _make_fused_kernel (launched by _logistic_value_and_grad_padded, built by
// make_logistic_potential).  For chains q [C, D] over data X [N, D], labels
// y [N] and weights w [N] it computes, without ever storing eta:
//
//   eta[c, n] = sum_d q[c, d] X[n, d]
//   t         = exp(-|eta|)                        (one t serves both uses)
//   logp[c]   = sum_n w (y eta - max(eta, 0) - log1p(t)) - s2/2 |q_c|^2
//   sig       = eta >= 0 ? 1/(1+t) : t/(1+t)
//   grad[c,:] = sum_n w (y - sig) X[n, :] - s2 q_c
//
// and maps a non-finite logp to -inf with a zero gradient (and zeroes any
// non-finite gradient component), as make_logistic_potential does.
//
// Bound on an H100 SXM: the two contractions take 4 C N D flops, 16.4 GFLOP
// per evaluation at C = 8192, N = 1e4, D = 50, plus 2 C N transcendentals.
// The bytes are small (q, X, y, w in and logp, grad out: about 5 MB, and X
// at 2 MB stays resident in the 50 MB L2), so the kernel is compute-bound on
// fp32 FMA: 16.4 GFLOP / 67 TFLOP/s = 0.24 ms.
//
// Design (a simple, right kernel first; tensor cores, TMA and wgmma are
// later work):
//  * Each block owns BC = 32 chains and walks the whole N axis itself, in
//    shared-memory tiles of BN = 64 observations, so every chain's logp and
//    gradient is summed by exactly one block in a fixed order: deterministic,
//    no atomics, no second pass.  (The TPU kernel walks N as a sequential
//    grid axis and accumulates across grid steps instead.)
//  * No padding to 128 lanes: D stays D.  The gradient accumulators are
//    sized by a compile-time bound DP >= D (64, 128 or 256).
//  * Full-f32 FMA for both contractions: eta is f32-grade without the TPU's
//    split-bf16 3-pass product.  expf, log1pf and the division are the
//    precise (non fast-math) versions.
//  * Per tile: the forward gives each thread a 4 chains x 4 observations
//    micro-tile of eta, turned into logp partial sums (kept in registers for
//    the whole N loop) and a residual tile in shared memory; the backward
//    gives each thread 4 chains x DP/16 dims of the gradient, accumulated in
//    registers across all tiles.  The d-major X tile has a padded row
//    stride, so both passes read it without bank conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BC = 32;        // chains per block
constexpr int BN = 64;        // observations per shared-memory tile
constexpr int THREADS = 128;  // 4 warps: 8 chain quads x 16 lanes
constexpr int XS = BN + 1;    // padded row stride of the d-major X tile

template <int DP>
constexpr size_t smem_floats() {
  return DP * BC + DP * XS + BN * BC + 2 * BN + BC;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
logistic_vg_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const float* __restrict__ y, const float* __restrict__ w,
                   float s2, float* __restrict__ logp,
                   float* __restrict__ grad, int64_t C, int64_t N, int D) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [DP][BC] chain tile, d-major
  float* xT = qT + DP * BC;    // [DP][XS] observation tile, d-major
  float* rT = xT + DP * XS;    // [BN][BC] residual tile, n-major
  float* ys = rT + BN * BC;    // [BN]
  float* ws = ys + BN;         // [BN]
  float* lp = ws + BN;         // [BC] raw logp, for the gradient's guard

  constexpr int KD = DP / 16;  // gradient dims per thread
  const int tid = threadIdx.x;
  const int cq = tid >> 4;     // chains 4*cq .. 4*cq+3 in both passes
  const int ln = tid & 15;     // observations ln + 16 j; dims ln + 16 k
  const int64_t c0 = (int64_t)blockIdx.x * BC;

  for (int i = tid; i < BC * DP; i += THREADS) {
    const int c = i / DP, d = i % DP;
    qT[d * BC + c] = (c0 + c < C && d < D) ? q[(c0 + c) * D + d] : 0.f;
  }

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
      xT[d * XS + n] = (n0 + n < N && d < D) ? x[(n0 + n) * D + d] : 0.f;
    }
    if (tid < BN) {
      const bool in = n0 + tid < N;  // padded rows weigh nothing
      ys[tid] = in ? y[n0 + tid] : 0.f;
      ws[tid] = in ? w[n0 + tid] : 0.f;
    }
    __syncthreads();

    // forward: eta for 4 chains x 4 observations
    float eta[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) eta[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * BC + 4 * cq]);
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
        const float e = eta[i][j];
        const float t = expf(-fabsf(e));
        lacc[i] = fmaf(wv, yv * e - (fmaxf(e, 0.f) + log1pf(t)), lacc[i]);
        const float inv1pt = 1.f / (1.f + t);
        r[i] = (yv - (e >= 0.f ? inv1pt : t * inv1pt)) * wv;
      }
      *reinterpret_cast<float4*>(&rT[n * BC + 4 * cq]) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();

    // backward: grad += resid X for 4 chains x KD dims
    for (int n = 0; n < BN; ++n) {
      const float4 rv = *reinterpret_cast<const float4*>(&rT[n * BC + 4 * cq]);
      const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float xv = xT[(ln + 16 * k) * XS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[i][k] = fmaf(ra[i], xv, gacc[i][k]);
      }
    }
  }

  // logp: sum the 16 lanes that share a chain quad (one half-warp), add the
  // prior, guard
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lacc[i] += __shfl_xor_sync(0xffffffffu, lacc[i], off);
  if (ln == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * cq + i;
      float qq = 0.f;
      for (int d = 0; d < D; ++d) qq = fmaf(qT[d * BC + c], qT[d * BC + c], qq);
      lp[c] = lacc[i] - 0.5f * s2 * qq;
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
        const float g = gacc[i][k] - s2 * qT[d * BC + c];
        grad[(c0 + c) * D + d] = (ok && isfinite(g)) ? g : 0.f;
      }
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* x, const float* y,
                   const float* w, float s2, float* logp, float* grad,
                   int64_t C, int64_t N, int D, cudaStream_t stream) {
  const size_t bytes = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logistic_vg_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (C + BC - 1) / BC;
  logistic_vg_kernel<DP><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      q, x, y, w, s2, logp, grad, C, N, D);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous float32: q [C, D], x [N, D],
// y [N], w [N], logp [C], grad [C, D].  D must be in [1, 256].
extern "C" int logistic_vg_launch(const float* q, const float* x,
                                  const float* y, const float* w, float s2,
                                  float* logp, float* grad, int64_t C,
                                  int64_t N, int D, void* stream) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || N < 0 || D < 1 || (C + BC - 1) / BC > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)launch<64>(q, x, y, w, s2, logp, grad, C, N, D, s);
  if (D <= 128) return (int)launch<128>(q, x, y, w, s2, logp, grad, C, N, D, s);
  if (D <= 256) return (int)launch<256>(q, x, y, w, s2, logp, grad, C, N, D, s);
  return (int)cudaErrorInvalidValue;
}
