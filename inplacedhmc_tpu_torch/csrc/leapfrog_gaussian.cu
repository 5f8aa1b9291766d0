// One fused velocity-Verlet step for targets with grad = -Lambda q and a
// diagonal inverse metric Minv, for a batch of chains.
//
// Replaces the TPU kernel inplacedhmc_tpu/ops/leapfrog_pallas.py::_kernel
// (launched by _fused_leapfrog_padded, built by make_fused_gaussian_leapfrog).
// For chains q, p [C, D] and a signed step eps [C] it computes
//
//   p_mid = p - (eps/2) (Lambda q)
//   q'    = q + eps (Minv p_mid)
//   grad' = -(Lambda q')
//   p'    = p_mid + (eps/2) grad'
//   p#'   = Minv p'
//   logp' = -1/2 sum_d (Lambda q') q'
//   kin'  = 1/2 sum_d p' p#'
//
// with the operations in the order of the TPU kernel and of the plain torch
// version (ops/leapfrog.py), each rounded on its own (__fmul_rn and
// __fadd_rn keep nvcc from contracting them into FMAs), so the elementwise
// outputs equal the plain version's bit for bit; only the two row sums are
// taken in another order.
//
// Bound on an H100 SXM: two [C, D] reads and four [C, D] writes, 6 C D 4
// bytes (the TPU kernel's own cost estimate), 24.6 MB at C = 10,240,
// D = 100, so 7.3 us at 3.35 TB/s; about 12 flops per element is far below
// the fp32 rate.  The kernel is a bandwidth pass.
//
// Design (simple first): one warp per chain row, lanes striding over D, so
// each of the six arrays is read or written in coalesced 128-byte runs; the
// two row sums are a fixed-order per-lane sum followed by a butterfly
// shuffle, so they are deterministic and every lane holds the same value.
// D has no compile-time bound.
//
// The second launcher, leapfrog_multistep_launch, replaces the TPU kernel
// inplacedhmc_tpu/ops/leapfrog_pallas.py::_multi_step_kernel (launched by
// multi_step_leapfrog): k_steps dependent steps with q and p held on chip,
// writing q' and p' only (no gradient, p# or row sums), for the roofline
// harness tools/roofline_torch.py.  Every step is verlet_step, the
// arithmetic of the single step above, so k of its steps round exactly as k
// launches of leapfrog_gaussian_launch do; the TPU kernel's
// p' = p_mid - (eps/2) (Lambda q') is the same number as
// p_mid + (eps/2) (-(Lambda q')), since IEEE negation is exact.
//
// Its bound on an H100 SXM at C = 10,240, D = 100, k = 64: 8 C D k =
// 524 MFLOP (the TPU kernel's cost estimate) at 67 TFLOP/s, 7.8 us, above
// the 16.4 MB of q, p in and q', p' out at 3.35 TB/s, 4.9 us.  Without
// FMA contraction each step is 9 float32 instructions, not 4 FMAs, so the
// instruction rate allows about 2.2 times that bound.
//
// Design (simple first): one thread per (chain, coordinate), q and p in
// registers for all k steps, eps, Lambda and Minv read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // chain rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int MULTISTEP_THREADS = 256;

// one velocity-Verlet step of one coordinate, each operation rounded on its
// own: q, p in; q', p' and Lambda q' out
__device__ __forceinline__ void verlet_step(float& q, float& p, float& lq,
                                            float e, float half, float l,
                                            float m) {
  const float p_mid = __fsub_rn(p, __fmul_rn(half, __fmul_rn(l, q)));
  q = __fadd_rn(q, __fmul_rn(e, __fmul_rn(m, p_mid)));
  lq = __fmul_rn(l, q);
  p = __fadd_rn(p_mid, __fmul_rn(half, -lq));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(THREADS)
leapfrog_gaussian_kernel(const float* __restrict__ q,
                         const float* __restrict__ p,
                         const float* __restrict__ eps,
                         const float* __restrict__ lam,
                         const float* __restrict__ minv,
                         float* __restrict__ q_out, float* __restrict__ p_out,
                         float* __restrict__ g_out, float* __restrict__ ps_out,
                         float* __restrict__ logp_out,
                         float* __restrict__ kin_out, int64_t C, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp leaves together
  const float e = eps[c];
  const float half = __fmul_rn(0.5f, e);
  const int64_t row = c * D;
  float lp = 0.f, kin = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float l = lam[d], m = minv[d];
    float qn = q[row + d], pn = p[row + d], lq;
    verlet_step(qn, pn, lq, e, half, l, m);
    const float g = -lq;
    const float ps = __fmul_rn(m, pn);
    q_out[row + d] = qn;
    p_out[row + d] = pn;
    g_out[row + d] = g;
    ps_out[row + d] = ps;
    lp = __fadd_rn(lp, __fmul_rn(lq, qn));
    kin = __fadd_rn(kin, __fmul_rn(pn, ps));
  }
  lp = warp_sum(lp);
  kin = warp_sum(kin);
  if (lane == 0) {
    logp_out[c] = __fmul_rn(-0.5f, lp);
    kin_out[c] = __fmul_rn(0.5f, kin);
  }
}

__global__ void __launch_bounds__(MULTISTEP_THREADS)
leapfrog_multistep_kernel(const float* __restrict__ q,
                          const float* __restrict__ p,
                          const float* __restrict__ eps,
                          const float* __restrict__ lam,
                          const float* __restrict__ minv,
                          float* __restrict__ q_out,
                          float* __restrict__ p_out, int64_t C, int D,
                          int k_steps) {
  const int64_t i = (int64_t)blockIdx.x * MULTISTEP_THREADS + threadIdx.x;
  if (i >= C * D) return;
  const int64_t c = i / D;
  const int d = (int)(i - c * D);
  const float e = eps[c];
  const float half = __fmul_rn(0.5f, e);
  const float l = lam[d], m = minv[d];
  float qv = q[i], pv = p[i], lq;
  for (int s = 0; s < k_steps; ++s) verlet_step(qv, pv, lq, e, half, l, m);
  q_out[i] = qv;
  p_out[i] = pv;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous float32: q, p [C, D], eps [C],
// lam, minv [D]; outputs q', p', grad', p#' [C, D], logp', kin' [C].
extern "C" int leapfrog_gaussian_launch(
    const float* q, const float* p, const float* eps, const float* lam,
    const float* minv, float* q_out, float* p_out, float* g_out,
    float* ps_out, float* logp_out, float* kin_out, int64_t C, int D,
    void* stream) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || D < 1 || (C + WARPS - 1) / WARPS > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C + WARPS - 1) / WARPS;
  leapfrog_gaussian_kernel<<<(unsigned)blocks, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, p, eps, lam, minv, q_out, p_out, g_out, ps_out, logp_out, kin_out, C,
      D);
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous float32: q, p [C, D], eps [C],
// lam, minv [D]; outputs q', p' [C, D] after k_steps >= 1 steps.
extern "C" int leapfrog_multistep_launch(
    const float* q, const float* p, const float* eps, const float* lam,
    const float* minv, float* q_out, float* p_out, int64_t C, int D,
    int k_steps, void* stream) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || D < 1 || k_steps < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C * D + MULTISTEP_THREADS - 1) / MULTISTEP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  leapfrog_multistep_kernel<<<(unsigned)blocks, MULTISTEP_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q, p, eps, lam, minv, q_out, p_out, C, D, k_steps);
  return (int)cudaGetLastError();
}
