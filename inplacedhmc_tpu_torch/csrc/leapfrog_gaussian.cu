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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // chain rows per block
constexpr int THREADS = 32 * WARPS;

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
    const float p_mid =
        __fsub_rn(p[row + d], __fmul_rn(half, __fmul_rn(l, q[row + d])));
    const float qn = __fadd_rn(q[row + d], __fmul_rn(e, __fmul_rn(m, p_mid)));
    const float lq = __fmul_rn(l, qn);
    const float g = -lq;
    const float pn = __fadd_rn(p_mid, __fmul_rn(half, g));
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
