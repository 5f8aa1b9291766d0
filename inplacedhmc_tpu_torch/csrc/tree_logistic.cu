// K5 with Bayesian logistic regression's tile physics (BASELINE config 3):
// the body of tree_kernel.cuh with the hand-written value and gradient of
// the TPU kernel's logistic physics, the chunked tile_vg of
// inplacedhmc_tpu/ops/tree_pallas.py:1242-1275 (built by
// make_logistic_tree_transition, :1159; its vjp form, :1202-1223, computes
// the same function).  Its plain version is ops/tile_physics.py::logistic:
//   eta  = q x^T                                   (f32)
//   t    = exp(-|eta|)                             (one t for both uses)
//   logp = -0.5 inv_var |q|^2 + sum_n w (y eta - (max(eta, 0) + log1p(t)))
//   sig  = eta >= 0 ? 1 / (1 + t) : t / (1 + t)
//   grad = -inv_var q + sum_n (y - sig) w x_n
// over the observation-major x [n_obs, D] (zero rows past the data), the
// labels y and the weights w [n_obs] (0 on the padding: a padded row gives
// eta = 0, a finite ll and sigmoid, and w = 0 makes its terms exactly 0).
// Under grad_bf16 (scalar s1 != 0) the residual and x are rounded to
// bfloat16 (round to nearest even) before the backward product, whose
// terms are then exact in f32 and summed in f32; eta, logp and the
// energies are never rounded (ROADMAP's exactness classes).  A logistic
// density that overflows (eta infinite or NaN) makes logp or the gradient
// non-finite, which the leaf's sanitisation turns into a divergence.
//
// Layout.  One warp per chain, lanes over features as the tree body holds
// q and g (lane l has features l + 32 k).  Per step of J = 8 observations
// each lane loads its features of the 8 rows of x (coalesced rows of the
// obs-major matrix, JAX's xobs layout, kept in registers), forms 8 partial
// dot products, and a reduce-scatter (shuffles xor 16, 8, 4 halve the
// values, xor 2 and 1 finish one sum: 9 shuffles, against 40 for 8 warp
// sums) leaves lanes 4j..4j+3 with eta of observation j, the same value on
// each.  Each group of four computes t, ll, the sigmoid and the residual
// of its observation (four times the special functions, cheaper than 8
// more shuffles); lane 4j alone adds its w ll to the log density.  Eight
// broadcasts of the residuals feed the backward product on the rows still
// in registers.  So x is read once per evaluation, from L2 (2 MB at
// 10,000 x 50: resident in the 50 MB L2 across a launch), with no shared
// memory and no scratch.  The two layouts the design notes weighed: lanes
// over observations (x feature-major) would keep D gradient partials per
// lane, in registers past the 128 cap or as a shared slab read and written
// per feature and observation; two passes would read both layouts of x and
// keep the residuals in scratch.  The sums (eta, the log density and the
// gradient) are taken in another order than the plain version's, with
// fused multiply-adds; the elementwise operations of each observation are
// the plain version's, each rounded on its own.
//
// Bound on an H100 SXM: each evaluation does 4 N D flops of products (16.4
// GFLOP per evaluation of 8192 chains at N = 1e4, D = 50) and 2 N special
// functions (exp, log1p), at 67 TFLOP/s fp32: operations, against x read
// once per launch.  What it reaches instead is L2: every chain streams all
// of x at every leaf (2 MB; on the order of 130 GB per launch of 8192
// chains at eight leaves each), since one warp per chain shares no slice
// of x with its neighbours.  A block of chains walking their leaves in
// step over slices of x staged in shared memory (the TPU kernel's chain
// tile), and bf16 or split-bf16 tensor-core products, are later work.

#include <cuda_bf16.h>

#include "tree_kernel.cuh"

namespace tree {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int NV>
struct Logistic {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  // the dense launcher keeps M^-1 on the register path (kStagedOf): the
  // leaf streams the observations from L2, and the staged matrix's shared
  // memory is taken from the L1 that serves them (measured 0.5 % slower)
  static constexpr bool kStaging = false;
  static constexpr bool kWide = false;  // D <= 256 only (the reduce-scatter)
  static constexpr int J = 8;  // observations per step
  const float* x;              // [n_obs, D]
  const float* y;              // [n_obs]
  const float* w;              // [n_obs]
  int64_t n_obs;
  int D;
  float inv_var;
  bool bf16;

  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&)[NV], const Warp&) {
    x = pd.obs_mat;
    y = pd.obs_row[0];
    w = pd.obs_row[1];
    n_obs = pd.n_obs;
    D = pd.D;
    inv_var = pd.scalar[0];
    bf16 = pd.scalar[1] != 0.f;
  }

  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV],
                                              const Warp& t) const {
    const int lane = t.lane;
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.f;
    float lp = 0.f;            // this lane's share of sum_n w ll
    const int jl = lane >> 2;  // the observation of a step this lane finishes
#pragma unroll 1
    for (int64_t n0 = 0; n0 < n_obs; n0 += J) {
      float xv[J][NV], p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool row_in = n0 + j < n_obs;
        const float* row = x + (n0 + j) * D + lane;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          xv[j][k] = (row_in && lane + 32 * k < D) ? __ldg(row + 32 * k) : 0.f;
          s = fmaf(q[k], xv[j][k], s);
        }
        p[j] = s;
      }
      // reduce-scatter: lanes 4j..4j+3 end with eta of observation j
      const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float send = h4 ? p[i] : p[i + 4];
        p[i] = add(h4 ? p[i + 4] : p[i], __shfl_xor_sync(FULL, send, 16));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float send = h3 ? p[i] : p[i + 2];
        p[i] = add(h3 ? p[i + 2] : p[i], __shfl_xor_sync(FULL, send, 8));
      }
      float eta = add(h2 ? p[1] : p[0],
                      __shfl_xor_sync(FULL, h2 ? p[0] : p[1], 4));
      eta = add(eta, __shfl_xor_sync(FULL, eta, 2));
      eta = add(eta, __shfl_xor_sync(FULL, eta, 1));

      const bool obs_in = n0 + jl < n_obs;
      const float yv = obs_in ? __ldg(y + n0 + jl) : 0.f;
      const float wv = obs_in ? __ldg(w + n0 + jl) : 0.f;
      const float t = expf(-fabsf(eta));
      const float ll = sub(mul(yv, eta), add(fmaxf(eta, 0.f), log1pf(t)));
      if ((lane & 3) == 0) lp = add(lp, mul(ll, wv));
      const float inv1pt = fdiv(1.f, add(1.f, t));
      const float sig = eta >= 0.f ? inv1pt : mul(t, inv1pt);
      float r = mul(sub(yv, sig), wv);
      if (bf16) {  // the same on every lane: a uniform branch
        r = bf16_round(r);
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int k = 0; k < NV; ++k) xv[j][k] = bf16_round(xv[j][k]);
      }
      // backward: g += r_j x_j, r_j broadcast from lane 4j
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float rj = __shfl_sync(FULL, r, 4 * j);
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[k] = fmaf(rj, xv[j][k], acc[k]);
      }
    }
    float qq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      qq = add(qq, mul(q[k], q[k]));
      g[k] = lane + 32 * k < D ? add(mul(-inv_var, q[k]), acc[k]) : 0.f;
    }
    return add(mul(mul(-0.5f, inv_var), warp_sum(qq)), warp_sum(lp));
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// logistic regression: obs_mat x [n_obs, D], obs_row0 y and obs_row1 w
// [n_obs]; s0 inv_var, s1 grad_bf16 (0 or 1); row0..row2 and mat are not
// read.  Any n_obs >= 0 (a ragged last step reads no row past it).
TREE_LAUNCHERS(logistic, tree::Logistic)
