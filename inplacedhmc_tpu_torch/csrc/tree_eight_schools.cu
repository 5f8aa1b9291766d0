// K5 with eight schools' tile physics (BASELINE config 4): the body of
// tree_kernel.cuh with the hand-written value and gradient of
// inplacedhmc_tpu/models/eight_schools.py::_tile_logp, which the TPU kernel
// differentiates with jax.vjp (tree_pallas.py:899-912).  Its plain version
// is ops/tile_physics.py::eight_schools, the same operations in the same
// order except the row sums.
//
// Lanes [mu, log_tau, z_1..z_8]; data rows y, sig, obs_mask (1 on the z
// lanes).  With r_j = (y_j - mu - tau z_j) / sig_j:
//   logp = -0.5 (mu/10)^2 - softplus(2 (log_tau - log 5)) + log_tau
//          - 0.5 sum (z_j^2 + r_j^2)
//   d/dz_j = tau r_j / sig_j - z_j
//   d/dmu = sum r_j / sig_j - (mu/10)/10
//   d/dlog_tau = 1 - 2 sigmoid(2 (log_tau - log 5)) + tau sum z_j r_j / sig_j
// mu and log_tau come to every lane from lanes 0 and 1 (two broadcasts);
// the log density and the two sums of the gradient's first entries are
// three warp sums.  Per leaf about 10 flops per z lane, 3 warp sums of 5
// shuffles, and 3 exponentials and a log1p (the SFU's).

#include "tree_kernel.cuh"

namespace tree {

constexpr float LOG5_F32 = 1.6094379425048828f;  // float32(log 5)

template <int NV>
struct EightSchools {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 2;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  // the dense launcher keeps M^-1 on the register path (kStagedOf): at
  // D = 10 the leaf's special functions set the time, the 400-byte matrix
  // sits in L1, and the staged instantiation's registers cost more than
  // shared memory saves (measured 3 % slower)
  static constexpr bool kStaging = false;
  static constexpr bool kWide = false;  // D <= 256 only
  float y[NV], sig[NV];
  bool obs[NV];

  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&in)[NV],
                                       const Warp& t) {
    const int lane = t.lane;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = lane + 32 * k;
      obs[k] = in[k] && pd.row[2][d] != 0.f;
      y[k] = obs[k] ? pd.row[0][d] : 0.f;
      sig[k] = obs[k] ? pd.row[1][d] : 1.f;
    }
  }

  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV],
                                              const Warp& t) const {
    const int lane = t.lane;
    const float mu = __shfl_sync(FULL, q[0], 0);
    const float log_tau = __shfl_sync(FULL, q[0], 1);
    const float tau = expf(log_tau);
    float ss = 0.f, sr = 0.f, szr = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float gk = 0.f;
      if (obs[k]) {
        const float z = q[k];
        const float r = fdiv(sub(y[k], add(mu, mul(tau, z))), sig[k]);
        const float rs = fdiv(r, sig[k]);
        ss = add(ss, add(mul(z, z), mul(r, r)));
        sr = add(sr, rs);
        szr = add(szr, mul(z, rs));
        gk = sub(mul(tau, rs), z);
      }
      g[k] = gk;
    }
    ss = warp_sum(ss);
    sr = warp_sum(sr);
    szr = warp_sum(szr);
    const float mu10 = fdiv(mu, 10.f);
    const float x = mul(2.f, sub(log_tau, LOG5_F32));
    // logaddexp(0, x) as JAX computes it; its derivative 2 sigmoid(x)
    const float softplus = add(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
    const float sigmoid = fdiv(1.f, add(1.f, expf(-x)));
    if (lane == 0) g[0] = sub(sr, fdiv(mu10, 10.f));
    if (lane == 1) g[0] = add(sub(1.f, mul(2.f, sigmoid)), mul(tau, szr));
    return sub(add(sub(mul(-0.5f, mul(mu10, mu10)), softplus), log_tau),
               mul(0.5f, ss));
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// eight schools: row0 y, row1 sig, row2 obs_mask [D]; mat, s0, s1 are not
// read.  D >= 2.
TREE_LAUNCHERS(eight_schools, tree::EightSchools)
