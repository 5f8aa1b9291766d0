// K5 with Neal's funnel's tile physics (BASELINE config 2): the body of
// tree_kernel.cuh with the hand-written value and gradient of
// inplacedhmc_tpu/models/funnel.py::_make_tile_logp, which the TPU kernel
// differentiates with jax.vjp (tree_pallas.py:899-912).  Its plain version
// is ops/tile_physics.py::funnel, the same operations in the same order
// except the row sum.
//
// Lanes [v, x_1..x_{D-1}]; data row x_mask (1 on the x lanes), scalars
// k = D - 1 and inv_s2 = 1 / scale^2.  With S = sum x_i^2 and e = exp(-v):
//   logp = -0.5 (inv_s2 v^2 + S e + k v)
//   d/dv = 0.5 S e - inv_s2 v - 0.5 k
//   d/dx_i = -e x_i
// v comes to every lane from lane 0 (one broadcast), S is one warp sum.  A
// non-finite e (v below about -88) makes the leaf's log density or
// gradient non-finite, which the leaf's sanitisation turns into a
// divergence, as in the TPU kernel (tree_pallas.py:271-293).  Per leaf
// about 3 flops per x lane, one warp sum of 5 shuffles and one exponential.

#include "tree_kernel.cuh"

namespace tree {

template <int NV>
struct Funnel {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  static constexpr bool kStaging = true;  // products staged (kStagedOf)
  static constexpr bool kWide = false;  // D <= 256 only
  bool xm[NV];
  float kf, inv_s2;

  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&in)[NV],
                                       const Warp& t) {
    const int lane = t.lane;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      xm[k] = in[k] && pd.row[0][lane + 32 * k] != 0.f;
    kf = pd.scalar[0];
    inv_s2 = pd.scalar[1];
  }

  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV],
                                              const Warp& t) const {
    const int lane = t.lane;
    const float v = __shfl_sync(FULL, q[0], 0);
    const float e = expf(-v);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (xm[k]) s = add(s, mul(q[k], q[k]));
    s = warp_sum(s);
#pragma unroll
    for (int k = 0; k < NV; ++k) g[k] = xm[k] ? -mul(e, q[k]) : 0.f;
    if (lane == 0)
      g[0] = sub(sub(mul(0.5f, mul(s, e)), mul(inv_s2, v)), mul(0.5f, kf));
    return mul(-0.5f,
               add(add(mul(mul(inv_s2, v), v), mul(s, e)), mul(kf, v)));
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// the funnel: row0 x_mask [D]; s0 k, s1 inv_s2; row1, row2, mat are not
// read.
TREE_LAUNCHERS(funnel, tree::Funnel)
