// K5 with the dense Gaussian's tile physics (mvn models, grad = -(q P) with
// a symmetric [D, D] precision P): the body of tree_kernel.cuh with the
// value and gradient of the TPU kernel's _dense_gaussian_tile_vg
// (inplacedhmc_tpu/ops/tree_pallas.py:1118-1123, built by
// make_dense_gaussian_tree_transition, :1126).  Its plain version is
// ops/tile_physics.py::dense_gaussian:
//   g = -(q P),  logp = 0.5 sum g q
// P q is one team mat-vec (tree_kernel.cuh's Warp::matvec, Block::matvec
// in the wide form above D = 256; P is symmetric, so row i of P is its
// column i), the log density one team sum of the same product's terms.
// Per leaf 2 D^2 + 3 D flops and D shuffles; P (D^2 floats, 250 KB at
// D = 250) is read from L2 at every leaf.  The TPU kernel pads P with an
// identity block on its dead lanes; here lanes past D read no row of P and
// get a zero gradient, so nothing is padded.

#include "tree_kernel.cuh"

namespace tree {

template <int NV>
struct DenseGaussian {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kWide = true;
  const float* prec;  // [D, D]
  int D;

  template <class T>
  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&)[NV], const T&) {
    prec = pd.mat;
    D = pd.D;
  }

  template <class T>
  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV], T& t) const {
    t.matvec(prec, D, q, g);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      g[k] = -g[k];
      part = add(part, mul(g[k], q[k]));
    }
    return mul(0.5f, t.sum(part));
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// the dense Gaussian: mat is the precision P [D, D]; row0..row2, s0, s1 are
// not read.  D up to MAX_DIM (the wide form above 256).
TREE_LAUNCHERS(dense_gaussian, tree::DenseGaussian)
