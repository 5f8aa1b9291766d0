// K5 with the dense Gaussian's tile physics (mvn models, grad = -(q P) with
// a symmetric [D, D] precision P): the body of tree_kernel.cuh with the
// value and gradient of the TPU kernel's _dense_gaussian_tile_vg
// (inplacedhmc_tpu/ops/tree_pallas.py:1118-1123, built by
// make_dense_gaussian_tree_transition, :1126).  Its plain version is
// ops/tile_physics.py::dense_gaussian:
//   g = -(q P),  logp = 0.5 sum g q
// P q is one staged team mat-vec (tree_kernel.cuh's Staged: P is
// symmetric, so row i of P is its column i), the log density one team sum
// of the same product's terms.  Per leaf 2 D^2 + 3 D flops.  P is staged
// as every [D, D] matrix of K5 is, under either metric: resident in the
// block's shared memory where it fits beside the stacks (40 KB at D = 100),
// else streamed through the warp's ring of panels (250 KB at D = 250), by
// the asynchronous bulk copies of tree_kernel.cuh; the register path reads
// it from L2 in the wide form, where the ring measured slower (plan_of).  The TPU kernel pads P with an
// identity block on its dead lanes; here lanes past D read no row of P and
// get a zero gradient, so nothing is padded.

#include "tree_kernel.cuh"

namespace tree {

template <int NV>
struct DenseGaussian {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = true;  // a [D, D] matrix of its own
  static constexpr bool kStaging = true;  // products staged (kStagedOf)
  static constexpr bool kWide = true;
  Mat prec;  // [D, D]
  int D;

  template <class T>
  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&)[NV], const T&) {
    prec = Mat{pd.mat, MAT_OWN};
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
