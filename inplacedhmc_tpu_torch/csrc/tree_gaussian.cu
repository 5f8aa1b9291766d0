// K5 with Gaussian tile physics: the whole NUTS transition for targets with
// grad = -Lambda q (diag_gaussian models), the kernel body of
// tree_kernel.cuh with the Gaussian's value and gradient
// (ops/tile_physics.py::gaussian; the TPU kernel's _gaussian_tile_logp,
// inplacedhmc_tpu/ops/tree_pallas.py:1103).  Its leaf keeps the log density
// and the kinetic energy in one fused loop.  The source's second launcher
// writes what the kernel's generator draws (the check of the generator
// against utils/philox.py).

#include "tree_kernel.cuh"

namespace tree {

template <int NV>
struct Gaussian {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = true;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  static constexpr bool kStaging = true;  // products staged (kStagedOf)
  static constexpr bool kWide = true;
  float lam[NV];  // the precision

  template <class T>
  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&in)[NV], const T& t) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      lam[k] = in[k] ? pd.row[0][t.base + t.lane + 32 * k] : 0.f;
  }

  // logp = -0.5 sum lam q^2, grad = -lam q
  template <class T>
  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV], T& t) const {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float lq = mul(lam[k], q[k]);
      g[k] = -lq;
      part = add(part, mul(lq, q[k]));
    }
    return mul(-0.5f, t.sum(part));
  }
};

// What the kernel's generator draws for `key`: normals [K, C, D] (before
// the momentum scale), direction words [K, C] and uniforms [K, n_unif, C];
// any output pointer may be null.
__global__ void philox_draws_kernel(const int64_t* keyg, float* normals,
                                    int32_t* dirs, float* unif, int64_t C,
                                    int D, int n_unif, int K) {
  const Key key{(uint32_t)keyg[0], (uint32_t)keyg[1]};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (normals)
    for (int64_t i = first; i < (int64_t)K * C * D; i += stride) {
      const int64_t sc = i / D;
      normals[i] = draw_normal(key, (uint32_t)(sc % C), (int)(sc / C),
                               (int)(i % D));
    }
  if (dirs)
    for (int64_t i = first; i < (int64_t)K * C; i += stride)
      dirs[i] = (int32_t)draw_direction(key, (uint32_t)(i % C), (int)(i / C));
  if (unif)
    for (int64_t i = first; i < (int64_t)K * n_unif * C; i += stride) {
      const int64_t su = i / C;
      unif[i] = draw_uniform(key, (uint32_t)(i % C), (int)(su / n_unif),
                             (int)(su % n_unif));
    }
}

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// the Gaussian: row0 is the precision lam [D]; row1, row2, mat, s0, s1 are
// not read.  Under a dense Minv the leaf is the generic one.  D up to
// MAX_DIM (the wide form above 256).
TREE_LAUNCHERS(gaussian, tree::Gaussian)

// Writes what the tree kernel's generator draws under `key` (int64 [2]) for
// C chains, D coordinates, n_unif uniform slots and K transitions: normals
// [K, C, D] float32, direction words [K, C] int32, uniforms [K, n_unif, C]
// float32 (each may be null).  Launches on `stream`; returns its
// cudaError_t.
extern "C" int philox_draws_launch(const int64_t* key, float* normals,
                                   int32_t* dirs, float* unif, int64_t C,
                                   int D, int n_unif, int K, void* stream) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C < 0 || D < 0 || n_unif < 0 || K < 0 || C > 0xffffffffLL || !key)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || K == 0) return 0;
  tree::philox_draws_kernel<<<1024, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      key, normals, dirs, unif, C, D, n_unif, K);
  return cudaGetLastError();
}
