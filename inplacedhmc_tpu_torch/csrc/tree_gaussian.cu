// The whole NUTS transition for targets with grad = -Lambda q and a diagonal
// inverse metric Minv, one chain per warp, in one launch.
//
// Replaces the TPU kernel inplacedhmc_tpu/ops/tree_pallas.py::_make_kernel
// (launched by _build_transition_padded, built by make_tree_transition and
// make_gaussian_tree_transition) in its diagonal-metric form with Gaussian
// tile physics, explicit momentum, direction words and proposal uniforms
// (dense=False, use_prng=False, n_sweep=1, refresh_inside=False).  For each
// chain it computes what that kernel computes: the momentum-refresh energy
// pi0, the doubling loop over depths d < max_depth, the 2^d leapfrog leaves
// of each subtree, the generalized U-turn checks on the checkpoint stack, the
// progressive proposal within a subtree and the biased one at each doubling,
// divergence at delta < min_delta, the acceptance sum
// sum exp(min(delta, 0)) in linear space (its log taken once, at exit), and
// the termination records (term, term_left, term_right, depth, steps).
//
// What differs from the TPU kernel, and why:
//  * The TPU runs a tile of chains in lockstep: the leaf index is global to
//    the tile and a leaf is skipped only when the whole tile is dead.  Here
//    each chain has its own control flow: a warp leaves its subtree when its
//    chain diverges or turns, and its tree when the chain terminates.  The
//    TPU kernel masks every update of a dead chain, so a dead chain's later
//    leaves change nothing, and the uniforms are indexed by (leaf position,
//    chain): the results are the same as the tile's.
//  * Uniforms: unif [2^md - 1 + md, C]; leaf n of subtree depth d reads row
//    2^d - 1 + n, the epilogue of depth d row 2^md - 1 + d (the layout of
//    the TPU kernel's interpret mode).
//  * Checkpoint stacks: even leaf n stores the pre-leaf momentum sum and p#
//    to slot popcount(n >> 1); the U-turn checks of levels
//    m < trailing_ones(n) read slot popcount(n >> 1) - m.  The TPU kernel's
//    odd-leaf stores go to a dummy slot that nothing reads; here they are
//    skipped.  The stacks ([md, D] floats each, 8 KB per chain at D = 100,
//    md = 10) live in dynamic shared memory, one region per warp; the
//    position, momentum and gradient vectors of the tree (15 of them) live
//    in registers, K = DP / 32 floats per lane.
//  * Arithmetic: the operations of each leaf are those of the TPU kernel and
//    of the plain torch version (ops/tree.py), each rounded on its own
//    (__fmul_rn, __fadd_rn: no FMA contraction), so a trajectory's vectors
//    equal the plain version's bit for bit; only the row sums (log density,
//    kinetic energy, U-turn statistics) are taken in another order, a
//    fixed-order sum per lane and a butterfly shuffle, deterministic and the
//    same on every lane, so every branch is uniform across the warp.
//
// Bound on an H100 SXM: each leapfrog leaf does about 25 D flops (the
// update, two row sums, the guards, the expected U-turn check and the
// selects), so a transition is about 25 D sum(steps) flops at 67 TFLOP/s
// fp32, against the bytes of its inputs and outputs (q0, p0, the uniforms
// in, q, grad and the per-chain records out) at 3.35 TB/s.  At C = 10,240,
// D = 100, md = 10 the uniforms (42 MB) dominate the bytes.  A simple kernel
// that is right comes first; the tile shape, in-kernel Philox and sweeps are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TERM_MAX_DEPTH = 0;  // core/state.py::Termination
constexpr int TERM_DIVERGENCE = 1;
constexpr int TERM_TURNING = 2;
constexpr int MAX_WARPS = 4;          // chains per block
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory of one block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// logaddexp as jnp and torch compute it: max + log1p(exp(-|a - b|)), and
// a + b where a - b is NaN (both -inf)
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float dl = sub(a, b);
  if (isnan(dl)) return add(a, b);
  return add(fmaxf(a, b), log1pf(expf(-fabsf(dl))));
}

template <int K>
__device__ __forceinline__ void copy(float (&dst)[K], const float (&src)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = src[k];
}

// sum_d a_d b_d over the chain's row
template <int K>
__device__ __forceinline__ float dot(const float (&a)[K], const float (&b)[K]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s = add(s, mul(a[k], b[k]));
  return warp_sum(s);
}

template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS)
tree_gaussian_kernel(const float* __restrict__ q0g,
                     const float* __restrict__ p0g,
                     const float* __restrict__ epsg,
                     const int32_t* __restrict__ dirsg,
                     const float* __restrict__ unif,
                     const float* __restrict__ lamg,
                     const float* __restrict__ minvg,
                     float* __restrict__ q_out, float* __restrict__ logp_out,
                     float* __restrict__ grad_out,
                     float* __restrict__ energy_out,
                     float* __restrict__ lsa_out, int32_t* __restrict__ term_out,
                     int32_t* __restrict__ tl_out, int32_t* __restrict__ tr_out,
                     int32_t* __restrict__ depth_out,
                     int32_t* __restrict__ steps_out, int64_t C, int D,
                     int md, float min_delta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // the whole warp leaves together

  const int64_t stack_len = 2 * (int64_t)md * D;
  float* stk_s = smem + warp * stack_len;
  float* stk_ps = stk_s + (int64_t)md * D;

  bool in[K];
  float lam[K], minv[K];
  float lq[K], lp[K], lg[K], rq[K], rp[K], rg[K];  // trajectory ends
  float cq[K], cp[K], cg[K];                       // subtree frontier
  float psl[K], psr[K], rho[K], scum[K], propq[K], subq[K];
  const int64_t row = c * D;
  float lp_part = 0.f, kin_part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    in[k] = d < D;
    lam[k] = in[k] ? lamg[d] : 0.f;
    minv[k] = in[k] ? minvg[d] : 0.f;
    const float q = in[k] ? q0g[row + d] : 0.f;
    const float p = in[k] ? p0g[row + d] : 0.f;
    const float lqk = mul(lam[k], q);
    lq[k] = rq[k] = propq[k] = subq[k] = cq[k] = q;
    lp[k] = rp[k] = rho[k] = cp[k] = p;
    lg[k] = rg[k] = cg[k] = -lqk;
    psl[k] = psr[k] = mul(minv[k], p);
    lp_part = add(lp_part, mul(lqk, q));
    kin_part = add(kin_part, mul(mul(p, minv[k]), p));
  }
  const float logp0 = mul(-0.5f, warp_sum(lp_part));
  const float pi0 = sub(logp0, mul(0.5f, warp_sum(kin_part)));

  const float eps = epsg[c];
  const uint32_t dirs = (uint32_t)dirsg[c];
  float omega = 0.f, prop_delta = 0.f, prop_logp = logp0;
  float sub_delta = 0.f, sub_logp = logp0, sum_alpha = 0.f;
  int i_left = 0, i_right = 0, steps = 0, depth = 0;
  int term = TERM_MAX_DEPTH, tl = 1, tr = 0;  // REACHED_MAX_DEPTH (1, 0)

  for (int d = 0; d < md; ++d) {
    const bool isf = (dirs >> d) & 1u;
    const int signi = isf ? 1 : -1;
    const float eps_signed = mul(isf ? 1.f : -1.f, eps);
    const float half = mul(0.5f, eps_signed);
    const int i_base = isf ? i_right : i_left;
    const int n_leaves = 1 << d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cq[k] = isf ? rq[k] : lq[k];
      cp[k] = isf ? rp[k] : lp[k];
      cg[k] = isf ? rg[k] : lg[k];
      scum[k] = 0.f;
    }
    float omega_sub = -INFINITY;
    bool died_div = false, died_turn = false;
    int die_l = 0, die_r = 0;

    for (int n = 0; n < n_leaves; ++n) {
      // leapfrog leaf
      float qn[K], pn[K], gn[K], psn[K];
      lp_part = 0.f;
      kin_part = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float p_mid = add(cp[k], mul(half, cg[k]));
        qn[k] = add(cq[k], mul(eps_signed, mul(minv[k], p_mid)));
        const float lqn = mul(lam[k], qn[k]);
        gn[k] = -lqn;
        pn[k] = add(p_mid, mul(half, gn[k]));
        psn[k] = mul(minv[k], pn[k]);
        lp_part = add(lp_part, mul(lqn, qn[k]));
        kin_part = add(kin_part, mul(mul(pn[k], minv[k]), pn[k]));
      }
      const float logp_new = mul(-0.5f, warp_sum(lp_part));
      const float kin_new = mul(0.5f, warp_sum(kin_part));
      // any non-finite joint density is -inf, a NaN delta is -inf
      float joint = sub(logp_new, isfinite(kin_new) ? kin_new : INFINITY);
      if (!isfinite(joint)) joint = -INFINITY;
      float delta = sub(joint, pi0);
      if (isnan(delta)) delta = -INFINITY;
      const bool divergent = delta < min_delta;
      // non-finite elements fall back to the previous point before they are
      // stored (p# to 0)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!isfinite(qn[k])) qn[k] = cq[k];
        if (!isfinite(pn[k])) pn[k] = cp[k];
        if (!isfinite(gn[k])) gn[k] = cg[k];
        if (!isfinite(psn[k])) psn[k] = 0.f;
      }
      const int i_new = i_base + (n + 1) * signi;
      sum_alpha = add(sum_alpha, expf(fminf(delta, 0.f)));
      steps += 1;

      // even leaves open nodes: store the pre-leaf momentum sum and p#
      if ((n & 1) == 0) {
        const int slot = __popc(n >> 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (in[k]) {
            stk_s[slot * D + lane + 32 * k] = scum[k];
            stk_ps[slot * D + lane + 32 * k] = psn[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) scum[k] = add(scum[k], pn[k]);

      // U-turn checks of the nodes this leaf closes, innermost first
      bool turning = false;
      int turn_pos = 0;
      const int t_ones = __ffs(~n) - 1;
      const int idx_max = __popc(n >> 1);
      for (int m = 0; m < t_ones; ++m) {
        const int j = idx_max - m;
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float s = in[k] ? stk_s[j * D + lane + 32 * k] : 0.f;
          const float ps = in[k] ? stk_ps[j * D + lane + 32 * k] : 0.f;
          const float rn = sub(scum[k], s);
          a = add(a, mul(rn, ps));
          b = add(b, mul(rn, psn[k]));
        }
        a = warp_sum(a);
        b = warp_sum(b);
        if (a < 0.f || b < 0.f) {
          turning = true;
          turn_pos = i_base + (n - (2 << m) + 2) * signi;
          break;
        }
      }
      turning = turning && !divergent;

      // progressive proposal within the subtree (unbiased multinomial)
      const float omega_new = logaddexp(omega_sub, delta);
      const float u = unif[(int64_t)(n_leaves - 1 + n) * C + c];
      if (!divergent) {
        if (logf(u) < sub(delta, omega_new)) {
#pragma unroll
          for (int k = 0; k < K; ++k) subq[k] = qn[k];
          sub_delta = delta;
          sub_logp = logp_new;
        }
        omega_sub = omega_new;
      }
      copy(cq, qn);
      copy(cp, pn);
      copy(cg, gn);
      if (divergent) {
        died_div = true;
        die_l = die_r = i_new;
        break;
      }
      if (turning) {
        died_turn = true;
        die_l = min(turn_pos, i_new);
        die_r = max(turn_pos, i_new);
        break;
      }
    }

    // merge the subtree into the trajectory (biased progressive sampling)
    const bool ok = !(died_div || died_turn);
    bool turn_top = false;
    if (ok) {
      const float u2 = unif[(int64_t)((1 << md) - 1 + d) * C + c];
      if (logf(u2) < sub(omega_sub, omega)) {
        copy(propq, subq);
        prop_delta = sub_delta;
        prop_logp = sub_logp;
      }
      omega = logaddexp(omega, omega_sub);
      const int i_end = i_base + n_leaves * signi;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float ps_end = mul(minv[k], cp[k]);
        if (isf) {
          rq[k] = cq[k]; rp[k] = cp[k]; rg[k] = cg[k]; psr[k] = ps_end;
        } else {
          lq[k] = cq[k]; lp[k] = cp[k]; lg[k] = cg[k]; psl[k] = ps_end;
        }
        rho[k] = add(rho[k], scum[k]);
      }
      if (isf) i_right = i_end; else i_left = i_end;
      depth = d + 1;
      turn_top = dot(rho, psl) < 0.f || dot(rho, psr) < 0.f;
    }
    if (died_div) term = TERM_DIVERGENCE;
    if (died_turn || turn_top) term = TERM_TURNING;
    if (!ok) {
      tl = die_l;
      tr = die_r;
      break;
    }
    if (turn_top) {
      tl = i_left;
      tr = i_right;
      break;
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (in[k]) {
      q_out[row + lane + 32 * k] = propq[k];
      grad_out[row + lane + 32 * k] = -mul(lam[k], propq[k]);
    }
  }
  if (lane == 0) {
    logp_out[c] = prop_logp;
    energy_out[c] = add(prop_delta, pi0);
    lsa_out[c] = logf(sum_alpha);
    term_out[c] = term;
    tl_out[c] = tl;
    tr_out[c] = tr;
    depth_out[c] = depth;
    steps_out[c] = steps;
  }
}

template <int K>
cudaError_t launch(const float* q0, const float* p0, const float* eps,
                   const int32_t* dirs, const float* unif, const float* lam,
                   const float* minv, float* q_out,
                   float* logp_out, float* grad_out, float* energy_out,
                   float* lsa_out, int32_t* term, int32_t* tl, int32_t* tr,
                   int32_t* depth, int32_t* steps, int64_t C, int D, int md,
                   float min_delta, cudaStream_t stream) {
  const int per_warp = 2 * md * D * (int)sizeof(float);
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_LIMIT) --warps;
  const int bytes = warps * per_warp;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tree_gaussian_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (C + warps - 1) / warps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  tree_gaussian_kernel<K><<<(unsigned)blocks, 32 * warps, bytes, stream>>>(
      q0, p0, eps, dirs, unif, lam, minv, q_out, logp_out, grad_out,
      energy_out, lsa_out, term, tl, tr, depth, steps, C, D, md, min_delta);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous arrays: q0, p0 [C, D], eps [C],
// dirs [C] (int32 direction words), unif [2^md - 1 + md, C], lam, minv [D]
// (float32 unless said).  Outputs: q, grad [C, D]; logp, energy,
// log_sum_alpha [C] float32; term, term_left, term_right, depth, steps [C]
// int32.  D must be in [1, 256] and md in [1, 30].
extern "C" int tree_gaussian_launch(
    const float* q0, const float* p0, const float* eps, const int32_t* dirs,
    const float* unif, const float* lam, const float* minv, float* q_out,
    float* logp_out, float* grad_out, float* energy_out, float* lsa_out,
    int32_t* term, int32_t* tl, int32_t* tr, int32_t* depth, int32_t* steps,
    int64_t C, int D, int md, float min_delta, void* stream) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || D < 1 || md < 1 || md > 30) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TREE_ARGS                                                            \
  q0, p0, eps, dirs, unif, lam, minv, q_out, logp_out, grad_out, energy_out, \
      lsa_out, term, tl, tr, depth, steps, C, D, md, min_delta, s
  if (D <= 64) return (int)launch<2>(TREE_ARGS);
  if (D <= 128) return (int)launch<4>(TREE_ARGS);
  if (D <= 256) return (int)launch<8>(TREE_ARGS);
#undef TREE_ARGS
  return (int)cudaErrorInvalidValue;
}
