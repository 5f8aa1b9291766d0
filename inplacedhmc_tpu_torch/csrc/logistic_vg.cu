// Fused logistic-regression log density and gradient for a batch of chains.
//
// Replaces the TPU kernels inplacedhmc_tpu/ops/logistic_pallas.py::
// _make_fused_kernel (K1, launched by _logistic_value_and_grad_padded) and
// _make_packed_kernel (K2, launched by _logistic_value_and_grad_packed),
// both built by make_logistic_potential.  For chains q [C, D] over data
// X [N, D], labels y [N] and weights w [N] it computes, without ever
// storing eta:
//
//   eta[c, n] = sum_d q[c, d] X[n, d]
//   t         = exp(-|eta|)                        (one t serves both uses)
//   logp[c]   = sum_n w (y eta - max(eta, 0) - log1p(t)) - s2/2 |q_c|^2
//   sig       = eta >= 0 ? 1/(1+t) : t/(1+t)
//   grad[c,:] = sum_n w (y - sig) X[n, :] - s2 q_c
//
// and maps a non-finite logp to -inf with a zero gradient (and zeroes any
// non-finite gradient component), as make_logistic_potential does.  One
// body, three forms of it (the template parameter FORM), every product on
// the tensor cores (mma.sync), each class of product at its grade:
//
//  * kF32 (logistic_vg_launch, grad_bf16 = 0): both products float32-grade,
//    as 3xTF32: each operand a = a_hi + a_lo with a_hi = cvt.rna.tf32(a),
//    a_lo = cvt.rna.tf32(a - a_hi) (|a - a_hi - a_lo| <= 2^-22 |a|), and
//    a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, in
//    mma.sync.m16n8k8 tf32 products with float32 accumulation.  X's halves
//    are made once per potential (the plane, below); q and the residual
//    are split here, in registers.  Never one TF32 pass.
//  * kGradBf16 (logistic_vg_launch, grad_bf16 = 1;
//    make_logistic_potential(..., grad_bf16=True)): the forward as kF32's;
//    the backward one bf16 pass (mma.sync.m16n8k16) of the residual
//    w (y - sig) and X, both rounded to bfloat16 (nearest even), whose
//    products are exact and whose sums are float32, as the TPU kernel's
//    astype does (_make_fused_kernel, `if grad_bf16:`) and the plain version
//    computes.  logp is kF32's to the bit.
//  * kPacked (logistic_packed_launch, D <= 64;
//    make_logistic_potential(..., fwd_precision="packed")): the forward is
//    the packed split-bf16 product.  With bfloat16 halves a = a_hi + a_lo
//    (a_hi = a rounded to nearest even, a_lo = (a - a_hi) rounded; X's
//    halves given, q's split here, in registers),
//
//      eta = (sum_d q_hi x_hi + sum_d q_lo x_hi) + sum_d q_hi x_lo
//
//    the first two sums in one accumulator, as the TPU kernel sums them in
//    one MXU product ([q_hi | q_lo] . [x_hi | x_hi] over 128 lanes), the
//    third in a second one added after (mma.sync.m16n8k16 bf16).  The
//    backward is kF32's 3xTF32 one.
//
// The f32-grade products serve JAX's "default", "high" and "highest" alike
// (ops/logistic.py::make_logistic_potential): 3xTF32 drops the lo.lo term,
// about 2^-22 of each product, as JAX's 3-pass "high" drops it.
//
// Bound on an H100 SXM at C = 8192, N = 1e4, D = 50 (2 C N D = 8.19 GFLOP a
// product; 2 C N transcendentals; the bytes, q, X, y, w in and logp, grad
// out, about 5 MB, X resident in the 50 MB L2): the tensor pipe.  kF32's
// two products as three TF32 passes each, 49.2 GFLOP at 495 TFLOP/s,
// 0.099 ms (the two products alone on the fp32 FMA pipe: 0.245 ms); kGradBf16
// 24.6 GFLOP TF32 + 8.2 GFLOP bf16 at 989, 0.058 ms; kPacked 24.6 GFLOP
// bf16 + 24.6 GFLOP TF32, 0.075 ms.  The precise expf, log1pf and division
// on 8.2e7 observations run beside them on the other pipes.
//
// Design:
//  * A block is 4 warps over BC = 64 chains (16 a warp: the M side of the
//    mma tiles), and walks a range of the observations.  The N axis is cut
//    into tiles of BN = 32 observations; the launch splits the tiles of the
//    chains' block across gridDim.y blocks (`splits`, chosen by the wrapper
//    from the occupancy so that the card is filled, ops/logistic.py::
//    launch_splits), each writing its partial logp and gradient to scratch;
//    a second kernel of this source (logistic_finalize) adds the splits in
//    order, adds the prior and applies the guard: deterministic, no atomics.
//  * X arrives in shared memory by bulk asynchronous copies (cp.async.bulk
//    on an mbarrier per stage, bulk_copy.cuh) into a ring of STAGES tiles:
//    thread 0 keeps STAGES - 1 tiles in flight while the block computes one;
//    every warp reads every tile.  The tiles are laid out for the fragments
//    by the plane (ops/logistic.py::logistic_planes, made once per
//    potential): per tile of BN observations and chunk of DC = 64
//    dimensions, X's tf32 hi and lo halves [BN][XS] (row stride 68 words:
//    the forward's and the backward's fragment loads are free of bank
//    conflicts), y and w [BN], and the form's own: kGradBf16 X's bf16
//    values d-major in observation pairs [DC][XBW], kPacked X's bf16 halves
//    [BN][XPW] each.  Padded observations carry w = y = 0 and X = 0, padded
//    dimensions X = 0, so the kernel masks nothing but its chains.  A block
//    consumes every tile it asks for before it leaves.
//  * The forward (FA2 shape: eta plays the scores, X both K and V) makes
//    eta for 16 chains x 8 observations in an mma C fragment; its residual
//    is formed in registers and the fragment is the backward's A operand
//    as it stands: for m16n8k8 tf32 the A fragment's column t4 / t4 + 4
//    takes C's columns 2 t4 / 2 t4 + 1, so the backward's B side reads the
//    observations of each group of 8 in the order (0, 2, 4, 6, 1, 3, 5, 7);
//    for m16n8k16 bf16 two C fragments of 8 observations are one A
//    fragment of 16.  No residual goes through shared memory.  The
//    instruction is mma.sync (warp-level, its fragments in registers), not
//    wgmma: with mma.sync the forward's accumulator is the backward's A
//    operand as it stands, and a warp's 16 chains need no warpgroup-wide
//    wait between the two products; a wgmma form is not built.
//  * Two-level sums: the tensor cores may truncate their float32 sums
//    (Fasi, Higham, Mikaitis and Pranesh 2021), so the backward's fragments
//    sum one tile (4 k-steps) and are then added, with ordinary float32
//    adds, into the walk's sums: each thread's own words of shared memory
//    (D <= 64; the registers they would take cost the body its occupancy)
//    or the block's slice of the scratch (D > 64); above D = 64 the
//    forward's chunks are added the same way.
//  * D <= 64 (WIDE = false): one instantiation per count NK = ceil(D / 8)
//    of k-steps of 8 dimensions, so that no branch on D splits the
//    products and the compiler schedules the tile as one block (a uniform
//    branch per k-step cost a quarter of the time); q's split fragments
//    stay in registers for the whole walk.  The tile's forward is issued
//    whole before its residuals, so its products run while the
//    transcendentals of the first group do.  D > 64 (WIDE = true, any D):
//    the dimensions are cut into chunks of 64; each tile streams its chunks
//    twice, once for the forward (q's fragments of the chunk loaded and
//    split per chunk) and once for the backward, whose chunk of the
//    gradient is added into the block's own slice of the scratch (read,
//    add, write: one owner; the reads are issued before the chunk's
//    products, whose time hides them: reading after them cost the wide
//    form 1.2-1.6x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "logistic_mma.cuh"

namespace {

using namespace lvg;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BC = 16 * WARPS;          // chains per block
constexpr int PACKED_DIM = 64;          // the contraction kPacked holds
constexpr int STAGE_BUDGET = 56 * 1024;  // ring bytes: 3 blocks an SM
constexpr int BAR_BYTES = 128;           // the ring's barriers, then the ring
constexpr int FIN_WARPS = 8;             // logistic_finalize: a chain a warp

template <int FORM>
__host__ __device__ constexpr int stages() {
  return STAGE_BUDGET / (4 * tile_words<FORM>()) < 2 ? 2
         : STAGE_BUDGET / (4 * tile_words<FORM>()) > 4
             ? 4
             : STAGE_BUDGET / (4 * tile_words<FORM>());
}
// the ring's barriers, the ring, and (D <= 64) the warps' gradient sums
template <int FORM, int NK, bool WIDE>
constexpr size_t smem_bytes() {
  return BAR_BYTES + (size_t)stages<FORM>() * tile_words<FORM>() * 4 +
         (WIDE ? 0 : (size_t)WARPS * NK * 4 * 32 * 4);
}

// q's tf32 fragments (A, m16n8k8) for the warp's chains cw .. cw + 15 and
// the dimensions d0 .. d0 + 8 NK - 1: element (row g + 8 (e & 1), column
// 8 k + t4 + 4 (e >> 1)) of k-step k; 0 past C and D
template <int NK>
__device__ __forceinline__ void q_fragments(const float* __restrict__ q,
                                            int64_t cw, int64_t C, int D,
                                            int d0, int g, int t4,
                                            uint32_t (&qh)[NK][4],
                                            uint32_t (&ql)[NK][4]) {
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t c = cw + g + 8 * (e & 1);
      const int d = d0 + 8 * k + t4 + 4 * (e >> 1);
      const float v = (c < C && d < D) ? __ldg(q + c * D + d) : 0.f;
      split(v, qh[k][e], ql[k][e]);
    }
}

// eta += q . X^T for the warp's 16 chains and n-tiles j0, j0 + 1 (8
// observations each) of the tile (tf32, 3 passes)
template <int NK, bool RAGGED>
__device__ __forceinline__ void forward_tf32(float (&e)[2][4], int j0,
                                             const float* xh, const float* xl,
                                             const uint32_t (&qh)[NK][4],
                                             const uint32_t (&ql)[NK][4],
                                             int nks, int g, int t4) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    if (takes<RAGGED>(k, nks)) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int o = (8 * (j0 + jj) + g) * XS + 8 * k + t4;
        mma_3x(e[jj], qh[k], ql[k], word(xh, o), word(xh, o + 4),
               word(xl, o), word(xl, o + 4));
      }
    }
  }
}

// eta += q . X^T as the packed split-bf16 product (m16n8k16) for n-tiles
// j0, j0 + 1: (q_hi x_hi + q_lo x_hi) + q_hi x_lo
template <int NP>
__device__ __forceinline__ void forward_packed(float (&e)[2][4], int j0,
                                               const uint32_t* xph,
                                               const uint32_t* xpl,
                                               const uint32_t (&qh)[NP][4],
                                               const uint32_t (&ql)[NP][4],
                                               int g, int t4) {
  float el[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int o = (8 * (j0 + jj) + g) * XPW + 8 * k + t4;
      mma_bf16(e[jj], qh[k], xph[o], xph[o + 4]);
      mma_bf16(e[jj], ql[k], xph[o], xph[o + 4]);
      mma_bf16(el[jj], qh[k], xpl[o], xpl[o + 4]);
    }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int v = 0; v < 4; ++v) e[jj][v] += el[jj][v];
}

// the residuals of n-tiles j0, j0 + 1 from their eta (in place), their
// terms added to lacc[row half]
__device__ __forceinline__ void residuals(float (&e)[2][4], int j0,
                                          const float* ys, const float* ws,
                                          float (&lacc)[2], int t4) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int el = 0; el < 4; ++el) {
      const int n = 8 * (j0 + jj) + 2 * t4 + (el & 1);
      e[jj][el] = obs_term(e[jj][el], ys[n], ws[n], lacc[el >> 1]);
    }
}

// The body.  NK: the k-steps of 8 dimensions, ceil(D / 8) for D <= 64
// (WIDE = false), 8 a chunk above (WIDE = true)
template <int FORM, int NK, bool WIDE>
__global__ void __launch_bounds__(THREADS, 3)
logistic_vg_kernel(const float* __restrict__ q,
                   const float* __restrict__ plane,
                   float* __restrict__ part_lp, float* __restrict__ part_g,
                   int64_t C, int D, int nc, int64_t ntiles) {
  constexpr int TW = tile_words<FORM>();
  constexpr int S = stages<FORM>();
  constexpr int NP = (NK + 1) / 2;  // kPacked's forward k-steps of 16
  static_assert(!WIDE || (NK == KS && FORM != kPacked), "the wide form");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + BAR_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the fragments' row, column
  const int64_t cw = (int64_t)blockIdx.x * BC + 16 * warp;
  const bool active = cw < C;  // the warp holds a chain: uniform
  const int64_t split_ix = blockIdx.y, splits = gridDim.y;
  const int64_t t0 = ntiles * split_ix / splits;
  const int64_t t1 = ntiles * (split_ix + 1) / splits;
  const int per_tile = WIDE ? 2 * nc : 1;
  const int64_t items = (t1 - t0) * per_tile;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) bar_init(full + s, 1);
    bar_init_fence();
  }
  __syncthreads();
  // item i (tile t0 + i / per_tile; WIDE: its chunk (i % per_tile) % nc)
  // into stage i % S, by thread 0
  auto issue = [&](int64_t i) {
    const int64_t tile = t0 + i / per_tile;
    const int chunk = WIDE ? (int)(i % per_tile) % nc : 0;
    const int s = (int)(i % S);
    bar_expect(full + s, 4u * TW);
    bulk_copy(ring + s * TW, plane + (tile * nc + chunk) * TW, 4u * TW,
              full + s);
  };
  if (tid == 0)
    for (int64_t i = 0; i < items && i < S; ++i) issue(i);

  float lacc[2] = {0.f, 0.f};  // logp's terms, rows g and g + 8
  // the gradient over the tile, in registers (inner), and, D <= 64, over
  // the walk, in the thread's own words of shared memory (outer: element
  // (k, e) at outer[32 (4 k + e)], free of bank conflicts)
  float inner[NK][4];
  float* outer = ring + S * TW + warp * NK * 4 * 32 + lane;
  if constexpr (!WIDE) {
#pragma unroll
    for (int k = 0; k < 4 * NK; ++k) outer[32 * k] = 0.f;
  }
  // q's fragments, D <= 64 for the whole walk: tf32 halves, or (kPacked)
  // bf16 halves for the m16n8k16 forward: rows {g, g + 8, g, g + 8},
  // columns 16 k + 2 t4 + {0, 0, 8, 8} (and the next)
  uint32_t qh[FORM == kPacked ? 1 : NK][4], ql[FORM == kPacked ? 1 : NK][4];
  uint32_t pqh[FORM == kPacked ? NP : 1][4], pql[FORM == kPacked ? NP : 1][4];
  if constexpr (FORM == kPacked) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t c = cw + g + 8 * (j & 1);
        const int d = 16 * k + 2 * t4 + 8 * (j >> 1);
        __nv_bfloat16 h[2], l[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v =
              (c < C && d + e < D) ? __ldg(q + c * D + d + e) : 0.f;
          h[e] = __float2bfloat16_rn(v);
          l[e] = __float2bfloat16_rn(v - __bfloat162float(h[e]));
        }
        pqh[k][j] = pack(h[0], h[1]);
        pql[k][j] = pack(l[0], l[1]);
      }
  } else if constexpr (!WIDE) {
    q_fragments<NK>(q, cw, C, D, 0, g, t4, qh, ql);
  }

  // WIDE: eta of the tile's 4 n-tiles (then their residuals) across its
  // chunks
  float ew[BN / 16][2][4];

  for (int64_t i = 0; i < items; ++i) {
    const int s = (int)(i % S);
    bar_wait(full + s, (unsigned)((i / S) & 1));
    const float* tile = ring + s * TW;
    const float* ys = tile + OFF_Y;
    const float* ws = tile + OFF_W;
    if (active) {
      if constexpr (!WIDE) {
        // the forward of the whole tile first, so that its products are in
        // flight while the residuals of the first group are formed
        zero(inner);
        float e[BN / 16][2][4];
#pragma unroll
        for (int p = 0; p < BN / 16; ++p) {
          zero(e[p]);
          if constexpr (FORM == kPacked) {
            const uint32_t* xph =
                reinterpret_cast<const uint32_t*>(tile + OFF_EXTRA);
            forward_packed<NP>(e[p], 2 * p, xph, xph + BN * XPW, pqh, pql, g,
                               t4);
          } else {
            forward_tf32<NK, false>(e[p], 2 * p, tile + OFF_HI,
                                    tile + OFF_LO, qh, ql, NK, g, t4);
          }
        }
#pragma unroll
        for (int p = 0; p < BN / 16; ++p) {
          residuals(e[p], 2 * p, ys, ws, lacc, t4);
          backward<FORM, NK, false>(inner, e[p], p, tile, NK, g, t4);
        }
#pragma unroll
        for (int k = 0; k < NK; ++k)
#pragma unroll
          for (int v = 0; v < 4; ++v) outer[32 * (4 * k + v)] += inner[k][v];
      } else {
        const int li = (int)(i % per_tile);
        const int chunk = li % nc;
        const int d0 = DC * chunk;
        const int nks = min(KS, (D - d0 + 7) / 8);
        if (li < nc) {
          // forward over this chunk: its fragments summed apart, then
          // added to eta
          q_fragments<KS>(q, cw, C, D, d0, g, t4, qh, ql);
#pragma unroll
          for (int p = 0; p < BN / 16; ++p) {
            float e[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            forward_tf32<KS, true>(e, 2 * p, tile + OFF_HI, tile + OFF_LO,
                                   qh, ql, nks, g, t4);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                ew[p][jj][v] =
                    chunk == 0 ? e[jj][v] : ew[p][jj][v] + e[jj][v];
          }
          if (chunk == nc - 1) {
#pragma unroll
            for (int p = 0; p < BN / 16; ++p)
              residuals(ew[p], 2 * p, ys, ws, lacc, t4);
          }
        } else {
          // backward over this chunk, added into the block's scratch: the
          // sums so far are read before the products, so that the reads'
          // latency passes under them (the first tile of the split has
          // none)
          const bool first = i < per_tile;
          float* dst = part_g + (split_ix * C + cw + g) * D + d0 + 2 * t4;
          float sofar[KS][4];
#pragma unroll
          for (int dn = 0; dn < KS; ++dn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int64_t c = cw + g + 8 * (e >> 1);
              const int d = d0 + 8 * dn + 2 * t4 + (e & 1);
              const int64_t o = 8 * (e >> 1) * (int64_t)D + 8 * dn + (e & 1);
              sofar[dn][e] = !first && dn < nks && c < C && d < D
                                 ? dst[o] : 0.f;
            }
          zero(inner);
#pragma unroll
          for (int p = 0; p < BN / 16; ++p)
            backward<FORM, KS, true>(inner, ew[p], p, tile, nks, g, t4);
#pragma unroll
          for (int dn = 0; dn < KS; ++dn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int64_t c = cw + g + 8 * (e >> 1);
              const int d = d0 + 8 * dn + 2 * t4 + (e & 1);
              const int64_t o = 8 * (e >> 1) * (int64_t)D + 8 * dn + (e & 1);
              if (dn < nks && c < C && d < D)
                dst[o] = sofar[dn][e] + inner[dn][e];
            }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && i + S < items) issue(i + S);
  }
  if (!active) return;

  // the partial logp: the 4 lanes of a quad hold one row's terms
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lacc[h] += __shfl_xor_sync(0xffffffffu, lacc[h], 1);
    lacc[h] += __shfl_xor_sync(0xffffffffu, lacc[h], 2);
  }
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = cw + g + 8 * h;
      if (c < C) part_lp[split_ix * C + c] = lacc[h];
    }
  }
  // the partial gradient: C fragment element e is (row g + 8 (e >> 1),
  // column 2 t4 + (e & 1)); WIDE wrote its own, unless it had no tile
  if constexpr (WIDE) {
    if (items > 0) return;
    for (int64_t c = cw; c < cw + 16 && c < C; ++c)
      for (int d = lane; d < D; d += 32)
        part_g[(split_ix * C + c) * D + d] = 0.f;
  } else {
#pragma unroll
    for (int dn = 0; dn < NK; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t c = cw + g + 8 * (e >> 1);
        const int d = 8 * dn + 2 * t4 + (e & 1);
        if (c < C && d < D)
          part_g[(split_ix * C + c) * D + d] = outer[32 * (4 * dn + e)];
      }
  }
}

// The splits' partial logp [splits, C] and gradients [splits, C, D] added
// in split order, the prior, the guard: one warp a chain
__global__ void __launch_bounds__(32 * FIN_WARPS)
logistic_finalize(const float* __restrict__ q,
                  const float* __restrict__ part_lp,
                  const float* __restrict__ part_g, float s2,
                  float* __restrict__ logp, float* __restrict__ grad,
                  int64_t C, int D, int splits) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * FIN_WARPS + (threadIdx.x >> 5);
  if (c >= C) return;
  float lp = 0.f, qq = 0.f;
  for (int s = lane; s < splits; s += 32) lp += part_lp[s * C + c];
  for (int d = lane; d < D; d += 32) qq = fmaf(q[c * D + d], q[c * D + d], qq);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lp += __shfl_xor_sync(0xffffffffu, lp, off);
    qq += __shfl_xor_sync(0xffffffffu, qq, off);
  }
  const float total = lp - 0.5f * s2 * qq;
  const bool ok = isfinite(total);
  if (lane == 0) logp[c] = ok ? total : -INFINITY;
  for (int d = lane; d < D; d += 32) {
    float gs = 0.f;
    for (int s = 0; s < splits; ++s) gs += part_g[(s * C + c) * D + d];
    const float gv = gs - s2 * q[c * D + d];
    grad[c * D + d] = (ok && isfinite(gv)) ? gv : 0.f;
  }
}

// One launch: the body, then logistic_finalize
template <int FORM, int NK, bool WIDE>
cudaError_t launch(const float* q, const float* plane, float s2, float* logp,
                   float* grad, float* part, int64_t C, int64_t N, int D,
                   int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes<FORM, NK, WIDE>();
  cudaError_t err = cudaFuncSetAttribute(
      logistic_vg_kernel<FORM, NK, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int nc = WIDE ? (D + DC - 1) / DC : 1;
  const int64_t ntiles = (N + BN - 1) / BN;
  float* part_lp = part;
  float* part_g = part + (int64_t)splits * C;
  const dim3 grid((unsigned)((C + BC - 1) / BC), (unsigned)splits);
  logistic_vg_kernel<FORM, NK, WIDE><<<grid, THREADS, bytes, stream>>>(
      q, plane, part_lp, part_g, C, D, nc, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logistic_finalize<<<(unsigned)((C + FIN_WARPS - 1) / FIN_WARPS),
                      32 * FIN_WARPS, 0, stream>>>(q, part_lp, part_g, s2,
                                                   logp, grad, C, D, splits);
  return cudaGetLastError();
}

// The occupancy of an instantiation into out[8] (logistic_occupancy)
template <int FORM, int NK, bool WIDE>
cudaError_t occupancy(int* out) {
  const size_t bytes = smem_bytes<FORM, NK, WIDE>();
  cudaError_t err = cudaFuncSetAttribute(
      logistic_vg_kernel<FORM, NK, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, logistic_vg_kernel<FORM, NK, WIDE>, THREADS, bytes);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, logistic_vg_kernel<FORM, NK, WIDE>);
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = blocks * WARPS;
  out[2] = sms;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = (int)bytes;
  out[6] = stages<FORM>();
  out[7] = tile_words<FORM>();
  return cudaSuccess;
}

// The instantiation a form takes at D: by its k-steps up to D = 64, the
// wide one above (kPacked takes D <= 64 only); `Op` is launch or occupancy
template <int FORM, template <int, int, bool> class Op, class... A>
cudaError_t dispatch(int D, A... a) {
  switch ((D + 7) / 8) {
    case 1: return Op<FORM, 1, false>::run(a...);
    case 2: return Op<FORM, 2, false>::run(a...);
    case 3: return Op<FORM, 3, false>::run(a...);
    case 4: return Op<FORM, 4, false>::run(a...);
    case 5: return Op<FORM, 5, false>::run(a...);
    case 6: return Op<FORM, 6, false>::run(a...);
    case 7: return Op<FORM, 7, false>::run(a...);
    case 8: return Op<FORM, 8, false>::run(a...);
    default:
      if constexpr (FORM == kPacked) return cudaErrorInvalidValue;
      else return Op<FORM, KS, true>::run(a...);
  }
}
template <int FORM, int NK, bool WIDE>
struct Launch {
  static cudaError_t run(const float* q, const float* plane, float s2,
                         float* logp, float* grad, float* part, int64_t C,
                         int64_t N, int D, int splits, cudaStream_t stream) {
    return launch<FORM, NK, WIDE>(q, plane, s2, logp, grad, part, C, N, D,
                                  splits, stream);
  }
};
template <int FORM, int NK, bool WIDE>
struct Occupancy {
  static cudaError_t run(int* out) { return occupancy<FORM, NK, WIDE>(out); }
};

// the checks both launchers make: the error already pending, or
// cudaErrorInvalidValue for what the kernel cannot take
int refuse(int64_t C, int64_t N, int D, int splits, int max_dim) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || N < 0 || D < 1 || D > max_dim || splits < 1 ||
      splits > 65535 || (C + BC - 1) / BC > 0x7fffffff ||
      (C + FIN_WARPS - 1) / FIN_WARPS > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// Pointers are device pointers to contiguous float32: q [C, D], the plane
// (ops/logistic.py::logistic_planes, form "f32", or "grad_bf16" when
// grad_bf16 = 1), logp [C], grad [C, D] and the scratch `part`, splits x C
// x (D + 1) floats.  Any D >= 1; grad_bf16 (0 or 1) rounds the backward
// product's inputs to bfloat16; splits in [1, 65535].
extern "C" int logistic_vg_launch(const float* q, const float* plane,
                                  float s2, float* logp, float* grad,
                                  float* part, int64_t C, int64_t N, int D,
                                  int grad_bf16, int splits, void* stream) {
  if (int rc = refuse(C, N, D, splits, 0x7fffffff)) return rc;
  if (C == 0) return 0;  // nothing to launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(grad_bf16
                   ? dispatch<kGradBf16, Launch>(D, q, plane, s2, logp, grad,
                                                 part, C, N, D, splits, s)
                   : dispatch<kF32, Launch>(D, q, plane, s2, logp, grad, part,
                                            C, N, D, splits, s));
}

// The packed split-bf16 forward (K2).  Pointers as logistic_vg_launch's,
// the plane of form "packed"; D must be in [1, 64].
extern "C" int logistic_packed_launch(const float* q, const float* plane,
                                      float s2, float* logp, float* grad,
                                      float* part, int64_t C, int64_t N,
                                      int D, int splits, void* stream) {
  if (int rc = refuse(C, N, D, splits, PACKED_DIM)) return rc;
  if (C == 0) return 0;  // nothing to launch
  return (int)dispatch<kPacked, Launch>(D, q, plane, s2, logp, grad, part, C,
                                        N, D, splits,
                                        static_cast<cudaStream_t>(stream));
}

// The occupancy of the instantiation a launch of `form` (0 float32, 1
// grad_bf16, 2 packed) at dimension D takes, on the current device, into
// out[8]: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// warps an SM, the device's SMs, registers a thread, local (spill) bytes a
// thread, dynamic shared memory a block, ring stages, words a tile.
extern "C" int logistic_occupancy(int form, int D, int* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  return (int)(form == kF32         ? dispatch<kF32, Occupancy>(D, out)
               : form == kGradBf16  ? dispatch<kGradBf16, Occupancy>(D, out)
               : form == kPacked && D <= PACKED_DIM
                   ? dispatch<kPacked, Occupancy>(D, out)
                   : cudaErrorInvalidValue);
}
