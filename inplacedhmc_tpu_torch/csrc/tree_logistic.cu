// K5 with Bayesian logistic regression's tile physics (BASELINE config 3):
// the body of tree_kernel.cuh in its tile form (Tile: a block of chains,
// a warp each, that walk their trees in lockstep) with the value and
// gradient of the TPU kernel's logistic physics, the chunked tile_vg of
// inplacedhmc_tpu/ops/tree_pallas.py:1242-1275 (built by
// make_logistic_tree_transition, :1159; its vjp form, :1202-1223, computes
// the same function), computed for the whole tile at once as tile_vg
// computes it for the TPU kernel's block_c chains.  Its plain version is
// ops/tile_physics.py::logistic:
//   eta  = Q X^T                                   (Q the tile's q rows)
//   t    = exp(-|eta|)                             (one t for both uses)
//   logp = -0.5 inv_var |q|^2 + sum_n w (y eta - (max(eta, 0) + log1p(t)))
//   sig  = eta >= 0 ? 1 / (1 + t) : t / (1 + t)
//   grad = -inv_var q + sum_n (y - sig) w x_n
// over X, y and w as the plane of ops/logistic.py::logistic_planes holds
// them (K1's tiles of logistic_mma.cuh, made once per transition; w = 0 on
// the padding, whose terms are exactly 0).  Both products are K1's, on the
// tensor cores: eta as 3xTF32 (float32 grade: never one TF32 pass), the
// backward as 3xTF32 or, under grad_bf16 (scalar s1 != 0), one bf16 pass
// of the residual and X rounded to bfloat16 (nearest even), whose
// products are exact and whose sums are float32; logp is never rounded.
// A logistic density that overflows (eta infinite or NaN) makes logp or
// the gradient non-finite, which the leaf's sanitisation turns into a
// divergence.
//
// Design.  The tile's chains are the M side of the mma tiles (16 rows;
// kTileChains 16 chains a tile at NV <= 4, 8 at NV = 8, where a thread
// holds 255 registers; fewer where the plan must).  Every value_grad is a
// call of the whole block (tree_kernel.cuh's tile form), and X crosses L2
// once per tile and evaluation, not once per chain:
//  * Each chain's warp writes its q as tf32 {hi, lo} pairs into its row of
//    Q [tc][qs] in shared memory.
//  * X arrives in shared memory by the copy unit's bulk copies
//    (bulk_copy.cuh) into a ring of `sets` sets of a batch of bt
//    observation tiles (each with its nc chunks of 64 dimensions), an
//    mbarrier per stage; the next set is on its way while the block walks
//    one (the first sets at the start of a call, the next after each
//    batch's last barrier), each stage issued by lane 0 of a warp in turn
//    (so that no one warp, held back by the issue, is the batch's last).
//  * Phase 1 of a batch: its 4 bt units of 8 observations (a tile's n-tiles)
//    go to the warps in turn, each unit's warp waiting for its tile's
//    stages; a unit's eta for the tile's 16 rows is K1's 3xTF32 forward
//    over the chunks (A from Q, B from the stage; each chunk summed apart
//    and added in float32, as K1's wide form does), and its residuals and
//    log density terms K1's obs_term; the residuals go to R [tc][rs], the
//    log density's into the warp's own sums.
//  * Phase 2, after a barrier: the gradient's 8-dimension n-tiles go to
//    the warps (a warp each, or, with fewer n-tiles than warps, `groups`
//    warps each, which split the batch's pairs of n-tiles); each runs K1's
//    backward on R and the stage, one tile's pairs at a time, and adds the
//    tile's sum into its own words of GP [groups][tc][gs] in float32 (two
//    levels, as K1: the tensor cores may truncate their sums).
//  * After the walk the warps' log density sums (LP, in R's words) and GP
//    are added in a fixed order by each chain's warp, with the prior.
// Every thread takes every loop and barrier of the call; the result of a
// chain depends on its own q only (an mma row is its own sums), so a
// chain's records do not depend on the chains beside it.
//
// Bound on an H100 SXM: each evaluation of the tile does 4 N D flops of
// products per chain, as three TF32 passes (or the backward one bf16 pass)
// on the tensor cores or on the fp32 FMA pipe, whichever is less, and per
// observation the precise expf, log1pf and division.  What holds it
// (tools/time_tile_variants.py): a block of 16 chains holds the SM's
// registers (128 a thread), so one block runs an SM and each batch's two
// barriers drain it; more tiles a batch ran faster (4 against 3 and 2:
// fewer barriers), two blocks of 8 chains an SM slower (each X tile then
// serves 8 chains).

#include "logistic_mma.cuh"
#include "tree_kernel.cuh"

namespace tree {

// The smallest count of 32-bit words >= w whose rows are free of bank
// conflicts for the fragments' loads and stores (64-bit accesses of rows
// g = 0..7 at columns 2 t4: a row stride of 8 or 24 words mod 32)
__host__ __device__ constexpr int conflict_free(int w) {
  int r = (w + 7) / 8 * 8;
  while (r % 32 != 8 && r % 32 != 24) r += 8;
  return r;
}

// The tile physics' shared memory after the chains' stacks, byte offsets
// from its start, each 16-byte aligned: the ring's barriers [stages], the
// ring [stages][tw] (the plane's tiles of the form: tw words each), Q
// [tc][qs] (tf32 {hi, lo} pairs), R [tc][rs] (a batch's residuals; after a
// walk the warps' log density sums LP [tc][16]) and GP [groups][tc][gs]
// (the gradient's sums).
struct TileLayout {
  int nc, ndn, stages, tw, qs, rs, gs, groups;
  int64_t bar, ring, q, r, gp, bytes;
};

__host__ __device__ constexpr int64_t up16(int64_t b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ constexpr TileLayout tile_layout(int D, int tc, int bt,
                                                     int sets, int opt) {
  TileLayout L{};
  L.nc = (D + lvg::DC - 1) / lvg::DC;
  L.ndn = (D + 7) / 8;
  L.stages = sets * bt * L.nc;
  L.tw = opt ? lvg::tile_words<lvg::kGradBf16>()
             : lvg::tile_words<lvg::kF32>();
  L.qs = conflict_free(16 * L.ndn);
  L.rs = 32 * bt + 8;
  L.gs = conflict_free(8 * L.ndn);
  L.groups = L.ndn >= tc ? 1
             : tc / L.ndn < 2 * bt ? tc / L.ndn
                                   : 2 * bt;
  L.bar = 0;
  L.ring = up16(8LL * L.stages);
  L.q = L.ring + 4LL * L.stages * L.tw;
  L.r = up16(L.q + 4LL * tc * L.qs);
  L.gp = up16(L.r + 4LL * tc * L.rs);
  L.bytes = up16(L.gp + 4LL * L.groups * tc * L.gs);
  return L;
}

template <int NV>
struct Logistic {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 1;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  // the dense launcher keeps M^-1 on the register path (kStagedOf)
  static constexpr bool kStaging = false;
  static constexpr bool kWide = false;  // D <= 256
  static constexpr bool kTile = true;   // the tile form
  static constexpr int kTileChains = NV > 4 ? 8 : 16;

  // the plan's sizes (tile_plan_of): the region's bytes, the ring's stages
  static __host__ __device__ int64_t region_bytes(int D, int tc, int bt,
                                                  int sets, int opt) {
    return tile_layout(D, tc, bt, sets, opt).bytes;
  }
  static __host__ __device__ int ring_stages(int D, int bt, int sets) {
    return sets * bt * ((D + lvg::DC - 1) / lvg::DC);
  }

  const float* plane;  // the plane's tiles [ntiles][nc][tw]
  int ntiles, D, bt, sets;
  int gb;              // the batches walked so far: the ring's phases
  uint32_t region;     // the region's byte offset in shared memory
  float inv_var;
  bool bf16;

  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&)[NV], Tile& t) {
    plane = pd.obs_mat;
    ntiles = (int)((pd.n_obs + lvg::BN - 1) / lvg::BN);
    D = pd.D;
    inv_var = pd.scalar[0];
    bf16 = pd.scalar[1] != 0.f;
    bt = t.batch;
    sets = t.stages / (bt * ((D + lvg::DC - 1) / lvg::DC));
    region = t.region;
    gb = 0;
    const int tc = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const TileLayout L = tile_layout(D, tc, bt, sets, bf16);
    unsigned char* base = staged_smem + region;
    if (threadIdx.x == 0) {
      uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar);
      for (int s = 0; s < L.stages; ++s) bar_init(full + s, 1);
      bar_init_fence();
    }
    // the chain's row of Q, its columns past D included (0: X's padded
    // dimensions are 0 too, and a non-finite q there would make NaNs)
    uint2* Q = reinterpret_cast<uint2*>(base + L.q) + warp * (L.qs / 2);
    for (int i = t.lane; i < L.qs / 2; i += 32) Q[i] = make_uint2(0u, 0u);
    __syncthreads();  // the barriers' initialisation before any issue
  }

  // The chain's log density, the same on every lane, and its gradient
  // entries: a call of the whole tile (every thread of the block)
  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV], Tile& t) {
    using namespace lvg;
    const int lane = t.lane, warp = threadIdx.x >> 5;
    const int tc = blockDim.x >> 5;
    const int gq = lane >> 2, t4 = lane & 3;  // the fragments' row, column
    const bool row0 = gq < tc, row1 = gq + 8 < tc;
    const TileLayout L = tile_layout(D, tc, bt, sets, bf16);
    unsigned char* base = staged_smem + region;
    uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar);
    float* ring = reinterpret_cast<float*>(base + L.ring);
    uint2* Q = reinterpret_cast<uint2*>(base + L.q);
    float* R = reinterpret_cast<float*>(base + L.r);
    float* GP = reinterpret_cast<float*>(base + L.gp);
    const int per = bt * L.nc;  // stages a batch
    const int nb = (ntiles + bt - 1) / bt;
    const int tw = L.tw, qh = L.qs / 2;

    // the stages of batch b of this call into its set: stage i by lane 0
    // of warp i % tc (the issue spread over the warps); a stage past the
    // last tile completes at once
    auto issue = [&](int b) {
      const int set = (gb + b) % sets;
      if (lane == 0)
        for (int i = warp; i < per; i += tc) {
          const int64_t tile = (int64_t)b * bt + i / L.nc;
          uint64_t* bar = full + set * per + i;
          if (tile < ntiles) {
            bar_expect(bar, 4u * tw);
            bulk_copy(ring + (int64_t)(set * per + i) * tw,
                      plane + (tile * L.nc + i % L.nc) * tw, 4u * tw, bar);
          } else {
            bar_arrive(bar);
          }
        }
    };
    // every stage is free: the last call's walk ended in a barrier that
    // every thread has passed
    for (int b = 0; b < sets && b < nb; ++b) issue(b);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        uint32_t hi, lo;
        split(q[k], hi, lo);
        Q[warp * qh + d] = make_uint2(hi, lo);
      }
    }
    __syncthreads();

    // phase 2's n-tiles of the gradient: warp `warp` owns n-tiles dn0,
    // dn0 + dstep, ... in group gi (warps of no group own none); its words
    // of GP start at 0
    const int ndn = L.ndn, G = L.groups;
    const int gi = ndn >= tc ? 0 : warp / ndn;
    const int dn0 = ndn >= tc ? warp : warp % ndn;
    const int dstep = ndn >= tc ? tc : ndn;
    const bool owner = gi < G;
    auto gp_at = [&](int dn, int row) {
      return reinterpret_cast<float2*>(GP + (gi * tc + row) * L.gs + 8 * dn +
                                       2 * t4);
    };
    if (owner)
      for (int dn = dn0; dn < ndn; dn += dstep) {
        if (row0) *gp_at(dn, gq) = make_float2(0.f, 0.f);
        if (row1) *gp_at(dn, gq + 8) = make_float2(0.f, 0.f);
      }

    float lacc[2] = {0.f, 0.f};  // logp's terms, rows gq and gq + 8
    for (int b = 0; b < nb; ++b) {
      const int set = (gb + b) % sets;
      const unsigned parity = (unsigned)((gb + b) / sets) & 1u;
      const float* batch = ring + (int64_t)set * per * tw;
      const int tiles = min(bt, ntiles - b * bt);
      // phase 1: the forward and the residuals of the batch's units, each
      // unit's warp waiting for its tile's stages (phase 2 reads every
      // tile's after the barrier that follows those waits)
      for (int u = warp; u < 4 * tiles; u += tc) {
        const int bi = u >> 2, j = u & 3;
        for (int ch = 0; ch < L.nc; ++ch)
          bar_wait(full + set * per + bi * L.nc + ch, parity);
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = 0; ch < L.nc; ++ch) {
          const float* st = batch + (bi * L.nc + ch) * tw;
          const int ks = min(KS, ndn - KS * ch);
          // the three passes in three sums, so that their products
          // overlap (one unit a warp: no other work hides a chain's)
          float elh[4] = {0.f, 0.f, 0.f, 0.f}, ehl[4] = {0.f, 0.f, 0.f, 0.f};
          float ehh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            if (k < ks) {
              const int col = DC * ch + 8 * k + t4;
              const uint2 z = make_uint2(0u, 0u);
              const uint2 v0 = row0 ? Q[gq * qh + col] : z;
              const uint2 v1 = row1 ? Q[(gq + 8) * qh + col] : z;
              const uint2 v2 = row0 ? Q[gq * qh + col + 4] : z;
              const uint2 v3 = row1 ? Q[(gq + 8) * qh + col + 4] : z;
              const uint32_t ah[4] = {v0.x, v1.x, v2.x, v3.x};
              const uint32_t al[4] = {v0.y, v1.y, v2.y, v3.y};
              const int o = (8 * j + gq) * XS + 8 * k + t4;
              const uint32_t bh0 = word(st + OFF_HI, o);
              const uint32_t bh1 = word(st + OFF_HI, o + 4);
              mma_tf32(elh, al, bh0, bh1);
              mma_tf32(ehl, ah, word(st + OFF_LO, o), word(st + OFF_LO, o + 4));
              mma_tf32(ehh, ah, bh0, bh1);
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float ec = (elh[v] + ehl[v]) + ehh[v];  // small terms first
            e[v] = ch == 0 ? ec : e[v] + ec;
          }
        }
        const float* st0 = batch + bi * L.nc * tw;
#pragma unroll
        for (int el = 0; el < 4; ++el) {
          const int n = 8 * j + 2 * t4 + (el & 1);
          e[el] = obs_term(e[el], st0[OFF_Y + n], st0[OFF_W + n],
                           lacc[el >> 1]);
        }
        const int col = 32 * bi + 8 * j + 2 * t4;
        if (row0)
          *reinterpret_cast<float2*>(R + gq * L.rs + col) =
              make_float2(e[0], e[1]);
        if (row1)
          *reinterpret_cast<float2*>(R + (gq + 8) * L.rs + col) =
              make_float2(e[2], e[3]);
      }
      __syncthreads();
      // phase 2: the backward of the batch into the owners' sums
      // (each tile's pairs summed apart, a sum a tile, so that the tiles'
      // products overlap; then added in tile order)
      if (owner)
        for (int dn = dn0; dn < ndn; dn += dstep) {
          const int ch = dn >> 3, ldn = dn & 7;
          float inner[MAX_BATCH_TILES][1][4];
#pragma unroll
          for (int bi = 0; bi < MAX_BATCH_TILES; ++bi) zero(inner[bi]);
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int bi = 0; bi < MAX_BATCH_TILES; ++bi) {
              if (bi >= tiles || (2 * bi + p) % G != gi) continue;
              const float* st = batch + (bi * L.nc + ch) * tw;
              float e2[2][4];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int col = 32 * bi + 16 * p + 8 * jj + 2 * t4;
                const float2 z = make_float2(0.f, 0.f);
                const float2 r0 =
                    row0 ? *reinterpret_cast<const float2*>(R + gq * L.rs +
                                                            col)
                         : z;
                const float2 r1 =
                    row1 ? *reinterpret_cast<const float2*>(
                               R + (gq + 8) * L.rs + col)
                         : z;
                e2[jj][0] = r0.x;
                e2[jj][1] = r0.y;
                e2[jj][2] = r1.x;
                e2[jj][3] = r1.y;
              }
              if (bf16)
                backward<kGradBf16, 1, false>(inner[bi], e2, p,
                                              st + 8 * ldn * XBW, 1, gq, t4);
              else
                backward<kF32, 1, false>(inner[bi], e2, p, st + 8 * ldn, 1,
                                         gq, t4);
            }
#pragma unroll
          for (int bi = 0; bi < MAX_BATCH_TILES; ++bi) {
            if (bi >= tiles || (G > 1 && 2 * bi % G != gi &&
                                (2 * bi + 1) % G != gi))
              continue;
            if (row0) {
              const float2 v = *gp_at(dn, gq);
              *gp_at(dn, gq) =
                  make_float2(v.x + inner[bi][0][0], v.y + inner[bi][0][1]);
            }
            if (row1) {
              const float2 v = *gp_at(dn, gq + 8);
              *gp_at(dn, gq + 8) =
                  make_float2(v.x + inner[bi][0][2], v.y + inner[bi][0][3]);
            }
          }
        }
      __syncthreads();  // every warp is done with the set: refill it
      if (b + sets < nb) issue(b + sets);
    }
    gb += nb;

    // the warps' log density sums (a quad holds a row's), then each chain's
    // own, added in warp and group order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lacc[h] = add(lacc[h], __shfl_xor_sync(FULL, lacc[h], 1));
      lacc[h] = add(lacc[h], __shfl_xor_sync(FULL, lacc[h], 2));
    }
    float* LP = R;  // R is free after the walk's last barrier
    if (t4 == 0) {
      LP[warp * 16 + gq] = lacc[0];
      LP[warp * 16 + gq + 8] = lacc[1];
    }
    __syncthreads();
    float lp = 0.f;
    for (int w = 0; w < tc; ++w) lp = add(lp, LP[w * 16 + warp]);
    float qq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = lane + 32 * k;
      qq = add(qq, mul(q[k], q[k]));
      float acc = 0.f;
      if (d < D)
        for (int i = 0; i < G; ++i)
          acc = add(acc, GP[(i * tc + warp) * L.gs + d]);
      g[k] = d < D ? add(mul(-inv_var, q[k]), acc) : 0.f;
    }
    return add(mul(mul(-0.5f, inv_var), warp_sum(qq)), lp);
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// logistic regression: obs_mat the plane of ops/logistic.py::
// logistic_planes (form "f32", or "grad_bf16" when s1 != 0; 16-byte
// aligned), n_obs the observations it holds; s0 inv_var, s1 grad_bf16 (0
// or 1); row0..row2, mat, obs_row0 and obs_row1 are not read.  Any n_obs
// >= 0 (a ragged last tile carries w = 0 past it).
TREE_LAUNCHERS(logistic, tree::Logistic)
