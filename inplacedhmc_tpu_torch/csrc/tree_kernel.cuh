// The whole NUTS transition for a diagonal or dense inverse metric Minv and
// a tile physics P (the model's log density and gradient, written by hand),
// one chain per warp (above D = 256 one chain per block of warps; for a
// physics of the tile form, a tile of chains a block, a warp each, in
// lockstep), K sequential transitions per launch, with the random numbers
// drawn inside the kernel.  Included by one source per physics
// (tree_gaussian.cu, tree_eight_schools.cu, tree_funnel.cu,
// tree_dense_gaussian.cu, tree_logistic.cu, tree_stoch_vol.cu), each of
// which defines its physics and its two extern "C" launchers with
// TREE_LAUNCHERS (diagonal and dense Minv).
//
// Replaces the TPU kernel inplacedhmc_tpu/ops/tree_pallas.py::_make_kernel
// (launched by _build_transition_padded, built by make_tree_transition,
// make_gaussian_tree_transition, make_dense_gaussian_tree_transition and
// make_logistic_tree_transition)
// in both its metric forms (dense = False and the dense branch,
// tree_pallas.py:179-221, with the dense refresh of :522-530), with the
// physics that make_tree_transition differentiates in the kernel (jax.vjp of
// the model's tile_logp, tree_pallas.py:899-912) written out as a device
// function, in the forms the sampling paths use: use_prng (proposal uniforms
// drawn in the kernel), refresh_inside (momentum and direction word too),
// padded_io (a `valid` column; rows with valid = 0 start inactive) and
// n_sweep = K (the proposal of transition s is the start of s + 1; the draws
// and records of every transition are written, the gradient once, after the
// last; the last draw is the carry of the next launch).  For each chain it
// computes what that kernel computes: the momentum-refresh energy pi0, the
// doubling loop over depths d < max_depth, the 2^d leapfrog leaves of each
// subtree, the generalized U-turn checks on the checkpoint stack, the
// progressive proposal within a subtree and the biased one at each doubling,
// divergence at delta < min_delta, the acceptance sum sum exp(min(delta, 0))
// in linear space (its log taken once, at exit) and the termination records
// (term, term_left, term_right, depth, steps).  The explicit arrays of the
// TPU kernel's interpret mode stay as test hooks: momentum [K, C, D],
// direction words [K, C] and uniforms [K, 2^md - 1 + md, C].
//
// A physics P<NV> is a struct that holds one chain's data rows in registers
// (NV values a lane, like lam and minv) and provides
//   void load(const PhysicsData&, const bool (&in)[NV], const T& team)
//   float value_grad(const float (&q)[NV], float (&g)[NV], T& team) const
// value_grad returns the chain's log density, reduced over the team and the
// same on every thread, and writes the thread's gradient entries, 0 past D
// (there q is 0 and the rows read 0); a physics of the tile form
// (P::kTile: logistic regression) computes it for the whole tile at once,
// a call of every thread of the block (Tile, below).  The kernel calls it for the start of
// each transition, at each leaf and for the final gradient, where the TPU
// kernel calls its physics (tree_pallas.py:266, :538, :586, :630).  The
// Gaussian's leaf keeps its log density and kinetic energy in one fused
// loop (P::kFusedGaussian) under a diagonal metric.  A physics with a wide
// form (P::kWide: the Gaussian, the dense Gaussian, stochastic volatility)
// takes either team T; a physics of the tile form takes Tile; the others
// take Warp only.
//
// One body, tree_kernel<T, P, kDense>, in two forms chosen by D in
// launch_physics, the team T (Warp or Block below) the only difference:
//  * T = Warp, D <= 256: one warp per chain, coordinate lane + 32 k in
//    register k (NV = 1, 2, 4 or 8 by D), up to MAX_WARPS chains a block;
//    a row sum is a fixed-order sum per lane and a butterfly shuffle
//    (warp_sum), a coordinate's value reaches every lane by __shfl_sync;
//  * T = Block, 256 < D <= MAX_DIM: one chain per block of W =
//    ceil(D / 256) warps, NV = 8 (T = Cluster: the same, its [D, D]
//    products split across a cluster of such blocks); warp w holds
//    coordinates [256 w, 256 w +
//    256) in the one-warp layout (coordinate 256 w + lane + 32 k in
//    register k), so the loads, stores, stacks and elementwise updates are
//    the one-warp ones per warp.  Every row-wide operation goes through
//    shared memory after a barrier: a row sum is each warp's butterfly, its
//    lane 0's partial stored, and after the barrier every thread adding the
//    W partials in warp order, so the sum is the same on every thread and
//    every branch (divergence, U-turn breaks, merges) stays uniform across
//    the block, as every __syncthreads needs; the values of coordinates
//    0..2 and the neighbours across a warp's edge (stochastic volatility's
//    AR(1) term) are stored and read back the same way; a [D, D] mat-vec
//    stages the vector in shared memory and each thread walks the rows in
//    order.  Each operation alternates between two buffers, so the barrier
//    of one operation keeps the next from overwriting what a slower thread
//    of the one before still reads.
// Warp's operations stay force-inlined to the warp's own shuffles, base a
// constant 0, so that the one-warp form pays nothing for the team
// (tools/compare_sass.py compares two checkouts' SASS, instantiation by
// instantiation).
//
// The dense metric (kDense): Minv is [D, D] and every p# = Minv p is a team
// mat-vec; the refresh draws xi and takes p = xi S with S = mass_chol^T
// [D, D] in the momentum slot.  A leaf does two products, Minv p_mid for
// the position update and Minv p_new, which serves both the U-turn p# and
// the kinetic energy 0.5 p . p#; a physics with a matrix (the dense
// Gaussian) does a third.  A merge takes the new end's p# from the
// subtree's last leaf, and a transition's start does one product (two
// under refresh).  The TPU kernel takes the turn statistic as a cheaper
// 1-pass bf16 product and the energy and the update as a 3-pass split-bf16
// one (tree_pallas.py:182-221); one f32 product for all is at least as
// exact as each of them and keeps both exactness classes.
// Every product of the one-warp form is staged (Staged, below) where the
// card measured it faster: its matrix reaches shared memory through the
// copy unit's asynchronous bulk copies (cp.async.bulk, completed on an
// mbarrier), not through registers, on one of two paths chosen by shape
// before the launch (plan_of, ops/tree.py::stage_plan):
//  * resident, where every matrix of the launch (M^-1, S under refresh, the
//    physics' own) fits beside the stacks of the block's chains (the
//    funnel's D = 10, 100, 102, 128: up to MAX_STAGED_WARPS chains a block
//    share one copy; above D = 128 only with as many chains an SM as the
//    ring): thread 0 copies them in once a launch, before any warp of a
//    partial last block leaves, and the warps wait on the copy's mbarrier;
//  * a ring, in the one-warp form above D = 128 where they do not fit (the
//    250-D mvn): each warp streams each product's matrix through its own S
//    stages of R rows, at the register path's blocks an SM in the room
//    they leave; one lane issues the panels, a `full` mbarrier per stage
//    signals arrival, S - 1 panels stay in flight while the warp reads
//    one, and a stage is refilled after a __syncwarp.
// The vector reaches every thread from shared memory, rows are read
// i = 0 .. D-1 in order by the lanes at consecutive addresses (no bank
// conflict), each thread keeps its own columns, and each product and sum
// is rounded on its own: the register path's arithmetic in its order, so
// the outputs are the same bit for bit whatever the path.  A bulk copy
// moves 16-byte-aligned multiples of 16 bytes: a panel is R rows with R D
// a multiple of 4, the matrices start 16-byte aligned (the wrapper
// checks), and the at most three floats of a matrix past its last multiple
// of 16 bytes are copied by the issuing thread before its arrival, which
// releases them to the waiters.  In the wide form under a dense metric a
// chain's products are split by columns across a thread-block cluster of
// K blocks (Cluster, below: the team T = Cluster, K = 4 or 8, asked for
// by the wrapper where a launch waits on its deepest chain, ops/tree.py::
// cluster_of), each block streaming its own column panel of the matrix
// through its own ring by bulk copies, so that no handshake spans the
// chain's blocks (a ring over
// one block of the chain's warps measured slower than the register path:
// each panel a handshake of all its warps with the issuing thread).  The
// register path (matvec below: v_i broadcast from its lane, row i read
// through the read-only cache by the 32 lanes at once; Block::matvec: rows
// in batches of MATVEC_ROWS, one block a chain, K = 1) stays for eight
// schools and logistic regression, whose products the card measured
// slower staged (kStagedOf), and in the wide form under a diagonal metric
// (the dense Gaussian's P q alone), and under a dense metric wherever
// the wrapper does not ask for a cluster (a launch of many chains that
// does not wait on its deepest chain) or no cluster's ring fits beside
// the stacks; elsewhere it is a launch's to ask for (path).
//
// What differs from the TPU kernel, and why:
//  * The TPU runs a tile of chains in lockstep: the leaf index is global to
//    the tile and a leaf is skipped only when the whole tile is dead.  Here
//    each chain has its own control flow (Warp, Block): a warp leaves its
//    subtree when its chain diverges or turns, its tree when the chain
//    terminates, and an invalid (padding) row skips the tree at once.  The
//    TPU kernel masks every update of a dead chain, so a dead chain's later
//    leaves change nothing: the results are the same as the tile's.  A
//    physics that reads an [N, D] matrix at every leaf (logistic
//    regression) takes the TPU kernel's lockstep instead (Tile, the tile
//    form, below), so that its tile's chains share each slice of it.
//  * Random numbers: the TPU's bits cannot be reproduced, so the kernel runs
//    Philox4x32-10 (Salmon et al., SC'11) keyed by the launch's two words
//    (read from device memory: the host never sees them), with one counter
//    per draw, (chain, s, stream, slot); utils/philox.py is its plain
//    version.  Uniforms are (bits >> 8) 2^-24, normals Box-Muller on
//    ((bits >> 8) + 0.5) 2^-24, both as the TPU kernel converts its bits.
//    Leaf n of subtree depth d reads uniform slot 2^d - 1 + n, the merge of
//    depth d slot 2^md - 1 + d: a draw depends on its chain and slot only,
//    and a chain that ends early draws nothing more.
//  * Checkpoint stacks: even leaf n stores the pre-leaf momentum sum and p#
//    to slot popcount(n >> 1); the U-turn checks of levels
//    m < trailing_ones(n) read slot popcount(n >> 1) - m.  The TPU kernel's
//    odd-leaf stores go to a dummy slot that nothing reads; here they are
//    skipped.  The stacks ([md, D] floats each, 8 KB per chain at D = 100,
//    md = 10) live in dynamic shared memory, one region per chain of
//    stack_bytes, rounded up to STACK_ALIGN; the position, momentum and
//    gradient vectors of the tree (15 of them) live in registers, NV floats
//    per lane.  Lanes past D hold zeros (minv and the momentum scale read
//    as 0), so nothing of them reaches a row sum.  The wide form needs
//    stack_bytes + 4 (2 D + WIDE_SCRATCH) bytes of a block's SMEM_LIMIT
//    (wide_bytes: the stacks, the mat-vec's two staging rows, the row sums'
//    partials): at D = 2048, md <= 13; at D = 1002 and md = 10, 88 KB.
//    Registers, not shared memory, hold the wide form to two blocks an SM:
//    its instantiations take 253-255 registers a thread.
//  * bfloat16 stacks (ckpt_bf16, JAX's _make_kernel option of that name):
//    a store rounds the momentum sum and p# to bfloat16, to nearest even
//    (__float2bfloat16_rn, as astype(bfloat16)), and the turn checks widen
//    them back (__bfloat162float), so both directions of a check use the
//    rounded values; everything else stays float32.  It halves the stacks
//    (at D = 2048, md <= 26).  The element size is a flag of the launch,
//    the same for every thread, not a template parameter, which would
//    double the instantiations and their build time; the stacks are
//    addressed as bytes.
//  * Arithmetic: the operations of each leaf are those of the TPU kernel and
//    of the plain torch version (ops/tree.py, ops/tile_physics.py), each
//    rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction); only the
//    row sums (log density, kinetic energy, U-turn statistics, and the sums
//    inside a physics' gradient) are taken in another order, a fixed-order
//    sum per lane and a butterfly shuffle, deterministic and the same on
//    every lane, so every branch is uniform across the warp.  The Gaussian's
//    gradient is elementwise, so its trajectories equal the plain version's
//    bit for bit; a physics whose gradient holds a row sum (eight schools,
//    the funnel) rounds that sum differently, and its trajectories agree
//    with the plain version's to f32 round-off.
//
// Bound on an H100 SXM: each leapfrog leaf does about 25 D flops of tree
// work (the update, two row sums, the guards, the expected U-turn check and
// the selects) plus the physics' own, and 2 D^2 flops per mat-vec under a
// dense metric, so a transition is about that times sum(steps) flops at 67
// TFLOP/s fp32, against the bytes of its inputs and outputs (q in, the
// matrices once, and per transition q and the eight per-chain records out,
// grad once) at 3.35 TB/s.  A launch lasts as long as its deepest chain,
// whose [D, D] products run one after another (chip_smoke.py prints the
// time per product on the longest chain): on the register path each waited
// for L2 row by row with a few KB in flight; staged, a resident product
// reads shared memory only, and a ring keeps S - 1 panels on their way,
// but each panel costs its team a handshake with the copy unit, whatever
// S, so a streamed product is held by its number of panels, and a launch
// of many chains by L2's bandwidth.  On a cluster a product's time is its
// blocks' walks over the D rows of their panels (each column's sum one
// dependent chain of D adds, each row's loads from shared memory) and
// two cluster barriers; a cluster holds K SMs' worth of blocks, so a
// launch of many chains holds fewer of them at once.
// Several chains sharing one stream of a matrix (the tile form's lockstep,
// built for logistic regression's observations, or TMA multicast across a
// cluster), then 3xTF32 tensor cores on the shared panels, are later work
// for the [D, D] products.
// With the draws made here no uniform array crosses device memory.  One
// warp per chain leaves 32 - D lanes idle where D < 32 (22 of 32 at D =
// 10); a simple kernel that is right comes first, the tile shape is later
// work.
//
// Registers: at D <= 128 the kernel asks for 4 blocks of 4 warps per SM
// (__launch_bounds__), which caps it at 128 registers a thread; above that
// the sweep loop and the generator would leave room for 3 blocks only.  The
// wide form allows blocks of up to MAX_WIDE_WARPS warps, one per SM at
// least: 255 registers a thread, the cluster's helpers too (one kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

namespace tree {

constexpr int TERM_MAX_DEPTH = 0;  // core/state.py::Termination
constexpr int TERM_DIVERGENCE = 1;
constexpr int TERM_TURNING = 2;
constexpr int MAX_WARPS = 4;          // chains per block (narrow)
constexpr int WARP_DIM = 256;         // coordinates of one warp (32 x NV 8)
constexpr int MAX_DIM = 2048;         // the wide form: up to 8 warps a chain
constexpr int MAX_WIDE_WARPS = MAX_DIM / WARP_DIM;
constexpr int WIDE_SCRATCH = 64;      // floats: two buffers of 32
constexpr int MATVEC_ROWS = 4;        // rows of the wide mat-vec's batch
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory of one block
constexpr int STACK_ALIGN = 16;       // bytes: a chain's stacks rounded up
constexpr unsigned FULL = 0xffffffffu;
// the staged [D, D] products (the plan below)
constexpr int SM_SMEM = 233472;       // shared memory of one SM (228 KB)
constexpr int BLOCK_RESERVED = 1024;  // of it reserved for each block
constexpr int MAX_STAGES = 8;         // stages of a ring
constexpr int MAX_STAGED_WARPS = 16;  // chains a block of the staged
                                      // one-warp form holds (D <= 128)
constexpr int PATH_REGISTER = 0;      // rows read from L2 into registers
constexpr int PATH_RESIDENT = 1;      // the matrices copied in once a launch
constexpr int PATH_RING = 2;          // panels of rows streamed through a
                                      // ring of stages
constexpr int RING_MIN_DIM = 128;     // the plan's own ring: the one-warp
                                      // form above it (plan_of)
// the wide form's products split across a cluster (Cluster, below)
constexpr int PATH_CLUSTER = 3;       // paths 3, 4: clusters of 4, 8
constexpr int CLUSTER_PATHS = 2;      // blocks a chain
constexpr int CLUSTER_STAGES = 4;     // stages of each block's ring
constexpr int MAX_PANEL_COLS = 4;     // a panel's columns a thread sums
constexpr int ROW_BATCH = 16;         // rows whose loads go out together
constexpr int CMD_SLOT = WIDE_SCRATCH / 2 - 1;  // the command's word in the
                                      // leader's scratch (no row sum's)
constexpr int CMD_DONE = 3;           // the command after the last product
                                      // (0..2 name a matrix: MatKind)

// utils/philox.py: streams, constants
constexpr uint32_t STREAM_MOMENTUM = 0;
constexpr uint32_t STREAM_DIRECTION = 1;
constexpr uint32_t STREAM_UNIFORM = 2;
constexpr float TWO_M24 = 1.0f / 16777216.0f;
constexpr float TWO_PI_F32 = 6.2831854820251465f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1)
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ float draw_uniform(Key k, uint32_t chain, int s,
                                              int slot) {
  const uint4 w = philox(chain, (uint32_t)s, STREAM_UNIFORM, (uint32_t)slot,
                         k.k0, k.k1);
  return mul(__uint2float_rn(w.x >> 8), TWO_M24);
}

__device__ __forceinline__ uint32_t draw_direction(Key k, uint32_t chain,
                                                   int s) {
  return philox(chain, (uint32_t)s, STREAM_DIRECTION, 0u, k.k0, k.k1).x;
}

__device__ __forceinline__ float draw_normal(Key k, uint32_t chain, int s,
                                             int dim) {
  const uint4 w = philox(chain, (uint32_t)s, STREAM_MOMENTUM, (uint32_t)dim,
                         k.k0, k.k1);
  const float u1 = mul(add(__uint2float_rn(w.x >> 8), 0.5f), TWO_M24);
  const float u2 = mul(add(__uint2float_rn(w.y >> 8), 0.5f), TWO_M24);
  const float r = sqrtf(mul(-2.0f, logf(u1)));
  return mul(r, cosf(mul(TWO_PI_F32, u2)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// logaddexp as jnp and torch compute it: max + log1p(exp(-|a - b|)), and
// a + b where a - b is NaN (both -inf)
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float dl = sub(a, b);
  if (isnan(dl)) return add(a, b);
  return add(fmaxf(a, b), log1pf(expf(-fabsf(dl))));
}

template <int NV>
__device__ __forceinline__ void copy(float (&dst)[NV], const float (&src)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) dst[k] = src[k];
}

// out_j = sum_i v_i M[i][j] over the chain's row, M a [D, D] row-major
// matrix (symmetric, or mass_chol^T for the refresh): v_i is broadcast from
// its lane, lane l adds M[i][l + 32k] v_i for i = 0 .. D-1 in order, so row
// i is read by the 32 lanes at once.  Lanes past D read nothing and get 0.
// out may alias v.
template <int NV>
__device__ __forceinline__ void matvec(const float* __restrict__ m, int D,
                                       const float (&v)[NV],
                                       float (&out)[NV], int lane) {
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NV; ++kk) {
    const int n = min(32, D - 32 * kk);  // the sources in register kk
#pragma unroll 4
    for (int src = 0; src < n; ++src) {
      const float vi = __shfl_sync(FULL, v[kk], src);
      const float* row = m + (int64_t)(32 * kk + src) * D + lane;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (lane + 32 * k < D)
          acc[k] = add(acc[k], mul(__ldg(row + 32 * k), vi));
    }
  }
  copy(out, acc);
}

// A team: the threads of one chain and their row-wide operations.  sum
// (one row sum, the same on every thread), sum2 and sum3 (two and three at
// once), lead (the values of coordinates 0..N-1, from register 0),
// from_prev and from_next (the neighbours across the warp edges: each
// thread passes its last or first register's value and gets the value of
// the coordinate before its warp's first or after its warp's last, 0 where
// there is none), matvec (out = v M, out may alias v) and leader (the one
// thread that writes the chain's records).  base is the first coordinate of
// the thread's warp: coordinate base + lane + 32 k sits in register k.
//
// Warp, the one-warp form's: the chain's warp, its operations the butterfly
// (warp_sum), __shfl_sync and the warp mat-vec above; base is 0 and there
// is no warp edge.
struct Warp {
  static constexpr bool kWide = false;
  static constexpr bool kTile = false;
  static constexpr bool kCluster = false;
  static constexpr int base = 0;
  int lane;

  __device__ __forceinline__ explicit Warp(float*) : lane(threadIdx.x & 31) {}
  __device__ __forceinline__ bool leader() const { return lane == 0; }
  __device__ __forceinline__ float sum(float v) const { return warp_sum(v); }
  __device__ __forceinline__ void sum2(float& a, float& b) const {
    a = warp_sum(a);
    b = warp_sum(b);
  }
  __device__ __forceinline__ void sum3(float& a, float& b, float& c) const {
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
  }
  template <int N>
  __device__ __forceinline__ void lead(float x0, float (&out)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __shfl_sync(FULL, x0, i);
  }
  __device__ __forceinline__ float from_prev(float) const { return 0.f; }
  __device__ __forceinline__ float from_next(float) const { return 0.f; }
  template <int NV>
  __device__ __forceinline__ void matvec(const float* __restrict__ m, int D,
                                         const float (&v)[NV],
                                         float (&out)[NV]) const {
    tree::matvec(m, D, v, out, lane);
  }
};

// Block, the wide form's: the block of warps of one chain, its operations
// through shared memory (the forms at the top of this file).
struct Block {
  static constexpr bool kWide = true;
  static constexpr bool kTile = false;
  static constexpr bool kCluster = false;
  int lane, warp, nw, base;
  float* scratch;  // [2][WIDE_SCRATCH / 2]
  float* stage;    // [2][D]
  unsigned ph;     // operations so far: the buffer of the next is ph & 1

  // s: the block's shared memory after the stacks
  __device__ __forceinline__ explicit Block(float* s)
      : lane(threadIdx.x & 31), warp(threadIdx.x >> 5), nw(blockDim.x >> 5),
        base(WARP_DIM * (threadIdx.x >> 5)), scratch(s),
        stage(s + WIDE_SCRATCH), ph(0u) {}
  __device__ __forceinline__ bool leader() const { return threadIdx.x == 0; }
  __device__ __forceinline__ float* buffer() {
    return scratch + (ph++ & 1u) * (WIDE_SCRATCH / 2);
  }
  __device__ __forceinline__ float total(const float* r) const {
    float s = r[0];
    for (int w = 1; w < nw; ++w) s = add(s, r[w]);
    return s;
  }
  __device__ __forceinline__ float sum(float v) {
    v = warp_sum(v);
    float* r = buffer();
    if (lane == 0) r[warp] = v;
    __syncthreads();
    return total(r);
  }
  __device__ __forceinline__ void sum2(float& a, float& b) {
    a = warp_sum(a);
    b = warp_sum(b);
    float* r = buffer();
    if (lane == 0) {
      r[warp] = a;
      r[MAX_WIDE_WARPS + warp] = b;
    }
    __syncthreads();
    a = total(r);
    b = total(r + MAX_WIDE_WARPS);
  }
  __device__ __forceinline__ void sum3(float& a, float& b, float& c) {
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
    float* r = buffer();
    if (lane == 0) {
      r[warp] = a;
      r[MAX_WIDE_WARPS + warp] = b;
      r[2 * MAX_WIDE_WARPS + warp] = c;
    }
    __syncthreads();
    a = total(r);
    b = total(r + MAX_WIDE_WARPS);
    c = total(r + 2 * MAX_WIDE_WARPS);
  }
  template <int N>
  __device__ __forceinline__ void lead(float x0, float (&out)[N]) {
    float* r = buffer();
    if (warp == 0 && lane < N) r[lane] = x0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = r[i];
  }
  __device__ __forceinline__ float from_prev(float last) {
    float* r = buffer();
    if (lane == 31) r[warp] = last;
    __syncthreads();
    return warp > 0 ? r[warp - 1] : 0.f;
  }
  __device__ __forceinline__ float from_next(float first) {
    float* r = buffer();
    if (lane == 0) r[warp] = first;
    __syncthreads();
    return warp + 1 < nw ? r[warp + 1] : 0.f;
  }
  // v staged in shared memory; each thread adds M[i][j] v_i for its own
  // columns j over i = 0 .. D-1 in order (the narrow form's order), row i
  // read through the read-only cache by the block's threads at once.  The
  // rows come in batches of MATVEC_ROWS whose loads are all issued before
  // the first of their products, so that a batch waits for L2 once, not
  // once a row.  Within a batch a column past D reads the next row's first
  // entries (in bounds: the batches stop before the last row), and its
  // sums are dropped at the end; the rows after the batches, the last
  // among them, read only the columns below D
  template <int NV>
  __device__ __forceinline__ void matvec(const float* __restrict__ m, int D,
                                         const float (&v)[NV],
                                         float (&out)[NV]) {
    float* st = stage + (ph++ & 1u) * D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = base + lane + 32 * k;
      if (d < D) st[d] = v[k];
    }
    __syncthreads();
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.f;
    const float* row = m + base + lane;
    int i = 0;
    for (; i + MATVEC_ROWS < D; i += MATVEC_ROWS) {
      float r[MATVEC_ROWS][NV];
#pragma unroll
      for (int j = 0; j < MATVEC_ROWS; ++j)
#pragma unroll
        for (int k = 0; k < NV; ++k)
          r[j][k] = __ldg(row + (int64_t)j * D + 32 * k);
      row += (int64_t)MATVEC_ROWS * D;
#pragma unroll
      for (int j = 0; j < MATVEC_ROWS; ++j) {
        const float vi = st[i + j];
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[k] = add(acc[k], mul(r[j][k], vi));
      }
    }
    for (; i < D; ++i, row += D) {
      const float vi = st[i];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (base + lane + 32 * k < D)
          acc[k] = add(acc[k], mul(__ldg(row + 32 * k), vi));
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      out[k] = base + lane + 32 * k < D ? acc[k] : 0.f;
  }
};

// Tile, the chain tile's (a physics with P::kTile: logistic regression): a
// block of blockDim.x / 32 chains, one warp each in the one-warp layout
// (Warp's row-wide operations, within the chain's warp), that walk their
// trees in lockstep.  any(v) is the block's vote (__syncthreads_or) that
// sets the trip counts of the doubling and leaf loops, and the physics'
// value_grad is a collective call of the block; region, stages and batch
// tell the physics where its shared memory starts (after the chains'
// stacks) and its plan (tile_plan_of).
struct Tile : Warp {
  static constexpr bool kTile = true;
  uint32_t region = 0;
  int stages = 0, batch = 0;

  __device__ __forceinline__ explicit Tile(float* s) : Warp(s) {}
  __device__ __forceinline__ bool any(bool v) const {
    return __syncthreads_or(v) != 0;
  }
};

// Whether a physics takes the tile form (P::kTile; false where the physics
// does not say)
template <class P, class = void>
struct TiledOf : std::false_type {};
template <class P>
struct TiledOf<P, std::void_t<decltype(P::kTile)>>
    : std::bool_constant<P::kTile> {};
template <class P>
constexpr bool kTiledOf = TiledOf<P>::value;
// The threads of a tile form's block at most: 32 P::kTileChains
template <class P, class = void>
struct TileThreads : std::integral_constant<int, 0> {};
template <class P>
struct TileThreads<P, std::void_t<decltype(P::kTileChains)>>
    : std::integral_constant<int, 32 * P::kTileChains> {};

// sum_d a_d b_d over the chain's row
template <class T, int NV>
__device__ __forceinline__ float dot(T& t, const float (&a)[NV],
                                     const float (&b)[NV]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) s = add(s, mul(a[k], b[k]));
  return t.sum(s);
}

// One chain's two checkpoint stacks [md, D] in bytes, float32 or (bf16)
// bfloat16, rounded up to STACK_ALIGN so that what follows stays aligned
__host__ __device__ constexpr int64_t stack_bytes(int D, int md, bool bf16) {
  return (2 * (int64_t)md * D * (bf16 ? 2 : 4) + STACK_ALIGN - 1) /
         STACK_ALIGN * STACK_ALIGN;
}

// A stack entry's store (a bfloat16 one rounds to nearest even) and load
// (a bfloat16 one widens back), by the entry's type
__device__ __forceinline__ void store_as(float& dst, float v) { dst = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16& dst, float v) {
  dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float load_as(float v) { return v; }
__device__ __forceinline__ float load_as(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A physics' data: up to three [D] rows, two scalars, a [D, D] matrix, an
// [n_obs, D] observation matrix (row-major: observation-major) and two
// [n_obs] observation rows, in the order of ops/tile_physics.py's Spec
// (rows, scalars, matrix, observation matrix and rows), and the dimension
struct PhysicsData {
  const float* row[3];
  float scalar[2];
  const float* mat;
  const float* obs_mat;
  const float* obs_row[2];
  int64_t n_obs;
  int D;
};

struct Args {
  const float* q0;       // [C, D] start of the sweep (may alias a row block
                         // of q_out: each warp reads its row before writing)
  const float* p0;       // [K, C, D] momentum, or the momentum's scale:
                         // the [D] sqrt-mass row, [D, D] mass_chol^T dense
  const float* eps;      // [C]
  const int32_t* dirs;   // [K, C] direction words (unused when refreshing)
  const int32_t* valid;  // [C] or null (every row valid)
  const int64_t* key;    // [2] launch key (unused when nothing is drawn)
  const float* unif;     // [K, n_unif, C] or null (drawn here)
  PhysicsData pd;
  const float* minv;     // [D], or [D, D] dense
  float* q_out;          // [K, C, D]
  float* logp_out;       // [K, C]
  float* grad_out;       // [C, D], after the last transition
  float* energy_out;     // [K, C]
  float* lsa_out;        // [K, C]
  int32_t* term_out;     // [K, C] ...
  int32_t* tl_out;
  int32_t* tr_out;
  int32_t* depth_out;
  int32_t* steps_out;
  int64_t C;
  int D, md, n_sweep, refresh;
  int ckpt_bf16;         // 1: bfloat16 checkpoint stacks
  float min_delta;
  int path;              // the staged products' path (Plan), and its ring's
  int ring_stages, ring_rows;  // stages and rows a panel
};

// Chains a block of the one-warp form holds: MAX_WARPS, fewer where their
// stacks would pass SMEM_LIMIT
inline int narrow_warps(int64_t per_warp) {
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_LIMIT) --warps;
  return warps;
}

// The wide form's dynamic shared memory (its bound, ops/tree.py::takes):
// the stacks, the scratch of the row sums, the mat-vec's two staging rows
__host__ __device__ constexpr int64_t wide_bytes(int D, int md, bool bf16) {
  return stack_bytes(D, md, bf16) +
         (int64_t)sizeof(float) * (WIDE_SCRATCH + 2 * (int64_t)D);
}

// The staged [D, D] products (the comment at the top of this file, "The
// dense metric") use the bulk copies of bulk_copy.cuh.

// n floats from src (device memory) to dst (shared memory), both 16-byte
// aligned, completed on bar (one arrival): the floats up to the last
// multiple of four by one bulk copy, the at most three after them by the
// calling thread before its arrival, which releases them to the waiters
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        int64_t n, uint64_t* bar) {
  const int64_t bulk = n & ~(int64_t)3;
  for (int64_t t = bulk; t < n; ++t) dst[t] = __ldg(src + t);
  bar_expect(bar, 4u * (unsigned)bulk);
  if (bulk) bulk_copy(dst, src, 4u * (unsigned)bulk, bar);
}

// The block's dynamic shared memory, as the staged products address it
// (every extern __shared__ array starts at the same address: the kernel's
// smem)
extern __shared__ __align__(16) unsigned char staged_smem[];

// A matrix of the products: g in device memory, and which of a launch's
// staged matrices it is (its slot among the resident copies: M^-1 first,
// then mass_chol^T under refresh, then the physics' own)
enum MatKind { MAT_MINV = 0, MAT_SCALE = 1, MAT_OWN = 2 };
struct Mat {
  const float* g;
  int kind;
  // the register path's view (Warp::matvec, Block::matvec): the matrix in
  // device memory
  __device__ __forceinline__ operator const float*() const { return g; }
};

// The staged regions' bytes
__host__ __device__ constexpr int64_t round16(int64_t b) {
  return (b + 15) / 16 * 16;
}
__host__ __device__ constexpr int64_t mat_bytes(int D) {
  return round16(4 * (int64_t)D * D);
}
__host__ __device__ constexpr int64_t vrow_bytes(int D) {
  return round16(4 * (int64_t)D);
}
__host__ __device__ constexpr int64_t ring_bytes(int D, int S, int R) {
  return 4 * (int64_t)S * R * D;
}
// a ring and its S barriers
__host__ __device__ constexpr int64_t ring_region(int D, int S, int R) {
  return ring_bytes(D, S, R) + round16(8 * (int64_t)S);
}

// Panel p of g (rows [p R, min(p R + R, D))) into stage s of the ring
// `buf` of R-row stages, on its barrier full[s], by the one issuing thread
__device__ __forceinline__ void issue_panel(float* buf, uint64_t* full,
                                            int R, const float* g, int D,
                                            int p, int s) {
  copy_in(buf + (int64_t)s * R * D, g + (int64_t)p * R * D,
          (int64_t)min(R, D - p * R) * D, full + s);
}

// The one-warp form's team with staged products: its matvec(Mat, D, v,
// out) reads the matrix from shared memory, resident or streamed through
// the warp's ring by the launch's path (or, on the register path, runs
// Warp's own).  What it keeps is four words, so that the registers of the
// register path and of the physics stay free: cfg (the path, the ring's
// stages S and rows R, the physics' matrix's slot), the byte offsets in
// shared memory of the resident matrices or the warp's ring and of its
// vector row, and rph (bit s the parity of ring stage s's next completion,
// the same on every lane).
struct Staged : Warp {
  uint32_t cfg = PATH_REGISTER;  // path | S << 2 | own slot << 6 | R << 8
  uint32_t off = 0, voff = 0, rph = 0;

  __device__ __forceinline__ explicit Staged(float* s) : Warp(s) {}

  template <int NV>
  __device__ __forceinline__ void matvec(Mat m, int D, const float (&v)[NV],
                                         float (&out)[NV]) {
    const int path = cfg & 3u;
    if (path == PATH_REGISTER) {
      Warp::matvec(m.g, D, v, out);
      return;
    }
    const bool streamed = path == PATH_RING;
    const int S = (cfg >> 2) & 15u, R = cfg >> 8;
    float* buf = reinterpret_cast<float*>(staged_smem + off);
    uint64_t* full =
        reinterpret_cast<uint64_t*>(staged_smem + off + ring_bytes(D, S, R));
    // the vector in the warp's row of shared memory, and the first S panels
    // on their way: the __syncwarp orders every lane's reads of the last
    // product's stages and vector before them
    float* vs = reinterpret_cast<float*>(staged_smem + voff);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (lane + 32 * k < D) vs[lane + 32 * k] = v[k];
    __syncwarp();
    const int np = streamed ? (D + R - 1) / R : 1;
    if (streamed && lane == 0)
      for (int p = 0; p < min(S, np); ++p)
        issue_panel(buf, full, R, m.g, D, p, p);
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.f;
    const int slot = m.kind == MAT_OWN ? (int)((cfg >> 6) & 3u) : m.kind;
    const float* row = buf + slot * (mat_bytes(D) / 4) + lane;
    int i = 0, s = 0;
    for (int p = 0; p < np; ++p) {
      if (streamed) {
        bar_wait(full + s, (rph >> s) & 1u);
        rph ^= 1u << s;
        row = buf + (int64_t)s * R * D + lane;
      }
      const int end = streamed ? min(i + R, D) : D;
#pragma unroll 4
      for (; i < end; ++i, row += D) {
        const float vi = vs[i];
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (lane + 32 * k < D) acc[k] = add(acc[k], mul(row[32 * k], vi));
      }
      if (streamed) {
        // the stage read by the warp: refilled with panel p + S
        __syncwarp();
        if (lane == 0 && p + S < np)
          issue_panel(buf, full, R, m.g, D, p + S, s);
        s = s + 1 == S ? 0 : s + 1;
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) out[k] = lane + 32 * k < D ? acc[k] : 0.f;
  }
};

// The wide form's products on a thread-block cluster (the paths
// PATH_CLUSTER.. : K = 4 or 8 blocks a chain on neighbouring SMs).  A
// chain's [D, D] product is split by output columns: block r of the
// cluster sums columns [r wk, r wk + wk) (wk = panel_cols(D, K)), each over
// i = 0 .. D-1 in order with the register path's mul and add, so the
// outputs are the register path's bit for bit whatever K.  Block rank 0,
// the leader, runs the chain's tree as Block does (its stacks, row sums
// and barriers unchanged); ranks 1 .. K-1, the helpers, hold no chain state
// and serve the leader's products until it is done (serve).  The wrapper
// packs each matrix once into K column panels [K, D, wk] (ops/tree.py::
// cluster_panels; columns past D zero), and each block streams its own
// panel through its own ring of CLUSTER_STAGES stages of R rows by the
// copy unit's bulk copies, one issuing thread and a `full` mbarrier per
// stage, a stage refilled after the block's __syncthreads: every handshake
// stays within one block, none spans the chain's blocks.  A product:
//  1. every block's first panels are on their way (start: those guessed
//     and issued after the last product, or, where the guess was another
//     matrix, issued now after the guessed ones have landed); the leader
//     stages v in its shared memory (stage[0, D)) and writes the matrix's
//     kind into every block's command word (distributed shared memory);
//  2. a cluster barrier (release / acquire);
//  3. each helper copies v from the leader's shared memory into its own;
//     every block sums its columns and stores them into the leader's
//     stage[D, 2D);
//  4. a cluster barrier; the leader's threads read their coordinates back,
//     and every block issues the first panels of its guess of the next
//     product's matrix (guess: the one of three products ago).
// Every block reaches every cluster barrier: the leader calls matvec from
// the team's uniform code (an invalid row still takes its start's
// products), a helper's loop ends only on the leader's command after its
// last product (finish: CMD_DONE), and a final barrier keeps the leader's
// shared memory until every helper has read that command; a helper's own
// shared memory is read by no other block.  The ring sits after the wide
// form's shared memory (cluster_base) in every block of the cluster.
__host__ __device__ constexpr int cluster_size(int path) {
  return path >= PATH_CLUSTER ? 4 << (path - PATH_CLUSTER) : 1;
}
__host__ __device__ constexpr int panel_cols(int D, int K) {
  return ((D + K - 1) / K + 3) / 4 * 4;
}
__host__ __device__ constexpr int64_t cluster_base(int D, int md, bool bf16) {
  return round16(wide_bytes(D, md, bf16));
}

// a barrier of every thread of the cluster: what a thread wrote before it
// is seen by every thread of the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
// the block's rank in its cluster
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// p, an address in this block's shared memory, at the same place in the
// shared memory of the cluster's block r (distributed shared memory)
template <class V>
__device__ __forceinline__ V* in_rank(V* p, unsigned r) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(r));
  return reinterpret_cast<V*>(q);
}

// a float and four floats (16-byte aligned) at a shared-memory address:
// shared-memory loads with 32-bit addresses (a generic pointer costs each
// load its own address arithmetic), issued in program order, so that a
// batch's loads all go out before its first use
__device__ __forceinline__ float lds(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
  return x;
}
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(a));
  return x;
}

struct Cluster : Block {
  static constexpr bool kCluster = true;
  int K = 1, S = 0, R = 0, wk = 0;
  unsigned rank = 0, rph = 0;  // rph: bit s the parity of stage s's next
  float* ring = nullptr;       // completion
  uint64_t* full = nullptr;
  int pend = -1;     // the matrix whose first panels are on their way
  unsigned hist = 0; // the last three products' matrices, 2 bits each
  const float* mats[3] = {nullptr, nullptr, nullptr};  // by MatKind

  __device__ __forceinline__ explicit Cluster(float* s) : Block(s) {}

  __device__ __forceinline__ int* command() {
    return reinterpret_cast<int*>(scratch) + CMD_SLOT;
  }

  // the launch's cluster, the block's ring and its barriers (every block);
  // the packed panels of M^-1 (dense), mass_chol^T (dense, refresh) and
  // the physics' own matrix
  __device__ __forceinline__ void setup(const Args& a, unsigned char* smem,
                                        bool dense) {
    K = cluster_size(a.path);
    S = a.ring_stages;
    R = a.ring_rows;
    wk = panel_cols(a.D, K);
    rank = cluster_rank();
    unsigned char* at = smem + cluster_base(a.D, a.md, a.ckpt_bf16 != 0);
    full = reinterpret_cast<uint64_t*>(at);
    ring = reinterpret_cast<float*>(at + round16(8 * (int64_t)S));
    mats[MAT_MINV] = dense ? a.minv : nullptr;
    mats[MAT_SCALE] = dense && a.refresh ? a.p0 : nullptr;
    mats[MAT_OWN] = a.pd.mat;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) bar_init(full + s, 1);
      bar_init_fence();
    }
    __syncthreads();
    cluster_sync();  // every block runs before any reaches into another
  }

  // rows [p R, min(p R + R, D)) of the block's panel of g into stage s
  __device__ __forceinline__ void issue(const float* g, int D, int p, int s) {
    const int i0 = p * R;
    const unsigned bytes = 4u * (unsigned)(min(R, D - i0) * wk);
    bar_expect(full + s, bytes);
    bulk_copy(ring + (int64_t)s * R * wk,
              g + ((int64_t)rank * D + i0) * wk, bytes, full + s);
  }
  // the first S panels of a product on their way (thread 0)
  __device__ __forceinline__ void prefetch(const float* g, int D) {
    if (threadIdx.x != 0) return;
    const int np = (D + R - 1) / R;
    for (int p = 0; p < min(S, np); ++p) issue(g, D, p, p);
  }
  // the panels of a product of matrix `kind` on their way: those prefetched
  // after the last product if it guessed this matrix; else the guessed
  // ones are waited for (no copy may be left landing in a stage) and this
  // matrix's issued.  The __syncthreads: every thread has seen the guessed
  // copies complete before their barriers are armed again.
  __device__ __forceinline__ void start(int kind, int D) {
    if (pend != kind) {
      drain(D);
      prefetch(mats[kind], D);
    }
    pend = -1;
    hist = ((hist << 2) | (unsigned)kind) & 63u;
  }
  // the guess for the next product: the matrix of three products ago (a
  // dense metric's leaf under the dense Gaussian takes M^-1, P, M^-1; every
  // other leaf one matrix), its first panels issued now, while the leader
  // works on the tree
  __device__ __forceinline__ void guess(int D) {
    pend = (int)((hist >> 4) & 3u);
    if (mats[pend] == nullptr) {
      pend = -1;
      return;
    }
    prefetch(mats[pend], D);
  }
  // wait for the guessed panels still landing (before a wrong guess is
  // replaced, and before the block leaves)
  __device__ __forceinline__ void drain(int D) {
    if (pend < 0) return;
    const int np = (D + R - 1) / R;
    for (int p = 0; p < min(S, np); ++p) {
      bar_wait(full + p, (rph >> p) & 1u);
      rph ^= 1u << p;
    }
    pend = -1;
    __syncthreads();
  }

  // rows [0, n) of a stage (row: the shared-memory address of this
  // thread's first column in the stage's first row; vp: of v at the
  // stage's first row) into the thread's nc <= NC column sums: batches of
  // ROW_BATCH rows whose loads all go out before their products (a batch
  // waits for shared memory once, not once a row; v by 16-byte loads: a
  // stage's first row is a multiple of ROW_BATCH, cluster_fit), then the
  // rows after the batches one by one; each column's products and sums in
  // row order
  template <int NC>
  __device__ __forceinline__ void walk(uint32_t row, uint32_t vp, int n,
                                       int nc,
                                       float (&acc)[MAX_PANEL_COLS]) const {
    const uint32_t rs = 4u * (uint32_t)wk, cs = 4u * blockDim.x;
    int i = 0;
    for (; i + ROW_BATCH <= n;
         i += ROW_BATCH, row += ROW_BATCH * rs, vp += 4 * ROW_BATCH) {
      float vv[ROW_BATCH];
#pragma unroll
      for (int r = 0; r < ROW_BATCH; r += 4) {
        const float4 v4 = lds4(vp + 4 * r);
        vv[r] = v4.x;
        vv[r + 1] = v4.y;
        vv[r + 2] = v4.z;
        vv[r + 3] = v4.w;
      }
      float m[ROW_BATCH][NC];
#pragma unroll
      for (int r = 0; r < ROW_BATCH; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          m[r][j] = j < nc ? lds(row + r * rs + j * cs) : 0.f;
#pragma unroll
      for (int r = 0; r < ROW_BATCH; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          if (j < nc) acc[j] = add(acc[j], mul(m[r][j], vv[r]));
    }
    for (; i < n; ++i, row += rs, vp += 4) {
      const float vi = lds(vp);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (j < nc) acc[j] = add(acc[j], mul(lds(row + j * cs), vi));
    }
  }

  // the block's columns of v M (v in this block's shared memory, vs) into
  // dst, the leader's stage[D, 2D): thread t sums columns t + j blockDim.x
  // of the panel (nc of them), rows in order, a stage of the ring at a time
  __device__ __forceinline__ void columns(const float* g, int D,
                                          const float* vs, float* dst) {
    const int T = blockDim.x, t = threadIdx.x;
    const int cols = min(wk, D - (int)rank * wk);
    const int most = (cols + T - 1) / T;  // the block's most a thread
    const int nc = cols > t ? (cols - t + T - 1) / T : 0;
    const int np = (D + R - 1) / R;
    float acc[MAX_PANEL_COLS];
#pragma unroll
    for (int j = 0; j < MAX_PANEL_COLS; ++j) acc[j] = 0.f;
    int s = 0;
    for (int p = 0; p < np; ++p) {
      bar_wait(full + s, (rph >> s) & 1u);
      rph ^= 1u << s;
      const int i0 = p * R, n = min(R, D - i0);
      const uint32_t row = smem_addr(ring + (int64_t)s * R * wk + t);
      const uint32_t vp = smem_addr(vs + i0);
      if (most <= 1)
        walk<1>(row, vp, n, nc, acc);
      else if (most <= 2)
        walk<2>(row, vp, n, nc, acc);
      else
        walk<MAX_PANEL_COLS>(row, vp, n, nc, acc);
      // the block has read stage s: refilled with panel p + S
      __syncthreads();
      if (t == 0 && p + S < np) issue(g, D, p + S, s);
      s = s + 1 == S ? 0 : s + 1;
    }
#pragma unroll
    for (int j = 0; j < MAX_PANEL_COLS; ++j)
      if (j < nc) dst[(int)rank * wk + t + j * T] = acc[j];
  }

  // the command `kind` to every block (each its own copy, in its scratch),
  // by the leader before the barrier that publishes it
  __device__ __forceinline__ void post(int kind) {
    if (threadIdx.x < (unsigned)K)
      *in_rank(command(), threadIdx.x) = kind;
  }

  // the leader's product out = v M (out may alias v): v in its stage[0,
  // D), which each helper copies, then every block's columns into the
  // leader's stage[D, 2D)
  template <int NV>
  __device__ __forceinline__ void matvec(Mat m, int D, const float (&v)[NV],
                                         float (&out)[NV]) {
    float* vs = stage;
    float* res = stage + D;
    start(m.kind, D);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = base + lane + 32 * k;
      if (d < D) vs[d] = v[k];
    }
    post(m.kind);
    cluster_sync();  // v and the command reach every block
    columns(mats[m.kind], D, vs, res);
    cluster_sync();  // every block's columns in res
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = base + lane + 32 * k;
      out[k] = d < D ? res[d] : 0.f;
    }
    guess(D);
  }

  // a helper: the leader's products until its command is CMD_DONE
  __device__ __forceinline__ void serve(int D) {
    const volatile int* cmd = command();
    const float* lead_v = in_rank(stage, 0);
    float* lead_res = in_rank(stage + D, 0);
    for (;;) {
      cluster_sync();  // the command in this block's shared memory
      const int kind = *cmd;
      if (kind == CMD_DONE) break;
      start(kind, D);
      // v from the leader into this block's stage[0, D): every remote load
      // out before the stores (D <= 8 blockDim.x)
      float v8[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = threadIdx.x + r * blockDim.x;
        v8[r] = i < D ? lead_v[i] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = threadIdx.x + r * blockDim.x;
        if (i < D) stage[i] = v8[r];
      }
      __syncthreads();
      columns(mats[kind], D, stage, lead_res);
      cluster_sync();
      guess(D);
    }
    drain(D);
    cluster_sync();
  }

  // the leader, after its last product: the helpers leave, and the leader
  // after every helper has read the command
  __device__ __forceinline__ void finish(int D) {
    drain(D);
    post(CMD_DONE);
    cluster_sync();
    cluster_sync();
  }
};

// The plan of a launch's staged products: the path, the chains of a block
// of the one-warp form (warps), the ring's stages and rows a panel, and the
// block's dynamic shared memory.  The one-warp form's staged instantiations
// hold 128 registers a thread at D <= 128 and 255 above (so 16 and 8 warps
// an SM), as the register path does; the wide form's 255.
struct Plan {
  int path, warps, stages, rows;
  int64_t bytes;
};

// Rows of a panel whose bytes are a multiple of 16
__host__ __device__ constexpr int align_rows(int D) {
  return D % 4 == 0 ? 1 : D % 2 == 0 ? 2 : 4;
}
inline int reg_warps(int D) { return D > 128 ? 8 : 16; }
inline int blocks_by_smem(int64_t bytes) {
  return (int)(SM_SMEM / (bytes + BLOCK_RESERVED));
}
// The ring for `room` bytes: the most rows a panel (a multiple of
// align_rows, at most D) with two stages, and as many stages of it as fit
// (at most MAX_STAGES); stages 0 where two stages of align_rows rows do
// not fit.  Each panel costs its team a handshake with the copy unit, so
// the fewest, largest panels go fastest (on the card the ring's time did
// not move with its depth, 2 to 8 stages, and fell with its rows a panel).
inline void ring_fit(int D, int64_t room, int* S, int* R) {
  const int unit = align_rows(D);
  int64_t r = room / (2 * 4LL * D) / unit * unit;
  if (r > D) r = (D + unit - 1) / unit * unit;
  *R = r >= unit ? (int)r : unit;
  const int64_t s = r >= unit ? room / (4LL * r * D) : 0;
  *S = s >= 2 ? (int)(s < MAX_STAGES ? s : MAX_STAGES) : 0;
}

// Whether an instantiation stages its [D, D] products: the one-warp form
// with a dense M^-1 or a physics' own matrix, for a physics whose products
// the card measured faster staged (P::kStaging; not eight schools' or
// logistic regression's, whose leaves the product does not set)
template <class T, class P, bool kDense>
constexpr bool kStagedOf =
    (kDense || P::kMatrix) && !T::kWide && P::kStaging;

// The transition of one chain by the team T (Warp: a chain per warp, up to
// MAX_WARPS a block; Block: a chain per block of up to MAX_WIDE_WARPS;
// Cluster: a chain per cluster of such blocks, the tree on block rank 0,
// the other blocks serving its products until it is done; Tile: a tile of
// chains, a warp each, in lockstep).
// Every branch depends on values that are the same on every thread of the
// team (its sums), so every thread of a block reaches every barrier.
// A launch of the one-warp form with a [D, D] matrix (a dense M^-1, or a
// physics' own) stages its products (Staged, kStagedOf); its blocks hold up
// to MAX_STAGED_WARPS chains at 128 registers a thread (D <= 128), 8 at 255.
//
// The tile form (T = Tile) runs the one-warp form's arithmetic for each
// chain, with the control flow of the TPU kernel's tile (tree_pallas.py's
// leaf_body, :254-275, and guarded_leaf, :437-447): the doubling loop and
// the leaf loop go round while any chain of the tile is alive (the block's
// vote, Tile::any), and a chain that has diverged, turned or terminated,
// or that never started (valid = 0, or a row past C in the last tile),
// goes round them with its updates masked (`live`, `on`): it draws no
// uniform, counts no step and changes no record, and it takes part in
// every value_grad of the tile (the transition's start, each leaf, the
// final gradient), whose result for it is ignored.  A draw depends on
// (chain, s, stream, slot) only, so every chain's records and draws are
// those of the one-warp form.  Barriers: every __syncthreads of the tile
// form (the votes, and those inside the physics' value_grad) is reached by
// every thread of the block on every path: the votes' results are the
// same on every thread, the leaf and doubling loops end only on them, the
// sweep loop's count is the launch's, and no thread of a tile leaves early
// (the `return` past C is the other forms').
template <class T, class P, bool kDense>
__global__ void __launch_bounds__(
    T::kWide                     ? 32 * MAX_WIDE_WARPS
    : T::kTile                   ? TileThreads<P>::value
    : kStagedOf<T, P, kDense>    ? 32 * (P::kNV > 4 ? 8 : MAX_STAGED_WARPS)
                                 : 32 * MAX_WARPS,
    T::kWide || T::kTile || P::kNV > 4 || kStagedOf<T, P, kDense> ? 1 : 4)
tree_kernel(const Args a) {
  constexpr int NV = P::kNV;
  constexpr bool kStaged = kStagedOf<T, P, kDense>;
  using Team = std::conditional_t<kStaged, Staged, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c =
      T::kCluster ? (int64_t)(blockIdx.x / cluster_size(a.path))
      : T::kWide  ? (int64_t)blockIdx.x
                  : (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  // the resident matrices (M^-1, mass_chol^T under refresh, the physics'
  // own: the slots of MatKind, the last the own slot) after the block's
  // stacks and vector rows, their barrier after them, copied in by thread
  // 0 before any warp of a partial last block leaves
  if constexpr (kStaged) {
    if (a.path == PATH_RESIDENT && threadIdx.x == 0) {
      const int64_t mb = mat_bytes(a.D);
      unsigned char* at =
          smem + (blockDim.x >> 5) * (stack_bytes(a.D, a.md, a.ckpt_bf16 != 0)
                                      + vrow_bytes(a.D));
      const int own = kDense ? 1 + (a.refresh != 0) : 0;
      uint64_t* bar = reinterpret_cast<uint64_t*>(at + (own + P::kMatrix) * mb);
      bar_init(bar, own + P::kMatrix);
      bar_init_fence();
      const int64_t n = (int64_t)a.D * a.D;
      if (kDense) copy_in(reinterpret_cast<float*>(at), a.minv, n, bar);
      if (kDense && a.refresh)
        copy_in(reinterpret_cast<float*>(at + mb), a.p0, n, bar);
      if (P::kMatrix)
        copy_in(reinterpret_cast<float*>(at + own * mb), a.pd.mat, n, bar);
    }
    if (a.path == PATH_RESIDENT) __syncthreads();
  }
  // a row of the tile form's last tile past C stays, inactive: it reads
  // none of the chains' arrays and writes nothing
  const bool real = !T::kTile || c < a.C;
  if constexpr (!T::kTile)
    if (c >= a.C) return;  // the whole warp (team) leaves together
  const int64_t C = a.C;
  const int D = a.D, md = a.md;
  const int n_unif = (1 << md) - 1 + md;

  // the team's stacks: one region per warp of the block, or the block's
  // one region followed by its scratch
  const bool bf16 = a.ckpt_bf16 != 0;
  const int64_t stack_len = stack_bytes(D, md, bf16);
  unsigned char* stk_s = smem + (T::kWide ? 0 : warp * stack_len);
  unsigned char* stk_ps = stk_s + (int64_t)md * D * (bf16 ? 2 : 4);
  Team team(reinterpret_cast<float*>(smem + stack_len));
  if constexpr (T::kCluster) {
    // every block of the chain's cluster: its ring; the helpers serve the
    // leader's products and leave
    team.setup(a, smem, kDense);
    if (team.rank != 0) {
      team.serve(D);
      return;
    }
  }
  if constexpr (kStaged) {
    // each warp's vector row after the block's stacks, then the resident
    // matrices, or each warp's ring and its barriers
    const int own = kDense ? 1 + (a.refresh != 0) : 0;
    team.cfg = a.path | a.ring_stages << 2 | own << 6 | a.ring_rows << 8;
    const int w = blockDim.x >> 5;
    const int64_t rows = w * stack_len;
    team.voff = rows + warp * vrow_bytes(D);
    if (a.path == PATH_RESIDENT) {
      team.off = rows + w * vrow_bytes(D);
      bar_wait(reinterpret_cast<uint64_t*>(
                   smem + team.off + (own + P::kMatrix) * mat_bytes(D)),
               0);
    } else if (a.path == PATH_RING) {
      const int S = a.ring_stages;
      team.off = rows + w * vrow_bytes(D) +
                 warp * ring_region(D, S, a.ring_rows);
      uint64_t* full = reinterpret_cast<uint64_t*>(
          smem + team.off + ring_bytes(D, S, a.ring_rows));
      if (lane == 0) {
        for (int s = 0; s < S; ++s) bar_init(full + s, 1);
        bar_init_fence();
      }
      __syncwarp();
    }
  }
  const int base = team.base;
  if constexpr (T::kTile) {
    team.region = (uint32_t)((blockDim.x >> 5) * stack_len);
    team.stages = a.ring_stages;
    team.batch = a.ring_rows;
  }

  const Key key = a.key ? Key{(uint32_t)a.key[0], (uint32_t)a.key[1]}
                        : Key{0u, 0u};
  const bool valid = real && (a.valid == nullptr || a.valid[c] != 0);
  const float eps = real ? a.eps[c] : 0.f;

  bool in[NV];
  float minv[NV];
  float lq[NV], lp[NV], lg[NV], rq[NV], rp[NV], rg[NV];  // trajectory ends
  float cq[NV], cp[NV], cg[NV];                          // subtree frontier
  float psl[NV], psr[NV], rho[NV], scum[NV], propq[NV], subq[NV];
  const int64_t row = c * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = base + lane + 32 * k;
    in[k] = real && d < D;
    minv[k] = (in[k] && !kDense) ? a.minv[d] : 0.f;
    propq[k] = in[k] ? a.q0[row + d] : 0.f;  // the sweep's carry
  }
  P phys;
  phys.load(a.pd, in, team);

  for (int s = 0; s < a.n_sweep; ++s) {
    // the transition's start: the carry, its log density and gradient, and
    // its momentum
    const float logp0 = phys.value_grad(propq, lg, team);
    float kin_part = 0.f;
    if constexpr (kDense) {
      float pv[NV];  // xi under refresh, then the momentum xi mass_chol^T
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int d = base + lane + 32 * k;
        pv[k] = !in[k]     ? 0.f
                : a.refresh ? draw_normal(key, (uint32_t)c, s, d)
                            : a.p0[((int64_t)s * C + c) * D + d];
      }
      if (a.refresh) team.matvec(Mat{a.p0, MAT_SCALE}, D, pv, pv);
      team.matvec(Mat{a.minv, MAT_MINV}, D, pv, psl);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        lq[k] = rq[k] = subq[k] = cq[k] = propq[k];
        lp[k] = rp[k] = rho[k] = cp[k] = pv[k];
        rg[k] = cg[k] = lg[k];
        psr[k] = psl[k];
        kin_part = add(kin_part, mul(pv[k], psl[k]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int d = base + lane + 32 * k;
        float p = 0.f;
        if (in[k])
          p = a.refresh ? mul(a.p0[d], draw_normal(key, (uint32_t)c, s, d))
                        : a.p0[((int64_t)s * C + c) * D + d];
        lq[k] = rq[k] = subq[k] = cq[k] = propq[k];
        lp[k] = rp[k] = rho[k] = cp[k] = p;
        rg[k] = cg[k] = lg[k];
        psl[k] = psr[k] = mul(minv[k], p);
        kin_part = add(kin_part, mul(mul(p, minv[k]), p));
      }
    }
    const float pi0 = sub(logp0, mul(0.5f, team.sum(kin_part)));
    const uint32_t dirs = a.refresh ? draw_direction(key, (uint32_t)c, s)
                          : real    ? (uint32_t)a.dirs[(int64_t)s * C + c]
                                    : 0u;
    const float* unif_s = a.unif ? a.unif + (int64_t)s * n_unif * C : nullptr;
    auto uniform = [&](int slot) -> float {
      return unif_s ? unif_s[(int64_t)slot * C + c]
                    : draw_uniform(key, (uint32_t)c, s, slot);
    };

    float omega = 0.f, prop_delta = 0.f, prop_logp = logp0;
    float sub_delta = 0.f, sub_logp = logp0, sum_alpha = 0.f;
    int i_left = 0, i_right = 0, steps = 0, depth = 0;
    int term = TERM_MAX_DEPTH, tl = 1, tr = 0;  // REACHED_MAX_DEPTH (1, 0)

    bool live = valid;  // the tile form: the chain's tree goes on
    for (int d = 0; (T::kTile || valid) && d < md; ++d) {
      if constexpr (T::kTile)
        if (!team.any(live)) break;
      const bool isf = (dirs >> d) & 1u;
      const int signi = isf ? 1 : -1;
      const float eps_signed = mul(isf ? 1.f : -1.f, eps);
      const float half = mul(0.5f, eps_signed);
      const int i_base = isf ? i_right : i_left;
      const int n_leaves = 1 << d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        cq[k] = isf ? rq[k] : lq[k];
        cp[k] = isf ? rp[k] : lp[k];
        cg[k] = isf ? rg[k] : lg[k];
        scum[k] = 0.f;
      }
      float omega_sub = -INFINITY;
      bool died_div = false, died_turn = false;
      int die_l = 0, die_r = 0;

      for (int n = 0; n < n_leaves; ++n) {
        // the tile form: the chain's subtree goes on (a chain whose subtree
        // or tree has ended takes the leaf masked)
        const bool on = !T::kTile || (live && !died_div && !died_turn);
        if constexpr (T::kTile)
          if (!team.any(on)) break;
        // the leaf's proposal uniform, drawn before the leapfrog so that the
        // generator's registers are free again when the leaf's are live
        const float log_u = on ? logf(uniform(n_leaves - 1 + n)) : 0.f;
        // leapfrog leaf
        float qn[NV], pn[NV], gn[NV], psn[NV];
        float logp_new, kin_leaf = 0.f;
        if constexpr (P::kFusedGaussian && !kDense) {
          float lp_part = 0.f;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const float p_mid = add(cp[k], mul(half, cg[k]));
            qn[k] = add(cq[k], mul(eps_signed, mul(minv[k], p_mid)));
            const float lqn = mul(phys.lam[k], qn[k]);
            gn[k] = -lqn;
            pn[k] = add(p_mid, mul(half, gn[k]));
            psn[k] = mul(minv[k], pn[k]);
            lp_part = add(lp_part, mul(lqn, qn[k]));
            kin_leaf = add(kin_leaf, mul(mul(pn[k], minv[k]), pn[k]));
          }
          logp_new = mul(-0.5f, team.sum(lp_part));
        } else {
          float p_mid[NV];
          if constexpr (kDense) {
#pragma unroll
            for (int k = 0; k < NV; ++k)
              p_mid[k] = add(cp[k], mul(half, cg[k]));
            team.matvec(Mat{a.minv, MAT_MINV}, D, p_mid, qn);  // Minv p_mid
#pragma unroll
            for (int k = 0; k < NV; ++k)
              qn[k] = add(cq[k], mul(eps_signed, qn[k]));
          } else {
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              p_mid[k] = add(cp[k], mul(half, cg[k]));
              qn[k] = add(cq[k], mul(eps_signed, mul(minv[k], p_mid[k])));
            }
          }
          logp_new = phys.value_grad(qn, gn, team);
          if constexpr (kDense) {
#pragma unroll
            for (int k = 0; k < NV; ++k)
              pn[k] = add(p_mid[k], mul(half, gn[k]));
            team.matvec(Mat{a.minv, MAT_MINV}, D, pn, psn);
#pragma unroll
            for (int k = 0; k < NV; ++k)
              kin_leaf = add(kin_leaf, mul(pn[k], psn[k]));
          } else {
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              pn[k] = add(p_mid[k], mul(half, gn[k]));
              psn[k] = mul(minv[k], pn[k]);
              kin_leaf = add(kin_leaf, mul(mul(pn[k], minv[k]), pn[k]));
            }
          }
        }
        // the tile form: a chain whose subtree has ended took the leaf for
        // the tile's physics only
        if constexpr (T::kTile)
          if (!on) continue;
        const float kin_new = mul(0.5f, team.sum(kin_leaf));
        // any non-finite joint density is -inf, a NaN delta is -inf
        float joint = sub(logp_new, isfinite(kin_new) ? kin_new : INFINITY);
        if (!isfinite(joint)) joint = -INFINITY;
        float delta = sub(joint, pi0);
        if (isnan(delta)) delta = -INFINITY;
        const bool divergent = delta < a.min_delta;
        // non-finite elements fall back to the previous point before they
        // are stored (p# to 0)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (!isfinite(qn[k])) qn[k] = cq[k];
          if (!isfinite(pn[k])) pn[k] = cp[k];
          if (!isfinite(gn[k])) gn[k] = cg[k];
          if (!isfinite(psn[k])) psn[k] = 0.f;
        }
        const int i_new = i_base + (n + 1) * signi;
        sum_alpha = add(sum_alpha, expf(fminf(delta, 0.f)));
        steps += 1;

        // even leaves open nodes: store the pre-leaf momentum sum and p#
        // (the stack type's branch outside the loop over registers: the
        // float32 loop is the one it always was)
        if ((n & 1) == 0) {
          const int slot = __popc(n >> 1);
          auto store = [&](auto* s_stk, auto* ps_stk) {
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              if (in[k]) {
                store_as(s_stk[slot * D + base + lane + 32 * k], scum[k]);
                store_as(ps_stk[slot * D + base + lane + 32 * k], psn[k]);
              }
            }
          };
          if (bf16)
            store(reinterpret_cast<__nv_bfloat16*>(stk_s),
                  reinterpret_cast<__nv_bfloat16*>(stk_ps));
          else
            store(reinterpret_cast<float*>(stk_s),
                  reinterpret_cast<float*>(stk_ps));
        }
#pragma unroll
        for (int k = 0; k < NV; ++k) scum[k] = add(scum[k], pn[k]);

        // U-turn checks of the nodes this leaf closes, innermost first
        bool turning = false;
        int turn_pos = 0;
        const int t_ones = __ffs(~n) - 1;
        const int idx_max = __popc(n >> 1);
        for (int m = 0; m < t_ones; ++m) {
          const int j = idx_max - m;
          float ta = 0.f, tb = 0.f;
          auto terms = [&](const auto* s_stk, const auto* ps_stk) {
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              const float sv =
                  in[k] ? load_as(s_stk[j * D + base + lane + 32 * k]) : 0.f;
              const float ps =
                  in[k] ? load_as(ps_stk[j * D + base + lane + 32 * k]) : 0.f;
              const float rn = sub(scum[k], sv);
              ta = add(ta, mul(rn, ps));
              tb = add(tb, mul(rn, psn[k]));
            }
          };
          if (bf16)
            terms(reinterpret_cast<const __nv_bfloat16*>(stk_s),
                  reinterpret_cast<const __nv_bfloat16*>(stk_ps));
          else
            terms(reinterpret_cast<const float*>(stk_s),
                  reinterpret_cast<const float*>(stk_ps));
          team.sum2(ta, tb);
          if (ta < 0.f || tb < 0.f) {
            turning = true;
            turn_pos = i_base + (n - (2 << m) + 2) * signi;
            break;
          }
        }
        turning = turning && !divergent;

        // progressive proposal within the subtree (unbiased multinomial)
        const float omega_new = logaddexp(omega_sub, delta);
        if (!divergent) {
          if (log_u < sub(delta, omega_new)) {
#pragma unroll
            for (int k = 0; k < NV; ++k) subq[k] = qn[k];
            sub_delta = delta;
            sub_logp = logp_new;
          }
          omega_sub = omega_new;
        }
        copy(cq, qn);
        copy(cp, pn);
        copy(cg, gn);
        if constexpr (kDense) {
          // the frontier's p#, the new end's at the merge: the ends' p# are
          // read only there, and a subtree that merges ended on a finite
          // leaf, whose psn is M^-1 cp as a new product would give it
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            psr[k] = isf ? psn[k] : psr[k];
            psl[k] = isf ? psl[k] : psn[k];
          }
        }
        if (divergent) {
          died_div = true;
          die_l = die_r = i_new;
          if constexpr (!T::kTile) break;
        }
        if (turning) {  // (never when divergent)
          died_turn = true;
          die_l = min(turn_pos, i_new);
          die_r = max(turn_pos, i_new);
          if constexpr (!T::kTile) break;
        }
      }

      // merge the subtree into the trajectory (biased progressive sampling)
      const bool ok = !(died_div || died_turn);
      bool turn_top = false;
      if ((!T::kTile || live) && ok) {
        if (logf(uniform((1 << md) - 1 + d)) < sub(omega_sub, omega)) {
          copy(propq, subq);
          prop_delta = sub_delta;
          prop_logp = sub_logp;
        }
        omega = logaddexp(omega, omega_sub);
        const int i_end = i_base + n_leaves * signi;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float ps_end = kDense ? 0.f : mul(minv[k], cp[k]);
          if (isf) {
            rq[k] = cq[k]; rp[k] = cp[k]; rg[k] = cg[k];
            if (!kDense) psr[k] = ps_end;  // dense: set at the last leaf
          } else {
            lq[k] = cq[k]; lp[k] = cp[k]; lg[k] = cg[k];
            if (!kDense) psl[k] = ps_end;
          }
          rho[k] = add(rho[k], scum[k]);
        }
        if (isf) i_right = i_end; else i_left = i_end;
        depth = d + 1;
        turn_top = dot(team, rho, psl) < 0.f || dot(team, rho, psr) < 0.f;
      }
      if (died_div) term = TERM_DIVERGENCE;
      if (died_turn || turn_top) term = TERM_TURNING;
      if (!ok) {
        tl = die_l;
        tr = die_r;
        if constexpr (T::kTile) live = false; else break;
      }
      if (turn_top) {
        tl = i_left;
        tr = i_right;
        if constexpr (T::kTile) live = false; else break;
      }
    }

    const int64_t at = (int64_t)s * C + c;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (in[k]) a.q_out[at * D + base + lane + 32 * k] = propq[k];
    if (real && team.leader()) {
      a.logp_out[at] = prop_logp;
      a.energy_out[at] = add(prop_delta, pi0);
      a.lsa_out[at] = logf(sum_alpha);
      a.term_out[at] = term;
      a.tl_out[at] = tl;
      a.tr_out[at] = tr;
      a.depth_out[at] = depth;
      a.steps_out[at] = steps;
    }
  }

  // the final proposal's gradient (lg is free again)
  phys.value_grad(propq, lg, team);
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (in[k]) a.grad_out[row + base + lane + 32 * k] = lg[k];
  if constexpr (T::kCluster) team.finish(D);
}

// The cluster path of K blocks (Cluster) at D, md and the stack type:
// each block's ring of CLUSTER_STAGES stages of the most rows of its panel
// that fit beside the wide form's shared memory (at most ceil(D /
// CLUSTER_STAGES): a product's panels then all go out at once), a multiple
// of ROW_BATCH where there are that many (Cluster::walk); false where
// a stage of one row does not fit or a thread would sum more than
// MAX_PANEL_COLS of a panel's columns.
inline bool cluster_fit(int D, int md, bool bf16, int K, Plan* out) {
  const int wk = panel_cols(D, K);
  const int threads = 32 * ((D + WARP_DIM - 1) / WARP_DIM);
  if ((wk + threads - 1) / threads > MAX_PANEL_COLS) return false;
  const int64_t head = cluster_base(D, md, bf16)
                       + round16(8 * (int64_t)CLUSTER_STAGES);
  int64_t r = (SMEM_LIMIT - head) / (4LL * CLUSTER_STAGES * wk);
  const int64_t most = (D + CLUSTER_STAGES - 1) / CLUSTER_STAGES;
  if (r > most) r = most;
  if (r >= ROW_BATCH) r = r / ROW_BATCH * ROW_BATCH;
  if (r < 1) return false;
  const int path = PATH_CLUSTER + (K >= 8);
  *out = {path, 1, CLUSTER_STAGES, (int)r,
          head + 4LL * CLUSTER_STAGES * r * wk};
  return true;
}

// The plan for D, md, the stack type and the n matrices a launch stages
// (M^-1 under a dense metric, mass_chol^T when it refreshes too, the
// physics' own; none where kStagedOf is false): the register path's launch
// (narrow_warps chains a block, or the wide form's one); in the one-warp
// form, the resident path where every matrix fits beside the stacks of the
// block's chains, with the fewest chains a block that put the most on an
// SM, and the ring at the register path's blocks an SM in the room they
// leave (ring_fit).  The plan's own path is resident where that fits
// (above RING_MIN_DIM only where it holds as many chains an SM as the
// ring), else the ring above RING_MIN_DIM, else the register path.
// The card's measurements set these bounds (PERF.md section 6): a panel
// costs its team a handshake with the copy unit, so at D <= 128 (rows of
// at most 512 bytes) the ring ran 1.3 to 3.2 times slower than the
// register path, and a ring over the wide form's block, whose warps also
// hand each stage back to the issuing thread, 1.25 to 3.2 times slower at
// D = 1,002; from D = 200 to 256
// it ran 1.2 to 2.1 times faster; the resident path ran faster than both
// wherever it fitted, from D = 10 (the funnel: 1.7 % faster) to D = 128
// (2.2 times, at 3 chains an SM against 16), but for the physics that
// keep the register path (kStagedOf).  The ring
// stays admitted at D <= 128 where the plan does not take it, for a
// launch that asks for it.  The wide form's own path is the register
// path; under a dense metric it admits a cluster of 4 or 8 blocks a chain
// where cluster_fit does, which the wrapper asks for where a launch waits
// on its deepest chain (ops/tree.py::cluster_of: the card measured the
// cluster faster there, and slower where many chains share the card).
// `force` (-1 for the plan's own) asks for a path: cudaErrorInvalidValue
// where the shape does not admit it (n = 0 admits the register path only;
// the wide form the register path, and its clusters under a dense
// metric).
inline cudaError_t plan_of(int D, int md, bool bf16, int n, bool dense,
                           int force, Plan* out) {
  const bool wide = D > WARP_DIM;
  const int64_t stack = stack_bytes(D, md, bf16);
  const Plan reg = wide ? Plan{PATH_REGISTER, 1, 0, 0,
                               wide_bytes(D, md, bf16)}
                        : Plan{PATH_REGISTER, narrow_warps(stack), 0, 0,
                               narrow_warps(stack) * stack};
  Plan res{-1, 0, 0, 0, 0}, ring{-1, 0, 0, 0, 0};
  int res_chains = 0, reg_chains = 0;
  if (!wide && n > 0) {
    for (int w = 1; w <= reg_warps(D); ++w) {
      const int64_t bytes = w * (stack + vrow_bytes(D)) + n * mat_bytes(D) + 16;
      if (bytes > SMEM_LIMIT) break;
      const int by_smem = blocks_by_smem(bytes);
      const int ch = w * (reg_warps(D) / w < by_smem ? reg_warps(D) / w
                                                      : by_smem);
      if (ch > res_chains) {
        res_chains = ch;
        res = {PATH_RESIDENT, w, 0, 0, bytes};
      }
    }
    const int by_regs = reg_warps(D) / reg.warps;
    const int bps = by_regs < blocks_by_smem(reg.bytes)
                        ? by_regs : blocks_by_smem(reg.bytes);
    reg_chains = reg.warps * bps;
    if (bps >= 1) {
      int64_t budget = SM_SMEM / bps - BLOCK_RESERVED;
      if (budget > SMEM_LIMIT) budget = SMEM_LIMIT;
      int S, R;
      ring_fit(D, budget / reg.warps - stack - vrow_bytes(D) - 16
                      - 8 * MAX_STAGES, &S, &R);
      const int64_t bytes =
          reg.warps * (stack + vrow_bytes(D) + ring_region(D, S, R));
      if (S >= 2 && bytes <= SMEM_LIMIT)
        ring = {PATH_RING, reg.warps, S, R, bytes};
    }
  }
  // the wide form under a dense metric: a cluster of 4 or 8 blocks a chain
  Plan clu[CLUSTER_PATHS];
  bool clu_ok[CLUSTER_PATHS] = {false, false};
  if (wide && dense && n > 0)
    for (int i = 0; i < CLUSTER_PATHS; ++i)
      clu_ok[i] = cluster_fit(D, md, bf16, 4 << i, &clu[i]);
  const bool ring_own = ring.path >= 0 && D > RING_MIN_DIM;
  if (force < 0 && wide)
    *out = reg;
  else if (force < 0)
    *out = res.path >= 0 && (!ring_own || res_chains >= reg_chains) ? res
           : ring_own                                               ? ring
                                                                    : reg;
  else if (force >= PATH_CLUSTER && force < PATH_CLUSTER + CLUSTER_PATHS &&
           clu_ok[force - PATH_CLUSTER])
    *out = clu[force - PATH_CLUSTER];
  else if (force == PATH_REGISTER)
    *out = reg;
  else if (force == PATH_RESIDENT && res.path >= 0)
    *out = res;
  else if (force == PATH_RING && ring.path >= 0)
    *out = ring;
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The tile form's plan (a physics with P::kTile): the most chains a tile
// (at most P::kTileChains), then two sets of the physics' ring of
// observation tiles before one, then the most observation tiles a batch
// (at most MAX_BATCH_TILES), whose block fits SMEM_LIMIT: the chains'
// stacks and the physics' region (P::region_bytes, for `opt`, the
// physics' option: logistic regression's grad_bf16).  The plan's warps
// are the tile's chains, its stages the ring's, its rows the observation
// tiles a batch; its path the register path (the [D, D] products of a
// dense metric read M^-1 through the read-only cache, as Warp's).
constexpr int MAX_BATCH_TILES = 4;
template <class P>
cudaError_t tile_plan_of(int D, int md, bool bf16, int opt, Plan* out) {
  const int64_t stack = stack_bytes(D, md, bf16);
  for (int tc = P::kTileChains; tc >= 1; --tc)
    for (int sets = 2; sets >= 1; --sets)
      for (int bt = MAX_BATCH_TILES; bt >= 1; --bt) {
        const int64_t bytes =
            tc * stack + P::region_bytes(D, tc, bt, sets, opt);
        if (bytes <= SMEM_LIMIT) {
          *out = {PATH_REGISTER, tc, P::ring_stages(D, bt, sets), bt, bytes};
          return cudaSuccess;
        }
      }
  return cudaErrorInvalidValue;
}

// The launch launch_physics makes: the instantiation, its grid, threads,
// dynamic shared memory and plan
struct Shape {
  void (*kernel)(const Args);
  int64_t grid;
  int threads;
  int64_t bytes;
  Plan plan;
  int cluster;  // blocks a cluster (1: no cluster)
};

// shape_of's dispatch for a physics of the tile form (P::kTile): NV by D
// (up to 256), the plan tile_plan_of, the register path only
template <template <int> class P, bool kDense>
cudaError_t tile_shape_of(int64_t C, int D, int md, bool bf16, int force,
                          int opt, Shape* s) {
  if (D > WARP_DIM || force > PATH_REGISTER) return cudaErrorInvalidValue;
  Plan pl;
  void (*kernel)(const Args);
  cudaError_t err;
  if (D <= 32) {
    err = tile_plan_of<P<1>>(D, md, bf16, opt, &pl);
    kernel = tree_kernel<Tile, P<1>, kDense>;
  } else if (D <= 64) {
    err = tile_plan_of<P<2>>(D, md, bf16, opt, &pl);
    kernel = tree_kernel<Tile, P<2>, kDense>;
  } else if (D <= 128) {
    err = tile_plan_of<P<4>>(D, md, bf16, opt, &pl);
    kernel = tree_kernel<Tile, P<4>, kDense>;
  } else {
    err = tile_plan_of<P<8>>(D, md, bf16, opt, &pl);
    kernel = tree_kernel<Tile, P<8>, kDense>;
  }
  if (err != cudaSuccess) return err;
  *s = {kernel, (C + pl.warps - 1) / pl.warps, 32 * pl.warps, pl.bytes, pl,
        1};
  if (s->grid > 0x7fffffff) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(s->kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)s->bytes);
}

// The one dispatch by D, md, the stack type and what the launch stages, for
// C chains: the one-warp form (D <= 256, NV by D) puts plan.warps chains in
// a block, the wide form (P::kWide, 256 < D <= MAX_DIM) one chain in a
// block of ceil(D / 256) warps, the tile form (P::kTile, D <= 256) a tile
// of plan.warps chains in a block (tile_plan_of, for the physics' option
// `opt`); the plan (plan_of) by shape, before the launch.
// cudaErrorInvalidValue where neither form takes the shape or the plan
// refuses `force`.
template <template <int> class P, bool kDense>
cudaError_t shape_of(int64_t C, int D, int md, bool bf16, bool refresh,
                     int force, int opt, Shape* s) {
  if constexpr (kTiledOf<P<1>>) {
    return tile_shape_of<P, kDense>(C, D, md, bf16, force, opt, s);
  } else {
    if (D > WARP_DIM && !(P<8>::kWide && D <= MAX_DIM))
      return cudaErrorInvalidValue;
    const int n = !P<1>::kStaging ? 0
                  : (kDense ? 1 + (refresh ? 1 : 0) : 0)
                        + (P<1>::kMatrix ? 1 : 0);
    Plan pl;
    cudaError_t err = plan_of(D, md, bf16, n, kDense, force, &pl);
    if (err != cudaSuccess) return err;
    if (D <= WARP_DIM) {
      void (*kernel)(const Args) = D <= 32    ? tree_kernel<Warp, P<1>, kDense>
                                   : D <= 64  ? tree_kernel<Warp, P<2>, kDense>
                                   : D <= 128 ? tree_kernel<Warp, P<4>, kDense>
                                              : tree_kernel<Warp, P<8>, kDense>;
      *s = {kernel, (C + pl.warps - 1) / pl.warps, 32 * pl.warps, pl.bytes,
            pl, 1};
    } else if constexpr (P<8>::kWide) {
      const int threads = 32 * ((D + WARP_DIM - 1) / WARP_DIM);
      if (pl.path < PATH_CLUSTER) {
        *s = {tree_kernel<Block, P<8>, kDense>, C, threads, pl.bytes, pl, 1};
      } else {
        if constexpr (kDense) {
          const int k = cluster_size(pl.path);
          *s = {tree_kernel<Cluster, P<8>, kDense>, C * k, threads, pl.bytes,
                pl, k};
        } else {
          return cudaErrorInvalidValue;  // (plan_of: a dense metric's only)
        }
      }
    }
    if (s->bytes > SMEM_LIMIT || s->grid > 0x7fffffff)
      return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(s->kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s->bytes);
  }
}

// The launch configuration of a cluster shape: its grid of clusters of
// sh.cluster blocks (the attribute in `at`, which must outlive it)
inline cudaLaunchConfig_t cluster_config(const Shape& sh, void* stream,
                                         cudaLaunchAttribute (&at)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)sh.grid);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = (size_t)sh.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)sh.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan of the launch launch_physics makes for D, md, the stack type,
// the metric form, refresh and the physics' option, with `force` as
// shape_of takes it (TREE_LAUNCHERS' tree_<name>_plan): out[0..5] the
// path, the chains a block of the one-warp form (of a tile), the ring's
// stages and rows a panel (the tile form: its ring's stages and
// observation tiles a batch), the dynamic shared memory and the blocks an
// SM holds (the CUDA occupancy calculator: registers, shared memory,
// threads)
template <template <int> class P, bool kDense>
int plan_physics(int D, int md, int ckpt_bf16, int refresh, int force,
                 int opt, int* out) {
  if (!out || D < P<1>::kMinDim || md < 1 || md > 30)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  cudaError_t err = shape_of<P, kDense>(1, D, md, ckpt_bf16 != 0,
                                        refresh != 0, force, opt, &sh);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sh.kernel, sh.threads, (size_t)sh.bytes);
  if (err == cudaSuccess && sh.cluster > 1) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg = cluster_config(sh, nullptr, at);
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)sh.kernel,
                                         &cfg);
  }
  const int vals[7] = {sh.plan.path, sh.plan.warps, sh.plan.stages,
                       sh.plan.rows, (int)sh.bytes, blocks, clusters};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// The body of every physics' extern "C" launchers (TREE_LAUNCHERS), with a
// diagonal (kDense = false) or dense (kDense = true) Minv.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).  Pointers
// are device pointers to contiguous arrays (float32 unless said).  q0 [C, D]
// is the sweep's start; it is only read, and may be the last row block of
// q_out (the carry of the previous launch).  Momentum: with refresh = 0, p0
// is [K, C, D] and dirs [K, C] int32 direction words; with refresh = 1, p0
// is the momentum's scale, the [D] sqrt-mass row (p = p0 * xi) or, dense,
// the [D, D] mass_chol^T (p = xi p0), the momentum and the direction word
// are drawn here and dirs is not read.  valid [C] int32, or null for all
// rows; key [2] int64 (the two 32-bit words of the launch); unif [K,
// n_unif, C] explicit uniforms (a test hook), or null to draw them here.
// row0..row2 [D] the physics' data rows (null where it has fewer), mat its
// [D, D] matrix (null where it has none), obs_mat its [n_obs, D]
// observation matrix and obs_row0, obs_row1 its [n_obs] observation rows
// (null and n_obs 0 where it has none), s0, s1 its scalars; minv [D], or
// [D, D] dense; ckpt_bf16 1 for bfloat16 checkpoint stacks.  Outputs: q
// [K, C, D] (q[K - 1] the final carry); logp, energy, log_sum_alpha [K,
// C]; term, term_left, term_right, depth, steps [K, C] int32; grad [C, D]
// of the final carry.  D must be in [P's least
// D, 256], or for a physics with a wide form (P::kWide) in (256, MAX_DIM]
// with wide_bytes(D, md, ckpt_bf16) <= SMEM_LIMIT; md in [1, 30], K >= 1.
// path (-1: the plan's own) asks for the staged products' path (plan_of;
// a check's hook: the sampling paths pass -1); a matrix that is staged
// (minv dense, p0 under refresh dense, mat) must start 16-byte aligned.
#define TREE_LAUNCH_PARAMS                                                  \
  const float *q0, const float *p0, const float *eps, const int32_t *dirs, \
      const int32_t *valid, const int64_t *key, const float *unif,          \
      const float *row0, const float *row1, const float *row2,              \
      const float *mat, const float *obs_mat, const float *obs_row0,        \
      const float *obs_row1, int64_t n_obs, float s0, float s1,             \
      const float *minv,                                                    \
      float *q_out, float *logp_out, float *grad_out, float *energy_out,    \
      float *lsa_out, int32_t *term, int32_t *tl, int32_t *tr,              \
      int32_t *depth, int32_t *steps, int64_t C, int D, int md,             \
      int n_sweep, int refresh, int ckpt_bf16, int path, float min_delta,  \
      void *stream
#define TREE_LAUNCH_ARGS                                                    \
  q0, p0, eps, dirs, valid, key, unif, row0, row1, row2, mat, obs_mat,     \
      obs_row0, obs_row1, n_obs, s0, s1, minv, q_out, logp_out, grad_out,   \
      energy_out, lsa_out, term, tl, tr, depth, steps, C, D, md, n_sweep,   \
      refresh, ckpt_bf16, path, min_delta, stream

template <template <int> class P, bool kDense>
int launch_physics(TREE_LAUNCH_PARAMS) {
  cudaError_t prior = cudaGetLastError();
  if (prior != cudaSuccess) return (int)prior;
  if (C == 0) return 0;
  if (C < 0 || D < P<1>::kMinDim || md < 1 || md > 30 || n_sweep < 1 ||
      C > 0xffffffffLL || !p0 || n_obs < 0)
    return (int)cudaErrorInvalidValue;
  if ((refresh || !unif) && !key) return (int)cudaErrorInvalidValue;
  if (!refresh && !dirs) return (int)cudaErrorInvalidValue;
  const PhysicsData pd{{row0, row1, row2}, {s0, s1}, mat, obs_mat,
                       {obs_row0, obs_row1}, n_obs, D};
  Shape sh;
  cudaError_t err = shape_of<P, kDense>(C, D, md, ckpt_bf16 != 0,
                                        refresh != 0, path, s1 != 0.f, &sh);
  if (err != cudaSuccess) return (int)err;
  const Args a{q0,       p0,       eps,        dirs,    valid,
               key,      unif,     pd,         minv,    q_out,
               logp_out, grad_out, energy_out, lsa_out, term,
               tl,       tr,       depth,      steps,   C,
               D,        md,       n_sweep,    refresh, ckpt_bf16,
               min_delta, sh.plan.path, sh.plan.stages, sh.plan.rows};
  void* args[] = {(void*)&a};
  if (sh.cluster > 1) {  // a failed cluster launch returns its error
    cudaLaunchAttribute at[1];
    const cudaLaunchConfig_t cfg = cluster_config(sh, stream, at);
    return (int)cudaLaunchKernelExC(&cfg, (const void*)sh.kernel, args);
  }
  return (int)cudaLaunchKernel((const void*)sh.kernel, dim3((unsigned)sh.grid),
                               dim3(sh.threads), args, (size_t)sh.bytes,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace tree

// A physics source's two extern "C" launchers: tree_<name>_launch with a
// diagonal Minv [D] and tree_<name>_dense_launch with a dense Minv [D, D],
// each tree::launch_physics<PHYS> with TREE_LAUNCH_PARAMS; and
// tree_<name>_plan(D, md, ckpt_bf16, dense, refresh, path, opt, out), the
// plan of the launch either would make for the physics' option `opt` (its
// second scalar's being nonzero: logistic regression's grad_bf16) and the
// blocks an SM holds (tree::plan_physics; it launches nothing).
#define TREE_LAUNCHERS(name, PHYS)                                        \
  extern "C" int tree_##name##_launch(TREE_LAUNCH_PARAMS) {               \
    return tree::launch_physics<PHYS, false>(TREE_LAUNCH_ARGS);           \
  }                                                                       \
  extern "C" int tree_##name##_dense_launch(TREE_LAUNCH_PARAMS) {         \
    return tree::launch_physics<PHYS, true>(TREE_LAUNCH_ARGS);            \
  }                                                                       \
  extern "C" int tree_##name##_plan(int D, int md, int ckpt_bf16,         \
                                    int dense, int refresh, int path,     \
                                    int opt, int* out) {                  \
    return dense ? tree::plan_physics<PHYS, true>(D, md, ckpt_bf16,       \
                                                  refresh, path, opt,     \
                                                  out)                    \
                 : tree::plan_physics<PHYS, false>(D, md, ckpt_bf16,      \
                                                   refresh, path, opt,    \
                                                   out);                  \
  }
