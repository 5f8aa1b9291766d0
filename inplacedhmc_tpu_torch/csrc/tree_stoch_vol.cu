// K5 with stochastic volatility's tile physics (BASELINE config 5's model):
// the body of tree_kernel.cuh with the hand-written value and gradient of
// inplacedhmc_tpu/models/stoch_vol.py::_make_tile_logp, which the TPU
// kernel differentiates with jax.vjp (tree_pallas.py:906-912).  Its plain
// version is ops/tile_physics.py::stoch_vol, the same operations in the
// same order except the row sums.
//
// Lanes [raw_phi, log_s, h_1..h_T]; data rows r2 (the squared returns on
// the h lanes), h_mask (1 on the h lanes 2..T+1), ar_mask (1 on 3..T+1,
// the lanes with a predecessor); scalar t = T.  With phi = tanh(raw_phi),
// inv_s = exp(-log_s), u = 1 - phi^2, z1 = h_1 inv_s, h the q of the h
// lanes (0 elsewhere), h'_l = h_{l-1} and innov_l = (q_l - phi h'_l) inv_s
// on the ar_mask lanes (0 elsewhere):
//   logp = -0.5 (raw_phi - 1.5)^2 - 0.5 (log_s + 2)^2 + 0.5 log u
//          - T log_s - 0.5 u z1^2 - 0.5 sum innov^2
//          + sum over the h lanes of -0.5 (h + r2 e^-h)
//   d/dh_l = 0.5 r2 e^-h - 0.5 - innov_l inv_s + phi inv_s innov_{l+1}
//            (and - u z1 inv_s more on lane 2, h_1)
//   d/draw_phi = -(raw_phi - 1.5)
//                + u (-phi / u + phi z1^2 + inv_s sum innov_l h'_l)
//   d/dlog_s = -(log_s + 2) - T + u z1^2 + sum innov^2
// tanh' is taken as u; where f32 tanh saturates (|raw_phi| above about 9)
// u is 0, the log density -inf and d/draw_phi NaN, as in the TPU kernel,
// and the leaf's sanitisation turns the leaf into a divergence.
//
// The AR(1) term is the one thing here that couples neighbouring lanes:
// the kernel holds coordinate base + lane + 32 k in register k (base the
// first coordinate of the thread's warp: 0 in the narrow form, 256 w in
// warp w of the wide one), so h'_l comes from the lane below
// (__shfl_up_sync) and, on lane 0, from lane 31 of register k - 1, or for
// register 0 from lane 31 of the last register of the warp before (the
// team's from_prev; 0 in the first warp: h_1 has no predecessor);
// innov_{l+1} comes from the lane above (__shfl_down_sync) and, on lane 31,
// from lane 0 of register k + 1, or past the last register from lane 0 of
// register 0 of the warp after (the team's from_next; 0 past the last
// warp).  Coordinates past D hold q = 0 and read no row, so neither shift
// reads an h past h_T.  raw_phi, log_s and h_1 come to every thread from
// coordinates 0, 1 and 2 (by __shfl_sync from lanes 0, 1 and 2 in the
// narrow form, through the team's lead in the wide one); the log density's
// observation terms, sum innov^2 and sum innov h' are three row sums (the
// team's sum3: warp sums in the narrow form).  Per leaf about 18 flops per
// h lane, 4 shuffles per register, 3 row sums, and an exponential per h
// lane, a tanh, an exponential and a log per chain (the SFU's); the wide
// form adds four barriers (lead, from_prev, sum3, from_next).  One
// value_grad serves both forms: the team (tree_kernel.cuh's Warp or Block)
// supplies the row sums, the lead values and the neighbours across warp
// edges (none in a Warp).

#include "tree_kernel.cuh"

namespace tree {

template <int NV>
struct StochVol {
  static constexpr int kNV = NV;
  static constexpr int kMinDim = 3;
  static constexpr bool kFusedGaussian = false;
  static constexpr bool kMatrix = false;  // a [D, D] matrix of its own
  static constexpr bool kStaging = true;  // products staged (kStagedOf)
  static constexpr bool kWide = true;
  float r2[NV];
  bool hm[NV], am[NV];
  float tf;

  template <class T>
  __device__ __forceinline__ void load(const PhysicsData& pd,
                                       const bool (&in)[NV], const T& t) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = t.base + t.lane + 32 * k;
      hm[k] = in[k] && pd.row[1][d] != 0.f;
      am[k] = in[k] && pd.row[2][d] != 0.f;
      r2[k] = hm[k] ? pd.row[0][d] : 0.f;
    }
    tf = pd.scalar[0];
  }

  template <class T>
  __device__ __forceinline__ float value_grad(const float (&q)[NV],
                                              float (&g)[NV], T& t) const {
    const int lane = t.lane;
    float lead[3];  // raw_phi, log_s, h_1
    t.lead(q[0], lead);
    const float raw_phi = lead[0], log_s = lead[1], h1 = lead[2];
    const float phi = tanhf(raw_phi);
    const float inv_s = expf(-log_s);
    const float u = sub(1.f, mul(phi, phi));
    const float z1 = mul(h1, inv_s);
    const float z1z1 = mul(z1, z1);
    const float uz2 = mul(u, z1z1);
    float innov[NV];
    float s_ii = 0.f, s_ih = 0.f, s_obs = 0.f;
    // h at lane 31 of the register before
    float last = t.from_prev(hm[NV - 1] ? q[NV - 1] : 0.f);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float h = hm[k] ? q[k] : 0.f;
      const float up = __shfl_up_sync(FULL, h, 1);
      const float hprev = lane == 0 ? last : up;
      last = __shfl_sync(FULL, h, 31);
      const float in_k = am[k] ? mul(sub(q[k], mul(phi, hprev)), inv_s)
                               : 0.f;
      innov[k] = in_k;
      s_ii = add(s_ii, mul(in_k, in_k));
      s_ih = add(s_ih, mul(in_k, hprev));
      float gk = 0.f;
      if (hm[k]) {
        const float re = mul(r2[k], expf(-h));
        s_obs = add(s_obs, mul(-0.5f, add(h, re)));
        gk = sub(sub(mul(0.5f, re), 0.5f), mul(in_k, inv_s));
      }
      g[k] = gk;
    }
    t.sum3(s_ii, s_ih, s_obs);
    const float after = t.from_next(innov[0]);  // past the last register
    const float phis = mul(phi, inv_s);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float down = __shfl_down_sync(FULL, innov[k], 1);
      const float first =
          __shfl_sync(FULL, innov[k + 1 < NV ? k + 1 : k], 0);
      const float next = lane < 31 ? down : k + 1 < NV ? first : after;
      if (hm[k]) g[k] = add(g[k], mul(phis, next));
    }
    const float a = sub(raw_phi, 1.5f);
    const float b = add(log_s, 2.f);
    const int d0 = t.base + lane;  // register 0's coordinate
    if (d0 == 2) g[0] = sub(g[0], mul(mul(u, z1), inv_s));
    if (d0 == 0)
      g[0] = add(-a, mul(u, add(add(-fdiv(phi, u), mul(phi, z1z1)),
                                mul(inv_s, s_ih))));
    if (d0 == 1) g[0] = add(add(sub(-b, tf), uz2), s_ii);
    float lp = sub(mul(-0.5f, mul(a, a)), mul(0.5f, mul(b, b)));
    lp = add(lp, mul(0.5f, logf(u)));
    lp = sub(lp, mul(tf, log_s));
    lp = sub(lp, mul(0.5f, uz2));
    lp = sub(lp, mul(0.5f, s_ii));
    return add(lp, s_obs);
  }
};

}  // namespace tree

// The two launchers (diagonal and dense Minv) of tree::launch_physics with
// stochastic volatility: row0 r2, row1 h_mask, row2 ar_mask [D]; s0 t; s1,
// mat and the observation arrays are not read.  D >= 3, up to MAX_DIM (the
// wide form above 256).
TREE_LAUNCHERS(stoch_vol, tree::StochVol)
