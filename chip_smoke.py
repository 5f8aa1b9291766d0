#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``inplacedhmc_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed with its wall time:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build every kernel of the main paths from ``inplacedhmc_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all started together) and print
   what ptxas reports of registers, spills and shared memory;
2. hold each kernel against its plain PyTorch version at its main path's
   full width and time the kernel, the plain version and, where there is
   one, a library composition of the same function, beside the card's
   bound: K1 (logistic value and gradient, 8192 x 10,000 x 50, and with
   ``grad_bf16``, five times nearer its plain version than the float32
   backward), K2 (the packed split-bf16 forward on the tensor cores, at
   8192 x 10,000 x 50, nearer its plain version than K1, and at D = 1, 17
   and 64 with C and N off the tiles, then on inputs whose dropped lo.lo
   terms add up: ten times nearer its plain version than K1), K3 (the
   fused Gaussian leapfrog, at 64 x 1000 as the lockstep run of phase 7
   gives it, and at 10,240 x 100), K4 (the multi-step leapfrog, 10,240 x
   100 at k = 64 and 64 x 1000 at k = 7, against its plain version and
   against k chained K3 launches), then ``tools/roofline_torch.py
   --quick``, K4's own path (K3, K4, K1 against the card's peaks), and K5
   (the whole-tree NUTS transition,
   10,240 x 100, max_depth 10, at three step sizes, in each of its three
   forms: the explicit uniform array, the uniforms drawn in the kernel, and
   everything drawn in the kernel, each against the plain version fed the
   kernel's own draws); K5's generator against ``utils/philox.py``; a
   sweep of 16 transitions in one launch against 16 launches; K5 with the
   eight-schools physics (1,024 and 10,240 chains) and the funnel physics
   (64 and 1,024 chains, some chains diverging, some starting where the
   density overflows) at three step sizes each, against the plain version
   fed the kernel's own uniforms, and a sweep of 16 of eight schools
   against 16 launches; K5-dense (a ``[D, D]`` M^-1, each physics' second
   launcher): the Gaussian physics under a dense metric at 10,240 x 100,
   the dense Gaussian's physics on the 250-D Wishart-precision target
   (``mvn_target``) at 1,024 and 64 chains under a diagonal and under a
   dense metric, at three step sizes each, in the three forms, eight
   schools and the funnel under a dense metric; a dense sweep of 16
   against 16 launches; K5-logistic (``csrc/tree_logistic.cu``, the tile
   form: a tile of chains in lockstep) at 8192 x 10,000 x 50 from draws
   of the Laplace approximation, under its covariance as a dense M^-1 and
   under the diagonal of it, at three step sizes, in the three forms; at
   1, 64 and 1,000 chains (a partial tile), at D = 1, 17, 64, 200 and 256
   on 2,049 observations (a ragged tile), with ``grad_bf16`` and with
   ``ckpt_bf16``; sweeps of 16 against 16 launches (also with
   ``grad_bf16`` and ``ckpt_bf16``), and the per-leaf library composition
   of the physics timed for reference;
   K5-stoch_vol (``csrc/tree_stoch_vol.cu``, the AR(1) physics) at T = 100
   (D = 102) at 1,024 and 10,240 chains, under a diagonal and a dense
   metric, at three step sizes, every 16th chain started where f32 tanh
   saturates (raw_phi = 10), and a sweep of 16 against 16 launches; K5's
   wide form (D above 256, one chain per block of ceil(D / 256) warps):
   the SASS of its instantiations, the Gaussian at 64 and 1,024 chains x
   1,000 in the three forms at three step sizes, the dense Gaussian on a
   512-D Wishart-precision target at 256 chains under a diagonal and a
   dense metric, stochastic volatility at T = 1,000 (D = 1,002) at 1,024
   and 10,240 chains under a diagonal metric and at 1,024 under a dense
   one, every 16th chain saturated, and a sweep of 16 against 16 launches
   at D = 1,002; K5 with bfloat16 checkpoint stacks (``ckpt_bf16``)
   against its plain version with them, the Gaussian at 10,240 x 100 and
   stochastic volatility at 1,024 x 102 under a dense metric, each also
   launched with float32 stacks (the share of chains whose termination
   agrees, both timed in alternating pairs, both occupancies), the
   Gaussian at D = 2,048 and max_depth 20, which float32 stacks cannot
   take, and the blocks per SM of both stack types at D = 1,002; every
   dense check and every timing at a tuned state with a ``[D, D]`` matrix
   also prints the staged products' plan (path, ring stages and bytes in
   flight, chains a block, blocks an SM: the launcher's, held to
   ``ops.tree.stage_plan``) and its time per product on the longest chain,
   runs the launch again through every other path its shape admits
   (outputs equal bit for bit; once for each shape, on its first state;
   in the wide form under a dense metric through whichever of K = 1, the
   register path, and the thread-block cluster of 4 or 8 blocks a chain
   (which the wrapper asks for where a launch's chains in flight are few)
   the wrapper did not take, on every state, timed on the first of its
   shape, with the chains in flight, the wrapper's K and the clusters the
   card holds at once), and times the
   per-leaf library yardstick (one float32 ``torch.mm`` of every chain's
   vector by the matrix: ``library_leaf_ms`` in the kernels line, whose
   ``library_ms`` stays null, as no library call computes a transition);
3. ``sample()`` on BASELINE config 3 (logistic regression, 10,000 x 50 data
   from a seed, 8192 chains, dense metric, a short warmup schedule, 128
   draws) through K1; the same with ``fused_opts={"fwd_precision":
   "packed"}`` through K2 (no K1 launch), its acceptance beside K1's; 128
   draws with ``fused_opts={"grad_bf16": True}`` from K1's tuned state
   (K1 with the option at every launch); then the same through K5-logistic
   (``use_pallas="tree"``), no K1 launch, and with the flagship
   ``tree_opts`` from its tuned state; the crossover of K5-logistic
   against the lockstep tree with K1 at 1, 64, 1,024 and 8192 chains at
   that state (recorded: the default route stays the lockstep tree);
4. ``sample()`` on BASELINE config 1 (the 100-D standard normal) at 10,240
   chains, default 900-transition warmup, 256 draws: the whole-tree route,
   K5 once per transition;
5. the flagship path: the same ``sample()`` with ``tree_opts=
   {"refresh_inside": True, "padded_io": True, "n_sweep": FLAGSHIP_K}``
   (K5 once per tuning transition, once per ``FLAGSHIP_K`` sampling
   transitions); then ``bench.py``'s measurement done the port's way (q0
   normal, eps 0.25, 64 transitions with ``keep_dims=(0,)``, best of 3,
   and the eps 0.005 probe) for n_sweep 1, 4, 16 and 64 and for phase 4's
   route: chain leapfrog steps/s and leaf work over wall;
6. ``sample()`` on the 100-D standard normal at 64 chains (the examples'
   config 1 run: default warmup, 1000 draws): the whole-tree route as well;
7. ``sample()`` on the 1000-D standard normal at 64 chains, default warmup,
   1000 draws: the whole-tree route through K5's wide form; then the same
   model with ``use_pallas="on"``, the lockstep tree with K3 as its
   leapfrog, cut to a 200-transition warmup and 100 draws (K3's own path);
8. ``sample()`` on BASELINE config 4, eight schools, at 1,024 chains
   (default warmup, 1,000 draws) through K5 with the eight-schools physics;
9. ``sample()`` on BASELINE config 2, the 10-D Neal's funnel, at 64 chains
   (``delta`` 0.9, no L-BFGS start, 1,000 draws; the examples' run) through
   K5 with the funnel physics, and on its non-centred form through K5 with
   the Gaussian physics; then ``sample()`` on BASELINE config 5's model,
   stochastic volatility at T = 100 (data drawn on the card by the model's
   recursion, the true latents kept), config 5's recipe (delta 0.9, dense
   windows, 4 doubling windows, no L-BFGS start) at 1,024 chains, 200
   draws, through K5-stoch_vol, and its two launchers timed at the tuned
   state; then config 5's own T = 1,000 (D = 1,002) with config 5's whole
   recipe at 1,024 chains: streamed dense windows in chunks of 50
   transitions, the per-coordinate ASIS hook (10 sub-steps) after every
   transition, 50 draws in blocks of 25 with split moments over every
   coordinate (R-hat from them held to R-hat of the stored draws; R-hat
   printed, not gated), through K5-stoch_vol's wide form with bfloat16
   checkpoint stacks (its dense launches on a cluster counted:
   ``ops.tree.CLUSTER_LAUNCHES``), whether its dense launch at the tuned
   state is bound by its deepest chain (``tail_at_state``: every chain
   valid against the deepest alone, at K = 1 and on a cluster, and the
   wrapper's own K there, which must be a cluster), and its two launchers
   at the tuned state against their plain versions, timed with both stack
   types;
10. ``sample()`` on the 250-D multivariate normal of Hoffman and Gelman
   (2014) with a Wishart precision of 300 degrees of freedom (``mvn``) at
   1,024 chains, 4 dense windows, 300 draws: K5 with the dense Gaussian's
   physics, diagonal until the first dense window closes and dense after;
   then 256 draws with the flagship ``tree_opts`` from its tuned state;
11. ``sample()`` on the 100-D standard normal at 10,240 chains with dense
   windows, 256 draws: the Gaussian K5 under a dense metric;
12. the crossover between the routes: one transition through each, at 1 to
   10,240 chains: the 100-D standard normal through K5 and the lockstep
   tree with K3, eight schools and the funnel through K5 and autograd on
   the lockstep tree, at a fixed step size from the identity metric; the
   250-D ``mvn`` and the 100-D normal through K5-dense and autograd on the
   lockstep tree at the tuned step size and dense metric of phases 10 and
   11, stochastic volatility likewise at its tuned state (1 to 10,240
   chains); above D = 256 (K5's wide form) at 1, 64, 1,024 and 10,240
   chains, at the tuned states of phases 7 and 9: the 1000-D normal
   against the lockstep tree with K3, stochastic volatility at T = 1,000
   against autograd on the lockstep tree; it fails if
   ``NUTSKernel.TREE_MIN_CHAINS`` or ``TREE_MIN_CHAINS_BY_PHYSICS``
   contradicts the timings.

Each ``sample()`` phase resets every kernel's launch count just before the
call and reads the counts just after, and checks the posterior (finite
draws, split R-hat, acceptance; the coefficients' correlation for logistic
regression, the moments within Monte Carlo error for the normals and the
``mvn``, the means of mu and log_tau against the quadrature golden for
eight schools, v's standard deviation for the funnel; for stochastic
volatility the divergent fraction and the true latents' coverage).

It prints a ``{"kernels": [...]}`` line, the card's line, and as its last
line ``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero; without a CUDA device, or without the package beside it, it
exits non-zero before printing a result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

# the card's line and the H100's peaks, shared with tools/roofline_torch.py
from tools.card import (PEAK_BF16_TC, PEAK_BYTES, PEAK_FP32_FLOPS,  # noqa
                        PEAK_SFU, PEAK_TF32_TC, card_line)

SEED = 20261017
C, N, D = 8192, 10_000, 50        # chains, observations, features
N_DRAWS = 128
G_DIM = 100                       # BASELINE config 1: the 100-D std normal
G_CHAINS, G_DRAWS = 10_240, 256   # the whole-tree route
S_CHAINS, S_DRAWS = 64, 1000      # examples config 1: the whole-tree route
W_DIM = 1000                      # the 1000-D normal: K5's wide form
# the shortened lockstep run of the 1000-D normal that keeps K3 on a path
# (use_pallas="on"): a 200-transition warmup and W_K3_DRAWS draws
W_K3_STAGES = dict(init_steps=30, middle_steps=20, doubling_stages=3,
                   terminating_steps=30)
W_K3_DRAWS = 100
E_CHAINS, E_DRAWS = 1024, 1000    # BASELINE config 4: eight schools
F_DIM, F_CHAINS, F_DRAWS = 10, 64, 1000  # config 2: the funnel, as
                                        # examples/baseline_configs.py runs it
# the calibrated band of the centred funnel's v sd under vanilla NUTS at
# delta 0.9 (examples/baseline_configs.py:88-89; the exact value is 3)
FUNNEL_V_SD_BAND = (2.45, 3.0)
GOLDEN_EIGHT_SCHOOLS = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "tests", "golden", "eight_schools.json")
# the chain counts of the crossovers (every threshold is 1; the counts
# between these were dropped to keep the script within its time budget)
CROSSOVER_CHAINS = (1, 64, 1024, 10_240)
# the step sizes of the routes' crossover (identity metric, q0 normal)
CROSSOVER_EPS = {"gaussian": 0.3, "eight_schools": 0.3, "funnel": 0.2}
MAX_DEPTH = 10
# K5 against its plain version: both sides run the same f32 operations of
# each leaf in the same order, so the trajectories agree bit for bit; only
# the row sums (log density, kinetic energy, U-turn statistics) add their
# 100 terms in another order, about 1e-7 relative.  A U-turn statistic or a
# proposal's log-uniform test that falls within that of its threshold
# decides the other way and changes that chain's records or proposal.  Such
# ties have a probability of order 1e-6 per decision, a few thousand
# decisions per chain at max depth: one chain in a thousand is allowed.
TREE_MISMATCH_FRACTION = 1e-3
# With D-term products (a dense metric's p#, the dense Gaussian's P q) the
# products too add their terms in another order, and a proposal's test
# falls within the two sides' difference more often: such a chain counts
# as a tie only when the plain version, its uniforms shifted by that
# difference, makes the kernel's choice (compare_tree).
TREE_RTOL = 1e-4  # float fields of the chains that agree, relative to 1 + |x|
# Above D = 256 stochastic volatility's d/draw_phi and d/dlog_s are sums of
# D terms that cancel (sum innov^2 against T), so an f32 rounding
# difference of gamma_D times the sum of the terms' magnitudes (Higham,
# section 3.1) is far beyond TREE_RTOL of the result, and the leapfrog
# carries it into q and the log density: there the float fields are also
# held to LONG_SUM_K gamma_D of their terms' magnitudes (``sv_terms``), as
# tests/test_torch_stoch_vol.py holds the plain version to JAX's.  gamma_D
# bounds one evaluation; a trajectory carries each leaf's difference into
# the next, and the agreeing chains of the T = 1,000 checks need up to
# about 16 on the gradient (printed per case as "K needed")
LONG_SUM_K = 16
LONG_SUM_NEED: dict = {}   # the largest K each field needed in this run
# K1 sums N = 1e4 f32 terms per chain in another order than the float64
# reference: a random-walk rounding error of about sqrt(N) * 2^-24 = 6e-6 of
# sum_n |term_n|, so logp is held to 1e-5 of that sum.  The gradient's
# components cancel (resid * x of both signs), so its error is held against
# max |grad| with ten times the room.
LOGP_TOL = 1e-5   # |logp - ref| / sum_n |term_n|
GRAD_TOL = 1e-4   # |grad - ref| / max |ref grad|
# the tree's own per leaf: log of the proposal uniform, exp(min(delta, 0)),
# and the exp and log1p of the progressive logaddexp
TREE_SFU_PER_LEAF = 4
# each physics' device function per leaf, beyond the tree's 25 D flops
# (csrc/tree_<physics>.cu): flops per data lane, flops per chain, special
# functions per chain.  Eight schools: theta, r, r/sig, the three sums'
# terms and the z gradient, 14 per observed lane; mu/10, the softplus and
# sigmoid, the first two gradient entries and logp, 25; exp(log_tau), the
# softplus' exp and log1p, the sigmoid's exp.  The funnel: x^2, its sum and
# -e x, 3 per x lane; logp and d/dv, 12; exp(-v).  The dense Gaussian:
# the negation and the log density's terms, 3 per lane, beside its product
# P q (counted by tree_bound).
# Stochastic volatility, per h lane: innov's 3, the two sums' 4, exp's
# argument, r2 e, the observation term's 3, d/dh's 4 and the neighbour's
# 2: 18; per chain: u, z1, z1^2, u z1^2, phi inv_s, the two shifts of the
# priors, h_1's gradient 3, d/draw_phi 8, d/dlog_s 3 and logp 13: 35; tanh,
# exp(-log_s) and log u; and one exp per h lane (PHYSICS_LANE_SFU).
PHYSICS_COST = {"gaussian": (0, 0, 0), "eight_schools": (14, 25, 4),
                "funnel": (3, 12, 1), "dense_gaussian": (3, 0, 0),
                "logistic": (3, 6, 0), "stoch_vol": (18, 35, 3)}
PHYSICS_LANE_SFU = {"stoch_vol": 1}
# logistic regression per observation and evaluation, beyond the products'
# 4 D flops (tree_bound): |eta| and its negation, ll's four, the sigmoid's
# two and its select, the residual's two, w ll and its sum: 12 flops; exp
# and log1p: 2 special functions.  Per chain the prior's 3 per lane
# (|q|^2, -inv_var q and its sum) and the two sums' 6.
LOGISTIC_OBS_FLOPS, LOGISTIC_OBS_SFU = 12, 2
# K2 (the packed split-bf16 forward) beside config 3's shape: C and N off
# the kernel's 64-chain block and 32-observation tile, at the smallest,
# an odd and the largest D it takes
PACKED_CASES = ((200, 1_000, 1), (1_000, 2_049, 17), (8_001, 4_100, 64))
# K1 beside config 3's 8192 chains: the crossover's other chain counts, at
# the same data, and K1 above the D = 256 it once refused (chunks of 64
# dimensions), at 1,024 chains of config 3's observations
K1_CHAINS = (1, 64, 1024)
K1_WIDE = (1024, N, 300)
PAIRS = 4                         # alternating pairs of K2 and K1 times
# K4 (the multi-step leapfrog) at the roofline harness's shape and step
# count, and at the 1000-D lockstep shape with an odd count
MULTISTEP_CASES = ((G_CHAINS, G_DIM, 64), (S_CHAINS, W_DIM, 7))
# K5's generator: the normals may differ from torch's by the rounding of
# logf, cosf (1-2 ulp each) scaled by sqrt(-2 log u1) <= 5.8; 16 ulp of
# max(1, |x|) bounds that.  Direction words and uniforms are integer work
# and must be equal.
NORMAL_ULP = 16
# one Philox4x32-10 draw: 10 rounds of 2 mul.hi, 2 mul.lo, 4 xor, 2 add;
# Box-Muller about 30 more flops (log, sqrt, cos, the conversions)
PHILOX_OPS, BOX_MULLER_FLOPS = 100, 30
SWEEP_CHECK_K = 16                # the n_sweep of the bit-identity check
# the dense metric's target: Hoffman and Gelman's 250-D multivariate normal
# with a Wishart precision, at 300 degrees of freedom (mvn_target)
MVN_DIM, MVN_DF, MVN_SEED = 250, 300, 0
# the mvn run keeps 4 doubling windows (the default's first four: 500
# warmup transitions; 3 leave a worse metric and slower transitions), 150
# draws, and its flagship run from the tuned state 128 draws (5 windows,
# 1,000 and 1,024 draws until the wide phases took their time)
MVN_CHAINS, MVN_DRAWS, MVN_DOUBLING = 1024, 150, 4
MVN_SWEEP_DRAWS = 128             # a multiple of FLAGSHIP_K
DENSE_G_DRAWS = 256               # the 100-D normal with dense windows
# the TPU code each dense-metric form replaces: the dense branch of
# _make_kernel, and the dense Gaussian's _dense_gaussian_tile_vg
DENSE_REPLACES = {"gaussian": "179", "eight_schools": "179", "funnel": "179",
                  "dense_gaussian": "1118"}
# K5-logistic (BASELINE config 3 through the whole tree, use_pallas="tree"):
# the TPU code it replaces in both metric forms is the logistic physics'
# chunked tile_vg; JAX's default block_n pads 10,000 observations to 10,240
LOGISTIC_REPLACES = "1242"
LOGISTIC_BLOCK_N = 2048
INV_VAR = 0.01                    # the prior of logistic_regression()
LOGISTIC_CROSSOVER_CHAINS = (1, 64, 1024, C)
# K5-logistic's tile form beside config 3's shape: chain counts whose last
# tile is partial (1,000 = 62 x 16 + 8), dimensions across its
# instantiations and chunks of 64, and an observation count whose last
# tile of 32 is ragged
LOGISTIC_TILE_CHAINS = (1, 64, 1000)
LOGISTIC_TILE_DIMS = (1, 17, 64, 200, 256)
LOGISTIC_TILE_C, LOGISTIC_TILE_N = 1000, 2049
# BASELINE config 5's model, stochastic volatility, at the examples' T = 100
# (examples/baseline_configs.py:141-143: phi 0.97, s 0.15; D = 102) through
# K5 with its AR(1) physics (csrc/tree_stoch_vol.cu), with the recipe of
# :144-153 (delta 0.9, dense windows, doubling_stages 4, no L-BFGS start)
# at the examples' full-scale 1,024 chains and 200 draws, the draws stored
# (the T = 1,000 phase runs the streamed, chunked, hooked recipe); the
# kernel checks also at config 5's 10,240 chains
SV_T, SV_PHI, SV_S = 100, 0.97, 0.15
SV_CHAINS, SV_BIG, SV_DRAWS = 1024, 10_240, 200
# every SV_THIN-th transition is recorded: the centred posterior mixes
# slowly without ASIS (this phase runs none), in JAX too; on an H100 200
# consecutive draws of converged chains read a split R-hat of 1.27 on
# log_s (its autocorrelation time about 69 transitions), 16 transitions
# apart 1.042 on an h_t (the slowest coordinate, about 235); 32 apart
# halves that excess (PERF.md section 6)
SV_THIN = 32
# the kernel checks' step sizes under 0.5 + U(0, 1) or _spd's M^-1 from
# tile_start: trees of depth about 6.7, 4.3 and 0.3 (almost every chain
# diverges), and the sweep check's
SV_EPS = (0.002, 0.02, 0.2)
SV_SWEEP_EPS = 0.02
SV_SATURATED = 10.0               # raw_phi where f32 tanh is 1: u = 0
SV_ACCEPT_BAND = (0.75, 0.99)     # delta 0.9 (PERF.md section 2)
SV_DIV_MAX = 0.05                 # the divergent fraction of transitions
SV_COVERAGE = 70                  # percent of the true h_t in their central
                                  # 90 % intervals
SV_CROSSOVER_CHAINS = (1, 64, 1024, SV_BIG)
# config 5's own T = 1,000 (D = 1,002: K5's wide form, one chain per block
# of 4 warps) at the examples' 1,024 chains with its whole recipe
# (examples/baseline_configs.py:136-161: streamed dense windows, chunks of
# 50 tuning transitions, blocks of 25 draws, a fence after each, split
# moments over every coordinate) and the round-5 headline's per-coordinate
# ASIS hook after every transition, 10 sub-steps
# (examples/results_round5.jsonl), on bfloat16 checkpoint stacks; then
# SV_WIDE_DRAWS consecutive draws (the recipe's 1,250 draws thinned by 4
# cut to fit the budget; keep_dims=range(10) dropped, so that the coverage
# gate sees every h_t).  Its split R-hat is printed, not gated: ASIS
# shortens log_s's autocorrelation (tau about 148 transitions at 10,240
# chains in round 5), still far beyond these draws
SV_WIDE_T, SV_WIDE_DRAWS = 1000, 50
# the default route at that D (float32 stacks, no hook, stored draws):
# sample() from the recipe's tuned state, without warmup, under its dense
# M^-1 and under that M^-1's diagonal, this many draws each
SV_DEFAULT_DRAWS = 25
SV_RECIPE = dict(tuning_chunk=50, draw_block=25, sync_blocks=True,
                 collect_moments=True)
# K5's bfloat16 checkpoint stacks (ckpt_bf16): the TPU code they replace
# (the stores of _make_kernel, tree_pallas.py:317-321), the share of
# chains whose termination must agree with float32 stacks
# (tests/test_tree_pallas.py asks 0.9), the alternating pairs that time the
# two, the dimension above the one-warp form, and the wide check that only
# bfloat16 stacks fit: D = 2,048 at max_depth 20 (float32 stacks take 13)
BF16_REPLACES = "317"
BF16_AGREE = 0.9
BF16_PAIRS = 3
BF16_WIDE_MD = 20
# inputs on which the rounding decides turns (tests/test_torch_ckpt_bf16.py):
# the Gaussian at max_depth 8 and eps 0.005 (deep trees of small subtrees,
# whose checks subtract large checkpoint sums), M^-1 1e-6 past coordinate 0
# and standard normal momenta so that coordinate 0 decides, at these D (one
# warp, a block of two)
BF16_FLIP_DIMS, BF16_FLIP_MD, BF16_FLIP_EPS = (100, 300), 8, 0.005
SV_ASIS_STEPS = 10
# R-hat from float32 split moments against R-hat of the stored draws
# (moment_rhat_check)
MOMENT_RHAT_K = 4.0
# the dense Gaussian above D = 256: a Wishart-precision mvn at D = 512 with
# the 250-D target's ratio of degrees of freedom to D (300 / 250), 256 chains
MVN_WIDE_DIM, MVN_WIDE_DF, MVN_WIDE_CHAINS = 512, 614, 256
# the TPU code K5-stoch_vol replaces in both metric forms: jax.vjp of the
# model's tile_logp inside the kernel built by make_tree_transition
SV_REPLACES = "906"
FLAGSHIP_K = 16                   # n_sweep of the flagship sample()
SWEEP_KS = (1, 4, 16, 64)         # the n_sweep values the bench times
BENCH_EPS, BENCH_TRANSITIONS, PROBE_EPS = 0.25, 64, 0.005  # bench.py's


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events.
    The stream first sleeps for about 30 ms, so that the host queues all
    ``iters`` calls before the first one runs: the events then time the
    device's work back to back, not the host's launch overhead.  ``fn`` must
    not synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean wall time of ``fn()``, synchronised at both ends: for functions
    whose host loop synchronises (the plain tree, a whole transition)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def timed(fn):
    """``(fn(), ms)``: the result of one call and its wall time,
    synchronised at both ends (``wall_ms`` of one call without warm-up, its
    result kept: a comparison's run of the plain version timed as it runs).
    """
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(flops: float, nbytes: float, sfu: float = 0.0,
          tc_flops: float = 0.0, tf32_flops: float = 0.0):
    """The least time of the work on an H100 SXM, in ms, and what sets it:
    the operations (fp32 at the fp32 rate, special functions at the SFU
    rate, bf16 and TF32 products at the tensor cores' rates, one pipe
    whose two times add; the pipes run side by side, so the largest) or
    the bytes at the memory rate."""
    t_ops = max(flops / PEAK_FP32_FLOPS, sfu / PEAK_SFU,
                tc_flops / PEAK_BF16_TC + tf32_flops / PEAK_TF32_TC)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def build_kernels():
    """Build every kernel of the main paths, one nvcc process per source,
    all started together."""
    from inplacedhmc_tpu_torch.ops.cuda_build import build_all
    from inplacedhmc_tpu_torch.ops.leapfrog import (LEAPFROG_GAUSSIAN,
                                                    LEAPFROG_MULTISTEP)
    from inplacedhmc_tpu_torch.ops.logistic import (LOGISTIC_PACKED,
                                                    LOGISTIC_VG)
    from inplacedhmc_tpu_torch.ops.tree import (TREE_DENSE_KERNELS,
                                                TREE_KERNELS)
    kernels = [LOGISTIC_VG, LOGISTIC_PACKED, LEAPFROG_GAUSSIAN,
               LEAPFROG_MULTISTEP, *TREE_KERNELS.values(),
               *TREE_DENSE_KERNELS.values()]
    build_all(kernels)
    for k in kernels:
        if k.build_seconds is None:   # a second launcher of a built source
            continue
        print(f"[build] {k.source}: {k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "Compiling entry" in line:
                name = line.split("'")[1] if "'" in line else line
                print(f"[build]   {name[:110]}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")
    return kernels


def logistic_instantiations(card: str) -> None:
    """The three forms of the logistic body at config 3's D (float32,
    ``grad_bf16``, packed) and the two wide ones (D > 64): ptxas's
    registers and spills, their tensor-core instructions (``HMMA``) in the
    SASS, and the occupancy of each (blocks and warps an SM,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Fails unless each
    of the three runs its products on the tensor cores, spills nothing and
    keeps more than 8 warps an SM."""
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG, occupancy
    nk = f"ELi{(D + 7) // 8}ELb0E"    # the instantiation of config 3's D
    counts = sass_counts(
        LOGISTIC_VG, lambda name: "logistic_vg_kernel" in name
        and (nk in name or "ELb1E" in name), ("LDL", "STL", "HMMA", "BAR"))
    for form, code in (("f32", 0), ("grad_bf16", 1), ("packed", 2)):
        ours = [v for k, v in counts.items() if f"ILi{code}{nk}" in k]
        for d in (D, K1_WIDE[2]):
            if form == "packed" and d > 64:
                continue
            occ = occupancy(form, d)
            print(f"[sass] logistic {form} at D = {d}: "
                  f"{occ['registers']} registers, {occ['local_bytes']} "
                  f"local bytes, {occ['blocks_per_sm']} blocks = "
                  f"{occ['warps_per_sm']} warps an SM, {occ['stages']} "
                  f"stages of {4 * occ['tile_words']} bytes, "
                  f"{occ['smem_bytes']} bytes of shared memory a block, on "
                  f"{card}")
        occ = occupancy(form, D)
        if not (len(ours) == 1 and ours[0]["HMMA"] > 0
                and ours[0]["LDL"] == ours[0]["STL"] == 0
                and occ["local_bytes"] == 0 and occ["warps_per_sm"] > 8):
            raise RuntimeError(f"the logistic body's {form} form at D = {D}: "
                               f"{ours}, {occ}")


def launch_counts(kernels) -> dict:
    """Each launcher's count of launches, by its symbol (a source's two
    launchers count apart)."""
    return {k.symbol: k.launches for k in kernels}


def _library_logistic(q, x, y, w, s2, grad_bf16: bool = False):
    """One library composition of the same function: cuBLAS products and
    PyTorch's fused BCE-with-logits; with ``grad_bf16`` the backward is
    cuBLAS's bf16 product with float32 accumulation and output
    (``torch.mm(..., out_dtype=torch.float32)``) on the residual and ``x``
    rounded to bfloat16.  A yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    eta = torch.matmul(q, x.T)
    nll = F.binary_cross_entropy_with_logits(
        eta, y.expand_as(eta), weight=w, reduction="none").sum(1)
    logp = -nll - 0.5 * s2 * (q * q).sum(1)
    resid = (y - torch.sigmoid(eta)) * w
    if grad_bf16:
        grad = torch.mm(resid.to(torch.bfloat16), x.to(torch.bfloat16),
                        out_dtype=torch.float32).sub_(q, alpha=s2)
    else:
        grad = torch.addmm(q, resid, x, beta=-s2)
    return logp, grad


def logistic_bound(c: int, n: int, d: int, form: str = "f32") -> dict:
    """``bound()`` of one logistic evaluation at c x n x d, the same work
    whatever implements it: the forward and backward products, 2 c n d
    flops each, the bfloat16 ones (``"grad_bf16"``'s backward, one pass;
    ``"packed"``'s forward, three passes, which also reads x's two bf16
    halves) at the tensor cores' bf16 rate, each float32-grade one at the
    lesser of two times, on the fp32 FMA pipe or as three TF32 passes on
    the tensor cores; beside them the per-observation work
    (``LOGISTIC_OBS_FLOPS``, ``LOGISTIC_OBS_SFU``).  Returns ``ms`` and
    ``by`` (the lesser bound and what sets it) and ``text``, which gives
    both routes' bounds and the work of each type."""
    prod = 2.0 * c * n * d
    bf16 = {"f32": 0.0, "grad_bf16": prod, "packed": 3 * prod}[form]
    f32_grade = {"f32": 2, "grad_bf16": 1, "packed": 1}[form] * prod
    elem = LOGISTIC_OBS_FLOPS * c * n
    sfu = LOGISTIC_OBS_SFU * c * n
    nbytes = 4.0 * (c * d + n * d + 2 * n) + 4.0 * (c + c * d) \
        + (2.0 * 2 * n * d if form == "packed" else 0.0)
    fma = bound(f32_grade + elem, nbytes, sfu, tc_flops=bf16)
    tf32 = bound(elem, nbytes, sfu, tc_flops=bf16, tf32_flops=3 * f32_grade)
    ms, by = min(tf32, fma)
    text = (
        f"bound {ms:.4f} ms ({by}; the float32-grade products "
        f"{f32_grade / 1e9:.2f} GFLOP as three TF32 passes at "
        f"{PEAK_TF32_TC / 1e12:g} TFLOP/s {tf32[0]:.4f} ms, on the fp32 FMA "
        f"pipe {fma[0]:.4f} ms; {bf16 / 1e9:.2f} GFLOP bf16 "
        f"{bf16 / PEAK_BF16_TC * 1e3:.4f} ms, {elem / 1e9:.2f} GFLOP fp32 "
        f"elementwise, {sfu / 1e9:.3f} G special functions "
        f"{sfu / PEAK_SFU * 1e3:.4f} ms, {nbytes / 1e6:.2f} MB)")
    return {"ms": ms, "by": by, "text": text}


def check_logistic_kernel(card: str) -> dict:
    """K1 against its plain version at C x N x D, with one NaN chain."""
    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (
        BLOCK_CHAINS, LOGISTIC_VG, launch_splits, logistic_planes,
        logistic_value_and_grad, logistic_value_and_grad_plain, occupancy)

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = beta + 0.1 * torch.randn((C, D), generator=gen, device="cuda")
    q[1, 3] = float("nan")
    w = torch.ones_like(y)
    s2 = 0.01
    before = LOGISTIC_VG.launches
    logp, grad = logistic_value_and_grad(q, x, y, w, s2)
    torch.cuda.synchronize()
    if LOGISTIC_VG.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K1 on a CUDA tensor")

    # reference: the plain version on the same inputs, in float64
    q64, x64, y64, w64 = (t.double() for t in (q, x, y, w))
    lp_ref, g_ref = logistic_value_and_grad_plain(q64, x64, y64, w64, s2)
    eta = q64 @ x64.T
    scale = (w64 * (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta))
             ).abs().sum(1) + 0.5 * s2 * (q64 * q64).sum(1)
    ok = torch.isfinite(lp_ref)
    if not (torch.equal(torch.isfinite(logp), ok) and logp[1] == -torch.inf
            and bool((grad[1] == 0).all())):
        raise RuntimeError("K1 guard: the NaN chain must give -inf and a "
                           "zero gradient, and only it")
    lp_err = ((logp.double() - lp_ref).abs()[ok] / scale[ok]).max().item()
    g_err = ((grad.double() - g_ref).abs().max()
             / g_ref.abs().max()).item()
    abs_err = max((logp.double() - lp_ref).abs()[ok].max().item(),
                  (grad.double() - g_ref).abs().max().item())
    print(f"[k1] logp err / sum|terms| = {lp_err:.3e} (tol {LOGP_TOL:g}), "
          f"grad err / max|grad| = {g_err:.3e} (tol {GRAD_TOL:g}), "
          f"max abs err {abs_err:.3e}")
    if not (lp_err <= LOGP_TOL and g_err <= GRAD_TOL):
        raise RuntimeError("K1 disagrees with its plain version")

    # timed as the potential launches it: the plane of the data made once
    qf = q.clone()
    qf[1, 3] = 0.0
    plane = logistic_planes(x, y, w)
    ms = cuda_time_ms(lambda: logistic_value_and_grad(qf, x, y, w, s2,
                                                      planes=plane))
    plain_ms = cuda_time_ms(
        lambda: logistic_value_and_grad_plain(qf, x, y, w, s2))
    library_ms = cuda_time_ms(lambda: _library_logistic(qf, x, y, w, s2))
    b = logistic_bound(C, N, D)
    bound_ms, bound_by = b["ms"], b["by"]
    print(f"[k1] {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, {b['text']}, "
          f"{bound_ms / ms:.3f} of the bound, "
          f"{4.0 * C * N * D / ms / 1e9:.1f} TFLOP/s of the two products "
          f"achieved")
    # the crossover's chain counts at the same data
    for c in K1_CHAINS:
        qc = qf[:c].contiguous()
        occ = occupancy("f32", D)
        splits = launch_splits(c, N, occ["blocks_per_sm"], occ["sms"])
        ms_c = cuda_time_ms(lambda: logistic_value_and_grad(
            qc, x, y, w, s2, planes=plane))
        bc = logistic_bound(c, N, D)
        print(f"[k1] {c} x {N} x {D} ({splits} splits of the observations "
              f"a block of {BLOCK_CHAINS} chains): kernel {ms_c:.4f} ms, "
              f"bound {bc['ms']:.5f} ms ({bc['by']}), "
              f"{bc['ms'] / ms_c:.3f} of it, on {card}")
    return {"name": "logistic_value_and_grad", "route": "cuda",
            "source": "inplacedhmc_tpu_torch/csrc/logistic_vg.cu",
            "replaces": "inplacedhmc_tpu/ops/logistic_pallas.py:71",
            "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_logistic_wide(card: str) -> None:
    """K1 above D = 256 (``K1_WIDE``: chunks of 64 dimensions, each tile
    streamed once for the forward and once for the backward) against its
    plain version in float64, with one NaN chain, to ``LOGP_TOL`` and
    ``GRAD_TOL``; timed beside its bound."""
    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, logistic_planes, logistic_value_and_grad,
        logistic_value_and_grad_plain, occupancy)

    c, n, d = K1_WIDE
    x, y, beta = synthetic_data(SEED + 5, n, d, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q = beta + 0.1 * torch.randn((c, d), generator=gen, device="cuda")
    q[1, 3] = float("nan")
    w = torch.ones_like(y)
    before = LOGISTIC_VG.launches
    logp, grad = logistic_value_and_grad(q, x, y, w, INV_VAR)
    torch.cuda.synchronize()
    if LOGISTIC_VG.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K1 at D = 300")
    q64, x64, y64, w64 = (t.double() for t in (q, x, y, w))
    lp_ref, g_ref = logistic_value_and_grad_plain(q64, x64, y64, w64,
                                                  INV_VAR)
    eta = q64 @ x64.T
    scale = (w64 * (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta))
             ).abs().sum(1) + 0.5 * INV_VAR * (q64 * q64).sum(1)
    ok = torch.isfinite(lp_ref)
    if not (torch.equal(torch.isfinite(logp), ok) and logp[1] == -torch.inf
            and bool((grad[1] == 0).all())):
        raise RuntimeError("K1 guard at D = 300")
    lp_err = ((logp.double() - lp_ref).abs()[ok] / scale[ok]).max().item()
    g_err = ((grad.double() - g_ref).abs()[ok].max()
             / g_ref[ok].abs().max()).item()
    q[1, 3] = 0.0
    plane = logistic_planes(x, y, w)
    ms = cuda_time_ms(lambda: logistic_value_and_grad(q, x, y, w, INV_VAR,
                                                      planes=plane))
    b = logistic_bound(c, n, d)
    occ = occupancy("f32", d)
    print(f"[k1] {c} x {n} x {d}: logp err / sum|terms| = {lp_err:.3e} "
          f"(tol {LOGP_TOL:g}), grad err / max|grad| = {g_err:.3e} (tol "
          f"{GRAD_TOL:g}); kernel {ms:.4f} ms, {b['text']}, "
          f"{b['ms'] / ms:.3f} of it; {occ['registers']} registers, "
          f"{occ['warps_per_sm']} warps an SM, on {card}")
    if not (lp_err <= LOGP_TOL and g_err <= GRAD_TOL):
        raise RuntimeError("K1 disagrees with its plain version at D = 300")


def _rel_errors(logp, grad, lp_ref, g_ref, scale, gscale, ok):
    """The largest |logp - ref| / scale and |grad - ref| / gscale over the
    finite chains, and the root mean square over chains of the first."""
    lp = (logp.double() - lp_ref).abs()[ok] / scale[ok]
    g = (grad.double() - g_ref).abs()[ok] / gscale[ok]
    return lp.max().item(), g.max().item(), lp.square().mean().sqrt().item()


def _packed_case(card: str, c: int, n: int, d: int, seed: int,
                 timing: bool = False) -> dict:
    """K2 against its plain version at c x n x d, with one NaN chain: the
    reference is the plain version in float64 on the same bf16 halves
    (exact there, and run with TF32 off), so the kernel's difference is its
    own float32 sums.  logp to ``LOGP_TOL`` of sum_n |term_n|, each
    gradient component to ``LOGP_TOL`` of sum_n |resid_n x_nd| (+ the
    prior's |s2 q|).  Prints K1's distance from the same reference on the
    same q.  With ``timing`` (config 3's shape) K2's logp must sit nearer
    its reference than K1's does, in the root mean square over chains
    (the gradient is printed only: K2's backward is K1's, so the two share
    its rounding), and K2, its plain version, the library composition and
    K1 are timed beside the bound, K2 and K1 in alternating pairs."""
    import statistics

    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_PACKED, logistic_planes, logistic_value_and_grad,
        logistic_value_and_grad_packed, logistic_value_and_grad_packed_plain,
        split_bf16)
    from inplacedhmc_tpu_torch.sample import f32_matmuls

    x, y, beta = synthetic_data(seed, n, d, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = beta + 0.1 * torch.randn((c, d), generator=gen, device="cuda")
    q[1, min(3, d - 1)] = float("nan")
    w = torch.ones_like(y)
    s2 = INV_VAR
    x_hi, x_lo = split_bf16(x)
    before = LOGISTIC_PACKED.launches
    logp, grad = logistic_value_and_grad_packed(q, x_hi, x_lo, x, y, w, s2)
    torch.cuda.synchronize()
    if LOGISTIC_PACKED.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K2 on a CUDA tensor")
    q64, x64, y64, w64 = (t.double() for t in (q, x, y, w))
    with f32_matmuls():
        lp_ref, g_ref = logistic_value_and_grad_packed_plain(
            q64, x_hi, x_lo, x64, y64, w64, s2)
    eta = q64 @ x64.T
    scale = (w64 * (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta))
             ).abs().sum(1) + 0.5 * s2 * (q64 * q64).sum(1)
    gscale = ((y64 - torch.sigmoid(eta)) * w64).abs() @ x64.abs() \
        + s2 * q64.abs()
    ok = torch.isfinite(lp_ref)
    if not (torch.equal(torch.isfinite(logp), ok) and logp[1] == -torch.inf
            and bool((grad[1] == 0).all())):
        raise RuntimeError("K2 guard: the NaN chain must give -inf and a "
                           "zero gradient, and only it")
    lp_err, g_err, lp_rms = _rel_errors(logp, grad, lp_ref, g_ref, scale,
                                        gscale, ok)
    abs_err = max((logp.double() - lp_ref).abs()[ok].max().item(),
                  (grad.double() - g_ref).abs()[ok].max().item())
    lp1, g1 = logistic_value_and_grad(q, x, y, w, s2)
    k1_lp, k1_g, k1_rms = _rel_errors(lp1, g1, lp_ref, g_ref, scale, gscale,
                                      ok)
    print(f"[k2] {c} x {n} x {d}: logp err / sum|terms| = {lp_err:.3e} "
          f"(rms over chains {lp_rms:.3e}), grad err / sum|resid x| = "
          f"{g_err:.3e} (tol {LOGP_TOL:g} each), max abs err {abs_err:.3e}; "
          f"K1 on the same q from the same reference: logp {k1_lp:.3e} "
          f"(rms {k1_rms:.3e}), grad {k1_g:.3e}")
    if not (lp_err <= LOGP_TOL and g_err <= LOGP_TOL):
        raise RuntimeError(f"K2 disagrees with its plain version at {c} x "
                           f"{n} x {d}")
    out = {"name": "logistic_value_and_grad_packed", "route": "cuda",
           "source": "inplacedhmc_tpu_torch/csrc/logistic_vg.cu",
           "replaces": "inplacedhmc_tpu/ops/logistic_pallas.py:161",
           "launches": None, "max_abs_err": abs_err}
    if not timing:
        return out
    if not lp_rms < k1_rms:
        raise RuntimeError(f"K2's logp is no nearer its packed plain version "
                           f"than K1's float32 forward ({lp_rms:.3e} >= "
                           f"{k1_rms:.3e}): the packed forward did not run")
    qf = q.clone()
    qf[1, min(3, d - 1)] = 0.0
    planes = {f: logistic_planes(x, y, w, f, x_hi, x_lo)
              for f in ("packed", "f32")}
    runs = {"K2": lambda: logistic_value_and_grad_packed(
        qf, x_hi, x_lo, x, y, w, s2, planes=planes["packed"]),
        "K1": lambda: logistic_value_and_grad(qf, x, y, w, s2,
                                              planes=planes["f32"])}
    times = {"K2": [], "K1": []}
    for i in range(PAIRS):
        for name in (("K2", "K1") if i % 2 == 0 else ("K1", "K2")):
            times[name].append(cuda_time_ms(runs[name]))
    ms, k1_ms = (statistics.median(times[k]) for k in ("K2", "K1"))
    ratio = statistics.median(a / b for a, b in zip(times["K2"],
                                                    times["K1"]))
    with f32_matmuls():
        plain_ms = cuda_time_ms(lambda: logistic_value_and_grad_packed_plain(
            qf, x_hi, x_lo, x, y, w, s2))
        library_ms = cuda_time_ms(lambda: _library_logistic(qf, x, y, w, s2))
    b = logistic_bound(c, n, d, "packed")
    bound_ms, bound_by = b["ms"], b["by"]
    print(f"[k2] {card}: kernel {ms:.4f} ms, K1 on the same inputs "
          f"{k1_ms:.4f} ms (medians of {PAIRS} alternating pairs; K2 / K1 "
          f"{ratio:.4f}), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, {b['text']}, {bound_ms / ms:.3f} of the "
          f"bound")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    return out


def _bf16_loaded(shape, gen):
    """Float32 values just above 0.5 (bfloat16 hi halves in [0.5, 0.5625],
    where an ulp, 2^-8, is 2^-7 of the value) whose lo half is 0.45 of an
    ulp: the packed forward's dropped q_lo x_lo terms, each about 1.2e-5 of
    its q x, then add up with one sign."""
    import torch
    hi = (0.5 + 0.0625 * torch.rand(shape, generator=gen, device="cuda")) \
        .to(torch.bfloat16).float()
    return hi + 0.45 * 2.0 ** -8


def check_packed_separates(card: str) -> None:
    """K2 and K1 on inputs where the packed forward's lo.lo term, which it
    drops, adds up (``_bf16_loaded`` q and x, y = 0, so each observation's
    term is about -eta, at 1.2e-5 of it from the float32 forward's): 256
    chains x 8 observations x 16, few sums, so little rounding beside that
    term.  K2's logp must agree with its plain version to ``LOGP_TOL`` and
    sit ten times nearer it than K1's float32 forward does."""
    import torch

    from inplacedhmc_tpu_torch.ops.logistic import (
        logistic_value_and_grad, logistic_value_and_grad_packed,
        logistic_value_and_grad_packed_plain, split_bf16)
    from inplacedhmc_tpu_torch.sample import f32_matmuls

    c, n, d = 256, 8, 16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    q, x = _bf16_loaded((c, d), gen), _bf16_loaded((n, d), gen)
    y = torch.zeros((n,), device="cuda")
    w = torch.ones_like(y)
    x_hi, x_lo = split_bf16(x)
    lp2, _ = logistic_value_and_grad_packed(q, x_hi, x_lo, x, y, w, INV_VAR)
    lp1, _ = logistic_value_and_grad(q, x, y, w, INV_VAR)
    with f32_matmuls():
        ref, _ = logistic_value_and_grad_packed_plain(
            q.double(), x_hi, x_lo, x.double(), y.double(), w.double(),
            INV_VAR)
    eta = q.double() @ x.double().T
    scale = (eta + torch.log1p(torch.exp(-eta))).sum(1) \
        + 0.5 * INV_VAR * (q.double() ** 2).sum(1)
    err2 = ((lp2.double() - ref).abs() / scale).max().item()
    err1 = ((lp1.double() - ref).abs() / scale).max().item()
    print(f"[k2] {c} x {n} x {d}, the lo.lo terms of one sign: logp err / "
          f"sum|terms| K2 {err2:.3e} (tol {LOGP_TOL:g}), K1's float32 "
          f"forward {err1:.3e} from the same packed reference")
    if not (err2 <= LOGP_TOL and err2 < err1 / 10):
        raise RuntimeError("K2's packed forward is not told apart from K1's "
                           "float32 forward")


def check_packed_kernel(card: str) -> dict:
    """K2 at config 3's shape (timed) and at ``PACKED_CASES``, the inputs
    that tell it from K1 (``check_packed_separates``).  Returns config 3's
    case."""
    main = _packed_case(card, C, N, D, SEED, timing=True)
    for i, (c, n, d) in enumerate(PACKED_CASES):
        _packed_case(card, c, n, d, SEED + 10 + i)
    check_packed_separates(card)
    return main


def check_grad_bf16_kernel(card: str) -> dict:
    """K1 with ``grad_bf16`` against its plain version with it, in float64,
    at C x N x D with one NaN chain: logp equal to K1's without the option
    (the forward is untouched), the gradient to ``GRAD_TOL`` of max|grad|
    (the residual rounds from float32 on both sides, so a residual on a
    bf16 tie may round apart: one ulp of 2^-8 in a sum of 10^4 terms) and
    five times nearer that reference than the float32 backward is."""
    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.logistic import (
        LOGISTIC_VG, logistic_planes, logistic_value_and_grad,
        logistic_value_and_grad_plain)

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q = beta + 0.1 * torch.randn((C, D), generator=gen, device="cuda")
    q[1, 3] = float("nan")
    w = torch.ones_like(y)
    before = LOGISTIC_VG.bf16_launches
    logp, grad = logistic_value_and_grad(q, x, y, w, INV_VAR, grad_bf16=True)
    torch.cuda.synchronize()
    if LOGISTIC_VG.bf16_launches != before + 1:
        raise RuntimeError("the wrapper did not launch K1 with grad_bf16")
    lp32, g32 = logistic_value_and_grad(q, x, y, w, INV_VAR)
    lp_ref, g_ref = logistic_value_and_grad_plain(
        *(t.double() for t in (q, x, y, w)), INV_VAR, grad_bf16=True)
    ok = torch.isfinite(lp_ref)
    top = g_ref[ok].abs().max()
    g_err = ((grad.double() - g_ref).abs()[ok].max() / top).item()
    shift = ((g32.double() - g_ref).abs()[ok].max() / top).item()
    abs_err = (grad.double() - g_ref).abs()[ok].max().item()
    print(f"[k1-bf16] grad err / max|grad| = {g_err:.3e} (tol {GRAD_TOL:g}, "
          f"and below a fifth of the float32 backward's {shift:.3e}); logp "
          f"equal to K1's without the option: "
          f"{bool(torch.equal(logp, lp32))}")
    if not (torch.equal(logp, lp32) and g_err <= GRAD_TOL
            and g_err < shift / 5 and bool((grad[~ok] == 0).all())):
        raise RuntimeError("K1 with grad_bf16 disagrees with its plain "
                           "version, or is not told apart from the float32 "
                           "backward")
    qf = q.clone()
    qf[1, 3] = 0.0
    plane = logistic_planes(x, y, w, "grad_bf16")
    ms = cuda_time_ms(lambda: logistic_value_and_grad(
        qf, x, y, w, INV_VAR, grad_bf16=True, planes=plane))
    plain_ms = cuda_time_ms(lambda: logistic_value_and_grad_plain(
        qf, x, y, w, INV_VAR, grad_bf16=True))
    library_ms = cuda_time_ms(lambda: _library_logistic(
        qf, x, y, w, INV_VAR, grad_bf16=True))
    b = logistic_bound(C, N, D, "grad_bf16")
    bound_ms, bound_by = b["ms"], b["by"]
    print(f"[k1-bf16] {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (the backward a cuBLAS bf16 product) {library_ms:.4f} "
          f"ms, {b['text']}, {bound_ms / ms:.3f} of the bound")
    return {"name": "logistic_value_and_grad_grad_bf16", "route": "cuda",
            "source": "inplacedhmc_tpu_torch/csrc/logistic_vg.cu",
            "replaces": "inplacedhmc_tpu/ops/logistic_pallas.py:131",
            "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _library_multistep(q, p, eps, lam, minv, k: int):
    """A torch composition of ``k`` steps (fused multiply-adds, addcmul).
    A yardstick only; the port never calls it."""
    import torch
    half = (0.5 * eps)[:, None]
    e = eps[:, None]
    for _ in range(k):
        p = torch.addcmul(p, half, lam * q, value=-1.0)
        q = torch.addcmul(q, e, minv * p)
        p = torch.addcmul(p, half, lam * q, value=-1.0)
    return q, p


def multistep_case(card: str, c: int, d: int, k: int, seed: int,
                   timing: bool = False) -> dict:
    """K4 at c x d x k against its plain version and against k chained K3
    launches on the same inputs: equal bit for bit (the same float32
    operations in the same order), else within k gamma_4 of each value's
    magnitude (Higham's bound for the step's four roundings), which this
    script reports; with ``timing``, timed beside the plain version, a
    torch composition and the bound."""
    import torch

    from inplacedhmc_tpu_torch.ops.leapfrog import (
        LEAPFROG_MULTISTEP, fused_gaussian_leapfrog, multi_step_leapfrog,
        multi_step_leapfrog_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lam = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    q = torch.randn((c, d), generator=gen, device="cuda")
    p = torch.randn((c, d), generator=gen, device="cuda") / minv.sqrt()
    eps = 0.05 * torch.where(torch.rand((c,), generator=gen, device="cuda")
                             < 0.5, 1.0, -1.0)
    before = LEAPFROG_MULTISTEP.launches
    got = multi_step_leapfrog(q, p, eps, lam, minv, k)
    torch.cuda.synchronize()
    if LEAPFROG_MULTISTEP.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K4 on a CUDA tensor")
    want = multi_step_leapfrog_plain(q, p, eps, lam, minv, k)
    chain = (q, p)
    for _ in range(k):
        chain = fused_gaussian_leapfrog(chain[0], chain[1], eps, lam,
                                        minv)[:2]
    gamma = k * 4 * 2.0 ** -24 / (1 - 4 * 2.0 ** -24)
    abs_err, verdict = 0.0, []
    for other, label in ((want, "plain"), (chain, f"{k} K3 launches")):
        equal = all(torch.equal(a, b) for a, b in zip(got, other))
        err = max((a - b).abs().max().item() for a, b in zip(got, other))
        within = all(bool(((a - b).abs() <= gamma * b.abs().clamp(min=1.0)
                           ).all()) for a, b in zip(got, other))
        abs_err = max(abs_err, err)
        verdict.append(f"{label}: {'equal bit for bit' if equal else ''}"
                       f"{'' if equal else f'max abs err {err:.3e}'}")
        if not (equal or within):
            raise RuntimeError(f"K4 at {c} x {d}, k = {k} disagrees with "
                               f"{label} beyond k gamma_4 ({err:.3e})")
    print(f"[k4] {c} x {d}, k = {k}: against " + "; ".join(verdict))
    out = {"name": "multi_step_leapfrog", "route": "cuda",
           "source": "inplacedhmc_tpu_torch/csrc/leapfrog_gaussian.cu",
           "replaces": "inplacedhmc_tpu/ops/leapfrog_pallas.py:95",
           "launches": None, "max_abs_err": abs_err}
    if not timing:
        return out
    ms = cuda_time_ms(lambda: multi_step_leapfrog(q, p, eps, lam, minv, k))
    plain_ms = cuda_time_ms(
        lambda: multi_step_leapfrog_plain(q, p, eps, lam, minv, k))
    library_ms = cuda_time_ms(
        lambda: _library_multistep(q, p, eps, lam, minv, k))
    flops = 8.0 * c * d * k
    nbytes = 4.0 * (4 * c * d + c + 2 * d)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[k4] {card}: kernel {ms:.4f} ms per launch ({ms / k * 1e3:.3f} "
          f"us per step), plain {plain_ms:.4f} ms, torch composition "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    return out


def check_multistep_kernel(card: str) -> dict:
    """K4 at ``MULTISTEP_CASES`` (the first timed), then its own path, the
    roofline harness ``tools/roofline_torch.py --quick``: it must exit 0,
    and K4's launches there are its launch count.  Returns the first
    case."""
    main = None
    for i, (c, d, k) in enumerate(MULTISTEP_CASES):
        entry = multistep_case(card, c, d, k, SEED + 20 + i, timing=i == 0)
        main = main or entry
    from inplacedhmc_tpu_torch.ops.leapfrog import LEAPFROG_MULTISTEP
    sass_counts(LEAPFROG_MULTISTEP, lambda name: "leapfrog" in name,
                ("LDL", "STL", "BAR"))
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "roofline_torch.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, tool, "--quick"],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[roofline] {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"tools/roofline_torch.py --quick exited "
                           f"{proc.returncode}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    k4 = [r for r in rows if r["kernel"].startswith("multi_step_leapfrog")]
    if len(rows) != 3 or len(k4) != 1 or not k4[0]["launches"] > 0:
        raise RuntimeError(f"the roofline harness did not run K4: {rows}")
    main["launches"] = k4[0]["launches"]
    print(f"[roofline] {time.perf_counter() - t0:.2f} s; K4 "
          f"{k4[0]['launches']} launches, {k4[0]['step_us']:.4f} us per step, JAX's "
          f"single-step ideal / step {k4[0]['ideal_over_step']:.3f}")
    return main


def _library_leapfrog(q, p, eps, lam, minv):
    """A torch composition of the same step: fused multiply-adds (addcmul)
    and row dot products (vecdot).  A yardstick only; the port never calls
    it."""
    import torch
    half = (0.5 * eps)[:, None]
    p_mid = torch.addcmul(p, half, lam * q, value=-1.0)
    q_new = torch.addcmul(q, eps[:, None], minv * p_mid)
    grad = -(lam * q_new)
    p_new = torch.addcmul(p_mid, half, grad)
    psharp = minv * p_new
    return (q_new, p_new, grad, -0.5 * torch.linalg.vecdot(lam * q_new, q_new),
            0.5 * torch.linalg.vecdot(p_new, psharp), psharp)


def leapfrog_case(card: str, c: int, d: int, seed: int) -> dict:
    """K3 against its plain version at c x d, with a non-identity diagonal
    metric and step sizes of both signs, timed beside the plain version, a
    torch composition and the bound."""
    import torch

    from inplacedhmc_tpu_torch.ops.leapfrog import (
        LEAPFROG_GAUSSIAN, fused_gaussian_leapfrog,
        fused_gaussian_leapfrog_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lam = torch.ones((d,), device="cuda")
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    q = torch.randn((c, d), generator=gen, device="cuda")
    p = torch.randn((c, d), generator=gen, device="cuda") / minv.sqrt()
    eps = 0.3 * torch.where(torch.rand((c,), generator=gen, device="cuda")
                            < 0.5, 1.0, -1.0)
    before = LEAPFROG_GAUSSIAN.launches
    got = fused_gaussian_leapfrog(q, p, eps, lam, minv)
    torch.cuda.synchronize()
    if LEAPFROG_GAUSSIAN.launches != before + 1:
        raise RuntimeError("the wrapper did not launch K3 on a CUDA tensor")
    want = fused_gaussian_leapfrog_plain(q, p, eps, lam, minv)
    # the vectors are the same f32 operations in the same order (no FMA
    # contraction in the kernel): equal to 1e-6 relative; the row sums add
    # D terms in another order: 1e-5 of the sum of |terms|
    q_new, p_new = want[0], want[1]
    scales = ((lam * q_new * q_new).abs().sum(1),
              (p_new * minv * p_new).abs().sum(1))
    abs_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        abs_err = max(abs_err, err.max().item())
        lim = 1e-5 * scales[i - 3] if i in (3, 4) else 1e-6 * w.abs()
        if not bool((err <= lim).all()):
            raise RuntimeError(f"K3 output {i} disagrees with its plain "
                               f"version at {c} x {d} (max abs err "
                               f"{err.max().item():.3e})")
    ms = cuda_time_ms(lambda: fused_gaussian_leapfrog(q, p, eps, lam, minv))
    plain_ms = cuda_time_ms(
        lambda: fused_gaussian_leapfrog_plain(q, p, eps, lam, minv))
    library_ms = cuda_time_ms(lambda: _library_leapfrog(q, p, eps, lam, minv))
    # q, p in; q', p', grad', p#' out (the TPU kernel's 6 [C, D] arrays),
    # plus the [C] and [D] vectors; 12 flops per element (its cost estimate)
    nbytes = 4.0 * (6 * c * d + 3 * c + 2 * d)
    bound_ms, bound_by = bound(12.0 * c * d, nbytes)
    print(f"[k3] {c} x {d}: max abs err {abs_err:.3e}; {card}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch composition "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.3f} MB), {nbytes / ms / 1e6:.1f} GB/s achieved")
    return {"name": "fused_gaussian_leapfrog", "route": "cuda",
            "source": "inplacedhmc_tpu_torch/csrc/leapfrog_gaussian.cu",
            "replaces": "inplacedhmc_tpu/ops/leapfrog_pallas.py:38",
            "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_leapfrog_kernel(card: str) -> dict:
    """K3 at the shape its main path gives it (the lockstep run of the
    1000-D normal at 64 chains: one [64, 1000] step per leaf), and at
    10,240 x 100 as an extra check of a bandwidth-sized launch.  Returns
    the main path's case."""
    main = leapfrog_case(card, S_CHAINS, W_DIM, SEED + 2)
    leapfrog_case(card, G_CHAINS, G_DIM, SEED + 5)
    return main


def tree_bound(c: int, d: int, out, form: str = "array",
               physics: str = "gaussian", dense: bool = False,
               n_obs: int = 0, grad_bf16: bool = False) -> tuple:
    """K5's bound for one launch on these inputs, over the steps this data
    needs.  Operations: about 25 D flops per leapfrog leaf (the update 8,
    the two row sums 5, the guards 4, the momentum sum 1, the expected
    single U-turn level 5, the p# 1, and the selects; the Gaussian's
    log density and gradient are among them), plus the physics' own
    (``PHYSICS_COST``) at every leaf, every start and the final gradient;
    where the kernel draws, ``PHILOX_OPS`` per uniform it reads (one per
    leaf, one per successful doubling) and, under ``refresh``, per
    direction word and per normal, with ``BOX_MULLER_FLOPS`` per normal;
    special functions (``PEAK_SFU``): ``TREE_SFU_PER_LEAF`` and the
    physics' per leaf, 3 per successful doubling (the merge's log and
    logaddexp), 3 per normal.  Bytes: q, eps, valid, the physics' data
    rows, minv in; the K transitions' q and eight [C] records out (logp,
    energy, log_sum_alpha, term, term_left, term_right, depth, steps: the
    TPU kernel's outputs; the last q is the carry) and the final grad; for
    ``array`` and ``prng`` the momentum and direction words in, for
    ``array`` the uniforms the trees read.  ``form``: ``"array"``
    (explicit uniforms), ``"prng"`` (uniforms drawn) or ``"refresh"``
    (everything drawn).  Each [D, D] product (a dense metric's p# at every
    leaf twice and at every start once, the start's kinetic energy; a merge
    takes the new end's p# from its last leaf; the refresh's momentum once
    per transition; the dense Gaussian's P q at every evaluation) adds
    2 D^2 flops, and each matrix its D^2 floats read once.  A physics
    over ``n_obs`` observations (logistic regression) adds per evaluation
    4 D flops per observation for its two products, ``LOGISTIC_OBS_FLOPS``
    and ``LOGISTIC_OBS_SFU`` more per observation, and its observation
    matrix and two rows read once; a physics with special functions on its
    lanes (``PHYSICS_LANE_SFU``) adds those per evaluation.  The two
    products, 2 N D flops each, count as ``logistic_bound`` counts K1's,
    whatever implements them: the float32-grade ones (both, or under
    ``grad_bf16`` the forward) at the lesser of the fp32 FMA pipe and three
    TF32 passes on the tensor cores, ``grad_bf16``'s backward one bf16
    pass."""
    from inplacedhmc_tpu_torch.ops.tile_physics import PHYSICS
    k = out.q.shape[0] if out.q.ndim == 3 else 1
    steps = float(out.steps.sum())
    merges = float(out.depth.sum())
    draws = steps + merges
    lane_flops, chain_flops, phys_sfu = PHYSICS_COST[physics]
    evals = steps + k * c + c
    lanes = {"gaussian": 0, "eight_schools": d - 2, "funnel": d - 1,
             "dense_gaussian": d, "logistic": d, "stoch_vol": d - 2}[physics]
    flops = 25.0 * d * steps + (lane_flops * lanes + chain_flops) * evals
    flops += LOGISTIC_OBS_FLOPS * n_obs * evals
    prod = 2.0 * d * n_obs * evals          # one of the two products
    f32_grade = (1 if grad_bf16 else 2) * prod
    bf16_flops = prod if grad_bf16 else 0.0
    phys_mat = PHYSICS[physics].matrix is not None
    products = phys_mat * evals
    if dense:
        products += 2 * steps + k * c + (k * c if form == "refresh" else 0)
    flops += 2.0 * d * d * products
    sfu = TREE_SFU_PER_LEAF * steps + 3 * merges + phys_sfu * evals \
        + LOGISTIC_OBS_SFU * n_obs * evals \
        + PHYSICS_LANE_SFU.get(physics, 0) * lanes * evals
    n_rows = len(PHYSICS[physics].rows) + (0 if dense else 1)
    n_mats = phys_mat + dense * (1 + (form == "refresh"))
    nbytes = 4.0 * (c * d + 2 * c + n_rows * d + n_mats * d * d) \
        + 4.0 * (k * c * d + 8 * k * c + c * d) + 4.0 * n_obs * (d + 2)
    if form == "refresh":
        flops += PHILOX_OPS * (draws + k * c * (d + 1)) \
            + BOX_MULLER_FLOPS * k * c * d
        sfu += 3 * k * c * d
        nbytes += 0.0 if dense else 4.0 * d
    else:
        nbytes += 4.0 * (k * c * d + k * c)
        if form == "array":
            nbytes += 4.0 * draws
        else:
            flops += PHILOX_OPS * draws
    fma = bound(flops + f32_grade, nbytes, sfu, tc_flops=bf16_flops)
    tf32 = bound(flops, nbytes, sfu, tc_flops=bf16_flops,
                 tf32_flops=3 * f32_grade)
    return (*min(fma, tf32), steps)


def _gamma(n: int) -> float:
    """gamma_n = n u / (1 - n u), u = 2^-24: an f32 sum of n terms is within
    gamma_n of the sum of its terms' magnitudes (Higham, Accuracy and
    Stability of Numerical Algorithms, section 3.1)."""
    nu = n * 2.0 ** -24
    return nu / (1 - nu)


def grad_bound(phys):
    """``compare_tree``'s bound on the difference of two gradients that are
    long sums whose terms cancel, ``bound(q_got, q_want) -> [C, D]``
    (float64), or ``None`` for a physics without one (its gradient is held
    to TREE_RTOL alone).  The dense Gaussian, ``grad = -(q P)``: the
    proposals' difference carried through P and each f32 product within
    gamma_D of its terms, ``|dq| |P| + 2 gamma_D |q| |P|``.  Logistic
    regression, ``grad = -inv_var q + sum_n r_n x_n``, with ``A = |X|^T |X|
    / 4 + inv_var I`` (the sigmoid's slope is at most 1/4): ``|dq| A`` (the
    proposals' difference); ``(gamma_D + t_f) |q| A``, each side's eta
    carried through the sigmoid: the plain version's float32 sum within
    gamma_D, the kernel's 3xTF32 product within ``t_f = 3 2^-22 + (k + 2)
    2^-23 + n_c u`` of its terms' magnitudes (the dropped lo.lo term and
    the halves' roundings, a tensor-core sum of k = min(D, 64) terms that
    may truncate, 2^-23 a term, and the float32 adds of the n_c chunks of
    64 dimensions: ``tests/test_torch_tf32.py``'s model of K1's products);
    ``(gamma_N + 6 u + t_b + 6 u) sum_n |x_n|``, each side's backward sum
    of N terms and a few roundings of each residual, which is at most 1:
    the plain version's float32 sum within gamma_N, the kernel's within
    ``t_b = 3 2^-22 + 34 2^-23 + gamma_(ceil(N / 32) + 18)`` (3xTF32
    products summed 32 observations at a time on the tensor cores, then
    added in float32 over the tiles and at most 16 groups of warps; under
    grad_bf16 the products are exact and the 3 2^-22 drops)."""
    import torch
    if phys.name == "dense_gaussian":
        a = phys.matrix().abs().double()
        g = _gamma(a.shape[0])
        return lambda qg, qw: ((qg - qw).abs().double() @ a
                               + 2 * g * (qw.abs().double() @ a))
    if phys.name == "logistic":
        xa = phys.obs_matrix().abs().double()
        d = xa.shape[1]
        n = int(phys.data["w"].sum())
        u = 2.0 ** -24
        a = 0.25 * (xa.T @ xa) + phys.data["inv_var"] * torch.eye(
            d, dtype=torch.float64, device=xa.device)
        t_f = 3 * 2.0 ** -22 + (min(d, 64) + 2) * 2.0 ** -23 \
            + math.ceil(d / 64) * u
        t_b = (0.0 if phys.data["grad_bf16"] else 3 * 2.0 ** -22) \
            + 34 * 2.0 ** -23 + _gamma(math.ceil(n / 32) + 18)
        eta = _gamma(d) + t_f
        col = (_gamma(n) + 6 * u + t_b + 6 * u) * xa.sum(0)
        return lambda qg, qw: ((qg - qw).abs().double() @ a
                               + eta * (qw.abs().double() @ a) + col)
    return None


def _n_obs(phys) -> int:
    """The observations of a physics with an observation matrix (the sum of
    its weights: the padding weighs 0), else 0."""
    return 0 if phys.obs_matrix() is None else int(phys.data["w"].sum())


def _grad_bf16(phys) -> bool:
    """Whether a physics rounds its backward product to bfloat16 (logistic
    regression's ``grad_bf16``)."""
    return bool(phys.data.get("grad_bf16", 0))


def _long_sums(phys, d: int) -> bool:
    """Whether the log density sums so many terms that its rounding
    difference can exceed TREE_RTOL of a log_sum_alpha of order 1
    (``compare_tree``'s ``lsa_bound``): logistic regression's N
    observations, or more than 256 coordinates (K5's wide form)."""
    return (phys is not None and _n_obs(phys) > 0) or d > 256


def sv_terms(phys, q):
    """Stochastic volatility's scales at ``q [C, D]``, float64: per chain
    the sum of the magnitudes of the log density's terms, and per gradient
    component the sum of its terms' magnitudes
    (``tests/test_torch_stoch_vol.py::_terms`` in torch); 0 where they are
    not finite (a saturated tanh)."""
    import torch
    q = q.double()
    r2, hm, am = (phys.data[k].double() for k in ("r2", "h_mask", "ar_mask"))
    hm, am = hm != 0, am != 0
    t = float(phys.data["t"])
    raw_phi, log_s = q[:, :1], q[:, 1:2]
    phi, inv_s = torch.tanh(raw_phi), torch.exp(-log_s)
    u = 1.0 - phi * phi
    z1 = q[:, 2:3] * inv_s
    h = torch.where(hm, q, 0.0)
    hprev = torch.nn.functional.pad(h[:, :-1], (1, 0))
    innov = torch.where(am, (q - phi * hprev) * inv_s, 0.0)
    re = r2 * torch.exp(-h)
    lp = (0.5 * (raw_phi - 1.5) ** 2 + 0.5 * (log_s + 2.0) ** 2
          + 0.5 * torch.log(u).abs() + t * log_s.abs()
          + 0.5 * u * z1 * z1)[:, 0] + 0.5 * (innov ** 2).sum(1) \
        + torch.where(hm, 0.5 * (h.abs() + re), 0.0).sum(1)
    nxt = torch.nn.functional.pad(innov[:, 1:], (0, 1)).abs()
    g = torch.where(hm, 0.5 * re + 0.5 + innov.abs() * inv_s
                    + phi.abs() * inv_s * nxt, 0.0)
    g[:, 2] += (u * z1.abs() * inv_s)[:, 0]
    g[:, 0] = (((raw_phi - 1.5).abs() + phi.abs() + u * (
        phi.abs() * z1 * z1
        + inv_s * (innov * hprev).abs().sum(1, keepdim=True))))[:, 0]
    g[:, 1] = ((log_s + 2.0).abs() + t + u * z1 * z1)[:, 0] \
        + (innov ** 2).sum(1)
    return (torch.nan_to_num(lp, nan=0.0, posinf=0.0),
            torch.nan_to_num(g, nan=0.0, posinf=0.0))


def _terms_of(phys, d: int):
    """``compare_tree``'s ``terms`` for ``phys`` at ``d``: ``sv_terms``
    for stochastic volatility above D = 256, else None."""
    if phys.name != "stoch_vol" or d <= 256:
        return None
    return functools.partial(sv_terms, phys)


def compare_tree(got, want, label: str, bound=None, grad_q=None,
                 replay=None, lsa_bound: bool = False, terms=None) -> float:
    """K5 against its plain version: the chains whose integer fields differ,
    or whose float fields differ beyond TREE_RTOL, may be at most
    TREE_MISMATCH_FRACTION of all, not counting the verified ties below;
    returns the largest absolute difference over the other chains.  With
    ``bound`` (``grad_bound``: a gradient that is a long sum whose
    components cancel), a gradient component also agrees within
    ``bound(q_got, q_want)``.  ``lsa_bound``, for a log density that is a
    sum over N observations (logistic regression): its rounding difference
    e (the largest energy difference of the chains that agree so far) can
    exceed TREE_RTOL of a log_sum_alpha of order 1, so log_sum_alpha also
    agrees within 4 e; so it does for a log density over more than 256
    coordinates (``_long_sums``) (each exp(min(delta, 0)) has a delta that is a
    difference of two joint densities, the argument below).  ``grad_q``:
    the kernel's and the plain version's
    positions of the gradients, where those are not ``got.q`` and
    ``want.q`` (a sweep's final gradient beside its first transition).

    A verified tie (``replay``): a proposal's test ``log u < x`` decides the
    other way when x lies within the two sides' rounding difference of
    log u.  Each side of a test is a difference of two joint densities (one
    of them through a logaddexp), so it differs by at most 4 e, e the
    largest energy difference of the agreeing chains; where no chain agrees
    but bit for bit, e is 0 and no tie can be verified.  ``replay(rows,
    shift)`` runs the plain version on those chains with every uniform
    times exp(shift); a differing chain is a verified tie when the shift
    -4e or +4e gives the kernel's integer fields and its q, logp, energy
    and log_sum_alpha (by the rule above).  A NaN agrees with a NaN in the
    same place (``same_value``): a gradient component that is NaN on both
    sides, as stochastic volatility's d/draw_phi where tanh saturates.
    ``terms`` (``sv_terms``: stochastic volatility above D = 256): q, logp,
    energy and grad also agree within ``LONG_SUM_K`` gamma_D of their
    scales (``1 + |q|``, the log density's terms' magnitudes, those plus
    the kinetic energy, each gradient component's terms' magnitudes), here
    and in the replay."""
    import torch
    c = got.q.shape[0]
    q_got, q_want = (got.q, want.q) if grad_q is None else grad_q
    ints = ("term", "term_left", "term_right", "depth", "steps")
    bad = torch.zeros((c,), dtype=torch.bool, device=got.q.device)
    for f in ints:
        bad |= getattr(got, f) != getattr(want, f)
    n_int = int(bad.sum())

    scale = {}
    if terms is not None:
        gam = LONG_SUM_K * _gamma(got.q.shape[1])
        lp_t, g_t = terms(want.q)[0], terms(q_want)[1]
        kin = (want.logp - want.energy).abs().double()
        scale = {"q": gam * (1 + want.q.abs().double()), "logp": gam * lp_t,
                 "energy": gam * (lp_t + kin), "grad": gam * g_t}

    def agree(g, w, f=None, rows=None):
        same = same_value(g, w) \
            | ((g - w).abs() <= TREE_RTOL * (1 + w.abs()))
        if f in scale:
            sc = scale[f] if rows is None else scale[f][rows]
            same |= (g - w).abs().double() <= sc
        return same

    def agree_lsa(g, w, e):
        same = agree(g, w)
        return same | ((g - w).abs() <= 4 * e) if lsa_bound else same

    diffs, n_field = {}, {}
    for f in ("q", "logp", "grad", "energy", "log_sum_alpha"):
        g, w = getattr(got, f), getattr(want, f)
        same = agree(g, w, f)
        if f == "grad" and bound is not None:
            same |= (g - w).abs().double() <= bound(q_got, q_want)
        if f == "log_sum_alpha":
            e_now = diffs["energy"][~bad]
            same = agree_lsa(g, w, e_now.max() if len(e_now) else 0.0)
        if same.ndim == 2:
            same = same.all(dim=1)
        n_field[f] = int((~same).sum())
        bad |= ~same
        d = torch.where(same_value(g, w), torch.zeros_like(g),
                        (g - w).abs())
        diffs[f] = d if d.ndim == 1 else d.amax(dim=1)
    ok = ~bad
    err = {f: (v[ok].max().item() if bool(ok.any()) else 0.0)
           for f, v in diffs.items()}
    if scale:
        # the K each field needs on the chains that agree: its largest
        # difference beyond TREE_RTOL over gamma_D times its scale
        need = {}
        for f, sc in scale.items():
            g, w = getattr(got, f)[ok], getattr(want, f)[ok]
            unit = sc[ok] / LONG_SUM_K
            d = torch.where(same_value(g, w)
                            | ((g - w).abs() <= TREE_RTOL * (1 + w.abs())),
                            torch.zeros_like(g), (g - w).abs()).double()
            r = torch.where(unit > 0, d / unit, torch.zeros_like(d))
            need[f] = float(r.max()) if r.numel() else 0.0
            LONG_SUM_NEED[f] = max(LONG_SUM_NEED.get(f, 0.0), need[f])
        print(f"[k5] {label}: K needed by field "
              f"{({f: float(f'{v:.3g}') for f, v in need.items()})} "
              f"(LONG_SUM_K {LONG_SUM_K})")
    rows = torch.nonzero(bad).flatten()
    ties, notes = 0, []
    shift = 4.0 * err["energy"]
    if replay is not None and len(rows) and shift > 0:
        for sign in (-1.0, 1.0):
            r = replay(rows, sign * shift)
            tie = torch.ones((len(rows),), dtype=torch.bool,
                             device=rows.device)
            for f in ints:
                tie &= getattr(got, f)[rows] == getattr(r, f)
            for f in ("q", "logp", "energy", "log_sum_alpha"):
                g, w = getattr(got, f)[rows], getattr(r, f)
                same = agree_lsa(g, w, err["energy"]) \
                    if f == "log_sum_alpha" else agree(g, w, f, rows)
                tie &= same.all(dim=1) if same.ndim == 2 else same
            for i in torch.nonzero(tie).flatten().tolist():
                notes.append(f"chain {int(rows[i])} at {sign * shift:+.3g} "
                             f"(q {float(diffs['q'][rows[i]]):.3g} from the "
                             f"plain version's)")
            ties += int(tie.sum())
            rows = rows[~tie]
            if not len(rows):
                break
    n_bad = int(bad.sum())
    allowed = TREE_MISMATCH_FRACTION * c
    print(f"[k5] {label}: {n_int} chains of {c} differ in the integer fields, "
          f"{n_bad - n_int} more in a float field beyond {TREE_RTOL:g} (by "
          f"field {({f: n for f, n in n_field.items() if n})}); verified "
          f"ties {ties}{' (' + '; '.join(notes) + ')' if notes else ''}; "
          f"{n_bad - ties} counted, allowed {allowed:g}; max abs err on the "
          f"rest {max(err.values()):.3e} (by field "
          f"{({f: float(f'{v:.3e}') for f, v in err.items()})}); "
          f"terminations {torch.bincount(want.term.long(), minlength=3).tolist()}"
          f" (max depth, divergence, turning), depth mean "
          f"{want.depth.double().mean().item():.3f}")
    if n_bad - ties > allowed:
        raise RuntimeError(f"K5 disagrees with its plain version ({label})")
    return max(err.values())


def ints_differ(a, b):
    """The chains whose integer records (termination, its two ends, depth,
    steps) differ between two transitions' outputs."""
    bad = a.term != b.term
    for f in ("term_left", "term_right", "depth", "steps"):
        bad |= getattr(a, f) != getattr(b, f)
    return bad


def same_value(g, w):
    """Equal, or NaN on both sides."""
    import torch
    return (g == w) | (torch.isnan(g) & torch.isnan(w))


def _first(out):
    """A one-transition sweep's output without its sweep axis."""
    from inplacedhmc_tpu_torch.ops.tree import TreeOut
    return TreeOut(*(t if f == "grad" else t[0]
                     for f, t in zip(TreeOut._fields, out)))


def _key(seed: int):
    import torch

    from inplacedhmc_tpu_torch.utils.philox import draw_key
    return draw_key(torch.Generator(device="cuda").manual_seed(seed))


def _physics(name: str, data: dict):
    """``name``'s physics bound to ``data`` on the card in float32 (a tile
    physics with its kernel's plane, ``ops.tree.bind``)."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import bind
    return bind(name, data, "cuda", torch.float32)


def tree_form(form: str, q0, p0, e, d32, unif, phys, minv, key, md: int,
              scale=None, bf16: bool = False):
    """``(launch, plain)``: K5 with the physics ``phys`` in one of its forms
    and its plain version fed the same numbers.  ``array``: the explicit
    uniform array; ``prng``: the given momentum and directions, the
    uniforms drawn in the kernel; ``refresh``: everything drawn in the
    kernel (momentum ``sqrt_mass * xi`` with ``sqrt_mass = minv^-1/2``, or
    for a dense ``minv`` ``mass_chol xi`` with ``scale = mass_chol^T``).
    The plain version gets what the kernel's generator draws for ``key``
    (``ops.tree.philox_draws``); ``plain(rows, shift)`` runs it on those
    chains with every uniform times exp(shift) (``compare_tree``'s
    replay).  ``bf16``: both with bfloat16 checkpoint stacks.
    ``launch(path)`` forces the staged products' path (``ops.tree.
    stage_plan``; by default the plan's own)."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import (
        philox_draws, refresh_momentum, tree_sweep, tree_transition,
        tree_transition_plain)
    c, d = q0.shape
    if form == "array":
        u_plain = unif
    else:
        xi, g_dirs, g_unif = philox_draws(key, c, d, md)
        u_plain = g_unif[0]
    if form == "refresh":
        sqrt_mass = 1.0 / torch.sqrt(minv) if scale is None else scale
        p0, d32 = refresh_momentum(sqrt_mass, xi[0]), g_dirs[0]

    def plain(rows=None, shift: float = 0.0):
        r = slice(None) if rows is None else rows
        return tree_transition_plain(
            q0[r], p0[r], e[r], d32[r], u_plain[:, r] * math.exp(shift),
            phys, minv, md, -1000.0, ckpt_bf16=bf16)

    if form == "array":
        return (lambda path=None: tree_transition(
            q0, p0, e, d32, unif, phys, minv, md, -1000.0,
            ckpt_bf16=bf16, path=path), plain)
    if form == "prng":
        return (lambda path=None: tree_transition(
            q0, p0, e, d32, None, phys, minv, md, -1000.0, key=key,
            ckpt_bf16=bf16, path=path), plain)
    return (lambda path=None: _first(tree_sweep(
        q0, e, phys, minv, md, -1000.0, key=key, sqrt_mass=sqrt_mass,
        ckpt_bf16=bf16, path=path)), plain)


def check_tree_kernel(card: str, c: int = G_CHAINS, d: int = G_DIM,
                      seed: int = 3) -> None:
    """K5 against its plain version at ``c`` x ``d`` (by default 10,240 x
    100; above D = 256 its wide form, one chain per block of warps),
    max_depth 10, with the same q0, p0, directions and uniforms at three
    step sizes: 0.3 (trees of mixed depths that end in U-turns), 1.8
    (divergences, since the largest M^-1 makes the step unstable) and 0.002
    (every tree reaches max depth); in each of its three forms
    (``tree_form``), timed beside its bound."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import (TREE_GAUSSIAN, WARP_DIM,
                                                direction_words_int32,
                                                n_uniforms, wide_smem_bytes)

    md = MAX_DEPTH
    gen = torch.Generator(device="cuda").manual_seed(SEED + seed)
    lam = torch.ones((d,), device="cuda")
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    q0 = torch.randn((c, d), generator=gen, device="cuda")
    p0 = torch.randn((c, d), generator=gen, device="cuda") / minv.sqrt()
    dirs = torch.randint(0, 2 ** 32, (c,), generator=gen, dtype=torch.int64,
                         device="cuda")
    d32 = direction_words_int32(dirs)
    unif = torch.rand((n_uniforms(md), c), generator=gen, device="cuda")
    key = _key(SEED + 6 + seed)
    if d <= WARP_DIM:
        print(f"[k5] checkpoint stacks: {2 * md * d * 4} bytes of dynamic "
              f"shared memory per chain (one warp), up to 4 chains per block")
    else:
        print(f"[k5] wide form at D = {d}: one chain per block of "
              f"{-(-d // WARP_DIM)} warps, {wide_smem_bytes(d, md)} bytes of "
              f"dynamic shared memory per block")
    for eps in (0.3, 1.8, 0.002):
        e = torch.full((c,), eps, device="cuda")
        for form in ("array", "prng", "refresh"):
            launch, plain = tree_form(form, q0, p0, e, d32, unif,
                                      _physics("gaussian", {"lam": lam}),
                                      minv, key, md)
            before = TREE_GAUSSIAN.launches
            got = launch()
            torch.cuda.synchronize()
            if TREE_GAUSSIAN.launches != before + 1:
                raise RuntimeError("the wrapper did not launch K5 on a CUDA "
                                   "tensor")
            want = plain()
            tag = f"{c} x {d}, eps {eps}, {form}"
            compare_tree(got, want, tag, replay=plain,
                         lsa_bound=_long_sums(None, d))
            ms = cuda_time_ms(launch, 3 if eps < 0.01 else 20)
            bound_ms, bound_by, steps = tree_bound(c, d, want, form)
            print(f"[k5] {tag} on {card}: kernel {ms:.4f} ms; "
                  f"{steps:.0f} leapfrog steps, {steps / ms * 1e3:.4g} "
                  f"steps/s; bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.4f} of it")


def check_generator(card: str) -> None:
    """K5's generator (the source's second launcher, which runs the
    kernel's ``__device__`` Philox) against ``utils/philox.py`` on the card,
    for 10,240 chains, 100 normals, the 1,033 uniform slots of max_depth 10
    and 2 transitions: direction words and uniforms equal, normals within
    ``NORMAL_ULP`` ulp of max(1, |x|)."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import (PHILOX_DRAWS,
                                                direction_words_int32,
                                                n_uniforms, philox_draws)
    from inplacedhmc_tpu_torch.utils import philox

    c, d, md, k = G_CHAINS, G_DIM, MAX_DEPTH, 2
    key = _key(SEED + 7)
    before = PHILOX_DRAWS.launches
    normals, dirs, unif = philox_draws(key, c, d, md, k)
    torch.cuda.synchronize()
    if PHILOX_DRAWS.launches != before + 1:
        raise RuntimeError("the generator's launcher did not launch")
    rows = torch.arange(c, dtype=torch.int64, device="cuda")
    n_dirs = n_unif = 0
    worst_ulp = 0.0
    for s in range(k):
        n_dirs += int((dirs[s] != direction_words_int32(
            philox.direction_words(key, rows, s))).sum())
        n_unif += int((unif[s] != philox.uniforms(
            key, rows, s, range(n_uniforms(md)))).sum())
        want = philox.normals(key, rows, s, d)
        ulp = 2.0 ** -23 * torch.clamp(want.abs(), min=1.0)
        worst_ulp = max(worst_ulp,
                        float(((normals[s] - want).abs() / ulp).max()))
    print(f"[philox] {k} x {c} direction words: {n_dirs} differ; "
          f"{unif.numel()} uniforms: {n_unif} differ; {normals.numel()} "
          f"normals: largest difference {worst_ulp:.2f} ulp of max(1, |x|) "
          f"(allowed {NORMAL_ULP}); uniform mean "
          f"{float(unif.double().mean()):.6f}, normal mean "
          f"{float(normals.double().mean()):.6f} var "
          f"{float(normals.double().var()):.6f}")
    if n_dirs or n_unif or not worst_ulp <= NORMAL_ULP:
        raise RuntimeError("K5's generator disagrees with utils/philox.py")


def tile_model(name: str, sv_t: int = SV_T):
    """The model of a tile physics at its BASELINE width, on the card
    (stochastic volatility at ``sv_t``, ``sv_problem``)."""
    from inplacedhmc_tpu_torch.models import eight_schools, funnel, funnel_nc
    return {"eight_schools": eight_schools, "funnel": lambda: funnel(F_DIM),
            "funnel_nc": lambda: funnel_nc(F_DIM),
            "stoch_vol": lambda: sv_problem(sv_t)[0]}[name]()


@functools.lru_cache(maxsize=None)
def sv_problem(t_len: int = SV_T):
    """Stochastic volatility's data for a series of ``t_len`` returns, made
    on the card from a seeded generator by the documented recursion
    (``synthetic_returns``' recipe, kept here so that the true latents are
    known): innovations ``eps ~ N(0, SV_S^2)``, ``h_1 = eps_1 / sqrt(1 -
    SV_PHI^2)``, ``h_t = SV_PHI h_{t-1} + eps_t``, returns ``z exp(h / 2)``.
    Returns the model (``stoch_vol(returns)``), the true ``h [T]`` and the
    returns ``[T]``."""
    import torch

    from inplacedhmc_tpu_torch.models import stoch_vol

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    eps = torch.randn((t_len,), generator=gen, device="cuda") * SV_S
    h = torch.empty_like(eps)
    h[0] = eps[0] / math.sqrt(1.0 - SV_PHI * SV_PHI)
    for t in range(1, t_len):
        h[t] = SV_PHI * h[t - 1] + eps[t]
    r = torch.randn((t_len,), generator=gen, device="cuda") \
        * torch.exp(0.5 * h)
    return stoch_vol(r, device="cuda"), h, r


#: coordinate 0's value at which a model's density is not finite (the
#: funnel's exp(-v) overflows float32 at v = -95; stochastic volatility's
#: tanh(10) is 1 in float32, so log(1 - phi^2) is -inf and d/draw_phi NaN)
SATURATED = {"funnel": -95.0, "stoch_vol": SV_SATURATED}


def tile_start(name: str, c: int, gen, neck: bool = False,
               sv_t: int = SV_T):
    """Positions for ``c`` chains of a tile model at its width: normal, with
    eight schools' mu about its posterior; stochastic volatility's (at
    ``sv_t``) about the truth (raw_phi, log_s 0.2 from it, each h_t 0.3);
    with ``neck``, every 16th chain at coordinate 0's ``SATURATED`` value,
    where the density and the gradient are non-finite and the leaf's
    sanitisation runs."""
    import torch
    if name == "stoch_vol":
        h = sv_problem(sv_t)[1]
        q = torch.randn((c, sv_t + 2), generator=gen, device="cuda")
        q[:, 0] = math.atanh(SV_PHI) + 0.2 * q[:, 0]
        q[:, 1] = math.log(SV_S) + 0.2 * q[:, 1]
        q[:, 2:] = h + 0.3 * q[:, 2:]
    else:
        q = torch.randn((c, 10), generator=gen, device="cuda")
    if name == "eight_schools":
        q[:, 0] = 5.0 + 4.0 * q[:, 0]
    if neck:
        q[::16, 0] = SATURATED[name]
    return q


def check_sweep(card: str, physics: str = "gaussian",
                eps: float = 0.3, sv_t: int = SV_T) -> None:
    """One launch of ``SWEEP_CHECK_K`` transitions drawing everything itself
    against that many one-transition launches fed what the generator draws
    for its key (max_depth 10, step size ``eps``, 1 row in 1,000 padded;
    the standard normal at 10,240 x 100, or a tile model at 1,024 chains
    and its width, stochastic volatility at ``sv_t``): every field equal
    bit for bit.  Timed beside the single launches (each with its own key)
    and the bound."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import (TREE_KERNELS, TreeOut,
                                                philox_draws, tree_sweep)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    if physics == "gaussian":
        c, d = G_CHAINS, G_DIM
        data = {"lam": torch.ones((d,), device="cuda")}
        q0 = torch.randn((c, d), generator=gen, device="cuda")
    else:
        st = tile_model(physics, sv_t).structure
        data = {**st["data"], **st["scalars"]}
        q0 = tile_start(physics, E_CHAINS, gen, sv_t=sv_t)
        c, d = q0.shape
    phys = _physics(physics, data)
    md, k = MAX_DEPTH, SWEEP_CHECK_K
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    sqrt_mass = 1.0 / torch.sqrt(minv)
    e = torch.full((c,), eps, device="cuda")
    valid = (torch.arange(c, device="cuda") % 1000 != 999).to(torch.int32)
    key = _key(SEED + 9)
    kern = TREE_KERNELS[physics]
    before = kern.launches
    swept = tree_sweep(q0, e, phys, minv, md, -1000.0, k, key=key,
                       sqrt_mass=sqrt_mass, valid=valid)
    torch.cuda.synchronize()
    if kern.launches != before + 1:
        raise RuntimeError("the sweep was not one K5 launch")
    xi, dirs, unif = philox_draws(key, c, d, md, k)
    q = q0
    differ = []
    for s in range(k):
        one = tree_sweep(q, e, phys, minv, md, -1000.0,
                         momentum=(sqrt_mass * xi[s])[None],
                         dirs=dirs[s:s + 1], unif=unif[s:s + 1], valid=valid)
        differ += [f"{f}[{s}]" for f in TreeOut._fields if f != "grad"
                   and not torch.equal(getattr(swept, f)[s],
                                       getattr(one, f)[0])]
        q = one.q[0]
    if not torch.equal(swept.grad, one.grad):
        differ.append("grad")
    steps = float(swept.steps.sum())
    print(f"[sweep] {physics}, {c} x {d}: {k} transitions in one launch "
          f"against {k} launches: fields that differ {differ or 'none'}; "
          f"depth mean "
          f"{swept.depth.double().mean().item():.3f}, {steps:.0f} steps")
    if differ:
        raise RuntimeError("a K5 sweep differs from its single launches")
    # timed on a start and output buffers made beforehand: nothing but the
    # kernel is queued in the timed loop
    ms = cuda_time_ms(lambda: tree_sweep(
        q0, e, phys, minv, md, -1000.0, k, key=key, sqrt_mass=sqrt_mass,
        valid=valid, out=swept), iters=5, warmup=1)
    keys = [_key(SEED + 10 + s) for s in range(k)]
    one_ms = cuda_time_ms(lambda: [tree_sweep(
        q0, e, phys, minv, md, -1000.0, key=kk, sqrt_mass=sqrt_mass,
        valid=valid, out=one) for kk in keys], iters=5, warmup=1)
    # the single launches each start from q0: their work is not the sweep's
    one_steps = sum(float(tree_sweep(
        q0, e, phys, minv, md, -1000.0, key=kk, sqrt_mass=sqrt_mass,
        valid=valid).steps.sum()) for kk in keys)
    bound_ms, bound_by, _ = tree_bound(c, d, swept, "refresh", physics)
    print(f"[sweep] {physics} on {card}: one launch of {k} {ms:.4f} ms "
          f"({ms / k:.4f} ms per transition, {steps / ms * 1e3:.4g} "
          f"steps/s), {k} launches of one from the start {one_ms:.4f} ms "
          f"({one_steps:.0f} steps, {one_steps / one_ms * 1e3:.4g} "
          f"steps/s); bound {bound_ms:.4f} ms ({bound_by})")


def check_tile_kernel(card: str, physics: str, chain_counts, eps_list,
                      neck: bool = False, dense: bool = False,
                      sv_t: int = SV_T) -> None:
    """K5 with a tile physics against its plain version at its model's
    width, max_depth 10, for each chain count and step size, in the
    default route's form (momentum and directions from the host, the
    uniforms drawn in the kernel; the plain version fed the kernel's own):
    ``compare_tree``'s rule; timed beside its bound (3 launches where the
    trees average above depth 7, else 20).  The metric is ``0.5 +
    U(0, 1)`` on the diagonal, or with ``dense`` a dense ``M^-1``
    (``_spd``, the source's second launcher).  With ``neck`` every 16th
    chain starts where the density is not finite (``tile_start``): those
    chains must diverge at their first leaf and keep their start.
    Stochastic volatility runs at T = ``sv_t``."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops.tree import (TREE_DENSE_KERNELS,
                                                TREE_KERNELS,
                                                direction_words_int32)

    st = tile_model(physics, sv_t).structure
    phys = _physics(physics, {**st["data"], **st["scalars"]})
    kern = (TREE_DENSE_KERNELS if dense else TREE_KERNELS)[physics]
    md = MAX_DEPTH
    metric = "dense" if dense else "diagonal"
    for c in chain_counts:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 12 + c)
        q0 = tile_start(physics, c, gen, neck, sv_t)
        d = q0.shape[1]
        xi = torch.randn((c, d), generator=gen, device="cuda")
        if dense:
            minv = _spd(d, gen)
            p0 = (xi @ dense_metric(minv).mass_chol.T).contiguous()
        else:
            minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
            p0 = xi / minv.sqrt()
        d32 = direction_words_int32(torch.randint(
            0, 2 ** 32, (c,), generator=gen, dtype=torch.int64,
            device="cuda"))
        key = _key(SEED + 13 + c)
        for eps in eps_list:
            e = torch.full((c,), eps, device="cuda")
            launch, plain = tree_form("prng", q0, p0, e, d32, None, phys,
                                      minv, key, md)
            before = kern.launches
            got = launch()
            torch.cuda.synchronize()
            if kern.launches != before + 1:
                raise RuntimeError(f"the wrapper did not launch {kern.symbol}")
            want = plain()
            label = f"{physics}, {metric} metric, {c} x {d}, eps {eps}"
            compare_tree(got, want, label, replay=plain,
                         lsa_bound=_long_sums(phys, d),
                         terms=_terms_of(phys, d))
            # every position stays finite; the density and energy too but
            # on the chains that start where the density is not finite,
            # which diverge at their first leaf and keep their start
            rest = q0[:, 0] != SATURATED.get(physics, math.nan)
            n_neck = int((~rest).sum())
            finite = bool(torch.isfinite(got.q).all()) and all(
                bool(torch.isfinite(getattr(got, f)[rest]).all())
                for f in ("logp", "energy"))
            if n_neck and not (bool((got.term[~rest] == 1).all())
                               and torch.equal(got.q[~rest], q0[~rest])):
                finite = False
            deep = float(want.depth.double().mean()) > 7
            ms = cuda_time_ms(launch, 3, 1) if deep else cuda_time_ms(launch)
            bound_ms, bound_by, steps = tree_bound(c, d, want, "prng",
                                                   physics, dense)
            neck_note = (f"; the {n_neck} chains started where the density "
                         f"is not finite all diverged at their start"
                         if n_neck else "")
            print(f"[k5] {label} on {card}: kernel {ms:.4f} ms; {steps:.0f} "
                  f"leapfrog steps, {steps / ms * 1e3:.4g} steps/s; bound "
                  f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of "
                  f"it{neck_note}")
            if dense:
                staged_paths(card, label, launch, got, physics, d, dense,
                             "prng", ms, int(got.steps.max()))
            if not finite:
                raise RuntimeError(f"K5 ({label}) returned a non-finite "
                                   f"state, or a chain started where the "
                                   f"density is not finite did not diverge "
                                   f"there")


@functools.lru_cache(maxsize=None)
def mvn_target(dim: int = MVN_DIM, df: int = MVN_DF):
    """The 250-D multivariate normal of Hoffman and Gelman (2014), section
    4.1, with 300 degrees of freedom where they use 250 (or another ``dim``
    and ``df``): the precision is A = X X^T with X ``[dim, df]`` standard
    normal from numpy's ``default_rng(MVN_SEED)`` (a Wishart draw with
    identity scale), and ``mvn`` gets ``cov = inv(A)`` in float64, which it
    holds as float32 and inverts on the card.  Returns the model and
    ``sigma``, the float64 inverse of the float32 precision the model
    holds: the covariance the gates hold the draws to."""
    import numpy as np
    import torch

    from inplacedhmc_tpu_torch.models import mvn

    x = np.random.default_rng(MVN_SEED).standard_normal((dim, df))
    a = x @ x.T
    model = mvn(np.linalg.inv(a), device="cuda")
    sigma = torch.linalg.inv(model.structure["precision"].double())
    eig = np.linalg.eigvalsh(a)
    sd = torch.sqrt(torch.diag(sigma))
    print(f"[mvn] target: {dim}-D, Wishart precision with {df} "
          f"degrees of freedom (seed {MVN_SEED}): eigenvalues of A "
          f"{eig[0]:.4g} to {eig[-1]:.6g}, cond(A) {eig[-1] / eig[0]:.4g}; "
          f"marginal sds {float(sd.min()):.4f} to {float(sd.max()):.4f}")
    return model, sigma


def _spd(d: int, gen):
    """A dense symmetric positive definite ``M^-1`` of eigenvalues in about
    [0.5, 2.5]: 0.5 I + 0.5 B B^T with B ``[d, d]`` normal / sqrt(d)."""
    import torch
    b = torch.randn((d, d), generator=gen, device="cuda") / d ** 0.5
    m = 0.5 * torch.eye(d, device="cuda") + 0.5 * (b @ b.T)
    return 0.5 * (m + m.T)


def kernel_order_product(xi, s):
    """``xi @ s`` in the order of the kernel's warp mat-vec
    (``tree_kernel.cuh::matvec``): over i in order, each product and each
    sum rounded on its own.  The dense refresh's momentum as the kernel
    computes it, bit for bit."""
    import torch
    acc = torch.zeros_like(xi)
    for i in range(s.shape[0]):
        acc = acc + xi[..., i:i + 1] * s[i]
    return acc


def n_products(physics: str, dense: bool, form: str, n_leaf: int,
               k: int = 1) -> int:
    """The ``[D, D]`` products of a chain of ``n_leaf`` leaves over ``k``
    transitions (``tree_bound``'s count): a dense metric's two a leaf, one
    at each start and, under ``refresh``, one more for the momentum; the
    dense Gaussian's one a leaf, one at each start and one for the final
    gradient."""
    own = physics == "dense_gaussian"
    return own * (n_leaf + k + 1) \
        + dense * (2 * n_leaf + k + k * (form == "refresh"))


def bits_equal(a, b) -> bool:
    """Whether two tensors hold the same bits (a NaN where the other holds
    the same NaN counts as equal: the saturated chains' gradients)."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


#: the shapes (physics, D, metric, refresh, stack type) whose launch
#: ``staged_paths`` has forced through every admitted path
_FORCED_SHAPES = set()


def staged_paths(card: str, label: str, launch, ref, physics: str, d: int,
                 dense: bool, form: str, ms: float, n_leaf: int,
                 bf16: bool = False, k: int = 1,
                 grad_bf16: bool = False) -> str:
    """The staged products of a launch that has a ``[D, D]`` matrix: the
    launcher's plan (``ops.tree.plan_on_card``), which must be the Python
    mirror's (``stage_plan``); on the first state of each shape,
    ``launch(path)`` forced through every other path the shape admits, each
    output equal bit for bit to ``ref`` (the plan's own launch: the same
    arithmetic in the same order; ``bits_equal``).  Prints and returns the
    plan, the ring's stages and bytes in flight, the chains a block, the
    blocks an SM holds, and the time per product on the longest chain
    (``ms`` over its ``n_products``).  A physics of the tile form
    (``TILED_PHYSICS``, its option ``grad_bf16``) prints its tile's plan
    instead: chains a tile, observation tiles a batch, ring stages."""
    import torch

    from inplacedhmc_tpu_torch.ops.tree import (
        CLUSTER_PATHS, PATHS, TILED_PHYSICS, WARP_DIM, TreeOut,
        active_clusters, chains_in_flight, cluster_of, plan_on_card,
        stage_plan)
    refresh = form == "refresh"
    plan, blocks = plan_on_card(physics, d, MAX_DEPTH, dense, refresh, bf16,
                                grad_bf16=grad_bf16)
    mirror = stage_plan(d, MAX_DEPTH, physics, dense, refresh, bf16,
                        grad_bf16=grad_bf16)
    if plan != mirror:
        raise RuntimeError(f"{label}: the launcher plans {plan}, the mirror "
                           f"{mirror}")
    shape = (physics, d, dense, refresh, bf16)
    first = shape not in _FORCED_SHAPES
    _FORCED_SHAPES.add(shape)
    same = []
    for path in (p for p in PATHS if p not in CLUSTER_PATHS) if first \
            else ():
        try:
            stage_plan(d, MAX_DEPTH, physics, dense, refresh, bf16, path)
        except ValueError:
            continue
        if path == plan.path:
            continue
        got = launch(path)
        torch.cuda.synchronize()
        differ = [f for f in TreeOut._fields
                  if not bits_equal(getattr(got, f), getattr(ref, f))]
        if differ:
            raise RuntimeError(f"{label}: the {path} path differs from the "
                               f"{plan.path} path in {differ}")
        same.append(path)
    n_prod = n_products(physics, dense, form, n_leaf, k)
    ring = (f"a tile of {plan.warps} chains, {plan.rows} observation tiles "
            f"a batch, {plan.stages} ring stages, {plan.smem_bytes} bytes"
            if physics in TILED_PHYSICS else
            f"{plan.stages} stages of {plan.rows} rows ({plan.in_flight(d)} "
            f"bytes in flight), {plan.warps} chains a block")
    cluster = ""
    if dense and d > WARP_DIM:
        # the wide form: K = 1 (the register path, one block a chain) and
        # the cluster a launch waiting on its deepest chain takes; on every
        # state the one the wrapper's timed launches did not take (their K
        # is cluster_of's for this launch's chains in flight: the record
        # they read) bit for bit to the wrapper's own launch, timed on each
        # shape's first state beside them
        k = cluster_of(d)
        spread = chains_in_flight(ref.steps)
        taken = cluster_of(d, spread)
        other = "register" if taken > 1 else f"cluster{k}"
        got = launch(other)
        torch.cuda.synchronize()
        differ = [f for f in TreeOut._fields
                  if not bits_equal(getattr(got, f), getattr(ref, f))]
        if differ:
            raise RuntimeError(f"{label}: the {other} path differs from "
                               f"the wrapper's launch in {differ}")
        held = active_clusters(physics, d, MAX_DEPTH, dense, refresh, bf16,
                               f"cluster{k}")
        cluster = (f"{spread:.1f} chains in flight, the wrapper's K "
                   f"{taken}; K = 1 and K = {k} ({held} clusters at once) "
                   f"equal bit for bit")
        if first:
            o_ms = cuda_time_ms(lambda: launch(other), 3, 1)
            reg_ms, clu_ms = (o_ms, ms) if taken > 1 else (ms, o_ms)
            cluster += (f" (K = 1 {reg_ms:.4f} ms, {reg_ms / n_prod * 1e3:.2f}"
                        f" us per product; K = {k} {clu_ms:.4f} ms, "
                        f"{clu_ms / n_prod * 1e3:.2f} us; K = {k} / K = 1 "
                        f"{clu_ms / reg_ms:.4f})")
        cluster += "; "
    line = (f"{plan.path} path, {cluster}{ring}, "
            f"{blocks} blocks an SM ({blocks * plan.warps} chains); "
            f"longest chain {n_leaf} leaves, {n_prod} products, "
            f"{ms / n_prod * 1e3:.2f} us per product; "
            + (f"{', '.join(same) or 'no other path'} admitted, equal bit "
               f"for bit" if first else "other paths checked on this "
               "shape's first state"))
    print(f"[staged] {label} on {card}: {line}")
    return line


def library_product_ms(v, m) -> float:
    """One ``torch.mm`` of every chain's vector ``v [C, D]`` by the matrix
    ``m [D, D]`` in float32 with TF32 off: the per-leaf library yardstick
    of a staged product (the kernel makes two or three a leaf, each chain
    on its own)."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_time_ms(lambda: torch.mm(v, m))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def dense_case(card: str, label: str, physics: str, data: dict, q0, minv,
               eps_list, forms=("array", "prng", "refresh"),
               seed: int = 0, iters: int = 10, bf16: bool = False) -> dict:
    """K5 with ``physics`` and the metric ``minv`` (``[D]`` diagonal or
    ``[D, D]`` dense) against its plain version fed the kernel's own draws,
    at each step size and in each form (``tree_form``; ``bf16``: both with
    bfloat16 checkpoint stacks), by ``compare_tree``'s rule (and under
    ``grad_bf16`` ``grad_bf16_gate``); each timed beside its bound
    (``iters`` launches, 3 where the trees average above depth 7).
    Returns ``{(eps, form): (ms, plain_ms, bound_ms, bound_by,
    max_abs_err)}``."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops.tree import (TREE_DENSE_KERNELS,
                                                TREE_KERNELS,
                                                direction_words_int32,
                                                n_uniforms)
    c, d = q0.shape
    md = MAX_DEPTH
    dense = minv.ndim == 2
    kern = (TREE_DENSE_KERNELS if dense else TREE_KERNELS)[physics]
    scale = dense_metric(minv).mass_chol.T.contiguous() if dense \
        else 1.0 / torch.sqrt(minv)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + seed)
    xi = torch.randn((c, d), generator=gen, device="cuda")
    p0 = (xi @ scale if dense else scale * xi).contiguous()
    d32 = direction_words_int32(torch.randint(
        0, 2 ** 32, (c,), generator=gen, dtype=torch.int64, device="cuda"))
    unif = torch.rand((n_uniforms(md), c), generator=gen, device="cuda")
    key = _key(SEED + 21 + seed)
    phys = _physics(physics, data)
    times = {}
    for eps in eps_list:
        e = torch.full((c,), eps, device="cuda")
        for form in forms:
            launch, plain = tree_form(form, q0, p0, e, d32, unif, phys, minv,
                                      key, md, scale, bf16)
            before = kern.launches
            got = launch()
            torch.cuda.synchronize()
            if kern.launches != before + 1:
                raise RuntimeError(f"the wrapper did not launch "
                                   f"{kern.symbol}")
            want, plain_ms = timed(plain)
            tag = f"{label}, eps {eps:.4g}, {form}"
            err = compare_tree(got, want, tag, grad_bound(phys),
                               replay=plain, lsa_bound=_long_sums(phys, d))
            if _grad_bf16(phys):
                grad_bf16_gate(tag, phys, got)
            if not bool(torch.isfinite(got.q).all()):
                raise RuntimeError(f"K5 ({tag}) returned a non-finite state")
            deep = float(want.depth.double().mean()) > 7
            ms = cuda_time_ms(launch, 3 if deep else iters, 1)
            bound_ms, bound_by, steps = tree_bound(c, d, want, form, physics,
                                                   dense, _n_obs(phys),
                                                   _grad_bf16(phys))
            print(f"[k5-dense] {tag} on {card}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.2f} ms (wall); {steps:.0f} leapfrog steps, "
                  f"{steps / ms * 1e3:.4g} steps/s; bound {bound_ms:.4f} ms "
                  f"({bound_by}), {bound_ms / ms:.4f} of it")
            # a launch lasts as long as its longest chain, whose [D, D]
            # products (tree_bound's count) run one after another
            if dense or phys.matrix() is not None:
                staged_paths(card, tag, launch, got, physics, d, dense, form,
                             ms, int(got.steps.max()), bf16,
                             grad_bf16=_grad_bf16(phys))
            times[(eps, form)] = (ms, plain_ms, bound_ms, bound_by, err)
    return times


def sass_counts(kernel, keep, ops=("LDL", "STL", "LDG", "SHFL", "BAR")):
    """ptxas's registers and spill bytes (``-Xptxas -v`` of the build, read
    from ``kernel``, the launcher that built its source) and the counts of
    ``ops`` in the SASS (``cuobjdump -sass`` beside ``nvcc``) of each kernel
    function of its library whose mangled name ``keep`` accepts: ``LDL``
    and ``STL`` are local-memory loads and stores (spills).  Returns the
    counts by name."""
    import re

    from inplacedhmc_tpu_torch.ops.cuda_build import find_nvcc
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kernel.build()],
                          capture_output=True, text=True, check=True).stdout
    usage, name = {}, None
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            usage[name] = " ".join(re.findall(
                r"\d+ bytes spill (?:stores|loads)", line))
        elif name and "Used" in line and "registers" in line:
            usage[name] = (re.search(r"Used \d+ registers", line).group(0)
                           + ", " + usage.get(name, "spills not reported"))
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n")[0].strip()
        if keep(name):
            count = {op: len(re.findall(rf"\b{op}\b", block))
                     for op in ops}
            print(f"[sass] {name}: {usage.get(name, 'ptxas not reported')}; "
                  f"{count}")
            counts[name] = count
    return counts


def check_dense_tree_kernel(card: str) -> dict:
    """K5-dense (the ``[D, D]`` M^-1 launchers) and the dense Gaussian's
    physics against their plain versions (``dense_case``), max_depth 10:

    * the Gaussian physics (the 100-D standard normal) under a dense metric
      (``_spd``) at 10,240 x 100, eps 0.3, 1.8 (divergences) and 0.002
      (every tree at max depth), in the three forms;
    * ``dense_gaussian`` on the 250-D target (``mvn_target``) at 1,024 and
      at 64 chains, from draws of the target, under its diagonal metric
      diag(Sigma) at 0.5, 1.5 and 0.1 of the stability limit 2 /
      sqrt(lambda_max) of the preconditioned precision, and under the dense
      metric Sigma at eps 0.3, 2.5 and 0.05, in the default route's form
      at 64 chains, and in the three forms but for the deep 0.1 and 0.05
      at 1,024 (``mvn_cases``);
    * eight schools and the funnel under a dense metric at their D = 10,
      1,024 chains, the default route's form.

    First the spills of the dense Gaussian's instantiations
    (``sass_counts``); each case's ``staged_paths`` line gives its plan and
    the time per ``[D, D]`` product on its longest chain.  Returns the
    kernels-line entry of
    ``dense_gaussian`` under its diagonal metric (the mvn run's early
    windows), timed at 1,024 chains and half the stability limit, drawing
    its uniforms."""
    import torch

    t = time.perf_counter()
    from inplacedhmc_tpu_torch.ops.tree import TREE_DENSE_KERNELS
    # the staged instantiations of the dense Gaussian (its P under either
    # metric; the other launchers' registers and spills print with the
    # build)
    sass_counts(TREE_DENSE_KERNELS["dense_gaussian"],
                lambda name: "tree_kernel" in name,
                ("LDL", "STL", "LDG", "LDS", "SHFL", "BAR", "SYNCS"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    d = G_DIM
    q0 = torch.randn((G_CHAINS, d), generator=gen, device="cuda")
    minv = _spd(d, gen)
    dense_case(card, f"gaussian, dense metric, {G_CHAINS} x {d}",
               "gaussian", {"lam": torch.ones((d,), device="cuda")}, q0,
               minv, (0.3, 1.8, 0.002), seed=1)
    ms, plain_ms, bound_ms, bound_by, err = mvn_cases(
        card, gen, MVN_DIM, MVN_DF, (MVN_CHAINS,), deep=False)
    mvn_cases(card, gen, MVN_DIM, MVN_DF, (64,), forms=("prng",))
    model, _ = mvn_target()
    prec = model.structure["precision"]
    lib = library_product_ms(torch.randn((MVN_CHAINS, MVN_DIM), generator=gen,
                                         device="cuda"), prec)
    print(f"[k5-dense] the per-leaf library yardstick of P q: torch.mm of "
          f"[{MVN_CHAINS}, {MVN_DIM}] by [{MVN_DIM}, {MVN_DIM}], float32, "
          f"TF32 off: {lib:.4f} ms")
    entry = {"name": "tree_dense_gaussian", "route": "cuda",
             "source": "inplacedhmc_tpu_torch/csrc/tree_dense_gaussian.cu",
             "replaces": "inplacedhmc_tpu/ops/tree_pallas.py:1118",
             "launches": None, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None,
             "library_leaf_ms": lib}
    for name, eps in (("eight_schools", 0.3), ("funnel", 0.2)):
        st = tile_model(name).structure
        dense_case(card, f"{name}, dense metric, {E_CHAINS} x 10", name,
                   {**st["data"], **st["scalars"]},
                   tile_start(name, E_CHAINS, gen), _spd(10, gen), (eps,),
                   forms=("prng",), seed=4)
    print(f"[k5-dense] checks {time.perf_counter() - t:.2f} s")
    return entry


def mvn_cases(card: str, gen, dim: int, df: int, chain_counts,
              forms=("array", "prng", "refresh"), deep: bool = True) -> tuple:
    """``dense_gaussian`` on the ``dim``-D Wishart-precision target
    (``mvn_target(dim, df)``) at each chain count, from draws of the
    target, under its diagonal metric diag(Sigma) at 0.5, 1.5 and (with
    ``deep``) 0.1 of the stability limit 2 / sqrt(lambda_max) of the
    preconditioned precision, and under the dense metric Sigma at eps 0.3,
    2.5 and (with ``deep``) 0.05, in the ``forms`` (``dense_case``).
    Returns the first count's timing under the diagonal metric at half the
    limit, drawing its uniforms."""
    import torch

    model, sigma = mvn_target(dim, df)
    prec = model.structure["precision"]
    chol = torch.linalg.cholesky(sigma)
    var = torch.diag(sigma)
    pre = prec.double() * torch.sqrt(var[:, None] * var[None, :])
    limit = 2.0 / float(torch.linalg.eigvalsh(pre).max()) ** 0.5
    sigma32 = sigma.float()
    sigma32 = (0.5 * (sigma32 + sigma32.T)).contiguous()
    first = None
    for c in chain_counts:
        q0 = (torch.randn((c, dim), generator=gen, dtype=torch.float64,
                          device="cuda") @ chol.T).float().contiguous()
        times = dense_case(
            card, f"dense_gaussian, diagonal metric, {c} x {dim}",
            "dense_gaussian", {"prec": prec}, q0, var.float().contiguous(),
            (0.5 * limit, 1.5 * limit) + ((0.1 * limit,) if deep else ()),
            forms, seed=2)
        if first is None:
            first = times[(0.5 * limit, "prng")]
        dense_case(card, f"dense_gaussian, dense metric, {c} x {dim}",
                   "dense_gaussian", {"prec": prec}, q0, sigma32,
                   (0.3, 2.5) + ((0.05,) if deep else ()), forms, seed=3)
    return first


def check_wide_kernels(card: str) -> None:
    """K5's wide form (D above 256: one chain per block of ceil(D / 256)
    warps, the row sums, the AR(1) neighbours and the ``[D, D]`` products
    through shared memory) against its plain version, max_depth 10, by
    ``compare_tree``'s rule: the SASS of the wide instantiations of the
    Gaussian and stochastic volatility (``sass_counts``; the dense
    Gaussian's print with its narrow ones); the Gaussian at 64 and 1,024
    chains x 1,000 in its three forms at three step sizes
    (``check_tree_kernel``); the dense Gaussian on a 512-D Wishart-precision
    target at 256 chains under a diagonal and a dense metric, at a mixed
    and a divergent step size (``mvn_cases``: the deep cases cost seconds
    of the plain version each and add no form); stochastic volatility at
    T = 1,000 at 1,024 and 10,240 chains under a diagonal metric and at
    1,024 under a dense one, at three step sizes, every 16th chain
    saturated (``check_tile_kernel``); and a sweep of 16 against 16
    launches at D = 1,002 (``check_sweep``)."""
    import torch

    t = time.perf_counter()
    from inplacedhmc_tpu_torch.ops.tree import TREE_DENSE_KERNELS
    for source in ("gaussian", "stoch_vol"):
        # the wide form's instantiations: team Block
        sass_counts(TREE_DENSE_KERNELS[source],
                    lambda name: "tree_kernel" in name and "5BlockE" in name)
    for c in (S_CHAINS, E_CHAINS):
        check_tree_kernel(card, c, W_DIM, seed=30 + c)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    mvn_cases(card, gen, MVN_WIDE_DIM, MVN_WIDE_DF, (MVN_WIDE_CHAINS,),
              deep=False)
    for dense, counts in ((False, (SV_CHAINS, SV_BIG)), (True, (SV_CHAINS,))):
        check_tile_kernel(card, "stoch_vol", counts, SV_EPS, neck=True,
                          dense=dense, sv_t=SV_WIDE_T)
    check_sweep(card, "stoch_vol", SV_SWEEP_EPS, SV_WIDE_T)
    print(f"[k5-wide] stochastic volatility's long sums: the largest K "
          f"needed by field {LONG_SUM_NEED} (LONG_SUM_K {LONG_SUM_K})")
    print(f"[k5-wide] checks {time.perf_counter() - t:.2f} s")


def bf16_case(card: str, label: str, physics: str, phys, q0, p0, e, d32,
              minv, key, md: int = MAX_DEPTH, with_f32: bool = True,
              name: Optional[str] = None, flips: bool = False) -> dict:
    """K5 with bfloat16 checkpoint stacks (``ckpt_bf16``) against its plain
    version with them, on the same q0, momentum, directions and the
    kernel's own uniforms (the default route's form), by ``compare_tree``'s
    rule; timed beside its bound.  With ``with_f32`` the same launch with
    float32 stacks too: the chains whose integer records differ between
    the two stack types, and how many of those differ from the plain
    version with bfloat16 stacks; the share of chains whose termination and
    depth agree between the two (JAX's own check asks ``BF16_AGREE``,
    ``tests/test_tree_pallas.py``); the two timed in ``BF16_PAIRS``
    alternating pairs, f32 first then bf16 first, by CUDA events; and the
    blocks per SM of each (``ops.tree.blocks_per_sm``).  ``flips``: inputs
    chosen so that the rounding decides turns (``BF16_FLIP_DIMS``); then,
    in place of the agreement, at least one chain must end otherwise than
    with float32 stacks, and every such chain as the plain version with
    bfloat16 stacks ends it (a kernel that skipped the rounding, or cut
    the mantissa, ends them otherwise).  Returns the kernels line's entry
    of the bfloat16 launch."""
    import statistics

    import torch

    from inplacedhmc_tpu_torch.ops.tree import (CKPT_BF16_LAUNCHES,
                                                TREE_DENSE_KERNELS,
                                                TREE_KERNELS, blocks_per_sm)
    c, d = q0.shape
    dense = minv.ndim == 2
    kern = (TREE_DENSE_KERNELS if dense else TREE_KERNELS)[physics]
    launch, plain = tree_form("prng", q0, p0, e, d32, None, phys, minv, key,
                              md, bf16=True)
    before = CKPT_BF16_LAUNCHES.get(kern.symbol, 0)
    got = launch()
    torch.cuda.synchronize()
    if CKPT_BF16_LAUNCHES.get(kern.symbol, 0) != before + 1:
        raise RuntimeError(f"{kern.symbol} did not launch with bfloat16 "
                           f"stacks")
    want, plain_ms = timed(plain)
    err = compare_tree(got, want, f"{label}, bfloat16 stacks",
                       grad_bound(phys), None, plain,
                       lsa_bound=_long_sums(phys, d),
                       terms=_terms_of(phys, d))
    slow = dense or d > 256 or float(want.depth.double().mean()) > 7
    reps = (3, 1) if slow else (20, 3)
    bound_ms, bound_by, steps = tree_bound(c, d, want, "prng", physics,
                                           dense, _n_obs(phys),
                                           _grad_bf16(phys))
    note = ""
    if with_f32:
        launch32, _ = tree_form("prng", q0, p0, e, d32, None, phys, minv,
                                key, md)
        got32 = launch32()
        flip = ints_differ(got, got32)
        n_flip = int(flip.sum())
        off = int((flip & ints_differ(got, want)).sum())
        agree = float(((got.term == got32.term)
                       & (got.depth == got32.depth)).double().mean())
        same = float((got.q == got32.q).all(dim=1).double().mean())
        t32, t16 = [], []
        for i in range(BF16_PAIRS):
            for side in ((t32, launch32), (t16, launch))[::1 - 2 * (i % 2)]:
                side[0].append(cuda_time_ms(side[1], *reps))
        ms = statistics.median(t16)
        ms32 = statistics.median(t32)
        ratio = statistics.median(b / a for a, b in zip(t32, t16))
        occ = [blocks_per_sm(physics, d, md, dense, b) for b in (False, True)]
        note = (f"; {n_flip} chains end otherwise than with float32 "
                f"stacks, {off} of them otherwise than the plain version "
                f"with bfloat16 stacks"
                f"; float32 stacks {ms32:.4f} ms, bf16 / f32 median "
                f"{ratio:.4f} over {BF16_PAIRS} pairs (f32 "
                f"{min(t32):.4f}-{max(t32):.4f}, bf16 "
                f"{min(t16):.4f}-{max(t16):.4f}); termination and depth "
                f"agree with float32 stacks on {agree:.4f} of chains "
                f"(proposal equal on {same:.4f}); blocks per SM "
                f"{occ[0]} (f32), {occ[1]} (bf16)")
        if flips and (n_flip == 0 or off):
            raise RuntimeError(f"{label}: {n_flip} chains end otherwise "
                               f"with bfloat16 stacks than with float32 "
                               f"ones, {off} of them otherwise than the "
                               f"plain version with bfloat16 stacks")
        if not flips and agree < BF16_AGREE:
            raise RuntimeError(f"{label}: bfloat16 and float32 stacks agree "
                               f"in termination on {agree} < {BF16_AGREE}")
    else:
        ms = cuda_time_ms(launch, *reps)
    print(f"[k5-bf16] {label} on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms (wall), bound {bound_ms:.4g} ms ({bound_by}), "
          f"{bound_ms / ms:.4f} of it; {steps:.0f} steps{note}")
    leaf = {}
    if dense:
        staged_paths(card, f"{label}, bfloat16 stacks", launch, got, physics,
                     d, dense, "prng", ms, int(got.steps.max()), bf16=True)
        leaf = {"library_leaf_ms": library_product_ms(q0, minv)}
    return {"name": name or f"tree_{physics}_ckpt_bf16", "route": "cuda",
            "source": f"inplacedhmc_tpu_torch/csrc/{kern.source}",
            "replaces": f"inplacedhmc_tpu/ops/tree_pallas.py:{BF16_REPLACES}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, **leaf}


def bf16_at_state(card: str, ws, physics: str, data: dict, label: str,
                  name: str) -> dict:
    """``bf16_case`` on the state a run ended in: its q, tuned eps and
    metric (diagonal or dense), a fresh momentum and directions."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import sample_momentum
    from inplacedhmc_tpu_torch.ops.tree import direction_words_int32

    q0 = ws.z.q.contiguous()
    c = q0.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    p0 = sample_momentum(ws.metric, gen, q0.shape, q0.dtype).contiguous()
    d32 = direction_words_int32(torch.randint(
        0, 2 ** 32, (c,), generator=gen, dtype=torch.int64, device="cuda"))
    e = torch.exp(ws.log_eps).expand(c).contiguous()
    return bf16_case(card, label, physics, _physics(physics, data), q0, p0, e,
                     d32, ws.metric.inv.contiguous(), _key(SEED + 5),
                     name=name)


def tail_at_state(card: str, ws, physics: str, data: dict, label: str,
                  bf16: bool = True) -> None:
    """Whether a dense launch at a run's tuned state is bound by its
    deepest chain (the tail) or by what all chains share: the launch of
    ``bf16_at_state``'s inputs with every chain valid against only its
    deepest chain valid (the ``valid`` column: an invalid row skips its
    tree at once), at K = 1 (the register path, one block a chain) and on
    the cluster a launch waiting on its deepest chain takes
    (``ops.tree.cluster_of``), with the time per ``[D, D]`` product of that
    chain alone.  Within about 20 % of each other, the launch waits for
    its deepest chain's serial products; far apart, for L2's bandwidth
    over all chains.  The deepest chain's records alone equal its records
    beside the others bit for bit.  The wrapper's own launch, once the
    record of one launch of the state has reached the host, must run the
    cluster ``cluster_of`` picks for its chains in flight, a cluster at the
    tuned state.  Returns that K."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import sample_momentum
    from inplacedhmc_tpu_torch.ops import tree as tree_ops
    from inplacedhmc_tpu_torch.ops.tree import (TreeOut, chains_in_flight,
                                                cluster_of,
                                                direction_words_int32,
                                                tree_transition)

    q0 = ws.z.q.contiguous()
    c, d = q0.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    p0 = sample_momentum(ws.metric, gen, q0.shape, q0.dtype).contiguous()
    d32 = direction_words_int32(torch.randint(
        0, 2 ** 32, (c,), generator=gen, dtype=torch.int64, device="cuda"))
    e = torch.exp(ws.log_eps).expand(c).contiguous()
    minv, key, phys = ws.metric.inv.contiguous(), _key(SEED + 5), \
        _physics(physics, data)
    tail_k = cluster_of(d)
    for path in ("register", f"cluster{tail_k}"):
        def run(valid=None, path=path):
            return tree_transition(q0, p0, e, d32, None, phys, minv,
                                   MAX_DEPTH, -1000.0, key=key, valid=valid,
                                   ckpt_bf16=bf16, path=path)
        ref = run()
        deep = int(torch.argmax(ref.steps))
        one = torch.zeros((c,), dtype=torch.int32, device="cuda")
        one[deep] = 1
        alone = run(one)
        for f in TreeOut._fields:
            if not bits_equal(getattr(alone, f)[deep], getattr(ref, f)[deep]):
                raise RuntimeError(f"{label}: the deepest chain alone "
                                   f"differs in {f}")
        t_all = cuda_time_ms(run, 3, 1)
        t_one = cuda_time_ms(lambda: run(one), 3, 1)
        n_leaf = int(ref.steps[deep])
        n_prod = n_products(physics, True, "prng", n_leaf)
        k = tail_k if path != "register" else 1
        print(f"[tail] {label}, K = {k} ({path}) on {card}: every chain "
              f"valid {t_all:.4f} ms, the deepest chain (row {deep}, "
              f"{n_leaf} leaves) alone {t_one:.4f} ms, alone / all "
              f"{t_one / t_all:.4f}; {t_one / n_prod * 1e3:.2f} us per "
              f"product on that chain alone ({n_prod} products); its "
              f"records equal bit for bit")
    # the wrapper's own choice: its second launch of the state reads the
    # first's record
    sym = tree_ops.TREE_DENSE_KERNELS[physics].symbol
    run(path=None)
    torch.cuda.synchronize()
    before = tree_ops.CLUSTER_LAUNCHES.get(sym, 0)
    own = run(path=None)
    torch.cuda.synchronize()
    spread = chains_in_flight(own.steps)
    k = cluster_of(d, spread)
    ran = tree_ops.CLUSTER_LAUNCHES.get(sym, 0) - before
    print(f"[tail] {label}: {spread:.2f} chains in flight, the wrapper's K "
          f"{k}, {ran} cluster launch of 1")
    if ran != (k > 1) or k == 1:
        raise RuntimeError(f"{label}: the wrapper's launch at the tuned "
                           f"state ran {ran} cluster launches for K = {k}")
    return k


def check_ckpt_bf16(card: str) -> None:
    """K5 with bfloat16 checkpoint stacks (``bf16_case``) in the one-warp
    form, the Gaussian at 10,240 x 100 (eps 0.3, M^-1 0.5 + U(0, 1)) and
    stochastic volatility at 1,024 x 102 under a dense M^-1 (``_spd``, eps
    0.02); in the wide form the Gaussian at D = 2,048 and max_depth
    ``BF16_WIDE_MD`` (64 chains, eps 0.3), which float32 stacks cannot take
    (``ops.tree.takes``); the Gaussian at 1,024 chains on inputs where the
    rounding decides turns (``BF16_FLIP_DIMS``, ``bf16_case``'s
    ``flips``), in both forms; and the blocks per SM of both stack types at
    config 5's D = 1,002 (the wide form, max_depth 10)."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops.tree import (MAX_DIM, blocks_per_sm,
                                                direction_words_int32, takes)

    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)

    def draws(c, d, minv):
        xi = torch.randn((c, d), generator=gen, device="cuda")
        p0 = (xi @ dense_metric(minv).mass_chol.T if minv.ndim == 2
              else xi / minv.sqrt()).contiguous()
        d32 = direction_words_int32(torch.randint(
            0, 2 ** 32, (c,), generator=gen, dtype=torch.int64,
            device="cuda"))
        return p0, d32

    c, d = G_CHAINS, G_DIM
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    q0 = torch.randn((c, d), generator=gen, device="cuda")
    p0, d32 = draws(c, d, minv)
    bf16_case(card, f"gaussian, {c} x {d}, eps 0.3", "gaussian",
              _physics("gaussian", {"lam": torch.ones((d,), device="cuda")}),
              q0, p0, torch.full((c,), 0.3, device="cuda"), d32, minv,
              _key(SEED + 81))
    st = tile_model("stoch_vol").structure
    q0 = tile_start("stoch_vol", SV_CHAINS, gen)
    c, d = q0.shape
    minv = _spd(d, gen)
    p0, d32 = draws(c, d, minv)
    bf16_case(card, f"stoch_vol, dense metric, {c} x {d}, eps 0.02",
              "stoch_vol", _physics("stoch_vol", {**st["data"],
                                                  **st["scalars"]}),
              q0, p0, torch.full((c,), 0.02, device="cuda"), d32, minv,
              _key(SEED + 82))
    c, d, md = S_CHAINS, MAX_DIM, BF16_WIDE_MD
    if takes(d, md, "gaussian") or not takes(d, md, "gaussian", True):
        raise RuntimeError(f"ops.tree.takes at D = {d}, max_depth {md}")
    minv = 0.5 + torch.rand((d,), generator=gen, device="cuda")
    q0 = torch.randn((c, d), generator=gen, device="cuda")
    p0, d32 = draws(c, d, minv)
    bf16_case(card, f"gaussian, {c} x {d}, max_depth {md}, eps 0.3 "
              f"(float32 stacks do not fit)", "gaussian",
              _physics("gaussian", {"lam": torch.ones((d,), device="cuda")}),
              q0, p0, torch.full((c,), 0.3, device="cuda"), d32, minv,
              _key(SEED + 83), md=md, with_f32=False)
    c, md = SV_CHAINS, BF16_FLIP_MD
    for d in BF16_FLIP_DIMS:
        minv = torch.full((d,), 1e-6, device="cuda")
        minv[0] = 0.5 + torch.rand((), generator=gen, device="cuda")
        lam = 0.5 + torch.rand((d,), generator=gen, device="cuda")
        q0 = torch.randn((c, d), generator=gen, device="cuda")
        # standard normal momenta: coordinates past 0 then add 1e-6 of
        # coordinate 0's share to the turn checks' sums
        _, d32 = draws(c, d, minv)
        p0 = torch.randn((c, d), generator=gen, device="cuda")
        bf16_case(card, f"gaussian, {c} x {d}, max_depth {md}, eps "
                  f"{BF16_FLIP_EPS}, M^-1 1e-6 past coordinate 0 (the "
                  f"rounding decides turns)", "gaussian",
                  _physics("gaussian", {"lam": lam}), q0, p0,
                  torch.full((c,), BF16_FLIP_EPS, device="cuda"), d32, minv,
                  _key(SEED + 84 + d), md=md, flips=True)
    for dense in (False, True):
        occ = [blocks_per_sm("stoch_vol", SV_WIDE_T + 2, MAX_DEPTH, dense, b)
               for b in (False, True)]
        print(f"[k5-bf16] stoch_vol, D = {SV_WIDE_T + 2}, max_depth "
              f"{MAX_DEPTH}, {'dense' if dense else 'diagonal'} metric: "
              f"blocks per SM {occ[0]} with float32 stacks, {occ[1]} with "
              f"bfloat16 stacks")
    print(f"[k5-bf16] checks {time.perf_counter() - t:.2f} s")


def sweep_case(card: str, label: str, phys, q0, minv, eps: float,
               seed: int, ckpt_bf16: bool = False) -> None:
    """K5 with the physics ``phys`` under ``minv`` (``[D]`` or ``[D, D]``),
    eps ``eps``, 1 row in 1,000 padded: one launch of ``SWEEP_CHECK_K``
    transitions drawing everything itself against that many one-transition
    launches fed what its generator draws (under a dense metric the
    momentum ``xi mass_chol^T`` in the kernel's order of operations,
    ``kernel_order_product``): every field equal bit for bit.  Timed beside
    the single launches and the bound."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import dense_metric
    from inplacedhmc_tpu_torch.ops.tree import (TREE_DENSE_KERNELS,
                                                TREE_KERNELS, TreeOut,
                                                philox_draws, tree_sweep)

    c, d = q0.shape
    md, k = MAX_DEPTH, SWEEP_CHECK_K
    dense = minv.ndim == 2
    scale = dense_metric(minv).mass_chol.T.contiguous() if dense \
        else 1.0 / torch.sqrt(minv)
    e = torch.full((c,), eps, device="cuda")
    valid = (torch.arange(c, device="cuda") % 1000 != 999).to(torch.int32)
    key = _key(seed)
    kern = (TREE_DENSE_KERNELS if dense else TREE_KERNELS)[phys.name]
    before = kern.launches
    swept = tree_sweep(q0, e, phys, minv, md, -1000.0, k, key=key,
                       sqrt_mass=scale, valid=valid, ckpt_bf16=ckpt_bf16)
    torch.cuda.synchronize()
    if kern.launches != before + 1:
        raise RuntimeError(f"the sweep ({label}) was not one K5 launch")
    xi, dirs, unif = philox_draws(key, c, d, md, k)
    q = q0
    differ = []
    for s in range(k):
        p = kernel_order_product(xi[s], scale) if dense else scale * xi[s]
        one = tree_sweep(q, e, phys, minv, md, -1000.0, momentum=p[None],
                         dirs=dirs[s:s + 1], unif=unif[s:s + 1], valid=valid,
                         ckpt_bf16=ckpt_bf16)
        differ += [f"{f}[{s}]" for f in TreeOut._fields if f != "grad"
                   and not torch.equal(getattr(swept, f)[s],
                                       getattr(one, f)[0])]
        q = one.q[0]
    if not torch.equal(swept.grad, one.grad):
        differ.append("grad")
    steps = float(swept.steps.sum())
    print(f"[sweep] {label}, {c} x {d}: {k} transitions in one launch "
          f"against {k} launches: fields that differ {differ or 'none'}; "
          f"depth mean {swept.depth.double().mean().item():.3f}, "
          f"{steps:.0f} steps")
    if differ:
        raise RuntimeError(f"a K5 sweep ({label}) differs from its single "
                           f"launches")
    ms = cuda_time_ms(lambda: tree_sweep(
        q0, e, phys, minv, md, -1000.0, k, key=key, sqrt_mass=scale,
        valid=valid, out=swept, ckpt_bf16=ckpt_bf16), iters=3, warmup=1)
    keys = [_key(seed + 1 + s) for s in range(k)]
    one_ms = cuda_time_ms(lambda: [tree_sweep(
        q0, e, phys, minv, md, -1000.0, key=kk, sqrt_mass=scale, valid=valid,
        out=one, ckpt_bf16=ckpt_bf16) for kk in keys], iters=3, warmup=1)
    bound_ms, bound_by, _ = tree_bound(c, d, swept, "refresh", phys.name,
                                       dense, _n_obs(phys), _grad_bf16(phys))
    print(f"[sweep] {label} on {card}: one launch of {k} {ms:.4f} ms "
          f"({ms / k:.4f} ms per transition), {k} launches of one "
          f"{one_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
          f"{steps / ms * 1e3:.4g} steps/s")


def check_dense_sweep(card: str) -> None:
    """K5-dense, ``dense_gaussian`` on the 250-D target at 1,024 chains
    under the dense metric Sigma, eps 0.3: ``sweep_case``."""
    import torch

    model, sigma = mvn_target()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q0 = (torch.randn((MVN_CHAINS, MVN_DIM), generator=gen,
                      dtype=torch.float64, device="cuda")
          @ torch.linalg.cholesky(sigma).T).float().contiguous()
    minv = sigma.float()
    sweep_case(card, "dense_gaussian, dense metric",
               _physics("dense_gaussian",
                        {"prec": model.structure["precision"]}),
               q0, (0.5 * (minv + minv.T)).contiguous(), 0.3, SEED + 23)


@functools.lru_cache(maxsize=None)
def logistic_problem():
    """BASELINE config 3's data (``synthetic_data(SEED)``, 10,000 x 50, as
    ``run_sample`` makes them), the physics' data (``logistic_data``,
    ``block_n`` ``LOGISTIC_BLOCK_N``), and the Laplace approximation's
    covariance at the coefficients that made the data, ``(X^T S X +
    inv_var I)^-1`` with ``S = s (1 - s)`` (float64, ``_laplace``): the
    metric and the start of the kernel checks."""
    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.tile_physics import logistic_data

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    h, cov = _laplace(x, y, beta)
    data = logistic_data(x, y, INV_VAR, block_n=LOGISTIC_BLOCK_N)
    return x, y, beta, h, cov, data


def _laplace(x, y, beta):
    """The Laplace approximation of a logistic regression at the
    coefficients that made its data: ``(H, cov)``, ``H = X^T S X + inv_var
    I`` with ``S = s (1 - s)`` and ``cov = H^-1`` (float64)."""
    import torch
    x64 = x.double()
    s = torch.sigmoid(x64 @ beta.double())
    h = x64.T @ (x64 * (s * (1 - s))[:, None]) \
        + INV_VAR * torch.eye(x.shape[1], dtype=torch.float64, device="cuda")
    cov = torch.linalg.inv(h)
    return h, 0.5 * (cov + cov.T)


def _limit(h, minv) -> float:
    """The leapfrog's stability limit 2 / sqrt(lambda_max(M^-1 H))."""
    import torch
    chol = torch.linalg.cholesky(minv)
    return 2.0 / torch.linalg.eigvalsh(chol.T @ h @ chol).max().item() ** 0.5


def _laplace_draws(beta, cov, c: int, seed: int):
    """``c`` draws of the Laplace approximation, float32 ``[c, D]``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (beta.double() + torch.randn(
        (c, beta.shape[0]), generator=gen, dtype=torch.float64,
        device="cuda") @ torch.linalg.cholesky(cov).T).float().contiguous()


def grad_bf16_gate(tag: str, phys, got) -> None:
    """Under ``grad_bf16``: the kernel's gradient at its own proposals
    against the plain physics' there, within the bfloat16 rounding of one
    residual, 2^-8 max |x|, beside TREE_RTOL (1 + |g|) (the float32 sums),
    and not the float32 physics' gradient (the rounding is made):
    ``tests/test_torch_cuda.py::test_cuda_logistic_grad_bf16``'s gate."""
    _, g_plain = phys(got.q)
    xmax = float(phys.obs_matrix().abs().max())
    diff = (got.grad - g_plain).abs()
    ok = bool((diff <= 2.0 ** -8 * xmax
               + TREE_RTOL * (1 + g_plain.abs())).all())
    g32 = _physics("logistic", {**phys.data, "grad_bf16": 0.0})(got.q)[1]
    apart = float((g32 - got.grad).abs().max())
    print(f"[k5-logistic] {tag}: the gradient at the kernel's proposals "
          f"within 2^-8 max|x| + {TREE_RTOL:g} (1 + |g|) of the plain "
          f"grad_bf16 physics' {ok} (max {float(diff.max()):.3e}); "
          f"{apart:.3e} from the float32 physics'")
    if not ok or not apart > 1e-6:
        raise RuntimeError(f"K5-logistic's grad_bf16 gradient ({tag})")


def check_logistic_tree_kernel(card: str) -> dict:
    """K5-logistic's tile form (``csrc/tree_logistic.cu``) against its
    plain version at full width, 8192 chains x 10,000 x 50
    (``logistic_problem``), from draws of the Laplace approximation,
    max_depth 10: under the dense metric M^-1 = its covariance and under
    the diagonal of it, at 0.5, 1.5 (divergences) and 0.1 (deep trees) of
    the stability limit 2 / sqrt(lambda_max(M^-1 H)), in the three forms
    (``dense_case``: ``compare_tree`` with the logistic gradient's bound,
    ``grad_bound``, and verified ties); then, under the dense metric at
    half the limit with the uniforms drawn: at 1, 64 and 1,000 chains (a
    partial last tile) of the same data; on data drawn at D = 1, 17, 64,
    200 and 256 with 2,049 observations (a ragged last tile), 1,000 chains
    each; with ``grad_bf16`` (both sides round the backward's inputs; the
    gradient at the kernel's proposals also held by ``grad_bf16_gate``) and
    with ``ckpt_bf16`` (both sides with bfloat16 stacks); and a sweep of 16
    against 16 launches (``sweep_case``), with float32 products, with
    ``grad_bf16`` and with ``ckpt_bf16``.  Prints the per-leaf library
    composition of the physics (cuBLAS products and BCE-with-logits on the
    same padded data) for reference: no library call computes the whole
    tree.  Returns the kernels-line entry of the diagonal launcher (the
    sample()'s first windows run it), at half the limit, drawing its
    uniforms."""
    import torch

    from inplacedhmc_tpu_torch.models import synthetic_data
    from inplacedhmc_tpu_torch.ops.tile_physics import logistic_data

    t = time.perf_counter()
    x, y, beta, h, cov, data = logistic_problem()
    phys = _physics("logistic", data)
    q0 = _laplace_draws(beta, cov, C, SEED + 40)
    lib_ms = cuda_time_ms(lambda: _library_logistic(
        q0, phys.data["x"], phys.data["y"], phys.data["w"], INV_VAR))
    print(f"[k5-logistic] {C} x {N} x {D} (padded to "
          f"{phys.data['x'].shape[0]} observations): the per-leaf library "
          f"composition of the physics (cuBLAS + BCE-with-logits, all "
          f"chains) {lib_ms:.4f} ms on {card}")
    entry = None
    for metric in ("dense", "diag"):
        minv = cov if metric == "dense" else torch.diag(torch.diag(cov))
        limit = _limit(h, minv)
        m32 = (minv if metric == "dense" else torch.diag(cov)).float() \
            .contiguous()
        eps = (0.5 * limit, 1.5 * limit, 0.1 * limit)
        times = dense_case(card, f"logistic, {metric} metric, {C} x {D}",
                           "logistic", data, q0, m32, eps,
                           seed=5 + (metric == "diag"), iters=3)
        if metric == "diag":
            ms, plain_ms, bound_ms, bound_by, err = times[(eps[0], "prng")]
            entry = {"name": "tree_logistic", "route": "cuda",
                     "source": "inplacedhmc_tpu_torch/csrc/tree_logistic.cu",
                     "replaces": "inplacedhmc_tpu/ops/tree_pallas.py:"
                                 + LOGISTIC_REPLACES,
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
    m32 = cov.float().contiguous()
    half = 0.5 * _limit(h, cov)
    for c in LOGISTIC_TILE_CHAINS:
        dense_case(card, f"logistic, dense metric, {c} x {D}", "logistic",
                   data, q0[:c].contiguous(), m32, (half,), ("prng",),
                   seed=7, iters=3)
    for d in LOGISTIC_TILE_DIMS:
        xd, yd, bd = synthetic_data(SEED + d, LOGISTIC_TILE_N, d,
                                    device="cuda")
        hd, cd = _laplace(xd, yd, bd)
        dense_case(card, f"logistic, dense metric, {LOGISTIC_TILE_C} x "
                   f"{LOGISTIC_TILE_N} x {d}", "logistic",
                   logistic_data(xd, yd, INV_VAR, block_n=LOGISTIC_BLOCK_N),
                   _laplace_draws(bd, cd, LOGISTIC_TILE_C, SEED + 42 + d),
                   cd.float().contiguous(), (0.5 * _limit(hd, cd),),
                   ("prng",), seed=8, iters=3)
    bf16_data = {**data, "grad_bf16": 1.0}
    dense_case(card, f"logistic, dense metric, {C} x {D}, grad_bf16",
               "logistic", bf16_data, q0, m32, (half,), ("prng",), seed=9,
               iters=3)
    dense_case(card, f"logistic, dense metric, {C} x {D}, ckpt_bf16",
               "logistic", data, q0, m32, (half,), ("prng",), seed=10,
               iters=3, bf16=True)
    sweep_case(card, "logistic, dense metric", phys, q0, m32, half,
               SEED + 41)
    sweep_case(card, "logistic, dense metric, grad_bf16",
               _physics("logistic", bf16_data), q0, m32, half, SEED + 43)
    sweep_case(card, "logistic, dense metric, ckpt_bf16", phys, q0, m32,
               half, SEED + 44, ckpt_bf16=True)
    print(f"[k5-logistic] checks {time.perf_counter() - t:.2f} s")
    return entry


def tree_at_state(card: str, res, form: str = "prng", k: int = 1,
                  physics: str = "gaussian", data=None,
                  name: Optional[str] = None) -> dict:
    """K5 timed on the state a whole-tree run ended in (its tuned eps and
    metric, diagonal or dense, a fresh momentum and directions) in the form
    its route runs: ``prng`` (the default route: momentum and directions
    from the host, the uniforms drawn in the kernel) or ``refresh`` with
    ``k`` transitions per launch (the flagship's sampling loop).  Held
    against the plain version fed the kernel's own draws; for ``refresh``
    the first of the ``k`` transitions is compared, the gradient of the
    last proposal against the plain physics at that proposal, and the plain
    version is timed over all ``k``.  ``physics`` and its ``data`` are the
    model's (by default the standard normal's); ``name`` the entry's in the
    kernels line."""
    import torch

    from inplacedhmc_tpu_torch.core.metric import DenseMetric, sample_momentum
    from inplacedhmc_tpu_torch.ops.tree import (
        TREE_KERNELS, direction_words_int32, philox_draws, refresh_momentum,
        tree_sweep, tree_sweep_plain, tree_transition_plain)

    ws = res.warmup_state
    q0 = ws.z.q.contiguous()
    c, d, md = q0.shape[0], q0.shape[1], MAX_DEPTH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    p0 = sample_momentum(ws.metric, gen, q0.shape, q0.dtype)
    d32 = direction_words_int32(torch.randint(
        0, 2 ** 32, (c,), generator=gen, dtype=torch.int64, device="cuda"))
    e = torch.exp(ws.log_eps).expand(c).contiguous()
    phys = _physics(physics, data or {"lam": torch.ones((d,), device="cuda")})
    dense = isinstance(ws.metric, DenseMetric)
    minv = ws.metric.inv.contiguous()
    scale = (ws.metric.mass_chol.T if dense else ws.metric.sqrt_mass) \
        .contiguous()
    key = _key(SEED + 5)
    grad_q = None
    if form == "prng":
        kw = dict(momentum=p0[None], dirs=d32[None])
        launch, plain = tree_form("prng", q0, p0, e, d32, None, phys, minv,
                                  key, md)
        got = launch()
        want, plain_ms = timed(plain)
    else:
        kw = dict(sqrt_mass=scale)
        xi, dirs, unif = philox_draws(key, c, d, md, k)
        p_all = refresh_momentum(scale, xi)

        def plain():
            return tree_sweep_plain(q0, e, phys, minv, md, -1000.0, k,
                                    momentum=p_all, dirs=dirs, unif=unif)

        def first(rows, shift):  # the first transition, for a replay
            return tree_transition_plain(
                q0[rows], p_all[0][rows], e[rows], dirs[0][rows],
                unif[0][:, rows] * math.exp(shift), phys, minv, md, -1000.0)

        got = tree_sweep(q0, e, phys, minv, md, -1000.0, k, key=key, **kw)
        want, plain_ms = timed(plain)
        # the sweep's gradient is that of its last proposal: held against
        # the plain physics at the kernel's own last proposal (a tie in any
        # of the k transitions parts the two sides' last proposals)
        q_last = got.q[-1]
        got, want = _first(got), _first(want)._replace(grad=phys(q_last)[1])
        grad_q = (q_last, q_last)
    abs_err = compare_tree(got, want, f"{physics}, {c} chains, tuned eps "
                           f"{float(e[0]):.4g}, {form}, n_sweep {k}",
                           grad_bound(phys), grad_q,
                           plain if form == "prng" else first,
                           lsa_bound=_long_sums(phys, d),
                           terms=_terms_of(phys, d))
    # timed on a start and output buffers made beforehand: nothing but the
    # kernel is queued in the timed loop
    out = tree_sweep(q0, e, phys, minv, md, -1000.0, k, key=key, **kw)
    # a dense or wide state's launches take tens of ms and its plain
    # version seconds: fewer repeats, and the plain version timed on its
    # comparison run above
    slow = dense or d > 256
    ms = cuda_time_ms(lambda: tree_sweep(
        q0, e, phys, minv, md, -1000.0, k, key=key, out=out, **kw),
        *((3, 1) if slow else (20, 3)))
    if not slow:
        plain_ms = wall_ms(plain, 2, 1)
    bound_ms, bound_by, steps = tree_bound(c, d, out, form, physics, dense,
                                           _n_obs(phys), _grad_bf16(phys))
    metric = "dense" if dense else "diagonal"
    print(f"[k5] {physics}, {c} chains at the tuned state ({metric} "
          f"metric), {form}, n_sweep "
          f"{k}, on {card}: kernel {ms:.4f} ms ({ms / k:.4f} ms per "
          f"transition), plain {plain_ms:.2f} ms (wall: its host loop "
          f"synchronises), bound {bound_ms:.4g} ms ({bound_by}); "
          f"{steps:.0f} steps, {steps / ms * 1e3:.4g} steps/s")
    leaf = {}
    mat = phys.matrix()
    if dense or mat is not None:
        # the products of the longest chain over the k transitions
        staged_paths(card, f"{physics}, {c} x {d} at the tuned state "
                     f"({metric} metric), {form}, n_sweep {k}",
                     lambda path: tree_sweep(q0, e, phys, minv, md, -1000.0,
                                             k, key=key, path=path, **kw),
                     out, physics, d, dense, form, ms,
                     int(out.steps.sum(0).max()), k=k)
        leaf = {"library_leaf_ms": library_product_ms(
            q0, minv if dense else mat)}
        print(f"[k5] the per-leaf library yardstick: torch.mm of the "
              f"[{c}, {d}] vectors by the [{d}, {d}] matrix, float32, TF32 "
              f"off: {leaf['library_leaf_ms']:.4f} ms")
    if name is None:
        name = f"tree_{physics}" if physics != "gaussian" else \
            "gaussian_tree_transition" if form == "prng" else \
            "gaussian_tree_sweep"
    return {"name": name, "route": "cuda",
            "source": f"inplacedhmc_tpu_torch/csrc/"
                      f"{TREE_KERNELS[physics].source}",
            "replaces": "inplacedhmc_tpu/ops/tree_pallas.py:"
                        + (LOGISTIC_REPLACES if physics == "logistic"
                           else SV_REPLACES if physics == "stoch_vol"
                           else DENSE_REPLACES[physics] if dense else "92"),
            "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, **leaf}


class StageTimer:
    """Reporter that records each stage's wall time, synchronising the card
    at both ends."""

    def __init__(self):
        self.stages = []

    def start_stage(self, name, total_steps=0):
        import torch
        torch.cuda.synchronize()
        self._name, self._t0 = name, time.perf_counter()

    def end_stage(self, **info):
        import torch
        torch.cuda.synchronize()
        self.stages.append((self._name, time.perf_counter() - self._t0))


def logistic_stages():
    """The short dense warmup schedule of the logistic ``sample()`` runs:
    50, then 50 and 100 with dense metric estimates, then 50."""
    from inplacedhmc_tpu_torch import default_warmup_stages
    return default_warmup_stages(init_steps=50, middle_steps=50,
                                 doubling_stages=2, terminating_steps=50,
                                 metric="dense")


def logistic_gates(tag: str, card: str, res, beta, sample_s: float) -> float:
    """The logistic ``sample()`` gates: finite draws of ``[N_DRAWS, C, D]``,
    split R-hat < 1.05, mean acceptance in [0.6, 0.95], corr(posterior
    mean, beta_true) > 0.95; prints them with the sampling loop's steps/s
    and ESS/s.  Returns the mean acceptance."""
    import torch

    from inplacedhmc_tpu_torch import diagnostics as diag

    stats, draws = res.stats, res.draws
    if tuple(draws.shape) != (N_DRAWS, C, D) \
            or not bool(torch.isfinite(draws).all()):
        raise RuntimeError(f"{tag} draws are not finite or not [n_draws, C, "
                           f"D]")
    rhat = diag.split_rhat(draws.double()).max().item()
    ess = diag.ess_bulk(draws.double(), cap=False)
    accept = stats.acceptance_rate.double().mean().item()
    post_mean = draws.double().mean(dim=(0, 1))
    corr = torch.corrcoef(torch.stack([post_mean, beta.double()]))[0, 1].item()
    chain_steps = int(stats.steps.sum())
    print(f"{tag} eps {torch.exp(res.warmup_state.log_eps).item():.5g}, "
          f"split R-hat max {rhat:.4f}, acceptance mean {accept:.4f}, "
          f"corr(posterior mean, beta_true) {corr:.5f}")
    print(f"{tag} {card}: {chain_steps / sample_s:.4g} leapfrog steps/s "
          f"(chain steps while sampling / sampling wall), "
          f"ess_bulk min {ess.min().item():.4g} -> "
          f"{ess.min().item() / sample_s:.4g} ESS/s")
    print(diag.summarize_tree_statistics(stats))
    if not rhat < 1.05:
        raise RuntimeError(f"{tag} split R-hat {rhat} >= 1.05")
    if not 0.6 <= accept <= 0.95:
        raise RuntimeError(f"{tag} mean acceptance {accept} outside "
                           f"[0.6, 0.95]")
    if not corr > 0.95:
        raise RuntimeError(f"{tag} posterior mean vs beta_true corr {corr} "
                           f"<= 0.95")
    return accept


def run_sample(card: str, kernels, tag: str = "[sample]",
               fused_opts: Optional[dict] = None, state=None):
    """``sample()`` at full width through K1, or through the kernel that
    ``fused_opts`` select (K2 under ``{"fwd_precision": "packed"}``), with
    the posterior checked (``logistic_gates``); no other kernel launched.
    Under ``grad_bf16`` every K1 launch must carry it.  From ``state`` (a
    tuned ``WarmupState``) it runs no warmup.  Returns the launch counts,
    the mean acceptance and the tuned state."""
    import torch

    from inplacedhmc_tpu_torch import sample
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              synthetic_data)
    from inplacedhmc_tpu_torch.ops.logistic import LOGISTIC_VG

    opts = dict(fused_opts or {})
    packed = opts.get("fwd_precision") == "packed"
    sym, name = (("logistic_packed_launch", "K2") if packed
                 else ("logistic_vg_launch", "K1"))
    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    model = logistic_regression(x, y, device="cuda")
    stages, start = logistic_stages(), {}
    if state is not None:
        stages = ()
        start = dict(q=state.z.q, metric=state.metric,
                     eps=float(torch.exp(state.log_eps)))
    timer = StageTimer()
    for k in kernels:
        k.launches = 0
    LOGISTIC_VG.bf16_launches = 0
    t0 = time.perf_counter()
    res = sample(SEED + (state is not None), model, N_DRAWS, C,
                 warmup_stages=stages, reporter=timer, device="cuda",
                 fused_opts=fused_opts, **start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)

    for stage, sec in timer.stages:
        print(f"{tag} {stage}: {sec:.2f} s on {card}")
    print(f"{tag} total {wall:.2f} s on {card}")
    sample_s = timer.stages[-1][1]

    stats, wstats = res.stats, res.warmup_stats
    # every lockstep transition runs at least its longest chain's steps,
    # one launch each
    min_launches = int(stats.steps.amax(dim=1).sum())
    if wstats is not None:
        min_launches += int(wstats.steps.amax(dim=1).sum())
    print(f"{tag} {name} launches {launches[sym]} "
          f"(lockstep leapfrog steps >= {min_launches})")
    if launches[sym] < min_launches:
        raise RuntimeError(f"the main path did not go through {name}")
    others = {k: v for k, v in launches.items() if k != sym}
    if any(others.values()):
        raise RuntimeError(f"the logistic path launched another kernel: "
                           f"{others}")
    bf16 = LOGISTIC_VG.bf16_launches
    if bf16 != (launches[sym] if opts.get("grad_bf16") else 0):
        raise RuntimeError(f"{tag} K1 launches with grad_bf16: {bf16} of "
                           f"{launches[sym]}")
    accept = logistic_gates(tag, card, res, beta, sample_s)
    return launches, accept, res.warmup_state


def run_logistic_tree_sample(card: str, kernels):
    """``sample()`` on BASELINE config 3 through K5-logistic
    (``use_pallas="tree"``): the data, seed, dense warmup schedule and 128
    draws of ``run_sample``; K5's logistic launchers once per transition
    (``tree_launches``: the diagonal one until the first dense window
    closes) and nothing else, K1 not once; the gates of ``run_sample``.
    Then the flagship ``tree_opts`` (``n_sweep`` ``FLAGSHIP_K``) from that
    run's tuned state with no warmup: ``N_DRAWS / FLAGSHIP_K`` launches of
    the dense launcher, the same gates.  Returns both results, their launch
    counts and their sampling walls."""
    import torch

    from inplacedhmc_tpu_torch import sample
    from inplacedhmc_tpu_torch.models import (logistic_regression,
                                              synthetic_data)

    x, y, beta = synthetic_data(SEED, N, D, device="cuda")
    model = logistic_regression(x, y, device="cuda")
    out = []
    for flagship in (False, True):
        if flagship:
            ws = out[0][0].warmup_state
            stages, topts = (), {"refresh_inside": True, "padded_io": True,
                                 "n_sweep": FLAGSHIP_K}
            start = dict(q=ws.z.q, metric=ws.metric,
                         eps=float(torch.exp(ws.log_eps)))
            mine = tree_launches("logistic", stages, N_DRAWS // FLAGSHIP_K,
                                 form="dense")
        else:
            stages, topts, start = logistic_stages(), None, {}
            mine = tree_launches("logistic", stages, N_DRAWS)
        tag = "[logistic tree" + (f", n_sweep {FLAGSHIP_K}, from the tuned "
                                  f"state]" if flagship else "]")
        timer = StageTimer()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = sample(SEED + flagship, model, N_DRAWS, C,
                     warmup_stages=stages, reporter=timer, device="cuda",
                     use_pallas="tree", tree_opts=topts, **start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(kernels)
        for name, sec in timer.stages:
            print(f"{tag} {name}: {sec:.2f} s on {card}")
        print(f"{tag} total {wall:.2f} s on {card}; launches "
              f"{ {k: v for k, v in launches.items() if v} }, expected "
              f"{mine}")
        if any(launches[k] != v for k, v in mine.items()) or any(
                v for k, v in launches.items() if k not in mine):
            raise RuntimeError(f"{tag} the logistic whole-tree path did not "
                               f"go through K5-logistic alone: {launches}")
        sample_s = timer.stages[-1][1]
        logistic_gates(tag, card, res, beta, sample_s)
        out.append((res, launches, sample_s))
    return out


def tree_launches(physics: str, stages, n_sampling: int,
                  form: str = "diag") -> dict:
    """What ``sample()`` launches of each K5 launcher of ``physics``: one
    per tuning transition under the window's metric (the starting metric's
    ``form``, by default the identity diagonal, until a window that
    estimates one has closed, then that window's form) and ``n_sampling``
    under the last one."""
    from inplacedhmc_tpu_torch import TuningNUTS
    from inplacedhmc_tpu_torch.ops.tree import (TREE_DENSE_KERNELS,
                                                TREE_KERNELS)
    n = {"diag": 0, "dense": 0}
    for stage in stages:
        if isinstance(stage, TuningNUTS):
            n[form] += stage.n
            form = stage.metric or form
    n[form] += n_sampling
    return {TREE_KERNELS[physics].symbol: n["diag"],
            TREE_DENSE_KERNELS[physics].symbol: n["dense"]}


def run_gaussian_sample(card: str, kernels, dim: int, n_chains: int,
                        n_draws: int, route: str, tree_opts=None, *,
                        model=None, metric: str = "diag", var=None,
                        physics: str = "gaussian", state=None,
                        use_pallas: str = "auto", stages=None):
    """``sample()`` on a Gaussian, by default the ``dim``-D standard normal,
    with the default warmup whose windows estimate a ``metric`` ("diag" or
    "dense"), through ``route`` ("tree": K5 once per transition, under the
    launcher of the window's metric form (``tree_launches``), and nothing
    else, or with ``tree_opts`` once per tuning transition and once per
    ``n_sweep`` sampling transitions; "lockstep": K3 once per lockstep leaf
    and nothing else), with the posterior checked: finite draws, split
    R-hat < 1.05, mean acceptance in [0.6, 0.95], and every coordinate's
    mean and variance within five Monte Carlo standard errors of 0 and of
    its variance ``var`` (default 1; from the draws' own ESS, of q and of
    q^2).  ``model`` (another Gaussian, ``physics`` its whole-tree physics)
    replaces the standard normal.  With ``state`` (a ``WarmupState``, of a
    run on the same model) there is no warmup: the sampling loop starts
    from its positions, metric and eps.  ``use_pallas`` is ``sample()``'s
    (``"on"``: the lockstep tree with K3 whatever K5 takes); ``stages``
    replaces the default warmup."""
    import torch

    from inplacedhmc_tpu_torch import (DenseMetric, NUTSKernel,
                                       default_warmup_stages, sample)
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.models import std_normal

    if model is None:
        model = std_normal(dim, device="cuda")
    dim = model.dim
    if stages is None:
        stages = default_warmup_stages(metric=metric)
    start, form = {}, "diag"
    if state is not None:
        stages = ()
        start = dict(q=state.z.q, metric=state.metric,
                     eps=float(torch.exp(state.log_eps)))
        form = "dense" if isinstance(state.metric, DenseMetric) else "diag"
    timer = StageTimer()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = sample(SEED, model, n_draws, n_chains, warmup_stages=stages,
                 reporter=timer, device="cuda", tree_opts=tree_opts,
                 use_pallas=use_pallas, **start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    tag = f"[{route} {model.name} {n_chains} x {dim}, " \
        + ("from a tuned state" if state is not None
           else f"{metric} windows") \
        + (f", n_sweep {tree_opts['n_sweep']}]" if tree_opts else "]")
    for name, sec in timer.stages:
        print(f"{tag} {name}: {sec:.2f} s on {card}")
    print(f"{tag} total {wall:.2f} s on {card}; launches "
          f"{ {k: v for k, v in launches.items() if v} } "
          f"(TREE_MIN_CHAINS {NUTSKernel.TREE_MIN_CHAINS})")
    sample_s = timer.stages[-1][1]
    stats, wstats = res.stats, res.warmup_stats
    if route == "tree":
        mine = tree_launches(physics, stages, n_draws // (
            tree_opts["n_sweep"] if tree_opts else 1), form)
        print(f"{tag} K5 launches expected {mine}")
        ok = all(launches[k] == v for k, v in mine.items())
    else:
        mine = {"leapfrog_gaussian_launch": 0}
        leaves = int(stats.steps.amax(dim=1).sum()
                     + wstats.steps.amax(dim=1).sum())
        print(f"{tag} K3 launches {launches['leapfrog_gaussian_launch']} "
              f"(lockstep leaves >= {leaves})")
        ok = launches["leapfrog_gaussian_launch"] >= leaves > 0
    if not ok or any(v for k, v in launches.items() if k not in mine):
        raise RuntimeError(f"the {route} path did not go through its kernel "
                           f"alone: {launches}")

    draws = res.draws
    if tuple(draws.shape) != (n_draws, n_chains, dim) \
            or not bool(torch.isfinite(draws).all()):
        raise RuntimeError("draws are not finite or not [n_draws, C, D]")
    x = draws.double()
    var = torch.ones((dim,), dtype=torch.float64, device=x.device) \
        if var is None else var
    rhat = diag.split_rhat(x).max().item()
    ess = diag.ess_bulk(x, cap=False)
    ess_sq = diag.ess_bulk(x * x, cap=False)
    accept = stats.acceptance_rate.double().mean().item()
    mean = x.mean(dim=(0, 1))
    mean_z = (mean / torch.sqrt(var / ess)).abs().max().item()
    var_z = ((x * x).mean(dim=(0, 1)) - mean ** 2 - var).abs() \
        / (var * torch.sqrt(2.0 / ess_sq))
    var_z = var_z.max().item()
    chain_steps = int(stats.steps.sum())
    print(f"{tag} eps {torch.exp(res.warmup_state.log_eps).item():.5g}, "
          f"split R-hat max {rhat:.4f}, acceptance mean {accept:.4f}, "
          f"max |mean| / SE {mean_z:.3f}, max |var - var_true| / SE "
          f"{var_z:.3f}")
    print(f"{tag} {card}: {chain_steps / sample_s:.4g} leapfrog steps/s "
          f"(chain steps while sampling / sampling wall), ess_bulk min "
          f"{ess.min().item():.4g} -> {ess.min().item() / sample_s:.4g} ESS/s")
    print(diag.summarize_tree_statistics(stats))
    if not rhat < 1.05:
        raise RuntimeError(f"split R-hat {rhat} >= 1.05")
    if not 0.6 <= accept <= 0.95:
        raise RuntimeError(f"mean acceptance {accept} outside [0.6, 0.95]")
    if not (mean_z < 5 and var_z < 5):
        raise RuntimeError("posterior moments outside 5 Monte Carlo SE")
    return res, launches, sample_s


def run_tile_sample(card: str, kernels, name: str):
    """``sample()`` on a BASELINE tile model through its whole-tree kernel,
    K5 once per transition and nothing else, with its posterior checked:

    * ``eight_schools``: 1,024 chains, default warmup, 1,000 draws; finite
      draws, split R-hat < 1.05, mean acceptance in [0.6, 0.95], the means
      of mu and log_tau within 5 Monte Carlo SE of the quadrature golden
      (``tests/golden/eight_schools.json``; SE from the golden sd and the
      draws' ESS);
    * ``funnel``: the 10-D centred funnel, 64 chains, ``delta`` 0.9, no
      L-BFGS start, 1,000 draws (``examples/baseline_configs.py``); finite
      draws, the divergences counted, v's sd in ``FUNNEL_V_SD_BAND`` (its
      R-hat is printed: the centred neck mixes slowly, as in JAX);
    * ``funnel_nc``: the non-centred funnel, the same run, through the
      Gaussian physics; split R-hat < 1.05 and v's sd (from ``constrain``)
      within 5 SE of 3 (SE = 3 / sqrt(2 ESS of v^2)).

    Returns the result, the launch counts and the sampling wall."""
    import torch

    from inplacedhmc_tpu_torch import (DualAveraging, TuningNUTS,
                                       default_warmup_stages, sample)
    from inplacedhmc_tpu_torch import diagnostics as diag

    model = tile_model(name)
    if name == "eight_schools":
        stages, n_chains, n_draws = default_warmup_stages(), E_CHAINS, E_DRAWS
    else:
        stages = default_warmup_stages(
            local_optimization=None,
            stepsize_adaptation=DualAveraging(delta=0.9))
        n_chains, n_draws = F_CHAINS, F_DRAWS
    n_warm = sum(s.n for s in stages if isinstance(s, TuningNUTS))
    mine = "tree_gaussian_launch" if name == "funnel_nc" \
        else f"tree_{name}_launch"
    timer = StageTimer()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = sample(SEED, model, n_draws, n_chains, warmup_stages=stages,
                 reporter=timer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    tag = f"[{name} {n_chains} x {model.dim}]"
    for stage, sec in timer.stages:
        print(f"{tag} {stage}: {sec:.2f} s on {card}")
    print(f"{tag} total {wall:.2f} s on {card}; launches {launches}")
    if launches[mine] != n_warm + n_draws or any(
            v for k, v in launches.items() if k != mine):
        raise RuntimeError(f"the {name} path did not go through its kernel "
                           f"alone: {launches}")
    sample_s = timer.stages[-1][1]
    draws, stats = res.draws, res.stats
    if tuple(draws.shape) != (n_draws, n_chains, model.dim) \
            or not bool(torch.isfinite(draws).all()):
        raise RuntimeError("draws are not finite or not [n_draws, C, D]")
    x = draws.double()
    rhat = diag.split_rhat(x).max().item()
    accept = stats.acceptance_rate.double().mean().item()
    n_div = int((stats.termination == 1).sum())
    ess = diag.ess_bulk(x, cap=False)
    chain_steps = int(stats.steps.sum())
    print(f"{tag} eps {torch.exp(res.warmup_state.log_eps).item():.5g}, "
          f"split R-hat max {rhat:.4f}, acceptance mean {accept:.4f}, "
          f"divergences {n_div} of {stats.termination.numel()} transitions, "
          f"{card}: {chain_steps / sample_s:.4g} leapfrog steps/s, ess_bulk "
          f"min {ess.min().item():.4g} -> {ess.min().item() / sample_s:.4g} "
          f"ESS/s")
    print(diag.summarize_tree_statistics(stats))
    fails = []
    if name == "eight_schools":
        with open(GOLDEN_EIGHT_SCHOOLS) as f:
            gold = json.load(f)
        for j, key in ((0, "mu"), (1, "log_tau")):
            mean = x[..., j].mean().item()
            se = gold[f"{key}_sd"] / float(ess[j]) ** 0.5
            z = abs(mean - gold[f"{key}_mean"]) / se
            print(f"{tag} {key} mean {mean:.5f} against the golden "
                  f"{gold[key + '_mean']:.5f}: {z:.3f} SE (SE {se:.3g})")
            if not z < 5:
                fails.append(f"{key} mean {z:.2f} SE from the golden")
    if name in ("eight_schools", "funnel_nc") and not rhat < 1.05:
        fails.append(f"split R-hat {rhat} >= 1.05")
    if name == "eight_schools" and not 0.6 <= accept <= 0.95:
        fails.append(f"mean acceptance {accept} outside [0.6, 0.95]")
    if name == "funnel":
        v_sd = x[..., 0].std().item()
        lo, hi = FUNNEL_V_SD_BAND
        print(f"{tag} v sd {v_sd:.4f} (calibrated band [{lo}, {hi}])")
        if not lo <= v_sd <= hi:
            fails.append(f"v sd {v_sd} outside [{lo}, {hi}]")
    if name == "funnel_nc":
        v = model.constrain(x)["v"]
        ess_sq = diag.ess_bulk((v * v)[..., None], cap=False)[0].item()
        z = abs(v.std().item() - 3.0) / (3.0 / (2 * ess_sq) ** 0.5)
        print(f"{tag} v sd {v.std().item():.4f} against 3: {z:.3f} SE")
        if not z < 5:
            fails.append(f"v sd {z:.2f} SE from 3")
    if fails:
        raise RuntimeError(f"{name}: " + "; ".join(fails))
    return res, launches, sample_s


def run_sv_sample(card: str, kernels, t_len: int = SV_T,
                  n_draws: int = SV_DRAWS, thin: int = SV_THIN,
                  recipe: bool = False):
    """``sample()`` on stochastic volatility at T = ``t_len``
    (``sv_problem``) through K5 with its physics: config 5's recipe (delta
    0.9, dense windows, ``doubling_stages`` 4, no L-BFGS start),
    ``SV_CHAINS`` chains, ``n_draws`` draws, every ``thin``-th transition
    recorded; the diagonal launcher until the first dense window closes and
    the dense one after (``tree_launches``), once per transition, and no
    other kernel: no transition ran the lockstep tree.  With ``recipe``
    the whole of config 5's recipe (``SV_RECIPE``: streamed dense windows,
    ``tuning_chunk``, ``draw_block``, ``sync_blocks``, ``collect_moments``)
    with the per-coordinate ASIS hook after every transition and bfloat16
    checkpoint stacks: every launch then has bfloat16 stacks
    (``ops.tree.CKPT_BF16_LAUNCHES``) and the hook runs once per
    transition.  Gates: finite draws, split R-hat max over every coordinate
    < 1.05 (without ``recipe``; with it printed beside the 2.26 this phase
    read without ASIS, PERF.md section 6, and R-hat from the run's split
    moments held to that of the stored
    draws, ``moment_rhat_check``), mean acceptance in ``SV_ACCEPT_BAND``,
    divergent fraction below ``SV_DIV_MAX``, at least ``SV_COVERAGE``
    percent of the true h_t inside their central 90 % posterior intervals.
    Prints phi's and s's posterior means beside the truth.  Returns the
    result, the launch counts and the sampling wall."""
    import torch

    from inplacedhmc_tpu_torch import (DualAveraging, default_warmup_stages,
                                       sample)
    from inplacedhmc_tpu_torch import diagnostics as diag
    from inplacedhmc_tpu_torch.models.stoch_vol import make_asis_hook
    from inplacedhmc_tpu_torch.ops import tree as tree_ops

    model, h_true, returns = sv_problem(t_len)
    stages = default_warmup_stages(
        local_optimization=None,
        stepsize_adaptation=DualAveraging(delta=0.9), doubling_stages=4,
        metric="dense", stream=recipe)
    mine = tree_launches("stoch_vol", stages, n_draws * thin)
    n_trans = sum(mine.values())
    opts, hooks = {}, []
    if recipe:
        asis = make_asis_hook(returns, per_coord=True,
                              n_steps=SV_ASIS_STEPS)

        def counted_asis(gen, z):
            hooks.append(1)
            return asis(gen, z)

        opts = dict(SV_RECIPE, post_step=counted_asis,
                    tree_opts={"ckpt_bf16": True})
    timer = StageTimer()
    for k in kernels:
        k.launches = 0
    tree_ops.CKPT_BF16_LAUNCHES.clear()
    tree_ops.CLUSTER_LAUNCHES.clear()
    t0 = time.perf_counter()
    res = sample(SEED, model, n_draws, SV_CHAINS, warmup_stages=stages,
                 reporter=timer, device="cuda", thin=thin, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    bf16 = dict(tree_ops.CKPT_BF16_LAUNCHES)
    clusters = dict(tree_ops.CLUSTER_LAUNCHES)
    # the dense launches the wrapper ran on a cluster (the wide form's,
    # where the last launch's chains in flight were few: ops.tree.
    # cluster_of); no other launcher has one
    dense_sym = "tree_stoch_vol_dense_launch"
    tag = f"[stoch_vol {SV_CHAINS} x {model.dim}" \
        + (", config 5's recipe]" if recipe else "]")
    for stage, sec in timer.stages:
        print(f"{tag} {stage}: {sec:.2f} s on {card}")
    print(f"{tag} total {wall:.2f} s on {card}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, expected {mine}"
          + (f"; with bfloat16 stacks {bf16}; ASIS hook calls "
             f"{len(hooks)} of {n_trans} transitions" if recipe else "")
          + f"; on a cluster {clusters}")
    if any(launches[k] != v for k, v in mine.items()) or any(
            v for k, v in launches.items() if k not in mine):
        raise RuntimeError(f"the stoch_vol path did not go through "
                           f"K5-stoch_vol alone: {launches}")
    if set(clusters) - {dense_sym} or \
            clusters.get(dense_sym, 0) > launches[dense_sym]:
        raise RuntimeError(f"cluster launches {clusters} of the launches "
                           f"{launches}")
    if recipe and (bf16 != {k: v for k, v in mine.items() if v}
                   or len(hooks) != n_trans):
        raise RuntimeError(f"the recipe's transitions did not all run K5 "
                           f"with bfloat16 stacks and the hook: {bf16}, "
                           f"{len(hooks)} hook calls")
    sample_s = timer.stages[-1][1]
    draws, stats = res.draws, res.stats
    if tuple(draws.shape) != (n_draws, SV_CHAINS, model.dim) \
            or not bool(torch.isfinite(draws).all()):
        raise RuntimeError("draws are not finite or not [n_draws, C, D]")
    x = draws.double()
    rhat = diag.split_rhat(x)
    accept = stats.acceptance_rate.double().mean().item()
    div = (stats.termination == 1).double().mean().item()
    ess = diag.ess_bulk(x, cap=False)
    hs = torch.sort(x[..., 2:].reshape(-1, t_len), dim=0).values
    n = hs.shape[0]
    lo, hi = hs[int(0.05 * (n - 1))], hs[int(math.ceil(0.95 * (n - 1)))]
    h64 = h_true.double()
    covered = int(((h64 >= lo) & (h64 <= hi)).sum())
    need = math.ceil(SV_COVERAGE * t_len / 100)
    post = model.constrain(x)
    chain_steps = int(stats.steps.sum())
    print(f"{tag} eps {torch.exp(res.warmup_state.log_eps).item():.5g}, "
          f"split R-hat max {rhat.max().item():.4f} (coordinate "
          f"{int(rhat.argmax())}; raw_phi {rhat[0].item():.4f}, log_s "
          f"{rhat[1].item():.4f}; "
          + ("not gated; 2.26 on log_s over 64 draws without ASIS, "
             "PERF.md section 6"
             if recipe else "gated")
          + f"), acceptance mean {accept:.4f}, divergent "
          f"fraction {div:.5f}; {covered} of {t_len} true h_t in their "
          f"central 90 % intervals (at least {need}); posterior means phi "
          f"{post['phi'].mean().item():.4f} (truth {SV_PHI}), s "
          f"{post['s'].mean().item():.4f} (truth {SV_S})")
    print(f"{tag} {card}: {chain_steps * thin / sample_s:.4g} leapfrog "
          f"steps/s (the recorded transitions' steps times {thin}), "
          f"ess_bulk min {ess.min().item():.4g} (raw_phi "
          f"{ess[0].item():.4g}, log_s {ess[1].item():.4g}) -> "
          f"{ess.min().item() / sample_s:.4g} ESS/s")
    print(diag.summarize_tree_statistics(stats))
    fails = []
    if recipe:
        fails += moment_rhat_check(tag, res.sample_moments, rhat)
    elif not rhat.max().item() < 1.05:
        fails.append(f"split R-hat {rhat.max().item()} >= 1.05")
    lo_a, hi_a = SV_ACCEPT_BAND
    if not lo_a <= accept <= hi_a:
        fails.append(f"mean acceptance {accept} outside [{lo_a}, {hi_a}]")
    if not div < SV_DIV_MAX:
        fails.append(f"divergent fraction {div} >= {SV_DIV_MAX}")
    if not covered >= need:
        fails.append(f"{covered} true h_t covered, fewer than {need}")
    if fails:
        raise RuntimeError("stoch_vol: " + "; ".join(fails))
    return res, launches, sample_s


def run_sv_wide_default(card: str, kernels, ws):
    """The default route at config 5's D = 1,002: ``sample()`` with the
    default tree options (float32 stacks, no hook, stored draws, one
    block), no warmup, from the state ``ws`` (the recipe's tuned q, eps and
    M^-1, dense or diagonal), ``SV_DEFAULT_DRAWS`` draws.  Every transition
    goes through K5-stoch_vol's launcher of that metric form, none with
    bfloat16 stacks and no other kernel; the draws are finite.  Returns the
    result and the launch counts."""
    import torch

    from inplacedhmc_tpu_torch import sample
    from inplacedhmc_tpu_torch.core.metric import DenseMetric
    from inplacedhmc_tpu_torch.ops import tree as tree_ops

    model, _, _ = sv_problem(SV_WIDE_T)
    dense = isinstance(ws.metric, DenseMetric)
    sym = f"tree_stoch_vol{'_dense' if dense else ''}_launch"
    for k in kernels:
        k.launches = 0
    tree_ops.CKPT_BF16_LAUNCHES.clear()
    t0 = time.perf_counter()
    res = sample(SEED + 6, model, SV_DEFAULT_DRAWS, SV_CHAINS,
                 warmup_stages=(), q=ws.z.q, metric=ws.metric,
                 eps=float(torch.exp(ws.log_eps)), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    bf16 = dict(tree_ops.CKPT_BF16_LAUNCHES)
    stats = res.stats
    print(f"[stoch_vol {SV_CHAINS} x {model.dim}, default options, "
          f"{'dense' if dense else 'diagonal'} metric] {SV_DEFAULT_DRAWS} "
          f"draws from the recipe's tuned state in {wall:.2f} s on {card}; "
          f"launches { {k: v for k, v in launches.items() if v} }, with "
          f"bfloat16 stacks {bf16}; acceptance mean "
          f"{stats.acceptance_rate.double().mean().item():.4f}, depth mean "
          f"{stats.depth.double().mean().item():.3f}")
    if launches[sym] != SV_DEFAULT_DRAWS or bf16 or any(
            v for k, v in launches.items() if k != sym):
        raise RuntimeError(f"the default stoch_vol route at D = "
                           f"{model.dim} did not go through {sym} alone "
                           f"with float32 stacks: {launches}, {bf16}")
    if tuple(res.draws.shape) != (SV_DEFAULT_DRAWS, SV_CHAINS, model.dim) \
            or not bool(torch.isfinite(res.draws).all()):
        raise RuntimeError("default-route draws are not finite or not "
                           "[n_draws, C, D]")
    return res, launches


def moment_rhat_check(tag: str, mom, rhat) -> list:
    """R-hat from the run's float32 split moments
    (``diagnostics.split_rhat_from_moments``) against ``rhat``, split R-hat
    of the stored draws in float64, on every coordinate.  Each half's
    within variance is a one-pass ``(s2 - s1^2 / n) / (n - 1)`` of n draws
    centred on the chain's start: its float32 error is within ``3 gamma_n
    s2`` (the two sums' rounding, Higham section 3.1), relative to the
    variance ``3 gamma_n s2 / ((n - 1) var)``; averaged over the chains'
    halves, ``W`` is within ``3 gamma_n`` times ``r = mean(s2) / ((n - 1)
    W)`` of itself, and the half means' spread ``B`` far less (their
    errors are ``gamma_n`` of ``|mean - start|``, the spread is the
    posterior's).  R-hat, ``sqrt(((n - 1) / n W + B / n) / W)``, moves by
    at most half of W's relative error, so the bound is
    ``MOMENT_RHAT_K gamma_n r`` of R-hat, ``MOMENT_RHAT_K`` = 4 leaving a
    third over the 3 of the argument.  Returns the failures."""
    import torch

    from inplacedhmc_tpu_torch import diagnostics as diag
    got = diag.split_rhat_from_moments(mom).double()
    n = float(mom.cnt.min())
    w_mom = ((mom.s2 - mom.s1 * mom.s1 / n) / (n - 1)).double() \
        .reshape(-1, got.shape[0]).mean(0)
    r = (mom.s2.double().reshape(-1, got.shape[0]).mean(0) / (n - 1)) \
        / torch.clamp(w_mom, min=1e-300)
    bound = MOMENT_RHAT_K * _gamma(int(n)) * r * rhat
    diff = (got - rhat).abs()
    used = float((diff / bound).max())
    print(f"{tag} split R-hat from the moments (halves "
          f"{mom.cnt.tolist()}) against the stored draws': max difference "
          f"{float(diff.max()):.3e} (coordinate {int(diff.argmax())}), "
          f"{used:.3g} of its bound (MOMENT_RHAT_K {MOMENT_RHAT_K} gamma_n "
          f"r, r up to {float(r.max()):.3g}); moment R-hat max "
          f"{float(got.max()):.4f}, log_s {float(got[1]):.4f}")
    return [] if used <= 1.0 else [f"R-hat from the moments differs from "
                                   f"the draws' by {used:.3g} of its bound"]


def bench_flagship(card: str) -> int:
    """``bench.py``'s measurement of the flagship path, done the port's way:
    the 100-D standard normal at 10,240 chains from q0 normal (seed 0), eps
    0.25, the identity metric, ``run_sampling`` of ``BENCH_TRANSITIONS``
    transitions recording ``keep_dims=(0,)``, best of 3 (each run continuing
    from the last one's state), then the eps 0.005 probe (every tree at max
    depth: the per-step cost with the per-transition costs amortised).
    Prints chain leapfrog steps/s and ``leaf_work_over_wall`` = steps x
    probe cost per step / wall for each n_sweep of ``SWEEP_KS`` (the
    flagship options) and for phase 4's route.  Returns the fastest
    n_sweep."""
    import torch

    from inplacedhmc_tpu_torch import NUTS
    from inplacedhmc_tpu_torch.adapt import warmup as W
    from inplacedhmc_tpu_torch.models import std_normal
    from inplacedhmc_tpu_torch.sample import NUTSKernel, f32_matmuls

    model = std_normal(G_DIM, device="cuda")
    q0 = torch.randn((G_CHAINS, G_DIM),
                     generator=torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    rates = {}
    for k in (None,) + SWEEP_KS:
        topts = None if k is None else {
            "refresh_inside": True, "padded_io": True, "n_sweep": k}
        kern = NUTSKernel(model, NUTS(), tree_opts=topts)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

        def run_once(state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = W.run_sampling(gen, kern.potential, kern.algorithm, state,
                                 BENCH_TRANSITIONS,
                                 transition_factory=kern.transition_factory,
                                 keep_dims=(0,))
            steps = int(out.stats.steps.sum())
            torch.cuda.synchronize()
            return out, steps, time.perf_counter() - t0

        with f32_matmuls():
            state = W.init_warmup_state(gen, kern.potential, G_DIM,
                                        G_CHAINS, device="cuda", q=q0,
                                        eps=BENCH_EPS)
            out, _, _ = run_once(state)              # warm
            state = state._replace(z=out.z)
            best, best_steps = float("inf"), 0
            for _ in range(3):
                out, steps, dt = run_once(state)
                if dt < best:
                    best, best_steps = dt, steps
                state = state._replace(z=out.z)
            deep = state._replace(log_eps=torch.log(torch.tensor(
                PROBE_EPS, device="cuda")))
            run_once(deep)
            _, steps_deep, dt_deep = run_once(deep)
        rate = best_steps / best
        eff = best_steps * (dt_deep / steps_deep) / best
        rates[k] = rate
        label = "phase 4's route (no tree_opts)" if k is None \
            else f"n_sweep {k}"
        print(f"[bench] {label} on {card}: {rate:.4g} chain leapfrog "
              f"steps/s ({best_steps} steps in {best * 1e3:.2f} ms, "
              f"{best / BENCH_TRANSITIONS * 1e3:.4f} ms per transition), "
              f"leaf_work_over_wall {eff:.4f} (probe {steps_deep} steps in "
              f"{dt_deep * 1e3:.2f} ms)")
    fastest = max(SWEEP_KS, key=lambda k: rates[k])
    print(f"[bench] fastest n_sweep {fastest} ({rates[fastest]:.4g} "
          f"steps/s); the flagship phase ran FLAGSHIP_K = {FLAGSHIP_K} "
          f"({rates[FLAGSHIP_K]:.4g})")
    return fastest


def crossover(card: str, physics: str = "gaussian", state=None,
              model=None, start=None, chains=CROSSOVER_CHAINS,
              check: bool = True) -> dict:
    """Wall time of one transition at each of ``CROSSOVER_CHAINS``, through
    the whole-tree kernel and through the route ``NUTSKernel`` takes below
    its threshold, from q0 normal at the fixed eps ``CROSSOVER_EPS`` and
    the identity metric, or at the tuned eps and metric of a run's
    ``state`` (a ``WarmupState``) with ``model`` and positions from
    ``start(c, gen)``: the 100-D standard normal against the lockstep tree
    with K3 (with a dense metric: autograd on the lockstep tree), eight
    schools (mu about its posterior), the funnel, the dense Gaussian and
    stochastic volatility against autograd of ``logp`` on the lockstep
    tree, logistic regression
    (K5-logistic, which only ``use_pallas="tree"`` takes) against the
    default route's lockstep tree with K1.  With ``check``, fails unless
    the whole tree was the faster exactly at the counts from the threshold
    (``NUTSKernel.TREE_MIN_CHAINS``, ``TREE_MIN_CHAINS_BY_PHYSICS``) up;
    returns the faster route by chain count.  The whole tree is timed over
    10 transitions (2 where its first took more than 0.1 s), the other
    route over 2 (its first alone where that took more than a second)."""
    import torch

    from inplacedhmc_tpu_torch import DenseMetric, NUTSKernel, identity_metric
    from inplacedhmc_tpu_torch.core.hamiltonian import evaluate
    from inplacedhmc_tpu_torch.models import std_normal
    from inplacedhmc_tpu_torch.nuts.tree import nuts_transition
    from inplacedhmc_tpu_torch.ops.tree import make_tree_transition
    from inplacedhmc_tpu_torch.sample import _tree_physics

    if model is None:
        model = std_normal(G_DIM, device="cuda") if physics == "gaussian" \
            else tile_model(physics)
    _, data = _tree_physics(model.structure, "tree")
    kern = NUTSKernel(model)
    if state is None:
        metric = identity_metric(model.dim, device="cuda")
        eps = CROSSOVER_EPS[physics]
    else:
        metric, eps = state.metric, float(torch.exp(state.log_eps))
    trans = make_tree_transition(physics, data, model.dim, metric,
                                 max_depth=MAX_DEPTH)
    step_fn = kern.step_factory(metric) if kern.step_factory else None
    other = "lockstep + K3" if step_fn else "lockstep + K1" \
        if physics == "logistic" else "autograd on the lockstep tree"
    form = "dense" if isinstance(metric, DenseMetric) else "diagonal"

    def lockstep(gen, z):
        return nuts_transition(gen, kern.potential, metric, z, eps,
                               max_depth=MAX_DEPTH, step_fn=step_fn)

    faster = {}
    for c in chains:
        gen = torch.Generator(device="cuda").manual_seed(SEED + c)
        q0 = start(c, gen) if start is not None \
            else torch.randn((c, G_DIM), generator=gen, device="cuda") \
            if physics == "gaussian" else tile_start(physics, c, gen)
        z = evaluate(kern.potential, q0)
        t0 = time.perf_counter()
        trans(gen, z, eps)[1].depth.max().item()   # K5's warm-up
        k5 = wall_ms(lambda: trans(gen, z, eps),
                     iters=2 if time.perf_counter() - t0 > 0.1 else 10,
                     warmup=1)
        t0 = time.perf_counter()
        depth = int(lockstep(gen, z)[1].depth.max())   # also its warm-up
        warm_s = time.perf_counter() - t0
        slow = warm_s * 1e3 if warm_s > 1.0 else wall_ms(
            lambda: lockstep(gen, z), iters=2, warmup=0)
        faster[c] = "K5" if k5 < slow else "lockstep"
        print(f"[crossover] {physics} ({model.dim}-D, {form} metric), {c} "
              f"chains, eps {eps:.4g} on {card}: whole tree (K5) {k5:.3f} "
              f"ms, {other} {slow:.3f} ms per transition "
              f"({slow / k5:.1f}x); deepest tree {depth}")
    if not check:
        print(f"[crossover] {physics} ({form} metric): faster route by chain "
              f"count: {faster} (recorded; the default route stays)")
        return faster
    tmc = kern.tree_min_chains(physics)
    print(f"[crossover] {physics} ({form} metric): threshold {tmc} chains; "
          f"faster route by chain count: {faster}")
    if not all((v == "K5") == (c >= tmc) for c, v in faster.items()):
        raise RuntimeError(f"the whole-tree threshold of {physics} ({tmc} "
                           f"chains) contradicts the timings: {faster}")
    return faster


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import inplacedhmc_tpu_torch  # noqa: F401  (fails outside a checkout)
    from inplacedhmc_tpu_torch import default_warmup_stages
    from inplacedhmc_tpu_torch.core.metric import diag_metric
    from inplacedhmc_tpu_torch.models import logistic_regression, std_normal

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    kernels = build_kernels()
    logistic_instantiations(card)
    print(f"[phase] build {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    k1 = check_logistic_kernel(card)
    check_logistic_wide(card)
    k1b = check_grad_bf16_kernel(card)
    k2 = check_packed_kernel(card)
    k3 = check_leapfrog_kernel(card)
    k4 = check_multistep_kernel(card)
    check_tree_kernel(card)
    check_generator(card)
    check_sweep(card)
    check_tile_kernel(card, "eight_schools", (E_CHAINS, G_CHAINS),
                      (0.05, 0.3, 1.5))
    check_tile_kernel(card, "funnel", (F_CHAINS, E_CHAINS), (0.05, 0.3, 3.0),
                      neck=True)
    check_sweep(card, "eight_schools")
    t_sv = time.perf_counter()
    for dense, counts in ((False, (SV_CHAINS, SV_BIG)), (True, (SV_CHAINS,))):
        check_tile_kernel(card, "stoch_vol", counts, SV_EPS, neck=True,
                          dense=dense)
    check_sweep(card, "stoch_vol", SV_SWEEP_EPS)
    print(f"[k5-stoch_vol] checks {time.perf_counter() - t_sv:.2f} s")
    check_wide_kernels(card)
    check_ckpt_bf16(card)
    k5d_diag = check_dense_tree_kernel(card)
    check_dense_sweep(card)
    k5l_diag = check_logistic_tree_kernel(card)
    print(f"[phase] kernel checks {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches, k1_accept, k1_state = run_sample(card, kernels)
    k1["launches"] = launches["logistic_vg_launch"]
    print(f"[sample] K1 device time about {k1['launches']} x {k1['ms']:.4f} "
          f"ms = {k1['launches'] * k1['ms'] / 1e3:.2f} s of sample()'s wall")
    print(f"[phase] logistic sample {time.perf_counter() - t:.2f} s")
    # the same through K2 (fused_opts packed), then K1 with grad_bf16 from
    # the K1 run's tuned state
    t = time.perf_counter()
    launches, k2_accept, _ = run_sample(card, kernels, "[packed]",
                                        {"fwd_precision": "packed"})
    k2["launches"] = launches["logistic_packed_launch"]
    print(f"[packed] acceptance mean {k2_accept:.4f} through K2 beside "
          f"{k1_accept:.4f} through K1; K2 device time about "
          f"{k2['launches']} x {k2['ms']:.4f} ms = "
          f"{k2['launches'] * k2['ms'] / 1e3:.2f} s of sample()'s wall")
    print(f"[phase] packed logistic sample {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches, _, _ = run_sample(card, kernels, "[grad_bf16]",
                                {"grad_bf16": True}, state=k1_state)
    k1b["launches"] = launches["logistic_vg_launch"]
    del k1_state
    print(f"[phase] grad_bf16 logistic sample {time.perf_counter() - t:.2f} "
          f"s")
    # BASELINE config 3 through K5-logistic (use_pallas="tree"), then its
    # flagship options from the tuned state, and the crossover against the
    # default route (lockstep + K1) at that state
    t = time.perf_counter()
    (res, launches, sample_s), (res_f, launches_f, _) = \
        run_logistic_tree_sample(card, kernels)
    x, y, _, _, _, ldata = logistic_problem()
    k5l_diag["launches"] = launches["tree_logistic_launch"]
    k5l = tree_at_state(card, res, physics="logistic", data=ldata,
                        name="tree_logistic_dense")
    k5l["launches"] = launches["tree_logistic_dense_launch"]
    print(f"[logistic tree] K5-logistic device time {N_DRAWS} x "
          f"{k5l['ms']:.4f} ms = {N_DRAWS * k5l['ms'] / 1e3:.3f} s of the "
          f"{sample_s:.3f} s sampling wall")
    k5ls = tree_at_state(card, res_f, "refresh", FLAGSHIP_K,
                         physics="logistic", data=ldata,
                         name="tree_logistic_dense_sweep")
    k5ls["launches"] = launches_f["tree_logistic_dense_launch"]
    ws = res.warmup_state
    del res, res_f
    crossover(card, "logistic", ws,
              logistic_regression(x, y, device="cuda"),
              lambda c, gen: ws.z.q[:c].contiguous(),
              LOGISTIC_CROSSOVER_CHAINS, check=False)
    del ws
    print(f"[phase] logistic whole-tree sample {time.perf_counter() - t:.2f} "
          f"s")
    t = time.perf_counter()
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, G_DIM, G_CHAINS, G_DRAWS, "tree")
    k5 = tree_at_state(card, res)
    k5["launches"] = launches["tree_gaussian_launch"]
    print(f"[tree {G_CHAINS}] K5 device time {G_DRAWS} x {k5['ms']:.4f} ms "
          f"= {G_DRAWS * k5['ms'] / 1e3:.3f} s of the {sample_s:.3f} s "
          f"sampling wall")
    del res
    print(f"[phase] whole-tree sample {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    topts = {"refresh_inside": True, "padded_io": True,
             "n_sweep": FLAGSHIP_K}
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, G_DIM, G_CHAINS, G_DRAWS, "tree", topts)
    k5s = tree_at_state(card, res, "refresh", FLAGSHIP_K)
    k5s["launches"] = launches["tree_gaussian_launch"]
    n_launch = G_DRAWS // FLAGSHIP_K
    print(f"[flagship {G_CHAINS}] K5 device time {n_launch} x "
          f"{k5s['ms']:.4f} ms = {n_launch * k5s['ms'] / 1e3:.4f} s of the "
          f"{sample_s:.4f} s sampling wall ({sample_s / G_DRAWS * 1e3:.4f} "
          f"ms per transition)")
    del res
    bench_flagship(card)
    print(f"[phase] flagship {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    res, _, _ = run_gaussian_sample(card, kernels, G_DIM, S_CHAINS, S_DRAWS,
                                    "tree")
    tree_at_state(card, res)
    del res
    print(f"[phase] whole-tree sample, {S_CHAINS} chains "
          f"{time.perf_counter() - t:.2f} s")
    # the 1000-D normal through K5's wide form (the default route), then
    # the same model on the lockstep tree with K3 (use_pallas="on"), cut
    # to a short run: K3's own path
    t = time.perf_counter()
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, W_DIM, S_CHAINS, S_DRAWS, "tree")
    k5w = tree_at_state(card, res, name="gaussian_tree_transition_wide")
    k5w["launches"] = launches["tree_gaussian_launch"]
    print(f"[tree {S_CHAINS} x {W_DIM}] K5 (wide) device time {S_DRAWS} x "
          f"{k5w['ms']:.4f} ms = {S_DRAWS * k5w['ms'] / 1e3:.3f} s of the "
          f"{sample_s:.3f} s sampling wall")
    w_state = res.warmup_state
    del res
    print(f"[phase] wide whole-tree sample {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    _, launches, _ = run_gaussian_sample(
        card, kernels, W_DIM, S_CHAINS, W_K3_DRAWS, "lockstep",
        use_pallas="on", stages=default_warmup_stages(**W_K3_STAGES))
    k3["launches"] = launches["leapfrog_gaussian_launch"]
    print(f"[phase] lockstep sample {time.perf_counter() - t:.2f} s")
    tiles = []
    for name in ("eight_schools", "funnel", "funnel_nc"):
        t = time.perf_counter()
        res, launches, sample_s = run_tile_sample(card, kernels, name)
        if name != "funnel_nc":
            st = tile_model(name).structure
            entry = tree_at_state(card, res, physics=name,
                                  data={**st["data"], **st["scalars"]})
            entry["launches"] = launches[f"tree_{name}_launch"]
            n = res.draws.shape[0]
            print(f"[{name}] K5 device time about {n} x {entry['ms']:.4f} ms "
                  f"= {n * entry['ms'] / 1e3:.3f} s of the {sample_s:.3f} s "
                  f"sampling wall")
            tiles.append(entry)
        del res
        print(f"[phase] {name} sample {time.perf_counter() - t:.2f} s")
    # BASELINE config 5's model at T = 100 through K5-stoch_vol, then each
    # launcher timed at the tuned state (the dense M^-1, and its diagonal)
    t = time.perf_counter()
    res, launches, sample_s = run_sv_sample(card, kernels)
    st = tile_model("stoch_vol").structure
    sv_data = {**st["data"], **st["scalars"]}
    sv_state = res.warmup_state
    sv = [tree_at_state(card, res, physics="stoch_vol", data=sv_data,
                        name="tree_stoch_vol_dense")]
    sv[0]["launches"] = launches["tree_stoch_vol_dense_launch"]
    n = SV_DRAWS * SV_THIN
    print(f"[stoch_vol] K5-stoch_vol device time {n} x {sv[0]['ms']:.4f} ms "
          f"= {n * sv[0]['ms'] / 1e3:.3f} s of the {sample_s:.3f} s sampling "
          f"wall")
    sv_diag = sv_state._replace(metric=diag_metric(
        torch.diagonal(sv_state.metric.inv).contiguous()))
    sv.insert(0, tree_at_state(card, res._replace(warmup_state=sv_diag),
                               physics="stoch_vol", data=sv_data))
    sv[0]["launches"] = launches["tree_stoch_vol_launch"]
    del res
    print(f"[phase] stoch_vol sample {time.perf_counter() - t:.2f} s")
    # config 5's T = 1,000 through K5-stoch_vol's wide form with its whole
    # recipe (ASIS, streamed moments, chunks, blocks) on bfloat16 stacks;
    # then each launcher timed at the tuned state with both stack types
    t = time.perf_counter()
    res, launches, sample_s = run_sv_sample(
        card, kernels, SV_WIDE_T, SV_WIDE_DRAWS, 1, recipe=True)
    st = tile_model("stoch_vol", SV_WIDE_T).structure
    svw_data = {**st["data"], **st["scalars"]}
    svw_state = res.warmup_state
    del res
    # the wide dense launch's bound at the tuned state: the deepest chain
    # alone against every chain, at K = 1 and on a cluster, and the
    # wrapper's K there
    svw_k = tail_at_state(card, svw_state, "stoch_vol", svw_data,
                          f"stoch_vol, {SV_CHAINS} x {SV_WIDE_T + 2}, the "
                          f"recipe's tuned state, dense metric, bfloat16 "
                          f"stacks")
    svw, svw32 = [], []
    for dense in (False, True):
        ws = svw_state if dense else svw_state._replace(metric=diag_metric(
            torch.diagonal(svw_state.metric.inv).contiguous()))
        form = "dense" if dense else "diagonal"
        name = "tree_stoch_vol_wide" + ("_dense" if dense else "")
        entry = bf16_at_state(
            card, ws, "stoch_vol", svw_data,
            f"stoch_vol, {SV_CHAINS} x {SV_WIDE_T + 2}, the recipe's tuned "
            f"state, {form} metric", name + "_ckpt_bf16")
        sym = f"tree_stoch_vol{'_dense' if dense else ''}_launch"
        entry["launches"] = launches[sym]
        svw.append(entry)
        # the default route (float32 stacks) from the same state, and its
        # launcher timed there on bf16_at_state's inputs
        res_d, launches_d = run_sv_wide_default(card, kernels, ws)
        entry = tree_at_state(card, res_d._replace(warmup_state=ws),
                              physics="stoch_vol", data=svw_data, name=name)
        entry["launches"] = launches_d[sym]
        svw32.append(entry)
        if dense:   # the wrapper's blocks a chain at the tuned state
            for e in (svw[-1], entry):
                e["cluster"] = svw_k
        del res_d
    svw += svw32
    print(f"[stoch_vol {SV_WIDE_T}] K5-stoch_vol (wide, bfloat16 stacks) "
          f"device time {SV_WIDE_DRAWS} x {svw[1]['ms']:.4f} ms = "
          f"{SV_WIDE_DRAWS * svw[1]['ms'] / 1e3:.3f} s of the "
          f"{sample_s:.3f} s sampling wall")
    print(f"[phase] wide stoch_vol sample {time.perf_counter() - t:.2f} s")
    # the dense metric: the 250-D Wishart-precision mvn at 1,024 chains on
    # the default route and with the flagship options, the 100-D normal at
    # 10,240 chains with dense windows
    model, sigma = mvn_target()
    var = torch.diag(sigma)
    mvn_data = {"prec": model.structure["precision"]}
    dense = []
    t = time.perf_counter()
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, 0, MVN_CHAINS, MVN_DRAWS, "tree", model=model,
        metric="dense", var=var, physics="dense_gaussian",
        stages=default_warmup_stages(metric="dense",
                                     doubling_stages=MVN_DOUBLING))
    entry = tree_at_state(card, res, physics="dense_gaussian", data=mvn_data,
                          name="tree_dense_gaussian_dense")
    entry["launches"] = launches["tree_dense_gaussian_dense_launch"]
    k5d_diag["launches"] = launches["tree_dense_gaussian_launch"]
    print(f"[mvn] K5-dense device time {MVN_DRAWS} x {entry['ms']:.4f} ms = "
          f"{MVN_DRAWS * entry['ms'] / 1e3:.3f} s of the {sample_s:.3f} s "
          f"sampling wall")
    dense += [k5d_diag, entry]
    mvn_state = res.warmup_state
    del res
    print(f"[phase] mvn sample {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    # from the first run's tuned state: its tuning windows run the
    # n_sweep = 1 launcher that the first run covers already
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, 0, MVN_CHAINS, MVN_SWEEP_DRAWS, "tree", topts,
        model=model, metric="dense", var=var, physics="dense_gaussian",
        state=mvn_state)
    entry = tree_at_state(card, res, "refresh", FLAGSHIP_K,
                          physics="dense_gaussian", data=mvn_data,
                          name="tree_dense_gaussian_dense_sweep")
    entry["launches"] = launches["tree_dense_gaussian_dense_launch"]
    dense.append(entry)
    del res
    print(f"[phase] mvn flagship sample {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    res, launches, sample_s = run_gaussian_sample(
        card, kernels, G_DIM, G_CHAINS, DENSE_G_DRAWS, "tree",
        metric="dense")
    entry = tree_at_state(card, res, name="gaussian_tree_transition_dense")
    entry["launches"] = launches["tree_gaussian_dense_launch"]
    dense.append(entry)
    gauss_state = res.warmup_state
    del res
    print(f"[phase] dense-window whole-tree sample "
          f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    for physics in ("gaussian", "eight_schools", "funnel"):
        crossover(card, physics)
    chol = torch.linalg.cholesky(sigma).T.float()
    crossover(card, "dense_gaussian", mvn_state, model,
              lambda c, gen: torch.randn((c, MVN_DIM), generator=gen,
                                         device="cuda") @ chol)
    crossover(card, "gaussian", gauss_state)
    crossover(card, "stoch_vol", sv_state, tile_model("stoch_vol"),
              lambda c, gen: sv_state.z.q[torch.randint(
                  0, SV_CHAINS, (c,), generator=gen, device="cuda")],
              SV_CROSSOVER_CHAINS)
    # above D = 256 (K5's wide form) at the tuned states: the 1000-D normal
    # against the lockstep tree with K3, stochastic volatility at T = 1,000
    # against autograd on the lockstep tree
    crossover(card, "gaussian", w_state, std_normal(W_DIM, device="cuda"),
              lambda c, gen: torch.randn((c, W_DIM), generator=gen,
                                         device="cuda"),
              CROSSOVER_CHAINS)
    # (to 1,024 chains: the 10,240-chain point, 15.6x in K5's favour, and
    # its 7 s lockstep transition were cut to keep the script's budget)
    crossover(card, "stoch_vol", svw_state,
              tile_model("stoch_vol", SV_WIDE_T),
              lambda c, gen: svw_state.z.q[torch.randint(
                  0, SV_CHAINS, (c,), generator=gen, device="cuda")],
              CROSSOVER_CHAINS[:-1])
    print(f"[phase] crossover {time.perf_counter() - t:.2f} s")
    print(f"[k5-wide] stochastic volatility's long sums over the run: the "
          f"largest K needed by field {LONG_SUM_NEED} (LONG_SUM_K "
          f"{LONG_SUM_K})")
    print(f"[phase] total {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [k1, k1b, k2, k3, k4, k5, k5s, *tiles,
                                  *dense, k5l_diag, k5l, k5ls, *sv, k5w,
                                  *svw]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
