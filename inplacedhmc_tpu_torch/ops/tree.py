"""The whole NUTS transition in one kernel, for a diagonal or dense metric
and a tile physics.

The port's counterpart of ``inplacedhmc_tpu/ops/tree_pallas.py``
(``_make_kernel``, ``_build_transition_padded``, ``make_tree_transition``,
``make_gaussian_tree_transition``, ``make_dense_gaussian_tree_transition``,
``make_logistic_tree_transition``).  The physics is the model's log density
and gradient, written by hand (``ops/tile_physics.py``: the Gaussian of
``diag_gaussian`` models, eight schools, the funnel, the dense Gaussian of
``mvn``, logistic regression over an ``[npad, D]`` observation matrix,
stochastic volatility's AR(1) latents)
where JAX differentiates the model's ``tile_logp`` in its kernel or
hand-fuses it (logistic regression's chunked ``tile_vg``).  ``M^-1`` is a
``[D]`` diagonal or a ``[D, D]`` dense matrix; with a dense one every
``p# = M^-1 p`` is a product and the momentum refresh is
``xi @ mass_chol^T``
(``core/metric.py::sample_momentum``).  The transition is the lockstep
tree's (``nuts/tree.py``), field for field: the momentum-refresh
energy, the doubling loop, the leapfrog leaves, the generalized U-turn checks
on the checkpoint stack, the progressive and biased proposals, divergence at
``delta < min_delta``, the acceptance sum ``sum exp(min(delta, 0))`` and the
termination records.

One launch runs ``n_sweep = K`` sequential transitions from a start it only
reads, the proposal of each the start of the next (the last one the carry
of the next launch), and rows whose ``valid`` is 0 (the padding of
``block_c`` tiles) start inactive.  Its random numbers come from the
Philox generator of ``utils/philox.py``, keyed by two words per launch: the
proposal uniforms always (JAX's ``use_prng``), and under ``refresh_inside``
the momentum and the direction word too.  Leaf ``n`` of the subtree of depth
``d`` reads uniform slot ``2^d - 1 + n``, the merge at depth ``d`` slot
``2^md - 1 + d``; so a chain's result depends on its own draws only,
whichever chains run beside it.  The explicit arrays of the TPU kernel's
interpret mode stay as test hooks: momentum ``[K, C, D]``, direction words
``[K, C]``, uniforms ``[K, 2^md - 1 + md, C]``.

On a CUDA tensor :func:`tree_sweep` launches the hand-written kernel of its
physics and metric form (``csrc/tree_<physics>.cu`` over
``csrc/tree_kernel.cuh``, one launcher per metric form): one warp per chain
up to ``D = 256``, and above it, for the physics of ``WIDE_PHYSICS``, one
chain per block of ``ceil(D / 256)`` warps whose row sums, neighbour
exchanges and ``[D, D]`` products go through shared memory, up to
``MAX_DIM`` within the shared-memory bound of :func:`takes`; for the
physics of ``TILED_PHYSICS`` (logistic regression), a tile of chains a
block, a warp each, walking their trees in lockstep as the TPU kernel's
tile does, its physics a call of the whole tile on the tensor cores with
the observations streamed through shared memory from the plane of
:func:`tile_plane` (:func:`tile_plan`);
on a CPU tensor it runs :func:`tree_sweep_plain`, the lockstep form over all
chains in plain torch, drawing the same Philox numbers.  There is no other
path: a CUDA tensor launches the kernel or raises.  The ``gaussian_*``
functions are these with the Gaussian physics of precision ``lam``.

Every ``[D, D]`` product of a launch (a dense ``M^-1``, the refresh's
``mass_chol^T``, the dense Gaussian's ``P``) reads its matrix from shared
memory, filled by the copy unit's asynchronous bulk copies: in the one-warp
form resident in the block where the launch's matrices fit beside its
chains' stacks, else streamed through each chain's ring of row panels; in
the wide form under a dense metric, where a launch waits on its deepest
chain (:func:`cluster_of`), split by columns across a thread-block cluster
of 4 or 8 blocks a chain, each block streaming its own column panel of the
matrix (packed once per matrix by :func:`cluster_panels`) through its own
ring.  :func:`stage_plan` is the launcher's choice by shape,
:func:`plan_on_card` asks the launcher.
The arithmetic and its order are those of the kernel before staging, so
the outputs are too, bit for bit, on every path.

``ckpt_bf16`` stores the two checkpoint stacks in bfloat16, as JAX's
kernel can (``_make_kernel``'s ``ckpt_bf16``): each store rounds the
momentum sum and ``p#`` to bfloat16 (round to nearest even) and the turn
checks widen them back, so both directions of a U-turn check use the
rounded values; everything else stays float32.  On the card it halves the
stacks' shared memory (:func:`takes`).

Not ported yet: D above 256 for eight schools, the funnel and logistic
regression (ROADMAP queue 2 item 1 (g)), and D above 2,048 or past the
shared-memory bound (item 1 (h)).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from ..core.metric import (DenseMetric, DiagMetric, dense_metric, diag_metric,
                           matvec, sample_momentum)
from ..core.state import EvalPoint, Termination, TreeStats
from ..utils import philox
from ..utils.bits import checkpoint_slot, direction_bit, trailing_ones
from . import tile_physics
from .common import chain_tiles, check_tensor
from .cuda_build import CudaKernel
from .logistic import CHUNK_DIMS, logistic_planes, plane_shape

_P = ctypes.c_void_p
_TREE_ARGS = ([_P] * 14 + [ctypes.c_int64] + [ctypes.c_float] * 2
              + [_P] * 11
              + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 _P])
#: the whole-tree kernel of each physics with a diagonal metric,
#: ``csrc/tree_<physics>.cu``; its ``launches`` counts its launches
TREE_KERNELS = {
    name: CudaKernel(f"tree_{name}.cu", f"tree_{name}_launch", _TREE_ARGS)
    for name in tile_physics.PHYSICS}
#: the same with a dense ``[D, D]`` metric: the second launcher of each
#: source
TREE_DENSE_KERNELS = {
    name: CudaKernel(f"tree_{name}.cu", f"tree_{name}_dense_launch",
                     _TREE_ARGS)
    for name in tile_physics.PHYSICS}
TREE_GAUSSIAN = TREE_KERNELS["gaussian"]
#: launches with bfloat16 checkpoint stacks, by launcher symbol: a subset of
#: that launcher's ``launches`` (the stack type is an argument of the one
#: kernel), counted where it launches
CKPT_BF16_LAUNCHES: dict = {}
#: launches whose ``[D, D]`` products ran on a cluster of blocks (the wide
#: form's cluster paths, :func:`cluster_of`), by launcher symbol: a subset
#: of that launcher's ``launches``, counted where it launches
CLUSTER_LAUNCHES: dict = {}
#: each source's plan query (``tree_<physics>_plan``: the staged products'
#: plan of a launch and the blocks an SM holds; it launches nothing), read
#: by :func:`plan_on_card` and :func:`blocks_per_sm`
TREE_PLAN = {
    name: CudaKernel(f"tree_{name}.cu", f"tree_{name}_plan",
                     [ctypes.c_int] * 7 + [ctypes.c_void_p])
    for name in tile_physics.PHYSICS}
#: the Gaussian source's second launcher: it writes what the kernel's generator
#: draws (the check of the generator against ``utils/philox.py``)
PHILOX_DRAWS = CudaKernel(
    "tree_gaussian.cu", "philox_draws_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p])

#: largest dimension of the one-warp form (32 lanes x 8 registers)
WARP_DIM = 256
#: largest dimension of the wide form (one chain per block of up to 8 warps)
MAX_DIM = 2048
#: the physics whose kernels take D above ``WARP_DIM`` (the wide form)
WIDE_PHYSICS = ("gaussian", "dense_gaussian", "stoch_vol")
#: dynamic shared memory of one block (``csrc/tree_kernel.cuh``)
SMEM_LIMIT = 232448
#: floats of the wide form's row-sum scratch (``WIDE_SCRATCH``)
_WIDE_SCRATCH = 64
#: bytes the checkpoint stacks' region is rounded up to
#: (``tree_kernel.cuh::STACK_ALIGN``)
_STACK_ALIGN = 16
#: the chain tile of JAX's ``make_logistic_tree_transition`` (its default)
LOGISTIC_BLOCK_C = 128
#: the staged ``[D, D]`` products (``tree_kernel.cuh``'s ``plan_of``): the
#: paths, by their number in the launch (``"clusterK"``: the wide form's
#: products split across a cluster of K blocks a chain); an SM's shared
#: memory and what of it each block reserves; a ring's most stages; the
#: most chains a block of the staged one-warp form holds (D <= 128; 8
#: above)
PATHS = ("register", "resident", "ring", "cluster4", "cluster8")
SM_SMEM = 233472
BLOCK_RESERVED = 1024
MAX_STAGES = 8
MAX_STAGED_WARPS = 16
#: the plan's own ring: the one-warp form above this D
#: (``tree_kernel.cuh::RING_MIN_DIM``, set by the card's measurements)
RING_MIN_DIM = 128
#: the wide form's cluster paths under a dense metric, which the launcher
#: alone plans (``tree_kernel.cuh``'s ``cluster_fit``; :func:`stage_plan`
#: mirrors the rest)
CLUSTER_PATHS = PATHS[3:]
#: :func:`cluster_of`: a cluster has 8 blocks from this D, 4 below it; it is
#: asked for where a launch's chains in flight are fewer than
#: ``TAIL_CHAINS`` (times ``(TAIL_DIM / D)^2`` above ``TAIL_DIM``)
CLUSTER8_DIM = 768
TAIL_CHAINS = 64
TAIL_DIM = 1024
#: chains a block of the one-warp form holds on the register path
_MAX_WARPS = 4
#: the physics whose dense launcher keeps its products on the register
#: path (``kStaging = false`` in their source: the card measured them
#: slower staged, eight schools' 3 % at D = 10, where the leaf's special
#: functions set the time, and logistic regression's 0.5 %, whose leaf
#: streamed the observations through the L1 the staged matrix takes; the
#: tile form's dense products stay on it, the register path being the
#: only one its plan admits)
UNSTAGED_PHYSICS = frozenset({"eight_schools", "logistic"})
#: the physics whose kernel takes the tile form (``tree_kernel.cuh``'s
#: ``Tile``: a block of chains, a warp each, walking their trees in
#: lockstep, the physics a call of the whole block) and its plan
#: (``tile_plan_of``): at most ``TILE_CHAINS`` chains a tile (8 above
#: D = 128, where a thread holds 255 registers), ``MAX_BATCH_TILES``
#: observation tiles a batch of its ring
TILED_PHYSICS = frozenset({"logistic"})
TILE_CHAINS = 16
MAX_BATCH_TILES = 4


class TreeOut(NamedTuple):
    """What the transitions return for every chain: the proposal's ``q``,
    ``logp`` and ``grad``, ``energy = pi0 + delta`` of the proposal,
    ``log_sum_alpha = log sum exp(min(delta, 0))`` over the visited leaves
    (the acceptance statistic is derived from it, :func:`acceptance`), and
    the int32 records ``term``, ``term_left``, ``term_right``, ``depth`` and
    ``steps``: the TPU kernel's outputs.  From a sweep every field but
    ``grad`` (that of the final proposal) has a leading axis of the ``K``
    transitions, and ``q[K - 1]`` is the sweep's carry."""

    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    energy: torch.Tensor
    log_sum_alpha: torch.Tensor
    term: torch.Tensor
    term_left: torch.Tensor
    term_right: torch.Tensor
    depth: torch.Tensor
    steps: torch.Tensor


def acceptance(log_sum_alpha: torch.Tensor,
               steps: torch.Tensor) -> torch.Tensor:
    """The acceptance statistic ``min(exp(log_sum_alpha) / max(steps, 1),
    1)``, as the JAX package derives it from the kernel's outputs."""
    return torch.clamp(torch.exp(log_sum_alpha)
                       / torch.clamp(steps, min=1).to(log_sum_alpha.dtype),
                       max=1.0)


def n_uniforms(max_depth: int) -> int:
    """Uniform slots of one transition: one per leaf position, one per
    merge."""
    return (1 << max_depth) - 1 + max_depth


def stack_bytes(dim: int, max_depth: int, ckpt_bf16: bool = False) -> int:
    """Bytes of one chain's two checkpoint stacks ``[md, D]`` (float32, or
    bfloat16 under ``ckpt_bf16``), rounded up to ``_STACK_ALIGN``
    (``tree_kernel.cuh::stack_bytes``)."""
    raw = 2 * max_depth * dim * (2 if ckpt_bf16 else 4)
    return -(-raw // _STACK_ALIGN) * _STACK_ALIGN


def wide_smem_bytes(dim: int, max_depth: int,
                    ckpt_bf16: bool = False) -> int:
    """Dynamic shared memory of the wide form's block (one chain of
    ``ceil(D / 256)`` warps): the two checkpoint stacks
    (:func:`stack_bytes`), then the row sums' scratch and the mat-vec's two
    staging rows ``[D]``, float32 (``tree_kernel.cuh::wide_bytes``)."""
    return stack_bytes(dim, max_depth, ckpt_bf16) \
        + 4 * (_WIDE_SCRATCH + 2 * dim)


def takes(dim: int, max_depth: int, physics: str,
          ckpt_bf16: bool = False) -> bool:
    """Whether the kernel of ``physics`` takes a ``dim``-dimensional problem
    at ``max_depth``, as its launcher decides: any physics up to
    ``WARP_DIM`` (one warp per chain); a physics of ``WIDE_PHYSICS`` up to
    ``MAX_DIM`` where the wide form's block fits the shared memory,
    ``wide_smem_bytes(dim, max_depth, ckpt_bf16) <= SMEM_LIMIT`` (at D =
    2048, ``max_depth <= 13`` with float32 stacks, ``<= 26`` with bfloat16
    ones).  The random numbers are drawn inside the kernel, so the chain
    count sets no bound."""
    if dim <= WARP_DIM:
        return dim >= 1
    return (physics in WIDE_PHYSICS and dim <= MAX_DIM
            and wide_smem_bytes(dim, max_depth, ckpt_bf16) <= SMEM_LIMIT)


def refusal(dim: int, max_depth: int, physics: str,
            ckpt_bf16: bool = False) -> str:
    """Why :func:`takes` refuses the problem, naming the bound and the
    ROADMAP item that lifts it."""
    if physics not in WIDE_PHYSICS:
        return (f"the {physics} kernel takes D <= {WARP_DIM}, this problem "
                f"has D = {dim} (its wide form is not ported yet: ROADMAP "
                f"queue 2 item 1 (g))")
    if dim > MAX_DIM:
        return (f"the {physics} kernel takes D <= {MAX_DIM}, this problem "
                f"has D = {dim} (ROADMAP queue 2 item 1 (h))")
    elem = 2 if ckpt_bf16 else 4
    return (f"the {physics} kernel's wide form needs "
            f"{wide_smem_bytes(dim, max_depth, ckpt_bf16)} bytes of shared "
            f"memory at D = {dim}, max_depth {max_depth} ("
            f"{'bfloat16' if ckpt_bf16 else 'float32'} stacks): {elem} 2 "
            f"max_depth D (rounded up to {_STACK_ALIGN}) + 4 (2 D + "
            f"{_WIDE_SCRATCH}) > {SMEM_LIMIT}, the shared-memory bound "
            f"(ROADMAP queue 2 item 1 (h))")


class StagePlan(NamedTuple):
    """How a launch takes its ``[D, D]`` products (``tree_kernel.cuh``'s
    ``plan_of``): ``path`` (one of :data:`PATHS`), the chains a block of
    the one-warp form holds (``warps``; 1 in the wide form), the ring's
    ``stages`` and ``rows`` a panel (0 off the ring), and the block's
    dynamic shared memory ``smem_bytes``.  In the tile form
    (:data:`TILED_PHYSICS`, :func:`tile_plan`) ``warps`` is the tile's
    chains, ``stages`` its ring of observation tiles' stages and ``rows``
    the observation tiles a batch."""

    path: str
    warps: int
    stages: int
    rows: int
    smem_bytes: int

    @property
    def cluster(self) -> int:
        """Blocks a chain: K on a ``"clusterK"`` path, else 1."""
        return cluster_size(self.path)

    def in_flight(self, dim: int) -> int:
        """Bytes of the matrix a team has on their way while it reads a
        panel: ``stages - 1`` panels on the ring (on a cluster path, each
        block's, of its panel's :func:`panel_cols` columns), 0 off it."""
        if self.path == "ring":
            return 4 * max(self.stages - 1, 0) * self.rows * dim
        if self.cluster > 1:
            return 4 * max(self.stages - 1, 0) * self.rows \
                * panel_cols(dim, self.cluster)
        return 0


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def _narrow_warps(per_warp: int) -> int:
    """Chains a block of the one-warp form holds on the register path:
    ``_MAX_WARPS``, fewer where their stacks would pass ``SMEM_LIMIT``
    (``tree_kernel.cuh::narrow_warps``)."""
    w = _MAX_WARPS
    while w > 1 and w * per_warp > SMEM_LIMIT:
        w -= 1
    return w


def _align_rows(dim: int) -> int:
    """Rows of a panel whose bytes are a multiple of 16."""
    return 1 if dim % 4 == 0 else 2 if dim % 2 == 0 else 4


def _ring_fit(dim: int, room: int):
    """``(stages, rows)`` of a ring in ``room`` bytes: the most rows a
    panel (a multiple of :func:`_align_rows`, at most ``dim``) with two
    stages, and as many stages of it as fit (at most ``MAX_STAGES``; 0
    where two stages of the fewest rows do not fit):
    ``tree_kernel.cuh::ring_fit``."""
    unit = _align_rows(dim)
    r = max(room, 0) // (8 * dim) // unit * unit
    r = min(r, -(-dim // unit) * unit)
    if r < unit:
        return 0, unit
    s = room // (4 * r * dim)
    return (min(s, MAX_STAGES) if s >= 2 else 0), r


def cluster_size(path: str) -> int:
    """Blocks a chain on ``path``: K for ``"clusterK"``, else 1."""
    return int(path[len("cluster"):]) if path.startswith("cluster") else 1


def panel_cols(dim: int, k: int) -> int:
    """Columns of each of a cluster's K column panels: ``ceil(D / K)``
    rounded up to a multiple of 4, so that a panel's rows are whole
    16-byte units for the bulk copies (``tree_kernel.cuh::panel_cols``)."""
    cols = -(-dim // k)
    return -(-cols // 4) * 4


def cluster_panels(m: torch.Tensor, k: int) -> torch.Tensor:
    """``m [D, D]`` as a cluster's K column panels ``[K, D, wk]``
    (``wk = panel_cols(D, K)``; panel ``r`` holds columns ``[r wk, r wk +
    wk)`` row by row, zero past column D): what block ``r`` of a chain's
    cluster streams.  Packed once per matrix: the result is kept while
    ``m`` lives and is not modified in place (its version counter), so a
    sampling loop that hands the same metric to every launch packs it
    once."""
    key = id(m)
    hit = _PANELS.get(key)
    if hit is not None and hit[0]() is m and hit[1] == (m._version, k):
        return hit[2]
    d = m.shape[0]
    wk = panel_cols(d, k)
    packed = torch.nn.functional.pad(m, (0, k * wk - d)) \
        .reshape(d, k, wk).transpose(0, 1).contiguous()
    _PANELS[key] = (weakref.ref(m, lambda _, key=key: _PANELS.pop(key, None)),
                    (m._version, k), packed)
    return packed


#: the packed panels of the matrices a launch was handed, by ``id``
#: (:func:`cluster_panels`)
_PANELS: dict = {}


def cluster_of(dim: int, spread: float = 1.0) -> int:
    """The blocks a chain of the wide form's launch under a dense metric
    (1: the register path, one block a chain) whose chains in flight are
    ``spread`` (:func:`chains_in_flight`): a cluster of 4 below
    ``CLUSTER8_DIM``, 8 from it, where ``spread`` is below ``TAIL_CHAINS``
    (times ``(TAIL_DIM / D)^2`` above ``TAIL_DIM``), else 1.  A cluster
    runs one chain's products several times faster but holds K SMs a
    chain, so it wins where the launch waits on its deepest chain's serial
    products and loses where many chains keep the card busy.  The card's
    measurements set these bounds (``tools/time_k5_pairs.py --paths``,
    ``chip_smoke.py``, ``PERF.md`` section 6): the cluster ran faster at 96
    chains in flight at D = 257, 66 at 1,002 (38 at config 5's tuned
    state) and 1 at every D, slower at 120 at D = 512, 98 at 1,002 and 36
    at 2,048.  A cluster of 8 ran a lone chain fastest at every D, and
    config 5's tuned state as fast as a cluster of 4."""
    if dim <= WARP_DIM:
        return 1
    bound = TAIL_CHAINS * min(1.0, (TAIL_DIM / dim) ** 2)
    if spread >= bound:
        return 1
    return 4 if dim < CLUSTER8_DIM else 8


def chains_in_flight(steps: torch.Tensor) -> float:
    """A launch's chains in flight from its ``steps [K, C]`` (or ``[C]``):
    the leaves of all its chains over those of its deepest chain (each
    chain's leaves summed over a sweep's K transitions).  The launch lasts
    at least its deepest chain's leaves one after another; it is that long
    where the card runs at least this many chains at once."""
    per_chain = steps.reshape(-1, steps.shape[-1]).sum(0)
    top = int(per_chain.max()) if per_chain.numel() else 0
    return float(per_chain.sum()) / top if top else float(steps.shape[-1])


class _Tail:
    """The chains in flight of each wide dense launch's last record that
    has reached the host, by launcher symbol, C, D and max depth: a launch
    copies its ``steps`` to the host behind it (when no copy of the same
    key is on its way) and the next launch of the key reads the copy if it
    has landed.  It never waits for one, so the choice trails the chains
    by a launch or more; before any record, the launch's C."""

    def __init__(self):
        self.seen = {}

    def spread(self, key, c: int) -> float:
        rec = self.seen.get(key)
        if rec is None:
            return float(c)
        if rec[1] is not None and rec[1][0].query():
            rec[0] = chains_in_flight(rec[1][1])
            rec[1] = None
        return rec[0]

    def record(self, key, c: int, steps: torch.Tensor) -> None:
        rec = self.seen.setdefault(key, [float(c), None])
        if rec[1] is None:
            host = torch.empty(steps.shape, dtype=steps.dtype,
                               pin_memory=True)
            host.copy_(steps, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            rec[1] = (done, host)


_TAIL = _Tail()


@functools.lru_cache(maxsize=None)
def _cluster_admitted(physics: str, dim: int, max_depth: int, refresh: bool,
                      ckpt_bf16: bool, path: str) -> bool:
    """Whether the launcher admits the cluster ``path`` for the wide form's
    dense launch of this shape (its ``cluster_fit``: each block's ring
    beside the stacks).  Needs the card."""
    try:
        _plan_query(physics, dim, max_depth, True, refresh, ckpt_bf16, path,
                    False)
    except RuntimeError:
        return False
    return True


def n_staged(physics: str, dense: bool, refresh: bool = False) -> int:
    """The ``[D, D]`` matrices a launch stages: ``M^-1`` under a dense
    metric, ``mass_chol^T`` when it refreshes there too, and the physics'
    own (the dense Gaussian's ``P``); none for the physics of
    ``UNSTAGED_PHYSICS``."""
    if physics in UNSTAGED_PHYSICS:
        return 0
    own = tile_physics.PHYSICS[physics].matrix is not None
    return (1 + bool(refresh)) * bool(dense) + own


def _conflict_free(words: int) -> int:
    """The smallest multiple of 8 words at least ``words`` that is 8 or 24
    mod 32: a row stride free of bank conflicts for the tile physics'
    fragments (``tree_logistic.cu::conflict_free``)."""
    r = -(-words // 8) * 8
    while r % 32 not in (8, 24):
        r += 8
    return r


class TileLayout(NamedTuple):
    """The tile physics' shared memory after the chains' stacks
    (``tree_logistic.cu::tile_layout``): chunks of 64 dimensions ``nc``,
    n-tiles of 8 ``ndn``, the ring's ``stages`` of ``tw`` words, the row
    strides in words of Q, R and GP (``qs``, ``rs``, ``gs``), the gradient's
    ``groups`` and the byte offsets of the ring's barriers, the ring, Q, R
    and GP, and the region's ``bytes``."""

    nc: int
    ndn: int
    stages: int
    tw: int
    qs: int
    rs: int
    gs: int
    groups: int
    bar: int
    ring: int
    q: int
    r: int
    gp: int
    bytes: int


def tile_layout(dim: int, chains: int, batch: int, sets: int,
                grad_bf16: bool = False) -> TileLayout:
    """:class:`TileLayout` of a tile of ``chains`` chains whose ring holds
    ``sets`` sets of ``batch`` observation tiles, each tile the plane's
    (``ops.logistic.plane_shape``: form ``"grad_bf16"`` or ``"f32"``)."""
    nc, ndn = -(-dim // CHUNK_DIMS), -(-dim // 8)
    stages = sets * batch * nc
    tw = plane_shape(1, 1, "grad_bf16" if grad_bf16 else "f32")[2]
    qs, rs, gs = _conflict_free(16 * ndn), 32 * batch + 8, \
        _conflict_free(8 * ndn)
    groups = 1 if ndn >= chains else min(chains // ndn, 2 * batch)
    ring = _round16(8 * stages)
    q = ring + 4 * stages * tw
    r = _round16(q + 4 * chains * qs)
    gp = _round16(r + 4 * chains * rs)
    return TileLayout(nc, ndn, stages, tw, qs, rs, gs, groups, 0, ring, q, r,
                      gp, _round16(gp + 4 * groups * chains * gs))


def tile_plan(dim: int, max_depth: int, ckpt_bf16: bool = False,
              grad_bf16: bool = False) -> StagePlan:
    """The tile form's plan (``tree_kernel.cuh::tile_plan_of``): the most
    chains a tile (at most ``TILE_CHAINS``, 8 above D = 128), then two sets
    of the ring before one, then the most observation tiles a batch (at
    most ``MAX_BATCH_TILES``) whose block fits ``SMEM_LIMIT``: the chains'
    stacks and :func:`tile_layout`'s region.  ``StagePlan("register",
    chains, stages, batch, bytes)``; ``ValueError`` where nothing fits."""
    stack = stack_bytes(dim, max_depth, ckpt_bf16)
    most = TILE_CHAINS if dim <= 128 else TILE_CHAINS // 2
    for tc in range(most, 0, -1):
        for sets in (2, 1):
            for bt in range(MAX_BATCH_TILES, 0, -1):
                lay = tile_layout(dim, tc, bt, sets, grad_bf16)
                if tc * stack + lay.bytes <= SMEM_LIMIT:
                    return StagePlan("register", tc, lay.stages, bt,
                                     tc * stack + lay.bytes)
    raise ValueError(f"no tile plan fits D = {dim}, max_depth {max_depth}")


def stage_plan(dim: int, max_depth: int, physics: str, dense: bool,
               refresh: bool = False, ckpt_bf16: bool = False,
               path: str = None, grad_bf16: bool = False) -> StagePlan:
    """The plan of the launch :func:`tree_sweep` makes, as the launcher
    decides it by shape before the launch (``tree_kernel.cuh::plan_of``,
    which :func:`plan_on_card` reads back).  The register path is the
    launch of the kernel before staging (:func:`_narrow_warps` chains a
    block, or the wide form's one).  In the one-warp form, with a matrix
    to stage (:func:`n_staged`): the resident path puts every staged
    matrix in the block beside its chains' stacks and vector rows, with the
    fewest chains a block that put the most on an SM (16 warps an SM by registers at
    D <= 128, 8 above); the ring keeps the register path's blocks an SM and
    fills the room they leave (:func:`_ring_fit`).  The plan's own path is
    resident where that fits (above ``RING_MIN_DIM`` only where it holds as
    many chains an SM as the ring), else the ring above ``RING_MIN_DIM``,
    else the register path (the card's measurements,
    ``tree_kernel.cuh::plan_of``: the ring lost to the register path at
    D <= 128 and over the wide form's block, the resident path won wherever
    it fitted, from D = 10 to 128, but for ``UNSTAGED_PHYSICS``).  The wide
    form's plan is the register path; its clusters (:data:`CLUSTER_PATHS`)
    are the launcher's to plan (:func:`plan_on_card`), and asking this
    mirror for one raises ``ValueError``.  ``path`` (one of
    :data:`PATHS`) asks for a path: ``ValueError`` where the shape does
    not admit it.  A launch without a matrix to stage and the wide form
    admit the register path only.  A physics of :data:`TILED_PHYSICS`
    takes :func:`tile_plan` (for its ``grad_bf16``), on the register path
    only."""
    if physics in TILED_PHYSICS:
        if path not in (None, "register"):
            if path not in PATHS:
                raise ValueError(f"path must be one of {PATHS}, got "
                                 f"{path!r}")
            raise ValueError(
                f"the {physics} kernel's tile form admits the register path "
                f"only, not the {path} path")
        return tile_plan(dim, max_depth, ckpt_bf16, grad_bf16)
    n = n_staged(physics, dense, refresh)
    stack = stack_bytes(dim, max_depth, ckpt_bf16)
    vrow = _round16(4 * dim)
    if dim > WARP_DIM:
        reg = StagePlan("register", 1, 0, 0,
                        wide_smem_bytes(dim, max_depth, ckpt_bf16))
    else:
        w = _narrow_warps(stack)
        reg = StagePlan("register", w, 0, 0, w * stack)
    res = ring = None
    res_chains = reg_chains = 0
    if dim <= WARP_DIM and n:
        reg_warps = 8 if dim > 128 else MAX_STAGED_WARPS

        def by_smem(b):
            return SM_SMEM // (b + BLOCK_RESERVED)

        for w in range(1, reg_warps + 1):
            b = w * (stack + vrow) + n * _round16(4 * dim * dim) + 16
            if b > SMEM_LIMIT:
                break
            ch = w * min(reg_warps // w, by_smem(b))
            if ch > res_chains:
                res_chains, res = ch, StagePlan("resident", w, 0, 0, b)
        bps = min(reg_warps // reg.warps, by_smem(reg.smem_bytes))
        reg_chains = reg.warps * bps
        if bps >= 1:
            budget = min(SMEM_LIMIT, SM_SMEM // bps - BLOCK_RESERVED)
            s, r = _ring_fit(dim, budget // reg.warps - stack - vrow - 16
                             - 8 * MAX_STAGES)
            b = reg.warps * (stack + vrow + 4 * s * r * dim
                             + _round16(8 * s))
            if s >= 2 and b <= SMEM_LIMIT:
                ring = StagePlan("ring", reg.warps, s, r, b)
    if path is None:
        ring_own = ring is not None and dim > RING_MIN_DIM
        if res is not None and (not ring_own or res_chains >= reg_chains):
            return res
        return ring if ring_own else reg
    if path in CLUSTER_PATHS:
        raise ValueError(f"the {physics} kernel's {path} path is the "
                         f"launcher's to plan (plan_on_card); this mirror "
                         f"does not admit it")
    plans = {"register": reg, "resident": res, "ring": ring}
    if path not in plans:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if plans[path] is None:
        raise ValueError(
            f"the {physics} kernel does not admit the {path} path at D = "
            f"{dim}, max_depth {max_depth} ({'dense' if dense else 'diagonal'}"
            f" metric, refresh {bool(refresh)}, "
            f"{'bfloat16' if ckpt_bf16 else 'float32'} stacks)")
    return plans[path]


def _check_path(dim: int, max_depth: int, physics: str, dense: bool,
                refresh: bool, ckpt_bf16: bool, path: str,
                grad_bf16: bool = False) -> None:
    """``ValueError`` where ``path`` is not one of :data:`PATHS` or the
    shape does not admit it: :func:`stage_plan`'s paths by its mirror, a
    cluster (:data:`CLUSTER_PATHS`) in the wide form under a dense metric
    only (the launcher refuses one whose ring does not fit)."""
    if path not in CLUSTER_PATHS:
        stage_plan(dim, max_depth, physics, dense, refresh, ckpt_bf16, path,
                   grad_bf16)
    elif dim <= WARP_DIM or not n_staged(physics, dense, refresh) \
            or not dense:
        raise ValueError(f"the {physics} kernel does not admit the {path} "
                         f"path at D = {dim} under a "
                         f"{'dense' if dense else 'diagonal'} metric")


def plan_on_card(physics: str, dim: int, max_depth: int, dense: bool,
                 refresh: bool = False, ckpt_bf16: bool = False,
                 path: str = None, grad_bf16: bool = False):
    """The launcher's own plan (``tree_<physics>_plan``) for the launch
    :func:`tree_sweep` would make (for a tile physics' ``grad_bf16``, its
    option), and the blocks of it one SM holds at once by the CUDA
    occupancy calculator (registers, shared memory, threads):
    ``(StagePlan, blocks)``.  Raises where the launcher refuses ``path``.
    Needs the card."""
    out = _plan_query(physics, dim, max_depth, dense, refresh, ckpt_bf16,
                      path, grad_bf16)
    return StagePlan(PATHS[out[0]], *out[1:5]), out[5]


def active_clusters(physics: str, dim: int, max_depth: int, dense: bool,
                    refresh: bool = False, ckpt_bf16: bool = False,
                    path: str = None) -> int:
    """The clusters of the launch :func:`plan_on_card` plans that the card
    holds at once (``cudaOccupancyMaxActiveClusters``; 0 off a cluster
    path).  Needs the card."""
    return _plan_query(physics, dim, max_depth, dense, refresh, ckpt_bf16,
                       path, False)[6]


def _plan_query(physics, dim, max_depth, dense, refresh, ckpt_bf16, path,
                grad_bf16) -> list:
    """``tree_<physics>_plan``'s seven numbers: the plan's path, warps,
    stages, rows and bytes, the blocks an SM, the clusters the card
    holds."""
    out = (ctypes.c_int * 7)()
    TREE_PLAN[physics].call(
        dim, max_depth, int(ckpt_bf16), int(dense), int(refresh),
        -1 if path is None else PATHS.index(path), int(grad_bf16), out)
    return list(out)


def blocks_per_sm(physics: str, dim: int, max_depth: int,
                  dense: bool = False, ckpt_bf16: bool = False,
                  refresh: bool = False, path: str = None,
                  grad_bf16: bool = False) -> int:
    """Blocks of the launch :func:`tree_sweep` would make for ``physics`` at
    ``dim`` and ``max_depth`` that one SM holds at once, by the CUDA
    occupancy calculator (:func:`plan_on_card`): a block is
    ``stage_plan(...).warps`` chains of the one-warp form (of a tile), or
    one chain of the wide form.  Needs the card."""
    return plan_on_card(physics, dim, max_depth, dense, refresh, ckpt_bf16,
                        path, grad_bf16)[1]


def tile_plane(phys: tile_physics.Bound):
    """``(plane, n)``: the tile kernel's plane of a logistic physics' data,
    ``ops.logistic.logistic_planes`` of its ``x``, ``y`` and ``w`` up to
    the last observation of nonzero weight (``n`` of them: the padding
    after it adds exactly nothing) in the form of its ``grad_bf16``
    (``"grad_bf16"`` or ``"f32"``): the one :func:`bind` attached, else
    made here."""
    if "plane" in phys.data:
        return phys.data["plane"], phys.data["plane_n"]
    x, y, w = phys.data["x"], phys.data["y"], phys.data["w"]
    nz = torch.nonzero(w).flatten()
    n = int(nz[-1]) + 1 if len(nz) else 0
    form = "grad_bf16" if phys.data["grad_bf16"] else "f32"
    return logistic_planes(x[:n], y[:n], w[:n], form), n


def bind(physics: str, data: dict, device=None,
         dtype=None) -> tile_physics.Bound:
    """``tile_physics.bind``, and for a physics of :data:`TILED_PHYSICS`
    bound on a CUDA device its kernel's plane (:func:`tile_plane`), made
    once, here."""
    b = tile_physics.bind(physics, data, device, dtype)
    if physics in TILED_PHYSICS and b.data["x"].device.type == "cuda":
        b.data["plane"], b.data["plane_n"] = tile_plane(b)
    return b


def _check_max_depth(max_depth: int) -> None:
    if not 1 <= max_depth <= 30:
        # 32-bit direction words: beyond 30 the 2^d subtree length overflows
        raise ValueError(f"max_depth must be in [1, 30], got {max_depth}")


def _gaussian(lam) -> tile_physics.Bound:
    return tile_physics.Bound("gaussian", {"lam": lam})


def psharp(minv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p# = M^-1 p`` for the kernel's raw ``minv``, a diagonal ``[D]`` or a
    dense ``[D, D]``: ``core/metric.py::psharp`` without the ``Metric``."""
    return minv * p if minv.ndim == 1 else matvec(minv, p)


def refresh_momentum(scale: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """The momentum from standard normals ``xi`` and the kernel's momentum
    scale: ``scale * xi`` for the ``[D]`` sqrt-mass row, ``mass_chol xi``
    for the dense metric's ``scale = mass_chol^T`` (``[D, D]``, the rows
    the kernel reads): ``core/metric.py::sample_momentum`` without the
    ``Metric``."""
    return scale * xi if scale.ndim == 1 else matvec(scale.T, xi)


def stack_store(t: torch.Tensor, ckpt_bf16: bool) -> torch.Tensor:
    """What a checkpoint stack holds of ``t`` when read back: ``t`` itself,
    or under ``ckpt_bf16`` ``t`` rounded to bfloat16 (to nearest, ties to
    even, as the kernel's ``__float2bfloat16_rn``) and widened back."""
    return t.to(torch.bfloat16).to(t.dtype) if ckpt_bf16 else t


def tree_transition_plain(q0, p0, eps, dirs, unif, phys, minv,
                          max_depth: int, min_delta: float,
                          valid=None, ckpt_bf16: bool = False) -> TreeOut:
    """Plain torch version of one transition of the kernel, in ``q0``'s
    dtype and on its device: every chain in lockstep, each update masked by
    the chain's own state.  ``q0, p0 [C, D]``; ``eps [C]``; ``dirs [C]``
    32-bit direction words (any integer dtype); ``unif`` the
    ``[2^md - 1 + md, C]`` proposal uniforms, or a function of a list of
    slots returning their rows ``[len(slots), C]`` (the generator's draws,
    made only for the depths a tree reaches); ``phys`` the physics,
    ``phys(q) -> (logp, grad)`` (a :class:`~.tile_physics.Bound`), called
    at the start, at every leaf and on the proposal; ``minv`` the diagonal
    ``[D]`` or the dense ``[D, D]`` ``M^-1`` (:func:`psharp`; the kinetic
    energy is ``0.5 sum(p * p#)``); ``valid [C]`` (default all): rows with 0
    start inactive and keep the records of an empty tree; ``ckpt_bf16``
    rounds every checkpoint store to bfloat16 (round to nearest even) and
    the turn checks read the rounded values."""
    _check_max_depth(max_depth)
    rows = unif if callable(unif) else (lambda slots: unif[slots])
    c, dim = q0.shape
    dt, dev = q0.dtype, q0.device
    md = max_depth
    i32 = dict(dtype=torch.int32, device=dev)
    col = dict(dtype=dt, device=dev)
    eps = torch.as_tensor(eps, **col).expand(c)

    def rowsum(t):
        return torch.sum(t, dim=1)

    def where(m, a, b):
        return torch.where(m[:, None] if a.ndim == 2 else m, a, b)

    logp0, g0 = phys(q0)
    ps_l = ps_r = psharp(minv, p0)
    pi0 = logp0 - 0.5 * rowsum(p0 * ps_l)
    left = right = (q0, p0, g0)
    rho = p0
    prop_q, prop_delta, prop_logp = q0, torch.zeros((c,), **col), logp0
    sub_q, sub_delta, sub_logp = q0, torch.zeros((c,), **col), logp0
    omega = torch.zeros((c,), **col)
    sum_alpha = torch.zeros((c,), **col)
    i_left = torch.zeros((c,), **i32)
    i_right = torch.zeros((c,), **i32)
    steps = torch.zeros((c,), **i32)
    depth = torch.zeros((c,), **i32)
    term = torch.full((c,), Termination.MAX_DEPTH, **i32)
    tl = torch.ones((c,), **i32)    # REACHED_MAX_DEPTH sentinel (1, 0)
    tr = torch.zeros((c,), **i32)
    die_l = torch.zeros((c,), **i32)
    die_r = torch.zeros((c,), **i32)
    active = torch.ones((c,), dtype=torch.bool, device=dev) if valid is None \
        else torch.as_tensor(valid, device=dev) != 0
    ckpt_s = torch.zeros((c, md, dim), **col)
    ckpt_ps = torch.zeros((c, md, dim), **col)

    for d in range(md):
        if not bool(active.any()):
            break
        # this depth's leaf uniforms, then its merge uniform
        u_d = rows(list(range((1 << d) - 1, (1 << (d + 1)) - 1))
                   + [(1 << md) - 1 + d])
        isf = direction_bit(dirs, d)
        signi = torch.where(isf, 1, -1).to(torch.int32)
        eps_signed = torch.where(isf, 1.0, -1.0).to(dt) * eps
        half = (0.5 * eps_signed)[:, None]
        i_base = torch.where(isf, i_right, i_left)
        cur_q, cur_p, cur_g = (where(isf, r, l) for r, l in zip(right, left))
        cur_ps = where(isf, ps_r, ps_l)
        s_cum = torch.zeros((c, dim), **col)
        omega_sub = torch.full((c,), -torch.inf, **col)
        alive = active
        died_div = torch.zeros_like(active)
        died_turn = torch.zeros_like(active)

        for n in range(1 << d):
            if not bool(alive.any()):
                break
            mask = alive
            p_mid = cur_p + half * cur_g
            q_new = cur_q + eps_signed[:, None] * psharp(minv, p_mid)
            logp_new, g_new = phys(q_new)
            p_new = p_mid + half * g_new
            ps_new = psharp(minv, p_new)
            kin_new = 0.5 * rowsum(p_new * ps_new)
            joint = logp_new - torch.where(torch.isfinite(kin_new), kin_new,
                                           torch.inf)
            joint = torch.where(torch.isfinite(joint), joint, -torch.inf)
            delta = joint - pi0
            delta = torch.where(torch.isnan(delta), -torch.inf, delta)
            divergent = delta < min_delta
            q_new = torch.where(torch.isfinite(q_new), q_new, cur_q)
            p_new = torch.where(torch.isfinite(p_new), p_new, cur_p)
            g_new = torch.where(torch.isfinite(g_new), g_new, cur_g)
            ps_new = torch.where(torch.isfinite(ps_new), ps_new, 0.0)
            i_new = i_base + (n + 1) * signi

            sum_alpha = torch.where(
                mask, sum_alpha + torch.exp(torch.clamp(delta, max=0.0)),
                sum_alpha)
            steps = steps + mask.to(torch.int32)
            if n % 2 == 0:
                slot = checkpoint_slot(n)
                ckpt_s[:, slot] = stack_store(s_cum, ckpt_bf16)
                ckpt_ps[:, slot] = stack_store(ps_new, ckpt_bf16)
            s_cum = where(mask, s_cum + p_new, s_cum)

            turning = torch.zeros_like(active)
            turn_pos = torch.zeros((c,), **i32)
            idx_max = checkpoint_slot(n)
            for m in range(trailing_ones(n)):
                j = idx_max - m
                rho_node = s_cum - ckpt_s[:, j]
                t = (rowsum(rho_node * ckpt_ps[:, j]) < 0) \
                    | (rowsum(rho_node * ps_new) < 0)
                l_pos = i_base + (n - (2 << m) + 2) * signi
                turn_pos = torch.where(t & ~turning, l_pos, turn_pos)
                turning = turning | t
            turning = turning & ~divergent

            omega_new = torch.logaddexp(omega_sub, delta)
            u = u_d[n]
            upd = mask & ~divergent
            take = upd & (torch.log(u) < (delta - omega_new))
            sub_q = where(take, q_new, sub_q)
            sub_delta = torch.where(take, delta, sub_delta)
            sub_logp = torch.where(take, logp_new, sub_logp)
            omega_sub = torch.where(upd, omega_new, omega_sub)

            cur_q, cur_p, cur_g, cur_ps = (
                where(mask, a, b) for a, b in
                ((q_new, cur_q), (p_new, cur_p), (g_new, cur_g),
                 (ps_new, cur_ps)))
            dd = mask & divergent
            dtn = mask & turning
            die_l = torch.where(dd, i_new, torch.where(
                dtn, torch.minimum(turn_pos, i_new), die_l))
            die_r = torch.where(dd, i_new, torch.where(
                dtn, torch.maximum(turn_pos, i_new), die_r))
            died_div = died_div | dd
            died_turn = died_turn | dtn
            alive = mask & ~(dd | dtn)

        # merge the subtree into the trajectory
        ok = alive
        u2 = u_d[-1]
        take2 = ok & (torch.log(u2) < (omega_sub - omega))
        prop_q = where(take2, sub_q, prop_q)
        prop_delta = torch.where(take2, sub_delta, prop_delta)
        prop_logp = torch.where(take2, sub_logp, prop_logp)
        omega = torch.where(ok, torch.logaddexp(omega, omega_sub), omega)
        grow_r = ok & isf
        grow_l = ok & ~isf
        cur = (cur_q, cur_p, cur_g)
        right = tuple(where(grow_r, a, b) for a, b in zip(cur, right))
        left = tuple(where(grow_l, a, b) for a, b in zip(cur, left))
        # the new end's p#: a subtree that merges ended on a finite leaf,
        # whose ps_new is M^-1 cur_p
        ps_r = where(grow_r, cur_ps, ps_r)
        ps_l = where(grow_l, cur_ps, ps_l)
        i_end = i_base + (1 << d) * signi
        i_right = torch.where(grow_r, i_end, i_right)
        i_left = torch.where(grow_l, i_end, i_left)
        rho = where(ok, rho + s_cum, rho)
        depth = torch.where(ok, d + 1, depth).to(torch.int32)
        turn_top = (rowsum(rho * ps_l) < 0) | (rowsum(rho * ps_r) < 0)
        died_top = ok & turn_top
        term = torch.where(died_div, Termination.DIVERGENCE, term)
        term = torch.where(died_turn | died_top, Termination.TURNING,
                           term).to(torch.int32)
        inner = died_div | died_turn
        tl = torch.where(inner, die_l, torch.where(died_top, i_left, tl))
        tr = torch.where(inner, die_r, torch.where(died_top, i_right, tr))
        active = ok & ~turn_top

    return TreeOut(q=prop_q, logp=prop_logp, grad=phys(prop_q)[1],
                   energy=prop_delta + pi0,
                   log_sum_alpha=torch.log(sum_alpha), term=term,
                   term_left=tl, term_right=tr, depth=depth, steps=steps)


def gaussian_tree_transition_plain(q0, p0, eps, dirs, unif, lam, minv,
                                   *args, **kw) -> TreeOut:
    """:func:`tree_transition_plain` with the Gaussian physics of precision
    ``lam [D]``."""
    return tree_transition_plain(q0, p0, eps, dirs, unif, _gaussian(lam),
                                 minv, *args, **kw)


def _draws_at(s: int, rows, dim: int, dt, p_stack, dirs, unif, key,
              sqrt_mass):
    """Transition ``s``'s momentum, direction words and uniforms: from the
    explicit stacks where given, else from the generator (the momentum from
    ``sqrt_mass`` and the normals, :func:`refresh_momentum`)."""
    if p_stack is None:
        p0 = refresh_momentum(sqrt_mass,
                              philox.normals(key, rows, s, dim, dt))
        d_s = philox.direction_words(key, rows, s)
    else:
        p0, d_s = p_stack[s], dirs[s]
    if unif is not None:
        return p0, d_s, unif[s]
    return p0, d_s, (lambda slots: philox.uniforms(key, rows, s, slots, dt))


def tree_sweep_plain(q0, eps, phys, minv, max_depth: int, min_delta: float,
                     n_sweep: int = 1, *, momentum=None, dirs=None, unif=None,
                     key=None, sqrt_mass=None, valid=None,
                     ckpt_bf16: bool = False) -> TreeOut:
    """Plain torch version of one launch: ``n_sweep`` transitions from
    ``q0 [C, D]``, each starting from the last one's proposal.  Either
    ``momentum [K, C, D]`` and ``dirs [K, C]`` are given, or they are drawn
    from ``key`` (``refresh_inside``: the momentum is ``sqrt_mass * xi``, or
    ``xi @ sqrt_mass`` where ``sqrt_mass`` is a dense metric's ``[D, D]``
    ``mass_chol^T``);
    ``unif [K, 2^md - 1 + md, C]`` is given or drawn from ``key``.  Returns
    the fields of every transition with a leading ``K`` axis, and the final
    proposal's gradient."""
    c, dim = q0.shape
    rows = torch.arange(c, dtype=torch.int64, device=q0.device)
    q, outs = q0, []
    for s in range(n_sweep):
        p0, d_s, u_s = _draws_at(s, rows, dim, q0.dtype, momentum, dirs,
                                 unif, key, sqrt_mass)
        out = tree_transition_plain(q, p0, eps, d_s, u_s, phys, minv,
                                    max_depth, min_delta, valid, ckpt_bf16)
        outs.append(out)
        q = out.q
    return TreeOut(*(out.grad if f == "grad" else
                     torch.stack([getattr(o, f) for o in outs])
                     for f in TreeOut._fields))


def gaussian_tree_sweep_plain(q0, eps, lam, minv, *args, **kw) -> TreeOut:
    """:func:`tree_sweep_plain` with the Gaussian physics of precision
    ``lam [D]``."""
    return tree_sweep_plain(q0, eps, _gaussian(lam), minv, *args, **kw)


_INT_FIELDS = ("term", "term_left", "term_right", "depth", "steps")


def _empty_out(lead: tuple, c: int, d: int, device) -> TreeOut:
    """Output buffers: ``lead = (K,)`` for a sweep, ``()`` for one
    transition (the kernel writes the same layout)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return TreeOut(
        q=torch.empty(lead + (c, d), **f32),
        logp=torch.empty(lead + (c,), **f32),
        grad=torch.empty((c, d), **f32),
        **{f: torch.empty(lead + (c,), **f32)
           for f in ("energy", "log_sum_alpha")},
        **{f: torch.empty(lead + (c,), **i32) for f in _INT_FIELDS})


def _check_draws(momentum, dirs, sqrt_mass, unif, key) -> bool:
    """Whether the call refreshes inside (no momentum given); raises on a
    combination the kernel cannot take."""
    refresh = momentum is None
    if refresh and (dirs is not None or sqrt_mass is None):
        raise ValueError("tree kernel: without momentum, pass sqrt_mass and "
                         "no dirs (both are drawn from the key)")
    if not refresh and dirs is None:
        raise ValueError("tree kernel: momentum needs its direction words")
    if (refresh or unif is None) and key is None:
        raise ValueError("tree kernel: a key is needed to draw")
    return refresh


def _launch(q0, eps, phys, minv, max_depth: int, min_delta: float, k: int,
            lead: tuple, momentum, dirs, unif, key, sqrt_mass, valid, out,
            refresh: bool, ckpt_bf16: bool, path) -> TreeOut:
    """Check what the physics' kernel (``csrc/tree_<physics>.cu``, its
    diagonal or dense launcher by ``minv``'s shape) reads through raw
    pointers and launch it on the current stream.  ``lead`` is ``(k,)`` for
    arrays with a sweep axis, ``()`` for one transition without one.
    ``path`` asks for the staged products' path (:func:`stage_plan`, or a
    cluster of :data:`CLUSTER_PATHS`); by default the plan's own, and in
    the wide form under a dense metric the cluster :func:`cluster_of`
    picks for the chains in flight of the last launch of this launcher and
    shape whose record has reached the host (before any, C).  The
    matrices a launch may stage must start 16-byte aligned, as the copy
    unit reads them."""
    if q0.device.type != "cuda":
        raise ValueError(f"tree kernel: unsupported device {q0.device}")
    if q0.ndim != 2:
        raise ValueError("tree kernel: q0 must be 2-D")
    c, d = q0.shape
    if not takes(d, max_depth, phys.name, ckpt_bf16):
        raise ValueError(
            f"tree kernel: {refusal(d, max_depth, phys.name, ckpt_bf16)}"
            if d >= 1 else f"tree kernel: D={d} < 1")
    dev = q0.device
    spec = tile_physics.PHYSICS[phys.name]
    rows, mat = phys.rows(), phys.matrix()
    obs_mat, obs_rows = phys.obs_matrix(), phys.obs_rows()
    n_obs = 0 if obs_mat is None else obs_mat.shape[0]
    dense = minv.ndim == 2
    metric_shape = (d, d) if dense else (d,)
    checks = [("q0", q0, (c, d), torch.float32),
              ("eps", eps, (c,), torch.float32),
              ("minv", minv, metric_shape, torch.float32)]
    checks += [(n, t, (d,), torch.float32) for n, t in zip(spec.rows, rows)]
    if mat is not None:
        checks.append(("matrix", mat, (d, d), torch.float32))
    if obs_mat is not None:
        checks.append((spec.obs_matrix, obs_mat, (n_obs, d), torch.float32))
    checks += [(n, t, (n_obs,), torch.float32)
               for n, t in zip(spec.obs_rows, obs_rows)]
    if refresh:
        checks.append(("sqrt_mass", sqrt_mass, metric_shape, torch.float32))
    else:
        checks += [("momentum", momentum, lead + (c, d), torch.float32),
                   ("dirs", dirs, lead + (c,), torch.int32)]
    if unif is not None:
        checks.append(("unif", unif, lead + (n_uniforms(max_depth), c),
                       torch.float32))
    if key is not None:
        checks.append(("key", key, (2,), torch.int64))
    if valid is not None:
        checks.append(("valid", valid, (c,), torch.int32))
    if out is None:
        out = _empty_out(lead, c, d, dev)
    else:
        for name, t in zip(TreeOut._fields, out):
            shape = (c, d) if name == "grad" else \
                lead + (c, d) if name == "q" else lead + (c,)
            dtype = torch.int32 if name in _INT_FIELDS else torch.float32
            checks.append((f"out.{name}", t, shape, dtype))
    for name, t, shape, dtype in checks:
        check_tensor("tree kernel", name, t, shape, dev, dtype)
    tiled = phys.name in TILED_PHYSICS
    if tiled:
        plane, n_plane = tile_plane(phys)
        form = "grad_bf16" if phys.data["grad_bf16"] else "f32"
        check_tensor("tree kernel", "plane", plane,
                     plane_shape(n_plane, d, form), dev, torch.float32)
    kernel = (TREE_DENSE_KERNELS if dense else TREE_KERNELS)[phys.name]
    if path is not None:
        _check_path(d, max_depth, phys.name, dense, refresh, ckpt_bf16, path,
                    tiled and bool(phys.data["grad_bf16"]))
    wide_dense = dense and d > WARP_DIM
    tail = (kernel.symbol, c, d, max_depth)
    if wide_dense and path is None:
        # a cluster where the last launch of this shape waited on its
        # deepest chain, if the launcher admits it here
        blocks = cluster_of(d, _TAIL.spread(tail, c))
        if blocks > 1 and _cluster_admitted(phys.name, d, max_depth,
                                            refresh, ckpt_bf16,
                                            f"cluster{blocks}"):
            path = f"cluster{blocks}"
    blocks = 1 if path is None else cluster_size(path)
    if blocks > 1:
        # the cluster's blocks stream the matrices' column panels, packed
        # once per matrix
        mat = None if mat is None else cluster_panels(mat, blocks)
        minv = cluster_panels(minv, blocks)
        if refresh:
            sqrt_mass = cluster_panels(sqrt_mass, blocks)
    staged = [("matrix", mat), ("minv", minv if dense else None),
              ("sqrt_mass", sqrt_mass if dense and refresh else None),
              ("plane", plane if tiled else None)]
    for name, t in staged:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(
                f"tree kernel: {name} must start 16-byte aligned for the "
                f"bulk copies (address {t.data_ptr():#x})")

    def ptr(t):
        return None if t is None else t.data_ptr()

    row_ptrs = [t.data_ptr() for t in rows] + [None] * (3 - len(rows))
    obs_ptrs = [t.data_ptr() for t in obs_rows] \
        + [None] * (2 - len(obs_rows))
    if tiled:   # the kernel reads the plane alone
        obs_mat, obs_ptrs, n_obs = plane, [None, None], n_plane
    scalars = phys.scalars() + [0.0] * (2 - len(phys.scalars()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel.launch(
            q0.data_ptr(), ptr(sqrt_mass if refresh else momentum),
            eps.data_ptr(), ptr(dirs), ptr(valid), ptr(key), ptr(unif),
            *row_ptrs, ptr(mat), ptr(obs_mat), *obs_ptrs, n_obs, *scalars,
            minv.data_ptr(),
            *(t.data_ptr() for t in out),
            c, d, max_depth, k, int(refresh), int(ckpt_bf16),
            -1 if path is None else PATHS.index(path),
            float(min_delta), stream)
    if ckpt_bf16:
        CKPT_BF16_LAUNCHES[kernel.symbol] = \
            CKPT_BF16_LAUNCHES.get(kernel.symbol, 0) + 1
    if blocks > 1:
        CLUSTER_LAUNCHES[kernel.symbol] = \
            CLUSTER_LAUNCHES.get(kernel.symbol, 0) + 1
    if wide_dense:
        with torch.cuda.device(dev):
            _TAIL.record(tail, c, out.steps)
    return out


def tree_sweep(q0: torch.Tensor, eps: torch.Tensor, phys,
               minv: torch.Tensor, max_depth: int, min_delta: float,
               n_sweep: int = 1, *, momentum=None, dirs=None, unif=None,
               key=None, sqrt_mass=None, valid=None, out=None,
               ckpt_bf16: bool = False, path: str = None) -> TreeOut:
    """``n_sweep`` transitions of every chain in one launch, from
    ``q0 [C, D]``, which is only read (on the card it may be the last
    transition of ``out.q``: the previous launch's carry), under the physics
    ``phys`` (a :class:`~.tile_physics.Bound`).  CPU tensors take the plain
    version (:func:`tree_sweep_plain`); CUDA tensors launch the physics'
    kernel on the current stream or raise.  On the card everything is
    float32 and contiguous: ``eps [C]``, the physics' rows ``[D]`` and
    matrix ``[D, D]``, ``minv`` ``[D]`` (diagonal) or ``[D, D]`` (dense);
    ``momentum [K, C, D]`` and ``dirs [K, C]`` int32, or neither and
    ``sqrt_mass`` (``refresh_inside``: the ``[D]`` sqrt-mass row, or the
    dense metric's ``[D, D]`` ``mass_chol^T``); ``unif [K, 2^md - 1 + md,
    C]`` or none; ``key [2]`` int64 where anything is drawn; ``valid [C]``
    int32 or none (every row valid).  ``out``: a :class:`TreeOut` of
    buffers to write into (a sampling loop's, allocated once); the returned
    tensors are those buffers, so the next call with them overwrites
    them.  ``ckpt_bf16``: bfloat16 checkpoint stacks.  ``path``: the staged
    products' path, a check's hook (:func:`stage_plan` or a cluster of
    :data:`CLUSTER_PATHS`; by default the plan's own, in the wide form
    under a dense metric a cluster where the last launch of the shape
    waited on its deepest chain, :func:`cluster_of`; the sampling paths
    never set it); the plain version checks it and has one path."""
    refresh = _check_draws(momentum, dirs, sqrt_mass, unif, key)
    _check_max_depth(max_depth)
    if n_sweep < 1:
        raise ValueError(f"n_sweep must be >= 1, got {n_sweep}")
    if q0.device.type == "cpu":
        if path is not None:
            _check_path(q0.shape[1], max_depth, phys.name, minv.ndim == 2,
                        refresh, ckpt_bf16, path)
        return tree_sweep_plain(
            q0, eps, phys, minv, max_depth, min_delta, n_sweep,
            momentum=momentum, dirs=dirs, unif=unif, key=key,
            sqrt_mass=sqrt_mass, valid=valid, ckpt_bf16=ckpt_bf16)
    return _launch(q0, eps, phys, minv, max_depth, min_delta, n_sweep,
                   (n_sweep,), momentum, dirs, unif, key, sqrt_mass, valid,
                   out, refresh, ckpt_bf16, path)


def gaussian_tree_sweep(q0, eps, lam, minv, *args, **kw) -> TreeOut:
    """:func:`tree_sweep` with the Gaussian physics of precision
    ``lam [D]``."""
    return tree_sweep(q0, eps, _gaussian(lam), minv, *args, **kw)


def tree_transition(q0: torch.Tensor, p0, eps: torch.Tensor, dirs, unif,
                    phys, minv: torch.Tensor, max_depth: int,
                    min_delta: float, *, key=None, valid=None,
                    sqrt_mass=None, ckpt_bf16: bool = False,
                    path: str = None) -> TreeOut:
    """One transition for every chain, with no sweep axis: with the given
    momentum ``p0 [C, D]`` and direction words ``dirs [C]`` (int32 on the
    card), or with ``p0 = dirs = None`` and the momentum's scale
    ``sqrt_mass`` (``[D]``, or ``[D, D]`` with a dense ``minv``: see
    :func:`tree_sweep`) both drawn from ``key`` (``refresh_inside``); with
    the uniforms ``unif [2^md - 1 + md, C]`` or, with ``unif=None``, those
    the generator draws from ``key``; under the physics ``phys``;
    ``ckpt_bf16``: bfloat16 checkpoint stacks; ``path`` as
    :func:`tree_sweep` takes it.  CPU tensors take the plain
    version; CUDA tensors launch the physics' kernel (float32 and
    contiguous, within :func:`takes`) or raise."""
    refresh = _check_draws(p0, dirs, sqrt_mass, unif, key)
    _check_max_depth(max_depth)
    if q0.device.type == "cpu":
        if path is not None:
            _check_path(q0.shape[1], max_depth, phys.name, minv.ndim == 2,
                        refresh, ckpt_bf16, path)
        if refresh:
            out = tree_sweep_plain(
                q0, eps, phys, minv, max_depth, min_delta, key=key,
                sqrt_mass=sqrt_mass, unif=None if unif is None
                else unif[None], valid=valid, ckpt_bf16=ckpt_bf16)
            return TreeOut(*(t if f == "grad" else t[0]
                             for f, t in zip(TreeOut._fields, out)))
        if unif is None:
            rows = torch.arange(q0.shape[0], dtype=torch.int64)
            unif = lambda slots: philox.uniforms(  # noqa: E731
                key, rows, 0, slots, q0.dtype)
        return tree_transition_plain(
            q0, p0, eps, dirs, unif, phys, minv, max_depth, min_delta, valid,
            ckpt_bf16)
    return _launch(q0, eps, phys, minv, max_depth, min_delta, 1, (), p0, dirs,
                   unif, key, sqrt_mass, valid, None, refresh, ckpt_bf16,
                   path)


def gaussian_tree_transition(q0, p0, eps, dirs, unif, lam, minv, *args,
                             **kw) -> TreeOut:
    """:func:`tree_transition` with the Gaussian physics of precision
    ``lam [D]``."""
    return tree_transition(q0, p0, eps, dirs, unif, _gaussian(lam), minv,
                           *args, **kw)


def direction_words_int32(dirs: torch.Tensor) -> torch.Tensor:
    """32-bit direction words (int64 in ``[0, 2^32)``) as the int32 bit
    patterns the kernel reads."""
    d = dirs.to(torch.int64) & 0xFFFFFFFF
    return torch.where(d >= 2 ** 31, d - 2 ** 32, d).to(torch.int32)


def philox_draws(key: torch.Tensor, n_chains: int, dim: int, max_depth: int,
                 n_sweep: int = 1):
    """What the kernel's generator draws under ``key`` for ``n_sweep``
    transitions of ``n_chains`` chains: standard normals ``[K, C, D]`` (the
    momentum before its scale), direction words ``[K, C]`` (int32 bit
    patterns) and uniforms ``[K, 2^md - 1 + md, C]``, all on ``key``'s
    device.  On the card they come from the source's second launcher (the
    kernel's own ``__device__`` generator); on the CPU from
    ``utils/philox.py``."""
    dev = key.device
    k, c, nu = n_sweep, n_chains, n_uniforms(max_depth)
    if dev.type == "cpu":
        rows = torch.arange(c, dtype=torch.int64)
        normals = torch.stack([philox.normals(key, rows, s, dim)
                               for s in range(k)])
        dirs = torch.stack([direction_words_int32(
            philox.direction_words(key, rows, s)) for s in range(k)])
        unif = torch.stack([philox.uniforms(key, rows, s, range(nu))
                            for s in range(k)])
        return normals, dirs, unif
    check_tensor("philox draws", "key", key, (2,), dev, torch.int64)
    normals = torch.empty((k, c, dim), dtype=torch.float32, device=dev)
    dirs = torch.empty((k, c), dtype=torch.int32, device=dev)
    unif = torch.empty((k, nu, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        PHILOX_DRAWS.launch(key.data_ptr(), normals.data_ptr(),
                            dirs.data_ptr(), unif.data_ptr(), c, dim, nu, k,
                            stream)
    return normals, dirs, unif


def _stats(out: TreeOut, dtype) -> TreeStats:
    return TreeStats(energy=out.energy.to(dtype),
                     acceptance_rate=acceptance(out.log_sum_alpha,
                                                out.steps).to(dtype),
                     termination=out.term, term_left=out.term_left,
                     term_right=out.term_right, depth=out.depth,
                     steps=out.steps)


def _pad_chains(c: int, block_c: int, q, eps, momentum, dirs, unif):
    """The inputs of ``c`` chains padded to ``chain_tiles(c, block_c)``
    rows (``q``, ``eps``: zeros; the momentum and direction words: zeros;
    the uniforms: ones), with the ``valid`` column that starts the padded
    rows inactive, or ``None`` where no row is padded.  The chain axis is
    the last but one of ``q`` and ``momentum`` and the last of the
    others."""
    cpad, _ = chain_tiles(c, block_c)
    if cpad == c:
        return q, eps, momentum, dirs, unif, None

    def pad(t, fill, axis):
        if t is None:
            return None
        shape = list(t.shape)
        shape[axis] = cpad - c
        return torch.cat([t, torch.full(shape, fill, dtype=t.dtype,
                                        device=t.device)], dim=axis)

    valid = torch.zeros((cpad,), dtype=torch.int32, device=q.device)
    valid[:c] = 1
    return (pad(q, 0, -2), pad(eps, 0, -1), pad(momentum, 0, -2),
            pad(dirs, 0, -1), pad(unif, 1, -1), valid)


def _rows(out: TreeOut, c: int, lead: tuple) -> TreeOut:
    """The first ``c`` chains of a (possibly padded) launch's outputs."""
    if out.q.shape[len(lead)] == c:
        return out
    return TreeOut(*(t[:c] if f == "grad" or not lead else t[:, :c]
                     for f, t in zip(TreeOut._fields, out)))


def make_tree_transition(physics: str, data: dict, dim: int, metric_inv, *,
                         max_depth: int = 10, min_delta: float = -1000.0,
                         block_c: int = 512, refresh_inside: bool = False,
                         padded_io: bool = False, n_sweep: int = 1,
                         ckpt_bf16: bool = False):
    """The whole-tree transition for the tile physics named ``physics``
    (``ops/tile_physics.py``) on ``data`` (its rows ``[dim]``, matrix
    ``[dim, dim]``, observation matrix ``[npad, dim]`` and rows ``[npad]``,
    scalars and settings) with the metric ``metric_inv``: a diagonal
    ``[dim]`` tensor or :class:`DiagMetric`, or a dense ``[dim, dim]``
    tensor or :class:`DenseMetric` (its ``M^-1``; the momentum is drawn
    through ``mass_chol``), as the JAX package's ``make_tree_transition``
    builds it for a model's ``tile_logp``.

    Returns ``transition(gen, z, eps, *, directions=None, momentum=None,
    unif=None)`` with the semantics of
    :func:`inplacedhmc_tpu_torch.nuts.tree.nuts_transition`.  ``gen`` draws
    the momentum and the ``[C]`` direction words (unless given) and the
    launch's key, from which the kernel draws the proposal uniforms (unless
    ``unif [2^md - 1 + md, C]`` is given, a test hook).  Under
    ``refresh_inside`` the kernel draws the momentum and the directions too,
    and passing them raises.  With ``n_sweep = K > 1`` one call runs K
    transitions and returns ``(z_final, q_draws [K, C, D], stats [K, C])``;
    without ``refresh_inside`` it then needs ``momentum [K, C, D]`` and
    ``directions [K, C]`` (``unif`` is ``[K, 2^md - 1 + md, C]``).

    For a physics of ``TILED_PHYSICS`` the transition pads the chains to
    ``chain_tiles(C, block_c)`` rows as JAX pads them to its tiles, the
    padded rows not valid (they start inactive), and returns the first C.

    ``padded_io`` (needs ``refresh_inside``): returns ``(transition,
    run_padded)``; ``run_padded(gen, q_state, eps_col, valid_col) ->
    (q_draws [K, cpad, D], logp [K, cpad], grad [cpad, D], stats [K, cpad])``
    runs one launch on the state of a sampling loop: it starts from
    ``q_state [cpad, D]`` (chains padded to a multiple of ``block_c``,
    ``ops.common.chain_tiles``), which it only reads; ``q_draws[-1]`` is the
    carry, to be passed as the next launch's ``q_state``; ``eps_col
    [cpad]`` and ``valid_col [cpad]`` int32 (padded rows 0) are the loop's.
    Between launches it draws the key and nothing else: the outputs are
    buffers allocated at the first call and overwritten by the next one.
    ``run_padded`` carries ``block_c``, ``n_sweep`` and ``dim``.
    ``ckpt_bf16`` stores the checkpoint stacks in bfloat16.

    The transition runs on ``z.q``'s device, in float32 on the card and in
    its dtype on the CPU."""
    tile_physics.bind(physics, data)   # raises on an unknown physics
    _check_max_depth(max_depth)
    if n_sweep < 1:
        raise ValueError(f"n_sweep must be >= 1, got {n_sweep}")
    if padded_io and not refresh_inside:
        raise ValueError("padded_io requires refresh_inside")
    if block_c % 8 != 0:
        raise ValueError(f"block_c must be a multiple of 8, got {block_c}")
    if isinstance(metric_inv, (DiagMetric, DenseMetric)):
        metric = metric_inv
    else:
        inv = torch.as_tensor(metric_inv)
        metric = dense_metric(inv) if inv.ndim == 2 else diag_metric(inv)
    dense = isinstance(metric, DenseMetric)
    if metric.inv.shape != ((dim, dim) if dense else (dim,)):
        raise ValueError(f"metric of shape {tuple(metric.inv.shape)} for a "
                         f"{dim}-dimensional model")
    # the momentum's scale: the sqrt-mass row, or mass_chol^T (p = xi @ it)
    scale = metric.mass_chol.transpose(-1, -2) if dense else metric.sqrt_mass
    tiled = physics in TILED_PHYSICS
    consts_cache = {}

    def consts(dev, dt):
        """the bound physics, M^-1 and the momentum scale on ``dev`` in
        ``dt``, cast once per device and dtype"""
        if (dev, dt) not in consts_cache:
            consts_cache[(dev, dt)] = (bind(physics, data, dev, dt),) + tuple(
                torch.as_tensor(t, device=dev).to(dt).contiguous()
                for t in (metric.inv, scale))
        return consts_cache[(dev, dt)]

    def transition(gen: torch.Generator, z: EvalPoint, eps, *,
                   directions=None, momentum=None, unif=None):
        q = z.q
        c = q.shape[0]
        dev = q.device
        dt = torch.float32 if dev.type == "cuda" else q.dtype
        phys, minv, sqrt_mass = consts(dev, dt)

        def cast(t):
            return torch.as_tensor(t, device=dev).to(dt).contiguous()

        if refresh_inside:
            if directions is not None or momentum is not None:
                raise ValueError("refresh_inside draws the momentum and the "
                                 "directions in the kernel; the explicit "
                                 "hooks need a refresh_inside=False build")
        elif n_sweep > 1:
            if directions is None or momentum is None:
                raise ValueError("n_sweep > 1 without refresh_inside needs "
                                 "momentum [K, C, D] and directions [K, C]")
        else:
            if momentum is None:
                momentum = sample_momentum(metric, gen, q.shape, q.dtype)
            if directions is None:
                directions = torch.randint(0, 2 ** 32, (c,), generator=gen,
                                           dtype=torch.int64, device=dev)
        key = philox.draw_key(gen) if refresh_inside or unif is None \
            else None
        q_in = cast(q)
        eps_c = torch.as_tensor(eps, dtype=dt, device=dev).expand(c) \
            .contiguous()
        draws = dict(key=key, sqrt_mass=sqrt_mass if refresh_inside else None,
                     ckpt_bf16=ckpt_bf16)
        mom = None if momentum is None else cast(momentum)
        d32 = None if directions is None else direction_words_int32(
            torch.as_tensor(directions, device=dev))
        u = None if unif is None else cast(unif)
        if tiled:
            # the chains padded to block_c tiles as JAX pads them, the rows
            # past c not valid (they start inactive and return their
            # inputs); the draws of a chain depend on its row only
            q_in, eps_c, mom, d32, u, draws["valid"] = _pad_chains(
                c, block_c, q_in, eps_c, mom, d32, u)
        if n_sweep == 1:
            out = tree_transition(q_in, mom, eps_c, d32, u, phys, minv,
                                  max_depth, min_delta, **draws)
            out = _rows(out, c, ())
            return (EvalPoint(q=out.q.to(q.dtype), logp=out.logp.to(q.dtype),
                              grad=out.grad.to(q.dtype)),
                    _stats(out, q.dtype))
        out = tree_sweep(q_in, eps_c, phys, minv, max_depth, min_delta,
                         n_sweep, momentum=mom, dirs=d32, unif=u, **draws)
        out = _rows(out, c, (n_sweep,))
        z_new = EvalPoint(q=out.q[-1].to(q.dtype),
                          logp=out.logp[-1].to(q.dtype),
                          grad=out.grad.to(q.dtype))
        return z_new, out.q.to(q.dtype), _stats(out, q.dtype)

    if not padded_io:
        return transition

    buffers = {}

    def run_padded(gen: torch.Generator, q_state: torch.Tensor,
                   eps_col: torch.Tensor, valid_col: torch.Tensor):
        dev, dt = q_state.device, q_state.dtype
        phys, minv, sqrt_mass = consts(dev, dt)
        buf = None
        if dev.type == "cuda":
            shape = tuple(q_state.shape)
            if buffers.get("shape") != (shape, dev):
                buffers["shape"] = (shape, dev)
                buffers["out"] = _empty_out((n_sweep,), *shape, dev)
            buf = buffers["out"]
        out = tree_sweep(
            q_state, eps_col, phys, minv, max_depth, min_delta, n_sweep,
            key=philox.draw_key(gen), sqrt_mass=sqrt_mass, valid=valid_col,
            out=buf, ckpt_bf16=ckpt_bf16)
        return out.q, out.logp, out.grad, _stats(out, dt)

    run_padded.block_c = block_c
    run_padded.n_sweep = n_sweep
    run_padded.dim = dim
    return transition, run_padded


def make_gaussian_tree_transition(precision, metric_inv, **kw):
    """:func:`make_tree_transition` for ``grad = -precision * q`` targets
    (the Gaussian physics), as the JAX package's
    ``make_gaussian_tree_transition`` builds it."""
    precision = torch.as_tensor(precision)
    return make_tree_transition("gaussian", {"lam": precision},
                                precision.shape[0], metric_inv, **kw)


def make_dense_gaussian_tree_transition(precision, metric_inv, **kw):
    """:func:`make_tree_transition` for ``grad = -(q P)`` targets with a
    symmetric ``[D, D]`` precision ``P`` (the ``dense_gaussian`` physics of
    ``mvn`` models), as the JAX package's
    ``make_dense_gaussian_tree_transition`` builds it, under a diagonal or
    a dense metric.  JAX pads ``P`` with an identity block on its dead
    lanes; the port pads no lanes (the kernel masks lanes past D), so there
    is nothing to pad."""
    precision = torch.as_tensor(precision)
    return make_tree_transition("dense_gaussian", {"prec": precision},
                                precision.shape[0], metric_inv, **kw)


def make_logistic_tree_transition(x, y, inv_var: float, metric_inv, *,
                                  block_c: int = LOGISTIC_BLOCK_C,
                                  physics_mode: str = "chunked",
                                  grad_bf16: bool = False,
                                  block_n: int = 2048, **kw):
    """:func:`make_tree_transition` for Bayesian logistic regression over
    ``x [N, D]``, labels ``y [N]`` and the prior precision ``inv_var`` (the
    ``logistic`` physics, ``csrc/tree_logistic.cu``), as the JAX package's
    ``make_logistic_tree_transition`` builds it, under a diagonal or a
    dense metric.  ``physics_mode`` ``"chunked"`` and ``"vjp"`` both run
    the one hand-written physics: JAX's two forms compute the same function
    (the hand-fused value and gradient, and autodiff of the log density).
    ``grad_bf16`` rounds the backward product's inputs to bfloat16, on the
    card and in the plain version, under ``"chunked"`` only: JAX's ``"vjp"``
    form never reads it; ``block_n`` pads the observations to a
    multiple of it (``ops/tile_physics.py::logistic_data``) and sets the
    plain version's chunk; the kernel walks the plane's tiles of 32
    observations whatever it is (:func:`tile_plane`, made once per device
    with the bound physics).  ``block_c`` (JAX's default 128, a multiple of
    the kernel's tile) pads the chains."""
    x = torch.as_tensor(x)
    data = tile_physics.logistic_data(x, y, inv_var,
                                      physics_mode=physics_mode,
                                      grad_bf16=grad_bf16, block_n=block_n)
    return make_tree_transition("logistic", data, x.shape[1], metric_inv,
                                block_c=block_c, **kw)
