"""The plan of K5's staged ``[D, D]`` products, on the CPU.

``ops.tree.stage_plan`` mirrors the launcher's ``plan_of``
(``csrc/tree_kernel.cuh``): which path a launch's products take (the
register path of the kernel before staging, the matrices resident in the
block's shared memory, or streamed through each team's ring of panels),
the chains a block holds, the ring's stages and rows a panel, and the
block's shared memory.  ``tests/test_torch_cuda.py::
test_cuda_staged_paths_bit_equal`` holds the launcher's own answers to this
mirror on the card, and every admissible path's outputs to each other's.
"""

import pytest

DIMS = [10, 50, 100, 102, 128, 129, 200, 250, 256, 257, 1002, 2048]
DEPTHS = [10, 13, 26]


@pytest.fixture(autouse=True, scope="module")
def _torch_port():
    """Import torch and the port when this file's tests run, not at
    collection (``tests/test_torch_cuda.py`` says why)."""
    global torch, tree
    import torch
    import inplacedhmc_tpu_torch.ops.tree as tree


def _takes_before(dim, md, physics, bf16):
    """``ops.tree.takes`` as the kernel without staging answered it: any
    physics to D = 256, the wide form's three to 2,048 while its stacks,
    row-sum scratch and two staging rows fit one block's 232,448 bytes."""
    if dim <= 256:
        return dim >= 1
    stacks = -(-2 * md * dim * (2 if bf16 else 4) // 16) * 16
    return (physics in ("gaussian", "dense_gaussian", "stoch_vol")
            and dim <= 2048 and stacks + 4 * (64 + 2 * dim) <= 232448)


def _cases():
    for physics, dense in (("gaussian", False), ("gaussian", True),
                           ("dense_gaussian", False),
                           ("dense_gaussian", True)):
        for refresh in (False, True):
            yield physics, dense, refresh


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("md", DEPTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_fits_and_takes_as_before(dim, md, bf16):
    """At every shape, for a physics without a matrix (the Gaussian) and
    one with (the dense Gaussian), under a diagonal and a dense metric,
    with and without the refresh: ``takes`` answers as before staging; where
    it takes the shape, every admissible path's shared memory stays within
    ``SMEM_LIMIT``, the register path is always admitted (the unstaged
    launch: its chains a block and bytes), the plan's own path is one of the
    admissible ones, and a launch without a matrix or of the wide form
    admits nothing else."""
    for physics, dense, refresh in _cases():
        takes = tree.takes(dim, md, physics, bf16)
        assert takes == _takes_before(dim, md, physics, bf16)
        if not takes:
            continue
        n = tree.n_staged(physics, dense, refresh)
        plans = {}
        for path in tree.PATHS:
            try:
                plans[path] = tree.stage_plan(dim, md, physics, dense,
                                              refresh, bf16, path)
            except ValueError:
                continue
            assert plans[path].path == path
            assert 0 < plans[path].smem_bytes <= tree.SMEM_LIMIT
        reg = plans["register"]
        stack = tree.stack_bytes(dim, md, bf16)
        if dim <= tree.WARP_DIM:
            w = min(4, tree.SMEM_LIMIT // stack)
            assert (reg.warps, reg.smem_bytes) == (w, w * stack)
        else:
            assert (reg.warps, reg.smem_bytes) \
                == (1, tree.wide_smem_bytes(dim, md, bf16))
        own = tree.stage_plan(dim, md, physics, dense, refresh, bf16)
        assert own == plans[own.path]
        if n == 0 or dim > tree.WARP_DIM:
            assert set(plans) == {"register"}
        if "ring" in plans:
            r = plans["ring"]
            assert 2 <= r.stages <= tree.MAX_STAGES
            assert (r.rows * dim) % 4 == 0 or r.rows >= dim
            assert r.warps == reg.warps


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("md", DEPTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_forced_path_refused_where_not_admitted(dim, md, bf16):
    """Forcing a path the shape does not admit raises: anything but the
    register path in the wide form (above D = 256: no matrix fits a block,
    and the card measured a ring over the block slower) and without a
    matrix; so does an unknown path.  An admitted ring has two to
    ``MAX_STAGES`` stages within ``SMEM_LIMIT``."""
    for physics, dense, refresh in _cases():
        if not tree.takes(dim, md, physics, bf16):
            continue
        n = tree.n_staged(physics, dense, refresh)
        if dim > tree.WARP_DIM or n == 0:
            for path in ("resident", "ring"):
                with pytest.raises(ValueError, match="does not admit"):
                    tree.stage_plan(dim, md, physics, dense, refresh, bf16,
                                    path)
        with pytest.raises(ValueError, match="path must be one of"):
            tree.stage_plan(dim, md, physics, dense, refresh, bf16, "fast")
        try:
            r = tree.stage_plan(dim, md, physics, dense, refresh, bf16,
                                "ring")
        except ValueError:
            continue
        assert 2 <= r.stages <= tree.MAX_STAGES
        assert r.smem_bytes <= tree.SMEM_LIMIT


@pytest.mark.parametrize("dim,md,bf16,physics,dense,refresh,path,warps,stages", [
    (10, 10, False, "eight_schools", True, False, "register", 4, 0),
    (10, 10, False, "funnel", True, False, "resident", 1, 0),
    (50, 10, False, "logistic", True, False, "register", 16, 8),
    (50, 10, False, "logistic", True, True, "register", 16, 8),
    (100, 10, False, "gaussian", True, False, "resident", 8, 0),
    (100, 10, False, "gaussian", True, True, "resident", 16, 0),
    (102, 10, False, "stoch_vol", True, False, "resident", 8, 0),
    (102, 10, True, "stoch_vol", True, True, "resident", 16, 0),
    (250, 10, False, "dense_gaussian", True, False, "ring", 4, 3),
    (250, 10, False, "dense_gaussian", False, False, "ring", 4, 3),
    (250, 10, True, "dense_gaussian", True, True, "ring", 4, 2),
    (200, 10, False, "gaussian", True, False, "ring", 4, 2),
    (128, 10, False, "gaussian", True, False, "resident", 15, 0),
    (128, 10, False, "dense_gaussian", True, True, "resident", 3, 0),
    (129, 10, False, "dense_gaussian", True, True, "ring", 4, 2),
    (129, 10, False, "gaussian", True, False, "resident", 4, 0),
    (1002, 10, False, "stoch_vol", True, False, "register", 1, 0),
    (1002, 10, True, "stoch_vol", True, True, "register", 1, 0),
    (2048, 10, False, "gaussian", True, False, "register", 1, 0),
    (2048, 13, False, "gaussian", True, False, "register", 1, 0),
    (2048, 26, True, "dense_gaussian", True, True, "register", 1, 0),
    (100, 10, False, "gaussian", False, False, "register", 4, 0)])
def test_plan_at_the_main_paths_shapes(dim, md, bf16, physics, dense,
                                       refresh, path, warps, stages):
    """The plan's own path at the shapes the sampling paths run: the
    matrix resident in the one-warp form's block at the funnel's D = 10,
    config 1's 100 (two matrices
    under the refresh, sixteen chains a block), stochastic volatility's
    102, and at D = 128 (15 chains a block; three matrices, three) and just
    past it where it holds as many chains an SM as the ring; a ring at the
    250-D ``mvn``, at D = 200 and at 129 with three matrices; the register
    path for eight schools and logistic regression (the card measured
    their products slower staged; logistic regression's tile form: a tile
    of 16 chains and its ring of 8 observation tiles' stages, two sets of
    a batch of 4, at config 3's shape), where the card measured the
    ring slower than it (the wide form:
    config 5's T = 1,000, D = 2,048), where neither staging fits
    beside the stacks (the wide form at D = 2,048, max_depth 13 with
    float32 stacks, 26 with bfloat16 ones) and where nothing is staged."""
    plan = tree.stage_plan(dim, md, physics, dense, refresh, bf16)
    assert (plan.path, plan.warps, plan.stages) == (path, warps, stages)
    if path == "ring":
        assert plan.in_flight(dim) == 4 * (stages - 1) * plan.rows * dim
    else:
        assert plan.in_flight(dim) == 0


def test_resident_or_ring_above_128():
    """Above D = 128, where the ring is admitted too, the plan keeps the
    matrices resident only where an SM then holds as many chains as on the
    ring (the register path's 8 warps, and what the shared memory leaves):
    the block takes more chains, one copy of the matrices serving them
    all; else it takes the ring.  Where the ring is not admitted, the
    matrices stay resident wherever they fit."""
    def chains(plan):
        per_sm = tree.SM_SMEM // (plan.smem_bytes + tree.BLOCK_RESERVED)
        return plan.warps * min(8 // plan.warps, per_sm)

    for dim in DIMS[5:9]:
        for md in DEPTHS:
            for physics, dense, refresh in _cases():
                if not tree.n_staged(physics, dense, refresh):
                    continue
                plan = tree.stage_plan(dim, md, physics, dense, refresh)
                try:
                    ring = tree.stage_plan(dim, md, physics, dense, refresh,
                                           path="ring")
                except ValueError:
                    assert plan.path in ("resident", "register")
                    continue
                if plan.path == "resident":
                    assert chains(plan) >= chains(ring)
                else:
                    assert plan.path == "ring"


def test_unstaged_physics_mirror_the_sources():
    """``ops.tree.UNSTAGED_PHYSICS`` names exactly the physics whose source
    sets ``kStaging = false`` (``tree_kernel.cuh::kStagedOf``), and a
    dense launch of theirs stages nothing: the mirror plans the register
    path there, as the launcher does."""
    import os
    import re
    from inplacedhmc_tpu_torch.ops import tile_physics
    csrc = os.path.join(os.path.dirname(tree.__file__), os.pardir, "csrc")
    off = set()
    for name in tile_physics.PHYSICS:
        with open(os.path.join(csrc, f"tree_{name}.cu")) as f:
            flag = re.findall(r"static constexpr bool kStaging = (\w+);",
                              f.read())
        assert flag in (["true"], ["false"]), name
        if flag == ["false"]:
            off.add(name)
    assert off == set(tree.UNSTAGED_PHYSICS)
    for name in off:
        assert tree.n_staged(name, True, True) == 0
        assert tree.stage_plan(10, 10, name, True).path == "register"


def test_cpu_launch_checks_the_forced_path():
    """On the CPU the plain version runs whatever the path (it has one),
    but a path the shape does not admit raises there as on the card, and
    an admitted one gives the plain version's outputs."""
    from inplacedhmc_tpu_torch.ops import tile_physics as tp
    gen = torch.Generator().manual_seed(3)
    c, d, md = 6, 12, 4
    q = torch.randn((c, d), generator=gen, dtype=torch.float64)
    p = torch.randn((c, d), generator=gen, dtype=torch.float64)
    phys = tp.bind("gaussian", {"lam": torch.ones(d, dtype=torch.float64)})
    minv = torch.ones(d, dtype=torch.float64)
    e = torch.full((c,), 0.3, dtype=torch.float64)
    dirs = torch.arange(c)
    unif = torch.rand((tree.n_uniforms(md), c), generator=gen,
                      dtype=torch.float64)
    with pytest.raises(ValueError, match="does not admit"):
        tree.tree_transition(q, p, e, dirs, unif, phys, minv, md, -1000.0,
                             path="resident")
    got = tree.tree_transition(q, p, e, dirs, unif, phys, minv, md, -1000.0,
                               path="register")
    want = tree.tree_transition(q, p, e, dirs, unif, phys, minv, md, -1000.0)
    for f in tree.TreeOut._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    dense = torch.eye(d, dtype=torch.float64)
    got = tree.tree_transition(q, p, e, dirs, unif, phys, dense, md, -1000.0,
                               path="ring")
    assert torch.equal(got.q, tree.tree_transition(
        q, p, e, dirs, unif, phys, dense, md, -1000.0).q)
