"""The port's brick trace (``brick.trace_brick``, the plain version of the
``brick_trace`` kernel) against the JAX package's ``trace_brick_jax`` and
the numpy oracle ``trace_numpy``.

On the CPU the wrapper ``brick_cuda.trace_brick_cuda`` runs the plain
version; the kernel is held to it on the card by chip_smoke.py. Tolerances
as in tests/test_torch_stackless.py: against XLA hit_leaf, hit_parent,
hit_child and iters exactly and hit_t to rtol 1e-5 / atol 1e-6 or 4 ULP of
the ray's largest plane term; against the oracle hit_leaf and hit_t bit for
bit off the tied rays. hit_parent and hit_child are the top tree's here (the
node above the brick and the brick's slot), so they are held to the
reference's brick trace only.

``iters`` against XLA's brick trace follows F11's rule: exact, but on up to
4 rays of 4,096 it may part by one step with the same hit. XLA contracts
the DDA's bpos * t_coef - t_bias into one multiply-add, so where two of a
voxel's exit planes tie in the port's rounding (which the kernel shares:
it is built without contraction) they need not tie in XLA's, and one walk
steps two axes at once where the other steps them one after the other
(terrain at depth 5, camera rays: one ray, 33 steps against 32, a miss
either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.scenes import Scene as JaxScene
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from tests.test_torch_stackless import (
    INTS, assert_matches_jax, assert_matches_oracle, make_rays)

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.ops import brick, brick_cuda, traverse
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SCENES = [("sphere", 5), ("terrain", 5), ("terrain", 6), ("flat_ground", 4),
          ("rotated_cuboid", 5)]
STAT = traverse.STAT_NAMES.index
ITERS_PARTING = 4


def _bricks(name, depth, scene=None):
    ref = jax_octree.build_svo(scene or jax_get_scene(name), depth).svo
    svo = convert.svo_from_numpy(ref, "cpu")
    return ref, jax_brick.make_brick_svo(ref), svo, brick.make_brick_svo(svo)


def _trace(bsvo, o, d):
    return brick.trace_brick(bsvo, torch.from_numpy(o), torch.from_numpy(d),
                             with_stats=True)


def _jax_trace(ref_bsvo, o, d):
    return jax_brick.trace_brick_jax(ref_bsvo.device(), jnp.asarray(o), jnp.asarray(d))


def assert_dda_cap_never_reached(stats):
    """An 8^3 brick needs at most 22 DDA steps (7 moves on each axis and
    the step that leaves); the round's cap of 30 never binds."""
    assert int(stats[:, STAT("dda_max")].max()) <= 22 < brick.DDA_ROUND_STEPS


@pytest.mark.parametrize("kind", ["camera", "random", "inside"])
@pytest.mark.parametrize("name,depth", SCENES)
def test_brick_matches_reference_and_oracle(name, depth, kind):
    ref_svo, ref_bsvo, _svo, bsvo = _bricks(name, depth)
    o, d = make_rays(kind, seed=depth)
    ours, stats = _trace(bsvo, o, d)
    assert_matches_jax(ours, _jax_trace(ref_bsvo, o, d), o, d,
                       iters_parting=ITERS_PARTING)
    assert_matches_oracle(ours, jax_traverse.trace_numpy(ref_svo, o, d), d,
                          names=("hit_leaf",))
    assert int((ours.hit_leaf >= 0).sum()) > 100
    assert int(stats[:, STAT("unfinished")].sum()) == 0
    assert int(stats[:, STAT("top_capped")].sum()) == 0
    assert_dda_cap_never_reached(stats)
    # the statistics add up: a ray's steps are its top steps and DDA steps,
    # and a ray that enters the root cube begins at least one round
    walked = ours.iters > 0
    assert bool((stats[:, STAT("dda_steps")] <= ours.iters).all())
    assert bool((stats[walked, STAT("rounds")] >= 1).all())
    assert bool((stats[:, STAT("dda_max")] <= stats[:, STAT("dda_steps")]).all())


@pytest.mark.parametrize("name,depth", [("sphere", 4), ("terrain", 7)])
def test_brick_depth_four_and_seven(name, depth):
    """Depth 4 leaves a top tree of one level (top_depth 1); depth 7 is the
    deepest tree the tests take."""
    ref_svo, ref_bsvo, svo, bsvo = _bricks(name, depth)
    assert bsvo.top_depth == depth - brick.BRICK_LEVELS
    o, d = make_rays("camera", seed=depth)
    ours, stats = _trace(bsvo, o, d)
    assert_matches_jax(ours, _jax_trace(ref_bsvo, o, d), o, d,
                       iters_parting=ITERS_PARTING)
    assert_matches_oracle(ours, jax_traverse.trace_numpy(ref_svo, o, d), d,
                          names=("hit_leaf",))
    assert_dda_cap_never_reached(stats)
    # the same hits as the stackless trace of the source tree
    flat = traverse.trace_stackless(svo, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(ours.hit_leaf, flat.hit_leaf)
    assert torch.equal(ours.hit_t.view(torch.int32), flat.hit_t.view(torch.int32))


def test_brick_empty_scene():
    """No leaf at all: the bricks table holds one zero row, every ray
    misses."""
    empty = JaxScene(name="air", lipschitz=1.0,
                     fn=lambda x, y, z, xp=np: xp.ones_like(x))
    _ref, ref_bsvo, _svo, bsvo = _bricks("air", 5, scene=empty)
    assert tuple(bsvo.bricks.shape) == (1, 17) and not bool(bsvo.bricks.any())
    o, d = make_rays("camera", seed=0)
    ours, stats = _trace(bsvo, o, d)
    assert_matches_jax(ours, _jax_trace(ref_bsvo, o, d), o, d)
    assert bool((ours.hit_leaf == -1).all())
    assert int(stats[:, STAT("dda_steps")].sum()) == 0


def test_brick_top_cap_binds(monkeypatch):
    """With a round's top walk cut to 4 steps, rays need more rounds in
    both packages (the reference's round then ends for the whole batch),
    and the hits and step counts stay the reference's."""
    ref_svo, ref_bsvo, _svo, bsvo = _bricks("terrain", 6)
    o, d = make_rays("camera", seed=0)
    o, d = o[2048:2825], d[2048:2825]  # a shape no other test traces with the patch
    _full, full_stats = _trace(bsvo, o, d)
    for mod in (jax_brick, brick):
        monkeypatch.setattr(mod, "max_iters_for_depth", lambda depth: 4)
    try:
        ref = _jax_trace(ref_bsvo, o, d)
        ours, stats = _trace(bsvo, o, d)
    finally:
        jax.clear_caches()
    assert_matches_jax(ours, ref, o, d, iters_parting=ITERS_PARTING)
    assert int((stats[:, STAT("top_capped")] > 0).sum()) > 100
    assert int(stats[:, STAT("unfinished")].sum()) == 0
    assert int(stats[:, STAT("rounds")].sum()) > int(full_stats[:, STAT("rounds")].sum()) + 100


def test_brick_round_bound_binds(monkeypatch):
    """With two rounds at most, rays that need more stop unfinished; every
    ray that finishes keeps the hit and step count of the unbounded trace."""
    _ref_svo, _ref_bsvo, _svo, bsvo = _bricks("terrain", 6)
    o, d = make_rays("camera", seed=0)
    full, full_stats = _trace(bsvo, o, d)
    monkeypatch.setattr(brick, "rounds_for_depth", lambda depth: 2)
    cut, stats = _trace(bsvo, o, d)
    unfinished = stats[:, STAT("unfinished")] == 1
    assert 100 < int(unfinished.sum()) < o.shape[0]
    assert bool((full_stats[unfinished, STAT("rounds")] > 2).all())
    assert bool((stats[:, STAT("rounds")] <= 2).all())
    assert bool((cut.hit_leaf[unfinished] == -1).all())
    done = ~unfinished
    for name in INTS + ("hit_t",):
        assert torch.equal(getattr(cut, name)[done], getattr(full, name)[done]), name


def test_brick_wrapper_on_cpu_runs_the_plain_version():
    _ref, _ref_bsvo, _svo, bsvo = _bricks("terrain", 5)
    o, d = (torch.from_numpy(a) for a in make_rays("random", seed=2))
    before = dict(brick_cuda.launches)
    ours, stats = brick_cuda.trace_brick_cuda(bsvo, o, d, with_stats=True)
    plain, plain_stats = brick.trace_brick(bsvo, o, d, with_stats=True)
    assert brick_cuda.launches == before  # no kernel launch on the CPU
    for name in INTS + ("hit_t",):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name
    assert torch.equal(stats, plain_stats)
    for n in (0, 1, 999):  # any ray count
        res = brick_cuda.trace_brick_cuda(bsvo, o[:n], d[:n])
        assert torch.equal(res.hit_leaf, plain.hit_leaf[:n])


def test_brick_kernel_refuses_cpu_tensors():
    """The kernel's wrapper has no CPU path: it raises before any build."""
    _ref, _ref_bsvo, _svo, bsvo = _bricks("sphere", 4)
    with pytest.raises(ValueError, match="CUDA"):
        brick_cuda._brick_kernel(bsvo, torch.zeros((10, 3)), torch.ones((10, 3)))
