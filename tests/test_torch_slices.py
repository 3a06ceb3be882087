"""Slice-based incremental construction (``stream/slices.py``) against the
JAX package's: the port of ``tests/test_slices.py``, plus both packages
held byte for byte. An extended tree is a fresh deeper build, byte for byte
(the SVO, its parent pointers and the BuildResult's coordinates), in both
packages; the occupancy pyramid is the reference's, level for level."""

import numpy as np
import pytest

from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from raytracingtest_tpu.stream import slices as jax_slices

from raytracingtest_tpu_torch.ops.morton import morton_decode
from raytracingtest_tpu_torch.ops.octree import build_svo
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.stream.slices import extend_svo, occupancy_pyramid
from tests.test_torch_build import assert_svo_identical
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def assert_result_identical(ours, ref, candidates=True):
    """The SVO (parent pointers where both carry them) and every
    coordinate array of two BuildResults, byte for byte; with `candidates`,
    the per-level candidate counts too (an extension keeps the counts of
    the build it extends, so they are a fresh build's only at its new
    level)."""
    assert_svo_identical(ours.svo, ref.svo)
    for name in ("leaf_coords", "frontier_coords"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    if candidates:
        assert ours.n_candidates == ref.n_candidates
    else:
        assert ours.n_candidates[-1] == ref.n_candidates[-1]
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(ours.node_coords, ref.node_coords))


@pytest.mark.parametrize("name", ["sphere", "flat_ground", "terrain"])
def test_pyramid_matches_builder_leaves(name):
    depth = 4
    pyr = occupancy_pyramid(get_scene(name), depth)
    assert len(pyr) == depth + 1 and pyr[0].shape == (1,)
    res = build_svo(get_scene(name), depth)
    x, y, z = morton_decode(np.nonzero(pyr[depth])[0].astype(np.uint32))
    assert set(zip(x.tolist(), y.tolist(), z.tolist())) == set(map(tuple, res.leaf_coords.tolist()))
    ref = jax_slices.occupancy_pyramid(jax_get_scene(name), depth)
    for a, b in zip(pyr, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pyramid_downsample_is_or():
    pyr = occupancy_pyramid(get_scene("sphere"), 4)
    for level in range(4):
        np.testing.assert_array_equal(pyr[level], pyr[level + 1].reshape(-1, 8).any(axis=1))
    assert pyr[0][0]


@pytest.mark.parametrize("name", ["sphere", "flat_ground", "rotated_cuboid", "terrain"])
@pytest.mark.parametrize("depth", [2, 4])
def test_extend_equals_fresh_build(name, depth):
    """AddSlice parity: a depth-k build plus one slice is the depth-(k+1)
    build, byte for byte, and the reference's extension too."""
    extended = extend_svo(build_svo(get_scene(name), depth), get_scene(name))
    assert_result_identical(extended, build_svo(get_scene(name), depth + 1),
                            candidates=False)
    ref = jax_slices.extend_svo(jax_octree.build_svo(jax_get_scene(name), depth),
                                jax_get_scene(name))
    assert_result_identical(extended, ref)


def test_extend_chain():
    """Appends from depth 2 to 5 stay equal to fresh builds."""
    r = build_svo(get_scene("sphere"), 2)
    for depth in range(3, 6):
        r = extend_svo(r, get_scene("sphere"))
        assert_result_identical(r, build_svo(get_scene("sphere"), depth),
                                candidates=False)
