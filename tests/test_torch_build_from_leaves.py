"""The port's bottom-up Morton builder (octree.build_from_leaves) against the
JAX package's: every array byte-identical, on shuffled leaves of host
builds, on bad input, and on the empty and single-leaf trees."""

import numpy as np
import pytest
import torch

import raytracingtest_tpu as jrt
from raytracingtest_tpu.ops.octree import build_from_leaves as jax_from_leaves

from raytracingtest_tpu_torch.ops import octree, traverse
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_build import assert_svo_identical
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("scene,depth", [("sphere", 5), ("terrain", 6)])
def test_matches_jax_on_shuffled_leaves(scene, depth):
    res = jrt.build_svo(jrt.get_scene(scene), depth)
    perm = np.random.default_rng(0).permutation(res.leaf_coords.shape[0])
    attrs = dict(albedo=np.asarray(res.svo.leaf_albedo)[perm],
                 normal=np.asarray(res.svo.leaf_normal)[perm],
                 density=np.asarray(res.svo.leaf_density)[perm])
    ours = octree.build_from_leaves(res.leaf_coords[perm], depth, **attrs)
    assert_svo_identical(ours, jax_from_leaves(res.leaf_coords[perm], depth,
                                               **attrs))
    # and the top-down builder's layout, the port's own included
    assert_svo_identical(ours, res.svo)
    assert_svo_identical(ours, octree.build_svo(get_scene(scene), depth).svo)


def test_default_attributes_match_jax():
    res = jrt.build_svo(jrt.get_scene("sphere"), 5)
    ours = octree.build_from_leaves(res.leaf_coords, 5)
    assert_svo_identical(ours, jax_from_leaves(res.leaf_coords, 5))
    assert torch.equal(ours.leaf_normal[:, 1], torch.ones(ours.n_leaves))


def test_traces_as_the_top_down_build():
    host = octree.build_svo(get_scene("sphere"), 5).svo
    res = jrt.build_svo(jrt.get_scene("sphere"), 5)
    ours = octree.build_from_leaves(res.leaf_coords, 5)
    rng = np.random.default_rng(1)
    v = rng.normal(size=(128, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = torch.from_numpy((0.5 + 2 * v).astype(np.float32))
    d = torch.from_numpy((-v).astype(np.float32))
    a, b = traverse.trace(host, o, d), traverse.trace(ours, o, d)
    assert torch.equal(a.hit_leaf, b.hit_leaf)
    assert torch.equal(a.hit_t.view(torch.int32), b.hit_t.view(torch.int32))


@pytest.mark.parametrize("coords,depth", [
    (np.array([[0, 0, 0], [0, 0, 0]]), 3),   # duplicate
    (np.array([[8, 0, 0]]), 3),              # out of range
    (np.array([[0, 0, 0]]), 0),              # no level
])
def test_rejects_bad_input(coords, depth):
    with pytest.raises(ValueError):
        jax_from_leaves(coords, depth)
    with pytest.raises(ValueError):
        octree.build_from_leaves(coords, depth)


def test_empty_and_single_match_jax():
    empty = np.zeros((0, 3), np.int64)
    ours = octree.build_from_leaves(empty, 3)
    assert ours.n_leaves == 0 and ours.n_nodes == 1
    assert_svo_identical(ours, jax_from_leaves(empty, 3))
    r = traverse.trace(ours, torch.tensor([[0.5, 0.5, -1.0]]),
                       torch.tensor([[0.0, 0.0, 1.0]]))
    assert int(r.hit_leaf[0]) == -1
    one = np.array([[3, 4, 5]])
    ours1 = octree.build_from_leaves(one, 3)
    assert ours1.n_leaves == 1
    assert_svo_identical(ours1, jax_from_leaves(one, 3))
