"""Level-sharded training and the ray-exchange trace against the JAX
package's.

``make_sharded_fit_step`` keeps each rank's voxel parameters with its arena:
its loss and arena gradients must match the reference's fit at the same
device count, and, mapped to the global leaf rows through
``octant_leaf_lo``, the port's one-tree step (``diff.loss_and_grads``).
``make_exchange_trace`` must give the reference's leaves, t, owners and
per-rank traced counts. Worlds of 1 (in this process), 2 and 4 (spawned
gloo ranks, ``tests/torch_ranks.py``) on CPU tensors. Tolerances: the loss
and gradients to F4's 1e-4 (an all_reduce sums in its own order); leaves,
owners and counts exactly; t to rtol 1e-5 / atol 1e-6 (F14).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.parallel import level_sharded as jax_ls
from raytracingtest_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.ops import octree
from raytracingtest_tpu_torch.parallel import level_sharded
from raytracingtest_tpu_torch.scenes import get_scene
from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_traverse import random_rays

WORLDS = (1, 2, 4)
F4 = 1e-4
LIGHT = np.asarray([-0.5, -1.0, -0.3], np.float32)
FRAYS = random_rays(256, seed=11)
TARGET = np.random.default_rng(0).random((256, 3), np.float32)
XRAYS = random_rays(512, seed=13)


@pytest.fixture(scope="module")
def builds():
    return (jax_octree.build_svo(jax_get_scene("sphere"), 6),
            octree.build_svo(get_scene("sphere"), 6))


@pytest.fixture(scope="module")
def ours():
    inputs = {"frays": FRAYS, "light": LIGHT, "target": TARGET, "xrays": XRAYS}
    return {w: torch_ranks.run(w, "level_train", inputs) for w in WORLDS}


def ref_fit(builds, n):
    ls = jax_ls.split_svo(builds[0], 2, n)
    step = jax_ls.make_sharded_fit_step(jax_make_mesh(n), ls, max_octants=6)
    args = [ls.arena_albedo, ls.arena_normal, ls.arena_density, ls.trunk_masks,
            ls.trunk_child, ls.trunk_leaf, ls.octant_owner, ls.octant_root,
            ls.octant_origin, ls.arena_masks, ls.arena_child, ls.arena_leaf,
            *FRAYS, LIGHT, TARGET]
    loss, grads = jax.jit(step)(*(jnp.asarray(a) for a in args))
    return float(loss), tuple(np.asarray(g) for g in grads)


def to_global(ls, grads_of_rank, like):
    """Each rank's arena gradients placed at the global leaf rows."""
    out = [np.zeros_like(x) for x in like]
    for i in range(len(ls.octant_owner)):
        dev, off = int(ls.octant_owner[i]), int(ls.octant_leaf_off[i])
        lo, cnt = int(ls.octant_leaf_lo[i]), int(ls.octant_n_leaves[i])
        for o, g in zip(out, grads_of_rank[dev]):
            o[lo:lo + cnt] = g[off:off + cnt]
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_reference(builds, ours, world):
    ref_loss, ref_grads = ref_fit(builds, world)
    for r, res in enumerate(ours[world]):
        np.testing.assert_allclose(res["loss"], ref_loss, rtol=0, atol=F4)
        for got, want in zip(res["grads"], ref_grads):
            np.testing.assert_allclose(got, want[r], rtol=0, atol=F4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_the_one_tree_step(builds, ours, world):
    """Loss and gradients mapped through octant_leaf_lo equal the port's
    replicated (one-tree) step."""
    svo = builds[1].svo
    t = torch.from_numpy
    loss, grads = diff.loss_and_grads(svo.leaf_albedo, svo.leaf_normal,
                                      svo.leaf_density, svo, t(FRAYS[0]),
                                      t(FRAYS[1]), t(LIGHT), t(TARGET))
    ls = level_sharded.split_svo(builds[1], 2, world)
    got = to_global(ls, [res["grads"] for res in ours[world]],
                    [g.numpy() for g in grads])
    for res in ours[world]:
        np.testing.assert_allclose(res["loss"], float(loss), rtol=0, atol=F4)
    for a, b in zip(got, grads):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=F4)
    assert any(np.abs(g).max() > 0 for g in got)


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_trace_matches_reference(builds, ours, world):
    ls = jax_ls.split_svo(builds[0], 2, world)
    fn = jax_ls.make_exchange_trace(jax_make_mesh(world), ls, max_rounds=8,
                                    cap_factor=4)
    args = [ls.trunk_masks, ls.trunk_child, ls.trunk_leaf, ls.octant_owner,
            ls.octant_root, ls.octant_origin, ls.arena_masks, ls.arena_child,
            ls.arena_leaf, *XRAYS]
    ref = tuple(np.asarray(a) for a in jax.jit(fn)(*(jnp.asarray(a) for a in args)))
    got = [np.concatenate([res["exchange"][k] for res in ours[world]])
           for k in range(5)]
    assert not got[4].any() and not ref[4].any()
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])   # traced, per rank
    hit = got[0] >= 0
    np.testing.assert_allclose(got[1][hit], ref[1][hit], rtol=1e-5, atol=1e-6)
    # the deep walks are spread over the ranks, each far below the whole
    traced = got[3]
    assert traced.sum() > 0 and (traced > 0).sum() == world
    # attribute identity through the owner's arena
    ls_ours = level_sharded.split_svo(builds[1], 2, world)
    np.testing.assert_array_equal(
        ls_ours.arena_albedo[got[2][hit], got[0][hit]],
        ls.arena_albedo[ref[2][hit], ref[0][hit]])
