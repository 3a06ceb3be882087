"""The sharded train steps' loss and gradients against the JAX package's
steps, at 1, 2 and 4 ranks.

Each rank of a world (1 in this process; 2 and 4 spawned gloo ranks,
``tests/torch_ranks.py``) takes its shard of the rays of `terrain` at depth
6 seen by bench.py's camera at 64x64 (4096 rays, 16 tiles), and each of
``make_train_step``, ``make_train_step_brick`` and ``make_train_step_tile``
sums the ranks' gradients and loss with an all_reduce; a still optimizer
(SGD, learning rate 0) keeps the summed gradients readable. They are held
against the reference's ``loss_and_grads``, ``loss_and_grads_brick`` and
``loss_and_grads_tile`` on the whole batch, from the same perturbed
parameters and seeded target (an all_reduce sums the ranks' partial
gradients in its own order; the reference's XLA rounds its own way),
residual 0. The loss is held to F4's 1e-4. A gradient is held to F4 scaled
to its own size (``assert_grads_close``: rtol 1e-4, atol 1e-4 x its largest
magnitude): at 64x64 rays a leaf's gradient is of the order of 1e-5, so an
absolute 1e-4 would pass a reduce that halves the sum or drops a rank's
share.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)
F4 = 1e-4
RES = 64
LIGHT = np.asarray([-0.5, -1.0, -0.3], np.float32)
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0,
           width=RES, height=RES)
# the trainer's tile budgets (models.renderers.TILE_STEP_BUDGETS)
BUDGETS = dict(k_max=96, fb_tiles=128, fb_k=256)


def assert_grads_close(got, want):
    """`got` within F4 of `want`, relative to each element and to the
    largest magnitude of `want`."""
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F4, atol=F4 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
    rng = np.random.default_rng(3)
    n = ref_svo.n_leaves
    params = ((ref_svo.leaf_albedo * rng.uniform(0.5, 1.0, (n, 1))).astype(np.float32),
              (ref_svo.leaf_normal * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32),
              rng.uniform(-0.2, 1.3, n).astype(np.float32))
    o, d = (np.ascontiguousarray(a) for a in jax_camera.Camera(**CAM).rays(np))
    target = rng.random((RES * RES, 3), dtype=np.float32)
    to, td, tc, _grid = (np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a
                         for a in jax_tile.tile_rays(jax_camera.Camera(**CAM), np))
    inputs = {"scene": "terrain", "depth": 6, "light": LIGHT, "params": params,
              "flat": (o, d, target), "tiles": (to, td, tc, target), "budgets": BUDGETS}
    return ref_svo, inputs


@pytest.fixture(scope="module")
def ours(setup):
    return {w: torch_ranks.run(w, "sharding_grads", setup[1]) for w in WORLDS}


@pytest.fixture(scope="module")
def reference(setup):
    ref_svo, inputs = setup
    p = [jnp.asarray(a) for a in inputs["params"]]
    light = jnp.asarray(LIGHT)
    o, d, target = (jnp.asarray(a) for a in inputs["flat"])
    s = ref_svo.device()
    b = jax_brick.make_brick_svo(ref_svo).device()
    out = {
        "stackless": jax_diff.loss_and_grads(
            *p, s.masks, s.child_base, s.leaf_base, o, d, s.depth, light, target,
            parent_ptr=s.parent_ptr),
        "brick": jax_diff.loss_and_grads_brick(
            *p, b.top_masks, b.top_child, b.top_parent, b.bricks, o, d, b.depth,
            b.top_depth, light, target),
    }
    (loss, residual), grads = jax_diff.loss_and_grads_tile(
        *p, jax_tile.make_tile_svo(ref_svo).device(),
        *(jnp.asarray(a) for a in inputs["tiles"][:3]), light, target, **BUDGETS)
    assert int(residual) == 0
    out["tile"] = (loss, grads)
    return {k: (float(loss), [np.asarray(g) for g in grads])
            for k, (loss, grads) in out.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("step", ["stackless", "brick", "tile"])
def test_sharded_step_grads_match_reference(ours, reference, world, step):
    ref_loss, ref_grads = reference[step]
    for res in ours[world]:
        rest, grads = res[step]
        np.testing.assert_allclose(float(rest[0]), ref_loss, rtol=0, atol=F4)
        if step == "tile":
            assert int(rest[1]) == 0
        for g, g_ref in zip(grads, ref_grads):
            assert_grads_close(g, g_ref)
    # every rank holds the same sums
    for res in ours[world][1:]:
        for a, b in zip(res[step][1], ours[world][0][step][1]):
            np.testing.assert_array_equal(a, b)
