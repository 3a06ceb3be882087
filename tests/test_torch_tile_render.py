"""The port's tile forward frame (``diff.render_diff_tile``) against the JAX
package's, and against the port's own per-ray frame: same numpy rays and
voxel parameters into each."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff
from raytracingtest_tpu_torch.ops import camera, tile
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = np.array([-0.5, -1.0, -0.3], np.float32)
# shading sums and normalises in another order than XLA, so images agree to
# float32 rounding, not bitwise (the tolerance tests/test_torch_render.py
# states for shading)
IMG_ATOL = 1e-6
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
# the benchmark frame's budgets
BUDGETS = dict(k_max=96, fb_tiles=96, fb_k=160, fb2_tiles=16, fb2_split=2)


@pytest.mark.parametrize("name,depth,res,budgets", [
    ("terrain", 7, 128, BUDGETS),
    ("sphere", 5, 64, dict(k_max=4, fb_tiles=2, fb_k=8, fb2_tiles=1)),
])
def test_render_diff_tile_matches_reference(name, depth, res, budgets):
    ref_svo = jax_octree.build_svo(jax_get_scene(name), depth).svo
    ref_ts = jax_tile.make_tile_svo(ref_svo)
    cam_args = dict(CAM, width=res, height=res)
    o, d, corners, grid = jax_tile.tile_rays(jax_camera.Camera(**cam_args), np)
    o, d, corners = (np.ascontiguousarray(a) for a in (o, d, corners))
    # non-trivial parameters: perturbed albedo, unnormalised normals, and
    # densities that reach both clip bounds
    rng = np.random.default_rng(depth)
    n = ref_svo.n_leaves
    albedo = (ref_svo.leaf_albedo * rng.uniform(0.5, 1.0, (n, 1))).astype(np.float32)
    normal = (ref_svo.leaf_normal * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    density = rng.uniform(-0.2, 1.3, n).astype(np.float32)

    img_ref, residual_ref = jax_diff.render_diff_tile(
        jnp.asarray(albedo), jnp.asarray(normal), jnp.asarray(density),
        ref_ts.device(), jnp.asarray(o), jnp.asarray(d), jnp.asarray(corners),
        jnp.asarray(LIGHT), **budgets)

    ts = convert.tile_svo_from_numpy(ref_ts, "cpu")
    svo = convert.svo_from_numpy(ref_svo, "cpu")
    params = convert.params_from_numpy(albedo, normal, density, "cpu")
    light = torch.from_numpy(LIGHT)
    o_t, d_t, c_t = (torch.from_numpy(a) for a in (o, d, corners))
    img, residual = diff.render_diff_tile(*params, ts, o_t, d_t, c_t, light,
                                          **budgets)
    assert img.shape == (res * res, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    assert int(residual) == int(residual_ref)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), rtol=0,
                               atol=IMG_ATOL)

    # the same camera through the port's per-ray frame: equal after
    # untiling, wherever the tile frame left no residual ray
    o_r, d_r = camera.Camera(**cam_args).rays("cpu")
    img_rows = diff.render_diff_cuda(*params, svo, o_r, d_r, light)
    _res, mask = tile.trace_tile_fb(ts, o_t, d_t, c_t, **budgets)
    keep = ~tile.untile_image(mask, grid)
    assert int(mask.sum()) == int(residual)
    np.testing.assert_allclose(tile.untile_image(img, grid)[keep].numpy(),
                               img_rows[keep].numpy(), rtol=0, atol=IMG_ATOL)
    hits = (_res.hit_leaf >= 0).sum()
    assert 0 < hits < res * res  # both hits and sky


def test_render_diff_tile_benchmark_budgets_leave_no_residual():
    """At the benchmark's budgets the small frame is exact: no residual ray,
    and the image equals the per-ray frame's everywhere."""
    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
    svo = convert.svo_from_numpy(ref_svo, "cpu")
    ts = tile.make_tile_svo(svo)
    cam = camera.Camera(**CAM, width=64, height=64)
    o, d, c, grid = tile.tile_rays(cam, "cpu")
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    light = torch.from_numpy(LIGHT)
    img, residual = diff.render_diff_tile(*params, ts, o, d, c, light, **BUDGETS)
    assert int(residual) == 0
    o_r, d_r = cam.rays("cpu")
    img_rows = diff.render_diff_cuda(*params, svo, o_r, d_r, light)
    np.testing.assert_allclose(tile.untile_image(img, grid).numpy(),
                               img_rows.numpy(), rtol=0, atol=IMG_ATOL)
