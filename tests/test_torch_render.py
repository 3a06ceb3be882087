"""The port's forward frame against the JAX package's Pallas frame
(``diff.render_diff_pallas`` in interpret mode): same numpy rays and voxel
parameters into both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu import render as jax_render
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops.traverse_pallas import trace_pallas
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff, render
from raytracingtest_tpu_torch.ops import traverse, traverse_cuda
from tests.test_traverse import random_rays
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = np.array([-0.5, -1.0, -0.3], np.float32)

# shading sums and normalises in another order than XLA, so images agree to
# float32 rounding, not bitwise
IMG_ATOL = 1e-6


@pytest.mark.parametrize("name,depth,cam_args", [
    ("sphere", 5, dict(position=(0.5, 0.5, -0.8), look_at=(0.5, 0.5, 0.5),
                       fov_y_deg=45.0, width=64, height=16)),
    ("terrain", 6, dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                        fov_y_deg=50.0, width=64, height=32)),
])
def test_render_diff_cuda_matches_pallas_frame(name, depth, cam_args):
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    dref = ref.device()
    o, d = jax_camera.Camera(**cam_args).rays(np)
    o, d = np.ascontiguousarray(o), np.ascontiguousarray(d)
    # non-trivial parameters: perturbed albedo, unnormalised normals, and
    # densities that reach both clip bounds
    rng = np.random.default_rng(depth)
    albedo = (ref.leaf_albedo * rng.uniform(0.5, 1.0, (ref.n_leaves, 1))).astype(np.float32)
    normal = (ref.leaf_normal * rng.uniform(0.5, 2.0, (ref.n_leaves, 1))).astype(np.float32)
    density = rng.uniform(-0.2, 1.3, ref.n_leaves).astype(np.float32)

    img_ref = np.asarray(jax_diff.render_diff_pallas(
        jnp.asarray(albedo), jnp.asarray(normal), jnp.asarray(density),
        dref.masks, dref.child_base, dref.leaf_base, jnp.asarray(o),
        jnp.asarray(d), ref.depth, jnp.asarray(LIGHT), interpret=True))

    svo = convert.svo_from_numpy(ref, "cpu")
    alb, nrm, den = convert.params_from_numpy(albedo, normal, density, "cpu")
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    img = diff.render_diff_cuda(alb, nrm, den, svo, o_t, d_t,
                                torch.from_numpy(LIGHT))
    assert img.shape == (o.shape[0], 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), img_ref, rtol=0, atol=IMG_ATOL)

    # the frame's hits, exact against the Pallas kernel's
    hits = traverse_cuda.trace_cuda(svo, o_t, d_t).hit_leaf.numpy()
    pal = trace_pallas(dref, o, d, interpret=True)
    np.testing.assert_array_equal(hits, np.asarray(pal.hit_leaf))
    assert 0 < (hits >= 0).sum() < hits.size  # both hits and sky


def test_sky_color_matches():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(300, 3)).astype(np.float32) * 1.5
    ours = render.sky_color(torch.from_numpy(d)).numpy()
    ref = np.asarray(jax_render.sky_color(jnp.asarray(d), jnp))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=IMG_ATOL)
    np.testing.assert_array_equal(np.float32(render.SKY_HORIZON), jax_render.SKY_HORIZON)
    np.testing.assert_array_equal(np.float32(render.SKY_ZENITH), jax_render.SKY_ZENITH)
    assert render.Light() == render.Light(**vars(jax_render.Light()))


def test_shade_matches_jax_with_synthetic_hits():
    """Shading alone, on hand-made hit ids with misses mixed in."""
    rng = np.random.default_rng(9)
    n_leaves, n = 40, 500
    albedo = rng.random((n_leaves, 3), dtype=np.float32)
    normal = rng.normal(size=(n_leaves, 3)).astype(np.float32)
    density = rng.uniform(-0.5, 1.5, n_leaves).astype(np.float32)
    hit_leaf = rng.integers(-1, n_leaves, n).astype(np.int32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    args = (1.3, 0.08)
    ref = np.asarray(jax_diff.shade_diff(
        jnp.asarray(hit_leaf), jnp.asarray(d), jnp.asarray(albedo),
        jnp.asarray(normal), jnp.asarray(density), jnp.asarray(LIGHT), *args))
    t = torch.from_numpy
    ours = diff.shade_diff(t(hit_leaf), t(d), t(albedo), t(normal),
                           t(density), t(LIGHT), *args)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=IMG_ATOL)


def test_shade_empty_scene_is_sky():
    d = torch.tensor([[0.0, 1.0, 0.0], [0.3, -0.2, 0.9]])
    empty = torch.zeros((0, 3))
    img = diff.shade_diff(torch.full((2,), -1, dtype=torch.int32), d, empty,
                          empty, torch.zeros(0), torch.from_numpy(LIGHT), 1.3, 0.08)
    assert torch.equal(img, render.sky_color(d))


def test_gather_voxel_params_rows():
    rng = np.random.default_rng(2)
    albedo = torch.from_numpy(rng.random((6, 3), dtype=np.float32))
    normal = torch.from_numpy(rng.random((6, 3), dtype=np.float32))
    density = torch.from_numpy(rng.random(6, dtype=np.float32))
    ids = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    alb, nrm, den = diff.gather_voxel_params(albedo, normal, density, ids)
    assert torch.equal(alb, albedo[ids.long()])
    assert torch.equal(nrm, normal[ids.long()])
    assert torch.equal(den, density[ids.long()])


def test_render_diff_cuda_takes_any_ray_count():
    """100 rays, no multiple of the Pallas kernel's 1024-ray tile: the frame
    is the plain trace shaded, as for any other count."""
    ref = jax_octree.build_svo(jax_get_scene("sphere"), 5).svo
    svo = convert.svo_from_numpy(ref, "cpu")
    alb, nrm, den = convert.params_from_numpy(ref.leaf_albedo, ref.leaf_normal,
                                              ref.leaf_density, "cpu")
    o, d = (torch.from_numpy(a) for a in random_rays(100, seed=100))
    light = torch.from_numpy(LIGHT)
    img = diff.render_diff_cuda(alb, nrm, den, svo, o, d, light)
    hit_leaf = traverse.trace(svo, o, d).hit_leaf
    assert img.shape == (100, 3) and int((hit_leaf >= 0).sum()) > 0
    assert torch.equal(img, diff.shade_diff_plain(hit_leaf, d, alb, nrm, den,
                                                  light, 1.3, 0.08))
