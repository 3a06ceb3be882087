"""The port's tile training step (``diff.loss_and_grads_tile``) against the
JAX package's, and against the port's own per-ray step.

The same numpy rays, voxel parameters and target go into both packages; on
the CPU the port runs the plain versions of its kernels. Tolerances:

  * loss: rtol 1e-6. Both sum a few thousand float32 squares, in another
    order.
  * the residual count: equal. It is an integer that depends on the walks'
    hits alone, and those are equal (``tests/test_torch_tile_fb.py``).
  * gradients: rtol 1e-5, atol 1e-7, the tolerance of the reference's own
    ``test_grads_match_builtin_autodiff``. Shading normalises and sums in
    another order than XLA, which contracts multiply-adds, and a leaf's rays
    add in another order in the two traversals (row-major, tile-major).
"""

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
RTOL, ATOL = 1e-5, 1e-7
# the benchmark frame's budgets
BUDGETS = dict(k_max=96, fb_tiles=96, fb_k=160, fb2_tiles=16, fb2_split=2)
BENCH_CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
BELOW_CAM = dict(position=(0.3, -0.5, 0.2), look_at=(0.5, 0.3, 0.5), fov_y_deg=50.0)
RES = 64


class Setup:
    """A scene at depth 6 seen by a 64x64 camera, in both packages, with
    perturbed parameters (unnormalised normals, densities that reach both
    clip bounds and sit exactly on them) and a seeded random target."""

    def __init__(self, name, cam):
        self.ref_svo = jax_octree.build_svo(jax_get_scene(name), 6).svo
        self.ref_ts = jax_tile.make_tile_svo(self.ref_svo)
        self.cam_args = dict(cam, width=RES, height=RES)
        o, d, corners, self.grid = jax_tile.tile_rays(
            jax_camera.Camera(**self.cam_args), np)
        self.rays = tuple(np.ascontiguousarray(a) for a in (o, d, corners))
        rng = np.random.default_rng(6)
        n = self.ref_svo.n_leaves
        density = rng.uniform(-0.2, 1.3, n)
        density[::5], density[2::5] = 1.0, 0.0
        self.params = (
            (self.ref_svo.leaf_albedo * rng.uniform(0.5, 1.0, (n, 1))).astype(np.float32),
            (self.ref_svo.leaf_normal * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32),
            density.astype(np.float32))
        self.target = rng.random((RES * RES, 3), dtype=np.float32)  # tile-major
        self.svo = convert.svo_from_numpy(self.ref_svo, "cpu")
        self.ts = convert.tile_svo_from_numpy(self.ref_ts, "cpu")

    def jax_step(self, target, budgets):
        (loss, residual), grads = jax_diff.loss_and_grads_tile(
            *(jnp.asarray(p) for p in self.params), self.ref_ts.device(),
            *(jnp.asarray(a) for a in self.rays), jnp.asarray(LIGHT),
            jnp.asarray(target), **budgets)
        return float(loss), int(residual), [np.asarray(g) for g in grads]

    def port_step(self, target, budgets):
        (loss, residual), grads = diff.loss_and_grads_tile(
            *convert.params_from_numpy(*self.params, "cpu"), self.ts,
            *(torch.from_numpy(a) for a in self.rays), torch.from_numpy(LIGHT),
            torch.from_numpy(target), **budgets)
        assert loss.dim() == 0 and residual.dim() == 0
        return float(loss), int(residual), [g.numpy() for g in grads]


@pytest.fixture(scope="module", params=[("terrain", BENCH_CAM),
                                        ("flat_ground", BELOW_CAM)],
                ids=["terrain", "flat_ground_from_below"])
def setup(request):
    return Setup(*request.param)


@pytest.mark.parametrize("zero_target", [True, False], ids=["target0", "random"])
def test_loss_residual_and_grads_match_reference(setup, zero_target):
    target = np.zeros_like(setup.target) if zero_target else setup.target
    loss_ref, residual_ref, grads_ref = setup.jax_step(target, BUDGETS)
    loss, residual, grads = setup.port_step(target, BUDGETS)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
    assert residual == residual_ref == 0
    for g, g_ref in zip(grads, grads_ref):
        assert g.shape == g_ref.shape and g.dtype == np.float32
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, g_ref, rtol=RTOL, atol=ATOL)
    # both hits and sky, and leaves that no ray reaches
    row_mag = np.abs(grads[0]).sum(axis=1)
    assert (row_mag == 0.0).any() and (row_mag > 0.0).any()


def test_starved_budgets_return_the_residual_and_still_match(setup):
    """With budgets too small for the frame some rays stay cap-limited: the
    step returns their count, acts on nothing, and loss and gradients over
    the inexact hits still equal the reference's."""
    budgets = dict(k_max=4, fb_tiles=2, fb_k=8)
    loss_ref, residual_ref, grads_ref = setup.jax_step(setup.target, budgets)
    loss, residual, grads = setup.port_step(setup.target, budgets)
    assert residual == residual_ref and residual > 0
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        np.testing.assert_allclose(g, g_ref, rtol=RTOL, atol=ATOL)


def test_tile_step_agrees_with_per_ray_step(setup):
    """No ray is residual at the benchmark's budgets, so the two traversals
    hit the same leaves and the two steps give the same loss and
    gradients."""
    loss_t, residual, grads_t = setup.port_step(setup.target, BUDGETS)
    assert residual == 0
    o, d = camera.Camera(**setup.cam_args).rays("cpu")
    target_rows = tile.untile_image(torch.from_numpy(setup.target), setup.grid)
    loss_r, grads_r = diff.loss_and_grads_cuda(
        *convert.params_from_numpy(*setup.params, "cpu"), setup.svo, o, d,
        torch.from_numpy(LIGHT), target_rows)
    np.testing.assert_allclose(loss_t, float(loss_r), rtol=1e-6)
    for g_t, g_r in zip(grads_t, grads_r):
        np.testing.assert_allclose(g_t, g_r.numpy(), rtol=RTOL, atol=ATOL)


def test_l2_loss_tile_is_the_mean_square_of_the_tile_frame(setup):
    args = (*convert.params_from_numpy(*setup.params, "cpu"), setup.ts,
            *(torch.from_numpy(a) for a in setup.rays), torch.from_numpy(LIGHT))
    target = torch.from_numpy(setup.target)
    loss, residual = diff.l2_loss_tile(*args, target, **BUDGETS)
    img, residual_img = diff.render_diff_tile(*args, **BUDGETS)
    assert float(loss) == float(torch.mean((img - target) ** 2))
    assert int(residual) == int(residual_img) == 0
