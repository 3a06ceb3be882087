"""Ray-sharded rendering and training (``parallel/render_sharded.py``,
``InverseRenderer(n_devices=)``) against the JAX package's and against the
port's one-device frames and steps.

Worlds of 1 (in this process) and 2 (spawned gloo ranks,
``tests/torch_ranks.py``), on CPU tensors; the reference runs on a mesh of
as many of conftest's CPU devices. A rank renders and trains on its
contiguous shard of the rays; the shards' images concatenated are the
one-device image, bit for bit. Tolerances:

  * images against the reference: rtol 1e-5 / atol 1e-6, as its own test;
  * gradients and loss against the one-device step: F4's 1e-4, a
    gradient's scaled to its largest magnitude
    (``test_torch_sharding_grads.assert_grads_close``; an all_reduce sums in
    its own order; at world 1 the bits are equal);
  * the brick step against the stackless step: equal (the same hits); the
    tile step against both: 1e-6, as the reference's own tests;
  * parameters after Adam steps against the reference's optax steps: atol
    2e-6 after one step (``tests/test_torch_trainer.py`` says why), 1e-6 a
    step after the model's four; losses rtol 1e-5. Against the one-device
    model: 2e-6, and equal at world 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from raytracingtest_tpu.config import CameraConfig as JaxCameraConfig
from raytracingtest_tpu.models import InverseRenderer as JaxInverseRenderer
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracingtest_tpu.parallel.render_sharded import (
    make_train_step as jax_make_train_step, render_sharded as jax_render_sharded)
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.config import CameraConfig
from raytracingtest_tpu_torch.models import InverseRenderer
from raytracingtest_tpu_torch.ops import tile
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.ops.octree import build_svo
from raytracingtest_tpu_torch.scenes import get_scene
from tests import torch_ranks
from tests.test_torch_sharding_grads import assert_grads_close
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLDS = (1, 2)
F4 = 1e-4
PARAM_ATOL = 2e-6
NAMES = ("albedo", "normal", "density")
LIGHT = np.asarray([-0.5, -1.0, -0.3], np.float32)
TERRAIN_CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)


def _np(t):
    return t.detach().numpy()


def _inputs():
    sphere_cam = Camera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                        fov_y_deg=45.0, width=32, height=32)
    o, d = (_np(t) for t in sphere_cam.rays("cpu"))
    target = np.random.default_rng(1).random((o.shape[0], 3), dtype=np.float32)
    # rays from one point (the reference's brick-step test)
    rng = np.random.default_rng(0)
    n = 4096
    po = np.tile(np.asarray([[0.5, 0.85, -0.6]], np.float32), (n, 1))
    pd = rng.standard_normal((n, 3)).astype(np.float32)
    pd[:, 2] = np.abs(pd[:, 2]) + 0.3
    pd /= np.linalg.norm(pd, axis=1, keepdims=True)
    to, td, tc, _grid = (_np(t) if isinstance(t, torch.Tensor) else t for t in
                         tile.tile_rays(Camera(**TERRAIN_CAM, width=64, height=64), "cpu"))
    ro, rd, rc, _grid = (_np(t) if isinstance(t, torch.Tensor) else t for t in
                         tile.tile_rays(Camera(**TERRAIN_CAM, width=128, height=128), "cpu"))
    mo, md = (_np(t) for t in Camera(**TERRAIN_CAM, width=40, height=24).rays("cpu"))
    return {
        "light": LIGHT,
        "sphere": (o, d, target),
        "point": (po, pd, np.zeros((n, 3), np.float32)),
        "tiles": (to, td, tc, np.zeros((to.shape[0] * to.shape[1], 3), np.float32)),
        "tiles128": (ro, rd, rc),
        "view": dict(TERRAIN_CAM, width=64, height=64),
        "view_target": np.random.default_rng(4).random((64 * 64, 3), dtype=np.float32),
        "model_rays": (mo, md, np.random.default_rng(5).random((mo.shape[0], 3),
                                                               dtype=np.float32)),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ours():
    return {w: torch_ranks.run(w, "sharding", INPUTS) for w in WORLDS}


def gathered(ours, world, key):
    return np.concatenate([r[key] for r in ours[world]])


@pytest.fixture(scope="module")
def trees():
    return {name: build_svo(get_scene(s), depth).svo
            for name, s, depth in (("s4", "sphere", 4), ("s5", "sphere", 5),
                                   ("t6", "terrain", 6))}


@pytest.mark.parametrize("world", WORLDS)
def test_render_sharded_matches_one_device_and_reference(ours, trees, world):
    svo = trees["s4"]
    o, d, _ = INPUTS["sphere"]
    one = diff.render_diff(svo.leaf_albedo, svo.leaf_normal, svo.leaf_density, svo,
                           torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(LIGHT))
    got = gathered(ours, world, "render")
    np.testing.assert_array_equal(got, _np(one))
    ref_svo = jax_octree.build_svo(jax_get_scene("sphere"), 4).svo.device()
    ref = jax_render_sharded(
        jax_make_mesh(world), jnp.asarray(ref_svo.leaf_albedo),
        jnp.asarray(ref_svo.leaf_normal), jnp.asarray(ref_svo.leaf_density),
        ref_svo.masks, ref_svo.child_base, ref_svo.leaf_base, jnp.asarray(o),
        jnp.asarray(d), ref_svo.depth, jnp.asarray(LIGHT))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_one_device_and_reference(ours, trees, world):
    svo = trees["s4"]
    o, d, target = (torch.from_numpy(a) for a in INPUTS["sphere"])
    loss, grads = diff.loss_and_grads(svo.leaf_albedo, svo.leaf_normal,
                                      svo.leaf_density, svo, o, d,
                                      torch.from_numpy(LIGHT), target)
    for r in ours[world]:
        (got_loss,), got_grads = r["step_grads"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=0, atol=F4)
        for a, b in zip(got_grads, grads):
            assert_grads_close(a, _np(b))
        if world == 1:
            assert float(got_loss) == float(loss)
            assert all(np.array_equal(a, _np(b)) for a, b in zip(got_grads, grads))
    # one Adam step against the reference's optax step
    ref_svo = jax_octree.build_svo(jax_get_scene("sphere"), 4).svo.device()
    params = {k: jnp.asarray(getattr(ref_svo, "leaf_" + k)) for k in NAMES}
    opt = optax.adam(1e-2)
    ref_params, _, ref_loss = jax_make_train_step(jax_make_mesh(world), ref_svo.depth, opt)(
        params, opt.init(params), ref_svo.masks, ref_svo.child_base,
        ref_svo.leaf_base, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(LIGHT), jnp.asarray(target.numpy()))
    for r in ours[world]:
        np.testing.assert_allclose(float(r["step_loss"]), float(ref_loss), rtol=1e-5)
        for k in NAMES:
            np.testing.assert_allclose(r["step_params"][k], np.asarray(ref_params[k]),
                                       rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_brick_train_step_matches_plain(ours, world):
    """The same hits: the brick step's loss and updated parameters equal
    the stackless step's."""
    for r in ours[world]:
        assert float(r["plain_loss"]) == float(r["brick_loss"])
        for k in NAMES:
            np.testing.assert_array_equal(r["plain_params"][k], r["brick_params"][k])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("form,other", [("tile", "flat"), ("tile2", "tile"),
                                        ("starved", "brick6")])
def test_tile_train_step_matches(ours, world, form, other):
    """The tile step against the stackless step on the same tile-major
    rays; in two overlapped groups against one; with k_max = 8 (the main
    walk drops candidates everywhere, the re-walk restores them) against
    the brick step. Residual 0 each."""
    for r in ours[world]:
        assert int(r[f"{form}_resid"]) == 0
        assert abs(float(r[f"{form}_loss"]) - float(r[f"{other}_loss"])) < 1e-6
        for k in NAMES:
            np.testing.assert_allclose(r[f"{form}_params"][k], r[f"{other}_params"][k],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_tile_train_step_grads_match_one_device(ours, trees, world):
    svo = trees["t6"]
    ts = tile.make_tile_svo(svo)
    to, td, tc, tt = (torch.from_numpy(a) for a in INPUTS["tiles"])
    for form, kw in (("tile", dict(fb_tiles=16, fb_k=512)),
                     ("starved", dict(k_max=8, fb_tiles=16, fb_k=512))):
        (loss, resid), grads = diff.loss_and_grads_tile(
            svo.leaf_albedo, svo.leaf_normal, svo.leaf_density, ts, to, td, tc,
            torch.from_numpy(LIGHT), tt, **dict(dict(k_max=96), **kw))
        for r in ours[world]:
            (got_loss, got_resid), got_grads = r[f"{form}_grads"]
            assert int(got_resid) == int(resid) == 0
            np.testing.assert_allclose(got_loss, float(loss), rtol=0, atol=F4)
            for a, b in zip(got_grads, grads):
                assert_grads_close(a, _np(b))


@pytest.mark.parametrize("world", WORLDS)
def test_tile_sharded_render_matches_single(ours, trees, world):
    svo = trees["t6"]
    ro, rd, rc = (torch.from_numpy(a) for a in INPUTS["tiles128"])
    img, res = diff.render_diff_tile(svo.leaf_albedo, svo.leaf_normal,
                                     svo.leaf_density, tile.make_tile_svo(svo), ro,
                                     rd, rc, torch.from_numpy(LIGHT), k_max=96,
                                     fb_tiles=16, fb_k=64)
    got = np.concatenate([r["tile_render"][0] for r in ours[world]])
    np.testing.assert_array_equal(got, _np(img))
    assert sum(int(r["tile_render"][1].sum()) for r in ours[world]) == int(res)


@pytest.mark.parametrize("world", WORLDS)
def test_inverse_renderer_sharded_matches_one_device_and_reference(ours, trees, world):
    """InverseRenderer(n_devices=world): two step_view (the tile route) and
    two step (the brick route) against the one-device model and against the
    reference's model on a mesh of as many devices."""
    svo = trees["t6"]
    one = InverseRenderer(svo, optimize=("albedo",), device="cpu")
    params, state = one.init_params(seed=0)
    view = CameraConfig(**INPUTS["view"])
    losses = []
    for _ in range(2):
        params, state, loss, resid = one.step_view(params, state, view, LIGHT,
                                                   INPUTS["view_target"])
        losses.append((float(loss), int(resid)))
    mo, md, mt = (torch.from_numpy(a) for a in INPUTS["model_rays"])
    for _ in range(2):
        params, state, loss = one.step(params, state, mo, md, LIGHT, mt)
        losses.append((float(loss), 0))

    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
    ref = JaxInverseRenderer(ref_svo.device(), optimize=("albedo",), n_devices=world)
    rp, rs = ref.init_params(seed=0)
    ref_losses = []
    light = jnp.asarray(LIGHT)
    for _ in range(2):
        rp, rs, loss, resid = ref.step_view(rp, rs, JaxCameraConfig(**INPUTS["view"]),
                                            light, INPUTS["view_target"])
        ref_losses.append((float(loss), int(resid)))
    o_s, d_s, t_s = ref.shard_rays(*INPUTS["model_rays"])
    for _ in range(2):
        rp, rs, loss = ref.step(rp, rs, o_s, d_s, light, t_s)
        ref_losses.append((float(loss), 0))

    for r in ours[world]:
        for (got, g_res), (want, w_res), (ref_l, r_res) in zip(
                r["model_losses"], losses, ref_losses):
            assert g_res == w_res == r_res == 0
            np.testing.assert_allclose(got, want, rtol=0, atol=F4)
            np.testing.assert_allclose(got, ref_l, rtol=1e-5)
        for k in NAMES:
            np.testing.assert_allclose(r["model_params"][k], _np(params[k]),
                                       rtol=0, atol=PARAM_ATOL)
            if world == 1:
                np.testing.assert_array_equal(r["model_params"][k], _np(params[k]))
            np.testing.assert_allclose(r["model_params"][k], np.asarray(rp[k]),
                                       rtol=0, atol=len(losses) * 1e-6)
