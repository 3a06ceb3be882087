"""The port's ``InverseRenderer`` against the JAX package's: the same
starting parameters, the same views and targets, a few Adam steps each.

The reference trains on a one-device mesh here; the port trains on the CPU
(``device="cpu"``), where its kernels' wrappers run their plain versions.
Tolerances:

  * starting parameters: equal. Both draw them from numpy's generator.
  * parameters after 1 and after 3 steps: atol 2e-6. The gradients agree to
    rtol 1e-5 (``tests/test_torch_train_tile.py``), Adam divides the
    gradient by its own magnitude, so a step is the learning rate (5e-2)
    times a number the two agree on to about 1e-5, and optax and
    ``torch.optim.Adam`` round the bias corrections and the division in
    another order.
  * frozen parameters: bit-unchanged.
  * loss: rtol 1e-5 (it is computed from parameters that agree to 2e-6).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from raytracingtest_tpu.config import CameraConfig as JaxCameraConfig
from raytracingtest_tpu.models import InverseRenderer as JaxInverseRenderer
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff
from raytracingtest_tpu_torch.config import CameraConfig
from raytracingtest_tpu_torch.models import InverseRenderer
from raytracingtest_tpu_torch.models.renderers import _accel_of
from raytracingtest_tpu_torch.ops import camera, shade_cuda, tile_cuda
from raytracingtest_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = (-0.5, -1.0, -0.3)
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
PARAM_ATOL = 2e-6
NAMES = ("albedo", "normal", "density")


@pytest.fixture(scope="module")
def scene():
    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
    return ref_svo, convert.svo_from_numpy(ref_svo, "cpu")


def scene_image(svo, cam_args):
    """The scene's own (H*W, 3) image, row-major: the target of the fit."""
    o, d = camera.Camera(**cam_args).rays("cpu")
    img = diff.render_diff_cuda(svo.leaf_albedo, svo.leaf_normal,
                                svo.leaf_density, svo, o, d, torch.tensor(LIGHT))
    return img.numpy()


def as_numpy(params):
    return {k: np.array(v) for k, v in params.items()}


def run_both(scene, cam_args, steps, optimize=("albedo",), randomize=("albedo",),
             black_target=False):
    """Both trainers from init_params(seed=0) through `steps` step_view
    calls, towards the scene's own image or a black one; returns per step
    (reference params, port params, reference loss, port loss, reference
    residual, port residual), and the starting parameters of both."""
    ref_svo, svo = scene
    target = scene_image(svo, cam_args)
    if black_target:
        target = np.zeros_like(target)
    ref_model = JaxInverseRenderer(ref_svo.device(), optimize=optimize, n_devices=1)
    model = InverseRenderer(svo, optimize=optimize, device="cpu")
    ref_params, ref_state = ref_model.init_params(seed=0, randomize=randomize)
    params, state = model.init_params(seed=0, randomize=randomize)
    start = as_numpy(ref_params), {k: v.clone().numpy() for k, v in params.items()}
    light = jnp.asarray(LIGHT, jnp.float32)
    out = []
    for _ in range(steps):
        ref_params, ref_state, ref_loss, ref_res = ref_model.step_view(
            ref_params, ref_state, JaxCameraConfig(**cam_args), light, target)
        params, state, loss, res = model.step_view(
            params, state, CameraConfig(**cam_args), LIGHT, target)
        out.append((as_numpy(ref_params),
                    {k: v.clone().numpy() for k, v in params.items()},
                    float(ref_loss), float(loss), int(ref_res), int(res)))
    return start, out


@pytest.mark.parametrize("res", [32, 64])
def test_step_view_tracks_the_reference(scene, res):
    before = (tile_cuda.launches, dict(shade_cuda.launches))
    (ref_start, start), steps = run_both(scene, dict(CAM, width=res, height=res), 3)
    for name in NAMES:
        np.testing.assert_array_equal(start[name], ref_start[name])
    assert not np.array_equal(start["albedo"], scene[0].leaf_albedo)
    losses = []
    for i, (ref_p, p, ref_loss, loss, ref_res, n_res) in enumerate(steps):
        assert ref_res == n_res == 0
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        losses.append(loss)
        if i in (0, 2):
            np.testing.assert_allclose(p["albedo"], ref_p["albedo"], rtol=0,
                                       atol=PARAM_ATOL)
        for name in ("normal", "density"):  # frozen
            np.testing.assert_array_equal(p[name], start[name])
            np.testing.assert_array_equal(ref_p[name], start[name])
    assert losses[0] > losses[1] > losses[2] > 0.0
    moved = np.abs(steps[2][1]["albedo"] - start["albedo"]).max(axis=1) > 0
    assert moved.any() and not moved.all()  # only the leaves some ray hit
    assert (tile_cuda.launches, shade_cuda.launches) == before  # CPU: no launch


def test_step_view_trains_density_from_its_clip_bound(scene):
    """Every leaf's density starts at exactly 1.0, the upper bound of the
    clip: half the cotangent passes in both packages, so the first step
    moves density alike."""
    (_ref_start, start), steps = run_both(
        scene, dict(CAM, width=32, height=32), 1, optimize=("density",),
        randomize=(), black_target=True)
    assert (start["density"] == 1.0).all()
    ref_p, p, ref_loss, loss, ref_res, n_res = steps[0]
    assert ref_res == n_res == 0
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(p["density"], ref_p["density"], rtol=0,
                               atol=PARAM_ATOL)
    assert (p["density"] != 1.0).any()
    for name in ("albedo", "normal"):
        np.testing.assert_array_equal(p[name], start[name])


def test_step_view_falls_back_to_the_flat_step(scene):
    """A width that is no multiple of 16 takes ``step`` (the brick step, as
    the reference's does): residual 0 by definition, parameters as the
    reference's."""
    (_ref_start, _start), steps = run_both(
        scene, dict(CAM, width=8, height=128), 1)
    ref_p, p, ref_loss, loss, ref_res, n_res = steps[0]
    assert ref_res == n_res == 0
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(p["albedo"], ref_p["albedo"], rtol=0,
                               atol=PARAM_ATOL)


def test_step_view_trains_any_ray_count(scene):
    """A 24 x 24 view: 576 rays, no multiple of 16 (so ``step``) nor of the
    Pallas kernel's 1024-ray tile. The reference trains on it; so must the
    port, with the loss and parameters the reference's step gives."""
    (_ref_start, _start), steps = run_both(
        scene, dict(CAM, width=24, height=24), 1)
    ref_p, p, ref_loss, loss, ref_res, n_res = steps[0]
    assert ref_res == n_res == 0
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(p["albedo"], ref_p["albedo"], rtol=0,
                               atol=PARAM_ATOL)
    assert loss > 0.0


def test_step_updates_in_place_and_returns_the_same_objects(scene):
    _ref_svo, svo = scene
    model = InverseRenderer(svo, optimize=("albedo", "density"), device="cpu")
    params, state = model.init_params(seed=1, randomize=("albedo", "density"))
    o, d = camera.Camera(**CAM, width=32, height=32).rays("cpu")
    target = torch.zeros((o.shape[0], 3))
    old = {k: v.clone() for k, v in params.items()}
    params2, state2, loss = model.step(params, state, o, d, LIGHT, target)
    assert params2 is params and state2 is state and loss.dim() == 0
    assert not torch.equal(params["albedo"], old["albedo"])
    assert not torch.equal(params["density"], old["density"])
    assert torch.equal(params["normal"], old["normal"])


def test_constructor_contract(scene, monkeypatch):
    _ref_svo, svo = scene
    # two devices need a world of two ranks (parallel/mesh.py); none is started
    with pytest.raises(ValueError, match="n_devices=2"):
        InverseRenderer(svo, n_devices=2, device="cpu")
    with pytest.raises(ValueError):
        InverseRenderer(svo, optimize=("colour",), device="cpu")
    # no device named and no card: an error, never a silent CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        InverseRenderer(svo)
    # n_devices named: the sharded route, over a world of one started here
    model = InverseRenderer(svo, n_devices=1, device="cpu")
    try:
        assert model.mesh is not None and model.mesh.world == 1
    finally:
        dist.destroy_process_group()
    # a world of one started by someone else leaves the default on one device
    make_mesh(1, "cpu")
    try:
        assert InverseRenderer(svo, device="cpu").mesh is None
    finally:
        dist.destroy_process_group()


def test_accel_cache_is_keyed_by_svo_identity(scene):
    _ref_svo, svo = scene
    model = InverseRenderer(svo, device="cpu")
    first = _accel_of(model)
    assert first[0] is not None and first[1] is not None
    assert _accel_of(model)[1] is first[1]
    shallow = convert.svo_from_numpy(
        jax_octree.build_svo(jax_get_scene("sphere"), 3).svo, "cpu")
    model.svo = shallow
    assert _accel_of(model) == (None, None)  # too shallow for bricks


def _step_both(ref_svo, svo, cam_args, monkeypatch):
    """One ``step`` of each trainer on the view's flat batch of rays
    towards a seeded target, counting which of the port's two steps ran;
    returns (reference params, port params, reference loss, port loss,
    calls by route)."""
    calls = {"loss_and_grads_brick": 0, "loss_and_grads": 0}
    for name in calls:
        fn = getattr(diff, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(diff, name, counted)
    o, d = camera.Camera(**cam_args).rays("cpu")
    target = np.random.default_rng(5).random((o.shape[0], 3), dtype=np.float32)
    ref_model = JaxInverseRenderer(ref_svo.device(), n_devices=1)
    model = InverseRenderer(svo, device="cpu")
    ref_params, ref_state = ref_model.init_params(seed=0)
    params, state = model.init_params(seed=0)
    o_s, d_s, t_s = ref_model.shard_rays(o.numpy(), d.numpy(), target)
    ref_params, ref_state, ref_loss = ref_model.step(
        ref_params, ref_state, o_s, d_s, jnp.asarray(LIGHT, jnp.float32), t_s)
    params, state, loss = model.step(params, state, o, d, LIGHT,
                                     torch.from_numpy(target))
    return as_numpy(ref_params), as_numpy(params), float(ref_loss), float(loss), calls


def test_step_takes_the_brick_route(scene, monkeypatch):
    """A tree with bricks (depth >= 4): ``step`` goes through the brick
    trace, as the reference's does, and lands where the reference's step
    does."""
    ref_svo, svo = scene
    ref_p, p, ref_loss, loss, calls = _step_both(
        ref_svo, svo, dict(CAM, width=40, height=24), monkeypatch)
    assert calls == {"loss_and_grads_brick": 1, "loss_and_grads": 0}
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(p["albedo"], ref_p["albedo"], rtol=0, atol=PARAM_ATOL)


def test_step_takes_the_stackless_route_on_a_shallow_tree(monkeypatch):
    """A depth-3 tree has no bricks: ``step`` goes through the stackless
    trace, as the reference's does."""
    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 3).svo
    svo = convert.svo_from_numpy(ref_svo, "cpu")
    ref_p, p, ref_loss, loss, calls = _step_both(
        ref_svo, svo, dict(CAM, width=40, height=24), monkeypatch)
    assert calls == {"loss_and_grads_brick": 0, "loss_and_grads": 1}
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(p["albedo"], ref_p["albedo"], rtol=0, atol=PARAM_ATOL)
    moved = np.abs(p["albedo"] - as_numpy(InverseRenderer(
        svo, device="cpu").init_params(seed=0)[0])["albedo"]).max(axis=1) > 0
    assert moved.any()
