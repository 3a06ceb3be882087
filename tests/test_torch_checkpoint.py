"""The port's checkpoints against the JAX package's: the raw ESVO dump
byte for byte, the fit's parameters read across both ways, and the port's
Adam state, whose round trip gives the next step bit for bit."""

import numpy as np
import pytest
import torch

from raytracingtest_tpu.io import checkpoint as jax_ckpt
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.io import checkpoint as ckpt
from raytracingtest_tpu_torch.models import InverseRenderer
from raytracingtest_tpu_torch.ops import camera, octree
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,depth", [("sphere", 5), ("terrain", 6)])
def test_esvo_binary_identical(tmp_path, name, depth):
    ours = octree.build_svo(get_scene(name), depth).svo
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    p_ours, p_ref = str(tmp_path / "ours.bin"), str(tmp_path / "ref.bin")
    ckpt.save_esvo_binary(ours, p_ours)
    jax_ckpt.save_esvo_binary(ref, p_ref)
    assert open(p_ours, "rb").read() == open(p_ref, "rb").read()
    got, want = ckpt.load_esvo_binary(p_ref), jax_ckpt.load_esvo_binary(p_ours)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[3:] == want[3:] == (depth, tuple(ours.level_start))
    # the dump holds the structure: it traces as the SVO it came from
    np.testing.assert_array_equal(got[0], ours.masks.numpy())
    np.testing.assert_array_equal(got[1], ours.child_base.numpy())
    np.testing.assert_array_equal(got[2], ours.leaf_base.numpy())


def test_esvo_binary_rejects_bad_magic(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(ValueError):
        ckpt.load_esvo_binary(str(path))


def _params(seed, n=37):
    rng = np.random.default_rng(seed)
    return {"albedo": rng.random((n, 3), dtype=np.float32),
            "normal": rng.normal(size=(n, 3)).astype(np.float32),
            "density": rng.random(n, dtype=np.float32)}


def test_jax_reads_port_params(tmp_path):
    params = {k: torch.from_numpy(v) for k, v in _params(1).items()}
    path = str(tmp_path / "ours.npz")
    ckpt.save_train_state(path, params, None, step=7, meta={"scene": "x"})
    got, opt, step = jax_ckpt.load_train_state(path)
    assert step == 7 and opt is None
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == v.numpy().tobytes()
    import json
    assert json.load(open(path + ".meta.json")) == {"step": 7, "scene": "x"}


def test_port_reads_jax_params(tmp_path):
    import jax.numpy as jnp
    import optax
    params = {k: jnp.asarray(v) for k, v in _params(2).items()}
    path = str(tmp_path / "ref.npz")
    opt = optax.adam(1e-2)
    jax_ckpt.save_train_state(path, params, opt.init(params), step=3)
    got, opt_state, step = ckpt.load_train_state(path, device="cpu")
    assert step == 3 and opt_state is None
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        assert got[k].numpy().tobytes() == np.asarray(v).tobytes()
    # optax's state is not carried into a torch optimizer
    template = torch.optim.Adam([got["albedo"].clone()], lr=1e-2)
    assert ckpt.load_train_state(path, template, device="cpu")[1] is None


@pytest.fixture(scope="module")
def fit_setup():
    svo = octree.build_svo(get_scene("sphere"), 4).svo
    cam = camera.Camera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                        fov_y_deg=45.0, width=24, height=24)
    o, d = cam.rays("cpu")
    light = torch.tensor([-0.5, -1.0, -0.3])
    target = diff.render_diff_cuda(svo.leaf_albedo, svo.leaf_normal,
                                   svo.leaf_density, svo, o, d, light)
    return svo, o, d, light, target


@pytest.mark.parametrize("optimize", [("albedo",), ("albedo", "normal")])
def test_adam_round_trip_next_step_bitwise(tmp_path, fit_setup, optimize):
    svo, o, d, light, target = fit_setup
    model = InverseRenderer(svo, optimize=optimize, device="cpu")
    params, opt = model.init_params(seed=0)
    for _ in range(2):
        params, opt, _loss = model.step(params, opt, o, d, light, target)
    path = str(tmp_path / "state.npz")
    ckpt.save_train_state(path, params, opt, step=2)
    params, opt, loss = model.step(params, opt, o, d, light, target)

    # a fresh optimizer over other values, restored from the file
    fresh, fresh_opt = model.init_params(seed=9)
    got, got_opt, step = ckpt.load_train_state(path, fresh_opt, device="cpu")
    assert step == 2 and got_opt is fresh_opt
    for name in optimize:
        assert got[name] is fresh[name]   # the optimizer trains the returned tensors
    got, got_opt, got_loss = model.step(got, got_opt, o, d, light, target)
    assert float(got_loss) == float(loss)
    for name in params:
        assert torch.equal(got[name], params[name]), name
    for p, q in zip(opt.param_groups[0]["params"], got_opt.param_groups[0]["params"]):
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][field], got_opt.state[q][field])


def test_load_refuses_a_template_of_another_shape(tmp_path, fit_setup):
    svo = fit_setup[0]
    model = InverseRenderer(svo, optimize=("albedo", "normal"), device="cpu")
    params, opt = model.init_params(seed=0)
    path = str(tmp_path / "state.npz")
    ckpt.save_train_state(path, params, opt, step=0)
    one, one_opt = InverseRenderer(svo, optimize=("albedo",), device="cpu").init_params()
    with pytest.raises(ValueError):
        ckpt.load_train_state(path, one_opt, device="cpu")
    stray = torch.optim.Adam([torch.zeros(3, requires_grad=True)])
    with pytest.raises(ValueError):
        ckpt.save_train_state(path, params, stray)
