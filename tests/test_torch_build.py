"""The port's host side against the JAX package: noise, SVO build,
checkpoints, camera rays, and the package's independence from JAX.

Inputs come from numpy seeds; both packages see identical arrays."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracingtest_tpu.io import checkpoint as jax_ckpt
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from raytracingtest_tpu.utils import noise as jax_noise

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.io import checkpoint as ckpt
from raytracingtest_tpu_torch.ops import camera
from raytracingtest_tpu_torch.ops import octree
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.utils import noise
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SVO_ARRAYS = ("masks", "child_base", "leaf_base", "leaf_albedo",
              "leaf_normal", "leaf_density", "parent_ptr")


def assert_svo_identical(ours, ref):
    """Every array byte-identical (dtype included), same depth and layout;
    parent_ptr only where both carry it."""
    for name in SVO_ARRAYS:
        a, b = getattr(ours, name), getattr(ref, name)
        if name == "parent_ptr" and (a is None or b is None):
            continue
        a = a.cpu().numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert ours.depth == ref.depth
    assert tuple(ours.level_start) == tuple(ref.level_start)


@pytest.mark.parametrize("fn", ["noise3", "fbm3"])
def test_noise_matches_jax_bitwise(fn):
    # 20,000 points: both packages take their native (C++) path
    rng = np.random.default_rng(11)
    p = rng.random((20000, 3), dtype=np.float32) * 16.0 - 4.0
    ours = getattr(noise, fn)(p[:, 0], p[:, 1], p[:, 2], seed=3)
    ref = getattr(jax_noise, fn)(p[:, 0], p[:, 1], p[:, 2], xp=np, seed=3)
    assert ours.dtype == np.float32 and ours.shape == (20000,)
    assert ours.tobytes() == np.asarray(ref, np.float32).tobytes()


def test_noise_numpy_path_matches_jax_bitwise():
    # below the native threshold both run the numpy path
    rng = np.random.default_rng(12)
    p = rng.random((3000, 3), dtype=np.float32) * 8.0
    ours = noise.fbm3(p[:, 0], p[:, 1], p[:, 2], seed=1, octaves=3)
    ref = jax_noise.fbm3(p[:, 0], p[:, 1], p[:, 2], xp=np, seed=1, octaves=3)
    assert ours.tobytes() == np.asarray(ref, np.float32).tobytes()


# a chunk of the world, as stream/clipmap's chunks are built: (origin, size)
CHUNK = ((0.25, 0.0, 0.5), 0.5)


def _chunk_scene(world, origin, size):
    """The port's twin of stream/clipmap._chunk_scene: `world` restricted to
    a chunk, in chunk-local [0,1]^3, its density rescaled by 1/size."""
    from raytracingtest_tpu_torch.scenes import Scene
    ox, oy, oz = (float(v) for v in origin)
    s = float(size)

    def fn(x, y, z):
        return world.fn(np.asarray(x) * s + ox, np.asarray(y) * s + oy,
                        np.asarray(z) * s + oz) / s

    return Scene(f"{world.name}@{origin}/{size}", fn, world.lipschitz)


BUILD_CASES = [
    ("sphere", 5, {}), ("terrain", 5, {}), ("terrain", 6, {}),
    ("flat_ground", 4, {}), ("rotated_cuboid", 5, {}), ("dense_cube", 4, {}),
    ("simplex", 5, {}), ("perlin", 5, {}), ("perlin", 6, {}),
    ("terrain_ref", 5, {}), ("simplex_ref", 5, {}),
    ("sphere", 4, {"prune": False}), ("terrain", 5, {"attr_frame": CHUNK}),
]


@pytest.mark.parametrize(
    "name,depth,options", BUILD_CASES,
    ids=[f"{n}-{d}" + "".join(f"-{k}" for k in o) for n, d, o in BUILD_CASES])
def test_build_svo_matches_jax(name, depth, options):
    scene, ref_scene = get_scene(name), jax_get_scene(name)
    ours_kw, ref_kw = dict(options), dict(options)
    if "attr_frame" in options:
        from raytracingtest_tpu.stream.clipmap import _chunk_scene as jax_chunk
        origin, size = options["attr_frame"]
        ours_kw["attr_frame"] = (scene, origin, size)
        ref_kw["attr_frame"] = (ref_scene, origin, size)
        scene = _chunk_scene(scene, origin, size)
        ref_scene = jax_chunk(ref_scene, origin, size)
    ours = octree.build_svo(scene, depth, **ours_kw).svo
    ref = jax_octree.build_svo(ref_scene, depth, **ref_kw).svo
    assert ours.n_leaves > 0
    assert_svo_identical(ours, ref)
    if options:
        # the options change the result: prune=False keeps the same tree,
        # attr_frame moves the attributes off the chunk-local ones
        plain = octree.build_svo(scene, depth).svo
        assert torch.equal(ours.masks, plain.masks)
        moved = not torch.equal(ours.leaf_albedo, plain.leaf_albedo)
        assert moved == ("attr_frame" in options)


@pytest.mark.parametrize(
    "name,depth,options", BUILD_CASES,
    ids=[f"{n}-{d}" + "".join(f"-{k}" for k in o) for n, d, o in BUILD_CASES])
def test_build_result_matches_jax(name, depth, options):
    """The rest of the BuildResult, field for field, byte for byte: the
    finest-grid leaf coordinates, each level's node coordinates, the
    candidate counts and the finest candidate frontier."""
    scene, ref_scene = get_scene(name), jax_get_scene(name)
    ours_kw, ref_kw = dict(options), dict(options)
    if "attr_frame" in options:
        from raytracingtest_tpu.stream.clipmap import _chunk_scene as jax_chunk
        origin, size = options["attr_frame"]
        ours_kw["attr_frame"] = (scene, origin, size)
        ref_kw["attr_frame"] = (ref_scene, origin, size)
        scene = _chunk_scene(scene, origin, size)
        ref_scene = jax_chunk(ref_scene, origin, size)
    ours = octree.build_svo(scene, depth, **ours_kw)
    ref = jax_octree.build_svo(ref_scene, depth, **ref_kw)
    assert isinstance(ours, octree.BuildResult)
    for name in ("leaf_coords", "frontier_coords"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert ours.n_candidates == ref.n_candidates
    assert len(ours.node_coords) == len(ref.node_coords) == depth
    for a, b in zip(ours.node_coords, ref.node_coords):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ours.leaf_coords.shape[0] == ours.svo.n_leaves


def test_build_svo_rejects_depth_zero():
    with pytest.raises(ValueError):
        octree.build_svo(get_scene("sphere"), 0)


def test_scene_lipschitz_matches_jax():
    from raytracingtest_tpu.scenes import SCENES as JAX_SCENES
    from raytracingtest_tpu_torch.scenes import SCENES
    assert sorted(SCENES) == sorted(JAX_SCENES) and len(SCENES) == 9
    for name, scene in SCENES.items():
        assert scene.lipschitz == jax_get_scene(name).lipschitz, name


def test_load_jax_checkpoint(tmp_path):
    ref = jax_octree.build_svo(jax_get_scene("terrain"), 5).svo
    path = str(tmp_path / "svo.npz")
    jax_ckpt.save_svo(ref, path)
    ours = ckpt.load_svo(path, "cpu")
    assert ours.parent_ptr is None  # the npz does not store it
    assert_svo_identical(ours, ref)


def test_jax_loads_port_checkpoint(tmp_path):
    ours = octree.build_svo(get_scene("sphere"), 4).svo
    path = str(tmp_path / "svo.npz")
    ckpt.save_svo(ours, path)
    assert_svo_identical(ours, jax_ckpt.load_svo(path))


def test_svo_from_numpy_and_to():
    ref = jax_octree.build_svo(jax_get_scene("sphere"), 4).svo
    ours = convert.svo_from_numpy(ref.device(), "cpu")
    assert_svo_identical(ours, ref)
    moved = ours.to("cpu")
    assert moved.n_nodes == ref.n_nodes and moved.n_leaves == ref.n_leaves
    alb, nrm, den = convert.params_from_numpy(
        ref.leaf_albedo, ref.leaf_normal, ref.leaf_density, "cpu")
    assert alb.dtype == torch.float32 and den.shape == (ref.n_leaves,)
    np.testing.assert_array_equal(nrm.numpy(), ref.leaf_normal)


CAMERAS = [
    dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0,
         width=64, height=32),
    dict(position=(1.7, 1.2, 1.9), look_at=(0.4, 0.5, 0.45), fov_y_deg=35.0,
         width=40, height=24),
    dict(position=(0.5, 0.5, -1.0), look_at=(0.5, 0.5, 0.5), ortho_height=1.2,
         width=16, height=16),
]


@pytest.mark.parametrize("cam_args", CAMERAS)
def test_camera_rays_match_numpy(cam_args):
    o_ref, d_ref = jax_camera.Camera(**cam_args).rays(np)
    o, d = camera.Camera(**cam_args).rays("cpu")
    assert o.shape == d.shape == (cam_args["width"] * cam_args["height"], 3)
    assert o.dtype == d.dtype == torch.float32
    np.testing.assert_array_equal(o.numpy(), o_ref)
    np.testing.assert_array_equal(d.numpy(), d_ref)


def test_octree_frame_matches_numpy():
    frame = camera.OctreeFrame(origin=(-1.0, 0.25, 3.0), size=2.5)
    ref = jax_camera.OctreeFrame(origin=(-1.0, 0.25, 3.0), size=2.5)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    o_l, d_l = frame.world_to_local(torch.from_numpy(o), torch.from_numpy(d))
    o_r, d_r = ref.world_to_local(o, d, np)
    np.testing.assert_array_equal(o_l.numpy(), o_r)
    np.testing.assert_array_equal(d_l.numpy(), d_r)
    t = rng.random(50).astype(np.float32)
    np.testing.assert_array_equal(frame.t_world(torch.from_numpy(t)).numpy(),
                                  ref.t_world(t, np))


PORT_MODULES = (
    "raytracingtest_tpu_torch", "raytracingtest_tpu_torch._build",
    "raytracingtest_tpu_torch._device", "raytracingtest_tpu_torch._launch",
    "raytracingtest_tpu_torch.cli", "raytracingtest_tpu_torch.config",
    "raytracingtest_tpu_torch.convert",
    "raytracingtest_tpu_torch.diff", "raytracingtest_tpu_torch.render",
    "raytracingtest_tpu_torch.scenes",
    "raytracingtest_tpu_torch.io.checkpoint", "raytracingtest_tpu_torch.io.hdr",
    "raytracingtest_tpu_torch.models",
    "raytracingtest_tpu_torch.models.renderers",
    "raytracingtest_tpu_torch.models.streaming",
    "raytracingtest_tpu_torch.ops.brick",
    "raytracingtest_tpu_torch.ops.brick_cuda",
    "raytracingtest_tpu_torch.ops.brick_dda",
    "raytracingtest_tpu_torch.ops.camera",
    "raytracingtest_tpu_torch.ops.codecs",
    "raytracingtest_tpu_torch.ops.gather",
    "raytracingtest_tpu_torch.ops.lod",
    "raytracingtest_tpu_torch.ops.morton",
    "raytracingtest_tpu_torch.ops.octree",
    "raytracingtest_tpu_torch.ops.octree_cuda",
    "raytracingtest_tpu_torch.ops.octree_device",
    "raytracingtest_tpu_torch.ops.rowread",
    "raytracingtest_tpu_torch.ops.shade_cuda",
    "raytracingtest_tpu_torch.ops.tile",
    "raytracingtest_tpu_torch.ops.tile_cuda",
    "raytracingtest_tpu_torch.ops.traverse",
    "raytracingtest_tpu_torch.ops.traverse_cuda",
    "raytracingtest_tpu_torch.parallel.level_sharded",
    "raytracingtest_tpu_torch.parallel.mesh",
    "raytracingtest_tpu_torch.parallel.multihost",
    "raytracingtest_tpu_torch.parallel.render_sharded",
    "raytracingtest_tpu_torch.stream",
    "raytracingtest_tpu_torch.stream.chunk_octree",
    "raytracingtest_tpu_torch.stream.clipmap",
    "raytracingtest_tpu_torch.stream.slices",
    "raytracingtest_tpu_torch.utils.checks",
    "raytracingtest_tpu_torch.utils.noise",
    "raytracingtest_tpu_torch.utils.opensimplex",
    "raytracingtest_tpu_torch.utils.perlin",
    "raytracingtest_tpu_torch.utils.profiling",
    "raytracingtest_tpu_torch.viz",
)


def _port_root():
    import os
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_modules_list_is_complete():
    """PORT_MODULES names every module of the package, so the import check
    below covers the new ones too."""
    import os
    pkg = os.path.join(_port_root(), "raytracingtest_tpu_torch")
    found = set()
    for base, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(base, f), _port_root())
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    found -= {"raytracingtest_tpu_torch.io", "raytracingtest_tpu_torch.ops",
              "raytracingtest_tpu_torch.parallel",
              "raytracingtest_tpu_torch.utils"}  # empty package markers
    assert found == set(PORT_MODULES)


def test_port_never_imports_jax():
    """Every module of the port imports with no CUDA device and no nvcc on
    the PATH, pulls in neither jax nor the JAX package, and builds nothing
    while it is imported."""
    code = (
        "import importlib, shutil, sys\n"
        f"mods = {PORT_MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'raytracingtest_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'raytracingtest_tpu' not in sys.modules\n"
        "import torch\n"
        "from raytracingtest_tpu_torch import _build\n"
        "assert not torch.cuda.is_available()\n"
        "assert shutil.which('nvcc') is None\n"
        "assert not _build._libs  # importing built nothing\n"
        "print('ok')\n")
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=_port_root(),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_load_svo_without_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    ours = octree.build_svo(get_scene("sphere"), 4).svo
    path = str(tmp_path / "svo.npz")
    ckpt.save_svo(ours, path)
    with pytest.raises(RuntimeError):
        ckpt.load_svo(path)
    with pytest.raises(RuntimeError):
        ours.to()
    assert ckpt.load_svo(path, "cpu").masks.device.type == "cpu"
