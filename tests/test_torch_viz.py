"""The port's debug visualisation against the JAX package's:
``Camera.project``, ``node_boxes``, ``draw_boxes``, ``draw_segment`` and
``ray_probe`` (run by the port on the CPU, through the plain k-segment
trace). Inputs come from numpy seeds."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracingtest_tpu import viz as jax_viz
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import viz
from raytracingtest_tpu_torch.ops import camera, octree
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CAMERAS = [
    dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0,
         width=64, height=48),
    dict(position=(1.7, 1.2, 1.9), look_at=(0.4, 0.5, 0.45), fov_y_deg=35.0,
         width=40, height=24),
    dict(position=(0.5, 0.5, -1.0), look_at=(0.5, 0.5, 0.5), ortho_height=1.2,
         width=32, height=32),
]


@pytest.fixture(scope="module")
def sphere5():
    return octree.build_svo(get_scene("sphere"), 5).svo


@pytest.mark.parametrize("cam_args", CAMERAS)
def test_project_matches_jax(cam_args):
    rng = np.random.default_rng(4)
    pts = rng.random((3000, 3), dtype=np.float32) * 3.0 - 1.0
    pix, front = camera.Camera(**cam_args).project(pts, "cpu")
    ref_pix, ref_front = jax_camera.Camera(**cam_args).project(pts)
    assert pix.dtype == torch.float32 and pix.shape == (3000, 2)
    np.testing.assert_array_equal(front.numpy(), ref_front)
    # numpy's float32 `@` rounds as its BLAS does and the port sums the dot
    # products left to right, an ULP apart in z; away from the camera's
    # plane that is within rtol 1e-5 (atol 1e-3 pixel)
    pos, fwd, _r, _u = jax_camera.Camera(**cam_args).basis(np)
    away = np.abs((pts - pos) @ fwd) > 0.05
    np.testing.assert_allclose(pix.numpy()[away], ref_pix[away], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("level", [0, 2, 4])
def test_node_boxes_equal(sphere5, level):
    origins, size = viz.node_boxes(sphere5, level)
    ref = jax_octree.build_svo(jax_get_scene("sphere"), 5).svo
    ref_origins, ref_size = jax_viz.node_boxes(ref, level)
    assert size == ref_size
    assert origins.dtype == ref_origins.dtype
    np.testing.assert_array_equal(origins, ref_origins)


def test_node_boxes_rejects_the_leaf_level(sphere5):
    with pytest.raises(ValueError):
        viz.node_boxes(sphere5, 5)


@pytest.mark.parametrize("cam_args", CAMERAS)
def test_draw_boxes_and_segment_pixels_equal(sphere5, cam_args):
    origins, size = viz.node_boxes(sphere5, 3)
    h, w = cam_args["height"], cam_args["width"]
    base = np.random.default_rng(5).random((h, w, 3), dtype=np.float32)
    ours, ref = base.copy(), base.copy()
    viz.draw_boxes(ours, camera.Camera(**cam_args), origins, size, max_boxes=40)
    jax_viz.draw_boxes(ref, jax_camera.Camera(**cam_args), origins, size, max_boxes=40)
    assert (ours != base).any()
    np.testing.assert_array_equal(ours, ref)
    seg = ((0.1, 0.9, 0.1), (0.9, 0.1, 0.9))
    viz.draw_segment(ours, camera.Camera(**cam_args), *seg)
    jax_viz.draw_segment(ref, jax_camera.Camera(**cam_args), *seg)
    np.testing.assert_array_equal(ours, ref)


# the reference's probe in a process of its own: XLA without FMA
# instructions rounds each multiply-add in two steps, as the port does, so
# t_in can be held bitwise (on the default ISA XLA contracts them, an ULP
# off on some segments)
_JAX_PROBE = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from raytracingtest_tpu import viz
from raytracingtest_tpu.ops.octree import build_svo
from raytracingtest_tpu.scenes import get_scene
rays = json.loads(sys.argv[1])
svo = build_svo(get_scene("sphere"), 5).svo
out = []
for o, d in rays:
    e = viz.ray_probe(svo, np.float32(o), np.float32(d), max_hits=32)
    out.append([[x.leaf_id, int(np.float32(x.t_enter).view(np.int32))] for x in e])
print(json.dumps(out))
"""


def test_ray_probe_matches_jax(sphere5):
    rng = np.random.default_rng(3)
    rays = []
    for _ in range(12):
        o = rng.random(3).astype(np.float32) * 0.2 + 0.05
        d = (np.float32(0.5) - o + rng.normal(0, 0.2, 3).astype(np.float32))
        rays.append((o.tolist(), d.astype(np.float32).tolist()))
    rays.append(([0.5, 1.5, 0.5], [0.0, -1.0, 0.0]))    # straight down the axis
    rays.append(([2.0, 2.0, 2.0], [1.0, 0.0, 0.0]))     # misses the cube
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_PROBE, json.dumps(rays)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    n_hits = 0
    for (o, d), want in zip(rays, ref):
        got = viz.ray_probe(sphere5, o, d, max_hits=32)
        assert all(e.is_leaf_hit and e.level == 5 for e in got)
        assert [[e.leaf_id, int(np.float32(e.t_enter).view(np.int32))]
                for e in got] == want
        n_hits += len(got)
    assert n_hits > 20
    assert viz.format_probe([]) == "(no intersections)"
    text = viz.format_probe(viz.ray_probe(sphere5, *rays[0], max_hits=32))
    assert text.splitlines()[0].startswith("  0: leaf ")
