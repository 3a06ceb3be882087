"""The port's ESVO traversal against the JAX package's: the numpy oracle
(bit-exact) and the Pallas kernel in interpret mode.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.ops.traverse_pallas import TILE_N, trace_pallas
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from tests.test_traverse import random_rays

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.ops import traverse, traverse_cuda
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SCENES = [("sphere", 5), ("terrain", 5), ("flat_ground", 4),
          ("rotated_cuboid", 5)]


def _svos(name, depth):
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    return ref, convert.svo_from_numpy(ref, "cpu")


def _trace(svo, o, d):
    return traverse.trace(svo, torch.tensor(o), torch.tensor(d))


def assert_matches_oracle(ours, ref):
    """Exact hit ids and iteration counts; hit_t bit-exact."""
    for name in ("hit_leaf", "hit_parent", "hit_child", "iters"):
        a = getattr(ours, name).numpy()
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, getattr(ref, name), err_msg=name)
    assert ours.hit_t.dtype == torch.float32
    np.testing.assert_array_equal(ours.hit_t.numpy().view(np.int32),
                                  np.asarray(ref.hit_t, np.float32).view(np.int32))


@pytest.mark.parametrize("name,depth", SCENES + [("terrain", 6)])
@pytest.mark.parametrize("n", [1000, 1024])
def test_trace_matches_numpy_oracle(name, depth, n):
    ref_svo, svo = _svos(name, depth)
    o, d = random_rays(n, seed=depth)
    ours = _trace(svo, o, d)
    ref = jax_traverse.trace_numpy(ref_svo, o, d)
    assert (ref.hit_leaf >= 0).sum() > 0
    assert_matches_oracle(ours, ref)


def test_trace_camera_rays_match_numpy_oracle():
    """Camera-coherent rays (the frame's access pattern), deeper scene."""
    ref_svo, svo = _svos("terrain", 6)
    cam = jax_camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                            fov_y_deg=50.0, width=64, height=32)
    o, d = cam.rays(np)
    assert_matches_oracle(_trace(svo, o, d),
                          jax_traverse.trace_numpy(ref_svo, o, d))


def test_trace_diagonal_ties_follow_pallas():
    """Rays with |dx| == |dy| can step two axes at once. The numpy oracle
    sums the axes' POP bits, which carries when the bits are equal, pops too
    far, and on 4 rays of this frame misses at the trip bound; the port ORs
    them as the Pallas kernel does and hits. Off the diagonals the port and
    the oracle agree exactly. (The interpreted kernel's step counts differ
    by one on some diagonal rays, so only its hits are compared.)"""
    ref_svo, svo = _svos("sphere", 5)
    cam = jax_camera.Camera(position=(0.5, 0.5, -0.8), look_at=(0.5, 0.5, 0.5),
                            fov_y_deg=45.0, width=64, height=16)
    o, d = (np.ascontiguousarray(a) for a in cam.rays(np))
    ours = _trace(svo, o, d)
    pal = trace_pallas(ref_svo.device(), o, d, interpret=True)
    np.testing.assert_array_equal(ours.hit_leaf.numpy(), np.asarray(pal.hit_leaf))

    ref = jax_traverse.trace_numpy(ref_svo, o, d)
    diagonal = np.abs(d[:, 0]) == np.abs(d[:, 1])
    off = ~diagonal
    for name in ("hit_leaf", "hit_parent", "hit_child", "iters"):
        np.testing.assert_array_equal(getattr(ours, name).numpy()[off],
                                      getattr(ref, name)[off], err_msg=name)
    np.testing.assert_array_equal(ours.hit_t.numpy()[off].view(np.int32),
                                  ref.hit_t[off].view(np.int32))
    diverged = ours.hit_leaf.numpy() != ref.hit_leaf
    assert diverged.sum() == 4 and diagonal[diverged].all()
    assert (ref.hit_leaf[diverged] == -1).all()
    assert (ref.iters[diverged] == jax_traverse.max_iters_for_depth(5)).all()
    assert (ours.hit_leaf.numpy()[diverged] >= 0).all()


def test_trace_axis_aligned_and_missing_rays():
    """Zero direction components (the eps clamp), rays from inside the
    cube, and rays that miss it."""
    ref_svo, svo = _svos("flat_ground", 4)
    o = np.array([[0.5, 0.9, 0.5], [0.5, 0.9, 0.5], [0.2, 0.1, 0.7],
                  [-1.0, 0.2, 0.5], [3.0, 3.0, 3.0], [0.5, 2.0, 0.5]],
                 np.float32)
    d = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                  [1.0, 0.0, -0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                 np.float32)
    ours = _trace(svo, o, d)
    ref = jax_traverse.trace_numpy(ref_svo, o, d)
    assert_matches_oracle(ours, ref)
    assert ref.hit_leaf[0] >= 0 and ref.hit_leaf[4] == -1


@pytest.mark.parametrize("name,depth", SCENES)
def test_trace_matches_pallas_interpret(name, depth):
    ref_svo, svo = _svos(name, depth)
    o, d = random_rays(TILE_N, seed=depth)
    ours = traverse_cuda.trace_cuda(svo, torch.from_numpy(o), torch.from_numpy(d))
    pal = trace_pallas(ref_svo.device(), o, d, interpret=True)
    np.testing.assert_array_equal(ours.hit_leaf.numpy(), np.asarray(pal.hit_leaf))
    hit = ours.hit_leaf.numpy() >= 0
    np.testing.assert_array_equal(ours.hit_parent.numpy()[hit],
                                  np.asarray(pal.hit_parent)[hit])
    np.testing.assert_array_equal(ours.hit_child.numpy()[hit],
                                  np.asarray(pal.hit_child)[hit])
    # test_pallas.py's tolerance: the interpreted kernel runs through XLA
    np.testing.assert_allclose(ours.hit_t.numpy()[hit],
                               np.asarray(pal.hit_t)[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_trace_cuda_takes_any_ray_count(n):
    """Any N, as the reference's per-ray step takes (no multiple of the
    Pallas kernel's 1024-ray tile): the CPU path is the plain trace."""
    _, svo = _svos("terrain", 5)
    o, d = random_rays(n, seed=n)
    ours = traverse_cuda.trace_cuda(svo, torch.from_numpy(o), torch.from_numpy(d))
    plain = _trace(svo, o, d)
    for name in ("hit_leaf", "hit_t", "hit_parent", "hit_child", "iters"):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name
    assert ours.hit_leaf.shape == (n,)
    assert n < 100 or int((ours.hit_leaf >= 0).sum()) > 0


def test_trace_cuda_on_cpu_runs_plain_version():
    _, svo = _svos("sphere", 4)
    o, d = random_rays(2048, seed=4)
    before = traverse_cuda.launches
    ours = traverse_cuda.trace_cuda(svo, torch.from_numpy(o), torch.from_numpy(d))
    assert traverse_cuda.launches == before  # no kernel launch on the CPU
    plain = _trace(svo, o, d)
    for name in ("hit_leaf", "hit_t", "hit_parent", "hit_child", "iters"):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name


def test_trace_kernel_refuses_cpu_tensors():
    """The kernel wrapper has no CPU path: it raises before any build."""
    _, svo = _svos("sphere", 3)
    with pytest.raises(ValueError, match="CUDA"):
        traverse_cuda._trace_kernel(svo, torch.zeros((10, 3)), torch.ones((10, 3)))


def test_popc8_and_iteration_bound():
    v = torch.arange(256, dtype=torch.int32)
    expect = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)
    assert torch.equal(traverse.popc8(v), expect)
    assert traverse.popc8(v).dtype == torch.int32
    for depth in (1, 5, 10):
        assert traverse.max_iters_for_depth(depth) == jax_traverse.max_iters_for_depth(depth)
