"""The LOD path against the JAX package on the CPU: ``traverse.trace_lod``
and ``brick.trace_brick_lod`` (the plain versions of the kernels
``esvo_stackless_lod`` and ``brick_trace_lod``) against ``trace_lod_jax`` and
``trace_brick_lod_jax``, ``ops/lod.py`` against the reference's module, the
twins of ``tests/test_lod.py``, and the checks of the two kernels'
launchers.

hit_leaf and hit_node are held exactly at every footprint coefficient;
hit_t to rtol 1e-5 / atol 1e-6 against XLA, which contracts multiply-adds
(F14), and bitwise against a numpy oracle of the footprint test (a multiply,
then an add, each rounded to float32). Inputs come from numpy seeds."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import lod as jax_lod
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.ops.camera import Camera as JaxCamera
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import _build, convert
from raytracingtest_tpu_torch.ops import brick, brick_cuda, lod, traverse
from raytracingtest_tpu_torch.render import Light
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
RES = 64
# the pixel footprint trace_lod_jax's docstring prescribes for this camera,
# the reference test's coarse setting, and its brick-parity setting
C0 = 2.0 * np.tan(np.radians(25.0)) / RES
COEFS = (0.0, C0, 8 * C0, 0.4)


@functools.lru_cache(maxsize=None)
def trees(name, depth):
    """(JAX SVO, JAX BrickSVO, the port's SVO, the port's BrickSVO) on the
    CPU, the port's moved from the reference's arrays."""
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    svo = convert.svo_from_numpy(ref, "cpu")
    return ref, jax_brick.make_brick_svo(ref), svo, brick.make_brick_svo(svo)


def rays(n, seed, spread=0.35):
    """Camera rays of a 64x64 view, then n rays from a radius-2 shell aimed
    near the centre (the reference test's random_rays)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = 0.5 + 2.0 * v
    d = 0.5 + rng.normal(0.0, spread, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam_o, cam_d = JaxCamera(**CAM, width=RES, height=RES).rays(np)
    return (np.concatenate([cam_o, o]).astype(np.float32),
            np.concatenate([cam_d, d]).astype(np.float32))


def as_t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# the reference's two LOD traces, compiled once a module for each tree
@functools.lru_cache(maxsize=None)
def ref_trace(kind, name, depth, coef, seed):
    ref, ref_b, _svo, _bsvo = trees(name, depth)
    o, d = rays(1024, seed)
    if kind == "stackless":
        return jax_traverse.trace_lod_jax(ref, jnp.asarray(o), jnp.asarray(d), coef)
    return jax_brick.trace_brick_lod_jax(ref_b, jnp.asarray(o), jnp.asarray(d), coef)


def assert_lod(ours, want, coef, what):
    for name in ("hit_leaf", "hit_node"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_allclose(ours.hit_t.numpy(), np.asarray(want.hit_t),
                               rtol=1e-5, atol=1e-6, err_msg=f"{what}: hit_t")


TREES = [("sphere", 6), ("terrain", 6)]


@pytest.mark.parametrize("coef", COEFS, ids=["0", "c0", "8c0", "0.4"])
@pytest.mark.parametrize("name,depth", TREES)
def test_trace_lod_matches_jax(name, depth, coef):
    _ref, _ref_b, svo, _bsvo = trees(name, depth)
    o, d = rays(1024, depth)
    ours, stats = traverse.trace_lod(svo, *as_t(o, d), coef, with_stats=True)
    want = ref_trace("stackless", name, depth, coef, depth)
    assert_lod(ours, want, coef, f"trace_lod {name} d{depth} coef {coef}")
    np.testing.assert_array_equal(ours.hit_parent.numpy(), np.asarray(want.hit_parent))
    # a node stop is not a leaf hit; a leaf hit names no node
    assert not bool(((ours.hit_node >= 0) & (ours.hit_leaf >= 0)).any())
    assert int(stats[:, :4].abs().sum()) == 0 and int(stats[:, 4].sum()) == 0
    if coef >= 8 * C0:
        assert int((ours.hit_node >= 0).sum()) > 100


@pytest.mark.parametrize("coef", COEFS, ids=["0", "c0", "8c0", "0.4"])
@pytest.mark.parametrize("name,depth", TREES)
def test_trace_brick_lod_matches_jax(name, depth, coef):
    _ref, _ref_b, _svo, bsvo = trees(name, depth)
    o, d = rays(1024, depth)
    ours, stats = brick.trace_brick_lod(bsvo, *as_t(o, d), coef, with_stats=True)
    want = ref_trace("brick", name, depth, coef, depth)
    assert_lod(ours, want, coef, f"trace_brick_lod {name} d{depth} coef {coef}")
    assert int(stats[:, 4].sum()) == 0  # every ray finishes


@pytest.mark.parametrize("name,depth", TREES)
def test_zero_coef_is_the_plain_traces(name, depth):
    """At coefficient 0 the LOD traces are the traces without LOD, bit for
    bit (hit_t and iters too), with hit_node all -1."""
    _ref, _ref_b, svo, bsvo = trees(name, depth)
    o, d = as_t(*rays(1024, depth + 1))
    for got, want in ((traverse.trace_lod(svo, o, d, 0.0), traverse.trace_stackless(svo, o, d)),
                      (brick.trace_brick_lod(bsvo, o, d, 0.0), brick.trace_brick(bsvo, o, d))):
        for field in ("hit_leaf", "hit_parent", "hit_child", "iters"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        assert torch.equal(got.hit_t.view(torch.int32), want.hit_t.view(torch.int32))
        assert bool((got.hit_node == -1).all()) and want.hit_node is None


def test_footprint_test_is_a_multiply_then_an_add():
    """The footprint compare is against a power of two, so its rounding
    decides node against leaf. A numpy float32 oracle that multiplies, then
    adds, each rounded: on the rays where it and a fused multiply-add
    disagree, the port follows the oracle (the CUDA build's --fmad=false)."""
    coef, bias = np.float32(C0), np.float32(1e-3)
    # footprints within a few ULP of each child size 2^-1 .. 2^-9
    size = np.repeat(np.float32(2.0) ** -np.arange(1, 10, dtype=np.float32), 4001)
    t0 = ((size - bias) / coef).astype(np.float32)
    tc = (t0.view(np.int32) + np.tile(np.arange(-2000, 2001, dtype=np.int32), 9)).view(np.float32)
    two_step = (tc * coef) + bias >= size
    fused = (tc.astype(np.float64) * np.float64(coef) + np.float64(bias)).astype(np.float32) >= size
    ours = (torch.from_numpy(tc) * torch.tensor(coef) + torch.tensor(bias)
            >= torch.from_numpy(size)).numpy()
    np.testing.assert_array_equal(ours, two_step)
    assert (two_step != fused).any()
    # coef and bias are rounded once from the Python number, as jnp.float32
    c, b = traverse.lod_constants(C0, 0.1, "cpu")
    assert float(c) == float(np.float32(C0)) and float(b) == float(np.float32(0.1))
    assert brick_cuda._lod_args(C0, 0.1) == (float(c), float(b))


def test_node_attributes_match_jax_bitwise():
    for name, depth in TREES + [("sphere", 4)]:
        ref, _ref_b, svo, _bsvo = trees(name, depth)
        want_alb, want_nrm = jax_lod.compute_node_attributes(ref)
        alb, nrm = lod.compute_node_attributes(svo)
        assert alb.dtype == nrm.dtype == torch.float32
        np.testing.assert_array_equal(alb.numpy().view(np.int32),
                                      np.asarray(want_alb).view(np.int32))
        np.testing.assert_array_equal(nrm.numpy().view(np.int32),
                                      np.asarray(want_nrm).view(np.int32))


@pytest.mark.parametrize("coef", [C0, 8 * C0], ids=["c0", "8c0"])
def test_render_and_shade_lod_match_jax(coef):
    """render_lod against the reference's, and shade_lod of the brick
    trace's result against the reference's shade_lod of its own (atol
    1e-6)."""
    ref, ref_b, svo, bsvo = trees("terrain", 6)
    o, d = rays(512, 9)
    node_alb, node_nrm = lod.compute_node_attributes(svo)
    light = Light()
    img, res = lod.render_lod(svo, node_alb, node_nrm, *as_t(o, d), coef, light)
    want_alb, want_nrm = jax_lod.compute_node_attributes(ref)
    want_img, want_res = jax_lod.render_lod(ref, want_alb, want_nrm, jnp.asarray(o),
                                            jnp.asarray(d), coef)
    np.testing.assert_array_equal(res.hit_node.numpy(), np.asarray(want_res.hit_node))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    res_b = brick.trace_brick_lod(bsvo, *as_t(o, d), coef)
    want_b = jax_brick.trace_brick_lod_jax(ref_b, jnp.asarray(o), jnp.asarray(d), coef)
    img_b = lod.shade_lod(svo, node_alb, node_nrm, res_b, torch.from_numpy(d), light)
    want_img_b = jax_lod.shade_lod(ref, want_alb, want_nrm, want_b, jnp.asarray(d), light)
    np.testing.assert_allclose(img_b.numpy(), np.asarray(want_img_b), rtol=0, atol=1e-6)
    assert int((res.hit_node >= 0).sum()) > 50


# ---- twins of tests/test_lod.py ----------------------------------------------

def shell(n, seed, spread=0.35):
    o, d = rays(n, seed, spread)
    return o[RES * RES:], d[RES * RES:]


def test_zero_coef_equals_plain_trace():
    _ref, _ref_b, svo, _bsvo = trees("sphere", 6)
    o, d = as_t(*shell(400, 5))
    r_lod = traverse.trace_lod(svo, o, d, 0.0)
    r_ref = traverse.trace(svo, o, d)
    assert torch.equal(r_lod.hit_leaf, r_ref.hit_leaf)
    assert int((r_lod.hit_node >= 0).sum()) == 0


def test_coarse_coef_terminates_early():
    _ref, _ref_b, svo, _bsvo = trees("sphere", 6)
    o, d = as_t(*shell(400, 7, spread=0.1))
    r_fine = traverse.trace_lod(svo, o, d, 0.0)
    r_coarse = traverse.trace_lod(svo, o, d, 0.05)
    assert int((r_coarse.hit_node >= 0).sum()) > 100
    assert float(r_coarse.iters.float().mean()) < float(r_fine.iters.float().mean())
    both = (r_coarse.hit_node >= 0) & (r_fine.hit_leaf >= 0)
    dt = (r_coarse.hit_t[both] - r_fine.hit_t[both]).abs().numpy()
    assert np.percentile(dt, 90) < 0.1


def test_node_attributes_average_children():
    _ref, _ref_b, svo, _bsvo = trees("sphere", 6)
    node_alb, node_nrm = (t.numpy() for t in lod.compute_node_attributes(svo))
    masks, leaf_base = svo.masks.numpy(), svo.leaf_base.numpy()
    albedo = svo.leaf_albedo.numpy()
    lo, hi = svo.level_start[svo.depth - 1], svo.level_start[svo.depth]
    for row in range(lo, min(lo + 20, hi)):
        lm = masks[row] & 0xFF
        ids = [leaf_base[row] + bin(lm & ((1 << k) - 1)).count("1")
               for k in range(8) if (lm >> k) & 1]
        np.testing.assert_allclose(node_alb[row], albedo[ids].mean(0), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(node_nrm[lo:hi], axis=1), 1.0, atol=1e-4)


def test_render_lod_image():
    _ref, _ref_b, svo, _bsvo = trees("sphere", 6)
    node_alb, node_nrm = lod.compute_node_attributes(svo)
    cam = JaxCamera(position=(0.5, 0.6, -1.2), look_at=(0.5, 0.5, 0.5),
                    fov_y_deg=40.0, width=48, height=48)
    o, d = as_t(*(a.astype(np.float32) for a in cam.rays(np)))
    coef = 2 * np.tan(np.radians(20.0)) / 48
    img_lod, res = lod.render_lod(svo, node_alb, node_nrm, o, d, coef * 8)
    img_fine, res_f = lod.render_lod(svo, node_alb, node_nrm, o, d, 0.0)
    assert bool(torch.isfinite(img_lod).all())
    hit = res_f.hit_leaf >= 0
    assert float((img_lod - img_fine).abs()[hit].mean()) < 0.25
    assert int((res.hit_node >= 0).sum()) > 50


def test_brick_lod_parity_coarse():
    """At coefficient 0.4 (stops at or above the brick level) the two LOD
    traces give the same bits: hit_node in the source SVO's rows, hit_leaf,
    hit_t."""
    _ref, _ref_b, svo, bsvo = trees("terrain", 6)
    o, d = rays(0, 0)
    r0 = traverse.trace_lod(svo, *as_t(o, d), 0.4)
    r1 = brick.trace_brick_lod(bsvo, *as_t(o, d), 0.4)
    assert torch.equal(r0.hit_node, r1.hit_node)
    assert torch.equal(r0.hit_leaf, r1.hit_leaf)
    assert torch.equal(r0.hit_t.view(torch.int32), r1.hit_t.view(torch.int32))
    assert int((r0.hit_node >= 0).sum()) > 50


def test_brick_lod_zero_coef_is_exact():
    _ref, _ref_b, _svo, bsvo = trees("sphere", 5)
    rng = np.random.default_rng(3)
    o = (rng.random((2048, 3), np.float32) * 1.4 - 0.2).astype(np.float32)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = as_t(o, d)
    r0 = brick.trace_brick(bsvo, o, d)
    r1 = brick.trace_brick_lod(bsvo, o, d, 0.0)
    assert torch.equal(r0.hit_leaf, r1.hit_leaf)
    assert bool((r1.hit_node == -1).all())


# ---- the launchers ------------------------------------------------------------

def launch_counts():
    return dict(brick_cuda.launches)


@pytest.mark.parametrize("call", [
    lambda svo, bsvo, o, d: brick_cuda._stackless_lod_kernel(svo, o, d, C0),
    lambda svo, bsvo, o, d: brick_cuda._brick_lod_kernel(bsvo, o, d, C0),
], ids=["esvo_stackless_lod", "brick_trace_lod"])
def test_lod_kernels_refuse_cpu_tensors_before_any_library(call):
    _ref, _ref_b, svo, bsvo = trees("sphere", 4)
    o, d = as_t(*shell(64, 1))
    before, loaded = launch_counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        call(svo, bsvo, o, d)
    assert launch_counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what", ["rays", "depth", "brick depth", "brick rays"])
def test_lod_launchers_refuse_bad_arguments(what, monkeypatch):
    """Rays that are not (N, 3) and trees out of range raise ValueError
    before any launch (the device check stood in for, so that CPU tensors
    reach the later checks)."""
    from raytracingtest_tpu_torch import _launch
    for kernel in (brick_cuda._ESVO_STACKLESS_LOD, brick_cuda._BRICK_TRACE_LOD):
        monkeypatch.setattr(kernel, "check",
                            lambda device, specs: _launch.check_tensors(device, specs))
    _ref, _ref_b, svo, bsvo = trees("sphere", 4)
    o, d = as_t(*shell(64, 2))
    calls = {
        "rays": lambda: brick_cuda._stackless_lod_kernel(svo, o.reshape(-1), d, C0),
        "depth": lambda: brick_cuda._stackless_lod_kernel(
            dataclasses.replace(svo, depth=23), o, d, C0),
        "brick depth": lambda: brick_cuda._brick_lod_kernel(
            dataclasses.replace(bsvo, depth=bsvo.depth + 1), o, d, C0),
        "brick rays": lambda: brick_cuda._brick_lod_kernel(bsvo, o, d[:, :2], C0),
    }
    before = launch_counts()
    with pytest.raises(ValueError):
        calls[what]()
    assert launch_counts() == before
