"""The port's tile trace against the JAX package's (XLA on the CPU): phase 1
candidates and ``trace_tile`` (tests/test_torch_tile_fb.py holds the
fallback passes ``trace_tile_fb`` and ``trace_tile_exact``).

On the CPU the walker runs its plain version (``tile.walk_plain``); the
CUDA kernel is held to that version on the card by chip_smoke.py. Hit ids,
iteration counts and the unresolved/residual masks must be equal.

``hit_t`` is held bitwise to the port's own per-ray trace, which
tests/test_torch_traverse.py holds bitwise to the numpy oracle. Against XLA
on the CPU it is held to the tolerance the JAX package's own
``test_walk_scheduled_chunked_parity`` states (rtol 1e-5, atol 1e-6): XLA
contracts ``pos*t_coef - t_bias`` into a fused multiply-add, the port rounds
the product first, and where the two terms nearly cancel that moves ``hit_t``
by many ULP of the result (48 measured on `terrain` depth 6, 3.9e-6
relative); ``test_xla_hit_t_is_off_the_oracle_not_the_port`` pins which side
moved."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.scenes import Scene as JaxScene
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.ops import camera, tile, tile_cuda, traverse
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BENCH_CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0)
INSIDE_CAM = dict(position=(0.5, 0.05, 0.5), look_at=(0.5, 0.5, 0.5),
                  fov_y_deg=60.0)
SCENES = [("terrain", 6), ("sphere", 5), ("flat_ground", 6)]
HIT_T_RTOL, HIT_T_ATOL = 1e-5, 1e-6  # against XLA on the CPU (see above)
TINY = dict(k_max=2, caps=(1, 2, 2, 2))  # absurdly small: heavy cap dropping

_cache = {}


def setup(name, depth, res=64, cam=None):
    """(reference TileSVO on the JAX CPU device, port TileSVO, port SVO,
    numpy rays o/d/corners): identical state on both sides."""
    key = (name, depth, res, tuple(sorted((cam or BENCH_CAM).items())))
    if key not in _cache:
        if name == "empty":
            scene = JaxScene("empty", lambda x, y, z, xp: xp.ones_like(
                xp.asarray(x, xp.float32)), 0.0)
        else:
            scene = jax_get_scene(name)
        ref_svo = jax_octree.build_svo(scene, depth).svo
        ref_ts = jax_tile.make_tile_svo(ref_svo)
        rays = jax_tile.tile_rays(
            jax_camera.Camera(**(cam or BENCH_CAM), width=res, height=res), np)[:3]
        _cache[key] = (ref_ts.device(),
                       convert.tile_svo_from_numpy(ref_ts, "cpu"),
                       convert.svo_from_numpy(ref_svo, "cpu"),
                       tuple(np.ascontiguousarray(a) for a in rays))
    return _cache[key]


def tensors(rays):
    return tuple(torch.from_numpy(a) for a in rays)


def assert_trace_matches(ours, ref, what):
    """Hit ids and step counts equal; hit_t to XLA-CPU's tolerance."""
    np.testing.assert_array_equal(ours.hit_leaf.numpy(),
                                  np.asarray(ref.hit_leaf), err_msg=what)
    np.testing.assert_array_equal(ours.iters.numpy(), np.asarray(ref.iters),
                                  err_msg=what)
    assert ours.hit_leaf.dtype == ours.iters.dtype == torch.int32
    assert ours.hit_t.dtype == torch.float32
    np.testing.assert_allclose(ours.hit_t.numpy(), np.asarray(ref.hit_t),
                               rtol=HIT_T_RTOL, atol=HIT_T_ATOL)
    assert bool((ours.hit_parent == -1).all()) and bool((ours.hit_child == 0).all())


_per_ray = {}


def per_ray(svo, o, d):
    """The per-ray trace of the rays o, d through `svo`, made once for each
    tree and ray set and shared by the tests that hold a tile trace to it."""
    key = (id(svo), o.data_ptr(), o.shape, d.data_ptr())
    if key not in _per_ray:
        _per_ray[key] = (svo, o, d, traverse.trace(svo, o.reshape(-1, 3), d.reshape(-1, 3)))
    return _per_ray[key][3]


def assert_equals_per_ray(ours, golden, mask=None):
    """Hit ids equal the per-ray trace's and hit_t is bitwise on hits, on
    the rays of `mask` (default: all)."""
    m = torch.ones_like(golden.hit_leaf, dtype=torch.bool) if mask is None else mask
    assert torch.equal(ours.hit_leaf[m], golden.hit_leaf[m])
    hit = m & (golden.hit_leaf >= 0)
    assert torch.equal(ours.hit_t[hit].view(torch.int32),
                       golden.hit_t[hit].view(torch.int32))
    return int(hit.sum())


@pytest.mark.parametrize("name,depth", SCENES)
@pytest.mark.parametrize("budget", ["default", "tiny", "wide"])
def test_candidates_match_reference(name, depth, budget):
    ref_ts, ts, _svo, rays = setup(name, depth)
    o, d, corners = rays
    k_max, caps = {
        "default": (48, jax_tile._default_caps(ts.top_depth, 48)),
        "tiny": (2, (1, 2, 2, 2)),
        "wide": (160, tuple(min(160, 8 ** l) for l in range(ts.top_depth + 1))),
    }[budget]
    ref = jax_tile._candidates(ref_ts.pyr, ref_ts.cellmap, jnp.asarray(corners),
                               jnp.asarray(o[0, 0]), ts.top_depth, caps, k_max)
    ours = tile._candidates(ts.pyr, ts.cellmap, torch.from_numpy(corners),
                            torch.from_numpy(o[0, 0]), ts.top_depth, caps, k_max)
    for a, b, what in zip(ours, ref, ("codes", "ids", "t_codes", "drop_t")):
        assert a.dtype == (torch.float32 if what in ("t_codes", "drop_t")
                           else torch.int32), what
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    assert ours[1].shape == (corners.shape[0], k_max)
    assert int((ours[1] >= 0).sum()) > 0


@pytest.mark.parametrize("name,depth", SCENES)
def test_trace_tile_matches_reference(name, depth):
    ref_ts, ts, svo, rays = setup(name, depth)
    o, d, corners = tensors(rays)
    ref, ref_un = jax_tile.trace_tile(ref_ts, *rays)
    ours, un = tile.trace_tile(ts, o, d, corners)
    assert_trace_matches(ours, ref, name)
    np.testing.assert_array_equal(un.numpy(), np.asarray(ref_un))
    # resolved rays are already exact against the per-ray trace
    assert assert_equals_per_ray(ours, per_ray(svo, o, d), ~un) > 100


def test_xla_hit_t_is_off_the_oracle_not_the_port():
    """Where the port's hit_t and XLA-CPU's differ, the port's is the numpy
    oracle's, bit for bit."""
    from raytracingtest_tpu.ops import traverse as jax_traverse

    ref_ts, ts, _svo, rays = setup("terrain", 6)
    o, d, corners = tensors(rays)
    ref, _ = jax_tile.trace_tile(ref_ts, *rays)
    ours, un = tile.trace_tile(ts, o, d, corners)
    ref_svo = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
    oracle = jax_traverse.trace_numpy(ref_svo, rays[0].reshape(-1, 3),
                                      rays[1].reshape(-1, 3))
    ok = ~un.numpy() & (oracle.hit_leaf >= 0)
    np.testing.assert_array_equal(ours.hit_leaf.numpy()[ok], oracle.hit_leaf[ok])
    np.testing.assert_array_equal(ours.hit_t.numpy()[ok].view(np.int32),
                                  oracle.hit_t[ok].view(np.int32))
    off = np.asarray(ref.hit_t)[ok] != oracle.hit_t[ok]
    assert ok.sum() > 1000 and off.sum() > 0  # XLA's contraction is real here


def test_trace_tile_adversarial_tiny_caps():
    """Starved candidate caps must flag (not silently drop) affected rays,
    and the exact trace must repair all of them."""
    ref_ts, ts, svo, rays = setup("terrain", 6)
    o, d, corners = tensors(rays)
    ref, ref_un = jax_tile.trace_tile(ref_ts, *rays, **TINY)
    ours, un = tile.trace_tile(ts, o, d, corners, **TINY)
    assert_trace_matches(ours, ref, "tiny caps")
    np.testing.assert_array_equal(un.numpy(), np.asarray(ref_un))
    assert int(un.sum()) > 100  # the caps really starve the walk
    golden = per_ray(svo, o, d)
    assert_equals_per_ray(ours, golden, ~un)
    exact = tile.trace_tile_exact(ts, svo, o, d, corners, **TINY)
    assert_equals_per_ray(exact, golden)


def test_camera_inside_the_solid():
    ref_ts, ts, svo, rays = setup("terrain", 6, 32, INSIDE_CAM)
    o, d, corners = tensors(rays)
    ref, ref_un = jax_tile.trace_tile(ref_ts, *rays)
    ours, un = tile.trace_tile(ts, o, d, corners)
    assert_trace_matches(ours, ref, "inside")
    np.testing.assert_array_equal(un.numpy(), np.asarray(ref_un))
    exact = tile.trace_tile_exact(ts, svo, o, d, corners)
    assert assert_equals_per_ray(exact, per_ray(svo, o, d)) > 100


def test_empty_scene_is_all_miss():
    ref_ts, ts, svo, rays = setup("empty", 4, 32)
    o, d, corners = tensors(rays)
    ours, un = tile.trace_tile(ts, o, d, corners)
    assert bool((ours.hit_leaf == -1).all()) and not bool(un.any())
    assert bool((ours.hit_t == 0).all()) and bool((ours.iters == 0).all())
    ref, ref_un = jax_tile.trace_tile(ref_ts, *rays)
    assert_trace_matches(ours, ref, "empty")
    fb, residual = tile.trace_tile_fb(ts, o, d, corners, fb2_tiles=2)
    assert bool((fb.hit_leaf == -1).all()) and not bool(residual.any())
    exact = tile.trace_tile_exact(ts, svo, o, d, corners)
    assert bool((exact.hit_leaf == -1).all())


def test_flat_ground_from_above_and_below():
    """An asymmetric scene from both sides: a mirrored or upside-down walk
    (the flip against the mirrored corner) cannot pass both."""
    for cam in (dict(position=(0.5, 0.9, -0.4), look_at=(0.5, 0.3, 0.5), fov_y_deg=50.0),
                dict(position=(0.3, -0.5, 0.2), look_at=(0.5, 0.3, 0.5), fov_y_deg=50.0)):
        ref_ts, ts, svo, rays = setup("flat_ground", 6, 64, cam)
        o, d, corners = tensors(rays)
        exact = tile.trace_tile_exact(ts, svo, o, d, corners)
        assert assert_equals_per_ray(exact, per_ray(svo, o, d)) > 500
        ref, _ = jax_tile.trace_tile(ref_ts, *rays)
        ours, _ = tile.trace_tile(ts, o, d, corners)
        assert_trace_matches(ours, ref, "flat_ground")


def test_walker_wrapper_contract():
    """On CPU tensors the wrapper is the plain version; the kernel entry
    refuses them, and the path never counts a launch here."""
    _ref_ts, ts, _svo, rays = setup("sphere", 5)
    o, d, corners = tensors(rays)
    caps = tile._default_caps(ts.top_depth, 16)
    codes, ids, t_codes, _drop = tile._candidates(
        ts.pyr, ts.cellmap, corners, o[0, 0], ts.top_depth, caps, 16)
    args = (ts.bsvo.bricks, o, d, codes, ids, t_codes, ts.depth, ts.top_depth)
    before = tile_cuda.launches
    a = tile_cuda.tile_walk(*args)
    b = tile.walk_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tile_cuda.launches == before
    with pytest.raises(ValueError):
        tile_cuda._walk_kernel(*args)
    with pytest.raises(ValueError):  # 256 rays a tile do not split 3x3
        tile.trace_tile_fb(ts, o, d, corners, fb2_tiles=1, fb2_split=3)
