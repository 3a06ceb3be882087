"""The port's tile host layouts against the JAX package's: the brick table,
the occupancy pyramid and the cellmap (byte-identical), the morton helpers,
the tile-major ray order and the sub-tile split.

SVOs are built by the JAX package and carried across with ``convert``, so
both sides start from identical state; every port call names
``device="cpu"``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.scenes import Scene as JaxScene
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

import raytracingtest_tpu_torch as rtt
from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.ops import brick, camera, tile
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BENCH_CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                 fov_y_deg=50.0)


def empty_scene():
    return JaxScene("empty", lambda x, y, z, xp: xp.ones_like(
        xp.asarray(x, xp.float32)), 0.0)


def jax_svo(name, depth):
    scene = empty_scene() if name == "empty" else jax_get_scene(name)
    return jax_octree.build_svo(scene, depth).svo


def same_bytes(ours, ref, what):
    """The tensor's bytes equal the reference array's (uint32 words are
    int32 bit patterns in the port)."""
    a = ours.cpu().numpy()
    b = np.asarray(ref)
    assert a.shape == b.shape, what
    assert a.dtype.itemsize == b.dtype.itemsize, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name,depth", [
    ("sphere", 5), ("terrain", 6), ("flat_ground", 6), ("empty", 4)])
def test_brick_and_tile_svo_byte_identical(name, depth):
    ref_svo = jax_svo(name, depth)
    ref_b = jax_brick.make_brick_svo(ref_svo)
    ref_t = jax_tile.make_tile_svo(ref_svo)
    svo = convert.svo_from_numpy(ref_svo, "cpu")
    ours_b = brick.make_brick_svo(svo)
    ours_t = tile.make_tile_svo(svo)
    for b in (ours_b, ours_t.bsvo):
        assert b.bricks.dtype == torch.int32
        assert (b.depth, b.top_depth) == (ref_b.depth, ref_b.top_depth)
        for field in ("top_masks", "top_child", "top_parent", "bricks"):
            same_bytes(getattr(b, field), getattr(ref_b, field), field)
    same_bytes(ours_t.pyr, ref_t.pyr, "pyr")
    same_bytes(ours_t.cellmap, ref_t.cellmap, "cellmap")
    assert ours_t.pyr.dtype == ours_t.cellmap.dtype == torch.int32
    # the converters carry the reference's containers over unchanged
    conv = convert.tile_svo_from_numpy(ref_t, "cpu")
    same_bytes(conv.pyr, ref_t.pyr, "converted pyr")
    same_bytes(conv.cellmap, ref_t.cellmap, "converted cellmap")
    same_bytes(conv.bsvo.bricks, ref_b.bricks, "converted bricks")
    same_bytes(convert.brick_svo_from_numpy(ref_b, "cpu").top_child,
               ref_b.top_child, "converted top_child")
    moved = ours_t.to("cpu")
    assert moved.depth == ref_t.depth and moved.top_depth == ref_t.top_depth
    assert moved.bsvo.n_bricks == ref_b.n_bricks
    assert moved.bsvo.n_top == ref_b.n_top


def test_make_brick_svo_rejects_shallow_tree():
    svo = convert.svo_from_numpy(jax_svo("sphere", 3), "cpu")
    with pytest.raises(ValueError):
        brick.make_brick_svo(svo)


def test_morton_roundtrip_and_reference():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1 << 10, (1000, 3))
    code = tile.morton3(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    np.testing.assert_array_equal(
        code, jax_tile.morton3(xyz[:, 0], xyz[:, 1], xyz[:, 2]))
    for got, want in zip(tile.unmorton3(code), xyz.T):
        np.testing.assert_array_equal(got, want)
    # the same helpers on int32 tensors (codes of up to 30 bits)
    t = torch.from_numpy(code.astype(np.int32))
    for got, want in zip(tile.unmorton3(t), xyz.T):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert tile._pyr_layout(7) == jax_tile._pyr_layout(7)


def test_bit_helpers_on_negative_words():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    words[:4] = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)
    t = torch.from_numpy(words.view(np.int32))
    assert (t < 0).any()
    pc = brick._popcount32(t)
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), tile._popcount_np(words))
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(jax_brick._popcount32(jnp.asarray(words))))
    x = torch.arange(8, dtype=torch.int32)
    np.testing.assert_array_equal(
        brick._spread3(x).numpy(), np.asarray(jax_brick._spread3(jnp.arange(8))))
    rows = torch.from_numpy(words[:3200].view(np.int32).reshape(200, 16))
    w = torch.from_numpy(rng.integers(0, 16, 200).astype(np.int32))
    np.testing.assert_array_equal(
        brick._sel16(rows, w).numpy().view(np.uint32),
        np.asarray(jax_brick._sel16(jnp.asarray(words[:3200].reshape(200, 16)),
                                    jnp.asarray(w.numpy()))))


@pytest.mark.parametrize("width,height,tile_px,jitter", [
    (64, 32, 16, None), (64, 64, 16, (0.25, 0.75)), (48, 24, 8, None)])
def test_tile_rays_bit_identical(width, height, tile_px, jitter):
    kw = dict(BENCH_CAM, width=width, height=height)
    o_r, d_r, c_r, grid_r = jax_tile.tile_rays(
        jax_camera.Camera(**kw), np, tile_px=tile_px, jitter=jitter)
    o, d, c, grid = tile.tile_rays(camera.Camera(**kw), "cpu",
                                   tile_px=tile_px, jitter=jitter)
    assert grid == grid_r
    for ours, ref in ((o, o_r), (d, d_r), (c, c_r)):
        assert ours.dtype == torch.float32
        same_bytes(ours.contiguous(), np.ascontiguousarray(ref), "rays")
    # tile order back to row-major pixels, and the inverse
    d_rows, _ = jax_camera.Camera(**kw).rays(np, jitter=jitter)[::-1]
    flat = d.reshape(-1, 3)
    np.testing.assert_array_equal(
        tile.untile_image(flat, grid, tile_px).numpy(), d_rows)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (width * height, 3), dtype=np.float32))
    assert torch.equal(tile.untile_image(tile.tile_pixels(x, grid, tile_px),
                                         grid, tile_px), x)
    y = x[:, 0].contiguous()  # a 1-D payload (masks, hit ids)
    assert torch.equal(tile.untile_image(tile.tile_pixels(y, grid, tile_px),
                                         grid, tile_px), y)
    np.testing.assert_array_equal(
        tile.tile_pixels(x, grid, tile_px).numpy(),
        jax_tile.tile_pixels(x.numpy(), grid, tile_px))


def test_tile_rays_rejects_ortho_and_misaligned():
    cam = camera.Camera(position=(0, 0, -2), look_at=(0, 0, 0),
                        ortho_height=1.0, width=64, height=64)
    with pytest.raises(ValueError):
        tile.tile_rays(cam, "cpu")
    cam2 = camera.Camera(position=(0, 0, -2), look_at=(0, 0, 0), width=60,
                         height=64)
    with pytest.raises(ValueError):
        tile.tile_rays(cam2, "cpu")


@pytest.mark.parametrize("split", [2, 4])
def test_subtile_split_matches_reference(split):
    kw = dict(BENCH_CAM, width=64, height=32)
    o_r, d_r, c_r, _ = jax_tile.tile_rays(jax_camera.Camera(**kw), np)
    o, d, c, _ = tile.tile_rays(camera.Camera(**kw), "cpu")
    o2, d2, c2 = tile._subtile_split(o, d, c, split)
    o2r, d2r, c2r = jax_tile._subtile_split(
        jnp.asarray(o_r), jnp.asarray(d_r), jnp.asarray(c_r), split)
    same_bytes(o2.contiguous(), o2r, "sub-tile origins")
    same_bytes(d2.contiguous(), d2r, "sub-tile directions")
    # the bilinear sub-corners: the same float32 expression on both sides;
    # XLA may contract its multiply-adds, so hold them to 1 ULP, and to
    # exact equality where they are the parent's own corners
    np.testing.assert_array_max_ulp(c2.numpy(), np.asarray(c2r), maxulp=1)
    T = o.shape[0]
    own = c2.reshape(T, split, split, 4, 3)
    assert torch.equal(own[:, 0, 0, 0], c[:, 0])
    assert torch.equal(own[:, 0, -1, 1], c[:, 1])
    assert torch.equal(own[:, -1, -1, 2], c[:, 2])
    assert torch.equal(own[:, -1, 0, 3], c[:, 3])
    # merge(split(x)) == x for a per-ray payload
    P = o.shape[1]
    q = int(round(P ** 0.5)) // split
    payload = torch.arange(T * P, dtype=torch.int32).reshape(T, P)
    as_rays = payload[..., None].expand(T, P, 3).to(torch.float32)
    split_payload = tile._subtile_split(as_rays, d, c, split)[0][..., 0]
    merged = tile._subtile_merge(split_payload.to(torch.int32), T, split, q)
    assert torch.equal(merged, payload)
    # every sub-tile ray direction lies inside its sub-frustum
    planes = tile._frustum_planes(c2, o2[:, 0])
    pd = torch.einsum("tpx,trx->trp", planes, d2)
    assert bool((pd >= -1e-4).all())


def test_caps_match_reference():
    for top_depth, k in ((3, 48), (7, 96), (7, 2), (9, 160)):
        assert tile._default_caps(top_depth, k) == jax_tile._default_caps(top_depth, k)
        assert tile._fb2_caps(top_depth, k) == jax_tile._fb2_caps(top_depth, k)


def test_no_device_named_and_no_card_raises():
    """With no device named, entry points use the card; here there is none,
    so they raise instead of handing back CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cam = camera.Camera(**BENCH_CAM, width=32, height=32)
    with pytest.raises(RuntimeError):
        rtt.default_device()
    with pytest.raises(RuntimeError):
        cam.rays()
    with pytest.raises(RuntimeError):
        cam.basis()
    with pytest.raises(RuntimeError):
        tile.tile_rays(cam)
    ref = jax_svo("sphere", 4)
    with pytest.raises(RuntimeError):
        convert.svo_from_numpy(ref)
    with pytest.raises(RuntimeError):
        convert.params_from_numpy(ref.leaf_albedo, ref.leaf_normal,
                                  ref.leaf_density)
    with pytest.raises(RuntimeError):
        convert.tile_svo_from_numpy(jax_tile.make_tile_svo(ref))
    with pytest.raises(RuntimeError):
        tile.make_tile_svo(convert.svo_from_numpy(ref, "cpu")).to()
    o, _d = cam.rays("cpu")
    assert o.device.type == "cpu"
