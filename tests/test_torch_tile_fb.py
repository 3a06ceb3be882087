"""The port's tile fallback passes against the JAX package's (XLA on the
CPU): ``trace_tile_fb`` with its enlarged-K and sub-tile re-walks, and
``trace_tile_exact``. Helpers and tolerances are those of
tests/test_torch_tile_trace.py; this is a file of its own so that the two
run side by side."""

import numpy as np
import pytest

from raytracingtest_tpu.ops import tile as jax_tile

from raytracingtest_tpu_torch.ops import tile
from tests.test_torch_tile_trace import (
    HIT_T_ATOL, HIT_T_RTOL, SCENES, TINY, assert_equals_per_ray,
    assert_trace_matches, per_ray, setup, tensors)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,depth", SCENES)
def test_trace_tile_fb_matches_reference(name, depth):
    ref_ts, ts, svo, rays = setup(name, depth)
    o, d, corners = tensors(rays)
    # the sub-tile pass on one scene only: each pass is one more walker for
    # XLA to compile, and test_subtile_rewalk_matches_reference holds it too
    kw = dict(k_max=8, fb_tiles=6, fb_k=64, fb2_tiles=4 if name == "terrain" else 0)
    ref, ref_res = jax_tile.trace_tile_fb(ref_ts, *rays, **kw)
    ours, residual = tile.trace_tile_fb(ts, o, d, corners, **kw)
    assert_trace_matches(ours, ref, name)
    np.testing.assert_array_equal(residual.numpy(), np.asarray(ref_res))
    assert_equals_per_ray(ours, per_ray(svo, o, d), ~residual)


@pytest.mark.parametrize("split", [2, 4])
def test_subtile_rewalk_matches_reference(split):
    """fb starved too (fb_k=4), so the sub-tile pass has real work."""
    ref_ts, ts, svo, rays = setup("terrain", 6)
    o, d, corners = tensors(rays)
    kw = dict(TINY, fb_tiles=4, fb_k=4)
    _r1, un1 = tile.trace_tile_fb(ts, o, d, corners, **kw)
    kw2 = dict(kw, fb2_tiles=o.shape[0], fb2_split=split)
    ours, un2 = tile.trace_tile_fb(ts, o, d, corners, **kw2)
    ref, ref_un2 = jax_tile.trace_tile_fb(ref_ts, *rays, **kw2)
    assert_trace_matches(ours, ref, f"split {split}")
    np.testing.assert_array_equal(un2.numpy(), np.asarray(ref_un2))
    # fb2 reduces the residual set and never flips a resolved hit
    assert int(un2.sum()) < int(un1.sum())
    assert_equals_per_ray(ours, per_ray(svo, o, d), ~un2)


@pytest.mark.parametrize("name,depth,res", [
    ("terrain", 6, 64), ("sphere", 5, 64), ("flat_ground", 6, 64),
    ("terrain", 7, 128)])
def test_trace_tile_exact_equals_per_ray_trace(name, depth, res):
    ref_ts, ts, svo, rays = setup(name, depth, res)
    o, d, corners = tensors(rays)
    exact = tile.trace_tile_exact(ts, svo, o, d, corners)
    assert assert_equals_per_ray(exact, per_ray(svo, o, d)) > 100
    if (name, res) == ("terrain", 64):  # one XLA compile of the default budgets
        ref = jax_tile.trace_tile_exact(ref_ts, *rays)
        np.testing.assert_array_equal(exact.hit_leaf.numpy(),
                                      np.asarray(ref.hit_leaf))
        np.testing.assert_allclose(exact.hit_t.numpy(), np.asarray(ref.hit_t),
                                   rtol=HIT_T_RTOL, atol=HIT_T_ATOL)
