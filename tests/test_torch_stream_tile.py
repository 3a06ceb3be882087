"""The streamed world's stitched tile trace (K8) and ``StreamingRenderer``
against the JAX package's: ``trace_clipmap_tile`` for one LOD (also against
a monolithic build) and two LODs (also against the per-ray stitched brick
trace), ``tile.remap_ids``, and the model's accumulation against the JAX
model. Split from ``tests/test_torch_stream_trace.py`` (whose helpers it
shares) so that neither file sets the parallel run's wall alone.

On the CPU the wrappers run the plain versions (``tile.candidates_plain``
with ``remap_ids``); chip_smoke.py holds ``tile_candidates_mapped`` to them
on the card. Tolerances: hit leaves and unresolved masks exactly; hit_t
within F14's rtol 1e-5 / atol 1e-6 of XLA on the CPU; images to 1e-5.
Chunks are of depth 4 and frames of 64² or less.
"""

import numpy as np
import torch

from raytracingtest_tpu.models import StreamingRenderer as JaxStreamingRenderer
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from raytracingtest_tpu.stream import clipmap as jax_cm

from raytracingtest_tpu_torch.models import StreamingRenderer
from raytracingtest_tpu_torch.ops import camera, octree, tile, traverse
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.stream import clipmap
from tests.test_torch_stream_trace import HIT_T_ATOL, HIT_T_RTOL, _pair
from tests.test_torch_threads import one_torch_thread  # noqa: F401


# ---- K8 ---------------------------------------------------------------------

def _tile_cam(res, **kw):
    return (camera.Camera(width=res, height=res, **kw),
            jax_camera.Camera(width=res, height=res, **kw))


def _compare_tile(ours, ref, m, rm, ours_devb, ref_devb, cam, jcam, what, **budgets):
    o, d, c, _g = tile.tile_rays(cam, "cpu")
    leaf, t, un = clipmap.trace_clipmap_tile(m, ours_devb, o, d, c, **budgets)
    jo, jd, jc, _ = jax_tile.tile_rays(jcam, np)
    rleaf, rt_, run = jax_cm.trace_clipmap_tile(rm, ref_devb, jo, jd, jc, **budgets)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(rleaf), err_msg=what)
    np.testing.assert_array_equal(un.numpy(), np.asarray(run), err_msg=what)
    np.testing.assert_allclose(t.numpy(), np.asarray(rt_), rtol=HIT_T_RTOL,
                               atol=HIT_T_ATOL, err_msg=what)
    return o, d, leaf, t, un


def test_tile_one_lod_matches_reference_and_monolithic():
    """One LOD covering the unit world (chunks of 0.25 at depth 4: the grid
    of a depth-6 build), the main pass alone (the two-LOD test runs the
    fallback passes): the stitched tile trace equals the reference's, and
    on its resolved rays the monolithic depth-6 per-ray trace's hits, t and
    leaf attributes through the arena."""
    ref, _rd, ref_devb, ours, dev, devb = _pair(
        "terrain", min_chunk_size=0.25, radius=4, lods=1, chunk_depth=4)
    ref.update((0.5, 0.5, 0.5))
    ours.update((0.5, 0.5, 0.5))
    ref_devb.sync(), dev.sync(), devb.sync()
    m, rm = ours.master_tile(), ref.master_tile()
    assert len(m) == 1 and m[0].depth == 6
    cam, jcam = _tile_cam(64, position=(0.5, 0.8, -0.8), look_at=(0.5, 0.4, 0.5),
                          fov_y_deg=55.0)
    o, d, leaf, t, un = _compare_tile(ours, ref, m, rm, devb, ref_devb, cam, jcam,
                                      "one LOD", fb_tiles=0, fb2_tiles=0)
    mono = octree.build_svo(get_scene("terrain"), 6).svo
    r = traverse.trace(mono, o.reshape(-1, 3), d.reshape(-1, 3))
    hit = (r.hit_leaf >= 0) & ~un
    assert torch.equal(hit, (leaf >= 0) & ~un) and int(hit.sum()) > 200
    np.testing.assert_allclose(t[hit].numpy(), r.hit_t[hit].numpy(), rtol=1e-5, atol=1e-6)
    for name in ("leaf_albedo", "leaf_normal"):
        np.testing.assert_allclose(getattr(dev, name)[leaf[hit].long()].numpy(),
                                   getattr(mono, name)[r.hit_leaf[hit].long()].numpy(),
                                   atol=1e-6)


def test_tile_two_lods_match_reference_and_stitched_brick():
    """Two LODs: the stitched tile trace against the reference's, and its
    hits against the per-ray stitched brick trace's (the same arena
    leaves)."""
    ref, _rd, ref_devb, ours, dev, devb = _pair(
        "terrain", min_chunk_size=0.25, radius=2, lods=2, chunk_depth=4,
        arenas=(400000, 400000, 400000, 200000))
    ref.update((0.5, 0.55, 0.5))
    ours.update((0.5, 0.55, 0.5))
    ref_devb.sync(), dev.sync(), devb.sync()
    m, rm = ours.master_tile(), ref.master_tile()
    assert len(m) == 2 and sum(int((x.brickmap >= 0).sum()) for x in m) > 0
    cam, jcam = _tile_cam(64, position=(0.5, 0.75, -0.35), look_at=(0.5, 0.3, 0.6),
                          fov_y_deg=60.0)
    o, d, leaf, t, un = _compare_tile(ours, ref, m, rm, devb, ref_devb, cam, jcam,
                                      "two LODs")
    assert not bool(un.any())
    trunk, roots, origins, sizes = ours.master_brick()
    leaf2, t2, _c, _tr = clipmap.trace_clipmap_device_brick(
        trunk, tuple(ours.octree.root.position), ours.octree.root.size, roots,
        origins, sizes, 4, devb, o.reshape(-1, 3), d.reshape(-1, 3))
    hit = leaf2 >= 0
    assert int(hit.sum()) > 200 and torch.equal(hit, leaf >= 0)
    assert torch.equal(leaf[hit], leaf2[hit])
    np.testing.assert_allclose(t[hit].numpy(), t2[hit].numpy(), rtol=1e-4, atol=1e-5)


def test_remap_ids_keeps_misses():
    ids = torch.tensor([[0, 3, -1], [2, -1, -1]], dtype=torch.int32)
    brickmap = torch.tensor([7, 9, 11, 40], dtype=torch.int32)
    assert tile.remap_ids(ids, brickmap).tolist() == [[7, 40, -1], [11, -1, -1]]


# ---- StreamingRenderer --------------------------------------------------------

def test_streaming_renderer_matches_jax_model():
    """Accumulation at a resting pose (jitter from the same seed), the reset
    on a pose change and on accumulate=False, each frame's image to 1e-5 of
    the JAX model's and its residual equal (without the sub-tile pass: one
    program less for XLA to compile)."""
    kw = dict(min_chunk_size=0.25, radius=4, lods=1, chunk_depth=4,
              node_capacity=300000, leaf_capacity=300000)
    ref = JaxStreamingRenderer(jax_get_scene("sphere"), **kw)
    ours = StreamingRenderer(get_scene("sphere"), device="cpu", **kw)
    st, rst = ours.update((0.5, 0.5, 0.5)), ref.update((0.5, 0.5, 0.5))
    assert st == rst and st["added"] > 0 and st["node_spans"] > 0
    pose = dict(look_at=(0.5, 0.5, 0.5), fov_y_deg=50.0)
    moved = dict(pose, position=(0.52, 0.7, -0.9))
    pose = dict(pose, position=(0.5, 0.7, -0.9))
    counts = []
    for p, accumulate in ((pose, True), (pose, True), (pose, True), (moved, True),
                          (moved, False)):
        cam, jcam = _tile_cam(32, **p)
        img, un = ours.render(cam, accumulate=accumulate, fb2_tiles=0)
        rimg, run = ref.render(jcam, accumulate=accumulate, fb2_tiles=0)
        assert un == run == 0
        assert img.shape == (32, 32, 3)
        np.testing.assert_allclose(img.numpy(), rimg, atol=1e-5)
        counts.append(ours.sample_count)
        assert counts[-1] == ref.sample_count
    assert counts == [1, 2, 3, 1, 1]
    acc, un = ours.render(cam, fetch=False, fb2_tiles=0)
    assert acc.shape == (32 * 32, 3) and int(un) == 0 and ours.sample_count == 2
