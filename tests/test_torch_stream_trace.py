"""The streamed world's traces against the JAX package's: the two-phase
stitched traversal (K10) in its plain forms against ``trace_clipmap_device``
and ``trace_clipmap_device_brick``, the host twin against the reference's
numpy ``trace_clipmap``, and ``cli fly`` and ``cli probe``. The stitched
tile trace (K8) and ``StreamingRenderer`` are in
``tests/test_torch_stream_tile.py``, which shares this module's helpers.

On the CPU the wrappers run the plain versions (``trace_clipmap_rounds``,
``tile.candidates_plain`` with ``remap_ids``); chip_smoke.py holds the
kernels ``clipmap_trace``, ``clipmap_trace_brick`` and
``tile_candidates_mapped`` to them on the card. Tolerances: hit leaves, hit
chunks, ``truncated`` and unresolved masks exactly; hit_t within F14's rtol
1e-5 / atol 1e-6 of XLA on the CPU, and bit for bit against the numpy twin;
images to 1e-5. Chunks are of depth 4 and frames of 64² or less.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

from raytracingtest_tpu import cli as jax_cli
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from raytracingtest_tpu.stream import clipmap as jax_cm

from raytracingtest_tpu_torch import cli, diff
from raytracingtest_tpu_torch.models import StreamingRenderer
from raytracingtest_tpu_torch.ops import camera, octree
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.stream import clipmap
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HIT_T_RTOL, HIT_T_ATOL = 1e-5, 1e-6   # F14, against XLA on the CPU
# the second pose evicts most of the first's chunks
WALK = [(0.5, 0.55, 0.5), (1.3, 0.55, 1.3)]


def _world_rays(n, seed, center=(1.0, 0.4, 1.0), radius=2.5, spread=0.5):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = np.asarray(center) + radius * v
    d = np.asarray(center) + rng.normal(0, spread, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _pair(scene, arenas=(300000, 300000, 300000, 150000), **kw):
    """Both packages' clipmaps with brick arenas and their device arenas
    (the port's on the CPU)."""
    n_nodes, n_leaves, n_top, n_bricks = arenas
    ref_a, ref_b = jax_cm.Arena(n_nodes, n_leaves), jax_cm.BrickArena(n_top, n_bricks)
    a, b = clipmap.Arena(n_nodes, n_leaves), clipmap.BrickArena(n_top, n_bricks)
    ref = jax_cm.Clipmap(jax_get_scene(scene), ref_a, brick_arena=ref_b, **kw)
    ours = clipmap.Clipmap(get_scene(scene), a, brick_arena=b, **kw)
    return (ref, jax_cm.DeviceArena(ref_a), jax_cm.DeviceBrickArena(ref_b),
            ours, clipmap.DeviceArena(a, "cpu"), clipmap.DeviceBrickArena(b, "cpu"))


# ---- K10 --------------------------------------------------------------------

@pytest.fixture(scope="module")
def stitched():
    """Along a camera walk with eviction (terrain in a world of size 2, two
    LODs): each pose's rays through both packages' stitched traces, in full
    and (at the last pose, after the eviction) through the brick arena and
    with the rounds capped at 2, and the host twins."""
    ref, ref_dev, ref_devb, ours, dev, devb = _pair(
        "terrain", min_chunk_size=0.25, radius=2, lods=2, chunk_depth=4,
        world_size=2.0)
    out = []
    for step, cam in enumerate(WALK):
        st = ours.update(cam)
        ref.update(cam)
        for d_ in (ref_dev, ref_devb, dev, devb):
            d_.sync()
        o, d = _world_rays(2048, step)
        ot, dt = torch.from_numpy(o), torch.from_numpy(d)
        org, size = tuple(ours.octree.root.position), ours.octree.root.size
        rec = dict(stats=st, o=o, d=d)
        # every pose in full through the node arena; the brick arena and the
        # rounds capped at the last, after the eviction (each is one more
        # program for XLA to compile)
        last = step == len(WALK) - 1
        for arena, cap in (("node", 0), ("brick", 0), ("node", 2), ("brick", 2)):
            if (arena == "brick" or cap) and not last:
                continue
            if arena == "node":
                tables, ref_tables = ours.master(), ref.master()
                ours_fn, ref_fn = clipmap.trace_clipmap_device, jax_cm.trace_clipmap_device
                arenas = (dev, ref_dev)
            else:
                tables, ref_tables = ours.master_brick(), ref.master_brick()
                ours_fn = clipmap.trace_clipmap_device_brick
                ref_fn = jax_cm.trace_clipmap_device_brick
                arenas = (devb, ref_devb)
            trunk, roots, origins, sizes = tables
            rt, rr, ro, rs = ref_tables
            rec[(arena, cap)] = (
                ours_fn(trunk, org, size, roots, origins, sizes, 4, arenas[0], ot, dt,
                        max_chunks=cap),
                ref_fn(rt, org, size, rr, ro, rs, 4, arenas[1], o, d, max_chunks=cap))
        trunk, roots, origins, sizes = ours.master()
        rt, rr, ro, rs = ref.master()
        rec["twin"] = (
            clipmap.trace_clipmap(trunk, org, size, roots, origins, sizes, 4,
                                  ours.arena, o[:512], d[:512], max_chunks=14),
            jax_cm.trace_clipmap(rt, org, size, rr, ro, rs, 4, ref.arena,
                                 o[:512], d[:512], max_chunks=14))
        out.append(rec)
    return out


def _same_stitched(got, want, what):
    names = ("hit_leaf", "hit_t", "hit_chunk", "truncated")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        if name == "hit_t":
            np.testing.assert_allclose(a.numpy(), b, rtol=HIT_T_RTOL,
                                       atol=HIT_T_ATOL, err_msg=what)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{what} {name}")


@pytest.mark.parametrize("arena", ["node", "brick"])
def test_stitched_plain_forms_match_reference(stitched, arena):
    """trace_clipmap_device(_brick)'s plain forms: hits, chunks and
    truncated exactly, hit_t to F14, at every pose of a walk with eviction,
    with the rounds' bound and capped at two rounds (some rays truncated)."""
    evicted = truncated = hits = 0
    for i, rec in enumerate(stitched):
        evicted += rec["stats"]["evicted"]
        for cap in (0, 2):
            if (arena, cap) not in rec:
                continue
            got, want = rec[(arena, cap)]
            _same_stitched(got, want, f"{arena} pose {i} cap {cap}")
            if cap:
                truncated += int(got[3].sum())
            else:
                assert not bool(got[3].any())
                hits += int((got[0] >= 0).sum())
    assert evicted > 40 and truncated > 100 and hits > 500


def test_stitched_traces_agree_across_arenas(stitched):
    """The node arena's walk and the brick arena's walk reach the same
    leaves and chunks; the host twin equals the reference's numpy twin bit
    for bit."""
    for rec in stitched:
        if ("brick", 0) in rec:
            (node, _), (brk, _) = rec[("node", 0)], rec[("brick", 0)]
            assert torch.equal(node[0], brk[0]) and torch.equal(node[2], brk[2])
            np.testing.assert_allclose(node[1].numpy(), brk[1].numpy(), rtol=1e-6,
                                       atol=1e-6)
        twin, ref_twin = rec["twin"]
        for a, b in zip(twin, ref_twin):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int((twin[0] >= 0).sum()) > 50


# ---- the command line ---------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


FLY = ("fly", "--scene", "sphere", "--frames", "3", "--hold-frames", "2",
       "--resolution", "32", "--chunk-depth", "4", "--lods", "2", "--radius", "2",
       "--min-chunk", "0.25", "--arena-nodes", "200000", "--arena-leaves", "200000")


def _fly_direct(path, res=32, frames=3, hold=2):
    """The kept frames of `cli fly`'s camera path, rendered by direct calls
    (the model, or the stitched brick trace and shade_diff)."""
    sr = StreamingRenderer(get_scene("sphere"), min_chunk_size=0.25, radius=2,
                           lods=2, chunk_depth=4, node_capacity=200000,
                           leaf_capacity=200000, device="cpu")
    light = torch.tensor([-0.5, -1.0, -0.3])
    total, kept, acc, sample, last = frames + hold, [], None, 0, None
    for f in range(total):
        u = min(f, frames - 1) / max(frames - 1, 1)
        pos = (0.18 + 0.55 * u, 0.72, 0.12 + 0.2 * u)
        look = (0.5 + 0.3 * (u - 0.5), 0.3, 0.6)
        sr.update(np.asarray(pos))
        cam = camera.Camera(position=pos, look_at=look, fov_y_deg=55.0, width=res,
                            height=res)
        if path == "tile":
            px, _un = sr.render(cam)
        else:
            if (pos, look) != last:
                acc, sample, last = None, 0, (pos, look)
            o, d = cam.rays("cpu")
            clip = sr.clipmap
            trunk, roots, origins, sizes = clip.master_brick()
            leaf, *_ = clipmap.trace_clipmap_device_brick(
                trunk, tuple(clip.octree.root.position), clip.octree.root.size,
                roots, origins, sizes, 4, sr.device_bricks, o, d)
            img = diff.shade_diff(leaf, d, sr.device_arena.leaf_albedo,
                                  sr.device_arena.leaf_normal,
                                  sr.device_arena.leaf_density, light, 1.3,
                                  0.08).reshape(res, res, 3)
            acc = img if sample == 0 else acc + (img - acc) / (sample + 1)
            sample += 1
            px = acc
        if (f % max(total // 8, 1) == 0) or f == total - 1:
            kept.append(cli.to_pixels(px))
    return np.concatenate(kept, axis=1)


@pytest.mark.parametrize("path", ["tile", "brick"])
def test_cli_fly_strip_equals_direct_calls(tmp_path, path):
    """`fly` on each path: one line a frame, and its strip PNG equal pixel
    for pixel to the direct calls' frames."""
    _out, err = _run(cli.main, ["--device", "cpu", *FLY, "--path", path,
                                "--out-dir", str(tmp_path)])
    assert err.count("frame ") == 5 and "avg/frame" in err
    strip = np.asarray(Image.open(tmp_path / "fly_strip.png"))
    assert strip.shape == (32, 32 * 5, 3)
    np.testing.assert_array_equal(strip, _fly_direct(path))


def test_cli_probe_scripted_matches_jax(tmp_path):
    """Scripted `probe`: the probe lists, inserts and deletes print the JAX
    command's text; `render` writes the overlay of the direct calls."""
    script = ("from 0.5 0.95 0.5; to 0.5 0.05 0.5; insert 0.25 0.25 0.25 0.25; "
              "boxes; level 2; delete 0.25 0.25 0.25 0.25; delete 0.5 0.5 0.5 0.5; "
              "bogus; quit")
    argv = ["probe", "--scene", "sphere", "--depth", "4", "--commands"]
    ours, _ = _run(cli.main, ["--cache-dir", str(tmp_path), "--device", "cpu",
                              *argv, script])
    ref, _ = _run(jax_cli.main, ["--cache-dir", str(tmp_path), *argv, script])
    assert ours == ref
    assert "leaf" in ours and "inserted" in ours and "removed" in ours
    assert "not found" in ours and "unknown command" in ours

    png = tmp_path / "probe.png"
    _run(cli.main, ["--cache-dir", str(tmp_path), "--device", "cpu", *argv[:-1],
                    "--width", "48", "--height", "48", "--commands",
                    f"insert 0.25 0.25 0.25 0.25; render {png}; quit"])
    from raytracingtest_tpu_torch import viz
    from raytracingtest_tpu_torch.render import render_image
    svo = octree.build_svo(get_scene("sphere"), 4).svo
    cam = camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                        fov_y_deg=50.0, width=48, height=48)
    img = render_image(svo, cam, device="cpu").numpy().copy()
    viz.draw_boxes(img, cam, *viz.node_boxes(svo, 3), max_boxes=4096)
    viz.draw_boxes(img, cam, np.asarray([(0.25, 0.25, 0.25)], np.float32), 0.25,
                   color=(1.0, 1.0, 0.2))
    viz.draw_segment(img, cam, np.asarray([0.1, 0.9, 0.1]), np.asarray([0.9, 0.1, 0.9]))
    np.testing.assert_array_equal(np.asarray(Image.open(png)), cli.to_pixels(img))


@pytest.mark.parametrize("arena", ["node", "brick"])
def test_stitched_kernel_wrapper_refuses_cpu_tensors(arena):
    """``brick_cuda.clipmap_kernel`` takes CUDA tensors only, and says so
    before any library is asked for; the trace_clipmap_device wrappers send
    CPU rays to the plain version."""
    from raytracingtest_tpu_torch import _build
    from raytracingtest_tpu_torch.ops import brick_cuda

    _r, _rd, _rb, ours, dev, devb = _pair("sphere", arenas=(20000, 40000, 20000, 10000),
                                          min_chunk_size=0.5, radius=1, lods=1,
                                          chunk_depth=4)
    ours.update((0.5, 0.5, 0.5))
    dev.sync(), devb.sync()
    tables = ours.master() if arena == "node" else ours.master_brick()
    tree = dev.tree(4) if arena == "node" else devb.tree(4)
    o, d = (torch.from_numpy(a) for a in _world_rays(8, 0))
    name = "clipmap_trace" if arena == "node" else "clipmap_trace_brick"
    loaded = set(_build._libs)
    with pytest.raises(ValueError, match=f"the {name} kernel takes CUDA tensors"):
        brick_cuda.clipmap_kernel(tables[0], (0.0, 0.0, 0.0), 1.0, *tables[1:], tree,
                                  o, d, 4, 8)
    assert set(_build._libs) == loaded and brick_cuda.launches[name] == 0
    got = clipmap.trace_clipmap_device(*tables[:1], (0.0, 0.0, 0.0), 1.0, *tables[1:], 4,
                                       dev, o, d) if arena == "node" else \
        clipmap.trace_clipmap_device_brick(*tables[:1], (0.0, 0.0, 0.0), 1.0, *tables[1:],
                                           4, devb, o, d)
    assert got[0].shape == (8,) and got[3].dtype == torch.bool
