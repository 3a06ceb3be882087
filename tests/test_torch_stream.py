"""The streamed world's host side against the JAX package's
(``raytracingtest_tpu/stream``): the chunk octree, the arenas, the clipmap's
rings and its stitched tile structures, and the per-ray `root=` hook of the
plain traces.

Both packages run the same operations on the same seeded inputs. Host
arrays must be equal (bricks compared as uint32 bit patterns); the traces
with roots give hit leaves exactly and hit_t within F14's rtol 1e-5 /
atol 1e-6 of XLA on the CPU. Chunks are of depth 4, so a walk builds in
seconds.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.ops.octree import SVO as JaxSVO
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from raytracingtest_tpu.stream import chunk_octree as jax_co
from raytracingtest_tpu.stream import clipmap as jax_cm

from raytracingtest_tpu_torch.ops import brick, octree, traverse
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.stream import chunk_octree, clipmap
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HIT_T_RTOL, HIT_T_ATOL = 1e-5, 1e-6   # F14, against XLA on the CPU
# camera poses in a world of size 2, so that both rings move: new chunks
# land in evicted chunks' rows
WALK = [(0.5, 0.55, 0.5), (1.3, 0.55, 1.3), (0.3, 0.55, 0.3), (1.6, 0.3, 0.4),
        (0.5, 0.55, 0.5)]


# ---- the chunk octree -------------------------------------------------------

def _octree_ops(seed):
    """A seeded sequence of 0.25-chunks on the lattice around and outside
    the unit cube (so the root grows), and which of them to remove."""
    rng = np.random.default_rng(seed)
    cells = [(x, y, z) for x in range(-2, 6) for y in range(-1, 5)
             for z in range(-2, 4)]
    pick = rng.choice(len(cells), 40, replace=False)
    adds = [tuple(0.25 * np.array(cells[i], np.float64)) for i in pick]
    removes = [adds[i] for i in rng.choice(40, 28, replace=False)]
    return adds, removes


def _same_octree(a, b, rng):
    assert a.n_chunks == b.n_chunks
    np.testing.assert_array_equal(a.root.position, b.root.position)
    assert a.root.size == b.root.size
    ca, cb = a.chunks(), b.chunks()
    assert [(tuple(p), s, c) for p, s, c in ca] == [(tuple(p), s, c) for p, s, c in cb]
    for p in rng.uniform(-1.0, 2.0, (200, 3)):
        assert a.find_chunk(p) == b.find_chunk(p)
    ref_trunk, ref_table = a.extract_trunk()
    trunk, table = b.extract_trunk()
    for name in ("masks", "child_base", "leaf_base"):
        np.testing.assert_array_equal(getattr(trunk, name).numpy(),
                                      np.asarray(getattr(ref_trunk, name)))
    assert (trunk.depth, trunk.level_start) == (ref_trunk.depth, ref_trunk.level_start)
    np.testing.assert_array_equal(trunk.parent_ptr.numpy(), octree.compute_parent_ptr(
        trunk.masks.numpy(), trunk.child_base.numpy()))
    assert trunk.n_leaves == len(table) == len(ref_table)
    assert [(tuple(p), s, c) for p, s, c in table] == [
        (tuple(p), s, c) for p, s, c in ref_table]


def test_chunk_octree_matches_reference():
    """Adds that grow the root, finds, removes that prune and shrink it,
    and the trunk (masks, pointers, levels, chunk table) after each phase."""
    rng = np.random.default_rng(0)
    adds, removes = _octree_ops(1)
    ref, ours = jax_co.ChunkOctree(), chunk_octree.ChunkOctree()
    for i, p in enumerate(adds):
        ref.add_chunk(p, 0.25, i)
        ours.add_chunk(p, 0.25, i)
    assert ours.root.size == ref.root.size == 8.0     # grown three times
    _same_octree(ref, ours, rng)
    for p in removes:
        assert ref.remove_chunk(p, 0.25) == ours.remove_chunk(p, 0.25) is True
    assert ref.remove_chunk(removes[0], 0.25) is ours.remove_chunk(removes[0], 0.25) is False
    _same_octree(ref, ours, rng)
    # removing everything simplifies the root down to one chunk's parent
    for p in set(adds) - set(removes):
        assert ours.remove_chunk(p, 0.25) and ref.remove_chunk(p, 0.25)
    assert ours.n_chunks == 0 and ours.root.size == ref.root.size
    ours.add_chunk((0.0, 0.0, 0.0), 0.25, "a")
    with pytest.raises(ValueError):
        ours.add_chunk((0.0, 0.0, 0.0), 0.25, "b")


# ---- the arenas -------------------------------------------------------------

def _chunk_builds(names_positions, depth=4):
    """(reference SVO, port SVO) of chunk builds of a world scene."""
    out = []
    for name, pos, size in names_positions:
        pos = np.asarray(pos, np.float64)
        ref_sub = jax_cm._chunk_scene(jax_get_scene(name), pos, size)
        sub = clipmap._chunk_scene(get_scene(name), pos, size)
        ref = jax_cm.build_svo(ref_sub, depth,
                               attr_frame=(jax_get_scene(name), pos, size)).svo
        ours = octree.build_svo(sub, depth, attr_frame=(get_scene(name), pos, size)).svo
        out.append((ref, ours))
    return out


ARENA_CHUNKS = [("terrain", (0.0, 0.0, 0.0), 0.5), ("terrain", (0.5, 0.0, 0.5), 0.5),
                ("sphere", (0.25, 0.25, 0.25), 0.25), ("terrain", (0.25, 0.0, 0.25), 0.25),
                ("sphere", (0.5, 0.5, 0.5), 0.25)]


def test_arena_upload_rebases_and_frees_coalesce():
    """Uploads rebase child and leaf pointers by their offsets; a freed
    middle chunk's ranges merge with their neighbours and are reused first
    fit; the brick arena rebases top rows, brick ids and leaf bases."""
    builds = _chunk_builds(ARENA_CHUNKS)
    ref_a, ours_a = jax_cm.Arena(20000, 40000), clipmap.Arena(20000, 40000)
    ref_b, ours_b = jax_cm.BrickArena(20000, 10000), clipmap.BrickArena(20000, 10000)
    placed = []
    for ref_svo, svo in builds[:4]:
        r = ref_a.upload(ref_svo)
        assert ours_a.upload(svo) == r
        assert ours_b.upload(svo, r[1]) == ref_b.upload(ref_svo, r[1])
        placed.append((r, svo))
    # free the second and third: their ranges coalesce into one
    for (node_off, leaf_off), svo in placed[1:3]:
        chunk = clipmap.Chunk(np.zeros(3), 0.5, 0, 0, node_off, svo.n_nodes, leaf_off,
                              svo.n_leaves, svo.depth, svo.level_start)
        ref_a.free(chunk)
        ours_a.free(chunk)
    assert ours_a._free_nodes == ref_a._free_nodes and len(ours_a._free_nodes) == 2
    assert ours_a._free_leaves == ref_a._free_leaves
    ref_svo, svo = builds[4]
    r = ref_a.upload(ref_svo)
    assert ours_a.upload(svo) == r and r[0] == placed[1][0][0]   # first fit: the hole
    assert ours_a.upload(svo) == ref_a.upload(ref_svo)
    for name in ("masks", "child_base", "leaf_base", "leaf_albedo", "leaf_normal",
                 "leaf_density"):
        np.testing.assert_array_equal(getattr(ours_a, name), getattr(ref_a, name))
    assert ours_a.dirty == ref_a.dirty and ours_a.nodes_used == ref_a.nodes_used
    for name in ("top_masks", "top_child", "top_parent"):
        np.testing.assert_array_equal(getattr(ours_b, name), getattr(ref_b, name))
    np.testing.assert_array_equal(ours_b.bricks.view(np.uint32), ref_b.bricks)
    assert ours_b.dirty == ref_b.dirty


@pytest.mark.parametrize("seed", [0, 1])
def test_span_grouping_and_padding_match_reference(seed):
    rng = np.random.default_rng(seed)
    spans = [(int(o), int(n), int(o2), int(n2)) for o, n, o2, n2 in zip(
        rng.integers(0, 5000, 12), rng.integers(1, 300, 12),
        rng.integers(0, 9000, 12), rng.integers(0, 600, 12))]
    for slack in (1, 8):
        for off, ln in ((0, 1), (2, 3)):
            assert clipmap._coalesce_spans(spans, slack, off, ln) == \
                jax_cm._coalesce_spans(spans, slack, off, ln)
    for lo, hi, cap in ((0, 1, 8), (5, 9, 16), (14, 17, 16), (3, 40, 64), (60, 63, 64)):
        ln = 1
        while ln < hi - lo:
            ln <<= 1
        want = (0, cap) if ln >= cap else ((lo if lo + ln <= cap else cap - ln), ln)
        assert clipmap._pad(lo, hi, cap) == want


# ---- the clipmap ------------------------------------------------------------

@pytest.fixture(scope="module")
def walked():
    """Both packages' clipmaps (terrain in a world cube of size 2, chunks of
    0.25 and 0.5 at depth 4, radius 2, two LODs, with brick arenas) after
    each pose of WALK: the
    stats, the device arenas' spans, the resident sets and the masters."""
    ref_a, ref_b = jax_cm.Arena(300000, 300000), jax_cm.BrickArena(300000, 150000)
    ours_a, ours_b = clipmap.Arena(300000, 300000), clipmap.BrickArena(300000, 150000)
    kw = dict(min_chunk_size=0.25, radius=2, lods=2, chunk_depth=4, world_size=2.0)
    ref = jax_cm.Clipmap(jax_get_scene("terrain"), ref_a, brick_arena=ref_b, **kw)
    ours = clipmap.Clipmap(get_scene("terrain"), ours_a, brick_arena=ours_b, **kw)
    ref_dev, ours_dev = jax_cm.DeviceArena(ref_a), clipmap.DeviceArena(ours_a, "cpu")
    ref_devb, ours_devb = jax_cm.DeviceBrickArena(ref_b), clipmap.DeviceBrickArena(ours_b, "cpu")
    steps = []
    for cam in WALK:
        st = (ref.update(cam), ours.update(cam))
        spans = ((ref_dev.sync(), ref_devb.sync()), (ours_dev.sync(), ours_devb.sync()))
        steps.append(dict(stats=st, spans=spans,
                          resident=(dict(ref.resident), dict(ours.resident)),
                          masters=(ref.master_tile(), ours.master_tile()),
                          parent_ok=_parents_ok(ours, ours_dev)))
    return dict(ref=ref, ours=ours, ref_dev=ref_dev, ours_dev=ours_dev,
                ref_devb=ref_devb, ours_devb=ours_devb, steps=steps)


def _parents_ok(clip, dev):
    """Rows of live chunks whose derived parent pointer (over the whole
    arena, freed rows included) is not the chunk's own parent."""
    pp = dev.parent_ptr.numpy()
    bad = 0
    for c in clip.resident.values():
        sl = slice(c.node_offset, c.node_offset + c.n_nodes)
        m = clip.arena.masks[sl]
        cb = np.where((m >> 8) & ~m & 0xFF, clip.arena.child_base[sl] - c.node_offset, 0)
        own = octree.compute_parent_ptr(m, cb.astype(np.int32)) + c.node_offset
        bad += int((pp[sl][1:] != own[1:]).sum())
    return bad


def test_clipmap_walk_matches_reference(walked):
    """Update stats, span counts, the resident set (keys, offsets, times)
    and every host and device arena array, at each pose; eviction and
    reuse happen along the walk."""
    evicted = reused = 0
    for step in walked["steps"]:
        assert step["stats"][0] == step["stats"][1]
        assert step["spans"][0] == step["spans"][1]
        ref_res, res = step["resident"]
        assert ref_res.keys() == res.keys()
        for key, c in res.items():
            r = ref_res[key]
            for f in ("size", "lod", "creation_time", "node_offset", "n_nodes",
                      "leaf_offset", "n_leaves", "depth", "level_start", "top_offset",
                      "n_top", "brick_offset", "n_bricks"):
                assert getattr(c, f) == getattr(r, f), (key, f)
            np.testing.assert_array_equal(c.position, r.position)
            np.testing.assert_array_equal(c.cell_occ, r.cell_occ)
        evicted += step["stats"][1]["evicted"]
    ours, ref = walked["ours"], walked["ref"]
    for name in ("masks", "child_base", "leaf_base", "leaf_albedo", "leaf_normal",
                 "leaf_density"):
        np.testing.assert_array_equal(getattr(ours.arena, name), getattr(ref.arena, name))
        np.testing.assert_array_equal(getattr(walked["ours_dev"], name).numpy(),
                                      np.asarray(getattr(walked["ref_dev"], name)))
    for name in ("top_masks", "top_child", "top_parent"):
        np.testing.assert_array_equal(getattr(walked["ours_devb"], name).numpy(),
                                      np.asarray(getattr(walked["ref_devb"], name)))
    np.testing.assert_array_equal(walked["ours_devb"].bricks.numpy().view(np.uint32),
                                  np.asarray(walked["ref_devb"].bricks))
    assert ours.arena._free_nodes == ref.arena._free_nodes
    assert evicted > 50
    # evicted chunks' rows are reused by other chunks along the walk
    held = {}
    for step in walked["steps"]:
        for key, c in step["resident"][1].items():
            reused += held.setdefault(c.node_offset, key) != key
            held[c.node_offset] = key
    assert reused > 5


def test_rings_disjoint_and_parent_pointers_survive_reuse(walked):
    """No two resident chunks overlap (the finer ring's cells are skipped
    at the coarser LOD), and after eviction and slot reuse the parent
    pointers derived over the whole arena, stale rows included, are each
    live chunk's own: a stale row's child pointer points forward into a
    chunk that starts after it, whose true parent row is larger."""
    for step in walked["steps"]:
        boxes = [(c.position, c.position + c.size) for c in step["resident"][1].values()]
        lo = np.array([b[0] for b in boxes])
        hi = np.array([b[1] for b in boxes])
        inter = np.all((np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None], lo[None]))
                       > 1e-9, axis=2)
        np.fill_diagonal(inter, False)
        assert not inter.any()
        assert step["parent_ok"] == 0
    lods = {c.lod for step in walked["steps"] for c in step["resident"][1].values()}
    assert lods == {0, 1}


def test_chunk_scene_scales_density():
    """The chunk scene is the world scene at p * size + origin, divided by
    size: bit for bit the reference's."""
    rng = np.random.default_rng(5)
    x, y, z = (rng.random(4096, dtype=np.float32) for _ in range(3))
    for name, pos, size in (("terrain", (0.25, 0.0, 0.5), 0.25), ("sphere", (0.5, 0.5, 0.0), 0.5)):
        ours = clipmap._chunk_scene(get_scene(name), pos, size)
        ref = jax_cm._chunk_scene(jax_get_scene(name), np.asarray(pos), size)
        got = ours.fn(x, y, z)
        np.testing.assert_array_equal(got, ref.fn(x, y, z, np))
        world = get_scene(name).fn(x * size + pos[0], y * size + pos[1], z * size + pos[2])
        np.testing.assert_allclose(got * size, world, rtol=1e-6, atol=1e-7)
        assert ours.lipschitz == get_scene(name).lipschitz


def test_master_tile_matches_reference(walked):
    """Each LOD's stitched pyramid, cellmap and brickmap, array for array."""
    n = 0
    for step in walked["steps"]:
        ref_m, ours_m = step["masters"]
        assert len(ref_m) == len(ours_m) == 2
        for r, m in zip(ref_m, ours_m):
            assert (m.depth, m.top_depth) == (r.depth, r.top_depth)
            np.testing.assert_array_equal(m.pyr.numpy().view(np.uint32), r.pyr)
            np.testing.assert_array_equal(m.cellmap.numpy(), r.cellmap)
            np.testing.assert_array_equal(m.brickmap.numpy(), r.brickmap)
            n += int((m.brickmap >= 0).sum())
    assert n > 400


# ---- the root= hook ---------------------------------------------------------

@partial(jax.jit, static_argnames=("depth",))
def _ref_core(masks, child, leaf_base, pptr, o, d, root, depth):
    return jax_traverse._trace_core(masks, child, leaf_base, pptr, o, d, depth, root=root)


@partial(jax.jit, static_argnames=("depth", "top_depth"))
def _ref_brick_core(tm, tc, tp, bricks, o, d, root, depth, top_depth):
    return jax_brick._trace_brick_core(tm, tc, tp, bricks, o, d, depth, top_depth,
                                       root=root)


def _chunk_rays(clip, n, seed):
    """Rays in chunk-local coordinates toward random resident chunks that
    hold leaves, with the chunks' node and top roots."""
    rng = np.random.default_rng(seed)
    chunks = [c for c in clip.resident.values() if c.n_leaves > 1]
    pick = rng.integers(0, len(chunks), n)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = (0.5 + 1.5 * v).astype(np.float32)
    d = ((0.5 + rng.normal(0, 0.25, (n, 3))) - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    roots = np.array([chunks[i].node_offset for i in pick], np.int32)
    tops = np.array([chunks[i].top_offset for i in pick], np.int32)
    return o, d, roots, tops


def test_root_hook_matches_reference(walked):
    """trace_stackless(root=) and trace_brick(root=) through the walked
    arenas against _trace_core(root=) and _trace_brick_core(root=); the
    stack-based trace(root=) against the numpy oracle's trace_numpy(root=);
    root=None is root 0."""
    ours, dev, devb = walked["ours"], walked["ours_dev"], walked["ours_devb"]
    o, d, roots, tops = _chunk_rays(ours, 4096, 7)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tree = dev.tree(4)
    got = traverse.trace_stackless(tree, ot, dt, root=torch.from_numpy(roots))
    ref_dev = walked["ref_dev"]
    pptr = jax_traverse.derive_parent_ptr_jnp(ref_dev.masks, ref_dev.child_base)
    want = _ref_core(ref_dev.masks, ref_dev.child_base, ref_dev.leaf_base, pptr,
                     jnp.asarray(o), jnp.asarray(d), jnp.asarray(roots), depth=4)
    np.testing.assert_array_equal(got.hit_leaf.numpy(), np.asarray(want.hit_leaf))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_allclose(got.hit_t.numpy(), np.asarray(want.hit_t),
                               rtol=HIT_T_RTOL, atol=HIT_T_ATOL)
    assert int((got.hit_leaf >= 0).sum()) > 1000

    gb = brick.trace_brick(devb.tree(4), ot, dt, root=torch.from_numpy(tops))
    rb = walked["ref_devb"]
    wb = _ref_brick_core(rb.top_masks, rb.top_child, rb.top_parent, rb.bricks,
                         jnp.asarray(o), jnp.asarray(d), jnp.asarray(tops),
                         depth=4, top_depth=1)
    np.testing.assert_array_equal(gb.hit_leaf.numpy(), np.asarray(wb.hit_leaf))
    np.testing.assert_allclose(gb.hit_t.numpy(), np.asarray(wb.hit_t),
                               rtol=HIT_T_RTOL, atol=HIT_T_ATOL)
    # the brick walk from a top root reaches the stackless walk's leaves
    np.testing.assert_array_equal(gb.hit_leaf.numpy(), got.hit_leaf.numpy())

    # the stack-based walk with roots, against the numpy oracle on the same arena
    ref_arena = walked["ref"].arena
    ref_svo = JaxSVO(masks=ref_arena.masks, child_base=ref_arena.child_base,
                     leaf_base=ref_arena.leaf_base, leaf_albedo=ref_arena.leaf_albedo,
                     leaf_normal=ref_arena.leaf_normal,
                     leaf_density=ref_arena.leaf_density, depth=4,
                     level_start=(0,) * 5)
    stack = traverse.trace(tree, ot[:1024], dt[:1024], root=torch.from_numpy(roots[:1024]))
    oracle = jax_traverse.trace_numpy(ref_svo, o[:1024], d[:1024], root=roots[:1024])
    np.testing.assert_array_equal(stack.hit_leaf.numpy(), oracle.hit_leaf)
    np.testing.assert_array_equal(stack.hit_t.numpy(), oracle.hit_t)

    # root=None keeps every bit: the same as rooting every ray at row 0
    svo = octree.build_svo(get_scene("terrain"), 5).svo
    a = traverse.trace_stackless(svo, ot, dt)
    b = traverse.trace_stackless(svo, ot, dt, root=0)
    for name in ("hit_leaf", "hit_t", "hit_parent", "hit_child", "iters"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_coarse_ring_dropped_when_only_the_fine_ring_moves():
    """The reference's fault, kept for parity (ROADMAP, Queue 3): a move that
    changes the fine ring's snap but not the coarse ring's skips the coarse
    LOD's update (its early-out) yet evicts every chunk not refreshed in
    this update, so the coarse ring's chunks go and none comes back."""
    kw = dict(min_chunk_size=0.25, radius=2, lods=2, chunk_depth=4, world_size=2.0)
    ref = jax_cm.Clipmap(jax_get_scene("terrain"), jax_cm.Arena(300000, 300000), **kw)
    ours = clipmap.Clipmap(get_scene("terrain"), clipmap.Arena(300000, 300000), **kw)
    for cam, coarse in (((0.3, 0.55, 0.3), 6), ((0.6, 0.55, 0.3), 0)):
        assert ours.update(cam) == ref.update(cam)
        lods = [c.lod for c in ours.resident.values()]
        assert lods.count(1) == coarse
        assert sorted(ours.resident) == sorted(ref.resident)
