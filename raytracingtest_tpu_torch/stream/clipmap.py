"""Clipmap streaming: camera-centred LOD rings of chunk SVOs in arenas on the
card, stitched under a trunk SVO and traced.

Port of ``raytracingtest_tpu/stream/clipmap.py``:

  * ``Arena`` / ``BrickArena``: every resident chunk's rows in shared flat
    host arrays (numpy), placed by a first-fit allocator; an upload rebases
    the chunk's absolute pointers by the offsets it got.
  * ``DeviceArena`` / ``DeviceBrickArena``: full-capacity tensors on the
    device. ``sync()`` keeps the reference's grouping of dirty spans and its
    power-of-two padding, and writes each group with ``Tensor.copy_`` from
    pinned host memory (the reference's ``dynamic_update_slice`` programs are
    copies with no arithmetic: the card's copy engine does that job). The node
    arena's parent pointers, which the reference derives on every trace, are
    derived once a sync and kept; the values are the same.
  * ``Clipmap``: the rings (chunk size min_chunk_size * 2^lod, the camera
    snapped to a 2 * chunk grid, early-out on an unchanged snap, cells of a
    finer ring skipped, chunks not refreshed evicted), built with the host
    ``build_svo(..., attr_frame=)``; ``master``, ``master_brick`` and
    ``master_tile`` stitch the resident set for the traces.
  * ``trace_clipmap_tile`` / ``render_clipmap_tile`` (K8): each LOD's
    stitched pyramid through the tile trace, its bricks fetched from the
    brick arena through the brickmap (phase 1 in the brickmap mode of
    ``tile_candidates`` on the card), composed by least t; shading and the
    progressive accumulation stay on the device.
  * ``trace_clipmap_device`` / ``trace_clipmap_device_brick`` (K10): the
    two-phase stitched traversal, kernels ``clipmap_trace`` and
    ``clipmap_trace_brick`` on the card (``brick_cuda.clipmap_kernel``),
    ``trace_clipmap_rounds`` on the CPU. ``trace_clipmap`` is the
    reference's numpy twin: a host function on CPU tensors over the per-ray
    ``traverse.trace`` with roots, never called on the card.

Entry points that take rays run where the rays lie; the arenas default to
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops import brick, tile, traverse
from raytracingtest_tpu_torch.ops.octree import SVO, build_svo
from raytracingtest_tpu_torch.scenes import Scene
from raytracingtest_tpu_torch.stream.chunk_octree import ChunkOctree

_F32, _I32 = torch.float32, torch.int32


def _alloc_range(free_list, n):
    """First-fit allocation from a sorted (offset, length) free list."""
    for i, (off, length) in enumerate(free_list):
        if length >= n:
            if length == n:
                free_list.pop(i)
            else:
                free_list[i] = (off + n, length - n)
            return off
    raise MemoryError(f"arena exhausted: need {n}")


def _free_range(free_list, off, n):
    """Return (off, n) to the free list and merge adjacent ranges."""
    free_list.append((off, n))
    free_list.sort()
    merged = []
    for o, length in free_list:
        if merged and merged[-1][0] + merged[-1][1] == o:
            merged[-1] = (merged[-1][0], merged[-1][1] + length)
        else:
            merged.append((o, length))
    free_list[:] = merged


@dataclasses.dataclass
class Chunk:
    """A resident chunk's record."""

    position: np.ndarray   # world low corner
    size: float
    lod: int
    creation_time: int
    node_offset: int
    n_nodes: int
    leaf_offset: int
    n_leaves: int
    depth: int
    level_start: tuple
    # brick-arena placement (0-sized without a BrickArena)
    top_offset: int = 0
    n_top: int = 0
    brick_offset: int = 0
    n_bricks: int = 0
    # chunk-local morton occupancy of the brick-cut cells (uint32 words;
    # set with a BrickArena): master_tile's input
    cell_occ: Optional[np.ndarray] = None


class Arena:
    """Flat SVO arena on the host: every resident chunk's node and leaf
    rows in shared arrays, so one trace serves all chunks (per-ray roots)."""

    def __init__(self, node_capacity: int, leaf_capacity: int):
        self.node_capacity = node_capacity
        self.leaf_capacity = leaf_capacity
        self.masks = np.zeros(node_capacity, np.int32)
        self.child_base = np.zeros(node_capacity, np.int32)
        self.leaf_base = np.zeros(node_capacity, np.int32)
        self.leaf_albedo = np.zeros((leaf_capacity, 3), np.float32)
        self.leaf_normal = np.zeros((leaf_capacity, 3), np.float32)
        self.leaf_density = np.zeros(leaf_capacity, np.float32)
        self._free_nodes = [(0, node_capacity)]
        self._free_leaves = [(0, leaf_capacity)]
        # spans written since the last DeviceArena.sync(): (node_off,
        # n_nodes, leaf_off, n_leaves)
        self.dirty: list = []

    def upload(self, svo: SVO):
        """Place a chunk SVO (CPU tensors) into the arena, rebasing its
        child and leaf pointers by the offsets allocated. Returns (node_off,
        leaf_off)."""
        n_nodes, n_leaves = svo.n_nodes, svo.n_leaves
        node_off = _alloc_range(self._free_nodes, max(n_nodes, 1))
        leaf_off = _alloc_range(self._free_leaves, max(n_leaves, 1))
        masks = svo.masks.numpy()
        sl = slice(node_off, node_off + n_nodes)
        self.masks[sl] = masks
        self.child_base[sl] = np.where(
            (masks >> 8) & ~masks & 0xFF, svo.child_base.numpy() + node_off, 0)
        self.leaf_base[sl] = np.where(
            masks & 0xFF, svo.leaf_base.numpy() + leaf_off, 0)
        ll = slice(leaf_off, leaf_off + n_leaves)
        self.leaf_albedo[ll] = svo.leaf_albedo.numpy()
        self.leaf_normal[ll] = svo.leaf_normal.numpy()
        self.leaf_density[ll] = svo.leaf_density.numpy()
        self.dirty.append((node_off, n_nodes, leaf_off, n_leaves))
        return node_off, leaf_off

    def free(self, chunk: Chunk):
        _free_range(self._free_nodes, chunk.node_offset, max(chunk.n_nodes, 1))
        _free_range(self._free_leaves, chunk.leaf_offset, max(chunk.n_leaves, 1))

    @property
    def nodes_used(self):
        return self.node_capacity - sum(length for _, length in self._free_nodes)


class BrickArena:
    """The brick-decomposed twin of Arena: each resident chunk's BrickSVO
    (top tree and bricks) in shared flat host arrays, so the brick trace
    serves every chunk from per-ray roots. Leaf attribute rows stay in the
    companion Arena: brick leaf bases are rebased to its leaf offsets.
    Bricks are int32 bit patterns of the reference's uint32 words."""

    def __init__(self, top_capacity: int, brick_capacity: int):
        self.top_capacity = top_capacity
        self.brick_capacity = brick_capacity
        self.top_masks = np.zeros(top_capacity, np.int32)
        self.top_child = np.zeros(top_capacity, np.int32)
        self.top_parent = np.zeros(top_capacity, np.int32)
        self.bricks = np.zeros((brick_capacity, 17), np.int32)
        self._free_top = [(0, top_capacity)]
        self._free_bricks = [(0, brick_capacity)]
        # spans written since the last DeviceBrickArena.sync(): (top_off,
        # n_top, brick_off, n_bricks)
        self.dirty: list = []

    def upload(self, svo: SVO, leaf_off: int):
        """Brick-decompose a chunk SVO into the arena, rebasing interior
        child rows by top_off, cut-level rows by brick_off and brick leaf
        bases by leaf_off. Returns (top_off, brick_off, n_top, n_bricks)."""
        bs = brick.make_brick_svo(svo)
        n_top, n_bricks = bs.n_top, bs.n_bricks
        top_off = _alloc_range(self._free_top, max(n_top, 1))
        brick_off = _alloc_range(self._free_bricks, max(n_bricks, 1))
        lo = int(svo.level_start[bs.top_depth - 1])   # the cut level's start
        tc = bs.top_child.numpy().copy()
        tc[:lo] += top_off
        tc[lo:] += brick_off
        sl = slice(top_off, top_off + n_top)
        self.top_masks[sl] = bs.top_masks.numpy()
        self.top_child[sl] = tc
        self.top_parent[sl] = bs.top_parent.numpy() + top_off
        bricks = bs.bricks.numpy().copy()
        bricks[:, 16] += leaf_off
        self.bricks[brick_off:brick_off + n_bricks] = bricks
        self.dirty.append((top_off, n_top, brick_off, n_bricks))
        return top_off, brick_off, n_top, n_bricks

    def free(self, top_off, n_top, brick_off, n_bricks):
        _free_range(self._free_top, top_off, max(n_top, 1))
        _free_range(self._free_bricks, brick_off, max(n_bricks, 1))


def _coalesce_spans(spans, slack, off_idx=0, len_idx=1):
    """Greedy grouping of dirty spans by offset: a span joins the current
    group while the group's bounding range stays within `slack` times the
    summed span lengths, so that two small spans at opposite ends of a
    recycled arena upload apart and not as one near-full range."""
    spans = sorted(spans, key=lambda s: s[off_idx])
    groups = [[spans[0]]]
    lo = spans[0][off_idx]
    hi = lo + spans[0][len_idx]
    tot = spans[0][len_idx]
    for s in spans[1:]:
        nhi = max(hi, s[off_idx] + s[len_idx])
        if (nhi - lo) <= slack * (tot + s[len_idx]):
            groups[-1].append(s)
            hi, tot = nhi, tot + s[len_idx]
        else:
            groups.append([s])
            lo = s[off_idx]
            hi = lo + s[len_idx]
            tot = s[len_idx]
    return groups


def _pad(lo, hi, cap):
    """The range [lo, hi) widened to a power-of-two length inside [0, cap):
    (start, length), the whole arena once the length reaches it."""
    ln = 1
    while ln < hi - lo:
        ln <<= 1
    if ln >= cap:
        return 0, cap
    return (lo if lo + ln <= cap else cap - ln), ln


class _Mirror:
    """Device copies of some of a host arena's arrays. On a CUDA device the
    host arrays move into pinned memory (the arena's attributes become
    numpy views of it), so that each span copies asynchronously; a sync
    waits for its copies before the host writes the arena again."""

    def __init__(self, host, names, device):
        self.device = resolve(device)
        self._host = {}
        for name in names:
            a = getattr(host, name)
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t)
                setattr(host, name, pinned.numpy())
                t = pinned
            self._host[name] = t
            setattr(self, name, t.to(self.device, copy=True))

    def _copy(self, name, lo, n):
        getattr(self, name)[lo:lo + n].copy_(self._host[name][lo:lo + n],
                                             non_blocking=True)

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


class DeviceArena(_Mirror):
    """The Arena's arrays at full capacity on `device` (None: the card),
    updated span by span (see the module's docstring), with the node rows'
    parent pointers."""

    COALESCE_SLACK = 8
    NAMES = ("masks", "child_base", "leaf_base", "leaf_albedo", "leaf_normal",
             "leaf_density")

    def __init__(self, arena: Arena, device=None):
        super().__init__(arena, self.NAMES, device)
        self.arena = arena
        self.parent_ptr = traverse.derive_parent_ptr(self.masks, self.child_base)
        arena.dirty.clear()

    def sync(self) -> int:
        """Copy the dirty spans (host arena -> device). Returns the number
        of spans applied."""
        spans = self.arena.dirty
        n = len(spans)
        if n == 0:
            return 0
        cap_n, cap_l = self.masks.shape[0], self.leaf_density.shape[0]
        for g in _coalesce_spans(spans, self.COALESCE_SLACK):
            n0 = min(s[0] for s in g)
            n1 = max(s[0] + s[1] for s in g)
            leaf_spans = [s for s in g if s[3]]
            l0 = min((s[2] for s in leaf_spans), default=0)
            l1 = max((s[2] + s[3] for s in leaf_spans), default=0)
            n0, ln = _pad(n0, max(n1, n0 + 1), cap_n)
            l0, ll = _pad(l0, max(l1, l0 + 1), cap_l)
            for name in self.NAMES[:3]:
                self._copy(name, n0, ln)
            for name in self.NAMES[3:]:
                self._copy(name, l0, ll)
        spans.clear()
        self.parent_ptr = traverse.derive_parent_ptr(self.masks, self.child_base)
        self._wait()
        return n

    def tree(self, chunk_depth: int) -> SVO:
        """The arena as one SVO for per-ray roots (the chunks' depth; no
        level layout)."""
        return SVO(masks=self.masks, child_base=self.child_base,
                   leaf_base=self.leaf_base, leaf_albedo=self.leaf_albedo,
                   leaf_normal=self.leaf_normal, leaf_density=self.leaf_density,
                   depth=chunk_depth, level_start=(0,) * (chunk_depth + 1),
                   parent_ptr=self.parent_ptr)


class DeviceBrickArena(_Mirror):
    """The BrickArena's arrays at full capacity on `device` (None: the
    card), updated span by span, grouped by brick offset (the large axis)."""

    COALESCE_SLACK = 8
    NAMES = ("top_masks", "top_child", "top_parent", "bricks")

    def __init__(self, barena: BrickArena, device=None):
        super().__init__(barena, self.NAMES, device)
        self.barena = barena
        barena.dirty.clear()

    def sync(self) -> int:
        spans = self.barena.dirty
        n = len(spans)
        if n == 0:
            return 0
        for g in _coalesce_spans(spans, self.COALESCE_SLACK, off_idx=2,
                                 len_idx=3):
            t0 = min(s[0] for s in g)
            t1 = max(s[0] + s[1] for s in g)
            b0 = min(s[2] for s in g)
            b1 = max(s[2] + s[3] for s in g)
            t0, tl = _pad(t0, max(t1, t0 + 1), self.top_masks.shape[0])
            b0, bl = _pad(b0, max(b1, b0 + 1), self.bricks.shape[0])
            for name in self.NAMES[:3]:
                self._copy(name, t0, tl)
            self._copy("bricks", b0, bl)
        spans.clear()
        self._wait()
        return n

    def tree(self, chunk_depth: int) -> brick.BrickSVO:
        """The brick arena as one BrickSVO for per-ray roots."""
        return brick.BrickSVO(
            top_masks=self.top_masks, top_child=self.top_child,
            top_parent=self.top_parent, bricks=self.bricks, depth=chunk_depth,
            top_depth=chunk_depth - brick.BRICK_LEVELS)


def _chunk_cell_occupancy(svo: SVO, top_depth_c: int) -> np.ndarray:
    """uint32 [max(1, 8^tdc / 32)]: which of the chunk's 8^top_depth_c
    brick-cut cells are occupied, as a morton bit array (bit m & 31 of word
    m >> 5 is the cell of chunk-local morton code m). `build_svo` lays the
    cut level out in morton order, so the k-th set bit is the chunk's k-th
    brick, which master_tile's brickmap relies on."""
    masks = svo.masks.numpy()
    child_base = svo.child_base.numpy()
    rows = np.zeros(1, np.int64)
    coords = np.zeros((1, 3), np.int64)
    for _l in range(top_depth_c):
        rows, pidx, slots = brick._expand_children(masks, child_base, rows)
        coords = coords[pidx] * 2 + np.stack(
            [slots & 1, (slots >> 1) & 1, (slots >> 2) & 1], axis=1)
    m = tile.morton3(coords[:, 0], coords[:, 1], coords[:, 2])
    words = np.zeros(max(1, (8 ** top_depth_c) // 32), np.uint32)
    np.bitwise_or.at(words, m >> 5, np.uint32(1) << (m & 31).astype(np.uint32))
    return words


def _chunk_scene(world_scene: Scene, origin, size) -> Scene:
    """`world_scene` restricted to a chunk's box, in chunk-local [0,1]^3
    coordinates; the density is divided by `size`, so Lipschitz bounds
    carry over."""
    ox, oy, oz = (float(v) for v in origin)
    s = float(size)

    def fn(x, y, z):
        return world_scene.fn(np.asarray(x) * s + ox, np.asarray(y) * s + oy,
                              np.asarray(z) * s + oz) / s

    return Scene(f"{world_scene.name}@{origin}/{size}", fn, world_scene.lipschitz)


@dataclasses.dataclass(frozen=True)
class MasterTile:
    """One LOD's stitched tile-path structure (``Clipmap.master_tile``): the
    occupancy pyramid and cellmap over the clipmap's world cube, and the
    morton-rank -> brick-arena-row indirection."""

    pyr: torch.Tensor        # int32 [n_words], uint32 bit patterns
    cellmap: torch.Tensor    # int32 [W_top, 2]
    brickmap: torch.Tensor   # int32 [a power of two >= resident bricks], -1 padded
    depth: int
    top_depth: int

    def to(self, device=None) -> "MasterTile":
        device = resolve(device)
        return MasterTile(self.pyr.to(device), self.cellmap.to(device),
                          self.brickmap.to(device), self.depth, self.top_depth)


class Clipmap:
    """Camera-centred nested LOD rings of chunks."""

    def __init__(self, scene: Scene, arena: Arena,
                 min_chunk_size: float = 0.25, radius: int = 2,
                 lods: int = 2, chunk_depth: int = 4,
                 world_origin=(0.0, 0.0, 0.0), world_size: float = 1.0,
                 brick_arena: Optional[BrickArena] = None):
        if lods > 1 and radius % 2:
            # the finer ring spans 2 * radius cells of half the coarse size;
            # only an even radius aligns it to the coarse lattice, so that
            # skipping its cells leaves no overlap and no hole
            raise ValueError("radius must be even when lods > 1")
        if brick_arena is not None and chunk_depth < 4:
            raise ValueError("brick arena needs chunk_depth >= 4")
        self.scene = scene
        self.arena = arena
        self.brick_arena = brick_arena
        self.min_chunk_size = min_chunk_size
        self.radius = radius
        self.lods = lods
        self.chunk_depth = chunk_depth
        self.world_origin = np.asarray(world_origin, np.float64)
        self.world_size = world_size
        self.octree = ChunkOctree(origin=world_origin, size=world_size)
        self.resident: dict = {}
        self._snapped = [None] * lods
        self._time = 0

    def update(self, camera_pos) -> dict:
        """One streaming update. Returns {added, evicted, resident}."""
        self._time += 1
        camera_pos = np.asarray(camera_pos, np.float64)
        added = 0
        wanted_any = False
        for lod in range(self.lods):
            cs = self.min_chunk_size * (2 ** lod)
            snap = np.floor(camera_pos / (2 * cs)) * (2 * cs)
            if self._snapped[lod] is not None and np.all(snap == self._snapped[lod]):
                continue  # the snap is unchanged
            self._snapped[lod] = snap
            wanted_any = True
            r = self.radius
            for ix in range(-r, r):
                for iy in range(-r, r):
                    for iz in range(-r, r):
                        pos = snap + np.array([ix, iy, iz]) * cs
                        if np.any(pos < self.world_origin - 1e-9) or np.any(
                                pos + cs > self.world_origin + self.world_size + 1e-9):
                            continue  # outside the world
                        if lod > 0 and self._inside_finer(pos, cs, lod):
                            continue  # a finer ring covers the cell
                        key = (lod, round(pos[0] / cs), round(pos[1] / cs),
                               round(pos[2] / cs))
                        if key in self.resident:
                            self.resident[key].creation_time = self._time
                            continue
                        self._add_chunk(key, pos, cs, lod)
                        added += 1
        evicted = self._evict_stale() if wanted_any else 0
        return {"added": added, "evicted": evicted, "resident": len(self.resident)}

    def _inside_finer(self, pos, cs, lod):
        for f in range(lod):
            fcs = self.min_chunk_size * (2 ** f)
            snap = self._snapped[f]
            if snap is None:
                continue
            lo = snap - self.radius * fcs
            hi = snap + self.radius * fcs
            if np.all(pos >= lo - 1e-9) and np.all(pos + cs <= hi + 1e-9):
                return True
        return False

    def _add_chunk(self, key, pos, cs, lod):
        # attributes at world coordinates: a streamed chunk's are a
        # monolithic build's
        svo = build_svo(_chunk_scene(self.scene, pos, cs), self.chunk_depth,
                        attr_frame=(self.scene, pos, cs)).svo
        node_off, leaf_off = self.arena.upload(svo)
        top_off = n_top = brick_off = n_bricks = 0
        cell_occ = None
        if self.brick_arena is not None:
            top_off, brick_off, n_top, n_bricks = self.brick_arena.upload(svo, leaf_off)
            cell_occ = _chunk_cell_occupancy(svo, self.chunk_depth - brick.BRICK_LEVELS)
        chunk = Chunk(
            position=pos.copy(), size=cs, lod=lod, creation_time=self._time,
            node_offset=node_off, n_nodes=svo.n_nodes, leaf_offset=leaf_off,
            n_leaves=svo.n_leaves, depth=svo.depth, level_start=svo.level_start,
            top_offset=top_off, n_top=n_top, brick_offset=brick_off,
            n_bricks=n_bricks, cell_occ=cell_occ)
        self.resident[key] = chunk
        self.octree.add_chunk(pos, cs, chunk)

    def _evict_stale(self):
        evicted = 0
        for key in list(self.resident):
            chunk = self.resident[key]
            if chunk.creation_time != self._time:
                self.octree.remove_chunk(chunk.position, chunk.size)
                self.arena.free(chunk)
                if self.brick_arena is not None:
                    self.brick_arena.free(chunk.top_offset, chunk.n_top,
                                          chunk.brick_offset, chunk.n_bricks)
                del self.resident[key]
                evicted += 1
        return evicted

    def _tables(self, root_of):
        trunk, table = self.octree.extract_trunk()
        roots = torch.tensor([root_of(c) for _, _, c in table], dtype=_I32)
        origins = torch.from_numpy(
            np.array([p for p, _, _ in table], np.float32).reshape(-1, 3))
        sizes = torch.from_numpy(np.array([s for _, s, _ in table], np.float32))
        return trunk, roots, origins, sizes

    def master(self):
        """The trunk SVO and the chunk tables for the stitched trace: (trunk,
        roots (C,) int32 node-arena rows, origins (C, 3), sizes (C,)), CPU
        tensors."""
        return self._tables(lambda c: c.node_offset)

    def master_brick(self):
        """``master`` with brick-arena roots (top rows), for
        ``trace_clipmap_device_brick``."""
        if self.brick_arena is None:
            raise ValueError("master_brick needs a brick arena")
        return self._tables(lambda c: c.top_offset)

    def master_tile(self):
        """The resident set stitched into per-LOD tile-path structures: one
        world-spanning occupancy pyramid and cellmap a LOD (its chunks'
        brick cells at their world morton positions) and a morton-rank ->
        brick-arena-row brickmap, so that the streamed world renders
        through the tile trace. A list of MasterTile (CPU tensors), one a
        LOD (a LOD with no cells gets an empty pyramid). world_size /
        chunk size must be a power of two."""
        if self.brick_arena is None:
            raise ValueError("master_tile needs a brick arena")
        tdc = self.chunk_depth - brick.BRICK_LEVELS
        masters = []
        for lod in range(self.lods):
            cs = self.min_chunk_size * (2 ** lod)
            g = np.log2(self.world_size / cs)
            if abs(g - round(g)) > 1e-9:
                raise ValueError(f"tile path needs world_size/chunk_size a power "
                                 f"of 2; got {self.world_size}/{cs}")
            g = int(round(g))
            td_eff = g + tdc
            if td_eff > 10:
                raise ValueError("tile path supports top_depth <= 10")
            chunks = [c for c in self.resident.values() if c.lod == lod]

            def cell_m(c, cs=cs):
                cc = np.round((np.asarray(c.position, np.float64)
                               - self.world_origin) / cs).astype(np.int64)
                return int(tile.morton3(cc[0], cc[1], cc[2]))

            chunks.sort(key=cell_m)
            bits = np.zeros(8 ** td_eff, bool)
            bmap_parts = []
            for c in chunks:
                occ = np.asarray(c.cell_occ, np.uint32)
                local = np.flatnonzero((occ[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
                if local.shape[0] == 0:
                    continue  # an empty chunk (one dummy brick row, no cells)
                assert local.shape[0] == c.n_bricks, (local.shape, c.n_bricks)
                bits[(cell_m(c) << (3 * tdc)) + local] = True
                bmap_parts.append(c.brick_offset + np.arange(c.n_bricks, dtype=np.int32))
            bmap = (np.concatenate(bmap_parts).astype(np.int32)
                    if bmap_parts else np.zeros(0, np.int32))
            # a power-of-two length, as the reference pads it
            cap = 1
            while cap < max(bmap.shape[0], 1):
                cap <<= 1
            brickmap = np.full(cap, -1, np.int32)
            brickmap[:bmap.shape[0]] = bmap

            # the pyramid: OR-downsample the finest level, pack to words
            offs, n_words = tile._pyr_layout(td_eff)
            pyr = np.zeros(n_words, np.uint32)
            packed = {td_eff: bits}
            level = bits
            for l in range(td_eff - 1, 0, -1):
                level = level.reshape(-1, 8).any(axis=1)
                packed[l] = level
            for l in range(1, td_eff + 1):
                by = np.packbits(packed[l], bitorder="little")
                pad = (-by.shape[0]) % 4
                if pad:
                    by = np.concatenate([by, np.zeros(pad, np.uint8)])
                w = by.view(np.uint32)
                pyr[offs[l]:offs[l] + w.shape[0]] = w

            w_top = pyr[offs[td_eff]:]
            pc = tile._popcount_np(w_top)
            prefix = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
            assert int(pc.sum()) == bmap.shape[0], (pc.sum(), bmap.shape)
            cellmap = np.stack([prefix, w_top.astype(np.int32)], axis=1)
            masters.append(MasterTile(
                pyr=torch.from_numpy(pyr.view(np.int32).copy()),
                cellmap=torch.from_numpy(np.ascontiguousarray(cellmap)),
                brickmap=torch.from_numpy(brickmap),
                depth=g + self.chunk_depth, top_depth=td_eff))
        return masters


# ---------------------------------------------------------------------------
# K8: the stitched pyramids through the tile trace
# ---------------------------------------------------------------------------

def _world_rays(o, d, world_origin, world_size, device):
    """Rays moved into the clipmap's world cube, and the cube's size."""
    worg = torch.tensor(world_origin, dtype=_F32, device=device)
    ws = torch.tensor(world_size, dtype=_F32, device=device)
    return (o.to(_F32) - worg) / ws, d.to(_F32).contiguous(), ws


def _trace_tiles(masters, bricks, o, d, corners, k_max, fb_tiles, fb_k,
                 fb2_tiles):
    """Each LOD's tile trace (``tile._trace_tile_fb`` through its brickmap),
    composed by least t: the rings are disjoint, so along a ray at most one
    LOD hits at each t, and all LODs trace in one cube, so their t compare.
    Returns (hit_leaf, hit_t in cube units, unresolved)."""
    device = bricks.device
    o = o.contiguous()
    corners = corners.to(_F32).contiguous()
    best_leaf = best_t = unres = None
    for m in masters:
        m = m.to(device)
        caps = tile._default_caps(m.top_depth, k_max)
        res, un = tile._trace_tile_fb(
            m.pyr, m.cellmap, bricks, o, d, corners, o[0, 0], m.depth,
            m.top_depth, caps, k_max, fb_tiles, fb_k, fb2_tiles, 2,
            brickmap=m.brickmap)
        t_eff = torch.where(res.hit_leaf >= 0, res.hit_t, float("inf"))
        if best_leaf is None:
            best_leaf, best_t, unres = res.hit_leaf, t_eff, un
        else:
            better = t_eff < best_t
            best_leaf = torch.where(better, res.hit_leaf, best_leaf)
            best_t = torch.minimum(t_eff, best_t)
            unres = unres | un
    hit = best_leaf >= 0
    return best_leaf, torch.where(hit, best_t, 0.0), unres


def trace_clipmap_tile(masters, dev_brick: DeviceBrickArena, o, d, corners,
                       world_origin=(0.0, 0.0, 0.0), world_size: float = 1.0,
                       k_max=64, fb_tiles=64, fb_k=192, fb2_tiles=16):
    """The streamed world through the tile trace: each LOD's stitched
    pyramid (``Clipmap.master_tile``), every brick fetched from the brick
    arena through the brickmap. o/d/corners: tile-major camera rays
    (``tile.tile_rays``) in world coordinates, on the arena's device.
    Returns (hit_leaf into the companion Arena's leaf rows, hit_t in world
    units, unresolved mask)."""
    o, d, ws = _world_rays(o, d, world_origin, world_size, dev_brick.bricks.device)
    leaf, t_cube, un = _trace_tiles(masters, dev_brick.bricks, o, d, corners,
                                    k_max, fb_tiles, fb_k, fb2_tiles)
    return leaf, t_cube * ws, un


def render_clipmap_tile(masters, dev_brick: DeviceBrickArena,
                        dev_arena: DeviceArena, o, d, corners, light_dir,
                        acc=None, sample=0, world_origin=(0.0, 0.0, 0.0),
                        world_size: float = 1.0, k_max=64, fb_tiles=64,
                        fb_k=192, fb2_tiles=16):
    """One streamed-world frame: the stitched tile trace, shading from the
    arena's leaf attributes (``diff.shade_diff``), and the progressive
    accumulation, all on the device. `acc`: the previous accumulator ((T*P,
    3)) or None; `sample`: frames accumulated so far at this pose (0
    replaces: a camera move resets). Returns (acc', residual count), both
    device tensors; nothing is read back to the host."""
    from raytracingtest_tpu_torch import diff

    o, d, _ws = _world_rays(o, d, world_origin, world_size, dev_brick.bricks.device)
    leaf, _t, un = _trace_tiles(masters, dev_brick.bricks, o, d, corners,
                                k_max, fb_tiles, fb_k, fb2_tiles)
    light = torch.as_tensor(light_dir, dtype=_F32, device=leaf.device)
    img = diff.shade_diff(leaf, d.reshape(-1, 3), dev_arena.leaf_albedo,
                          dev_arena.leaf_normal, dev_arena.leaf_density, light,
                          1.3, 0.08)
    # the running average with weight 1 / (sample + 1); sample 0 replaces
    if acc is None or sample == 0:
        acc = img
    else:
        acc = acc + (img - acc) / float(sample + 1)
    return acc, un.sum()


# ---------------------------------------------------------------------------
# K10: the two-phase stitched traversal
# ---------------------------------------------------------------------------

def _aabb_exit(o, d, box_org, box_size):
    """t of leaving the boxes [org, org + size] from origins possibly
    inside them, at least 0."""
    safe_d = torch.where(d.abs() < 1e-12, 1e-12, d)
    t0 = (box_org - o) / safe_d
    t1 = (box_org + box_size[:, None] - o) / safe_d
    return torch.clamp_min(torch.amin(torch.maximum(t0, t1), dim=1), 0.0)


def trace_clipmap(trunk: SVO, trunk_origin, trunk_size, chunk_roots,
                  chunk_origins, chunk_sizes, chunk_depth, arena: Arena,
                  origin, direction, max_chunks: int = 4):
    """The host twin of the stitched traversal (the reference's numpy
    ``trace_clipmap``): at most `max_chunks` rounds over all rays, the
    per-ray ``traverse.trace`` with roots in both phases, on CPU tensors
    and the host Arena. Returns (hit_leaf into the arena's leaf rows, -1 on
    a miss; t in world units; the hit chunk's id)."""
    o = torch.as_tensor(np.asarray(origin, np.float32))
    d = torch.as_tensor(np.asarray(direction, np.float32))
    n = o.shape[0]
    t_off = torch.zeros(n, dtype=_F32)
    done = torch.zeros(n, dtype=torch.bool)
    hit_leaf = torch.full((n,), -1, dtype=_I32)
    hit_t = torch.zeros(n, dtype=_F32)
    hit_chunk = torch.full((n,), -1, dtype=_I32)
    t_org = torch.tensor(trunk_origin, dtype=_F32)
    t_size = torch.tensor(trunk_size, dtype=_F32)
    roots_t, origins_t, sizes_t = (torch.as_tensor(np.asarray(a)) for a in (
        chunk_roots, chunk_origins, chunk_sizes))
    t = torch.from_numpy
    arena_svo = SVO(masks=t(arena.masks), child_base=t(arena.child_base),
                    leaf_base=t(arena.leaf_base), leaf_albedo=t(arena.leaf_albedo),
                    leaf_normal=t(arena.leaf_normal),
                    leaf_density=t(arena.leaf_density), depth=chunk_depth,
                    level_start=(0,) * (chunk_depth + 1))
    for _ in range(max_chunks):
        if bool(done.all()):
            break
        # phase 1: the trunk from the advanced origin
        o_cur = o + t_off[:, None] * d
        r1 = traverse.trace(trunk, (o_cur - t_org) / t_size, d)
        found = (r1.hit_leaf >= 0) & ~done
        done = done | (~found & ~done)   # a trunk miss is the ray's end
        if not bool(found.any()):
            break
        cid = torch.where(found, r1.hit_leaf, 0).long()
        c_org, c_size = origins_t[cid], sizes_t[cid]
        # phase 2: the chunk's tree in the arena from its root
        r2 = traverse.trace(arena_svo, (o_cur - c_org) / c_size[:, None], d,
                            root=roots_t[cid])
        hit2 = (r2.hit_leaf >= 0) & found
        new = hit2 & ~(hit_leaf >= 0)
        hit_leaf = torch.where(new, r2.hit_leaf, hit_leaf)
        hit_t = torch.where(new, t_off + r2.hit_t * c_size, hit_t)
        hit_chunk = torch.where(new, cid.to(_I32), hit_chunk)
        done = done | hit2
        # a chunk miss: past the chunk's box, back to phase 1
        adv = found & ~hit2
        t_off = torch.where(adv, t_off + _aabb_exit(o_cur, d, c_org, c_size) + 1e-5,
                            t_off)
    return hit_leaf, hit_t, hit_chunk


def rounds_bound(trunk_depth: int, max_chunks: int = 0) -> int:
    """The stitched trace's rounds: a ray crosses at most 3 * 2^trunk_depth
    occupied trunk cells; `max_chunks` (> 0) caps it lower."""
    return min(max_chunks or (1 << 30), 3 * (1 << trunk_depth) + 4)


def trace_clipmap_rounds(trunk, trunk_origin, trunk_size, roots, origins,
                         sizes, chunk_tree, origin, direction, n_max,
                         counts=None):
    """The plain version of the ``clipmap_trace`` kernels, in tensor ops on
    any device: at most `n_max` rounds, each the trunk's stackless walk
    (``traverse.trace_stackless``) from o + t_off * d, then the hit chunk's
    walk from its root row in `chunk_tree` (an arena SVO: the stackless
    walk; a BrickSVO: ``brick.trace_brick``), then, on a chunk miss, t_off
    moved past the chunk's box. Only the rays still walking take a round;
    every step is per ray. Returns (hit_leaf, hit_t, hit_chunk, truncated).

    `counts` (a dict, optional) gains the work this run's rays took:
    "rounds" (a ray's rounds), "walks" (walks begun: two a round a ray that
    found a chunk, one otherwise), "steps" (stackless and top-tree steps)
    and "dda" (brick DDA steps)."""
    dev = origin.device
    o, d = origin.to(_F32), direction.to(_F32)
    n = o.shape[0]
    t_off = torch.zeros(n, dtype=_F32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_leaf = torch.full((n,), -1, dtype=_I32, device=dev)
    hit_t = torch.zeros(n, dtype=_F32, device=dev)
    hit_chunk = torch.full((n,), -1, dtype=_I32, device=dev)
    t_org = torch.tensor(trunk_origin, dtype=_F32, device=dev)
    t_size = torch.tensor(trunk_size, dtype=_F32, device=dev)
    tally = counts if counts is not None else {}
    for key in ("rounds", "walks", "steps", "dda"):
        tally.setdefault(key, 0)
    brick_walk = isinstance(chunk_tree, brick.BrickSVO)

    def walk(ol, dd, r):
        if not brick_walk:
            res = traverse.trace_stackless(chunk_tree, ol, dd, root=r)
            tally["steps"] += int(res.iters.sum())
            return res
        res, stats = brick.trace_brick(chunk_tree, ol, dd, True, root=r)
        dda = int(stats[:, traverse.STAT_NAMES.index("dda_steps")].sum())
        tally["steps"] += int(res.iters.sum()) - dda
        tally["dda"] += dda
        return res

    for _ in range(n_max):
        act = torch.nonzero(~done)[:, 0]
        if act.numel() == 0:
            break
        oa, da, ta = o[act], d[act], t_off[act]
        o_cur = oa + ta[:, None] * da
        r1 = traverse.trace_stackless(trunk, (o_cur - t_org) / t_size, da)
        tally["steps"] += int(r1.iters.sum())
        found = r1.hit_leaf >= 0
        done[act[~found]] = True
        f_idx = torch.nonzero(found)[:, 0]
        tally["rounds"] += act.numel()
        tally["walks"] += act.numel() + f_idx.numel()
        sel = act[f_idx]
        cid = r1.hit_leaf[f_idx].long()
        c_org, c_size = origins[cid], sizes[cid]
        oc, dc, tc = o_cur[f_idx], da[f_idx], ta[f_idx]
        r2 = walk((oc - c_org) / c_size[:, None], dc, roots[cid])
        hit2 = r2.hit_leaf >= 0
        hs = sel[hit2]
        hit_leaf[hs] = r2.hit_leaf[hit2]
        hit_t[hs] = tc[hit2] + r2.hit_t[hit2] * c_size[hit2]
        hit_chunk[hs] = cid[hit2].to(_I32)
        done[hs] = True
        miss = ~hit2
        t_off[sel[miss]] = tc[miss] + _aabb_exit(
            oc[miss], dc[miss], c_org[miss], c_size[miss]) + 1e-5
    return hit_leaf, hit_t, hit_chunk, ~done


def _stitched(kernel_tree, trunk, trunk_origin, trunk_size, chunk_roots,
              chunk_origins, chunk_sizes, chunk_depth, origin, direction,
              max_chunks):
    dev = origin.device
    trunk = trunk.to(dev)
    roots = torch.as_tensor(chunk_roots, dtype=_I32).to(dev).contiguous()
    origins = torch.as_tensor(chunk_origins, dtype=_F32).reshape(-1, 3).to(dev).contiguous()
    sizes = torch.as_tensor(chunk_sizes, dtype=_F32).to(dev).contiguous()
    n_max = rounds_bound(trunk.depth, max_chunks)
    o = origin.to(_F32).contiguous()
    d = direction.to(_F32).contiguous()
    if dev.type == "cpu":
        return trace_clipmap_rounds(trunk, trunk_origin, trunk_size, roots,
                                    origins, sizes, kernel_tree, o, d, n_max)
    from raytracingtest_tpu_torch.ops import brick_cuda

    return tuple(brick_cuda.clipmap_kernel(
        trunk, tuple(float(v) for v in trunk_origin), float(trunk_size), roots,
        origins, sizes, kernel_tree, o, d, chunk_depth, n_max))


def trace_clipmap_device(trunk: SVO, trunk_origin, trunk_size, chunk_roots,
                         chunk_origins, chunk_sizes, chunk_depth,
                         dev_arena: DeviceArena, origin, direction,
                         max_chunks: int = 0):
    """The stitched traversal over the device node arena (``master``'s
    tables): kernel ``clipmap_trace`` for CUDA rays, ``trace_clipmap_rounds``
    for CPU rays. origin/direction: (N, 3) world-space rays on the arena's
    device. Returns (hit_leaf, hit_t, hit_chunk, truncated); truncated is
    all False unless `max_chunks` (> 0) caps the rounds below their bound."""
    return _stitched(dev_arena.tree(chunk_depth), trunk, trunk_origin,
                     trunk_size, chunk_roots, chunk_origins, chunk_sizes,
                     chunk_depth, origin, direction, max_chunks)


def trace_clipmap_device_brick(trunk: SVO, trunk_origin, trunk_size,
                               chunk_roots, chunk_origins, chunk_sizes,
                               chunk_depth, dev_brick: DeviceBrickArena,
                               origin, direction, max_chunks: int = 0):
    """``trace_clipmap_device`` with the chunk's walk through the brick
    arena (``master_brick``'s tables): kernel ``clipmap_trace_brick`` for
    CUDA rays. hit_leaf indexes the companion Arena's leaf rows."""
    return _stitched(dev_brick.tree(chunk_depth), trunk, trunk_origin,
                     trunk_size, chunk_roots, chunk_origins, chunk_sizes,
                     chunk_depth, origin, direction, max_chunks)
