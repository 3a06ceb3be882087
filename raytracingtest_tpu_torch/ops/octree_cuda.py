"""The SVO builder's kernels on the card: the wrappers of ``csrc/svo_build.cu``.

Counterpart of the XLA programs of ``raytracingtest_tpu/ops/octree_device.py``
(K7), which ``ops/octree_device.py`` drives level by level:

  * ``columns``     (``svo_columns``): a heightfield's h(x, z) once a child
                    column of the level (``HEIGHTFIELDS``), in a dense table
                    over the square of columns the build reaches there
                    (``column_square``); None for a 3-D scene.
  * ``expand``      (``svo_expand``): a level's children, the scene at their
                    centres (y - h from the column table for a heightfield,
                    the scene itself for a 3-D scene) and the keep test;
                    records (x, y, z, f bits).
  * ``expand_serial`` (``svo_expand_serial``): the expansion's first form,
                    the scene evaluated at every child; off the build's
                    path.
  * ``count`` and ``compact`` (``svo_compact``, count and place modes): the
                    blocks' counts of flagged rows, and a stable compaction
                    of the flagged rows' indices and record words.
  * ``leaves``      (``svo_leaves``): the finest level's leaf test, reading
                    the last expansion's values where a probe is the centre
                    of a child of a kept parent (``leaf_probe_sources``
                    models where each probe's value comes from).
  * ``leaf_attrs``  (``svo_leaf_attrs``): each leaf's albedo and normal, a
                    dense pass over the compacted leaves.
  * ``leaves_serial`` (``svo_leaves_serial``): the leaf test's first form,
                    every probe evaluated and the attributes in the same
                    pass; off the build's path.
  * ``level_up``    (``svo_level_pass``): phases C and D at one level in one
                    pass over the surviving children, which are sorted by
                    parent (each child's parent * 8 + slot one word): each surviving parent's valid mask, first
                    child's rank and candidate index at its rank, each
                    child's parent rank, and the count, left on the device.
  * ``level_up_serial`` (``svo_level_up``): the level-up's first form, each
                    parent candidate's valid mask and first child and its
                    survive flag (``count`` and ``compact`` then rank them);
                    on no build's path.
  * ``parent_ptr``  (``svo_parent_ptr``): each node's parent row, from the
                    packed masks and child bases; the first form of phase D,
                    on no build's path (``derive_parent_ptr_device``).
  * ``scene_eval``  the scene library at given points, the check of
                    ``csrc/scene.cuh``; no build calls it.

CUDA tensors launch the kernels; CPU tensors take the plain versions beside
them: torch ops around the port's own numpy scene (which batches its scene
calls as ``octree.build_svo`` does, so it gives that builder's bits),
``torch.nonzero`` for the compaction, ``index_add_``/``scatter_reduce_`` for
the masks and first children, a run-head scan for the level pass,
``octree.compute_parent_ptr``. Every function
returns the same tensors on both paths, the blocks' counts included (blocks
of ``BLOCK`` rows). The card evaluates a scene by its id in ``scene.cuh``
(``SCENE_IDS``, by ``Scene.name``); a scene the library lacks raises there,
and nothing falls back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytracingtest_tpu_torch._build import svo_lib
from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops.morton import morton_encode64
from raytracingtest_tpu_torch.ops.octree import (
    CHILD_OFFSETS, compute_parent_ptr, default_albedo, sampler_normal)
from raytracingtest_tpu_torch.utils import opensimplex

_F32, _I32, _U8 = torch.float32, torch.int32, torch.uint8

# csrc/svo_build.cu's BLOCK: rows a block, and so a blocks' count, covers
BLOCK = 256
# "no child": the first-child value of a parent none of whose children survive
BIG = 2 ** 31 - 1
# csrc/scene.cuh's scene ids, by Scene.name
SCENE_IDS = {"flat_ground": 0, "sphere": 1, "simplex": 2, "rotated_cuboid": 3,
             "terrain": 4, "dense_cube": 5, "perlin": 6, "terrain_ref": 7,
             "simplex_ref": 8}
# the heightfields among them, f = y - h(x, z) (scene.cuh's height): their
# expansion evaluates h once a column; the others are 3-D scenes
HEIGHTFIELDS = ("flat_ground", "simplex", "terrain", "perlin")

# kernel launches made by this process, by kernel (a launch of either mode
# of svo_compact counts once)
launches = {"svo_columns": 0, "svo_expand": 0, "svo_expand_serial": 0,
            "svo_compact": 0, "svo_leaves": 0, "svo_leaf_attrs": 0,
            "svo_leaves_serial": 0, "svo_level_pass": 0, "svo_level_up": 0,
            "svo_parent_ptr": 0, "scene_eval": 0}

_SVO_COLUMNS = Kernel("svo_columns", svo_lib)
_SVO_EXPAND = Kernel("svo_expand", svo_lib)
_SVO_EXPAND_SERIAL = Kernel("svo_expand_serial", svo_lib)
_SVO_COMPACT = Kernel("svo_compact", svo_lib)
_SVO_LEAVES = Kernel("svo_leaves", svo_lib)
_SVO_LEAF_ATTRS = Kernel("svo_leaf_attrs", svo_lib)
_SVO_LEAVES_SERIAL = Kernel("svo_leaves_serial", svo_lib)
_SVO_LEVEL_PASS = Kernel("svo_level_pass", svo_lib)
_SVO_LEVEL_UP = Kernel("svo_level_up", svo_lib)
_SVO_PARENT_PTR = Kernel("svo_parent_ptr", svo_lib)
_SCENE_EVAL = Kernel("scene_eval", svo_lib)

_tables: dict = {}  # device -> OpenSimplex's tables there


def scene_id(scene) -> int:
    """The id of `scene` in the card's scene library; ``ValueError`` for a
    scene it lacks."""
    try:
        return SCENE_IDS[scene.name]
    except KeyError:
        raise ValueError(
            f"the card's scene library (csrc/scene.cuh) has no scene "
            f"{scene.name!r}; build it on the host (octree.build_svo) or pass "
            f"device=\"cpu\"") from None


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """A scene as the builder's functions take it: the host scene (the plain
    versions call it) and, for a CUDA device, its id and the `_ref` scenes'
    tables there."""

    scene: object
    scene_id: int = -1
    tables: tuple = ()

    def pointers(self):
        return [t.data_ptr() for t in self.tables]


def device_scene(scene, device) -> DeviceScene:
    """`scene` for the builder on `device`. On a CUDA device the scene must
    be in the card's library (``scene_id`` raises first, before anything
    touches the device); the OpenSimplex tables of ``OpenSimplex3D(7)`` go
    to the device once."""
    device = torch.device(device)
    if device.type == "cpu":
        return DeviceScene(scene)
    sid = scene_id(scene)
    if device not in _tables:
        noise = opensimplex.OpenSimplex3D(7)
        host = (noise.perm, noise.perm3d, opensimplex._LUT_D_COLS,
                opensimplex._LUT_SB_COLS, opensimplex.GRADIENTS_3D.reshape(-1))
        _tables[device] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)
    return DeviceScene(scene, sid, _tables[device])


def n_blocks(n: int) -> int:
    return -(-n // BLOCK)


def _check_count(n: int, what: str) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} rows, the kernels index with int32")


def count_plain(flags):
    """Plain version of ``count``: the blocks' counts of nonzero `flags`
    (blocks of BLOCK rows)."""
    n = flags.shape[0]
    padded = torch.zeros(n_blocks(n) * BLOCK, dtype=_I32, device=flags.device)
    padded[:n] = flags != 0
    return padded.view(-1, BLOCK).sum(1, dtype=_I32)


def _centres(coords, scale):
    """float32 centres (c + 0.5) * scale of (n, 3) integer coordinates, one
    numpy column each, as the host builder makes them."""
    cc = coords.numpy()
    return [(cc[:, a].astype(np.float32) + np.float32(0.5)) * scale
            for a in range(3)]


# ---- svo_columns ----------------------------------------------------------------

class Columns(NamedTuple):
    """A heightfield's h at the child columns of a level: `h` (side * side,)
    float32, column (x0 + jx, z0 + jz) at jz * side + jx."""

    h: torch.Tensor
    x0: int
    z0: int
    side: int


def column_square(level: int, root_level: int = 0, root_coord=(0, 0, 0)):
    """(x0, z0, side): the square of columns at `level` that a build rooted
    at the cell `root_coord` of `root_level` reaches (the whole world's
    2^level at root level 0)."""
    k = level - root_level
    if k < 1:
        raise ValueError(f"level {level} is not below the root's {root_level}")
    return int(root_coord[0]) << k, int(root_coord[2]) << k, 1 << k


def columns_plain(scene, level, square, device):
    """Plain version of ``columns`` at `square` (``column_square``'s): the
    host scene at y = 0, where a heightfield's f is 0 - h, negated (both
    exact)."""
    x0, z0, side = square
    j = torch.arange(side * side)
    cols = torch.stack([x0 + j % side, torch.zeros_like(j), z0 + j // side], 1)
    px, py, pz = _centres(cols, np.float32(2.0 ** (-level)))
    f0 = np.asarray(scene(px, np.zeros_like(py), pz), np.float32)
    return Columns(torch.from_numpy(-f0).to(device), x0, z0, side)


def columns(ds: DeviceScene, level: int, root_level: int = 0,
            root_coord=(0, 0, 0), device=None):
    """The heightfield's h at every child column of `level` that a build
    rooted at `root_coord` of `root_level` reaches (``column_square``), on
    `device` (None: the card), or None for a 3-D scene. (A heightfield's
    surface crosses every column, so the level's parents cover all or most
    of the square; evaluating only their columns measured slower, PERF.md.)"""
    if ds.scene.name not in HEIGHTFIELDS:
        return None
    square = column_square(level, root_level, root_coord)
    device = resolve(device)
    if device.type == "cpu":
        return columns_plain(ds.scene, level, square, device)
    side = square[2]
    _check_count(side * side, "svo_columns")
    _SVO_COLUMNS.check(device, ())
    h = torch.empty(side * side, dtype=_F32, device=device)
    _SVO_COLUMNS(device, *square, float(np.float32(2.0 ** (-level))), ds.scene_id,
                 h.data_ptr())
    launches["svo_columns"] += 1
    return Columns(h, *square)


# ---- svo_expand ---------------------------------------------------------------

def expand_plain(scene, parents, level, thr_hi, thr_lo):
    """Plain version of ``expand`` and of ``expand_serial`` (any device; the
    scene runs on the host at every child)."""
    dev = parents.device
    child = (parents[:, None, :3].cpu() * 2
             + torch.from_numpy(CHILD_OFFSETS)[None]).reshape(-1, 3)
    px, py, pz = _centres(child, np.float32(2.0 ** (-level)))
    f = torch.from_numpy(np.asarray(scene(px, py, pz), np.float32))
    keep = ((f <= thr_hi) & (f >= thr_lo)).to(_U8)
    rec = torch.cat([child, f.view(_I32)[:, None]], 1)
    return rec.to(dev), keep.to(dev), count_plain(keep).to(dev)


def _expand_outputs(parents, kernel):
    dev = parents.device
    n_p = parents.shape[0]
    n = 8 * n_p
    _check_count(n, kernel.name)
    kernel.check(dev, (("parents", parents, _I32, (n_p, 4)),))
    return (n, torch.empty((n, 4), dtype=_I32, device=dev),
            torch.empty(n, dtype=_U8, device=dev),
            torch.empty(n_blocks(n), dtype=_I32, device=dev))


def expand(ds: DeviceScene, parents, level: int, thr_hi: float,
           thr_lo: float, cols: Columns | None = None):
    """Children of the (n_p, 4) int32 candidate records `parents` (x, y, z
    at level - 1, f bits) at `level`: (records (8 n_p, 4) int32 in Morton
    child order, parent-major, with the scene at each child's centre; keep
    flags (8 n_p,) uint8, thr_lo <= f <= thr_hi in float32; the blocks' kept
    counts). `cols`, the level's ``columns`` (None for a 3-D scene), gives
    a heightfield's f as py - h."""
    if parents.device.type == "cpu":
        return expand_plain(ds.scene, parents, level, thr_hi, thr_lo)
    dev = parents.device
    n, rec, keep, counts = _expand_outputs(parents, _SVO_EXPAND)
    if n and (cols is None) != (ds.scene.name not in HEIGHTFIELDS):
        raise ValueError(f"expand: scene {ds.scene.name!r} with column table "
                         f"{'none' if cols is None else 'given'}")
    if cols is not None:
        _SVO_EXPAND.check(dev, (("columns", cols.h, _F32, (cols.side ** 2,)),))
    if n:
        _SVO_EXPAND(dev, parents.data_ptr(), n, float(np.float32(2.0 ** (-level))),
                    thr_hi, thr_lo, ds.scene_id, *ds.pointers(),
                    *((None, 0, 0, 0) if cols is None else
                      (cols.h.data_ptr(), cols.x0, cols.z0, cols.side)),
                    rec.data_ptr(), keep.data_ptr(), counts.data_ptr())
        launches["svo_expand"] += 1
    return rec, keep, counts


def expand_serial(ds: DeviceScene, parents, level: int, thr_hi: float,
                  thr_lo: float):
    """The expansion's first form (``svo_expand_serial``), on no build's
    path: ``expand``'s results with the scene evaluated at every child."""
    if parents.device.type == "cpu":
        return expand_plain(ds.scene, parents, level, thr_hi, thr_lo)
    dev = parents.device
    n, rec, keep, counts = _expand_outputs(parents, _SVO_EXPAND_SERIAL)
    if n:
        _SVO_EXPAND_SERIAL(dev, parents.data_ptr(), n,
                           float(np.float32(2.0 ** (-level))), thr_hi, thr_lo,
                           ds.scene_id, *ds.pointers(), rec.data_ptr(),
                           keep.data_ptr(), counts.data_ptr())
        launches["svo_expand_serial"] += 1
    return rec, keep, counts


# ---- svo_compact ----------------------------------------------------------------

def count(flags):
    """The blocks' counts of nonzero (n,) uint8 `flags`."""
    if flags.device.type == "cpu":
        return count_plain(flags)
    dev = flags.device
    n = flags.shape[0]
    _check_count(n, "svo_compact")
    _SVO_COMPACT.check(dev, (("flags", flags, _U8, (n,)),))
    counts = torch.empty(n_blocks(n), dtype=_I32, device=dev)
    if n:
        _SVO_COMPACT(dev, flags.data_ptr(), n, None, None, 0, None, None,
                     counts.data_ptr())
        launches["svo_compact"] += 1
    return counts


def compact_plain(flags, block_base, total, src=None):
    """Plain version of ``compact`` (`block_base` is not needed)."""
    rows = torch.nonzero(flags).reshape(-1).to(_I32)
    if rows.shape[0] != total:
        raise ValueError(f"compact: {rows.shape[0]} flagged rows, told {total}")
    return rows, (None if src is None else src[rows.long()])


def compact(flags, block_base, total: int, src=None):
    """The rows of nonzero (n,) uint8 `flags` in order: (their indices
    (total,) int32, and their rows of the (n, w) int32 `src`, (total, w), or
    None). `block_base` is the exclusive scan of the blocks' counts and
    `total` their sum."""
    if flags.device.type == "cpu":
        return compact_plain(flags, block_base, total, src)
    dev = flags.device
    n = flags.shape[0]
    _check_count(n, "svo_compact")
    width = 0 if src is None else src.shape[1]
    specs = [("flags", flags, _U8, (n,)),
             ("block_base", block_base, _I32, (n_blocks(n),))]
    if src is not None:
        specs.append(("src", src, _I32, (n, width)))
    _SVO_COMPACT.check(dev, specs)
    if not 0 <= total <= n:
        raise ValueError(f"compact: total {total} outside 0..{n}")
    rows = torch.empty(total, dtype=_I32, device=dev)
    words = None if src is None else torch.empty((total, width), dtype=_I32,
                                                 device=dev)
    if n:
        _SVO_COMPACT(dev, flags.data_ptr(), n, block_base.data_ptr(),
                     None if src is None else src.data_ptr(), width,
                     rows.data_ptr(), None if words is None else words.data_ptr(),
                     None)
        launches["svo_compact"] += 1
    return rows, words


# ---- svo_leaves, svo_leaf_attrs, svo_leaves_serial ------------------------------

# the leaf test's six probes, in the host's order: (axis, sign)
PROBES = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))
# where a probe's value comes from in the new form: the sibling's record, the
# record of a child of another kept parent, or an evaluation of the scene
SIBLING, COUSIN, EVALUATE = 0, 1, 2


def leaf_probe_sources(rec, par, parents, depth):
    """A plain model of where ``leaves`` takes each probe's value: (src (n,
    6) int64, the row of the last level's uncompacted child records whose
    centre the probe is, -1 where the scene must be evaluated; kind (n, 6)
    int8, SIBLING, COUSIN or EVALUATE), the probes in ``PROBES`` order. `rec`
    holds the finest candidates, `par` their parents' rows among the kept
    parents `parents` (records at depth - 1, Morton order). A probe along
    axis a is the face neighbour c +- e_a: inside the candidate's own parent
    on the side of c's low bit (slot s ^ 2^a), else a child of the parent
    next to it, if that parent was kept (found by ``torch.searchsorted`` on
    the parents' Morton codes), else outside the world or an octant build's
    octant, or under a pruned parent."""
    dev = rec.device
    n = rec.shape[0]
    c = rec[:, :3].to(torch.int64)
    slot = (c[:, 0] & 1) | ((c[:, 1] & 1) << 1) | ((c[:, 2] & 1) << 2)
    own = par.to(torch.int64)
    codes = morton_encode64(*parents[:, :3].to(torch.int64).unbind(1))
    n_par = codes.shape[0]
    src = torch.full((n, 6), -1, dtype=torch.int64, device=dev)
    kind = torch.full((n, 6), EVALUATE, dtype=torch.int8, device=dev)
    for k, (a, sgn) in enumerate(PROBES):
        nb = c.clone()
        nb[:, a] += sgn
        nslot = slot ^ (1 << a)
        inside = ((c[:, a] & 1) == (1 if sgn < 0 else 0))
        in_world = (nb[:, a] >= 0) & (nb[:, a] < (1 << depth))
        want = morton_encode64(*(torch.clamp_min(nb, 0) >> 1).unbind(1))
        q = torch.searchsorted(codes, want).clamp_max(max(n_par - 1, 0))
        found = (in_world & ~inside & (codes[q] == want)) if n_par else \
            torch.zeros(n, dtype=torch.bool, device=dev)
        src[:, k] = torch.where(inside, 8 * own + nslot,
                                torch.where(found, 8 * q + nslot, -1))
        kind[:, k] = torch.where(inside, SIBLING,
                                 torch.where(found, COUSIN, EVALUATE)).to(torch.int8)
    return src, kind


def _probe_points(r, fin):
    """The host's six probe points of candidate records `r` (a CPU tensor):
    (3, 6 m) float32, probe k of every candidate in block k."""
    px, py, pz = _centres(r[:, :3], fin)
    m = r.shape[0]
    q = np.empty((3, 6 * m), np.float32)
    for k, (ax, sgn) in enumerate(PROBES):
        off = [px, py, pz]
        off[ax] = off[ax] + (fin if sgn > 0 else -fin)
        q[:, k * m:(k + 1) * m] = off
    return q


def leaves_plain(scene, rec, depth, par=None, parents=None, full=None):
    """Plain version of ``leaves``: ``octree.build_svo``'s phase B, every
    probe of a solid centre evaluated (the scene calls batched as there);
    `par`, `parents` and `full` are the kernel's and not needed."""
    dev = rec.device
    r = rec.cpu()
    fin = np.float32(2.0 ** (-depth))
    f0 = r[:, 3].contiguous().numpy().view(np.float32)
    survive = np.zeros(r.shape[0], bool)
    si = np.nonzero(f0 <= 0.0)[0]
    if si.size:
        # the six neighbours one voxel away, of every solid centre, in one
        # scene call
        q = _probe_points(r[torch.from_numpy(si)], fin)
        fq = np.asarray(scene(q[0], q[1], q[2]), np.float32)
        survive[si] = (fq.reshape(6, si.size) > 0.0).any(axis=0)
    flags = torch.from_numpy(survive.astype(np.uint8))
    return flags.to(dev), count_plain(flags).to(dev)


def leaves(ds: DeviceScene, rec, depth: int, par, parents, full,
           count_evals: bool = False):
    """The leaf test of the (n, 4) finest-level candidate records `rec` (x,
    y, z at `depth`, f bits of the centre): (survive (n,) uint8, a solid
    centre with an air neighbour one voxel away; the blocks' leaf counts).
    `par` (n,) int32 is each candidate's parent row among the (n_par, 4)
    kept parents `parents` (records at depth - 1, Morton order), and `full`
    (8 n_par, 4) the last expansion's records of all their children, whose
    f the test reads where a probe is such a child's centre. Three kernels
    behind one entry: each kept parent's neighbours, the test, and the
    evaluations it could not avoid. `count_evals`: the counting form, which
    also returns the scene evaluations it made (a Python int; the card
    only)."""
    if rec.device.type == "cpu":
        return leaves_plain(ds.scene, rec, depth, par, parents, full)
    dev = rec.device
    n, n_par = rec.shape[0], parents.shape[0]
    _check_count(max(n, 8 * n_par), "svo_leaves")
    _SVO_LEAVES.check(dev, (("rec", rec, _I32, (n, 4)), ("par", par, _I32, (n,)),
                            ("parents", parents, _I32, (n_par, 4)),
                            ("full", full, _I32, (8 * n_par, 4))))
    survive = torch.empty(n, dtype=_U8, device=dev)
    counts = torch.empty(n_blocks(n), dtype=_I32, device=dev)
    evals = torch.zeros(1, dtype=torch.int64, device=dev) if count_evals else None
    if n:
        # the kept parents' neighbour table, the needy list and its count
        scratch = torch.empty(6 * n_par + n + 1, dtype=_I32, device=dev)
        _SVO_LEAVES(dev, rec.data_ptr(), n, par.data_ptr(), parents.data_ptr(),
                    n_par, full.data_ptr(), float(np.float32(2.0 ** (-depth))),
                    1 << depth, ds.scene_id, *ds.pointers(), survive.data_ptr(),
                    counts.data_ptr(), scratch.data_ptr(),
                    None if evals is None else evals.data_ptr())
        launches["svo_leaves"] += 1
    if count_evals:
        return survive, counts, int(evals)
    return survive, counts


def leaf_attrs_plain(scene, leaf_rec, depth):
    """Plain version of ``leaf_attrs``: the host builder's palette and
    normal at the leaves' centres."""
    r = leaf_rec.cpu()
    attrs = np.zeros((r.shape[0], 6), np.float32)
    if r.shape[0]:
        lx, ly, lz = _centres(r[:, :3], np.float32(2.0 ** (-depth)))
        attrs[:, :3] = default_albedo(lx, ly, lz)
        attrs[:, 3:] = sampler_normal(scene, lx, ly, lz)
    return torch.from_numpy(attrs).to(leaf_rec.device)


def leaf_attrs(ds: DeviceScene, leaf_rec, depth: int):
    """The (m, 6) float32 albedo and normal of the leaves whose (m, 4)
    records (``compact``'s rows of the candidates) are `leaf_rec`."""
    if leaf_rec.device.type == "cpu":
        return leaf_attrs_plain(ds.scene, leaf_rec, depth)
    dev = leaf_rec.device
    m = leaf_rec.shape[0]
    _check_count(m, "svo_leaf_attrs")
    _SVO_LEAF_ATTRS.check(dev, (("leaf_rec", leaf_rec, _I32, (m, 4)),))
    attrs = torch.empty((m, 6), dtype=_F32, device=dev)
    if m:
        _SVO_LEAF_ATTRS(dev, leaf_rec.data_ptr(), m,
                        float(np.float32(2.0 ** (-depth))), ds.scene_id,
                        *ds.pointers(), attrs.data_ptr())
        launches["svo_leaf_attrs"] += 1
    return attrs


def leaves_serial_plain(scene, rec, depth):
    """Plain version of ``leaves_serial``: ``leaves_plain``'s flags and
    counts, and ``leaf_attrs_plain`` at the leaves' rows (zeros
    elsewhere)."""
    survive, counts = leaves_plain(scene, rec, depth)
    rows = torch.nonzero(survive.cpu()).reshape(-1)
    attrs = torch.zeros((rec.shape[0], 6), dtype=_F32)
    attrs[rows] = leaf_attrs_plain(scene, rec.cpu()[rows], depth)
    return survive, attrs.to(rec.device), counts


def leaves_serial(ds: DeviceScene, rec, depth: int):
    """The leaf test's first form (``svo_leaves_serial``), on no build's
    path: (survive, attributes (n, 6) float32 of each leaf at its
    candidate's row, zeros elsewhere, the blocks' leaf counts), every probe
    of a solid centre evaluated."""
    if rec.device.type == "cpu":
        return leaves_serial_plain(ds.scene, rec, depth)
    dev = rec.device
    n = rec.shape[0]
    _check_count(n, "svo_leaves_serial")
    _SVO_LEAVES_SERIAL.check(dev, (("rec", rec, _I32, (n, 4)),))
    survive = torch.empty(n, dtype=_U8, device=dev)
    attrs = torch.empty((n, 6), dtype=_F32, device=dev)
    counts = torch.empty(n_blocks(n), dtype=_I32, device=dev)
    if n:
        _SVO_LEAVES_SERIAL(dev, rec.data_ptr(), n,
                           float(np.float32(2.0 ** (-depth))), ds.scene_id,
                           *ds.pointers(), survive.data_ptr(), attrs.data_ptr(),
                           counts.data_ptr())
        launches["svo_leaves_serial"] += 1
    return survive, attrs, counts


# ---- svo_level_pass ----------------------------------------------------------------

# csrc/svo_build.cu's LTILE: survivors a tile of the level pass
LEVEL_TILE = 2048


class LevelPass(NamedTuple):
    """One level's pass, at level k from level k + 1's survivors, each a
    contiguous int32 tensor: `masks` (b,), each surviving parent's valid
    mask, in order; `first` (b,), the rank of its first surviving child;
    `below` (b,), their candidate indices at level k (the next pass's rows);
    `ranks` (m,), each survivor's parent's rank, or None; `count` (1,), the
    surviving parents, on the rows' device. Only the first `count` entries
    of `masks`, `first` and `below`, and the valid rows of `ranks`, are
    written."""

    masks: torch.Tensor
    first: torch.Tensor
    below: torch.Tensor
    ranks: torch.Tensor | None
    count: torch.Tensor


def level_pass_status(n: int, device):
    """The level pass's status words for a build whose first pass reads `n`
    survivors (the largest of its passes): a control word and a word a
    tile, int64, zeroed. Made once a build; each launch tags its words with
    its own epoch."""
    return torch.zeros(1 + max(-(-n // LEVEL_TILE), 1), dtype=torch.int64,
                       device=device)


def _level_pass_outputs(m, n_par, ranks, count, dev):
    """(masks, first, below, ranks or None, count): the first three rows of
    one allocation."""
    b = min(m, n_par)
    if count is None:
        count = torch.empty(1, dtype=_I32, device=dev)
    planes = torch.empty((3, b), dtype=_I32, device=dev)
    return (*planes.unbind(),
            torch.empty(m, dtype=_I32, device=dev) if ranks else None, count)


def level_pass_plain(rows, code, n_par, n_rows=None, ranks=True, count=None):
    """Plain version of ``level_up``: the runs of equal parents among the
    valid rows, their heads ranked by a cumulative sum (rows past the
    count, and outputs past the parents, stay zero)."""
    dev = rows.device
    m_bound = rows.shape[0]
    m = m_bound if n_rows is None else min(int(n_rows[0]), m_bound)
    masks, first_out, below, rank_out, count = _level_pass_outputs(
        m_bound, n_par, ranks, count, dev)
    for t in (masks, first_out, below):
        t.zero_()
    c_r = code[rows[:m].long()]
    p = c_r >> 3
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = p[1:] != p[:-1]
    seg = torch.cumsum(head, 0) - 1
    first = torch.nonzero(head).reshape(-1)
    c = first.shape[0]
    # a (parent, slot) bit appears once: the sum is the OR
    masks[:c] = torch.zeros(c, dtype=_I32, device=dev).index_add_(
        0, seg, (torch.ones_like(p) << (c_r & 7)).to(_I32))
    first_out[:c] = first.to(_I32)
    below[:c] = p[first]
    if rank_out is not None:
        rank_out.zero_()
        rank_out[:m] = seg.to(_I32)
    count.fill_(c)
    return LevelPass(masks, first_out, below, rank_out, count)


def level_up(rows, code, n_par: int, n_rows=None, ranks: bool = True,
             status=None, count=None) -> LevelPass:
    """Phases C and D at one level: level k's surviving parents from level k
    + 1's survivors. `rows` (m,) int32 are the survivors' candidate indices
    in order (``compact``'s, or the last pass's `below`), of which the
    first `n_rows[0]` are valid ((1,) int32 on the device; None: all m);
    `code` every level k + 1 candidate's parent index * 8 + child slot (one
    word, one gather); `n_par` level k's candidates; `ranks`: write each
    survivor's parent rank (where level k + 1 holds node rows). `status` is
    ``level_pass_status``'s (None: one made for this call) and `count` the
    (1,) int32 to write the count into (None: a new one). Returns a
    ``LevelPass``; nothing crosses to the host. Where nothing survives
    below, no parent survives: the build makes an empty world's root
    itself."""
    if rows.device.type == "cpu":
        return level_pass_plain(rows, code, n_par, n_rows, ranks, count)
    dev = rows.device
    m, n_c = rows.shape[0], code.shape[0]
    if status is None:
        status = level_pass_status(m, dev)
    specs = [("rows", rows, _I32, (m,)), ("code", code, _I32, (n_c,)),
             ("status", status, torch.int64, (status.shape[0],))]
    if n_rows is not None:
        specs.append(("n_rows", n_rows, _I32, (1,)))
    if count is not None:
        specs.append(("count", count, _I32, (1,)))
    _SVO_LEVEL_PASS.check(dev, specs)
    _check_count(m + 2 * LEVEL_TILE, "svo_level_pass")
    if status.shape[0] < 1 + -(-m // LEVEL_TILE):
        raise ValueError(f"svo_level_pass: {status.shape[0]} status words for "
                         f"{m} rows")
    masks, first, below, rank_out, count = _level_pass_outputs(
        m, n_par, ranks, count, dev)
    if m:
        _SVO_LEVEL_PASS(dev, rows.data_ptr(), m,
                        None if n_rows is None else n_rows.data_ptr(),
                        code.data_ptr(), status.data_ptr(), masks.data_ptr(), first.data_ptr(),
                        below.data_ptr(),
                        None if rank_out is None else rank_out.data_ptr(),
                        count.data_ptr())
        launches["svo_level_pass"] += 1
    else:  # nothing below, known on the host: no launch
        count.zero_()
    return LevelPass(masks, first, below, rank_out, count)


# ---- svo_level_up -------------------------------------------------------------------

def level_up_plain(rows, par, slot, n_par):
    """Plain version of ``level_up_serial``."""
    dev = rows.device
    r = rows.cpu().long()
    p = par.cpu()[r].long()
    bits = torch.ones(r.shape[0], dtype=_I32) << slot.cpu()[r]
    # a (parent, slot) bit appears once: the sum is the OR
    vm = torch.zeros(n_par, dtype=_I32).index_add_(0, p, bits)
    first = torch.full((n_par,), BIG, dtype=_I32).scatter_reduce_(
        0, p, torch.arange(r.shape[0], dtype=_I32), "amin")
    return (torch.stack([vm, first], 1).to(dev),
            (vm != 0).to(_U8).to(dev))


def level_up_serial(rows, par, slot, n_par: int):
    """The level-up's first form (``svo_level_up``), on no build's path:
    parents from their surviving children, `rows` (m,) int32 the surviving
    children's candidate indices in order (``compact``'s), `par` and `slot`
    every child candidate's parent index and child slot. Returns ((n_par, 2)
    int32: each parent's valid mask and the rank in `rows` of its first
    surviving child, BIG for none; (n_par,) uint8, the parents with a
    surviving child), which ``count`` and ``compact`` then rank."""
    if rows.device.type == "cpu":
        return level_up_plain(rows, par, slot, n_par)
    dev = rows.device
    m, n_c = rows.shape[0], par.shape[0]
    _SVO_LEVEL_UP.check(dev, (("rows", rows, _I32, (m,)),
                              ("par", par, _I32, (n_c,)),
                              ("slot", slot, _I32, (n_c,))))
    _check_count(max(m, n_par), "svo_level_up")
    rec = torch.zeros((n_par, 2), dtype=_I32, device=dev)
    rec[:, 1] = BIG
    survive = torch.zeros(n_par, dtype=_U8, device=dev)
    if m:
        _SVO_LEVEL_UP(dev, rows.data_ptr(), m, par.data_ptr(), slot.data_ptr(),
                      rec.data_ptr(), survive.data_ptr())
        launches["svo_level_up"] += 1
    return rec, survive


# ---- svo_parent_ptr -----------------------------------------------------------------

def parent_ptr_plain(masks, child_base):
    """Plain version of ``parent_ptr``: ``octree.compute_parent_ptr``."""
    return torch.from_numpy(compute_parent_ptr(
        masks.cpu().numpy(), child_base.cpu().numpy())).to(masks.device)


def parent_ptr(masks, child_base):
    """Each node row's parent row (the root's is itself) of a builder's
    packed (n,) int32 `masks` and `child_base`: phase D's first form, on no
    build's path (the level pass writes the parent ranks)."""
    if masks.device.type == "cpu":
        return parent_ptr_plain(masks, child_base)
    dev = masks.device
    n = masks.shape[0]
    _check_count(n, "svo_parent_ptr")
    _SVO_PARENT_PTR.check(dev, (("masks", masks, _I32, (n,)),
                                ("child_base", child_base, _I32, (n,))))
    pptr = torch.zeros(n, dtype=_I32, device=dev)
    if n:
        _SVO_PARENT_PTR(dev, masks.data_ptr(), child_base.data_ptr(), n,
                        pptr.data_ptr())
        launches["svo_parent_ptr"] += 1
    return pptr


# ---- scene_eval ---------------------------------------------------------------------

def scene_eval_plain(scene, x, y, z):
    """Plain version of ``scene_eval``: the host scene."""
    f = scene(x.cpu().numpy(), y.cpu().numpy(), z.cpu().numpy())
    return torch.from_numpy(np.asarray(f, np.float32)).to(x.device)


def scene_eval(ds: DeviceScene, x, y, z):
    """The scene's float32 density at the (n,) float32 points x, y, z."""
    if x.device.type == "cpu":
        return scene_eval_plain(ds.scene, x, y, z)
    dev = x.device
    n = x.shape[0]
    _check_count(n, "scene_eval")
    _SCENE_EVAL.check(dev, tuple((name, t, _F32, (n,))
                                 for name, t in (("x", x), ("y", y), ("z", z))))
    out = torch.empty(n, dtype=_F32, device=dev)
    if n:
        _SCENE_EVAL(dev, x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                    ds.scene_id, *ds.pointers(), out.data_ptr())
        launches["scene_eval"] += 1
    return out
