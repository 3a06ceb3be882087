"""The SVO builder's kernels on the card: the wrappers of ``csrc/svo_build.cu``.

Counterpart of the XLA programs of ``raytracingtest_tpu/ops/octree_device.py``
(K7), which ``ops/octree_device.py`` drives level by level:

  * ``expand``      (``svo_expand``): a level's children, the scene at their
                    centres and the keep test; records (x, y, z, f bits).
  * ``count`` and ``compact`` (``svo_compact``, count and place modes): the
                    blocks' counts of flagged rows, and a stable compaction
                    of the flagged rows' indices and record words.
  * ``leaves``      (``svo_leaves``): the finest level's leaf test and, for a
                    leaf, its albedo and normal.
  * ``level_up``    (``svo_level_up``): each parent's valid mask and first
                    child from its surviving children.
  * ``parent_ptr``  (``svo_parent_ptr``): each node's parent row.
  * ``scene_eval``  the scene library at given points, the check of
                    ``csrc/scene.cuh``; no build calls it.

CUDA tensors launch the kernels; CPU tensors take the plain versions beside
them: torch ops around the port's own numpy scene (which batches its scene
calls as ``octree.build_svo`` does, so it gives that builder's bits),
``torch.nonzero`` for the compaction, ``index_add_``/``scatter_reduce_`` for
the masks and first children, ``octree.compute_parent_ptr``. Every function
returns the same tensors on both paths, the blocks' counts included (blocks
of ``BLOCK`` rows). The card evaluates a scene by its id in ``scene.cuh``
(``SCENE_IDS``, by ``Scene.name``); a scene the library lacks raises there,
and nothing falls back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingtest_tpu_torch._build import svo_lib
from raytracingtest_tpu_torch._launch import Kernel
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

# kernel launches made by this process, by kernel (a launch of either mode
# of svo_compact counts once)
launches = {"svo_expand": 0, "svo_compact": 0, "svo_leaves": 0,
            "svo_level_up": 0, "svo_parent_ptr": 0, "scene_eval": 0}

_SVO_EXPAND = Kernel("svo_expand", svo_lib)
_SVO_COMPACT = Kernel("svo_compact", svo_lib)
_SVO_LEAVES = Kernel("svo_leaves", svo_lib)
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


# ---- svo_expand ---------------------------------------------------------------

def expand_plain(scene, parents, level, thr_hi, thr_lo):
    """Plain version of ``expand`` (any device; the scene runs on the
    host)."""
    dev = parents.device
    child = (parents[:, None, :3].cpu() * 2
             + torch.from_numpy(CHILD_OFFSETS)[None]).reshape(-1, 3)
    px, py, pz = _centres(child, np.float32(2.0 ** (-level)))
    f = torch.from_numpy(np.asarray(scene(px, py, pz), np.float32))
    keep = ((f <= thr_hi) & (f >= thr_lo)).to(_U8)
    rec = torch.cat([child, f.view(_I32)[:, None]], 1)
    return rec.to(dev), keep.to(dev), count_plain(keep).to(dev)


def expand(ds: DeviceScene, parents, level: int, thr_hi: float,
           thr_lo: float):
    """Children of the (n_p, 4) int32 candidate records `parents` (x, y, z
    at level - 1, f bits) at `level`: (records (8 n_p, 4) int32 in Morton
    child order, parent-major, with the scene at each child's centre; keep
    flags (8 n_p,) uint8, thr_lo <= f <= thr_hi in float32; the blocks' kept
    counts)."""
    if parents.device.type == "cpu":
        return expand_plain(ds.scene, parents, level, thr_hi, thr_lo)
    dev = parents.device
    n_p = parents.shape[0]
    n = 8 * n_p
    _check_count(n, "svo_expand")
    _SVO_EXPAND.check(dev, (("parents", parents, _I32, (n_p, 4)),))
    rec = torch.empty((n, 4), dtype=_I32, device=dev)
    keep = torch.empty(n, dtype=_U8, device=dev)
    counts = torch.empty(n_blocks(n), dtype=_I32, device=dev)
    if n:
        _SVO_EXPAND(dev, parents.data_ptr(), n, float(np.float32(2.0 ** (-level))),
                    thr_hi, thr_lo, ds.scene_id, *ds.pointers(),
                    rec.data_ptr(), keep.data_ptr(), counts.data_ptr())
        launches["svo_expand"] += 1
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


# ---- svo_leaves -------------------------------------------------------------------

def leaves_plain(scene, rec, depth):
    """Plain version of ``leaves``: ``octree.build_svo``'s phase B and leaf
    attributes, its scene calls batched as there."""
    dev = rec.device
    r = rec.cpu()
    n = r.shape[0]
    fin = np.float32(2.0 ** (-depth))
    px, py, pz = _centres(r[:, :3], fin)
    f0 = r[:, 3].contiguous().numpy().view(np.float32)
    survive = np.zeros(n, bool)
    si = np.nonzero(f0 <= 0.0)[0]
    if si.size:
        # the six neighbours one voxel away, of every solid centre, in one
        # scene call
        sx, sy, sz = px[si], py[si], pz[si]
        m = si.size
        q = np.empty((3, 6 * m), np.float32)
        for k, (ax, sgn) in enumerate(((0, fin), (0, -fin), (1, fin),
                                       (1, -fin), (2, fin), (2, -fin))):
            off = [sx, sy, sz]
            off[ax] = off[ax] + sgn
            q[:, k * m:(k + 1) * m] = off
        fq = np.asarray(scene(q[0], q[1], q[2]), np.float32)
        survive[si] = (fq.reshape(6, m) > 0.0).any(axis=0)
    attrs = np.zeros((n, 6), np.float32)
    lx, ly, lz = px[survive], py[survive], pz[survive]
    attrs[survive, :3] = default_albedo(lx, ly, lz)
    attrs[survive, 3:] = sampler_normal(scene, lx, ly, lz)
    flags = torch.from_numpy(survive.astype(np.uint8))
    return (flags.to(dev), torch.from_numpy(attrs).to(dev),
            count_plain(flags).to(dev))


def leaves(ds: DeviceScene, rec, depth: int):
    """The leaf test of the (n, 4) finest-level candidate records `rec`
    (x, y, z at `depth`, f bits of the centre): (survive (n,) uint8: a solid
    centre with an air neighbour one voxel away; attributes (n, 6) float32,
    a leaf's albedo and normal, zeros elsewhere; the blocks' leaf counts)."""
    if rec.device.type == "cpu":
        return leaves_plain(ds.scene, rec, depth)
    dev = rec.device
    n = rec.shape[0]
    _check_count(n, "svo_leaves")
    _SVO_LEAVES.check(dev, (("rec", rec, _I32, (n, 4)),))
    survive = torch.empty(n, dtype=_U8, device=dev)
    attrs = torch.empty((n, 6), dtype=_F32, device=dev)
    counts = torch.empty(n_blocks(n), dtype=_I32, device=dev)
    if n:
        _SVO_LEAVES(dev, rec.data_ptr(), n, float(np.float32(2.0 ** (-depth))),
                    ds.scene_id, *ds.pointers(), survive.data_ptr(),
                    attrs.data_ptr(), counts.data_ptr())
        launches["svo_leaves"] += 1
    return survive, attrs, counts


# ---- svo_level_up -------------------------------------------------------------------

def level_up_plain(rows, par, slot, n_par):
    """Plain version of ``level_up``."""
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


def level_up(rows, par, slot, n_par: int):
    """Parents from their surviving children: `rows` (m,) int32 are the
    surviving children's candidate indices in order (``compact``'s), `par`
    and `slot` every child candidate's parent index and child slot. Returns
    ((n_par, 2) int32: each parent's valid mask and the rank in `rows` of
    its first surviving child, BIG for none; (n_par,) uint8, the parents
    with a surviving child)."""
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
    packed (n,) int32 `masks` and `child_base`."""
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
