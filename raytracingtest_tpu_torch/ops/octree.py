"""SVO data model and the host-side hierarchical builder.

Port of ``raytracingtest_tpu/ops/octree.py``. The octree is a
struct-of-arrays over levels (root is row 0; level l's nodes occupy
[level_start[l], level_start[l+1])):

  masks[i]       int32  (valid_mask << 8) | leaf_mask
  child_base[i]  int32  row of node i's first non-leaf child
  leaf_base[i]   int32  row of node i's first leaf child in the leaf arrays

Children are packed in Morton child order (x fastest); child k of node i is
``child_base[i] + popcount(valid & ~leaf & ((1<<k)-1))`` and leaf child k is
``leaf_base[i] + popcount(valid & leaf & ((1<<k)-1))``.

``build_svo`` stays a numpy frontier sweep on the host, operation for
operation the JAX package's, so its arrays are byte-identical to that
builder's; only the result is handed over as torch tensors.
``build_from_leaves`` builds the same layout bottom up from leaf
coordinates (Morton codes, ``ops/morton.py``). The build on the card is
``ops/octree_device.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve

_SQRT3 = float(np.sqrt(3.0))

# Morton child order: slot k -> offset ((k>>0)&1, (k>>1)&1, (k>>2)&1).
CHILD_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], dtype=np.int32
)


@dataclasses.dataclass(frozen=True)
class SVO:
    """Packed sparse voxel octree: tensors on one device, plus the static
    depth and level layout."""

    masks: torch.Tensor         # int32 [n_nodes]   (valid<<8)|leaf
    child_base: torch.Tensor    # int32 [n_nodes]
    leaf_base: torch.Tensor     # int32 [n_nodes]
    leaf_albedo: torch.Tensor   # float32 [n_leaves, 3]
    leaf_normal: torch.Tensor   # float32 [n_leaves, 3] unit outward normals
    leaf_density: torch.Tensor  # float32 [n_leaves]
    depth: int
    level_start: tuple
    # int32 [n_nodes] parent row of each node (root -> itself)
    parent_ptr: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return int(self.level_start[-1])

    @property
    def n_leaves(self) -> int:
        return self.leaf_albedo.shape[0]

    def to(self, device=None) -> "SVO":
        """Copy of this SVO with every tensor on `device` (None: the
        default device); this SVO itself where every tensor is there
        already, so that the tables kept with the tree
        (``traverse.node_rows``) stay with it."""
        device = resolve(device)
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        moved = {name: value.to(device) if isinstance(value, torch.Tensor) else value
                 for name, value in fields.items()}
        if all(moved[name] is value for name, value in fields.items()):
            return self
        return SVO(**moved)


@dataclasses.dataclass
class BuildResult:
    """``build_svo``'s output: the SVO (CPU tensors) and the host build's
    numpy by-products. ``frontier_coords`` is the finest level's candidate
    set (after the Lipschitz pruning, before the leaf test), which
    ``stream/slices.py`` refines so that an extended build equals a fresh
    deeper one."""

    svo: SVO
    leaf_coords: np.ndarray  # int32 [n_leaves, 3] finest-grid coordinates
    node_coords: list        # per level: int32 [n_l, 3] octant coordinates
    n_candidates: list       # per level: candidate count (pre-prune)
    frontier_coords: np.ndarray = None  # int32 [n_cand, 3] finest candidates


def default_albedo(px, py, pz):
    """Position-derived rainbow palette, float32 (n, 3)."""
    px = np.asarray(px, np.float32)
    py = np.asarray(py, np.float32)
    pz = np.asarray(pz, np.float32)
    t = px * 3.1 + py * 5.3 + pz * 7.9
    r = 0.5 + 0.5 * np.sin(6.0 * t)
    g = 0.5 + 0.5 * np.sin(6.0 * t + 2.094)
    b = 0.5 + 0.5 * np.sin(6.0 * t + 4.188)
    return np.stack([r, g, b], axis=-1)


def sampler_normal(scene, px, py, pz, h=1e-3):
    """Central-difference gradient normal of the scene's density."""
    fx = scene(px + h, py, pz) - scene(px - h, py, pz)
    fy = scene(px, py + h, pz) - scene(px, py - h, pz)
    fz = scene(px, py, pz + h) - scene(px, py, pz - h)
    n = np.stack([fx, fy, fz], axis=-1)
    norm = np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    return n / np.maximum(norm, 1e-12)


def compute_parent_ptr(masks, child_base):
    """Each node row's parent row (root at itself): scatter each parent at
    its child block's start and forward-fill with a running maximum (child
    blocks are contiguous and ordered by parent row)."""
    masks = np.asarray(masks)
    child_base = np.asarray(child_base)
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    nl = (vm & ~lm) & 0xFF
    has = nl != 0
    seed = np.zeros(n, np.int32)
    seed[child_base[has]] = np.arange(n, dtype=np.int32)[has]
    return np.maximum.accumulate(seed).astype(np.int32)


def _sorted_unique(par):
    """(unique values, first-occurrence starts) of an already-sorted array."""
    starts = np.concatenate(
        [np.zeros(1, np.int64), np.flatnonzero(par[1:] != par[:-1]) + 1])
    return par[starts], starts


def build_from_leaves(leaf_coords, depth: int, albedo=None, normal=None,
                      density=None) -> SVO:
    """Packed SVO (CPU tensors) straight from finest-level leaf coordinates,
    bottom up: each level is one unique-prefix pass over the sorted Morton
    codes, which gives ``build_svo``'s breadth-first layout bit for bit.

    Attribute arrays (n_leaves, ...) are reordered to Morton leaf order;
    when omitted, albedo is the position palette, normal +y and density 1.
    Duplicate or out-of-range coordinates raise ``ValueError``.
    """
    from raytracingtest_tpu_torch.ops.morton import morton_encode64

    leaf_coords = np.asarray(leaf_coords, np.int64)
    n_in = leaf_coords.shape[0]
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if n_in and int(leaf_coords.max()) >= (1 << depth):
        raise ValueError("leaf coordinate out of range for depth")

    code = morton_encode64(leaf_coords[:, 0], leaf_coords[:, 1],
                           leaf_coords[:, 2])
    order = np.argsort(code, kind="stable")
    code = code[order]
    if n_in and np.any(code[1:] == code[:-1]):
        raise ValueError("duplicate leaf coordinates")

    # level l's nodes: the unique (leaf code >> 3 (depth - l)), bottom up
    codes = [None] * (depth + 1)
    codes[depth] = code
    for l in range(depth - 1, -1, -1):
        parent = codes[l + 1] >> 3
        keep = np.ones(parent.shape[0], bool)
        keep[1:] = parent[1:] != parent[:-1]
        codes[l] = parent[keep]
    if codes[0].shape[0] == 0:
        codes[0] = np.zeros(1, np.int64)  # keep an (empty) root

    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum([c.shape[0] for c in codes[:depth]], out=level_start[1:])
    n_nodes = int(level_start[-1])
    masks = np.zeros(n_nodes, np.int32)
    child_base = np.zeros(n_nodes, np.int32)
    leaf_base = np.zeros(n_nodes, np.int32)

    for l in range(depth):
        child = codes[l + 1]
        if child.shape[0] == 0:
            continue
        parent = child >> 3
        first = np.ones(child.shape[0], bool)
        first[1:] = parent[1:] != parent[:-1]
        starts = np.flatnonzero(first)
        rows = level_start[l] + np.arange(codes[l].shape[0])
        bits = np.int32(1) << (child & 7).astype(np.int32)
        vm = np.bitwise_or.reduceat(bits, starts)
        if l == depth - 1:
            masks[rows] = (vm << 8) | vm
            leaf_base[rows] = starts.astype(np.int32)
        else:
            masks[rows] = vm << 8
            child_base[rows] = (level_start[l + 1] + starts).astype(np.int32)

    lc = leaf_coords[order]
    fin = np.float32(2.0 ** (-depth))
    px = (lc[:, 0].astype(np.float32) + 0.5) * fin
    py = (lc[:, 1].astype(np.float32) + 0.5) * fin
    pz = (lc[:, 2].astype(np.float32) + 0.5) * fin
    if albedo is not None:
        alb = np.asarray(albedo, np.float32)[order]
    else:
        alb = default_albedo(px, py, pz).astype(np.float32)
    if normal is not None:
        nrm = np.asarray(normal, np.float32)[order]
    else:
        nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n_in, 1))
    den = (np.asarray(density, np.float32)[order] if density is not None
           else np.ones(n_in, np.float32))

    t = torch.from_numpy
    return SVO(
        masks=t(masks), child_base=t(child_base), leaf_base=t(leaf_base),
        leaf_albedo=t(np.ascontiguousarray(alb)),
        leaf_normal=t(np.ascontiguousarray(nrm)),
        leaf_density=t(np.ascontiguousarray(den)),
        depth=depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=t(compute_parent_ptr(masks, child_base)),
    )


def build_svo(scene, depth: int, prune: bool = True,
              attr_frame=None) -> BuildResult:
    """Build a packed SVO (CPU tensors) from a signed-density scene; returns
    a ``BuildResult`` (its ``.svo``, and the build's coordinates).

    Host-side numpy frontier build with Lipschitz pruning: an octant is kept
    only if the surface can pass within it. A finest-level voxel is a leaf
    iff its center is solid and one of its six axis neighbours (one voxel
    away) is air; interior nodes exist iff their subtree holds a leaf.
    ``prune=False`` expands every octant instead (exact, 8^depth work: small
    depths only).

    ``attr_frame=(world_scene, origin, size)``: `scene` is a chunk-local
    rescale of a larger world, and leaf attributes (palette albedo,
    gradient normals) are evaluated at the leaves' world coordinates
    ``p * size + origin`` on `world_scene`, as a monolithic build of that
    world would give them.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    L = float(scene.lipschitz)
    finest = 2.0 ** (-depth)

    # ---- Phase A: downward frontier sweep -------------------------------
    # coords[l]: int32 [n_l, 3] candidate octant coords at level l (Morton-
    # sorted); parent_of[l]: index into coords[l-1]; slot_of[l]: child slot.
    coords = [np.zeros((1, 3), np.int32)]
    parent_of = [np.zeros((1,), np.int64)]
    slot_of = [np.zeros((1,), np.int32)]
    n_candidates = [1]
    f_finest = None  # finest-level f(center) values, reused by phase B

    for l in range(1, depth + 1):
        p = coords[l - 1]
        n_p = p.shape[0]
        # expand: children in Morton child order, parent-major
        cc = (p[:, None, :] * 2 + CHILD_OFFSETS[None, :, :]).reshape(-1, 3)
        if not prune:
            coords.append(cc)
            parent_of.append(np.repeat(np.arange(n_p, dtype=np.int64), 8))
            slot_of.append(np.tile(np.arange(8, dtype=np.int32), n_p))
            n_candidates.append(cc.shape[0])
            continue
        half = 2.0 ** (-(l + 1))
        # float32 is exact here: (c + 0.5) * 2^-l is a dyadic rational
        scale_l = np.float32(2.0 ** (-l))
        px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * scale_l
        py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * scale_l
        pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * scale_l
        f = np.asarray(scene(px, py, pz), np.float32)
        # keep an octant that can hold a solid voxel center (f <= L*r) with
        # an air neighbour one voxel outside it (f >= -L*(r + 2*finest))
        r = _SQRT3 * half
        keep = (f <= L * r + 1e-6) & (f >= -(L * (r + 2.0 * finest)) - 1e-6)
        # children are parent-major, 8 per parent
        kept = np.nonzero(keep)[0]
        cc = cc[kept]
        if l == depth:
            f_finest = f[kept]
        coords.append(cc)
        parent_of.append(kept >> 3)
        slot_of.append((kept & 7).astype(np.int32))
        n_candidates.append(cc.shape[0])

    # ---- Phase B: exact leaf test at the finest level -------------------
    cc = coords[depth]
    fin32 = np.float32(finest)
    px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * fin32
    py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * fin32
    pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * fin32
    if f_finest is None:  # prune=False evaluated no level yet
        f_finest = np.asarray(scene(px, py, pz), np.float32)
    solid = f_finest <= 0.0
    # six-neighbour air probe at one voxel size, for solid voxels only, in
    # one batched scene call
    survive_leaf = np.zeros_like(solid)
    si = np.nonzero(solid)[0]
    if si.size:
        sx, sy, sz = px[si], py[si], pz[si]
        m = si.size
        qx = np.empty(6 * m, np.float32)
        qy = np.empty(6 * m, np.float32)
        qz = np.empty(6 * m, np.float32)
        k = 0
        for ax, sgn in ((0, fin32), (0, -fin32), (1, fin32), (1, -fin32),
                        (2, fin32), (2, -fin32)):
            off = [sx, sy, sz]
            off[ax] = off[ax] + sgn
            qx[k * m:(k + 1) * m] = off[0]
            qy[k * m:(k + 1) * m] = off[1]
            qz[k * m:(k + 1) * m] = off[2]
            k += 1
        fq = np.asarray(scene(qx, qy, qz), np.float32)
        air = (fq.reshape(6, m) > 0.0).any(axis=0)
        survive_leaf[si] = air

    # ---- Phase C: upward pruning + mask/pointer assembly ----------------
    # parent_of[l] is non-decreasing, so per-parent scatters are sorted-
    # segment reductions.
    survive = [None] * (depth + 1)
    survive[depth] = survive_leaf
    valid_masks = [None] * depth
    for l in range(depth - 1, -1, -1):
        n_c = coords[l].shape[0]
        vm = np.zeros(n_c, np.int32)
        s_child = survive[l + 1]
        par = parent_of[l + 1][s_child]
        bits = np.int32(1) << slot_of[l + 1][s_child]
        if par.size:
            upar, starts = _sorted_unique(par)
            vm[upar] = np.bitwise_or.reduceat(bits, starts)
        valid_masks[l] = vm
        survive[l] = vm != 0
    # keep the root, possibly empty, as the traversal's entry point
    survive[0][0] = True

    new_idx = [None] * (depth + 1)
    level_counts = []
    for l in range(depth):
        s = survive[l]
        new_idx[l] = np.cumsum(s, dtype=np.int64) - 1
        level_counts.append(int(s.sum()))
    s = survive[depth]
    leaf_idx = np.cumsum(s, dtype=np.int64) - 1
    n_leaves = int(s.sum())

    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])

    n_nodes = int(level_start[-1])
    masks = np.zeros(n_nodes, np.int32)
    child_base = np.zeros(n_nodes, np.int32)
    leaf_base = np.zeros(n_nodes, np.int32)
    node_coords = []

    def _first_child_per_parent(n_parents, par, vals):
        # par sorted, vals increasing: a parent's first child is at its
        # first occurrence
        fb = np.zeros(n_parents, np.int64)
        if par.size:
            upar, starts = _sorted_unique(par)
            fb[upar] = vals[starts]
        return fb

    for l in range(depth):
        s = survive[l]
        rows = level_start[l] + new_idx[l][s]
        vm = valid_masks[l][s]
        node_coords.append(coords[l][s])
        if l == depth - 1:
            masks[rows] = (vm << 8) | vm  # all children are leaves
            sc = survive[depth]
            fb = _first_child_per_parent(
                coords[l].shape[0], parent_of[depth][sc], leaf_idx[sc])
            leaf_base[rows] = fb[s].astype(np.int32)
        else:
            masks[rows] = vm << 8
            sc = survive[l + 1]
            fb = _first_child_per_parent(
                coords[l].shape[0], parent_of[l + 1][sc],
                level_start[l + 1] + new_idx[l + 1][sc])
            child_base[rows] = fb[s].astype(np.int32)

    # ---- Leaf attributes -------------------------------------------------
    sl = survive[depth]
    lpx, lpy, lpz = px[sl], py[sl], pz[sl]
    if attr_frame is not None:
        scene, origin, size = attr_frame
        lpx = lpx * np.float32(size) + np.float32(origin[0])
        lpy = lpy * np.float32(size) + np.float32(origin[1])
        lpz = lpz * np.float32(size) + np.float32(origin[2])
    albedo = default_albedo(lpx, lpy, lpz).astype(np.float32)
    normal = sampler_normal(scene, lpx, lpy, lpz).astype(np.float32)
    density = np.ones(n_leaves, np.float32)

    t = torch.from_numpy
    svo = SVO(
        masks=t(masks),
        child_base=t(child_base),
        leaf_base=t(leaf_base),
        leaf_albedo=t(albedo),
        leaf_normal=t(normal),
        leaf_density=t(density),
        depth=depth,
        level_start=tuple(int(v) for v in level_start),
        parent_ptr=t(compute_parent_ptr(masks, child_base)),
    )
    return BuildResult(svo=svo, leaf_coords=cc[sl].astype(np.int32),
                       node_coords=node_coords, n_candidates=n_candidates,
                       frontier_coords=cc.astype(np.int32))
