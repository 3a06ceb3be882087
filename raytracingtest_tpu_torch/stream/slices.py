"""Slice-based incremental SVO construction, on the host in numpy.

Port of ``raytracingtest_tpu/stream/slices.py``:

  * ``occupancy_pyramid``: the occupancy of every level, Morton-ordered; the
    finest level by the exact leaf test (solid, with an air neighbour), the
    coarser ones by OR over each 8 children.
  * ``extend_svo``: one level of detail added to a build. The stored finest
    candidate frontier (``BuildResult.frontier_coords``) is expanded, pruned
    with the scene's Lipschitz bound and leaf-tested; the masks and pointers
    above are rebuilt from survival, octants that gain leaves included. The
    result equals a fresh build one level deeper, byte for byte.

No kernel: the arrays are numpy, and the SVO comes back as CPU tensors, as
``build_svo`` hands it over.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingtest_tpu_torch.ops.morton import (
    morton_decode64, morton_encode, morton_encode64)
from raytracingtest_tpu_torch.ops.octree import (
    SVO, BuildResult, CHILD_OFFSETS, compute_parent_ptr, default_albedo,
    sampler_normal)

_SQRT3 = float(np.sqrt(3.0))
_AXES = (0, 0, 1, 1, 2, 2)


def _leaf_test(scene, px, py, pz, finest):
    """Solid voxel centres with an air neighbour one voxel away."""
    solid = np.asarray(scene(px, py, pz), np.float32) <= 0.0
    air = np.zeros_like(solid)
    d = np.float32(finest)
    for ax, sgn in zip(_AXES, (d, -d) * 3):
        off = [px, py, pz]
        off[ax] = off[ax] + sgn
        air |= np.asarray(scene(off[0], off[1], off[2]), np.float32) > 0.0
    return solid & air


def occupancy_pyramid(scene, depth: int):
    """[level 0 .. level depth] bool arrays of length 8^l, Morton-ordered:
    level `depth` by the exact leaf test, the coarser levels by OR over each
    8 children. Dense (8^depth points): depth <= 8."""
    R = 1 << depth
    finest = 1.0 / R
    idx = np.arange(R)
    cx, cy, cz = np.meshgrid(idx, idx, idx, indexing="ij")
    code = morton_encode(cx.ravel().astype(np.uint32),
                         cy.ravel().astype(np.uint32),
                         cz.ravel().astype(np.uint32))
    order = np.argsort(code)
    px = ((cx.ravel()[order] + 0.5) * finest).astype(np.float32)
    py = ((cy.ravel()[order] + 0.5) * finest).astype(np.float32)
    pz = ((cz.ravel()[order] + 0.5) * finest).astype(np.float32)

    pyramid = [None] * (depth + 1)
    pyramid[depth] = _leaf_test(scene, px, py, pz, finest)
    for l in range(depth - 1, -1, -1):
        # Morton order keeps one parent's children together
        pyramid[l] = pyramid[l + 1].reshape(-1, 8).any(axis=1)
    return pyramid


def extend_svo(result: BuildResult, scene) -> BuildResult:
    """The build `result` (depth k) with one more level of detail (depth
    k + 1): a ``BuildResult`` equal to ``build_svo(scene, k + 1)``'s."""
    depth = result.svo.depth
    new_depth = depth + 1
    finest = 2.0 ** (-new_depth)
    L = float(scene.lipschitz)

    # ---- the candidate frontier, one level down (build_svo's phase A) ----
    frontier = result.frontier_coords.astype(np.int64)
    cc = (frontier[:, None, :] * 2 + CHILD_OFFSETS[None, :, :]).reshape(-1, 3)
    half = 2.0 ** (-(new_depth + 1))
    center = (cc.astype(np.float64) + 0.5) * finest
    px = center[:, 0].astype(np.float32)
    py = center[:, 1].astype(np.float32)
    pz = center[:, 2].astype(np.float32)
    f = np.asarray(scene(px, py, pz), np.float32)
    r = _SQRT3 * half
    keep = (f <= L * r + 1e-6) & (f >= -(L * (r + 2.0 * finest)) - 1e-6)
    cc, px, py, pz = cc[keep], px[keep], py[keep], pz[keep]

    # ---- the exact leaf test (phase B) ------------------------------------
    new_leaf = _leaf_test(scene, px, py, pz, finest)

    # ---- survival upwards: each level is the old nodes and the parents of
    # surviving finer entries, Morton-sorted and deduplicated ----------------
    level_sets = [None] * (new_depth + 1)
    survive = [None] * (new_depth + 1)
    level_sets[new_depth] = cc
    survive[new_depth] = new_leaf
    valid_masks = [None] * new_depth
    for l in range(new_depth - 1, -1, -1):
        child_cc = level_sets[l + 1]
        s_child = survive[l + 1]
        allm = np.unique(_morton_of(child_cc[s_child] // 2))
        if l < depth:
            old_m = _morton_of(result.node_coords[l].astype(np.int64))
            allm = np.unique(np.concatenate([old_m, allm]))
        lvl_cc = np.stack(morton_decode64(allm), axis=1).astype(np.int64)
        level_sets[l] = lvl_cc
        slot = ((child_cc[:, 0] & 1) | ((child_cc[:, 1] & 1) << 1)
                | ((child_cc[:, 2] & 1) << 2)).astype(np.int32)
        pidx = np.searchsorted(allm, _morton_of(child_cc // 2))
        vm = np.zeros(lvl_cc.shape[0], np.int32)
        np.bitwise_or.at(vm, pidx[s_child], np.int32(1) << slot[s_child])
        valid_masks[l] = vm
        survive[l] = vm != 0
    survive[0][0] = True

    # ---- compaction and pointers (build_svo's phase C) --------------------
    new_idx = [np.cumsum(s, dtype=np.int64) - 1 for s in survive[:new_depth]]
    level_counts = [int(s.sum()) for s in survive[:new_depth]]
    leaf_idx = np.cumsum(survive[new_depth], dtype=np.int64) - 1
    n_leaves = int(survive[new_depth].sum())

    level_start = np.zeros(new_depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])
    n_nodes = int(level_start[-1])

    out_masks = np.zeros(n_nodes, np.int32)
    out_child = np.zeros(n_nodes, np.int32)
    out_leaf = np.zeros(n_nodes, np.int32)
    node_coords = []
    big = np.int64(1) << 60
    for l in range(new_depth):
        s = survive[l]
        rows = level_start[l] + new_idx[l][s]
        vmx = valid_masks[l][s]
        node_coords.append(level_sets[l][s].astype(np.int32))
        pidx = np.searchsorted(_morton_of(level_sets[l]),
                               _morton_of(level_sets[l + 1] // 2))
        fb = np.full(level_sets[l].shape[0], big)
        sc = survive[l + 1]
        if l == new_depth - 1:
            out_masks[rows] = (vmx << 8) | vmx
            np.minimum.at(fb, pidx[sc], leaf_idx[sc])
            out_leaf[rows] = np.where(fb[s] >= big, 0, fb[s]).astype(np.int32)
        else:
            out_masks[rows] = vmx << 8
            np.minimum.at(fb, pidx[sc], level_start[l + 1] + new_idx[l + 1][sc])
            out_child[rows] = np.where(fb[s] >= big, 0, fb[s]).astype(np.int32)

    sl = survive[new_depth]
    lpx, lpy, lpz = px[sl], py[sl], pz[sl]
    t = torch.from_numpy
    svo = SVO(
        masks=t(out_masks), child_base=t(out_child), leaf_base=t(out_leaf),
        leaf_albedo=t(default_albedo(lpx, lpy, lpz).astype(np.float32)),
        leaf_normal=t(sampler_normal(scene, lpx, lpy, lpz).astype(np.float32)),
        leaf_density=t(np.ones(n_leaves, np.float32)),
        depth=new_depth,
        level_start=tuple(int(v) for v in level_start),
        parent_ptr=t(compute_parent_ptr(out_masks, out_child)),
    )
    return BuildResult(
        svo=svo, leaf_coords=cc[sl].astype(np.int32), node_coords=node_coords,
        n_candidates=result.n_candidates + [cc.shape[0]],
        frontier_coords=cc.astype(np.int32))


def _morton_of(cc):
    """64-bit Morton codes of (n, 3) integer coordinates."""
    cc = np.asarray(cc)
    return morton_encode64(cc[:, 0].astype(np.uint64), cc[:, 1].astype(np.uint64),
                           cc[:, 2].astype(np.uint64))
