"""The SVO builder on the card.

Port of ``raytracingtest_tpu/ops/octree_device.py`` (K7): ``build_svo``'s
frontier sweep with every phase on the device, driven level by level over
the kernels of ``ops/octree_cuda.py`` (``csrc/svo_build.cu``):

  A. expansion and Lipschitz pruning, a level at a time (a heightfield's
     ``columns``, then ``expand`` and ``compact``), in chunks of
     ``CHUNK_PARENTS`` parents;
  B. the exact leaf test at the finest level (``leaves``, which reads the
     last expansion's records of every child of a kept parent, kept or not,
     where a probe is such a child's centre), ``compact``, then each leaf's
     attributes in a dense pass over the leaves (``leaf_attrs``);
  C. upward pruning, bottom up, one pass a level (``level_up``): each
     level's surviving parents, their masks and first children at their
     ranks, the next level's rows and its count, which stays on the device
     (the next pass reads it there; the host reads every level's count once,
     after the last), then the assembly of masks and pointers in torch;
  D. parent pointers: the same passes' parent ranks, each level's offset
     added in the assembly.

Candidate buffers stay on the device; in phases A and B one scalar a
compaction (its kept count, which sizes its output) crosses to the host,
in phase C the levels' counts at once. Every keep and leaf
decision takes the host builder's float32 operations on the same dyadic
inputs, and the scenes on the card give the host scenes' bits
(``csrc/scene.cuh``), so the structure equals ``build_svo``'s bit for bit;
normals too where the scene's bits agree, and the albedo within a few ULP
(sinf).

Buffers have exact sizes: the reference's power-of-two buckets (``_bucket``)
serve XLA's compile cache, and with exact sizes its ``_compact_merged``
has no padding to drop: the chunks' parts are concatenated. The device is
the card unless the caller passes ``device="cpu"``, where every function
takes its plain version.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops import octree_cuda
from raytracingtest_tpu_torch.ops.morton import morton_decode
from raytracingtest_tpu_torch.ops.octree import SVO, compute_parent_ptr

_SQRT3 = float(np.sqrt(3.0))
_I32 = torch.int32

# Parents a chunk of the expansion: bounds the eightfold children's working
# set (8 * CHUNK_PARENTS child records, 2^25 at most, so int32 indices hold)
CHUNK_PARENTS = 1 << 22


def keep_bounds(lipschitz: float, level: int, depth: int):
    """(upper, lower) bounds of a level's keep test, ``lower <= f <=
    upper``, as float32 values: the host builder compares a float32 f with
    the float64 ``L*r + 1e-6`` and ``-(L*(r + 2*finest)) - 1e-6``, which numpy
    rounds to float32 first."""
    half = 2.0 ** (-(level + 1))
    finest = 2.0 ** (-depth)
    r = _SQRT3 * half
    return (float(np.float32(lipschitz * r + 1e-6)),
            float(np.float32(-(lipschitz * (r + 2.0 * finest)) - 1e-6)))


def _offsets(counts):
    """(exclusive scan of the blocks' counts, their total): the one scalar a
    compaction brings to the host."""
    inclusive = torch.cumsum(counts, 0, dtype=_I32)
    total = int(inclusive[-1]) if inclusive.numel() else 0
    return inclusive - counts, total


def _expand_level(ds, records, level, depth, lipschitz, keep_full=False,
                  root_level=0, root_coord=(0, 0, 0)):
    """Expand and prune one level: (records (n, 4) of the kept children, their
    codes, parent index * 8 + child slot: each kept child's index among the
    level's children), parent-major; `keep_full` adds the
    records of every child, kept or not (8 a parent), which the leaf test
    reads. A heightfield's h is evaluated once a column of the level first,
    over the square of columns the build rooted at `root_coord` of
    `root_level` reaches (``octree_cuda.columns``)."""
    hi, lo = keep_bounds(lipschitz, level, depth)
    n_p = records.shape[0]
    if 8 * n_p >= 2 ** 31:
        raise ValueError(f"level {level}: {n_p} parents, the codes are int32")
    cols = (octree_cuda.columns(ds, level, root_level, root_coord, records.device)
            if n_p else None)
    parts, full = [], []
    for c0 in range(0, max(n_p, 1), CHUNK_PARENTS):
        rec, keep, counts = octree_cuda.expand(
            ds, records[c0:c0 + CHUNK_PARENTS], level, hi, lo, cols)
        base, n = _offsets(counts)
        rows, words = octree_cuda.compact(keep, base, n, rec)
        if keep_full:
            full.append(rec)
        del rec, keep
        parts.append((words, rows + 8 * c0 if c0 else rows))
    out = parts[0] if len(parts) == 1 else tuple(torch.cat(col) for col in zip(*parts))
    if keep_full:
        return (*out, full[0] if len(full) == 1 else torch.cat(full))
    return out


def build_svo_device(scene, depth: int, verbose: bool = False,
                     root_level: int = 0, root_coord=(0, 0, 0),
                     device=None) -> SVO:
    """Build a packed SVO of `scene` on `device` (None: the card); its
    tensors stay there. The structure equals ``octree.build_svo(scene,
    depth)``'s bit for bit.

    `root_level`/`root_coord` build the subtree rooted at that world octant
    (integer coordinates at `root_level`) down to world level `depth`; its
    dyadic corner keeps every sample position the monolithic build's, so
    octant builds merge into the monolithic structure
    (``build_svo_device_split``). The result has depth ``depth -
    root_level``; leaf attributes are evaluated at world coordinates.
    `verbose` prints each level's candidates and seconds.
    """
    sub_depth = depth - root_level
    if sub_depth < 1:
        raise ValueError("depth must be >= root_level + 1")
    device = resolve(device)
    ds = octree_cuda.device_scene(scene, device)
    lipschitz = float(scene.lipschitz)

    # ---- phase A: the downward sweep; list index k is the sub level ------
    records = torch.tensor([[*root_coord, 0]], dtype=_I32).to(device)
    # codes[k]: level k's candidates' parent index * 8 + child slot
    codes = [torch.zeros(1, dtype=_I32, device=device)]
    for k in range(1, sub_depth + 1):
        t0 = time.perf_counter()
        parents = records
        records, code, *full = _expand_level(
            ds, records, root_level + k, depth, lipschitz,
            keep_full=k == sub_depth, root_level=root_level,
            root_coord=root_coord)
        codes.append(code)
        if verbose:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"# build level {root_level + k}: {code.shape[0]} candidates "
                  f"({time.perf_counter() - t0:.4f}s)", flush=True)

    # ---- phase B: the leaf test over the last expansion's values, then the
    # leaves' attributes in a dense pass over the leaves --------------------
    survive, counts = octree_cuda.leaves(ds, records, depth, codes[-1] >> 3,
                                         parents, full[0])
    base, n_leaves = _offsets(counts)
    below, leaf_rec = octree_cuda.compact(survive, base, n_leaves, records)
    leaf_attrs = octree_cuda.leaf_attrs(ds, leaf_rec, depth)
    del records, parents, full, survive, leaf_rec

    # ---- phases C and D: one pass a level, bottom up ---------------------
    # the pass at level k reads level k + 1's survivors in order (`below`,
    # its first n_rows valid) and writes level k's surviving parents' valid
    # masks and first children (the rank of the first surviving child at
    # level k + 1), the next pass's rows and each level k + 1 survivor's
    # parent rank (ranks[k + 1], where level k + 1 holds node rows). Each
    # grid is sized from a bound the host holds: n_leaves at the last level,
    # then the smaller of that and the level's candidates; the counts cross
    # to the host once, after the last level. A leaf below makes every level
    # hold a node, the root among them.
    if n_leaves == 0:  # an empty world: the root alone, with no child
        masks, child_base, leaf_base, parent_ptr = torch.zeros(
            (4, 1), dtype=_I32, device=device).unbind()
        level_start = np.ones(sub_depth + 1, np.int64)
        level_start[0] = 0
    else:
        valid, first = [None] * sub_depth, [None] * sub_depth
        ranks = [None] * (sub_depth + 1)
        counts = torch.empty(sub_depth, dtype=_I32, device=device)
        status = octree_cuda.level_pass_status(n_leaves, device)
        n_rows = None
        for k in range(sub_depth - 1, -1, -1):
            valid[k], first[k], below, ranks[k + 1], _ = octree_cuda.level_up(
                below, codes[k + 1], codes[k].shape[0], n_rows,
                ranks=k + 1 < sub_depth, status=status, count=counts[k:k + 1])
            n_rows = counts[k:k + 1]
        level_counts = counts.tolist()
        level_start = np.zeros(sub_depth + 1, np.int64)
        np.cumsum(level_counts, out=level_start[1:])
        masks, child_base, leaf_base, parent_ptr = _assemble(
            valid, first, ranks, level_counts, [int(v) for v in level_start])
    del codes, below

    return SVO(
        masks=masks, child_base=child_base, leaf_base=leaf_base,
        leaf_albedo=leaf_attrs[:, :3].contiguous(),
        leaf_normal=leaf_attrs[:, 3:].contiguous(),
        leaf_density=torch.ones(n_leaves, dtype=torch.float32, device=device),
        depth=sub_depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=parent_ptr,
    )


def _assemble(valid, first, ranks, counts, level_start):
    """The packed arrays from the level passes' outputs: masks (valid << 8,
    and | valid at the last level, where every child is a leaf),
    child_base (the first child's rank plus its level's start), leaf_base
    (the first leaf's rank at the last level) and parent_ptr (the root's 0,
    then each level's parent ranks plus its parents' level's start). Every
    level has a node and every node a child: no first child is BIG."""
    last = len(valid) - 1
    masks = torch.cat([v[:c] for v, c in zip(valid, counts)])
    masks <<= 8
    tail = slice(level_start[last], level_start[last + 1])
    masks[tail] |= valid[last][:counts[last]]
    child_base = torch.empty_like(masks)
    leaf_base = torch.zeros_like(masks)
    parent_ptr = torch.empty_like(masks)
    parent_ptr[0] = 0
    for k in range(last):
        here = slice(level_start[k], level_start[k + 1])
        below = slice(level_start[k + 1], level_start[k + 2])
        torch.add(first[k][:counts[k]], level_start[k + 1], out=child_base[here])
        torch.add(ranks[k + 1][:counts[k + 1]], level_start[k], out=parent_ptr[below])
    child_base[tail] = 0
    leaf_base[tail] = first[last][:counts[last]]
    return masks, child_base, leaf_base, parent_ptr


def derive_parent_ptr_device(masks, child_base):
    """Each node row's parent row, on the tensors' device: ``svo_parent_ptr``
    on the card (phase D's first form; the build takes its parent pointers
    from the level passes), ``octree.compute_parent_ptr`` on the CPU."""
    return octree_cuda.parent_ptr(masks, child_base)


def build_svo_device_split(scene, depth: int, split_level: int = 2,
                           verbose: bool = False, device=None) -> SVO:
    """``build_svo_device`` octant by octant: the world is split into
    8^split_level octants, each built with ``build_svo_device(root_level=,
    root_coord=)``, and the octants are merged on the host in numpy with
    their pointers rebased. The result equals ``build_svo_device(scene,
    depth)`` bit for bit (dyadic octant corners keep every sample position);
    its tensors lie on `device`."""
    if split_level < 1 or depth <= split_level:
        raise ValueError("need 1 <= split_level < depth")
    device = resolve(device)
    n_oct = 8 ** split_level
    sub_depth = depth - split_level

    cx, cy, cz = morton_decode(np.arange(n_oct, dtype=np.uint32))
    subs = {}
    for o in range(n_oct):  # Morton order
        sub = build_svo_device(scene, depth, verbose=verbose,
                               root_level=split_level,
                               root_coord=(int(cx[o]), int(cy[o]), int(cz[o])),
                               device=device)
        if sub.n_leaves > 0:
            subs[o] = {name: getattr(sub, name).cpu().numpy()
                       for name in ("masks", "child_base", "leaf_base",
                                    "leaf_albedo", "leaf_normal")}
            subs[o]["level_start"] = sub.level_start
        if verbose:
            print(f"# octant {o}: {sub.n_nodes} nodes {sub.n_leaves} leaves",
                  flush=True)

    # ---- top levels 0 .. split_level - 1 over the octants' occupancy ---------
    occ = [None] * (split_level + 1)
    occ[split_level] = np.zeros(n_oct, bool)
    occ[split_level][list(subs)] = True
    for t in range(split_level - 1, -1, -1):
        occ[t] = occ[t + 1].reshape(-1, 8).any(axis=1)
    counts_top = [int(occ[t].sum()) for t in range(split_level + 1)]
    lvl_counts = counts_top[:split_level] + [
        sum(s["level_start"][k + 1] - s["level_start"][k] for s in subs.values())
        for k in range(sub_depth)]
    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(lvl_counts, out=level_start[1:])

    top_masks, top_child = [], []
    for t in range(split_level):
        cells = np.flatnonzero(occ[t])
        child_occ = occ[t + 1].reshape(-1, 8)
        vm = np.packbits(child_occ[cells], axis=1, bitorder="little")[:, 0]
        # children are packed parent-major at the next level: a prefix count
        # over the occupied cells gives each cell's first child
        child_prefix = np.concatenate(
            [[0], np.cumsum(child_occ.sum(axis=1))])[cells]
        top_masks.append(vm.astype(np.int32) << 8)
        top_child.append((level_start[t + 1] + child_prefix).astype(np.int32))
    n_top = sum(counts_top[:split_level])
    if not subs:  # empty world: the root alone
        top_masks = [np.zeros(1, np.int32)]
        top_child = [np.zeros(1, np.int32)]
        n_top = 1
        level_start[:] = 0
        level_start[1:] = 1

    # ---- the octants' levels, pointers rebased ---------------------------------
    order = sorted(subs)
    leaf_prefix, lvl_prefix = {}, {k: {} for k in range(sub_depth)}
    acc_leaf, acc_lvl = 0, [0] * sub_depth
    for o in order:
        s = subs[o]
        leaf_prefix[o] = acc_leaf
        acc_leaf += s["leaf_albedo"].shape[0]
        for k in range(sub_depth):
            lvl_prefix[k][o] = acc_lvl[k]
            acc_lvl[k] += s["level_start"][k + 1] - s["level_start"][k]

    masks_parts, child_parts = list(top_masks), list(top_child)
    leaf_parts = [np.zeros(n_top, np.int32)]
    for k in range(sub_depth):
        for o in order:
            s = subs[o]
            lo, hi = s["level_start"][k], s["level_start"][k + 1]
            m, cb, lb = (s[name][lo:hi] for name in
                         ("masks", "child_base", "leaf_base"))
            has_child = ((m >> 8) & ~m & 0xFF) != 0
            if k < sub_depth - 1:
                cb = np.where(has_child, cb - s["level_start"][k + 1]
                              + level_start[split_level + k + 1]
                              + lvl_prefix[k + 1][o], 0).astype(np.int32)
            else:
                cb = np.zeros_like(cb)
            lb = np.where((m & 0xFF) != 0, lb + leaf_prefix[o],
                          0).astype(np.int32)
            masks_parts.append(m)
            child_parts.append(cb)
            leaf_parts.append(lb)
    masks = np.concatenate(masks_parts).astype(np.int32)
    child_base = np.concatenate(child_parts).astype(np.int32)
    leaf_base = np.concatenate(leaf_parts).astype(np.int32)
    if subs:
        albedo = np.concatenate([subs[o]["leaf_albedo"] for o in order])
        normal = np.concatenate([subs[o]["leaf_normal"] for o in order])
    else:
        albedo = np.zeros((0, 3), np.float32)
        normal = np.zeros((0, 3), np.float32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return SVO(
        masks=t(masks), child_base=t(child_base), leaf_base=t(leaf_base),
        leaf_albedo=t(albedo), leaf_normal=t(normal),
        leaf_density=torch.ones(acc_leaf, dtype=torch.float32, device=device),
        depth=depth, level_start=tuple(int(v) for v in level_start),
        parent_ptr=t(compute_parent_ptr(masks, child_base)),
    )
