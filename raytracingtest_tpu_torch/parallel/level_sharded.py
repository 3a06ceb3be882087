"""The level-sharded octree: trees too large for one card's memory.

Port of ``raytracingtest_tpu/parallel/level_sharded.py``. The top levels
(0..split_level) are replicated as a trunk whose leaves are the occupied
octants at the split level; each octant's subtree (nodes and leaf
attributes) is a sub-SVO that one rank owns (round-robin) in its arena.
The breadth-first layout keeps each subtree one contiguous row interval a
level, so extraction is slicing and pointer rebasing (``extract_subtree``,
``split_svo``: host numpy, the reference's arrays byte for byte).

The reference's mesh of n devices is a ``torch.distributed`` world of n
ranks here (``parallel/mesh.py``), one arena a rank. Three entry points run
rounds of kernel ``level_round`` (``ops/brick_cuda.level_round_kernel``;
``level_round_plain`` on CPU tensors):

  * ``make_sharded_trace`` (K10b): rays replicated, content sharded. A
    round walks the trunk, then, for the rays whose octant this rank owns,
    the arena from the octant's root; an ``all_reduce`` of the "my arena
    hit" flags takes the place of the psum. A ray that crosses an octant
    without a hit moves past its box and walks the trunk again. At most
    ``3 * 2^trunk_depth + 4`` rounds.
  * ``make_sharded_fit_step``: the same rounds, then each rank shades and
    differentiates only the rays its arena hit (``diff.shade_diff``: kernels
    ``shade_fwd``, ``shade_bwd``, ``segment_sum``); gradients never leave
    their rank, the loss is all-reduced.
  * ``make_exchange_trace`` (K10c): rays and content both sharded. Each
    round walks the trunk for the rank's own rays, buckets the pending ones
    by owner (a stable sort, capped per peer), exchanges the packets with
    ``all_to_all_single``, walks the received ones in the arena, and sends
    the replies back the same way. It drains until no rank has a pending
    ray.

The loops read their termination on the host each round (the live rays,
or the all-reduced pending count), as the reference's while-loops test it;
on the card the same read bounds the round's grid: kernel ``level_round``
walks only the live rays and the valid packets, through a queue.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.ops import traverse
from raytracingtest_tpu_torch.ops.brick import _expand_children
from raytracingtest_tpu_torch.ops.octree import SVO
from raytracingtest_tpu_torch.parallel.mesh import RayMesh, all_sum
from raytracingtest_tpu_torch.render import sky_color

_F32, _I32 = torch.float32, torch.int32

# the advance past an octant's box, as the reference's eps
EPS = 1e-5


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_subtree(svo: SVO, level: int, index_in_level: int) -> SVO:
    """The standalone sub-SVO (CPU tensors) rooted at the
    `index_in_level`-th node of `level`: contiguous intervals a level,
    pointers rebased to the subtree."""
    masks = _np(svo.masks)
    child_base = _np(svo.child_base)
    leaf_base = _np(svo.leaf_base)

    # per-level [lo, hi) node intervals of the subtree
    row = svo.level_start[level] + index_in_level
    intervals = [(row, row + 1)]
    for _ in range(level, svo.depth - 1):
        lo, hi = intervals[-1]
        if hi == lo:
            intervals.append((0, 0))
            continue
        nonleaf = ((masks[lo:hi] >> 8) & 0xFF) & ~(masks[lo:hi] & 0xFF)
        nz = np.nonzero(nonleaf)[0]
        if nz.size == 0:
            intervals.append((0, 0))
            continue
        first = child_base[lo + nz[0]]
        last = child_base[lo + nz[-1]] + bin(int(nonleaf[nz[-1]])).count("1")
        intervals.append((int(first), int(last)))

    # the leaf interval, from the leaf bases of the intervals' rows
    leaf_lo = leaf_hi = None
    for lo, hi in intervals:
        if hi == lo:
            continue
        lm = masks[lo:hi] & 0xFF
        nz = np.nonzero(lm)[0]
        if nz.size == 0:
            continue
        first = int(leaf_base[lo + nz[0]])
        last = int(leaf_base[lo + nz[-1]]) + bin(int(lm[nz[-1]])).count("1")
        leaf_lo = first if leaf_lo is None else min(leaf_lo, first)
        leaf_hi = last if leaf_hi is None else max(leaf_hi, last)
    if leaf_lo is None:
        leaf_lo = leaf_hi = 0

    new_level_start = [0]
    starts = []
    offset = 0
    for lo, hi in intervals:
        starts.append(offset)
        offset += hi - lo
        new_level_start.append(offset)
    out_masks, out_child, out_leaf = [], [], []
    for li, (lo, hi) in enumerate(intervals):
        m = masks[lo:hi]
        out_masks.append(m)
        if li + 1 < len(intervals):
            nlo = intervals[li + 1][0]
            out_child.append(np.where((m >> 8) & ~m & 0xFF,
                                      child_base[lo:hi] - nlo + starts[li + 1],
                                      0).astype(np.int32))
        else:
            out_child.append(np.zeros(hi - lo, np.int32))
        out_leaf.append(np.where(m & 0xFF, leaf_base[lo:hi] - leaf_lo,
                                 0).astype(np.int32))

    t = torch.from_numpy
    return SVO(
        masks=t(np.concatenate(out_masks)), child_base=t(np.concatenate(out_child)),
        leaf_base=t(np.concatenate(out_leaf)),
        leaf_albedo=t(_np(svo.leaf_albedo)[leaf_lo:leaf_hi].copy()),
        leaf_normal=t(_np(svo.leaf_normal)[leaf_lo:leaf_hi].copy()),
        leaf_density=t(_np(svo.leaf_density)[leaf_lo:leaf_hi].copy()),
        depth=svo.depth - level, level_start=tuple(new_level_start))


@dataclasses.dataclass
class LevelShardedSVO:
    """The replicated trunk and each rank's arena (host numpy; a rank's
    tensors come from ``rank_tables``)."""

    trunk_masks: np.ndarray
    trunk_child: np.ndarray
    trunk_leaf: np.ndarray
    trunk_depth: int
    trunk_level_start: tuple
    # per octant (= trunk leaf id)
    octant_owner: np.ndarray     # i32 [n_oct] rank
    octant_root: np.ndarray      # i32 [n_oct] root row in the owner's arena
    octant_leaf_off: np.ndarray  # i32 [n_oct] leaf offset in the owner's arena
    octant_origin: np.ndarray    # f32 [n_oct, 3] octree-space low corner
    octant_size: float
    sub_depth: int
    # the ranks' arenas, stacked and padded to one size
    arena_masks: np.ndarray      # i32 [n_dev, cap_nodes]
    arena_child: np.ndarray
    arena_leaf: np.ndarray
    arena_albedo: np.ndarray     # f32 [n_dev, cap_leaves, 3]
    arena_normal: np.ndarray
    arena_density: np.ndarray
    # each octant's interval of the global leaf rows
    octant_leaf_lo: np.ndarray = None   # i32 [n_oct]
    octant_n_leaves: np.ndarray = None  # i32 [n_oct]

    @property
    def n_devices(self):
        return self.arena_masks.shape[0]


def _octant_coords(svo: SVO, split_level: int) -> np.ndarray:
    """The split level's octant coordinates, expanded from the root (a tree
    built on the card carries no build coordinates)."""
    m, cb = _np(svo.masks), _np(svo.child_base)
    rows = np.zeros(1, np.int64)
    coords = np.zeros((1, 3), np.int64)
    for _ in range(split_level):
        rows, pidx, slots = _expand_children(m, cb, rows)
        coords = coords[pidx] * 2 + np.stack(
            [slots & 1, (slots >> 1) & 1, (slots >> 2) & 1], axis=1)
    return coords.astype(np.int32)


def split_svo(result_or_svo, split_level: int, n_devices: int,
              node_coords_level=None) -> LevelShardedSVO:
    """Split a built SVO (or a ``BuildResult``) at `split_level` into the
    replicated trunk and `n_devices` arenas. The octant origins come from
    `node_coords_level`, else the BuildResult's node_coords, else are
    derived from the tree."""
    svo = getattr(result_or_svo, "svo", result_or_svo)
    if node_coords_level is None:
        nc = getattr(result_or_svo, "node_coords", None)
        node_coords_level = (nc[split_level] if nc is not None
                             else _octant_coords(svo, split_level))

    masks = _np(svo.masks)
    lo, hi = svo.level_start[split_level], svo.level_start[split_level + 1]
    n_oct = hi - lo

    # the trunk: levels 0..split_level-1, the split level's nodes as leaves
    t_masks = masks[:hi].copy()
    t_child = _np(svo.child_base)[:hi].copy()
    t_leaf = np.zeros_like(t_child)
    plo, phi = svo.level_start[split_level - 1], svo.level_start[split_level]
    vm = (t_masks[plo:phi] >> 8) & 0xFF
    t_masks[plo:phi] = (vm << 8) | vm
    # a parent's leaf base: its first child's rank among the split level
    t_leaf[plo:phi] = np.where(vm != 0, t_child[plo:phi] - lo, 0)
    t_child[plo:phi] = 0

    subs: List[SVO] = [extract_subtree(svo, split_level, i) for i in range(n_oct)]
    owner = np.arange(n_oct, dtype=np.int32) % n_devices
    roots = np.zeros(n_oct, np.int32)
    leaf_offs = np.zeros(n_oct, np.int32)
    per_dev = [dict(masks=[], child=[], leaf=[], albedo=[], normal=[],
                    density=[], n_nodes=0, n_leaves=0) for _ in range(n_devices)]
    for i, sub in enumerate(subs):
        dv = per_dev[owner[i]]
        roots[i] = dv["n_nodes"]
        leaf_offs[i] = dv["n_leaves"]
        m = sub.masks.numpy()
        dv["masks"].append(m)
        dv["child"].append(np.where((m >> 8) & ~m & 0xFF,
                                    sub.child_base.numpy() + dv["n_nodes"], 0))
        dv["leaf"].append(np.where(m & 0xFF, sub.leaf_base.numpy() + dv["n_leaves"], 0))
        dv["albedo"].append(sub.leaf_albedo.numpy())
        dv["normal"].append(sub.leaf_normal.numpy())
        dv["density"].append(sub.leaf_density.numpy())
        dv["n_nodes"] += sub.n_nodes
        dv["n_leaves"] += sub.n_leaves

    cap_nodes = max(max(d["n_nodes"] for d in per_dev), 1)
    cap_leaves = max(max(d["n_leaves"] for d in per_dev), 1)
    am = np.zeros((n_devices, cap_nodes), np.int32)
    ac = np.zeros((n_devices, cap_nodes), np.int32)
    al = np.zeros((n_devices, cap_nodes), np.int32)
    aa = np.zeros((n_devices, cap_leaves, 3), np.float32)
    an = np.zeros((n_devices, cap_leaves, 3), np.float32)
    ad = np.zeros((n_devices, cap_leaves), np.float32)
    for dev, dv in enumerate(per_dev):
        if dv["n_nodes"]:
            am[dev, :dv["n_nodes"]] = np.concatenate(dv["masks"])
            ac[dev, :dv["n_nodes"]] = np.concatenate(dv["child"])
            al[dev, :dv["n_nodes"]] = np.concatenate(dv["leaf"])
        if dv["n_leaves"]:
            aa[dev, :dv["n_leaves"]] = np.concatenate(dv["albedo"])
            an[dev, :dv["n_leaves"]] = np.concatenate(dv["normal"])
            ad[dev, :dv["n_leaves"]] = np.concatenate(dv["density"])

    size = 2.0 ** (-split_level)
    # octants and leaves are both Morton-ordered: the octants' leaf ranges
    # tile the global leaf rows in octant order
    n_leaves_per = np.array([s.n_leaves for s in subs], np.int64)
    leaf_lo = np.concatenate([[0], np.cumsum(n_leaves_per)[:-1]]).astype(np.int32)
    return LevelShardedSVO(
        trunk_masks=t_masks[:phi], trunk_child=t_child[:phi],
        trunk_leaf=t_leaf[:phi], trunk_depth=split_level,
        trunk_level_start=tuple(svo.level_start[: split_level + 1]),
        octant_owner=owner, octant_root=roots, octant_leaf_off=leaf_offs,
        octant_origin=np.asarray(node_coords_level).astype(np.float32) * size,
        octant_size=size, sub_depth=svo.depth - split_level,
        arena_masks=am, arena_child=ac, arena_leaf=al,
        arena_albedo=aa, arena_normal=an, arena_density=ad,
        octant_leaf_lo=leaf_lo, octant_n_leaves=n_leaves_per.astype(np.int32))


# ---------------------------------------------------------------------------
# a rank's tables and one round (K10b, K10c)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankTables:
    """One rank's tensors of a ``LevelShardedSVO`` on its device: the trunk
    and its arena as SVOs with parent pointers (derived over the truncated
    and the padded arrays, as the reference derives them), the octant
    tables, the octants' size and the rank."""

    trunk: SVO
    arena: SVO
    owner: torch.Tensor
    root: torch.Tensor
    origin: torch.Tensor
    size: float
    rank: int


def rank_tables(ls: LevelShardedSVO, mesh: RayMesh) -> RankTables:
    """Rank `mesh.rank`'s tables of `ls` on `mesh.device`."""
    if ls.n_devices != mesh.world:
        raise ValueError(f"{ls.n_devices} arenas for a world of {mesh.world}")
    dev, r = mesh.device, mesh.rank
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def tree(masks, child, leaf, depth, alb, nrm, den):
        masks, child = put(masks), put(child)
        return SVO(masks=masks, child_base=child, leaf_base=put(leaf),
                   leaf_albedo=put(alb), leaf_normal=put(nrm),
                   leaf_density=put(den), depth=depth,
                   level_start=(0,) * (depth + 1),
                   parent_ptr=traverse.derive_parent_ptr(masks, child))

    n_oct = ls.octant_owner.shape[0]
    trunk = tree(ls.trunk_masks, ls.trunk_child, ls.trunk_leaf, ls.trunk_depth,
                 np.zeros((n_oct, 3), np.float32), np.zeros((n_oct, 3), np.float32),
                 np.ones(n_oct, np.float32))
    arena = tree(ls.arena_masks[r], ls.arena_child[r], ls.arena_leaf[r],
                 ls.sub_depth, ls.arena_albedo[r], ls.arena_normal[r],
                 ls.arena_density[r])
    return RankTables(trunk=trunk, arena=arena, owner=put(ls.octant_owner),
                      root=put(ls.octant_root),
                      origin=put(ls.octant_origin.astype(np.float32)),
                      size=float(ls.octant_size), rank=r)


def _aabb_exit(o, d, box_org, size):
    """t of leaving the boxes [org, org + size] from origins possibly inside
    them, at least 0."""
    safe_d = torch.where(d.abs() < 1e-12, 1e-12, d)
    t0 = (box_org - o) / safe_d
    t1 = (box_org + size - o) / safe_d
    return torch.clamp_min(torch.amin(torch.maximum(t0, t1), dim=1), 0.0)


def _octant_walk(tb: RankTables, oct_id, o_cur, d, counts=None):
    """The arena walk from each ray's octant root at (o_cur - org) / size:
    (leaf, or -1; t * size of a hit, else 0)."""
    size = torch.tensor(tb.size, dtype=_F32, device=d.device)
    org = tb.origin[oct_id]
    res = traverse.trace_stackless(tb.arena, (o_cur - org) / size, d,
                                   root=tb.root[oct_id])
    if counts is not None:
        counts["steps"] += int(res.iters.sum())
    hit = res.hit_leaf >= 0
    return res.hit_leaf, torch.where(hit, res.hit_t * size, 0.0)


def level_round_plain(mode, tb: RankTables, rays, direction=None, t_off=None,
                      done=None, counts=None):
    """The plain version of kernel ``level_round``, in tensor ops on any
    device, with the kernel's outputs (``brick_cuda.level_round_kernel``).
    Only the rays not done walk the trunk, and only those whose octant this
    rank owns walk the arena ("sharded"). `counts` (a dict, optional) gains
    "walks" (walks begun) and "steps" (stackless steps) of this round."""
    tally = counts if counts is not None else {}
    tally.setdefault("walks", 0)
    tally.setdefault("steps", 0)
    dev, n = rays.device, rays.shape[0]
    if mode == "packets":
        bits = rays[:, 6:8].contiguous().view(_I32)
        leaf = torch.full((n,), -1, dtype=_I32, device=dev)
        t = torch.zeros(n, dtype=_F32, device=dev)
        v = torch.nonzero(bits[:, 1] != 0)[:, 0]
        if v.numel():
            lv, tv = _octant_walk(tb, bits[v, 0].long(), rays[v, 0:3], rays[v, 3:6], tally)
            leaf[v], t[v] = lv, tv
            tally["walks"] += v.numel()
        return (torch.stack([leaf.view(_F32), t], dim=1),)

    oct_id = torch.full((n,), -1, dtype=_I32, device=dev)
    t_next = t_off.clone()
    hit = torch.zeros(n, dtype=_I32, device=dev)
    leaf = torch.full((n,), -1, dtype=_I32, device=dev)
    t_hit = torch.zeros(n, dtype=_F32, device=dev)
    act = torch.nonzero(~done)[:, 0]
    if act.numel():
        da, ta = direction[act], t_off[act]
        o_cur = rays[act] + ta[:, None] * da
        r1 = traverse.trace_stackless(tb.trunk, o_cur, da)
        tally["walks"] += act.numel()
        tally["steps"] += int(r1.iters.sum())
        f = torch.nonzero(r1.hit_leaf >= 0)[:, 0]
        cid = r1.hit_leaf[f].long()
        sel = act[f]
        oct_id[sel] = cid.to(_I32)
        t_next[sel] = ta[f] + _aabb_exit(o_cur[f], da[f], tb.origin[cid],
                                         tb.size) + EPS
        if mode == "sharded":
            m = torch.nonzero(tb.owner[cid] == tb.rank)[:, 0]
            if m.numel():
                lm, tm = _octant_walk(tb, cid[m], o_cur[f][m], da[f][m], tally)
                tally["walks"] += m.numel()
                got = lm >= 0
                sm = sel[m]
                leaf[sm] = lm
                hit[sm] = got.to(_I32)
                t_hit[sm] = torch.where(got, ta[f][m] + tm, 0.0)
    if mode == "trunk":
        return oct_id, t_next
    return oct_id, hit, leaf, t_hit, t_next


def level_queue_plain(mode, rays, done=None, seg=None, prev=None):
    """A plain model of the queue of kernel ``level_round``'s queued form:
    the live rays ("sharded", "trunk": not `done`; of the last round's
    queue `prev` where given, in its order) or valid packets ("packets") in
    the order of the kernel's threads, int64. The valid packets must be a
    prefix of each segment of `seg` slots (all by default), as the
    exchange's bucket lays them out (``ValueError`` otherwise): the kernel
    counts them by a search that assumes it."""
    if mode != "packets":
        if prev is not None:
            prev = prev.long()
            return prev[~done[prev]]
        return torch.nonzero(~done)[:, 0]
    n = rays.shape[0]
    seg = n if seg is None else seg
    valid = rays[:, 7:8].contiguous().view(_I32)[:, 0] != 0
    if n:
        v = valid.view(-1, seg)
        prefix = (torch.arange(seg, device=rays.device)[None, :]
                  < v.sum(1, keepdim=True))
        if not torch.equal(prefix, v):
            raise ValueError("the valid packets are not a prefix of each "
                             f"segment of {seg} slots")
    return torch.nonzero(valid)[:, 0]


class LevelQueuePlain:
    """The state ``level_round_queued_plain`` keeps across a loop's rounds,
    as ``brick_cuda.LevelQueue`` does on the card: the outputs, and the
    last round's live rays (None after a first round: every ray)."""

    def __init__(self):
        self.out = None
        self.prev = None


def level_round_queued_plain(mode, tb: RankTables, rays, direction=None, t_off=None,
                             done=None, counts=None, live=None, built=None, seg=None,
                             queue=None):
    """A plain model of kernel ``level_round``'s queued form, with
    ``level_round``'s arguments: the queue (``level_queue_plain``, over the
    last round's live rays when a loop's `queue` state is given),
    ``level_round_plain`` over the queued rays or packets alone, their
    outputs at their own index, and the first form's outputs of a done ray
    or an invalid packet where the round found them (with `queue`, the
    outputs are kept from round to round, as the card keeps them). `live`,
    the grid's bound, must cover the queue; `built` is the card's and not
    needed; a new `queue`'s first round (no queue: every ray) must have no
    ray done."""
    for key in ("walks", "steps"):
        if counts is not None:
            counts.setdefault(key, 0)
    dev, n = rays.device, rays.shape[0]
    if mode == "packets":
        q = level_queue_plain(mode, rays, seg=seg)
        if live is not None and q.numel() > live:
            raise ValueError(f"{q.numel()} valid packets past the bound {live}")
        replies = torch.zeros((n, 2), dtype=_F32, device=dev)
        replies[:, 0] = torch.full((n,), -1, dtype=_I32, device=dev).view(_F32)
        if q.numel():
            (sub,) = level_round_plain(mode, tb, rays[q], counts=counts)
            replies[q] = sub
        return (replies,)
    keep = queue is not None
    if keep and queue.out is None and bool(done.any()):
        raise ValueError("a loop's first round with rays done")
    entries = (torch.arange(n, device=dev) if not keep or queue.prev is None
               else queue.prev)
    q = entries[~done[entries]]
    if live is not None and q.numel() > live:
        raise ValueError(f"{q.numel()} live rays past the bound {live}")
    out = queue.out if keep and queue.out is not None else [
        torch.empty(n, dtype=dt, device=dev)
        for dt in ((_I32, _I32, _I32, _F32, _F32) if mode == "sharded" else (_I32, _F32))]
    # the rays this round found done: the first form's outputs
    gone = entries[done[entries]]
    out[0][gone] = -1
    out[-1][gone] = t_off[gone]
    if mode == "sharded":
        out[1][gone], out[2][gone], out[3][gone] = 0, -1, 0.0
    if q.numel():
        sub = level_round_plain(mode, tb, rays[q], direction[q], t_off[q],
                                torch.zeros(q.numel(), dtype=torch.bool, device=dev),
                                counts=counts)
        for t, v in zip(out, sub):
            t[q] = v
    if keep:
        queue.out, queue.prev = out, q
    return tuple(out)


def level_round(mode, tb: RankTables, rays, direction=None, t_off=None,
                done=None, counts=None, live=None, built=None, seg=None, queue=None):
    """One round of `mode`: kernel ``level_round`` on CUDA tensors (its
    queued form: `live` bounds the live rays or valid packets, `built` is
    the round's ``brick_cuda.level_queue_build`` if made, `seg` the packets'
    segment, `queue` the loop's ``brick_cuda.LevelQueue``),
    ``level_round_plain`` on CPU tensors (`counts` is read only there)."""
    if rays.device.type == "cpu":
        return level_round_plain(mode, tb, rays, direction, t_off, done, counts)
    from raytracingtest_tpu_torch.ops import brick_cuda

    return brick_cuda.level_round_kernel(mode, tb.trunk, tb.arena, tb.owner,
                                         tb.root, tb.origin, tb.size, tb.rank,
                                         rays, direction, t_off, done, live=live,
                                         built=built, seg=seg, queue=queue)


def _queue_state(device):
    """A loop's queue state for its rounds: ``brick_cuda.LevelQueue`` on the
    card, ``LevelQueuePlain`` (the queued form's model keeps it) on the
    CPU."""
    if torch.device(device).type == "cpu":
        return LevelQueuePlain()
    from raytracingtest_tpu_torch.ops import brick_cuda

    return brick_cuda.LevelQueue()


def _live(done, t_off, queue):
    """(the rays not done, read on the host: the round's one read; on the
    card also the round's queue that gave it, made in one pass over the last
    round's live rays, else None)."""
    if done.device.type == "cpu":
        return int((~done).sum()), None
    from raytracingtest_tpu_torch.ops import brick_cuda

    built = brick_cuda.level_queue_build("sharded", done, t_off, queue)
    return brick_cuda.live_count(built), built


def rounds_bound(trunk_depth: int, max_octants=None) -> int:
    """The provable bound on the occupied octants a segment crosses (3 *
    2^trunk_depth grid crossings and entry and exit slack), or
    `max_octants`."""
    return 3 * (1 << trunk_depth) + 4 if max_octants is None else max_octants


def _phase_loop(mesh: RayMesh, tb: RankTables, o, d, n_max, stats):
    """The rounds of K10b over replicated rays: (leaf in this rank's arena,
    t, owner, truncated), each ray's record on its owner only. `stats`
    gains "rounds"."""
    dev, n = o.device, o.shape[0]
    o, d = o.to(_F32).contiguous(), d.to(_F32).contiguous()
    t_off = torch.zeros(n, dtype=_F32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    out_leaf = torch.full((n,), -1, dtype=_I32, device=dev)
    out_t = torch.zeros(n, dtype=_F32, device=dev)
    out_owner = torch.full((n,), -1, dtype=_I32, device=dev)
    queue = _queue_state(dev)
    rounds = 0
    for _ in range(n_max):
        # the first round has every ray live, and needs no count
        n_live, built = (n, None) if rounds == 0 else _live(done, t_off, queue)
        if n_live == 0:
            break
        rounds += 1
        oct_id, hit, leaf, t_hit, t_next = level_round(
            "sharded", tb, o, d, t_off, done, counts=stats, live=n_live, built=built,
            queue=queue)
        found = oct_id >= 0
        # did any rank's arena stop the ray this round?
        hit_any = all_sum(mesh, hit.clone()) > 0
        new = (hit > 0) & ~done
        out_owner = torch.where(new, tb.rank, out_owner)
        out_leaf = torch.where(new, leaf, out_leaf)
        out_t = torch.where(new, t_hit, out_t)
        done = done | (hit_any & found) | ~found
        # an octant crossed without a hit: past its box
        t_off = torch.where(found & ~hit_any, t_next, t_off)
    stats["rounds"] = stats.get("rounds", 0) + rounds
    return out_leaf, out_t, out_owner, ~done


def make_sharded_trace(mesh: RayMesh, ls: LevelShardedSVO, max_octants=None):
    """The level-sharded trace over `mesh`: rays replicated (every rank
    passes the same (N, 3) rays), arenas sharded. Returns trace(o, d) ->
    (leaf, t, owner, truncated) on every rank, all-reduced: `leaf` indexes
    the owner rank's arena leaf rows (-1 on a miss). ``trace.stats`` holds
    the last call's "rounds" (and, on CPU tensors, "walks" and "steps")."""
    tb = rank_tables(ls, mesh)
    n_max = rounds_bound(ls.trunk_depth, max_octants)

    def trace(o, d):
        trace.stats = {}
        out_leaf, out_t, out_owner, truncated = _phase_loop(
            mesh, tb, o, d, n_max, trace.stats)
        # each ray's record lives on its owner: sums with the others masked
        has = out_owner == tb.rank
        any_owner = all_sum(mesh, has.to(_I32)) > 0
        leaf_sum = all_sum(mesh, torch.where(has, out_leaf, 0))
        out_leaf = torch.where(any_owner, leaf_sum, -1)
        out_t = all_sum(mesh, torch.where(has, out_t, 0.0))
        dist.all_reduce(out_owner, op=dist.ReduceOp.MAX, group=mesh.group)
        truncated = all_sum(mesh, truncated.to(_I32)) > 0
        return out_leaf, out_t, out_owner, truncated

    trace.stats = {}
    trace.tables = tb
    return trace


def make_sharded_fit_step(mesh: RayMesh, ls: LevelShardedSVO, max_octants=None,
                          light_intensity: float = 1.3,
                          light_ambient: float = 0.08):
    """The level-sharded training step: each rank's voxel parameters are
    its arena's. Returns step(albedo, normal, density, o, d, light_dir,
    target) -> (loss, (g_albedo, g_normal, g_density)): the parameters
    (cap_leaves, 3), (cap_leaves, 3), (cap_leaves,) of this rank, replicated
    rays (N, 3) and target (N, 3). The loss is the one-tree L2 loss of
    ``diff.loss_and_grads``, on every rank; the gradients are this rank's
    and never cross it."""
    tb = rank_tables(ls, mesh)
    n_max = rounds_bound(ls.trunk_depth, max_octants)

    def step(albedo, normal, density, o, d, light_dir, target):
        step.stats = {}
        with torch.no_grad():
            out_leaf, _t, out_owner, _trunc = _phase_loop(mesh, tb, o, d, n_max,
                                                          step.stats)
        mine = out_owner == tb.rank
        any_hit = all_sum(mesh, mine.to(_I32)) > 0
        d = d.to(_F32).contiguous()
        sky = sky_color(d)
        n_rays = o.shape[0]
        # only this rank's rays carry a cotangent; the others shade as misses
        hit_leaf = torch.where(mine, out_leaf, -1).contiguous()

        def local_part(a, nr, s):
            img = diff.shade_diff(hit_leaf, d, a, nr, s, light_dir,
                                  light_intensity, light_ambient)
            err = torch.sum((img - target) ** 2, dim=1)
            return torch.sum(torch.where(mine, err, 0.0)) / (3.0 * n_rays)

        part, grads = diff._value_and_grads(local_part, albedo, normal, density)
        # a ray no rank hit is counted once, here, on every rank
        sky_err = torch.sum(torch.where(~any_hit[:, None], (sky - target) ** 2, 0.0))
        loss = all_sum(mesh, part.clone()) + sky_err / (3.0 * n_rays)
        return loss, grads

    step.stats = {}
    step.tables = tb
    return step


def _bucket(key, n_dev, cap):
    """The reference's bucket of rays by owner: a stable sort of `key`
    (the owner, n_dev for no packet), each ray's rank in its group, and
    the first `cap` of each owner's group placed at slot owner * cap + rank.
    Returns (idx_send (n_dev * cap,) ray ids, -1 in an empty slot; sent
    (N,) bool). A group starts at its key's first place in the sorted keys
    (the reference takes a running maximum of the group starts, which CUDA's
    scan runs about a hundred times slower than the sort)."""
    n = key.shape[0]
    dev = key.device
    sk, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sk, torch.arange(n_dev + 1, dtype=sk.dtype, device=dev))
    rank = torch.arange(n, device=dev) - starts[sk.long()]
    ok = (sk < n_dev) & (rank < cap)
    idx_send = torch.full((n_dev * cap,), -1, dtype=torch.int64, device=dev)
    idx_send[(sk * cap + rank)[ok]] = order[ok]
    sent = torch.zeros(n, dtype=torch.bool, device=dev)
    sent[order[ok]] = True
    return idx_send, sent


def make_exchange_trace(mesh: RayMesh, ls: LevelShardedSVO, max_rounds: int = 64,
                        cap_factor: int = 2):
    """The ray-exchange trace: rays sharded (each rank passes its own (n,
    3) shard) and arenas sharded. A round: the trunk walk of this rank's
    pending rays (kernel ``level_round``, "trunk"); a stable bucket by
    owner, at most cap = cap_factor * ceil(n / n_dev) rays a peer (the rest
    retry next round); ``all_to_all_single`` of the (n_dev * cap, 8)
    packets; the arena walk of the received ones ("packets"); the replies
    back by the mirrored ``all_to_all_single``; the hits recorded, and rays
    that crossed an octant without a hit moved past its box. It drains until
    no rank has a pending ray, or `max_rounds`.

    Returns trace(o, d) -> (leaf, t, owner, traced (1,), truncated) for
    this rank's rays: traced counts the packets this rank's arena walked.
    ``trace.stats`` holds the last call's "rounds"."""
    tb = rank_tables(ls, mesh)
    n_dev = mesh.world

    def trace(o, d):
        trace.stats = {}
        dev, n = o.device, o.shape[0]
        o, d = o.to(_F32).contiguous(), d.to(_F32).contiguous()
        cap = cap_factor * ((n + n_dev - 1) // n_dev)
        t_off = torch.zeros(n, dtype=_F32, device=dev)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        out_leaf = torch.full((n,), -1, dtype=_I32, device=dev)
        out_t = torch.zeros(n, dtype=_F32, device=dev)
        out_owner = torch.full((n,), -1, dtype=_I32, device=dev)
        traced = torch.zeros(1, dtype=torch.int64, device=dev)
        queue = _queue_state(dev)
        rounds = 0
        for _ in range(max_rounds):
            pending = int(all_sum(mesh, (~done).sum().reshape(1)))
            if pending == 0:
                break
            rounds += 1
            # no rank has more live rays, nor receives more valid packets,
            # than the world has pending: the bound of both rounds' grids
            oct_id, t_next = level_round("trunk", tb, o, d, t_off, done,
                                         counts=trace.stats, live=pending, queue=queue)
            found = oct_id >= 0
            done = done | ~found
            owner = tb.owner[torch.clamp_min(oct_id, 0).long()]
            key = torch.where(found, owner, n_dev)
            idx_send, sent = _bucket(key, n_dev, cap)

            # the packets: o_cur, d, the octant and the valid flag as bits
            valid = idx_send >= 0
            safe = torch.clamp_min(idx_send, 0)
            o_cur = o + t_off[:, None] * d
            packets = torch.empty((n_dev * cap, 8), dtype=_F32, device=dev)
            packets[:, 0:3] = o_cur[safe]
            packets[:, 3:6] = d[safe]
            words = torch.stack([torch.where(valid, oct_id[safe], 0),
                                 valid.to(_I32)], dim=1)
            packets[:, 6:8] = words.view(_F32)
            recv = torch.empty_like(packets)
            dist.all_to_all_single(recv, packets, group=mesh.group)

            # the owner's walks; slot j of recv came from rank j // cap
            (replies,) = level_round("packets", tb, recv, counts=trace.stats,
                                     live=pending, seg=cap)
            traced += (recv[:, 7:8].contiguous().view(_I32) != 0).sum()
            back = torch.empty_like(replies)
            dist.all_to_all_single(back, replies, group=mesh.group)

            # home: slot order is idx_send's; empty slots drop out
            home = idx_send[valid]
            back_leaf = back[:, 0].contiguous().view(_I32)[valid]
            hit_leaf_r = torch.zeros(n, dtype=_I32, device=dev)
            hit_t_r = torch.zeros(n, dtype=_F32, device=dev)
            got_hit = torch.zeros(n, dtype=torch.bool, device=dev)
            hit_leaf_r[home] = back_leaf
            hit_t_r[home] = back[:, 1][valid]
            got_hit[home] = back_leaf >= 0

            new = sent & got_hit & ~done
            out_leaf = torch.where(new, hit_leaf_r, out_leaf)
            out_t = torch.where(new, t_off + hit_t_r, out_t)
            out_owner = torch.where(new, owner, out_owner)
            done = done | new
            # sent and missed: past the octant's box; an overflowed ray
            # retries next round at the same t
            t_off = torch.where(sent & ~got_hit & ~done, t_next, t_off)
        trace.stats["rounds"] = rounds
        return out_leaf, out_t, out_owner, traced.to(_I32), ~done

    trace.stats = {}
    trace.tables = tb
    return trace
