"""Brick decomposition of an SVO: bottom octree levels as 512-bit bricks.

Port of ``raytracingtest_tpu/ops/brick.py``: the ``BrickSVO`` container,
``make_brick_svo`` (numpy, operation for operation the reference's, so its
arrays come out byte-identical), the bit helpers the tile walker shares, and
the brick trace (``_trace_brick_core``, ``_brick_round``, ``_top_step``)
as ``trace_brick``, the plain
version of the ``brick_trace`` kernel (``ops/brick_cuda.py``), its
k-segment form (``_trace_brick_multi_core``) as ``trace_brick_multi``, the
plain version of ``brick_trace_multi``, and its LOD form
(``trace_brick_lod_jax``) as ``trace_brick_lod``, the plain version of
``brick_trace_lod``. The deepest BRICK_LEVELS = 3 levels collapse into one
8x8x8 occupancy bitmask per level-(depth-3) node: 16 words in hierarchical
Morton bit order ((slot_l1 << 6) | (slot_l2 << 3) | slot_l3), which is the
leaf attribute order, so a hit's global leaf id is the brick's first leaf
id plus a prefix popcount.

The reference's words are uint32. torch has no uint32 arithmetic, so every
word here is carried as its int32 bit pattern: mask after each right shift,
and count bits with ``_popcount32``, which is right on negative words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops.octree import compute_parent_ptr
from raytracingtest_tpu_torch.ops.traverse import (
    S_MAX, Compacted, MultiTraceResult, TraceResult, _f2i, fast_step,
    lod_constants, max_iters_for_depth, multi_state, multi_steps_for_depth,
    walk_state)

BRICK_LEVELS = 3  # bottom levels folded into 8^3 bit bricks

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class BrickSVO:
    """Brick-decomposed SVO (derived from ops.octree.SVO, same world frame).

    Top tree = original levels 0..top_depth-1 with the level-(top_depth-1)
    nodes' children re-marked as leaves; their child_base column holds the
    first child's brick id instead of a node row. bricks[:, :16] are the
    512 occupancy bits (uint32 words as int32 bit patterns,
    hierarchical-Morton bit order); bricks[:, 16] is the brick's first
    global leaf id.
    """

    top_masks: torch.Tensor    # int32 [n_top]  (valid<<8)|leaf
    top_child: torch.Tensor    # int32 [n_top]  child node row / first brick id at the cut
    top_parent: torch.Tensor   # int32 [n_top]  parent row
    bricks: torch.Tensor       # int32 [n_bricks, 17]
    depth: int
    top_depth: int

    @property
    def n_top(self) -> int:
        return self.top_masks.shape[0]

    @property
    def n_bricks(self) -> int:
        return self.bricks.shape[0]

    def to(self, device=None) -> "BrickSVO":
        """Copy with every tensor on `device` (None: the default device)."""
        device = resolve(device)
        return BrickSVO(
            top_masks=self.top_masks.to(device),
            top_child=self.top_child.to(device),
            top_parent=self.top_parent.to(device),
            bricks=self.bricks.to(device),
            depth=self.depth, top_depth=self.top_depth)


def _expand_children(masks, child_base, rows):
    """Vectorized one-level expansion of non-leaf children (numpy).

    Returns (child_rows, parent_pos, slots) sorted by (parent position in
    `rows`, slot), the canonical contiguous-child order."""
    m = masks[rows]
    nl = ((m >> 8) & 0xFF) & ~(m & 0xFF)
    hit = ((nl[:, None] >> np.arange(8)) & 1).astype(bool)  # (m, 8)
    ranks = np.cumsum(hit, axis=1) - 1
    pidx, slots = np.nonzero(hit)
    crows = child_base[rows][pidx] + ranks[pidx, slots]
    return crows.astype(np.int64), pidx.astype(np.int64), slots.astype(np.int32)


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _words(a):
    """uint32 numpy words as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def make_brick_svo(svo) -> BrickSVO:
    """Host-side brick decomposition of a packed SVO (leaves at the finest
    level only, as ``build_svo`` makes them). Runs in numpy; the result's
    tensors lie on the CPU (move them with ``.to()``)."""
    depth = svo.depth
    if depth < BRICK_LEVELS + 1:
        raise ValueError(f"depth must be >= {BRICK_LEVELS + 1} for bricks")
    top_depth = depth - BRICK_LEVELS
    ls = svo.level_start
    masks = _host(svo.masks)
    child_base = _host(svo.child_base)
    leaf_base = _host(svo.leaf_base)
    if svo.parent_ptr is not None:
        parent_ptr = _host(svo.parent_ptr)
    else:
        parent_ptr = compute_parent_ptr(masks, child_base)

    nb_start, nb_end = int(ls[top_depth]), int(ls[top_depth + 1])
    n_bricks = nb_end - nb_start
    n_top = nb_start

    top_masks = masks[:n_top].copy()
    top_child = child_base[:n_top].copy()
    top_parent = parent_ptr[:n_top].copy()
    # cut level: children become (brick) leaves; child_base column -> brick id
    lo, hi = int(ls[top_depth - 1]), n_top
    vm_cut = (top_masks[lo:hi] >> 8) & 0xFF
    top_masks[lo:hi] = (vm_cut << 8) | vm_cut
    top_child[lo:hi] = child_base[lo:hi] - nb_start

    # ---- brick bits: expand the 3 levels under each brick node ----------
    brick_rows = np.arange(nb_start, nb_end, dtype=np.int64)
    r1, p1, s1 = _expand_children(masks, child_base, brick_rows)
    r2, p2, s2 = _expand_children(masks, child_base, r1)
    # leaves of level depth-1 nodes (valid == leaf there)
    lm2 = masks[r2] & 0xFF
    hit3 = ((lm2[:, None] >> np.arange(8)) & 1).astype(bool)
    pidx3, s3 = np.nonzero(hit3)
    s3 = s3.astype(np.int32)

    brick_of = p1[p2[pidx3]]
    bitidx = (s1[p2[pidx3]].astype(np.int64) << 6) | (s2[pidx3] << 3) | s3
    flat = brick_of * 16 + (bitidx >> 5)           # sorted non-decreasing
    bit = np.uint32(1) << (bitidx & 31).astype(np.uint32)

    words = np.zeros(n_bricks * 16, np.uint32)
    if flat.size:
        starts = np.concatenate(
            [np.zeros(1, np.int64), np.flatnonzero(flat[1:] != flat[:-1]) + 1])
        words[flat[starts]] = np.bitwise_or.reduceat(bit, starts)

    # first global leaf id per brick = leaf_base of its first depth-1 node
    bleaf = np.zeros(n_bricks, np.uint32)
    if r2.size:
        b_of_r2 = p1[p2]  # brick of each depth-1 node, sorted non-decreasing
        starts2 = np.concatenate(
            [np.zeros(1, np.int64),
             np.flatnonzero(b_of_r2[1:] != b_of_r2[:-1]) + 1])
        bleaf[b_of_r2[starts2]] = leaf_base[r2[starts2]].astype(np.uint32)

    bricks = np.concatenate(
        [words.reshape(n_bricks, 16), bleaf[:, None]], axis=1)
    if n_bricks == 0:
        # empty scene: keep one zero row so a masked row read is always
        # well-formed
        bricks = np.zeros((1, 17), np.uint32)
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return BrickSVO(
        top_masks=as_i32(top_masks), top_child=as_i32(top_child),
        top_parent=as_i32(top_parent), bricks=_words(bricks),
        depth=depth, top_depth=top_depth)


# ---------------------------------------------------------------------------
# bit helpers on int32 tensors
# ---------------------------------------------------------------------------

def _popcount32(v):
    """Set bits of each 32-bit word of an int32 tensor (any sign), int32.
    The count runs on the zero-extended word in int64, where no step can
    overflow."""
    x = v.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(_I32)


def _spread3(x):
    """Interleave the low 3 bits of x to positions 0, 3, 6."""
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def _sel16(words, w):
    """words[n, w[n]] for words (N, 16) and a word index w (N,) in 0..15.
    (The reference selects with a mux tree, its machine having no per-lane
    gather; here it is a gather.)"""
    return torch.gather(words, 1, w.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# the brick trace (the reference's `_trace_brick_core`), plain version
# ---------------------------------------------------------------------------

# DDA steps a round may take: the reference's loop runs while its counter is
# below 3 * 8 + 2, six steps a trip, so 30. An 8^3 brick needs at most 22
# (7 moves on each axis, and the step that leaves), so it never binds.
DDA_ROUND_STEPS = 30


def rounds_for_depth(depth: int) -> int:
    """The reference's bound on rounds (brick.py: 16 * depth + 64)."""
    return 16 * depth + 64


def _parked_rays(s, bricks, top_depth):
    """The parked rays of `s` at their brick's entry voxel: (sel, their ray
    rows; t_coef, t_bias, t_cur, om; the brick rows' 16 words and first
    leaf; bpos, the entry voxel's mirrored corner; flip), or None when no
    ray is parked. Each descends BRICK_LEVELS levels from its brick's
    corner with the reference's expression, half * coef + (pos * coef -
    bias), which rounds in two steps as the kernels do."""
    sel = torch.nonzero(s["parked"])[:, 0]
    if sel.numel() == 0:
        return None
    t_coef, t_bias = s["t_coef"][sel], s["t_bias"][sel]
    t_cur = s["t_min"][sel]
    om = s["octant_mask"][sel]
    row = bricks[s["brick_id"][sel].long()]
    bpos = s["pos"][sel]
    for level in range(1, BRICK_LEVELS + 1):
        half = 2.0 ** (-top_depth - level)
        upper = half * t_coef + (bpos * t_coef - t_bias) > t_cur[:, None]
        bpos = bpos + torch.where(upper, half, 0.0)
    flip = torch.stack([torch.where(((om >> c) & 1) != 0, 0, 7) for c in range(3)],
                       dim=1).to(_I32)
    return sel, t_coef, t_bias, t_cur, om, row[:, :16], row[:, 16], bpos, flip


def _leaf_in_brick(words, bleaf, idx9):
    """Leaf ids of voxels `idx9` of bricks (`words` (N, 16), first leaves
    `bleaf`): the brick's first leaf, the set bits of the words below the
    voxel's word, and those below its bit in its own word."""
    wsel = idx9 >> 5
    below_words = torch.arange(16, device=idx9.device)[None, :] < wsel[:, None]
    full = torch.sum(torch.where(below_words, _popcount32(words), 0), dim=1,
                     dtype=_I32)
    low_bits = (torch.ones_like(wsel, dtype=torch.int64) << (idx9 & 31)) - 1
    partial = _popcount32(_sel16(words, wsel).to(torch.int64) & low_bits)
    return bleaf + full + partial


def _dda_round(s, bricks, depth, top_depth):
    """The parked rays' brick walk (the DDA half of ``_brick_round``): each
    parked ray descends three levels from its brick's corner to its entry
    voxel, then steps voxel by voxel, at most DDA_ROUND_STEPS steps, to an
    occupied voxel (a hit: the brick's first leaf plus the set bits below
    the voxel's, and the top tree's parent and slot) or out of the brick
    (`popped`, so that the resumed walk steps past it). Every ray leaves
    unparked."""
    from raytracingtest_tpu_torch.ops.brick_dda import dda_step

    parked = _parked_rays(s, bricks, top_depth)
    if parked is None:
        return s
    sel, t_coef, t_bias, t_cur, om, words, bleaf, bpos, flip = parked
    word_of = lambda wsel: _sel16(words, wsel)
    no_bound = torch.full_like(t_cur, float("inf"))
    walking = torch.ones_like(sel, dtype=torch.bool)
    hit = torch.zeros_like(walking)
    exited = torch.zeros_like(walking)
    steps = torch.zeros_like(t_cur, dtype=_I32)
    idx9_hit = torch.zeros_like(steps)
    t_hit = torch.zeros_like(t_cur)
    for _ in range(DDA_ROUND_STEPS):
        if not bool(walking.any()):
            break
        steps += walking.to(_I32)
        bpos, t_cur, hit_now, exit_b, walking, idx9 = dda_step(
            bpos, t_cur, walking, no_bound, t_coef, t_bias, flip, word_of, depth)
        idx9_hit = torch.where(hit_now, idx9, idx9_hit)
        t_hit = torch.where(hit_now, t_cur, t_hit)
        hit |= hit_now
        exited |= exit_b
    leaf = _leaf_in_brick(words, bleaf, idx9_hit)

    out = dict(s)
    upd = lambda name, value: out[name].index_copy(0, sel, value)
    out["t_min"] = upd("t_min", t_cur)
    out["done"] = upd("done", s["done"][sel] | hit)
    out["popped"] = upd("popped", s["popped"][sel] | exited)
    out["hit_leaf"] = upd("hit_leaf", torch.where(hit, leaf, s["hit_leaf"][sel]))
    out["hit_t"] = upd("hit_t", torch.where(hit, t_hit, s["hit_t"][sel]))
    child = s["idx"][sel] ^ om ^ 7
    out["hit_parent"] = upd("hit_parent",
                            torch.where(hit, s["parent"][sel], s["hit_parent"][sel]))
    out["hit_child"] = upd("hit_child", torch.where(hit, child, s["hit_child"][sel]))
    _count_dda(out, s, sel, steps)
    out["parked"] = torch.zeros_like(s["parked"])
    return out


def _count_dda(out, s, sel, steps):
    """Add a round's DDA `steps` of the rays `sel` to their counts."""
    upd = lambda name, value: out[name].index_copy(0, sel, value)
    out["iters"] = upd("iters", s["iters"][sel] + steps)
    out["dda_steps"] = upd("dda_steps", s["dda_steps"][sel] + steps)
    out["dda_max"] = upd("dda_max", torch.maximum(s["dda_max"][sel], steps))


def dda_multi_steps(k: int) -> int:
    """DDA steps a round of the k-segment brick trace may take: the
    reference's loop runs while its counter is below 3 * 8 + 2 + k, one step
    a trip."""
    return 3 * 8 + 2 + k


def _dda_round_multi(s, bricks, depth, top_depth, k):
    """The DDA half of a round of ``_trace_brick_multi_core``: each parked
    ray descends to its entry voxel and steps through its brick, at most
    ``dda_multi_steps(k)`` steps; each occupied voxel it stands in records
    the segment (leaf, t, the voxel's exit t) in slot `count`, and the ray
    walks on, until it holds k segments (it is done, and does not step) or
    leaves the brick (`popped`). Every ray leaves unparked."""
    parked = _parked_rays(s, bricks, top_depth)
    if parked is None:
        return s
    sel, t_coef, t_bias, t_cur, _om, words, bleaf, bpos, flip = parked
    vshift, vsize = S_MAX - depth, 2.0 ** -depth
    hits_leaf, t_in, t_out = s["hits_leaf"][sel], s["t_in"][sel], s["t_out"][sel]
    count = s["count"][sel]
    slots = torch.arange(k, dtype=_I32, device=sel.device)[None, :]
    walking = torch.ones_like(sel, dtype=torch.bool)
    exited = torch.zeros_like(walking)
    steps = torch.zeros_like(count)
    for _ in range(dda_multi_steps(k)):
        if not bool(walking.any()):
            break
        steps += walking.to(_I32)
        li = (_f2i(bpos) >> vshift) & 7
        aa = li ^ flip
        idx9 = (_spread3(aa[:, 0]) | (_spread3(aa[:, 1]) << 1)
                | (_spread3(aa[:, 2]) << 2))
        occ = ((_sel16(words, idx9 >> 5) >> (idx9 & 31)) & 1) != 0
        hit_now = walking & occ
        t_corner = bpos * t_coef - t_bias
        tc_max = torch.amin(t_corner, dim=1)
        put = (slots == count[:, None]) & hit_now[:, None]
        hits_leaf = torch.where(put, _leaf_in_brick(words, bleaf, idx9)[:, None],
                                hits_leaf)
        t_in = torch.where(put, t_cur[:, None], t_in)
        t_out = torch.where(put, tc_max[:, None], t_out)
        count = count + hit_now.to(_I32)
        adv = walking & (count < k)
        step_bits = t_corner <= tc_max[:, None]
        exit_b = adv & torch.any(step_bits & (li == 0), dim=1)
        stay = adv & ~exit_b
        bpos = bpos - torch.where(step_bits & stay[:, None], vsize, 0.0)
        t_cur = torch.where(adv, torch.maximum(t_cur, tc_max), t_cur)
        exited |= exit_b
        walking = stay

    out = dict(s)
    upd = lambda name, value: out[name].index_copy(0, sel, value)
    out["t_min"] = upd("t_min", t_cur)
    out["done"] = upd("done", s["done"][sel] | (count >= k))
    out["popped"] = upd("popped", s["popped"][sel] | exited)
    out["hits_leaf"] = upd("hits_leaf", hits_leaf)
    out["t_in"] = upd("t_in", t_in)
    out["t_out"] = upd("t_out", t_out)
    out["count"] = upd("count", count)
    _count_dda(out, s, sel, steps)
    out["parked"] = torch.zeros_like(s["parked"])
    return out


def _brick_rounds(bsvo, st, out_names, n_top, n_rounds, dda_round, lod=None):
    """Rounds of the brick trace over the walk registers `st`: in each, the
    top walk of every ray still walking, at most `n_top` steps, until it
    parks or finishes (in LOD mode with `lod`, ``fast_step``'s); then
    `dda_round` (state -> state) walks the parked
    rays' bricks. At most `n_rounds` rounds. Returns the outputs
    `out_names` and the round statistics."""
    nodes = torch.stack([bsvo.top_masks, bsvo.top_child, bsvo.top_parent], dim=1)
    zi = torch.zeros_like(st["idx"])
    st.update(parked=torch.zeros_like(st["done"]), brick_id=zi, rounds=zi,
              dda_steps=zi, top_capped=zi, dda_max=zi)
    walk = Compacted(st, out_names + ("iters", "done", "rounds", "dda_steps",
                                      "top_capped", "dda_max"))
    for _ in range(n_rounds):
        walking = ~walk.state["done"]
        n_walking = int(walking.sum())
        if n_walking == 0:
            break
        if 2 * n_walking < walking.shape[0]:
            walk.compact(walking)
            walking = ~walk.state["done"]
        s = walk.state
        s["rounds"] = s["rounds"] + walking.to(_I32)
        for _ in range(n_top):
            if not bool((~s["done"] & ~s["parked"]).any()):
                break
            s = fast_step(s, nodes, park=True, lod=lod)
        s["top_capped"] = s["top_capped"] + (~s["done"] & ~s["parked"]).to(_I32)
        walk.state = dda_round(s)
    out = walk.finish()
    stats = torch.stack([out["rounds"], out["dda_steps"], out["top_capped"],
                         out["dda_max"], (~out["done"]).to(_I32)], dim=1)
    return out, stats


def trace_brick(bsvo, origin, direction, with_stats=False, root=None):
    """Brick trace of (N, 3) float32 rays through `bsvo`, any N: the plain
    version of the ``brick_trace`` kernel. hit_leaf and hit_t are the
    stackless trace's on the source SVO; hit_parent and hit_child are the
    TOP tree's (the level-(top_depth - 1) node and the brick's slot under
    it). Returns a TraceResult, or (TraceResult, stats (N, 5) int32; columns
    ``traverse.STAT_NAMES``) with `with_stats`.

    A round walks the top tree stacklessly, at most
    ``max_iters_for_depth(top_depth)`` steps, until the ray parks at a brick
    or finishes; a parked ray then walks its brick. At most
    ``rounds_for_depth(depth)`` rounds. Every ray still walking steps on
    every iteration of a round's top walk, so these are bounds on each ray:
    the reference's own, which it counts for the whole batch (and its round
    also ends once few rays can still step, ``TOP_DRAIN``), are never
    looser, and every ray that the reference finishes ends here alike.

    `root` (an int or (N,) int32) starts each ray's top walk at that top
    row instead of row 0, the reference's ``_trace_brick_core(root=)``: the
    clipmap's chunk roots in a shared brick arena."""
    depth, top_depth = bsvo.depth, bsvo.top_depth
    st = walk_state(origin, direction, top_depth, root)
    st["hit_leaf"] = torch.full_like(st["idx"], -1)
    out, stats = _brick_rounds(
        bsvo, st, ("hit_leaf", "hit_t", "hit_parent", "hit_child"),
        max_iters_for_depth(top_depth), rounds_for_depth(depth),
        lambda s: _dda_round(s, bsvo.bricks, depth, top_depth))
    res = TraceResult(out["hit_leaf"], out["hit_t"], out["hit_parent"],
                      out["hit_child"], out["iters"])
    return (res, stats) if with_stats else res


def trace_brick_multi(bsvo, origin, direction, k=4, with_stats=False):
    """The first `k` leaf segments of (N, 3) float32 rays through `bsvo`,
    any N: the plain version of the ``brick_trace_multi`` kernel and the
    counterpart of ``_trace_brick_multi_core``. The rounds of
    ``trace_brick`` with the DDA in collect mode (``_dda_round_multi``): a
    segment's t_out is its voxel's exit, which equals the stackless walk's
    min(t_max, tc_max), so the segments are ``traverse.trace_multi``'s on
    the source SVO. Returns a ``traverse.MultiTraceResult``, or
    (MultiTraceResult, stats (N, 5) int32; columns ``traverse.STAT_NAMES``)
    with `with_stats`.

    The bounds are the reference's, on each ray: at most
    ``max_iters_for_depth(top_depth) + 8 * k`` top steps and
    ``dda_multi_steps(k)`` DDA steps a round, at most ``rounds_for_depth(
    depth) + 8 * k`` rounds. The reference counts them for the batch and
    ends a round's top walk early once few rays can still step
    (``TOP_DRAIN``), which never lengthens a ray's stretch, so every ray it
    finishes within them ends here with the same segments."""
    if k < 1:
        raise ValueError(f"k = {k}: a ray keeps at least one segment")
    depth, top_depth = bsvo.depth, bsvo.top_depth
    st = multi_state(walk_state(origin, direction, top_depth), k)
    out, stats = _brick_rounds(
        bsvo, st, ("hits_leaf", "t_in", "t_out", "count"),
        multi_steps_for_depth(top_depth, k), rounds_for_depth(depth) + 8 * k,
        lambda s: _dda_round_multi(s, bsvo.bricks, depth, top_depth, k))
    res = MultiTraceResult(out["hits_leaf"], out["t_in"], out["t_out"],
                           out["count"], out["iters"])
    return (res, stats) if with_stats else res


def trace_brick_lod(bsvo, origin, direction, coef, bias=0.0, with_stats=False):
    """LOD brick trace of (N, 3) float32 rays through `bsvo`, any N: the
    plain version of the ``brick_trace_lod`` kernel and the counterpart of
    ``trace_brick_lod_jax``. ``trace_brick``'s rounds with the footprint
    stop in the top walk, the brick level included: entering a top-tree
    child (a node, or a brick) no larger than t * coef + bias ends the ray
    at t_min with `hit_node` the child's row in the source SVO (top rows
    are the source's, and the node of brick b is row n_top + b); hit_leaf,
    hit_parent and hit_child stay -1, -1, 0. A footprint finer than a brick
    walks the exact DDA to the leaf, as ``trace_brick`` does (hit_node -1).
    Returns a TraceResult, or (TraceResult, stats (N, 5) int32; columns
    ``traverse.STAT_NAMES``) with `with_stats`; ``trace_brick``'s bounds."""
    depth, top_depth = bsvo.depth, bsvo.top_depth
    st = walk_state(origin, direction, top_depth)
    st["hit_leaf"] = torch.full_like(st["idx"], -1)
    st["hit_node"] = torch.full_like(st["idx"], -1)
    lod = (*lod_constants(coef, bias, bsvo.top_masks.device), bsvo.n_top)
    out, stats = _brick_rounds(
        bsvo, st, ("hit_leaf", "hit_t", "hit_parent", "hit_child", "hit_node"),
        max_iters_for_depth(top_depth), rounds_for_depth(depth),
        lambda s: _dda_round(s, bsvo.bricks, depth, top_depth), lod=lod)
    res = TraceResult(out["hit_leaf"], out["hit_t"], out["hit_parent"],
                      out["hit_child"], out["iters"], out["hit_node"])
    return (res, stats) if with_stats else res
