"""The reference's walks: the brick trace and its k-segment form, in plain
torch operations on any device.

Frozen copy of the port's plain versions at commit
c4b99874d80592771fd0a8ae8a7eee3dc0040498: ``ops/traverse.py``
(``ray_setup``, ``init_state`` without its stack, ``fast_step`` without its
LOD mode, ``Compacted``), ``ops/brick_dda.py`` (``dda_step``) and
``ops/brick.py`` (``trace_brick``, ``trace_brick_multi`` and their rounds),
which are the reference's ``_trace_brick_core`` and
``_trace_brick_multi_core``. Each float step is its own operation, so
``a*b - c`` rounds twice, as the kernels built with ``--fmad=false`` round
it. It imports nothing of the program.

Words are uint32 bit patterns carried in int32: mask after each right shift.
"""

from __future__ import annotations

import torch

S_MAX = 23
BRICK_LEVELS = 3
# DDA steps a round may take (the reference's loop: six steps a trip while
# its counter is below 3 * 8 + 2); an 8^3 brick needs at most 22
DDA_ROUND_STEPS = 30

_F32, _I32 = torch.float32, torch.int32


def max_iters_for_depth(depth: int) -> int:
    return 24 * depth + 48


def rounds_for_depth(depth: int) -> int:
    return 16 * depth + 64


def multi_steps_for_depth(depth: int, k: int) -> int:
    return max_iters_for_depth(depth) + 8 * k


def dda_multi_steps(k: int) -> int:
    return 3 * 8 + 2 + k


def popc8(v):
    v = v & 0xFF
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _popcount32(v):
    x = v.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(_I32)


def _f2i(x):
    return x.contiguous().view(_I32)


def _i2f(x):
    return x.contiguous().view(_F32)


def _bits(mask3):
    bit = torch.tensor([1, 2, 4], dtype=_I32, device=mask3.device)
    return torch.sum(torch.where(mask3, bit, 0), dim=1, dtype=_I32)


def _spread3(x):
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def _sel16(words, w):
    return torch.gather(words, 1, w.long()[:, None])[:, 0]


def ray_setup(origin, direction):
    """Mirroring and root-cube entry: (t_coef, t_bias, octant_mask, t_min,
    t_max)."""
    o = origin.to(_F32) + 1.0
    d = direction.to(_F32)
    eps = 2.0 ** -S_MAX
    d = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    t_coef = -1.0 / d.abs()
    t_bias = t_coef * o
    pos_dir = d > 0.0
    octant_mask = 7 ^ _bits(pos_dir)
    t_bias = torch.where(pos_dir, 3.0 * t_coef - t_bias, t_bias)
    t_min = torch.amax(2.0 * t_coef - t_bias, dim=1)
    t_max = torch.amin(t_coef - t_bias, dim=1)
    t_min = torch.clamp(t_min, min=0.0)
    return t_coef, t_bias, octant_mask, t_min, t_max


def walk_state(origin, direction):
    """The stackless walk's registers after cube entry, each ray at row 0."""
    t_coef, t_bias, octant_mask, t_min, t_max = ray_setup(origin, direction)
    n = t_min.shape[0]
    device = t_min.device
    upper = 1.5 * t_coef - t_bias > t_min[:, None]
    zi = torch.zeros(n, dtype=_I32, device=device)
    zf = torch.zeros(n, dtype=_F32, device=device)
    done = t_min >= t_max
    return dict(pos=torch.where(upper, 1.5, 1.0), idx=_bits(upper), parent=zi,
                scale=zi + (S_MAX - 1), t_min=t_min, octant_mask=octant_mask,
                t_coef=t_coef, t_bias=t_bias, done=done,
                popped=torch.zeros_like(done), hit_parent=zi - 1, hit_child=zi,
                hit_t=zf, iters=zi)


def fast_step(st, nodes, park=False, k=0):
    """One step of the stackless walk of the rays walking in `st`; with
    `park` a ray entering a leaf child parks at brick ``child_base + leaf
    rank``, with `k` (collect mode) it records the segment and walks on."""
    walking = ~st["done"] & ~st["parked"] if park else ~st["done"]
    nd = nodes[st["parent"].long()]
    desc, cbase, pptr = nd[:, 0], nd[:, 1], nd[:, 2]
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF

    scale = st["scale"]
    scale_exp2 = _i2f((scale - S_MAX + 127) << 23)
    pos, t_coef, t_bias, t_min = st["pos"], st["t_coef"], st["t_bias"], st["t_min"]
    t_corner = pos * t_coef - t_bias
    tc_max = torch.amin(t_corner, dim=1)

    pshift = (scale + 1)[:, None]
    psh = _f2i(pos) >> pshift
    parent_pos = _i2f(psh << pshift)
    t_root = torch.amin(t_coef - t_bias, dim=1)
    t_max = torch.minimum(torch.amin(parent_pos * t_coef - t_bias, dim=1), t_root)

    child_shift = st["idx"] ^ st["octant_mask"] ^ 7
    child_valid = ((vm >> child_shift) & 1) != 0
    can = child_valid & (t_min <= t_max) & walking & ~st["popped"]
    tv_max = torch.minimum(t_max, tc_max)
    half = scale_exp2 * 0.5
    enter = can & (t_min <= tv_max)
    below = (torch.ones_like(child_shift) << child_shift) - 1
    leaf_bit = ((lm >> child_shift) & 1) != 0

    out = dict(st)
    leaf_now = enter & leaf_bit
    full = None
    node_rank = popc8(vm & ~lm & below)
    if park:
        leaf_rank = popc8(vm & lm & below)
        done = st["done"]
        out["brick_id"] = torch.where(leaf_now, cbase + leaf_rank, st["brick_id"])
        out["parked"] = st["parked"] | leaf_now
    elif k:
        leaf_id = nd[:, 3] + popc8(vm & lm & below)
        slots = torch.arange(k, dtype=_I32, device=desc.device)[None, :]
        sel = (slots == st["count"][:, None]) & leaf_now[:, None]
        out["hits_leaf"] = torch.where(sel, leaf_id[:, None], st["hits_leaf"])
        out["t_in"] = torch.where(sel, t_min[:, None], st["t_in"])
        out["t_out"] = torch.where(sel, tv_max[:, None], st["t_out"])
        out["count"] = st["count"] + leaf_now.to(_I32)
        full = out["count"] >= k
        done = st["done"] | full
    else:
        out["hit_parent"] = torch.where(leaf_now, st["parent"], st["hit_parent"])
        out["hit_child"] = torch.where(leaf_now, child_shift, st["hit_child"])
        out["hit_t"] = torch.where(leaf_now, t_min, st["hit_t"])
        done = st["done"] | leaf_now

    push = enter & ~leaf_bit
    parent = torch.where(push, cbase + node_rank, st["parent"])
    upper = half[:, None] * t_coef + t_corner > t_min[:, None]
    idx = torch.where(push, _bits(upper), st["idx"])
    pos = torch.where(push[:, None], pos + torch.where(upper, half[:, None], 0.0), pos)
    scale = torch.where(push, scale - 1, scale)

    adv = walking & ~push & (~leaf_now if full is None else ~full)
    step_bits = t_corner <= tc_max[:, None]
    step_mask = _bits(step_bits)
    idx_adv = st["idx"] ^ step_mask
    pop = adv & ((idx_adv & step_mask) != 0)
    move = adv & ~pop
    out["t_min"] = torch.where(adv, torch.maximum(t_min, tc_max), t_min)
    pos = pos - torch.where(step_bits & move[:, None], scale_exp2[:, None], 0.0)
    idx = torch.where(move, idx_adv, idx)

    new_scale = st["scale"] + 1
    exit_root = pop & (new_scale >= S_MAX)
    pop_ok = pop & ~exit_root
    out["pos"] = torch.where(pop_ok[:, None], parent_pos, pos)
    out["idx"] = torch.where(
        pop_ok, (psh[:, 0] & 1) | ((psh[:, 1] & 1) << 1) | ((psh[:, 2] & 1) << 2),
        idx)
    out["parent"] = torch.where(pop_ok, pptr, parent)
    out["scale"] = torch.where(pop_ok, new_scale, scale)
    out["done"] = done | exit_root
    out["popped"] = pop_ok
    out["iters"] = st["iters"] + walking.to(_I32)
    return out


class Compacted:
    """A walk's registers kept for the rays still walking only; ``out``
    holds the full-width outputs."""

    def __init__(self, state, out_names):
        self.state = state
        self.rays = torch.arange(state["done"].shape[0], device=state["done"].device)
        self.out = {k: state[k].clone() for k in out_names}

    def compact(self, keep):
        gone = self.rays[~keep]
        for k in self.out:
            self.out[k][gone] = self.state[k][~keep]
        self.state = {k: v[keep] for k, v in self.state.items()}
        self.rays = self.rays[keep]

    def finish(self):
        self.compact(torch.zeros_like(self.rays, dtype=torch.bool))
        return self.out


def dda_step(bpos, t_cur, walking, hit_t, t_coef, t_bias, flip, word_of, depth):
    """One masked step of the exact voxel DDA inside an 8^3 brick."""
    vshift = S_MAX - depth
    vsize = 2.0 ** -depth
    li = (_f2i(bpos) >> vshift) & 7
    aa = li ^ flip
    idx9 = (_spread3(aa[:, 0]) | (_spread3(aa[:, 1]) << 1)
            | (_spread3(aa[:, 2]) << 2))
    w = word_of(idx9 >> 5)
    occ = ((w >> (idx9 & 31)) & 1) != 0
    hit_now = walking & occ & (t_cur < hit_t)
    t_corner = bpos * t_coef - t_bias
    tc_max = torch.amin(t_corner, dim=1)
    adv = walking & ~hit_now
    step_bits = t_corner <= tc_max[:, None]
    exit_b = adv & torch.any(step_bits & (li == 0), dim=1)
    stay = adv & ~exit_b
    bpos = bpos - torch.where(step_bits & stay[:, None], vsize, 0.0)
    t_cur = torch.where(adv, torch.maximum(t_cur, tc_max), t_cur)
    return bpos, t_cur, hit_now, exit_b, stay, idx9


def _parked_rays(s, bricks, top_depth):
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
    wsel = idx9 >> 5
    below_words = torch.arange(16, device=idx9.device)[None, :] < wsel[:, None]
    full = torch.sum(torch.where(below_words, _popcount32(words), 0), dim=1,
                     dtype=_I32)
    low_bits = (torch.ones_like(wsel, dtype=torch.int64) << (idx9 & 31)) - 1
    partial = _popcount32(_sel16(words, wsel).to(torch.int64) & low_bits)
    return bleaf + full + partial


def _count_dda(out, s, sel, steps):
    upd = lambda name, value: out[name].index_copy(0, sel, value)
    out["iters"] = upd("iters", s["iters"][sel] + steps)
    out["dda_steps"] = upd("dda_steps", s["dda_steps"][sel] + steps)


def _dda_round(s, bricks, depth, top_depth):
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
    _count_dda(out, s, sel, steps)
    out["parked"] = torch.zeros_like(s["parked"])
    return out


def _dda_round_multi(s, bricks, depth, top_depth, k):
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


def _brick_rounds(bricks, st, out_names, n_top, n_rounds, dda_round):
    nodes = torch.stack([bricks["top_masks"], bricks["top_child"],
                         bricks["top_parent"]], dim=1)
    zi = torch.zeros_like(st["idx"])
    st.update(parked=torch.zeros_like(st["done"]), brick_id=zi, dda_steps=zi)
    walk = Compacted(st, out_names + ("iters", "done", "dda_steps"))
    for _ in range(n_rounds):
        walking = ~walk.state["done"]
        n_walking = int(walking.sum())
        if n_walking == 0:
            break
        if 2 * n_walking < walking.shape[0]:
            walk.compact(walking)
        s = walk.state
        for _ in range(n_top):
            if not bool((~s["done"] & ~s["parked"]).any()):
                break
            s = fast_step(s, nodes, park=True)
        walk.state = dda_round(s)
    return walk.finish()


def trace_brick(bricks, origin, direction):
    """The brick trace of (N, 3) float32 rays through the brick form
    `bricks` (a dict of ``top_masks``, ``top_child``, ``top_parent``,
    ``bricks`` tensors and ``depth``, ``top_depth``): a dict of ``hit_leaf``,
    ``hit_t``, ``iters`` and ``dda_steps`` (N,)."""
    depth, top_depth = bricks["depth"], bricks["top_depth"]
    st = walk_state(origin, direction)
    st["hit_leaf"] = torch.full_like(st["idx"], -1)
    return _brick_rounds(
        bricks, st, ("hit_leaf", "hit_t"), max_iters_for_depth(top_depth),
        rounds_for_depth(depth),
        lambda s: _dda_round(s, bricks["bricks"], depth, top_depth))


def trace_brick_multi(bricks, origin, direction, k):
    """The first `k` leaf segments of each ray: a dict of ``hits_leaf``,
    ``t_in``, ``t_out`` (N, k), ``count``, ``iters`` and ``dda_steps``
    (N,)."""
    depth, top_depth = bricks["depth"], bricks["top_depth"]
    st = walk_state(origin, direction)
    n, device = st["done"].shape[0], st["done"].device
    st.update(count=torch.zeros(n, dtype=_I32, device=device),
              hits_leaf=torch.full((n, k), -1, dtype=_I32, device=device),
              t_in=torch.zeros((n, k), dtype=_F32, device=device),
              t_out=torch.zeros((n, k), dtype=_F32, device=device))
    return _brick_rounds(
        bricks, st, ("hits_leaf", "t_in", "t_out", "count"),
        multi_steps_for_depth(top_depth, k), rounds_for_depth(depth) + 8 * k,
        lambda s: _dda_round_multi(s, bricks["bricks"], depth, top_depth, k))
