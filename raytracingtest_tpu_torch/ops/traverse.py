"""ESVO traversal, plain PyTorch: masked PUSH/ADVANCE/POP over all rays.

Port of ``raytracingtest_tpu/ops/traverse.py``: ``init_state``, ``step``,
``trace_numpy`` (the walk with a stack, below), and the stackless walk of the
reference's XLA path, ``_fast_step`` / ``_trace_core`` / ``trace_jax``, as
``fast_step`` / ``trace_stackless`` (the end of the module), with
``derive_parent_ptr``, ``parent_ptr_of`` and ``node_rows``; its k-segment walk,
``_trace_multi_core`` / ``trace_multi_jax``, as ``trace_multi`` (the plain
version of the ``esvo_stackless_multi`` kernel), with ``MultiTraceResult``;
and its LOD walk, ``_trace_lod_core`` / ``trace_lod_jax``, as ``trace_lod``
(the plain version of ``esvo_stackless_lod``).

The walk with a stack: every lane runs every iteration; PUSH/ADVANCE/POP are
``torch.where`` selects and the per-ray stack is a (depth, N) pair of
tensors addressed by gather/scatter. Rays are in octree-local coordinates,
mapped to the mirrored [1,2]^3 traversal cube.

It is the ``esvo_trace`` kernel's plain version (``traverse_cuda``): the CPU
tests hold it to the numpy oracle bit for bit and to the Pallas kernel's
hits, and ``chip_smoke.py`` holds the kernel to it on the card. POP follows
the Pallas kernel where the oracle differs from it (see ``step``). Integer
state stays int32 throughout (torch promotes to int64 readily); float steps
are separate ops, so ``a*b - c`` rounds twice, as in the oracle.
"""

from __future__ import annotations

import dataclasses

import torch

S_MAX = 23

_F32, _I32 = torch.float32, torch.int32


def popc8(v):
    """8-bit popcount (bit tricks, int32 in, int32 out)."""
    v = v & 0xFF
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _f2i(x):
    return x.contiguous().view(_I32)


def _i2f(x):
    return x.contiguous().view(_F32)


@dataclasses.dataclass(frozen=True)
class TraceResult:
    hit_leaf: torch.Tensor    # int32 (N,) leaf row, -1 on miss
    hit_t: torch.Tensor       # float32 (N,) entry t (octree-local units)
    hit_parent: torch.Tensor  # int32 (N,) node row holding the hit leaf, -1
    hit_child: torch.Tensor   # int32 (N,) unmirrored child slot
    iters: torch.Tensor       # int32 (N,) traversal steps taken
    # int32 (N,) the LOD traces' interior node row where the footprint
    # stopped the ray, -1 elsewhere; None from the other traces
    hit_node: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class TraceState:
    # per-ray traversal registers; shapes (N,) or (N, 3)
    pos: torch.Tensor          # f32 (N,3) mirrored lower corner of the child
    idx: torch.Tensor          # i32 mirrored child index bits
    parent: torch.Tensor       # i32 current node row
    scale: torch.Tensor        # i32
    scale_exp2: torch.Tensor   # f32
    t_min: torch.Tensor        # f32
    t_max: torch.Tensor        # f32
    h: torch.Tensor            # f32 last pushed tc_max (stack-write filter)
    octant_mask: torch.Tensor  # i32
    t_coef: torch.Tensor       # f32 (N,3)
    t_bias: torch.Tensor       # f32 (N,3)
    done: torch.Tensor         # bool
    hit_leaf: torch.Tensor     # i32
    hit_t: torch.Tensor        # f32
    hit_parent: torch.Tensor   # i32
    hit_child: torch.Tensor    # i32
    stack_node: torch.Tensor   # i32 (S, N)
    stack_tmax: torch.Tensor   # f32 (S, N)
    iters: torch.Tensor        # i32


def max_iters_for_depth(depth: int) -> int:
    # explicit trip bound so the masked loop always terminates
    return 24 * depth + 48


def _bits(mask3):
    """(N, 3) bool -> int32 (N,) with bit i set where column i is."""
    bit = torch.tensor([1, 2, 4], dtype=_I32, device=mask3.device)
    return torch.sum(torch.where(mask3, bit, 0), dim=1, dtype=_I32)


def ray_setup(origin, direction):
    """Mirroring and root-cube entry for (N, 3) float32 rays: (t_coef (N,3),
    t_bias (N,3), octant_mask (N,), t_min (N,), t_max (N,)). A ray with
    t_min >= t_max never enters the cube."""
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


def init_state(origin, direction, depth, root=None) -> TraceState:
    """Mirroring and cube entry for (N, 3) float32 rays. `root` (an int or
    (N,) int32): each ray's root row, where its walk starts (the clipmap's
    per-ray chunk roots in a shared arena); None is row 0."""
    t_coef, t_bias, octant_mask, t_min, t_max = ray_setup(origin, direction)
    n = t_min.shape[0]
    device = t_min.device

    # first child of the root
    upper = 1.5 * t_coef - t_bias > t_min[:, None]
    idx = _bits(upper)
    pos = torch.where(upper, 1.5, 1.0)

    zi = torch.zeros(n, dtype=_I32, device=device)
    zf = torch.zeros(n, dtype=_F32, device=device)
    parent = zi if root is None else zi + torch.as_tensor(root, dtype=_I32,
                                                           device=device)
    return TraceState(
        pos=pos, idx=idx, parent=parent, scale=zi + (S_MAX - 1),
        scale_exp2=zf + 0.5, t_min=t_min, t_max=t_max, h=t_max,
        octant_mask=octant_mask, t_coef=t_coef, t_bias=t_bias,
        done=t_min >= t_max, hit_leaf=zi - 1, hit_t=zf, hit_parent=zi - 1,
        hit_child=zi,
        stack_node=torch.zeros((depth, n), dtype=_I32, device=device),
        stack_tmax=torch.zeros((depth, n), dtype=_F32, device=device),
        iters=zi,
    )


def step(s: TraceState, masks, child_base, leaf_base, depth) -> TraceState:
    """One masked PUSH/ADVANCE/POP iteration over all rays."""
    s0 = S_MAX - depth  # lowest scale in use; stack slot = scale - s0
    active = ~s.done

    desc = masks[s.parent.long()]
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF

    t_corner = s.pos * s.t_coef - s.t_bias            # (N,3)
    tc_max = torch.amin(t_corner, dim=1)

    # true child slot = mirrored idx flipped on the mirrored axes
    child_shift = s.idx ^ s.octant_mask ^ 7
    child_valid = ((vm >> child_shift) & 1) != 0
    can = child_valid & (s.t_min <= s.t_max) & active

    tv_max = torch.minimum(s.t_max, tc_max)
    half = s.scale_exp2 * 0.5
    t_center = half[:, None] * s.t_coef + t_corner

    enter = can & (s.t_min <= tv_max)
    below = (torch.ones_like(child_shift) << child_shift) - 1
    leaf_bit = ((lm >> child_shift) & 1) != 0

    # ---- leaf hit ----
    hit_now = enter & leaf_bit
    leaf_rank = popc8(vm & lm & below)
    hit_leaf = torch.where(hit_now, leaf_base[s.parent.long()] + leaf_rank,
                           s.hit_leaf)
    hit_t = torch.where(hit_now, s.t_min, s.hit_t)
    hit_parent = torch.where(hit_now, s.parent, s.hit_parent)
    hit_child = torch.where(hit_now, child_shift, s.hit_child)
    done = s.done | hit_now

    # ---- PUSH ----
    push = enter & ~leaf_bit
    slot = torch.clamp(s.scale - s0, 0, depth - 1).long()[None]
    write = push & (tc_max < s.h)
    stack_node = s.stack_node.scatter(
        0, slot, torch.where(write, s.parent, s.stack_node.gather(0, slot)[0])[None])
    stack_tmax = s.stack_tmax.scatter(
        0, slot, torch.where(write, s.t_max, s.stack_tmax.gather(0, slot)[0])[None])
    h = torch.where(push, tc_max, s.h)

    node_rank = popc8(vm & ~lm & below)
    parent = torch.where(push, child_base[s.parent.long()] + node_rank, s.parent)

    upper = t_center > s.t_min[:, None]
    idx_descend = _bits(upper)
    pos_descend = s.pos + torch.where(upper, half[:, None], 0.0)

    idx = torch.where(push, idx_descend, s.idx)
    pos = torch.where(push[:, None], pos_descend, s.pos)
    scale = torch.where(push, s.scale - 1, s.scale)
    scale_exp2 = torch.where(push, half, s.scale_exp2)
    t_max = torch.where(push, tv_max, s.t_max)

    # ---- ADVANCE ----
    adv = active & ~push & ~hit_now
    step_bits = t_corner <= tc_max[:, None]
    step_mask = _bits(step_bits)
    pos_adv = pos - torch.where(step_bits & adv[:, None], scale_exp2[:, None], 0.0)
    t_min = torch.where(adv, torch.maximum(s.t_min, tc_max), s.t_min)
    idx_adv = torch.where(adv, idx ^ step_mask, idx)
    pos = torch.where(adv[:, None], pos_adv, pos)

    # ---- POP ----
    pop = adv & ((idx_adv & step_mask) != 0)
    xor_bits = torch.where(step_bits, _f2i(pos) ^ _f2i(pos + scale_exp2[:, None]), 0)
    # the stepped axes' bits are ORed, as ESVO and the Pallas kernel do (the
    # numpy oracle sums them, which carries when two axes step at once with
    # equal bits and pops too far); |1 keeps the f32 cast well-defined
    differing = xor_bits[:, 0] | xor_bits[:, 1] | xor_bits[:, 2] | 1
    new_scale = (_f2i(differing.to(_F32)) >> 23) - 127
    oob = pop & ((new_scale >= S_MAX) | (new_scale < s0))
    pop_ok = pop & ~oob
    done = done | oob

    scale = torch.where(pop_ok, new_scale, scale)
    scale_exp2 = torch.where(
        pop_ok, _i2f((torch.clamp(new_scale, s0, S_MAX - 1) - S_MAX + 127) << 23),
        scale_exp2)
    slot = torch.clamp(scale - s0, 0, depth - 1).long()[None]
    parent = torch.where(pop_ok, stack_node.gather(0, slot)[0], parent)
    t_max = torch.where(pop_ok, stack_tmax.gather(0, slot)[0], t_max)

    shift = torch.clamp(scale, 0, 31)[:, None]
    sh = _f2i(pos) >> shift
    pos = torch.where(pop_ok[:, None], _i2f(sh << shift), pos)
    idx = torch.where(
        pop_ok, (sh[:, 0] & 1) | ((sh[:, 1] & 1) << 1) | ((sh[:, 2] & 1) << 2),
        idx_adv)
    h = torch.where(pop_ok, 0.0, h)

    return TraceState(
        pos=pos, idx=idx, parent=parent, scale=scale, scale_exp2=scale_exp2,
        t_min=t_min, t_max=t_max, h=h, octant_mask=s.octant_mask,
        t_coef=s.t_coef, t_bias=s.t_bias, done=done, hit_leaf=hit_leaf,
        hit_t=hit_t, hit_parent=hit_parent, hit_child=hit_child,
        stack_node=stack_node, stack_tmax=stack_tmax,
        iters=s.iters + active.to(_I32),
    )


def trace(svo, origin, direction, root=None) -> TraceResult:
    """Trace (N, 3) float32 rays through `svo` (tensors on one device);
    loops until every ray is done or the trip bound is reached. `root`: the
    rays' root rows (``init_state``)."""
    st = init_state(origin, direction, svo.depth, root)
    for _ in range(max_iters_for_depth(svo.depth)):
        if bool(torch.all(st.done)):
            break
        st = step(st, svo.masks, svo.child_base, svo.leaf_base, svo.depth)
    return TraceResult(st.hit_leaf, st.hit_t, st.hit_parent, st.hit_child,
                       st.iters)


# ---------------------------------------------------------------------------
# the stackless walk (the reference's XLA path, `_fast_step` / `_trace_core`)
# ---------------------------------------------------------------------------

# columns of the optional per-ray statistics of `trace_stackless` and
# ``brick.trace_brick``: rounds begun, DDA steps (top steps = iters - DDA
# steps), rounds whose top walk stopped at the round's step cap, the most DDA
# steps in one round, and 1 where a bound stopped a ray that was still walking
STAT_NAMES = ("rounds", "dda_steps", "top_capped", "dda_max", "unfinished")


def derive_parent_ptr(masks, child_base):
    """Each node row's parent row (the root at itself) from the raw arrays,
    in tensor operations on their device: each parent's row is scattered at
    its child block's start and forward-filled by a running maximum (child
    blocks are contiguous and ordered by parent row). Counterpart of
    ``derive_parent_ptr_jnp``; ``octree.compute_parent_ptr`` is the host
    form."""
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    has = (vm & ~lm) != 0
    iota = torch.arange(n, dtype=_I32, device=masks.device)
    seed = torch.zeros(n, dtype=_I32, device=masks.device).scatter_reduce(
        0, torch.where(has, child_base, 0).long(), torch.where(has, iota, 0),
        "amax")
    return torch.cummax(seed, dim=0).values


def _tree_cache(svo):
    """The tables kept for the tree object `svo` (a dict, empty when new):
    they live on the object, so another tree, a copy made by ``to()`` or
    ``dataclasses.replace`` among them, never sees them, and they are made
    again when a tensor they come from was changed in place (its version
    counter moved). An object that takes no attribute keeps nothing."""
    key = tuple((t, None if t is None else t._version)
                for t in (svo.masks, svo.child_base, svo.leaf_base, svo.parent_ptr))
    cache = getattr(svo, "_tree_tables", None)
    if cache is not None and len(cache[0]) == len(key) and all(
            a is b and va == vb for (a, va), (b, vb) in zip(cache[0], key)):
        return cache[1]
    tables = {}
    try:
        object.__setattr__(svo, "_tree_tables", (key, tables))
    except AttributeError:
        pass
    return tables


def parent_ptr_of(svo):
    """``svo.parent_ptr``; for an SVO built without one, derived on its
    device once and kept with the tree (``_tree_cache``)."""
    if svo.parent_ptr is not None:
        return svo.parent_ptr
    tables = _tree_cache(svo)
    if "parent_ptr" not in tables:
        tables["parent_ptr"] = derive_parent_ptr(svo.masks, svo.child_base)
    return tables["parent_ptr"]


def node_rows(svo):
    """The stackless walk's node row table of `svo`: (n_nodes, 4) int32 on
    its device, each row's masks, child_base, parent_ptr and leaf_base,
    made once a tree and kept with it (``_tree_cache``). The stackless
    kernels' patched form reads a row as one 16-byte load; the plain walks
    gather their rows from it."""
    tables = _tree_cache(svo)
    if "rows" not in tables:
        tables["rows"] = torch.stack([svo.masks, svo.child_base, parent_ptr_of(svo),
                                      svo.leaf_base], dim=1)
    return tables["rows"]


def walk_state(origin, direction, depth, root=None):
    """The stackless walk's per-ray registers after cube entry (a dict of
    tensors): ``init_state`` without the stack, each ray at its `root` row
    (None: row 0)."""
    s = init_state(origin, direction, depth, root)
    return dict(pos=s.pos, idx=s.idx, parent=s.parent, scale=s.scale,
                t_min=s.t_min, octant_mask=s.octant_mask, t_coef=s.t_coef,
                t_bias=s.t_bias, done=s.done, popped=torch.zeros_like(s.done),
                hit_parent=s.hit_parent, hit_child=s.hit_child, hit_t=s.hit_t,
                iters=s.iters)


def fast_step(st, nodes, park=False, k=0, lod=None):
    """One step of the stackless walk on the rays of `st` that are walking
    (not done; with `park`, not parked either). Counterpart of
    ``_fast_step`` (with `park`, of ``brick._top_step``; with `k`, of the
    step of ``_trace_multi_core``). `nodes` (n, 3) or (n, 4)
    int32 holds each row's (masks, child_base, parent_ptr), and with `k` a
    fourth column, leaf_base (``node_rows``). Returns a new dict.

    One row a step; no stack: the parent's exit t comes from `pos` rounded
    up to the parent's grid, and POP climbs one level through parent_ptr.
    `popped` marks a ray that climbed on its last step, whose current child
    is the one it just left: it may not enter it again. Entering a leaf
    child is a hit (the parent and the unmirrored slot are recorded); with
    `park`, it parks the ray at brick ``child_base + leaf rank``; with `k`
    (collect mode), it records the segment (leaf, t_min, min(t_max,
    tc_max)) in slot `count` of (N, k) `hits_leaf`, `t_in`, `t_out`, and the
    ray ADVANCEs in the same step unless it now holds k segments, which
    ends it.

    `lod` (LOD mode, not with `k`): (coef, bias) float32 0-dim tensors, and
    with `park` the top tree's row count n_top. A child is small when the
    ray's footprint there, tc_max * coef + bias (a multiply, then an add),
    is at least its size 2 * half. Entering a small non-leaf child ends the
    ray at t_min with `hit_node` = that child's row (the parent and slot
    recorded as for a leaf, without `park`); with `park`, entering a small
    brick ends it with `hit_node` = n_top + the brick's id and `hit_t` =
    t_min, and a small child is never pushed nor parked at."""
    if lod is not None and k:
        raise ValueError("the LOD walk has no collect mode")
    walking = ~st["done"] & ~st["parked"] if park else ~st["done"]
    nd = nodes[st["parent"].long()]
    desc, cbase, pptr = nd[:, 0], nd[:, 1], nd[:, 2]
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF

    scale = st["scale"]
    scale_exp2 = _i2f((scale - S_MAX + 127) << 23)  # 2^(scale - S_MAX)
    pos, t_coef, t_bias, t_min = st["pos"], st["t_coef"], st["t_bias"], st["t_min"]
    t_corner = pos * t_coef - t_bias
    tc_max = torch.amin(t_corner, dim=1)

    # the parent cube's exit t: pos rounded up to the parent's grid, the
    # least of its corner planes' t, clipped by the root's exit
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
    full = small = None
    node_rank = popc8(vm & ~lm & below)
    if lod is not None:
        big = tc_max * lod[0] + lod[1] >= half * 2.0
        small = enter & ~leaf_bit & big
        out["hit_node"] = torch.where(small, cbase + node_rank, st["hit_node"])
    if park:
        leaf_rank = popc8(vm & lm & below)
        park_now, done = leaf_now, st["done"]
        if lod is not None:
            small_brick = leaf_now & big
            park_now = leaf_now & ~big
            out["hit_node"] = torch.where(small_brick, lod[2] + cbase + leaf_rank,
                                          out["hit_node"])
            out["hit_t"] = torch.where(small | small_brick, t_min, st["hit_t"])
            done = done | small | small_brick
        out["brick_id"] = torch.where(park_now, cbase + leaf_rank, st["brick_id"])
        out["parked"] = st["parked"] | park_now
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
        stop = leaf_now if small is None else leaf_now | small
        out["hit_parent"] = torch.where(stop, st["parent"], st["hit_parent"])
        out["hit_child"] = torch.where(stop, child_shift, st["hit_child"])
        out["hit_t"] = torch.where(stop, t_min, st["hit_t"])
        done = st["done"] | stop

    # ---- PUSH: descend into the entered non-leaf child ----
    push = enter & ~leaf_bit
    if small is not None:
        push = push & ~small
    parent = torch.where(push, cbase + node_rank, st["parent"])
    upper = half[:, None] * t_coef + t_corner > t_min[:, None]
    idx = torch.where(push, _bits(upper), st["idx"])
    pos = torch.where(push[:, None], pos + torch.where(upper, half[:, None], 0.0), pos)
    scale = torch.where(push, scale - 1, scale)

    # ---- ADVANCE: step to the sibling, or POP one level (in collect mode
    # a ray that recorded a segment advances too, unless it is full) ----
    adv = walking & ~push & (~leaf_now if full is None else ~full)
    if small is not None:
        adv = adv & ~small
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


def resolve_leaf(masks, leaf_base, hit_parent, hit_child):
    """Leaf rows of recorded hits (-1 where hit_parent < 0): the parent's
    first leaf plus the rank of the hit slot among its leaf children."""
    hit = hit_parent >= 0
    safe = torch.where(hit, hit_parent, 0).long()
    desc = masks[safe]
    vm = (desc >> 8) & 0xFF
    lm = desc & 0xFF
    below = (torch.ones_like(hit_child) << hit_child) - 1
    return torch.where(hit, leaf_base[safe] + popc8(vm & lm & below), -1)


class Compacted:
    """A walk's per-ray registers kept for the rays still walking only.

    ``state`` holds the walking rays' tensors and ``rays`` their ray ids;
    ``out`` the full-width outputs, which ``compact`` writes for the rays it
    drops (and ``finish`` for all). Which rays share a tensor never changes
    what a ray computes: every step is per ray."""

    def __init__(self, state, out_names):
        self.state = state
        self.rays = torch.arange(state["done"].shape[0], device=state["done"].device)
        self.out = {k: state[k].clone() for k in out_names}

    def compact(self, keep):
        """Write the outputs of the rays where `keep` is False, then drop
        them."""
        gone = self.rays[~keep]
        for k in self.out:
            self.out[k][gone] = self.state[k][~keep]
        self.state = {k: v[keep] for k, v in self.state.items()}
        self.rays = self.rays[keep]

    def finish(self):
        self.compact(torch.zeros_like(self.rays, dtype=torch.bool))
        return self.out


def trace_stackless(svo, origin, direction, with_stats=False, root=None):
    """Stackless trace of (N, 3) float32 rays through `svo`, any N: the
    plain version of the ``esvo_stackless`` kernel. Returns a TraceResult,
    or (TraceResult, stats (N, 5) int32; columns ``STAT_NAMES``) with
    `with_stats`. `root` (an int or (N,) int32) starts each ray's walk at
    that row instead of row 0, the reference's ``_trace_core(root=)``: a POP
    out of the root's cube ends the ray, so `svo` may be an arena of many
    trees.

    Every ray that has not finished takes one step an iteration, for at
    most ``max_iters_for_depth(depth)`` steps, which is the reference's
    bound on each ray exactly (its loop checks the batch's step count and
    steps every ray still walking)."""
    masks = svo.masks
    nodes = node_rows(svo)
    walk = Compacted(walk_state(origin, direction, svo.depth, root),
                     ("hit_parent", "hit_child", "hit_t", "iters", "done"))
    out = _walk(walk, nodes, max_iters_for_depth(svo.depth))
    hit_leaf = resolve_leaf(masks, svo.leaf_base, out["hit_parent"], out["hit_child"])
    res = TraceResult(hit_leaf, out["hit_t"], out["hit_parent"], out["hit_child"],
                      out["iters"])
    return (res, _unfinished_stats(out["done"])) if with_stats else res


def _walk(walk, nodes, n_steps, k=0, lod=None):
    """Step the rays of the Compacted `walk` that are walking, at most
    `n_steps` steps each (``fast_step``, in collect mode with `k`, in LOD
    mode with `lod`); returns the outputs."""
    for _ in range(n_steps):
        walking = ~walk.state["done"]
        n_walking = int(walking.sum())
        if n_walking == 0:
            break
        if 2 * n_walking < walking.shape[0]:
            walk.compact(walking)
        walk.state = fast_step(walk.state, nodes, k=k, lod=lod)
    return walk.finish()


def _unfinished_stats(done):
    """The statistics of a walk without rounds: zeros, and 1 in the
    `unfinished` column where a bound stopped a ray still walking."""
    stats = torch.zeros((done.shape[0], len(STAT_NAMES)), dtype=_I32,
                        device=done.device)
    stats[:, STAT_NAMES.index("unfinished")] = (~done).to(_I32)
    return stats


# ---------------------------------------------------------------------------
# the first k leaf segments of each ray (the reference's `_trace_multi_core`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiTraceResult:
    """Up to k ordered leaf segments a ray, for volumetric rendering."""

    hit_leaf: torch.Tensor  # int32 (N, k) leaf rows in t order, -1 padded
    t_in: torch.Tensor      # float32 (N, k) segment entry t, 0.0 padded
    t_out: torch.Tensor     # float32 (N, k) segment exit t, 0.0 padded
    count: torch.Tensor     # int32 (N,) segments found
    iters: torch.Tensor     # int32 (N,) steps taken


def multi_steps_for_depth(depth: int, k: int) -> int:
    """The k-segment walk's bound on each ray's steps (the reference's
    ``max_iters_for_depth(depth) + 8 * k``)."""
    return max_iters_for_depth(depth) + 8 * k


def multi_state(state, k):
    """`state` with the k-segment walk's slots added: (N, k) hits_leaf,
    t_in and t_out padded -1, 0.0, 0.0, and a count of 0."""
    n = state["done"].shape[0]
    device = state["done"].device
    return dict(state, count=torch.zeros(n, dtype=_I32, device=device),
                hits_leaf=torch.full((n, k), -1, dtype=_I32, device=device),
                t_in=torch.zeros((n, k), dtype=_F32, device=device),
                t_out=torch.zeros((n, k), dtype=_F32, device=device))


MULTI_OUTPUTS = ("hits_leaf", "t_in", "t_out", "count", "iters", "done")


def trace_multi(svo, origin, direction, k=4, with_stats=False):
    """The first `k` leaf segments of (N, 3) float32 rays through `svo`, any
    N: the plain version of the ``esvo_stackless_multi`` kernel and the
    counterpart of ``_trace_multi_core``. The stackless walk in collect
    mode: entering a leaf records (leaf, t_min, min(t_max, tc_max)) and the
    ray walks on; it ends with k segments or when it leaves the root.
    Returns a MultiTraceResult, or (MultiTraceResult, stats (N, 5) int32;
    columns ``STAT_NAMES``, all zero but `unfinished`) with `with_stats`.

    Each ray takes at most ``multi_steps_for_depth(depth, k)`` steps: the
    reference's loop checks that count for the batch and steps every ray
    still walking, and does not compact, so it is each ray's own bound."""
    if k < 1:
        raise ValueError(f"k = {k}: a ray keeps at least one segment")
    nodes = node_rows(svo)
    walk = Compacted(multi_state(walk_state(origin, direction, svo.depth), k),
                     MULTI_OUTPUTS)
    out = _walk(walk, nodes, multi_steps_for_depth(svo.depth, k), k=k)
    res = MultiTraceResult(out["hits_leaf"], out["t_in"], out["t_out"],
                           out["count"], out["iters"])
    return (res, _unfinished_stats(out["done"])) if with_stats else res


# ---------------------------------------------------------------------------
# the LOD walk (the reference's `_trace_lod_core`)
# ---------------------------------------------------------------------------

def lod_constants(coef, bias, device):
    """(coef, bias) as float32 0-dim tensors on `device`, each rounded once
    from the Python number, as ``jnp.float32`` rounds it."""
    return (torch.tensor(float(coef), dtype=_F32, device=device),
            torch.tensor(float(bias), dtype=_F32, device=device))


def trace_lod(svo, origin, direction, coef, bias=0.0, with_stats=False):
    """LOD trace of (N, 3) float32 rays through `svo`, any N: the plain
    version of the ``esvo_stackless_lod`` kernel and the counterpart of
    ``_trace_lod_core``. The stackless walk, but descent stops at a non-leaf
    child no larger than the ray's footprint t * coef + bias (octree-local
    units; for a pinhole camera coef is about 2 tan(fov / 2) / height): the
    ray ends there at t_min with `hit_node` that child's row, hit_parent and
    hit_child its parent and slot, and hit_leaf -1. Other rays end as in
    ``trace_stackless`` (hit_node -1). Returns a TraceResult, or
    (TraceResult, stats (N, 5) int32; all zero but `unfinished`) with
    `with_stats`. The bound is ``max_iters_for_depth(depth)`` steps a ray,
    the reference's."""
    masks = svo.masks
    nodes = node_rows(svo)
    st = walk_state(origin, direction, svo.depth)
    st["hit_node"] = torch.full_like(st["idx"], -1)
    walk = Compacted(st, ("hit_parent", "hit_child", "hit_t", "hit_node",
                          "iters", "done"))
    out = _walk(walk, nodes, max_iters_for_depth(svo.depth),
                lod=lod_constants(coef, bias, masks.device))
    leaf_parent = torch.where(out["hit_node"] >= 0, -1, out["hit_parent"])
    hit_leaf = resolve_leaf(masks, svo.leaf_base, leaf_parent, out["hit_child"])
    res = TraceResult(hit_leaf, out["hit_t"], out["hit_parent"], out["hit_child"],
                      out["iters"], out["hit_node"])
    return (res, _unfinished_stats(out["done"])) if with_stats else res
