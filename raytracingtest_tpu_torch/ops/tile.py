"""Tile-amortized traversal: frustum-shared structure walk + per-ray brick DDA.

Port of ``raytracingtest_tpu/ops/tile.py``. Rays are grouped into P-pixel
camera tiles (default 16x16):

  * phase 1 (``_candidates``): each tile's frustum (4 corner-ray planes)
    walks a dense occupancy-bit mip pyramid of the octree once, level by
    level, and keeps up to K brick candidates in conservative front-to-back
    order. Selection per level is one sort of a packed int32 key (quantised
    conservative t | morton code). For CUDA tensors this is the hand-written
    kernel behind ``tile_cuda.candidates``; its plain version is
    ``candidates_plain`` below.
  * phase 2 (the walker): every ray walks its tile's candidate list with its
    own cursor and runs the exact 8^3 brick DDA in each brick it enters;
    the hit's leaf id is resolved from one brick row. For CUDA tensors this
    is the hand-written kernel behind ``tile_cuda.tile_walk``; its plain
    version is ``walk_plain`` below.
  * every dropped candidate is accounted for: per-tile lower bounds on the t
    of anything dropped give an ``unresolved`` mask; ``trace_tile_fb``
    re-walks unresolved tiles with larger budgets and as sub-tiles, and
    ``trace_tile_exact`` re-traces what is left per ray.

Hits are bit-identical to the per-ray ESVO trace (``ops/traverse.py``) at
the sizes the tests run. The two are different algorithms, and on a frame of
a million rays a few tens part: rays that graze a voxel's corner, and rays on
which the per-ray walk runs into its step bound (chip_smoke.py referees them).

What differs from the reference, and why. Its walker is a lockstep
``while_loop`` over chunks of tiles with a ring buffer of candidates per
tile; the ring (`win`, `loads`, `skips`), the DDA unroll, the chunking
(`chunk_tiles`, `lane_budget`) and the trip backstop are scheduling for that
machine and change no hit, so none is an argument here: a GPU block per tile
runs on its own and waits for no other tile. uint32 words are int32 bit
patterns (see ``ops/brick.py``); sort keys stay int32.

The streamed world (``stream/clipmap.py``) traces stitched pyramids whose
bricks live at any rows of an arena: ``_trace_tile_fb(..., brickmap=)``
maps each candidate's morton-rank id through `brickmap` in all three
phase-1 calls, as the reference's does (``remap_ids``; on the card the
kernel's brickmap mode).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops.brick import (
    BRICK_LEVELS, BrickSVO, make_brick_svo, _expand_children, _host,
    _popcount32, _sel16, _words)
from raytracingtest_tpu_torch.ops.brick_dda import dda_step
from raytracingtest_tpu_torch.ops.traverse import TraceResult, ray_setup

_F32, _I32 = torch.float32, torch.int32
_SENTINEL = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# 3D Morton helpers (<= 10 bits/axis, x fastest: bit0=x, bit1=y, bit2=z, the
# traversal's child-index convention). They take numpy arrays, Python ints
# and int32 tensors alike.
# ---------------------------------------------------------------------------

def spread3_10(x):
    """Spread the low 10 bits of x to every 3rd bit position."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def compact3_10(x):
    """Inverse of spread3_10 (extract every 3rd bit)."""
    x = x & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton3(x, y, z):
    return spread3_10(x) | (spread3_10(y) << 1) | (spread3_10(z) << 2)


def unmorton3(code):
    return compact3_10(code), compact3_10(code >> 1), compact3_10(code >> 2)


def _popcount_np(v):
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


# ---------------------------------------------------------------------------
# TileSVO: occupancy-bit mip pyramid + brick table
# ---------------------------------------------------------------------------

def _pyr_layout(top_depth):
    """Static (offsets, total_words): level l in 1..top_depth has
    max(1, 8^l/32) words; bit m&31 of word off_l + (m>>5) is morton cell m."""
    offs = [0, 0]  # level 0 unused (root always occupied), level 1 at 0
    words = 0
    for l in range(1, top_depth + 1):
        if l > 1:
            offs.append(offs[-1])
        offs[l] = words
        words += max(1, (8 ** l) // 32)
    return tuple(offs), words


@dataclasses.dataclass(frozen=True)
class TileSVO:
    """Brick SVO + dense occupancy pyramid for the tile traversal.

    pyr: int32 [n_words], the uint32 words' bit patterns: concatenated
    per-level morton occupancy bits (levels 1..top_depth; see _pyr_layout).
    cellmap: int32 [W_top, 2], per finest-level word: (prefix popcount of
    occupied cells before this word, the word itself); brick id of occupied
    cell m = cellmap[m>>5,0] + popcount(cellmap[m>>5,1] & below-bits), valid
    because ``build_svo`` lays level nodes out in global morton order."""

    bsvo: BrickSVO
    pyr: torch.Tensor       # int32 [n_words]
    cellmap: torch.Tensor   # int32 [W_top, 2]

    @property
    def depth(self):
        return self.bsvo.depth

    @property
    def top_depth(self):
        return self.bsvo.top_depth

    def to(self, device=None) -> "TileSVO":
        """Copy with every tensor on `device` (None: the default device)."""
        device = resolve(device)
        return TileSVO(bsvo=self.bsvo.to(device), pyr=self.pyr.to(device),
                       cellmap=self.cellmap.to(device))


def make_tile_svo(svo, bsvo: BrickSVO | None = None) -> TileSVO:
    """Host-side pyramid build from a packed SVO. Runs in numpy; the
    result's tensors lie on the CPU (move them with ``.to()``)."""
    if bsvo is None:
        bsvo = make_brick_svo(svo)
    top_depth = bsvo.top_depth
    if top_depth > 10:
        raise ValueError("tile path supports top_depth <= 10 (depth <= 13)")
    masks = _host(svo.masks)
    child_base = _host(svo.child_base)
    offs, n_words = _pyr_layout(top_depth)
    pyr = np.zeros(n_words, np.uint32)

    rows = np.zeros(1, np.int64)
    coords = np.zeros((1, 3), np.int64)
    for l in range(1, top_depth + 1):
        rows, pidx, slots = _expand_children(masks, child_base, rows)
        coords = coords[pidx] * 2 + np.stack(
            [slots & 1, (slots >> 1) & 1, (slots >> 2) & 1], axis=1)
        m = morton3(coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64),
                    coords[:, 2].astype(np.int64))
        # children emerge sorted by (parent-rank, slot) == sorted morton
        np.bitwise_or.at(pyr, offs[l] + (m >> 5),
                         np.uint32(1) << (m & 31).astype(np.uint32))

    # finest level: brick id == morton rank among occupied cells (the
    # parent-major slot-order layout of ``build_svo`` is global morton order)
    w_top = pyr[offs[top_depth]:]
    pc = _popcount_np(w_top)
    prefix = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
    assert int(pc.sum()) == bsvo.n_bricks or bsvo.n_bricks == 1, (
        "pyramid occupancy disagrees with brick count")
    cellmap = np.stack([prefix, w_top.astype(np.int32)], axis=1)
    return TileSVO(bsvo=bsvo, pyr=_words(pyr),
                   cellmap=torch.from_numpy(np.ascontiguousarray(cellmap)))


# ---------------------------------------------------------------------------
# camera tiling
# ---------------------------------------------------------------------------

def tile_rays(cam, device=None, tile_px=16, jitter=None):
    """Tile-major rays for a pinhole camera on `device` (None: the default
    device): (T, P, 3) origins/directions, (T, 4, 3) corner directions (tile
    pixel-boundary corners, cyclic order), and the (tiles_y, tiles_x) grid
    shape. flat_index = tile * P + p maps back to row-major pixels via
    untile_image()."""
    device = resolve(device)
    H, W = cam.height, cam.width
    if H % tile_px or W % tile_px:
        raise ValueError(f"resolution {W}x{H} not divisible by tile {tile_px}")
    if cam.ortho_height > 0.0:
        raise ValueError("tile path is pinhole-only")
    o, d = cam.rays(device, jitter=jitter)
    ty, tx = H // tile_px, W // tile_px

    def regroup(x):
        x = x.reshape(ty, tile_px, tx, tile_px, 3).permute(0, 2, 1, 3, 4)
        return x.reshape(ty * tx, tile_px * tile_px, 3)

    # corner directions at pixel boundaries (jitter stays inside [0,1) px),
    # in float32 numpy arithmetic on the host as the reference computes them
    _pos, fwd, right, up = (v.numpy() for v in cam.basis("cpu"))
    tan_half = float(np.tan(np.radians(cam.fov_y_deg) * 0.5))
    aspect = W / H
    iy = np.arange(ty + 1, dtype=np.float32) * tile_px
    jx = np.arange(tx + 1, dtype=np.float32) * tile_px
    u = jx / W * 2.0 - 1.0
    v = 1.0 - iy / H * 2.0
    cdir = (fwd[None, None] + right[None, None] * (u[None, :, None] * aspect * tan_half)
            + up[None, None] * (v[:, None, None] * tan_half))  # (ty+1, tx+1, 3)
    corners = np.stack([
        cdir[:-1, :-1], cdir[:-1, 1:], cdir[1:, 1:], cdir[1:, :-1],
    ], axis=2).reshape(ty * tx, 4, 3).astype(np.float32)
    return (regroup(o), regroup(d), torch.from_numpy(corners).to(device),
            (ty, tx))


def tile_pixels(img_flat, grid, tile_px=16):
    """Row-major pixels -> tile-major ray order (inverse of untile_image)."""
    ty, tx = grid
    c = tuple(img_flat.shape[1:])
    x = img_flat.reshape(ty, tile_px, tx, tile_px, *c)
    x = x.permute(0, 2, 1, 3, *range(4, x.dim()))
    return x.reshape(ty * tx * tile_px * tile_px, *c)


def untile_image(img_flat, grid, tile_px=16):
    """Inverse of tile_rays' pixel ordering: (T*P, C) -> (H*W, C)."""
    ty, tx = grid
    c = tuple(img_flat.shape[-1:]) if img_flat.dim() > 1 else ()
    x = img_flat.reshape(ty, tx, tile_px, tile_px, *c)
    x = x.permute(0, 2, 1, 3, *range(4, x.dim()))
    return x.reshape(ty * tile_px * tx * tile_px, *c)


# ---------------------------------------------------------------------------
# phase 1: frustum candidate selection over the pyramid
# ---------------------------------------------------------------------------

def _frustum_planes(corners, apex):
    """(T,4,3) corner dirs -> (T,4,3) inward plane normals through apex."""
    a = corners
    b = torch.roll(corners, -1, dims=1)
    nrm = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                       a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                       a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)
    center = (corners[:, 0] + corners[:, 1] + corners[:, 2]
              + corners[:, 3])[:, None]
    dot = nrm * center
    sgn = torch.sign(dot[..., 0] + dot[..., 1] + dot[..., 2])[..., None]
    return nrm * torch.where(sgn == 0, 1.0, sgn)


def _candidates(pyr, cellmap, corners, apex, top_depth, caps, k_max,
                brickmap=None):
    """Per-tile brick candidates (see ``candidates_plain``), their ids
    mapped through `brickmap` when one is given (``remap_ids``). The kernel
    runs for CUDA tensors, the plain version for CPU tensors."""
    if corners.device.type == "cpu":
        codes, ids, t_codes, drop_t = candidates_plain(
            pyr, cellmap, corners, apex, top_depth, caps, k_max)
        if brickmap is not None:
            ids = remap_ids(ids, brickmap)
        return codes, ids, t_codes, drop_t
    from raytracingtest_tpu_torch.ops import tile_cuda

    return tile_cuda.candidates(pyr, cellmap, corners, apex, top_depth, caps,
                                k_max, brickmap=brickmap)


def remap_ids(ids, brickmap):
    """Candidate ids (morton ranks of a pyramid's occupied cells, -1 for
    none) as rows of a streaming arena's bricks: brickmap[id], -1 kept."""
    return torch.where(ids >= 0, brickmap[torch.clamp(ids, min=0).long()], -1)


def candidates_plain(pyr, cellmap, corners, apex, top_depth, caps, k_max):
    """Phase 1 in tensor ops: what ``tile_cuda.candidates``'s kernel
    computes, tile for tile. Per-tile brick candidates. Returns (codes (T,K),
    brick_ids (T,K), t_lb (T,K), a conservative per-tile lower bound on any
    ray's entry t, ascending) and drop_t (T,), a lower bound on the t of
    anything dropped (inf when nothing was dropped)."""
    T = corners.shape[0]
    dev = corners.device
    planes = _frustum_planes(corners, apex)           # (T,4,3)
    fwd = (corners[:, 0] + corners[:, 1] + corners[:, 2]
           + corners[:, 3])                           # (T,3) central dir
    apex = apex.to(_F32)
    offs = _pyr_layout(top_depth)[0]
    inf = float("inf")

    codes = torch.zeros((T, 1), dtype=_I32, device=dev)   # level-0 root
    t_codes = torch.zeros((T, 1), dtype=_F32, device=dev)
    drop_t = torch.full((T,), inf, dtype=_F32, device=dev)
    oct1 = torch.arange(8, dtype=_I32, device=dev)

    for l in range(1, top_depth + 1):
        c_prev = codes.shape[1]
        valid_p = codes >= 0
        safe = torch.where(valid_p, codes, 0)
        # one word holds all 8 children's occupancy bits
        word = pyr[(offs[l] + (safe >> 2)).long()]    # (T,C) int32 bits
        rep8 = lambda x: x.repeat_interleave(8, dim=1)   # (T,C) -> (T,W)
        oct8 = oct1.repeat(c_prev)[None, :]           # (1,W)
        child = rep8(safe * 8) + oct8                 # (T,W)
        shift = rep8((safe & 3) << 3) + oct8
        occ = ((rep8(word) >> shift) & 1) != 0
        occ = occ & rep8(valid_p)

        cx, cy, cz = unmorton3(child)
        half = 2.0 ** -(l + 1)
        cell = 2.0 ** -l
        rx = (cx.to(_F32) * cell + half) - apex[0]
        ry = (cy.to(_F32) * cell + half) - apex[1]
        rz = (cz.to(_F32) * cell + half) - apex[2]

        # 4 frustum side planes: outside iff dist(center) + r < 0
        pa = planes.abs()
        pr = (pa[..., 0] + pa[..., 1] + pa[..., 2]) * half   # (T,4)
        in_frustum = occ
        for p in range(4):
            pd = (planes[:, p, 0, None] * rx + planes[:, p, 1, None] * ry
                  + planes[:, p, 2, None] * rz)
            in_frustum = in_frustum & (pd + pr[:, p, None] >= 0)
        # view half-space: box entirely behind apex is out
        fd = (fwd[:, 0, None] * rx + fwd[:, 1, None] * ry
              + fwd[:, 2, None] * rz)
        fa = fwd.abs()
        fr = (fa[:, 0] + fa[:, 1] + fa[:, 2])[:, None] * half
        keep = in_frustum & (fd + fr >= 0)

        # conservative entry-t lower bound: euclidean distance from the
        # apex to the box (per-ray entry t >= distance since |d| = 1). The
        # float32 sqrt is taken in float64 and rounded: that is the
        # correctly rounded result on every device, and t_lb is quantised
        # into the sort key below
        ax = torch.clamp(rx.abs() - half, min=0.0)
        ay = torch.clamp(ry.abs() - half, min=0.0)
        az = torch.clamp(rz.abs() - half, min=0.0)
        t_lb = torch.sqrt((ax * ax + ay * ay + az * az).double()).to(_F32)

        # pack (quantized t | morton code) and sort: compaction + ordering.
        # The product is clipped to 2^30 before the cast (every key field
        # is narrower), so the cast never sees a value outside int32
        code_bits = 3 * l
        qbits = max(0, 30 - code_bits)
        qmax = (1 << qbits) - 2 if qbits else 0
        scaled = torch.clamp(t_lb * ((1 << qbits) / 4.0), max=float(2 ** 30))
        q = torch.clamp(scaled.to(_I32), 0, qmax)
        val = torch.where(keep, (q << code_bits) | child, _SENTINEL)
        val = torch.sort(val, dim=1).values

        cap = min(caps[l] if l < len(caps) else caps[-1], 8 ** l)
        if l == top_depth:
            cap = min(k_max, 8 ** l)
        kept = val[:, :cap]
        if cap < c_prev * 8:
            # anything beyond the cap is dropped: record its t lower bound
            nxt = val[:, cap]
            t_drop = (nxt >> code_bits).to(_F32) * (4.0 / (1 << qbits))
            drop_t = torch.minimum(
                drop_t, torch.where(nxt != _SENTINEL, t_drop, inf))
        codes = torch.where(kept == _SENTINEL, -1,
                            kept & ((1 << code_bits) - 1))
        t_codes = torch.where(kept == _SENTINEL, inf,
                              (kept >> code_bits).to(_F32)
                              * (4.0 / (1 << qbits)))

    # pad to k_max columns (small trees can produce fewer candidates)
    if codes.shape[1] < k_max:
        padw = k_max - codes.shape[1]
        codes = torch.cat(
            [codes, torch.full((T, padw), -1, dtype=_I32, device=dev)], dim=1)
        t_codes = torch.cat(
            [t_codes, torch.full((T, padw), inf, dtype=_F32, device=dev)],
            dim=1)

    # finest level: map codes -> brick ids via morton-rank prefix popcount
    valid = codes >= 0
    safe = torch.where(valid, codes, 0)
    pw = cellmap[(safe >> 5).long()]                   # (T,K,2)
    below = ~(torch.full_like(safe, -1) << (safe & 31))
    rank = _popcount32(pw[..., 1] & below)
    ids = torch.where(valid, pw[..., 0] + rank, -1)
    return codes, ids, t_codes, drop_t


# ---------------------------------------------------------------------------
# phase 2: per-ray candidate walk, plain version
# ---------------------------------------------------------------------------

def _mirrored_brick_corner(code, om, top_depth):
    """Mirrored [1,2]-space lower corner of a brick cell. code (...,) int32,
    om (...,) per-ray octant mask; returns (..., 3) f32 (exact dyadic)."""
    s = (1 << top_depth) - 1
    c = torch.stack(unmorton3(code), dim=-1)
    om_bits = torch.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], dim=-1)
    m = torch.where(om_bits == 1, c, s - c)
    return 1.0 + m.to(_F32) * (2.0 ** -top_depth)


def _resolve_hits(hit_bid, hit_idx9, hit_t, bricks):
    """Leaf ids of the walk's hits: one brick row per ray, the popcount of
    the words below the hit's word plus the bits below it in that word.
    hit_bid < 0 marks a miss (hit_leaf -1, hit_t 0)."""
    hit = hit_bid >= 0
    brow = bricks[torch.clamp(hit_bid, min=0).long()]            # (N,17)
    words = brow[:, :16]
    bleaf = brow[:, 16]
    wsel = hit_idx9 >> 5
    bitpos = hit_idx9 & 31
    w = _sel16(words, wsel)
    pc = _popcount32(words)
    word_iota = torch.arange(16, dtype=_I32, device=bricks.device)[None, :]
    full = torch.sum(torch.where(word_iota < wsel[:, None], pc, 0), dim=1,
                     dtype=_I32)
    partial = _popcount32(w & ~(torch.full_like(w, -1) << bitpos))
    leaf = bleaf + full + partial
    return torch.where(hit, leaf, -1), torch.where(hit, hit_t, 0.0)


def walk_plain(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """The tile walker in tensor ops: what ``tile_cuda.tile_walk``'s kernel
    computes, ray for ray. o/d (T,P,3) f32; codes/ids (T,K) int32 and
    t_codes (T,K) f32, the tiles' candidate lists, t ascending; bricks
    (n_bricks,17) int32. Returns (hit_leaf int32, hit_t f32, iters int32),
    each (T,P).

    Each ray walks its tile's list with its own cursor k. It is finished
    when k == K, ids[k] < 0, or t_codes[k] >= its best hit so far. Else it
    tests candidate k's box: on a miss the cursor moves on; on entry a
    three-level plane descent finds the entry voxel and the exact DDA runs
    to a hit or to the brick's exit, and the cursor moves on. A later
    candidate may hold a nearer hit, so the walk goes on after a hit until
    the finish test stops it. `iters` counts DDA steps. Every trip of the
    loop below gives each unfinished ray one candidate test (if it is
    between bricks) and one DDA step (if it is inside one)."""
    T, P = o.shape[0], o.shape[1]
    K = ids.shape[1]
    n = T * P
    dev = o.device
    t_coef, t_bias, om, t0, t_max = ray_setup(o.reshape(n, 3), d.reshape(n, 3))
    bsize = 2.0 ** -top_depth
    om_bits = torch.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], dim=-1)
    flip = torch.where(om_bits == 1, 0, 7).to(_I32)
    base = (torch.arange(n, device=dev) // P) * K       # int64 row offsets
    ids_f, codes_f, tlb_f = ids.reshape(-1), codes.reshape(-1), t_codes.reshape(-1)
    bricks_f = bricks.reshape(-1)

    zi = torch.zeros(n, dtype=_I32, device=dev)
    k = zi.clone()
    fin = t0 >= t_max                                   # never entered the root cube
    walking = torch.zeros(n, dtype=torch.bool, device=dev)
    bpos = torch.ones((n, 3), dtype=_F32, device=dev)
    t_cur = torch.zeros(n, dtype=_F32, device=dev)
    cur_bid = zi - 1
    hit_bid, hit_idx9, iters = zi - 1, zi.clone(), zi.clone()
    hit_t = torch.full((n,), float("inf"), dtype=_F32, device=dev)
    word_of = lambda wsel: bricks_f[torch.clamp(cur_bid, min=0).long() * 17
                                    + wsel.long()]

    # a brick's DDA takes at most 3*7+1 steps, so the loop is bounded
    for _ in range(K * (3 * 7 + 2) + 1):
        if bool(torch.all(fin)):
            break
        # ---- candidate test for rays between bricks ----
        scan = ~fin & ~walking
        j = base + torch.clamp(k, max=K - 1).long()
        id_k, code_k, tlb_k = ids_f[j], codes_f[j], tlb_f[j]
        fin_now = scan & ((k >= K) | (id_k < 0) | (tlb_k >= hit_t))
        fin = fin | fin_now
        try_init = scan & ~fin_now

        pos_b = _mirrored_brick_corner(code_k, om, top_depth)
        t_hi = (pos_b + bsize) * t_coef - t_bias
        t_lo = pos_b * t_coef - t_bias
        t_in = torch.maximum(torch.amax(t_hi, dim=1), t0)
        t_out = torch.amin(t_lo, dim=1)
        enter = try_init & (t_in < t_out) & (t_in < hit_t)
        k = k + (try_init & ~enter).to(_I32)

        # entry: 3-level ESVO plane descent to the entry voxel
        nbpos = pos_b
        for l in range(1, BRICK_LEVELS + 1):
            half = bsize * 2.0 ** -l
            t_center = half * t_coef + (nbpos * t_coef - t_bias)
            nbpos = nbpos + torch.where(t_center > t_in[:, None], half, 0.0)
        bpos = torch.where(enter[:, None], nbpos, bpos)
        t_cur = torch.where(enter, t_in, t_cur)
        cur_bid = torch.where(enter, id_k, cur_bid)
        walking = walking | enter

        # ---- one exact DDA step for rays inside a brick ----
        iters = iters + walking.to(_I32)
        bpos, t_cur, hit_now, exit_b, walking, idx9 = dda_step(
            bpos, t_cur, walking, hit_t, t_coef, t_bias, flip, word_of, depth)
        k = k + (hit_now | exit_b).to(_I32)
        hit_bid = torch.where(hit_now, cur_bid, hit_bid)
        hit_idx9 = torch.where(hit_now, idx9, hit_idx9)
        hit_t = torch.where(hit_now, t_cur, hit_t)

    hit_leaf, hit_t = _resolve_hits(hit_bid, hit_idx9, hit_t, bricks)
    return hit_leaf.reshape(T, P), hit_t.reshape(T, P), iters.reshape(T, P)


def _walk_tiles_chunk(bricks, o, d, codes, ids, t_codes, drop_t, *, depth,
                      top_depth, k_max):
    """Walk (T,P) rays through their tiles' candidate lists; returns
    (hit_leaf, hit_t, iters, unresolved), each (T,P). The walk is the CUDA
    kernel for CUDA tensors and ``walk_plain`` for CPU tensors."""
    from raytracingtest_tpu_torch.ops import tile_cuda

    T, P = o.shape[0], o.shape[1]
    assert ids.shape[1] == k_max, (ids.shape, k_max)
    hit_leaf, hit_t, iters = tile_cuda.tile_walk(
        bricks, o, d, codes, ids, t_codes, depth, top_depth)
    _c, _b, _om, t0, t_max = ray_setup(o.reshape(-1, 3), d.reshape(-1, 3))
    miss0 = (t0 >= t_max).reshape(T, P)   # never entered the root cube

    # the walk visits every candidate that could matter; the loss channel
    # left is per-level cap dropping, bounded by drop_t per tile
    hit_eff = torch.where(hit_leaf >= 0, hit_t, float("inf"))
    unresolved = (drop_t[:, None] < hit_eff) & ~miss0
    return hit_leaf, hit_t, iters, unresolved


def _walk_tiles_scheduled(bricks, o, d, codes, ids, t_codes, drop_t, *,
                          depth, top_depth, k_max):
    """The fallback walks' dispatch. The reference sorts tiles by candidate
    count and cuts them into chunks, because a chunk of its lockstep loop
    runs as long as its worst tile. On a GPU each tile is a block that
    waits for no other, so this is one launch over all the tiles; there is
    no chunking and no order to choose."""
    return _walk_tiles_chunk(bricks, o, d, codes, ids, t_codes, drop_t,
                             depth=depth, top_depth=top_depth, k_max=k_max)


def _default_caps(top_depth, k_max):
    """Per-level candidate caps (level-indexed; clipped to 8^l and to k_max
    at the finest level). Ramp: coarse levels are cheap to keep small, the
    finest carries the real list."""
    caps = [1, 8]
    for l in range(2, top_depth + 1):
        caps.append(min(k_max, max(12, caps[-1] + caps[-1] // 2)))
    return tuple(caps)


def _trace_tile(pyr, cellmap, bricks, o, d, corners, apex, depth, top_depth,
                caps, k_max, brickmap=None):
    T, P = o.shape[0], o.shape[1]
    n = T * P
    codes, ids, t_codes, drop_t = _candidates(pyr, cellmap, corners, apex,
                                              top_depth, caps, k_max, brickmap)
    hit_leaf, hit_t, iters, unresolved = _walk_tiles_chunk(
        bricks, o, d, codes, ids, t_codes, drop_t, depth=depth,
        top_depth=top_depth, k_max=k_max)
    return TraceResult(
        hit_leaf.reshape(n), hit_t.reshape(n),
        torch.full((n,), -1, dtype=_I32, device=o.device),
        torch.zeros(n, dtype=_I32, device=o.device),
        iters.reshape(n)), unresolved.reshape(n)


def _rays(tsvo, o, d, corners):
    dev = tsvo.pyr.device
    for name, t in (("o", o), ("d", d), ("corners", corners)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the TileSVO on {dev}")
    return (o.to(_F32).contiguous(), d.to(_F32).contiguous(),
            corners.to(_F32).contiguous())


def trace_tile(tsvo: TileSVO, o, d, corners, k_max=48, caps=None):
    """Tile-amortized trace. o/d: (T, P, 3) tile-major rays (tile_rays),
    corners: (T, 4, 3). Returns (TraceResult (T*P,), unresolved (T*P,)).
    Resolved rays' hit_leaf / hit_t are bit-identical to the per-ray trace;
    the unresolved mask marks rays that must be re-traced exactly
    (trace_tile_exact does this)."""
    o, d, corners = _rays(tsvo, o, d, corners)
    caps = caps or _default_caps(tsvo.top_depth, k_max)
    return _trace_tile(tsvo.pyr, tsvo.cellmap, tsvo.bsvo.bricks, o, d,
                       corners, o[0, 0], tsvo.depth, tsvo.top_depth, caps,
                       k_max)


def _subtile_split(o_s, d_s, c_s, split):
    """Split (Ts, P, 3) tiles into (Ts*split^2, P/split^2, 3) sub-tiles.

    Camera ray directions are affine in pixel coordinates, so the sub-tile
    corner directions are exact bilinear interpolations of the parent
    tile's 4 pixel-boundary corners (cyclic order [tl, tr, br, bl] from
    tile_rays). Returns (o2, d2, corners2); sub-tile order is (sy, sx)
    row-major, within-sub pixels row-major (_subtile_merge inverts it)."""
    Ts, P = o_s.shape[0], o_s.shape[1]
    px = int(round(P ** 0.5))
    q = px // split
    if q * split != px or px * px != P:
        raise ValueError(f"{P} rays a tile do not split {split}x{split}")

    def regroup(x):
        x = x.reshape(Ts, split, q, split, q, 3)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(Ts * split * split, q * q, 3)

    o2, d2 = regroup(o_s), regroup(d_s)
    c00, c01, c11, c10 = (c_s[:, j] for j in range(4))
    f = torch.arange(split + 1, dtype=_F32, device=c_s.device) / split
    fy = f[:, None, None, None]
    fx = f[None, :, None, None]
    grid = (c00[None, None] * (1 - fx) * (1 - fy)
            + c01[None, None] * fx * (1 - fy)
            + c11[None, None] * fx * fy
            + c10[None, None] * (1 - fx) * fy)        # (s+1, s+1, Ts, 3)
    sub = torch.stack([grid[:-1, :-1], grid[:-1, 1:], grid[1:, 1:],
                       grid[1:, :-1]], dim=2)         # (s, s, 4, Ts, 3)
    c2 = sub.permute(3, 0, 1, 2, 4).reshape(Ts * split * split, 4, 3)
    return o2, d2, c2


def _subtile_merge(x, n_tiles, split, q):
    """Inverse of _subtile_split's ray regrouping: (Ts*s^2, q^2) -> (Ts, P)."""
    x = x.reshape(n_tiles, split, split, q, q)
    x = x.permute(0, 1, 3, 2, 4)
    return x.reshape(n_tiles, split * split * q * q)


def _fb2_caps(top_depth, fb_k):
    """Doubling ramp for the sub-tile re-walk: frustum volume is split^2
    smaller, so a generous-but-bounded ramp replaces the all-cells caps."""
    caps = [1]
    for l in range(1, top_depth + 1):
        caps.append(min(fb_k, 8 ** l, 8 << l))
    return tuple(caps)


def _unresolved_first(un, n_tiles):
    """Indices of the first `n_tiles` tiles with unresolved rays first (in
    tile order, a stable sort), and which of them really have any."""
    un_tile = torch.any(un, dim=1)
    order = torch.argsort((~un_tile).to(torch.int8), stable=True)
    sel = order[:n_tiles]
    return sel, un_tile[sel]


def _trace_tile_fb(pyr, cellmap, bricks, o, d, corners, apex, depth,
                   top_depth, caps, k_max, fb_tiles, fb_k, fb2_tiles=0,
                   fb2_split=2, brickmap=None):
    """trace_tile + enlarged-K tile re-walk fallback (+ optional sub-tile
    re-walk for cap-saturated tiles).

    Unresolved rays exist only because per-level candidate caps dropped a
    candidate whose conservative t could precede a ray's hit. They cluster
    in few (horizon-band) tiles, so the fb_tiles tiles that contain
    unresolved rays are re-walked with enlarged caps (fb_k candidates).
    When fb2_tiles > 0, the tiles still unresolved after that are split
    into fb2_split^2 sub-tiles (smaller frusta, shorter lists) and
    re-walked per sub-tile with exact bilinear sub-corners. The tile
    budgets are fixed numbers of tiles, walked whether or not that many are
    unresolved, so no step waits for a count from the device.

    `brickmap` (int32): the pyramid's bricks lie at rows brickmap[morton
    rank] of `bricks` (a streaming arena, ``stream/clipmap.py``); every
    phase-1 call maps its ids through it.

    Returns (TraceResult, residual mask): residual rays are those in
    unresolved tiles beyond the fb/fb2 tile budgets or still cap-limited
    after every pass."""
    T, P = o.shape[0], o.shape[1]
    fb_tiles = min(fb_tiles, T)
    res, unresolved = _trace_tile(pyr, cellmap, bricks, o, d, corners, apex,
                                  depth, top_depth, caps, k_max, brickmap)
    un = unresolved.reshape(T, P)
    hl = res.hit_leaf.reshape(T, P)
    ht = res.hit_t.reshape(T, P)

    if fb_tiles:
        sel_t, m_t = _unresolved_first(un, fb_tiles)
        # generous caps: the re-walk exists to undo cap-dropping, so every
        # level keeps up to fb_k candidates (clipped to the level's 8^l
        # cells)
        caps2 = tuple(min(fb_k, 8 ** l) for l in range(top_depth + 1))
        codes2, ids2, t2, drop2 = _candidates(
            pyr, cellmap, corners[sel_t].contiguous(), apex, top_depth, caps2,
            fb_k, brickmap)
        hit2, t_hit2, _it2, un2 = _walk_tiles_scheduled(
            bricks, o[sel_t], d[sel_t], codes2, ids2, t2, drop2, depth=depth,
            top_depth=top_depth, k_max=fb_k)
        rep = m_t[:, None]
        hl[sel_t] = torch.where(rep, hit2, hl[sel_t])
        ht[sel_t] = torch.where(rep, t_hit2, ht[sel_t])
        # after substitution `un` is the residual: re-walked tiles carry
        # their re-walk unresolved mask, uncovered tiles keep the original
        un[sel_t] = torch.where(rep, un2, un[sel_t])

    if fb2_tiles:
        fb2_tiles = min(fb2_tiles, T)
        sel2, m2 = _unresolved_first(un, fb2_tiles)
        o3, d3, c3 = _subtile_split(o[sel2], d[sel2], corners[sel2],
                                    fb2_split)
        caps3 = _fb2_caps(top_depth, fb_k)
        codes3, ids3, t3, drop3 = _candidates(pyr, cellmap, c3.contiguous(),
                                              apex, top_depth, caps3, fb_k,
                                              brickmap)
        hit3, t_hit3, _it3, un3 = _walk_tiles_scheduled(
            bricks, o3.contiguous(), d3.contiguous(), codes3, ids3, t3,
            drop3, depth=depth, top_depth=top_depth, k_max=fb_k)
        q = int(round(P ** 0.5)) // fb2_split
        hit3 = _subtile_merge(hit3, fb2_tiles, fb2_split, q)
        t_hit3 = _subtile_merge(t_hit3, fb2_tiles, fb2_split, q)
        un3 = _subtile_merge(un3, fb2_tiles, fb2_split, q)
        rep2 = m2[:, None]
        hl[sel2] = torch.where(rep2, hit3, hl[sel2])
        ht[sel2] = torch.where(rep2, t_hit3, ht[sel2])
        un[sel2] = torch.where(rep2, un3, un[sel2])

    return TraceResult(hl.reshape(T * P), ht.reshape(T * P),
                       res.hit_parent, res.hit_child, res.iters), \
        un.reshape(T * P)


def trace_tile_fb(tsvo: TileSVO, o, d, corners, k_max=64, caps=None,
                  fb_tiles=128, fb_k=256, fb2_tiles=0, fb2_split=2):
    """Tile trace with the enlarged-K tile re-walk fallback (+ sub-tile
    re-walk when fb2_tiles > 0). The residual mask is nonzero only when
    unresolved rays span more than the fb tile budgets or stay cap-limited
    after every pass."""
    o, d, corners = _rays(tsvo, o, d, corners)
    caps = caps or _default_caps(tsvo.top_depth, k_max)
    return _trace_tile_fb(
        tsvo.pyr, tsvo.cellmap, tsvo.bsvo.bricks, o, d, corners, o[0, 0],
        tsvo.depth, tsvo.top_depth, caps, k_max, fb_tiles, fb_k, fb2_tiles,
        fb2_split)


def trace_tile_exact(tsvo: TileSVO, svo, o, d, corners, k_max=48, caps=None,
                     fb_tiles=128, fb_k=256, fb2_tiles=32,
                     fb2_split=2) -> TraceResult:
    """Exact tile trace: the enlarged-K re-walk (then the sub-tile re-walk)
    resolves nearly all cap-dropped rays; any residual rays (rare) are
    re-traced by the per-ray ESVO trace (``traverse_cuda.trace_cuda``)
    through `svo`, the packed SVO that `tsvo` was made from, on the same
    device. The residual rays stay on the device; only their count is read
    by the host."""
    from raytracingtest_tpu_torch.ops import traverse_cuda

    res, unresolved = trace_tile_fb(tsvo, o, d, corners, k_max=k_max,
                                    caps=caps, fb_tiles=fb_tiles, fb_k=fb_k,
                                    fb2_tiles=fb2_tiles, fb2_split=fb2_split)
    idx = torch.nonzero(unresolved)[:, 0]
    if idx.shape[0] == 0:
        return res
    o_f = o.reshape(-1, 3).to(_F32)[idx].contiguous()
    d_f = d.reshape(-1, 3).to(_F32)[idx].contiguous()
    sub = traverse_cuda.trace_cuda(svo, o_f, d_f)
    hit_leaf = res.hit_leaf.clone()
    hit_t = res.hit_t.clone()
    hit_leaf[idx] = sub.hit_leaf
    hit_t[idx] = sub.hit_t
    return TraceResult(hit_leaf, hit_t, res.hit_parent, res.hit_child,
                       res.iters)
