"""The reference's SVO and its brick form, built from the scene alone.

Frozen copies at commit c4b99874d80592771fd0a8ae8a7eee3dc0040498 of the
port's host build (``ops/octree.py`` ``build_svo``, ``default_albedo``,
``sampler_normal``, ``compute_parent_ptr``), of its brick decomposition
(``ops/brick.py`` ``make_brick_svo``) and of the ``terrain`` scene's field
(``scenes.py`` ``_terrain`` over ``utils/noise.py``'s numpy ``fbm3``). The
build is numpy on the host, as the port's; the scene's field, the bulk of
its time, is evaluated in plain torch float32 operations on `device`, each
operation rounding as numpy's float32 operation does, so the field has
numpy's bits (the port's host build calls a threaded C++ twin of it, within
about an ULP). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

# the scene's constants (scenes.py, utils/noise.py)
NOISE_FREQ = 4.0
NOISE_AMP = 0.12
NOISE3_LIPSCHITZ = 4.0
CHUNK_POINTS = 1 << 23
BRICK_LEVELS = 3

_SQRT3 = float(np.sqrt(3.0))
CHILD_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], dtype=np.int32)


def fbm3_lipschitz(octaves=2, lacunarity=2.0, gain=0.5):
    total, amp, freq = 0.0, 1.0, 1.0
    for _ in range(octaves):
        total += amp * freq * NOISE3_LIPSCHITZ
        amp *= gain
        freq *= lacunarity
    return total


# the Lipschitz bound of each scene the benchmark builds
LIPSCHITZ = {"terrain": 1.0 + NOISE_AMP * NOISE_FREQ * fbm3_lipschitz(octaves=2)}


# ---------------------------------------------------------------------------
# the terrain field in torch (numpy's float32 arithmetic, operation for
# operation; uint32 words carried in int64)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors `a` in [0, 2**32) and a constant
    c < 2**32, without a product above 2**48."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash3(ix, iy, iz, seed):
    h = (_mul32(ix & _M32, 0x8DA6B343) ^ _mul32(iy & _M32, 0xD8163841)
         ^ _mul32(iz & _M32, 0xCB1AB31F) ^ ((int(seed) * 0x9E3779B9) & _M32))
    h = h ^ (h >> 13)
    h = _mul32(h, 0x5BD1E995)
    return h ^ (h >> 15)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise3(x, y, z, seed=0):
    """``noise3``'s numpy path on float32 tensors."""
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    ix, iy, iz = (v.to(torch.int32).to(torch.int64) for v in (x0, y0, z0))
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def corner(cx, cy, cz):
        gi = _hash3(ix + cx, iy + cy, iz + cz, seed) % 12
        s1 = 1.0 - 2.0 * (gi & 1).to(torch.float32)
        s2 = 1.0 - 2.0 * ((gi >> 1) & 1).to(torch.float32)
        lt4, lt8 = gi < 4, gi < 8
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        gx = torch.where(lt8, s1, zero)
        gy = torch.where(lt4, s2, torch.where(lt8, zero, s1))
        gz = torch.where(lt4, zero, s2)
        return gx * (fx - cx) + gy * (fy - cy) + gz * (fz - cz)

    n000, n100 = corner(0, 0, 0), corner(1, 0, 0)
    n010, n110 = corner(0, 1, 0), corner(1, 1, 0)
    n001, n101 = corner(0, 0, 1), corner(1, 0, 1)
    n011, n111 = corner(0, 1, 1), corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def fbm3(x, y, z, seed=0, octaves=2):
    total = torch.zeros_like(x)
    amp, freq = 1.0, 1.0
    for i in range(octaves):
        total = total + amp * noise3(x * freq, y * freq, z * freq, seed=seed + i)
        amp *= 0.5
        freq *= 2.0
    return total


def terrain(x, y, z):
    """The ``terrain`` scene's signed density on float32 tensors."""
    h = fbm3(x * NOISE_FREQ, torch.zeros_like(x), z * NOISE_FREQ, octaves=2)
    return y - (0.45 + NOISE_AMP * h)


FIELDS = {"terrain": terrain}


def device_scene(name, device):
    """numpy (x, y, z) -> numpy float32 density: the scene's field evaluated
    on `device` in chunks of ``CHUNK_POINTS``."""
    field = FIELDS[name]

    def scene(x, y, z):
        x, y, z = (np.ascontiguousarray(np.broadcast_to(np.asarray(c, np.float32),
                                                        np.shape(x))).ravel()
                   for c in (x, y, z))
        out = np.empty(x.size, np.float32)
        for a in range(0, x.size, CHUNK_POINTS):
            b = min(a + CHUNK_POINTS, x.size)
            cols = [torch.from_numpy(np.array(c[a:b])).to(device) for c in (x, y, z)]
            out[a:b] = field(*cols).cpu().numpy()
        return out

    return scene


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def default_albedo(px, py, pz):
    px, py, pz = (np.asarray(c, np.float32) for c in (px, py, pz))
    t = px * 3.1 + py * 5.3 + pz * 7.9
    r = 0.5 + 0.5 * np.sin(6.0 * t)
    g = 0.5 + 0.5 * np.sin(6.0 * t + 2.094)
    b = 0.5 + 0.5 * np.sin(6.0 * t + 4.188)
    return np.stack([r, g, b], axis=-1)


def sampler_normal(scene, px, py, pz, h=1e-3):
    fx = scene(px + h, py, pz) - scene(px - h, py, pz)
    fy = scene(px, py + h, pz) - scene(px, py - h, pz)
    fz = scene(px, py, pz + h) - scene(px, py, pz - h)
    n = np.stack([fx, fy, fz], axis=-1)
    norm = np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    return n / np.maximum(norm, 1e-12)


def compute_parent_ptr(masks, child_base):
    n = masks.shape[0]
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    has = ((vm & ~lm) & 0xFF) != 0
    seed = np.zeros(n, np.int32)
    seed[child_base[has]] = np.arange(n, dtype=np.int32)[has]
    return np.maximum.accumulate(seed).astype(np.int32)


def _sorted_unique(par):
    starts = np.concatenate(
        [np.zeros(1, np.int64), np.flatnonzero(par[1:] != par[:-1]) + 1])
    return par[starts], starts


def build_svo(scene, lipschitz, depth):
    """The packed SVO of `scene` (numpy (x, y, z) -> float32) as a dict of
    numpy arrays: masks, child_base, leaf_base, parent_ptr, albedo, normal,
    density, level_start, depth. ``build_svo``'s frontier sweep with
    Lipschitz pruning and its exact leaf test."""
    L = float(lipschitz)
    finest = 2.0 ** (-depth)
    coords = [np.zeros((1, 3), np.int32)]
    parent_of = [np.zeros((1,), np.int64)]
    slot_of = [np.zeros((1,), np.int32)]
    f_finest = None
    for l in range(1, depth + 1):
        p = coords[l - 1]
        cc = (p[:, None, :] * 2 + CHILD_OFFSETS[None, :, :]).reshape(-1, 3)
        half = 2.0 ** (-(l + 1))
        scale_l = np.float32(2.0 ** (-l))
        px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * scale_l
        py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * scale_l
        pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * scale_l
        f = np.asarray(scene(px, py, pz), np.float32)
        r = _SQRT3 * half
        keep = (f <= L * r + 1e-6) & (f >= -(L * (r + 2.0 * finest)) - 1e-6)
        kept = np.nonzero(keep)[0]
        cc = cc[kept]
        if l == depth:
            f_finest = f[kept]
        coords.append(cc)
        parent_of.append(kept >> 3)
        slot_of.append((kept & 7).astype(np.int32))

    cc = coords[depth]
    fin32 = np.float32(finest)
    px = (cc[:, 0].astype(np.float32) + np.float32(0.5)) * fin32
    py = (cc[:, 1].astype(np.float32) + np.float32(0.5)) * fin32
    pz = (cc[:, 2].astype(np.float32) + np.float32(0.5)) * fin32
    solid = f_finest <= 0.0
    survive_leaf = np.zeros_like(solid)
    si = np.nonzero(solid)[0]
    if si.size:
        sx, sy, sz = px[si], py[si], pz[si]
        m = si.size
        qx, qy, qz = (np.empty(6 * m, np.float32) for _ in range(3))
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
        survive_leaf[si] = (fq.reshape(6, m) > 0.0).any(axis=0)

    survive = [None] * (depth + 1)
    survive[depth] = survive_leaf
    valid_masks = [None] * depth
    for l in range(depth - 1, -1, -1):
        vm = np.zeros(coords[l].shape[0], np.int32)
        s_child = survive[l + 1]
        par = parent_of[l + 1][s_child]
        bits = np.int32(1) << slot_of[l + 1][s_child]
        if par.size:
            upar, starts = _sorted_unique(par)
            vm[upar] = np.bitwise_or.reduceat(bits, starts)
        valid_masks[l] = vm
        survive[l] = vm != 0
    survive[0][0] = True

    new_idx = [None] * (depth + 1)
    level_counts = []
    for l in range(depth):
        new_idx[l] = np.cumsum(survive[l], dtype=np.int64) - 1
        level_counts.append(int(survive[l].sum()))
    leaf_idx = np.cumsum(survive[depth], dtype=np.int64) - 1
    n_leaves = int(survive[depth].sum())
    level_start = np.zeros(depth + 1, np.int64)
    np.cumsum(level_counts, out=level_start[1:])
    n_nodes = int(level_start[-1])
    masks = np.zeros(n_nodes, np.int32)
    child_base = np.zeros(n_nodes, np.int32)
    leaf_base = np.zeros(n_nodes, np.int32)

    def first_child(n_parents, par, vals):
        fb = np.zeros(n_parents, np.int64)
        if par.size:
            upar, starts = _sorted_unique(par)
            fb[upar] = vals[starts]
        return fb

    for l in range(depth):
        s = survive[l]
        rows = level_start[l] + new_idx[l][s]
        vm = valid_masks[l][s]
        if l == depth - 1:
            masks[rows] = (vm << 8) | vm
            sc = survive[depth]
            fb = first_child(coords[l].shape[0], parent_of[depth][sc], leaf_idx[sc])
            leaf_base[rows] = fb[s].astype(np.int32)
        else:
            masks[rows] = vm << 8
            sc = survive[l + 1]
            fb = first_child(coords[l].shape[0], parent_of[l + 1][sc],
                             level_start[l + 1] + new_idx[l + 1][sc])
            child_base[rows] = fb[s].astype(np.int32)

    sl = survive[depth]
    lpx, lpy, lpz = px[sl], py[sl], pz[sl]
    return dict(masks=masks, child_base=child_base, leaf_base=leaf_base,
                parent_ptr=compute_parent_ptr(masks, child_base),
                albedo=default_albedo(lpx, lpy, lpz).astype(np.float32),
                normal=sampler_normal(scene, lpx, lpy, lpz).astype(np.float32),
                density=np.ones(n_leaves, np.float32),
                level_start=level_start, depth=depth)


def _expand_children(masks, child_base, rows):
    m = masks[rows]
    nl = ((m >> 8) & 0xFF) & ~(m & 0xFF)
    hit = ((nl[:, None] >> np.arange(8)) & 1).astype(bool)
    ranks = np.cumsum(hit, axis=1) - 1
    pidx, slots = np.nonzero(hit)
    crows = child_base[rows][pidx] + ranks[pidx, slots]
    return crows.astype(np.int64), pidx.astype(np.int64), slots.astype(np.int32)


def make_brick_svo(svo):
    """The brick form of a ``build_svo`` dict: a dict of numpy int32
    ``top_masks``, ``top_child``, ``top_parent``, ``bricks`` (n_bricks, 17)
    and ``depth``, ``top_depth``."""
    depth = svo["depth"]
    top_depth = depth - BRICK_LEVELS
    ls = svo["level_start"]
    masks, child_base = svo["masks"], svo["child_base"]
    leaf_base, parent_ptr = svo["leaf_base"], svo["parent_ptr"]
    nb_start, nb_end = int(ls[top_depth]), int(ls[top_depth + 1])
    n_bricks = nb_end - nb_start
    n_top = nb_start
    top_masks = masks[:n_top].copy()
    top_child = child_base[:n_top].copy()
    top_parent = parent_ptr[:n_top].copy()
    lo, hi = int(ls[top_depth - 1]), n_top
    vm_cut = (top_masks[lo:hi] >> 8) & 0xFF
    top_masks[lo:hi] = (vm_cut << 8) | vm_cut
    top_child[lo:hi] = child_base[lo:hi] - nb_start

    brick_rows = np.arange(nb_start, nb_end, dtype=np.int64)
    r1, p1, s1 = _expand_children(masks, child_base, brick_rows)
    r2, p2, s2 = _expand_children(masks, child_base, r1)
    lm2 = masks[r2] & 0xFF
    hit3 = ((lm2[:, None] >> np.arange(8)) & 1).astype(bool)
    pidx3, s3 = np.nonzero(hit3)
    s3 = s3.astype(np.int32)
    brick_of = p1[p2[pidx3]]
    bitidx = (s1[p2[pidx3]].astype(np.int64) << 6) | (s2[pidx3] << 3) | s3
    flat = brick_of * 16 + (bitidx >> 5)
    bit = np.uint32(1) << (bitidx & 31).astype(np.uint32)
    words = np.zeros(n_bricks * 16, np.uint32)
    if flat.size:
        starts = np.concatenate(
            [np.zeros(1, np.int64), np.flatnonzero(flat[1:] != flat[:-1]) + 1])
        words[flat[starts]] = np.bitwise_or.reduceat(bit, starts)
    bleaf = np.zeros(n_bricks, np.uint32)
    if r2.size:
        b_of_r2 = p1[p2]
        starts2 = np.concatenate(
            [np.zeros(1, np.int64),
             np.flatnonzero(b_of_r2[1:] != b_of_r2[:-1]) + 1])
        bleaf[b_of_r2[starts2]] = leaf_base[r2[starts2]].astype(np.uint32)
    bricks = np.concatenate([words.reshape(n_bricks, 16), bleaf[:, None]], axis=1)
    if n_bricks == 0:
        bricks = np.zeros((1, 17), np.uint32)
    return dict(top_masks=top_masks.astype(np.int32),
                top_child=top_child.astype(np.int32),
                top_parent=top_parent.astype(np.int32),
                bricks=np.ascontiguousarray(bricks, np.uint32).view(np.int32),
                depth=depth, top_depth=top_depth)


def bricks_on(bsvo, device):
    """The brick form with its tables as torch tensors on `device`."""
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
            for k, v in bsvo.items()}
