"""Phase 1 of the tile trace: the dispatcher ``tile._candidates``, the
contract of the kernels' wrappers ``tile_cuda.candidates`` and
``tile_cuda.candidates_block``, the plain version ``tile.candidates_plain``
against the JAX package's ``_candidates``, and numpy models of the two
kernels' per-tile algorithms (``csrc/tile_candidates.cu``) held bitwise to
the plain version.

The first form's model does what one block of ``tile_candidates_block``
does for its tile: the planes and the view direction from the corners in
the kernel's order of sums, the static widths of ``tile_cuda.level_widths``,
each level's keys padded with the sentinel to a power of two and sorted by
the kernel's bitonic network, the drop rule, and the row padded to k_max.

The new form's model does what a warp or a block of ``tile_candidates``
does: the same keys, compacted to the valid ones (in slot order, as a
warp's ballots leave them, or shuffled, as a block's atomics may), the key
of rank ``width`` found by the kernel's bitwise search where a level
overflows (drop_t from it, the keys below it kept, in any order), and the
finest level's row sorted by the warp's register network of 32 * E keys.
The kernels themselves are held to the plain version on the card by
chip_smoke.py. Every comparison here is exact: integers equal, floats
equal as bits."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu.ops import tile as jax_tile

from raytracingtest_tpu_torch import _build, _launch
from raytracingtest_tpu_torch.ops import tile, tile_cuda
from tests.test_torch_tile_trace import INSIDE_CAM, setup

NAMES = ("codes", "ids", "t_codes", "drop_t")
SENTINEL = 2 ** 31 - 1
F32 = np.float32


HORIZON_CAM = dict(position=(0.5, 0.5, -0.3), look_at=(0.5, 0.5, 1.0),
                   fov_y_deg=50.0)


def budget(name, top_depth):
    """(caps, k_max, corners mode) of the budgets the tile frame, the
    trainer and the tests use, and two that make levels overflow: narrow
    intermediate levels, and a finest level narrower than the one above
    allows."""
    return {
        "narrow": ((1, 8) + (3,) * (top_depth - 1), 96, "tiles"),
        "narrow top": (tuple(min(64, 8 ** l) for l in range(top_depth + 1)), 40,
                       "tiles"),
        "tiny": ((1, 2, 2, 2), 2, "tiles"),
        "default": (tile._default_caps(top_depth, 48), 48, "tiles"),
        "main": (tile._default_caps(top_depth, 96), 96, "tiles"),
        "wide": (tuple(min(160, 8 ** l) for l in range(top_depth + 1)), 160, "tiles"),
        "fb2": (tile._fb2_caps(top_depth, 160), 160, "sub-tiles"),
        "fb_k 256": (tuple(min(256, 8 ** l) for l in range(top_depth + 1)), 256,
                     "tiles"),
    }[name]


def inputs(name, depth, which, res=64, cam=None):
    """(port TileSVO, corners (T,4,3), apex (3,), caps, k_max), as CPU
    tensors; the sub-tile budgets get the 2x2 sub-tiles' corners."""
    _ref_ts, ts, _svo, (o, d, corners) = setup(name, depth, res, cam)
    caps, k_max, mode = budget(which, ts.top_depth)
    o, d, c = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(corners)
    if mode == "sub-tiles":
        o, d, c = tile._subtile_split(o, d, c, 2)
    return ts, c.contiguous(), o[0, 0], caps, k_max


def assert_bitwise(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


# ---- the numpy model of one block of the kernel ------------------------------

def block_sort(keys):
    """The kernel's bitonic network on each row of (T, n) keys, n a power of
    two: every comparator puts the smaller key at the lower index; a pass
    pairs lo (the mask's top bit clear) with lo ^ mask."""
    n = keys.shape[1]
    p = np.arange(n // 2)
    k = 2
    while k <= n:
        mask = k - 1
        while mask > 0:
            h = k >> 1 if mask == k - 1 else mask
            lo = ((p & ~(h - 1)) << 1) | (p & (h - 1))
            hi = lo ^ mask
            a, b = keys[:, lo], keys[:, hi]
            keys[:, lo], keys[:, hi] = np.minimum(a, b), np.maximum(a, b)
            mask = k >> 2 if mask == k - 1 else mask >> 1
        k <<= 1
    return keys


def compact3(x):
    x = x & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def frustum(corners):
    """(planes (T,4,3), their |.| sums (T,4), view direction (T,3), its
    |.| sum (T,)) as the kernels compute them, in float32."""
    c = corners.astype(F32)
    fwd = ((c[:, 0] + c[:, 1]) + c[:, 2]) + c[:, 3]                 # (T,3)
    u, v = c, np.roll(c, -1, axis=1)
    nrm = np.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                    u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                    u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], axis=-1)
    dot = (nrm[..., 0] * fwd[:, None, 0] + nrm[..., 1] * fwd[:, None, 1]) \
        + nrm[..., 2] * fwd[:, None, 2]
    sgn = np.where(dot > 0, F32(1), np.where(dot < 0, F32(-1),
                                             np.where(dot == 0, F32(1), dot)))
    pl = nrm * sgn[..., None]                                         # (T,4,3)
    pa = np.abs(pl)
    fa = np.abs(fwd)
    return pl, (pa[..., 0] + pa[..., 1]) + pa[..., 2], fwd, \
        (fa[:, 0] + fa[:, 1]) + fa[:, 2]


def child_keys(pyr, offs, fr, apex, l, parent):
    """The keys of the 8 children of each (T, C) parent code (-1: none) at
    level l, in slot order (T, 8C): SENTINEL where empty or culled. `pyr`
    as uint32 words in int64, `fr` what ``frustum`` returns."""
    pl, pa_sum, fwd, fa_sum = fr
    half, cell = F32(2.0 ** -(l + 1)), F32(2.0 ** -l)
    cb = 3 * l
    qbits = max(0, 30 - cb)
    qmax = (1 << qbits) - 2 if qbits else 0
    i = np.arange(8 * parent.shape[1])
    par = parent[:, i >> 3]
    safe = np.maximum(par, 0)
    oct_ = i & 7
    word = pyr[offs[l] + (safe >> 2)]
    occ = (par >= 0) & (((word >> (((safe & 3) << 3) + oct_)) & 1) == 1)
    child = safe * 8 + oct_
    r = [(compact3(child >> a).astype(F32) * cell + half) - apex[a]
         for a in range(3)]
    keep = occ
    for j in range(4):
        pd = (pl[:, j, None, 0] * r[0] + pl[:, j, None, 1] * r[1]) \
            + pl[:, j, None, 2] * r[2]
        keep = keep & (pd + pa_sum[:, j, None] * half >= 0)
    fd = (fwd[:, None, 0] * r[0] + fwd[:, None, 1] * r[1]) + fwd[:, None, 2] * r[2]
    keep = keep & (fd + (fa_sum * half)[:, None] >= 0)
    ax = [np.maximum(np.abs(x) - half, F32(0)) for x in r]
    t_lb = np.sqrt(((ax[0] * ax[0] + ax[1] * ax[1]) + ax[2] * ax[2])
                   .astype(np.float64)).astype(F32)
    scaled = np.minimum(t_lb * F32((1 << qbits) / 4.0), F32(2 ** 30))
    q = np.clip(scaled.astype(np.int64), 0, qmax)
    return np.where(keep, (q << cb) | child, SENTINEL)


def t_scale(l):
    return F32(4.0 / (1 << max(0, 30 - 3 * l)))


def finest_row(keys, top_depth, cellmap, k_max):
    """codes, ids, t_codes of (T, m) finest-level keys in row order (the
    sentinel for none), padded to k_max."""
    cb = 3 * top_depth
    valid = keys != SENTINEL
    codes = np.where(valid, keys & ((1 << cb) - 1), -1)
    t_codes = np.where(valid, (keys >> cb).astype(F32) * t_scale(top_depth),
                       F32(np.inf))
    cm = cellmap.astype(np.int64)
    row = cm[np.maximum(codes, 0) >> 5]
    below = (1 << (np.maximum(codes, 0) & 31)) - 1
    rank = np.array([bin(int(x)).count("1") for x in
                     ((row[..., 1] & 0xFFFFFFFF) & below).ravel()],
                    dtype=np.int64).reshape(codes.shape)
    ids = np.where(valid, row[..., 0] + rank, -1)
    pad = k_max - codes.shape[1]
    return (np.pad(codes, ((0, 0), (0, pad)), constant_values=-1).astype(np.int32),
            np.pad(ids, ((0, 0), (0, pad)), constant_values=-1).astype(np.int32),
            np.pad(t_codes, ((0, 0), (0, pad)), constant_values=np.inf).astype(F32))


def kernel_model(pyr, cellmap, corners, apex, top_depth, widths, k_max):
    """codes, ids, t_codes, drop_t as the first form's kernel computes them,
    tile by tile (vectorised over tiles), in float32 numpy arithmetic."""
    pyr = pyr.astype(np.int64) & 0xFFFFFFFF
    fr = frustum(corners)
    T = corners.shape[0]
    offs = tile._pyr_layout(top_depth)[0]

    prev = np.zeros((T, 1), np.int64)
    drop = np.full(T, np.inf, F32)
    for l in range(1, top_depth + 1):
        n = 8 * widths[l - 1]
        n2 = 8
        while n2 < n:
            n2 *= 2
        cb = 3 * l
        keys = child_keys(pyr, offs, fr, apex, l, prev)
        keys = block_sort(np.pad(keys, ((0, 0), (0, n2 - n)),
                                 constant_values=SENTINEL))
        w = widths[l]
        if w < n:
            nxt = keys[:, w]
            t_drop = (nxt >> cb).astype(F32) * t_scale(l)
            drop = np.where((nxt != SENTINEL) & (t_drop < drop), t_drop, drop)
        kept = keys[:, :w]
        prev = np.where(kept == SENTINEL, -1, kept & ((1 << cb) - 1))
    return (*finest_row(kept, top_depth, cellmap, k_max), drop)


# ---- the numpy model of one warp or block of the new kernel ------------------

def rank_key(keys, w):
    """The kernel's bitwise search for the key of rank w (0-based) among
    more than w unique keys: the largest v with at most w keys below it,
    from the highest bit in which the smallest and the largest differ."""
    lo, hi = int(keys.min()), int(keys.max())
    top = (lo ^ hi).bit_length() - 1
    prefix = lo & ~((2 << top) - 1)
    for bit in range(top, -1, -1):
        cand = prefix | (1 << bit)
        if int((keys < cand).sum()) <= w:
            prefix = cand
    return prefix


def warp_sort(keys):
    """The kernel's register network on a warp's 32 * E keys (position
    lane * E + e): key i meets key i ^ j and keeps the smaller where i is
    the lower of the two in an ascending run (or the higher in a
    descending one), the larger otherwise."""
    n = keys.shape[0]
    i = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            other = keys[i ^ j]
            keep_min = ((i & j) == 0) == ((i & k) == 0)
            keys = np.where(keep_min, np.minimum(keys, other),
                            np.maximum(keys, other))
            j >>= 1
        k <<= 1
    return keys


def select_model(pyr, cellmap, corners, apex, top_depth, widths, k_max, seed=0):
    """codes, ids, t_codes, drop_t as the new kernel computes them, and the
    (T, top_depth) valid keys a tile saw at each level. A tile at a time:
    the valid keys compacted, in slot order for one warp a tile and in a
    seeded random order for a block (``tile_cuda.candidate_warps``); the
    width smallest selected; the finest row sorted in 32 * E registers."""
    pyr = pyr.astype(np.int64) & 0xFFFFFFFF
    fr_all = frustum(corners)
    T = corners.shape[0]
    offs = tile._pyr_layout(top_depth)[0]
    shuffle = tile_cuda.candidate_warps(widths) > 1
    rng = np.random.default_rng(seed)
    rows, drops, counts = [], [], np.zeros((T, top_depth), np.int64)
    for t in range(T):
        fr = tuple(x[t:t + 1] for x in fr_all)
        kept = np.zeros(1, np.int64)           # level 0: the root
        drop = F32(np.inf)
        for l in range(1, top_depth + 1):
            keys = child_keys(pyr, offs, fr, apex, l, kept[None])[0]
            staged = keys[keys != SENTINEL]
            if shuffle:
                staged = rng.permutation(staged)
            counts[t, l - 1] = count = staged.size
            w = widths[l]
            if count > w:
                kth = rank_key(staged, w)
                drop = min(drop, F32(kth >> 3 * l) * t_scale(l))
                staged = staged[staged < kth]
            kept = staged if l == top_depth else staged & ((1 << 3 * l) - 1)
        m = kept.size
        e = next(e for e in (1, 2, 4, 8) if m <= 32 * e)
        row = warp_sort(np.pad(kept, (0, 32 * e - m), constant_values=SENTINEL))
        rows.append(np.pad(row, (0, max(0, k_max - 32 * e)),
                           constant_values=SENTINEL)[:k_max])
        drops.append(drop)
    return (*finest_row(np.stack(rows), top_depth, cellmap, k_max),
            np.asarray(drops, F32)), counts


MODEL_CASES = [
    ("terrain", 6, "tiny", None), ("terrain", 6, "default", None),
    ("terrain", 6, "wide", None), ("terrain", 6, "fb2", None),
    ("terrain", 6, "fb_k 256", None), ("terrain", 7, "main", None),
    ("terrain", 7, "fb2", None),
    ("sphere", 5, "main", None),           # 64 cells at the top: rows padded
    ("flat_ground", 4, "default", None),   # top_depth 1: one level
    ("terrain", 6, "default", INSIDE_CAM),
    ("empty", 4, "default", None),
]


@pytest.mark.parametrize("name,depth,which,cam", MODEL_CASES,
                         ids=[f"{c[0]}-d{c[1]}-{c[2]}{'-inside' if c[3] else ''}"
                              for c in MODEL_CASES])
def test_kernel_model_equals_plain_bitwise(name, depth, which, cam):
    res = 32 if cam or name == "empty" else 64
    ts, corners, apex, caps, k_max = inputs(name, depth, which, res, cam)
    want = tile.candidates_plain(ts.pyr, ts.cellmap, corners, apex,
                                 ts.top_depth, caps, k_max)
    widths = tile_cuda.level_widths(ts.top_depth, caps, k_max)
    got = kernel_model(ts.pyr.numpy(), ts.cellmap.numpy(), corners.numpy(),
                       apex.numpy(), ts.top_depth, widths, k_max)
    assert_bitwise(got, [x.numpy() for x in want], f"{name} d{depth} {which}")
    n_valid = int((want[1] >= 0).sum())
    assert (n_valid == 0) == (name == "empty")
    if name == "sphere":   # lists shorter than k_max: the padding path
        assert widths[-1] < k_max and bool((want[0][:, widths[-1]:] == -1).all())


@pytest.mark.parametrize("which", ["fb2", "fb_k 256"])
@pytest.mark.parametrize("name,depth", [("terrain", 6), ("sphere", 5)])
def test_plain_matches_reference(name, depth, which):
    """The two budget sets test_candidates_match_reference lacks: the
    sub-tile pass's ramp on 2x2 sub-tile corners, and the trainer's
    fb_k = 256 (every level keeps up to 256)."""
    ref_ts, _ts, _svo, _rays = setup(name, depth)
    ts, corners, apex, caps, k_max = inputs(name, depth, which)
    ref = jax_tile._candidates(ref_ts.pyr, ref_ts.cellmap,
                               jnp.asarray(corners.numpy()),
                               jnp.asarray(apex.numpy()), ts.top_depth, caps,
                               k_max)
    ours = tile.candidates_plain(ts.pyr, ts.cellmap, corners, apex,
                                 ts.top_depth, caps, k_max)
    assert_bitwise([x.numpy() for x in ours], [np.asarray(x) for x in ref],
                   f"{name} d{depth} {which}")
    assert ours[0].shape == (corners.shape[0], k_max)
    assert int((ours[1] >= 0).sum()) > 0


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    ts, corners, apex, caps, k_max = inputs("terrain", 6, "default")
    before = tile_cuda.candidates_launches
    got = tile._candidates(ts.pyr, ts.cellmap, corners, apex, ts.top_depth,
                           caps, k_max)
    want = tile.candidates_plain(ts.pyr, ts.cellmap, corners, apex,
                                 ts.top_depth, caps, k_max)
    assert_bitwise([x.numpy() for x in got], [x.numpy() for x in want], "dispatch")
    assert tile_cuda.candidates_launches == before


def good_args():
    ts, corners, apex, caps, k_max = inputs("terrain", 6, "default")
    return dict(pyr=ts.pyr, cellmap=ts.cellmap, corners=corners, apex=apex,
                top_depth=ts.top_depth, caps=caps, k_max=k_max)


BAD_ARGUMENTS = [
    ("device", {}, "the tile_candidates kernel takes CUDA tensors"),
    ("dtype", dict(pyr=lambda a: a["pyr"].float()), "pyr"),
    ("shape", dict(cellmap=lambda a: a["cellmap"][:-1]), "cellmap"),
    ("contiguity", dict(corners=lambda a: a["corners"].transpose(1, 2)
                        .contiguous().transpose(1, 2)), "non-contiguous"),
    ("apex", dict(apex=lambda a: a["apex"][None]), "apex"),
    ("cap", dict(caps=lambda a: (1, 8, 257, 300)), "caps[2] = 257"),
    ("k_max", dict(k_max=lambda a: 257), "k_max 257"),
    ("top_depth 0", dict(top_depth=lambda a: 0), "top_depth 0"),
    ("top_depth 11", dict(top_depth=lambda a: 11), "top_depth 11"),
]


def refuses(wrapper, what, change, says, monkeypatch):
    """`change` made to good arguments raises ValueError matching `says`
    from tile_cuda.`wrapper`, before any library is asked for and with no
    launch counted. Past the device case the device check is stood in for,
    so that CPU tensors reach the later ones."""
    if what != "device":
        for kernel in (tile_cuda._TILE_CANDIDATES, tile_cuda._TILE_CANDIDATES_BLOCK):
            monkeypatch.setattr(kernel, "check", lambda device, specs:
                                _launch.check_tensors(device, specs))
    args = good_args()
    for key, fn in change.items():
        args[key] = fn(args)
    counts = lambda: (tile_cuda.candidates_launches,
                      tile_cuda.candidates_block_launches)
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError, match=re.escape(says)):
        getattr(tile_cuda, wrapper)(**args)
    assert counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what,change,says", BAD_ARGUMENTS + [
    ("warps", dict(warps=lambda a: 3), "3 warps a tile")])
def test_wrapper_refuses_bad_arguments(what, change, says, monkeypatch):
    """The new form's wrapper, ``candidates``; also a number of warps a tile
    that the kernel has no variant for."""
    refuses("candidates", what, change, says, monkeypatch)


@pytest.mark.parametrize("what,change,says", BAD_ARGUMENTS)
def test_first_form_wrapper_refuses_bad_arguments(what, change, says,
                                                  monkeypatch):
    """The first form's wrapper, ``candidates_block``, by the same check."""
    refuses("candidates_block", what, change,
            says.replace("tile_candidates", "tile_candidates_block"), monkeypatch)


def test_level_widths_on_the_frames_budgets():
    """The depth-10 frame's three calls (top_depth 7), a top level wider
    than its 8^l cells allow, and caps past the end of the tuple."""
    assert tile_cuda.level_widths(7, tile._default_caps(7, 96), 96) == (
        1, 8, 12, 18, 27, 40, 60, 96)
    assert tile_cuda.level_widths(7, tuple(min(160, 8 ** l) for l in range(8)),
                                  160) == (1, 8, 64, 160, 160, 160, 160, 160)
    assert tile_cuda.level_widths(7, tile._fb2_caps(7, 160), 160) == (
        1, 8, 32, 64, 128, 160, 160, 160)
    assert tile_cuda.level_widths(2, (1, 8, 12), 96) == (1, 8, 64)
    assert tile_cuda.level_widths(4, (1, 2), 2) == (1, 2, 2, 2, 2)


SELECT_CASES = MODEL_CASES + [
    ("terrain", 7, "narrow", None),        # intermediate levels overflow
    ("terrain", 7, "narrow top", None),    # the finest level overflows
    ("terrain", 7, "narrow", HORIZON_CAM),  # tiles that see nothing
    ("terrain", 7, "main", HORIZON_CAM),
]


@pytest.mark.parametrize("name,depth,which,cam", SELECT_CASES,
                         ids=[f"{c[0]}-d{c[1]}-{c[2]}{'-inside' if c[3] is INSIDE_CAM else '-horizon' if c[3] else ''}"
                              for c in SELECT_CASES])
def test_select_model_equals_plain_bitwise(name, depth, which, cam):
    res = 32 if cam is INSIDE_CAM or name == "empty" else 64
    ts, corners, apex, caps, k_max = inputs(name, depth, which, res, cam)
    want = tile.candidates_plain(ts.pyr, ts.cellmap, corners, apex,
                                 ts.top_depth, caps, k_max)
    widths = tile_cuda.level_widths(ts.top_depth, caps, k_max)
    got, counts = select_model(ts.pyr.numpy(), ts.cellmap.numpy(),
                               corners.numpy(), apex.numpy(), ts.top_depth,
                               widths, k_max)
    assert_bitwise(got, [x.numpy() for x in want], f"{name} d{depth} {which}")
    over = counts > np.asarray(widths[1:])
    if which == "narrow":
        assert over[:, :-1].any(), "no intermediate level overflows"
    if which == "narrow top":
        assert over[:, -1].any(), "the finest level never overflows"
    if cam is HORIZON_CAM:
        assert (counts[:, -1] == 0).any() and (counts[:, -1] > 0).any()
    # the drop rule: drop_t is finite exactly where some level overflowed
    np.testing.assert_array_equal(np.isfinite(got[3]), over.any(axis=1))


def test_select_model_at_exactly_the_width():
    """A level whose width is some tile's count of valid keys: that tile
    keeps all of them and drops nothing there, the plain version's bits."""
    ts, corners, apex, _caps, _k = inputs("terrain", 7, "wide")
    td = ts.top_depth
    free = tile_cuda.level_widths(td, (1, 8, 64, 256, 256), 256)
    _got, counts = select_model(ts.pyr.numpy(), ts.cellmap.numpy(),
                                corners.numpy(), apex.numpy(), td, free, 256)
    exact = int(counts[:, 2].max())          # level 3's largest count
    caps = (1, 8, 64, exact, 256)
    want = tile.candidates_plain(ts.pyr, ts.cellmap, corners, apex, td, caps, 96)
    widths = tile_cuda.level_widths(td, caps, 96)
    got, counts = select_model(ts.pyr.numpy(), ts.cellmap.numpy(),
                               corners.numpy(), apex.numpy(), td, widths, 96)
    assert widths[3] == exact and (counts[:, 2] == exact).any()
    assert not (counts[:, 2] > exact).any()
    assert_bitwise(got, [x.numpy() for x in want], "exactly the width")


@pytest.mark.parametrize("m", [0, 1, 31, 32, 33, 100, 256])
def test_warp_sort_sorts(m):
    """The register network sorts any 32 * E keys (E = 1, 2, 4, 8 by the
    row's length), unique keys padded with the sentinel."""
    rng = np.random.default_rng(m)
    e = next(e for e in (1, 2, 4, 8) if m <= 32 * e)
    keys = np.pad(rng.choice(2 ** 30, m, replace=False), (0, 32 * e - m),
                  constant_values=SENTINEL)
    np.testing.assert_array_equal(warp_sort(rng.permutation(keys)), np.sort(keys))
