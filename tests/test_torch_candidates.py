"""Phase 1 of the tile trace: the dispatcher ``tile._candidates``, the
contract of the kernel's wrapper ``tile_cuda.candidates``, the plain version
``tile.candidates_plain`` against the JAX package's ``_candidates``, and a
numpy model of the kernel's per-tile algorithm (``csrc/tile_candidates.cu``)
held bitwise to the plain version.

The model does what one block of the kernel does for its tile: the planes
and the view direction from the corners in the kernel's order of sums, the
static widths of ``tile_cuda.level_widths``, each level's keys padded with
the sentinel to a power of two and sorted by the kernel's bitonic network,
the drop rule, and the row padded to k_max. The kernel itself is held to
the plain version on the card by chip_smoke.py. Every comparison here is
exact: integers equal, floats equal as bits."""

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


def budget(name, top_depth):
    """(caps, k_max, corners mode) of the budgets the tile frame, the
    trainer and the tests use."""
    return {
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


def kernel_model(pyr, cellmap, corners, apex, top_depth, widths, k_max):
    """codes, ids, t_codes, drop_t as the kernel computes them, tile by tile
    (vectorised over tiles), in float32 numpy arithmetic."""
    pyr = pyr.astype(np.int64) & 0xFFFFFFFF
    c = corners.astype(F32)
    T = c.shape[0]
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
    pa_sum = (pa[..., 0] + pa[..., 1]) + pa[..., 2]                   # (T,4)
    fa = np.abs(fwd)
    fa_sum = (fa[:, 0] + fa[:, 1]) + fa[:, 2]
    offs = tile._pyr_layout(top_depth)[0]

    prev = np.zeros((T, 1), np.int64)
    drop = np.full(T, np.inf, F32)
    for l in range(1, top_depth + 1):
        n = 8 * widths[l - 1]
        n2 = 8
        while n2 < n:
            n2 *= 2
        half, cell = F32(2.0 ** -(l + 1)), F32(2.0 ** -l)
        cb = 3 * l
        qbits = max(0, 30 - cb)
        qmax = (1 << qbits) - 2 if qbits else 0
        i = np.arange(n2)
        parent = np.where(i < n, prev[:, np.minimum(i >> 3, prev.shape[1] - 1)], -1)
        safe = np.maximum(parent, 0)
        oct_ = i & 7
        word = pyr[offs[l] + (safe >> 2)]
        occ = (parent >= 0) & (((word >> (((safe & 3) << 3) + oct_)) & 1) == 1)
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
        keys = block_sort(np.where(keep, (q << cb) | child, SENTINEL))
        w = widths[l]
        t_scale = F32(4.0 / (1 << qbits))
        if w < n:
            nxt = keys[:, w]
            t_drop = (nxt >> cb).astype(F32) * t_scale
            drop = np.where((nxt != SENTINEL) & (t_drop < drop), t_drop, drop)
        kept = keys[:, :w]
        prev = np.where(kept == SENTINEL, -1, kept & ((1 << cb) - 1))

    valid = kept != SENTINEL
    t_codes = np.where(valid, (kept >> cb).astype(F32) * t_scale, F32(np.inf))
    cm = cellmap.astype(np.int64)
    row = cm[np.maximum(prev, 0) >> 5]
    below = (1 << (np.maximum(prev, 0) & 31)) - 1
    rank = np.array([bin(int(x)).count("1") for x in
                     ((row[..., 1] & 0xFFFFFFFF) & below).ravel()]).reshape(prev.shape)
    ids = np.where(valid, row[..., 0] + rank, -1)
    pad = k_max - prev.shape[1]
    codes = np.pad(prev, ((0, 0), (0, pad)), constant_values=-1).astype(np.int32)
    ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1).astype(np.int32)
    t_codes = np.pad(t_codes, ((0, 0), (0, pad)), constant_values=np.inf).astype(F32)
    return codes, ids, t_codes, drop


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


@pytest.mark.parametrize("what,change,says", [
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
])
def test_wrapper_refuses_bad_arguments(what, change, says, monkeypatch):
    """Each raises ValueError naming the argument, before any library is
    asked for and with no launch counted. Past the device case the device
    check is stood in for, so that CPU tensors reach the later ones."""
    if what != "device":
        monkeypatch.setattr(tile_cuda._TILE_CANDIDATES, "check",
                            lambda device, specs: _launch.check_tensors(device, specs))
    args = good_args()
    for key, fn in change.items():
        args[key] = fn(args)
    before, loaded = tile_cuda.candidates_launches, set(_build._libs)
    with pytest.raises(ValueError, match=re.escape(says)):
        tile_cuda.candidates(**args)
    assert tile_cuda.candidates_launches == before and set(_build._libs) == loaded


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
