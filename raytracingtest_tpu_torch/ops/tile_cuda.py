"""The tile trace on the card: the wrappers of ``tile_walk`` and
``tile_walk_serial`` in ``csrc/tile_walk.cu`` (phase 2, the walk) and of
``tile_candidates`` in ``csrc/tile_candidates.cu`` (phase 1).

Both kernels replace what the reference's ``_walk_chunk_window`` and
``_resolve_hits`` compute (``raytracingtest_tpu/ops/tile.py``) and give the
same bits. ``tile_walk`` gives each ray G lanes of one warp, which walk its
tile's candidate list G candidates at a time and rebuild the serial walk's
result from a prefix minimum of their hits; G comes from the launch's shape
(``lanes_per_ray``). ``tile_walk_serial`` is the first form, one thread a
ray: the check of the other and its yardstick, which nothing on the main
path launches. CUDA tensors go to a kernel; CPU tensors go to the plain
version, ``tile.walk_plain``. Nothing else picks the path: a build or launch
failure raises.

``candidates`` launches ``tile_candidates``, which computes what the
reference's ``_candidates`` does and gives the same bits as its plain
version, ``tile.candidates_plain``: a warp or a block a tile
(``candidate_warps``), each level's valid keys compacted, the ``width``
smallest selected, and only the finest level's row sorted.
``candidates_block`` launches the first form, ``tile_candidates_block``, one
block a tile that sorts each level's keys padded to a power of two: the
check of the other and its yardstick, which nothing on the main path
launches. ``tile._candidates`` sends CUDA tensors to ``candidates`` and CPU
tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from raytracingtest_tpu_torch._build import candidates_lib, tile_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops import tile
from raytracingtest_tpu_torch.ops.brick import BRICK_LEVELS
from raytracingtest_tpu_torch.ops.traverse import S_MAX

_F32, _I32 = torch.float32, torch.int32

# the kernels stage this many candidates a tile; the serial form's block
# holds this many rays (one thread each)
K_LIMIT = 256
P_LIMIT = 256
# lanes a ray: powers of two up to a warp
LANES = (1, 2, 4, 8, 16, 32)
# lanes_per_ray fills the card's thread slots this many times over
FILLS = 2

# tile_candidates keeps at most this many keys a level (k_max and every
# cap), so a tile stages at most 8 times as many; the pyramid has at most
# this many levels
WIDTH_LIMIT = 256
TOP_DEPTH_LIMIT = 10
# warps a tile of tile_candidates: one, or a block of eight; one warp a tile
# while a level expands at most this many child slots
CANDIDATE_WARPS = (1, 8)
WARP_SLOTS = 512

# kernel launches made by this process: tile_walk, its serial form,
# tile_candidates and its first form
launches = 0
serial_launches = 0
candidates_launches = 0
candidates_block_launches = 0

_TILE_WALK = Kernel("tile_walk", tile_lib)
_TILE_WALK_SERIAL = Kernel("tile_walk_serial", tile_lib)
_TILE_CANDIDATES = Kernel("tile_candidates", candidates_lib)
_TILE_CANDIDATES_BLOCK = Kernel("tile_candidates_block", candidates_lib)

_slots: dict = {}


def lanes_per_ray(tiles: int, rays: int, slots: int) -> int:
    """G for a walk of `tiles` tiles of `rays` rays on a card with `slots`
    resident thread slots (SMs times threads an SM): the largest power of
    two up to 32 for which the launch's tiles * rays * G threads fill the
    slots at most FILLS times, and 1 when the rays alone fill them that
    often (the frame's main walk). A walk with fewer rays has the idle slots walk its
    rays' candidates side by side. Two fills and not one: at G > 1 the
    kernel's registers hold a block of 256 threads to half an SM's slots,
    and a second fill shortens each ray's chain of rounds by more than it
    waits (measured on an H100 by chip_smoke.py's lanes sweep)."""
    if tiles < 1 or rays < 1 or slots < 1:
        raise ValueError(f"tiles {tiles}, rays {rays}, slots {slots}: each "
                         f"must be at least 1")
    g = 1
    while g < LANES[-1] and tiles * rays * (2 * g) <= FILLS * slots:
        g *= 2
    return g


def thread_slots(device) -> int:
    """The resident thread slots of the CUDA `device`: SMs times the threads
    an SM holds (2,048 on an H100's 132 SMs)."""
    index = torch.device(device).index or 0
    if index not in _slots:
        props = torch.cuda.get_device_properties(index)
        _slots[index] = props.multi_processor_count * getattr(
            props, "max_threads_per_multi_processor", 2048)
    return _slots[index]


def _check(kernel, bricks, o, d, codes, ids, t_codes, depth, top_depth,
           p_limit):
    """The one check of both kernels' arguments; returns (T, P, K)."""
    device = o.device
    if o.dim() != 3 or o.shape[2] != 3:
        raise ValueError(f"o has shape {tuple(o.shape)}, expected (T, P, 3)")
    T, P = o.shape[0], o.shape[1]
    if ids.dim() != 2 or ids.shape[0] != T:
        raise ValueError(f"ids has shape {tuple(ids.shape)}, expected ({T}, K)")
    K = ids.shape[1]
    kernel.check(device, (
        ("o", o, _F32, (T, P, 3)), ("d", d, _F32, (T, P, 3)),
        ("codes", codes, _I32, (T, K)), ("ids", ids, _I32, (T, K)),
        ("t_codes", t_codes, _F32, (T, K)),
        ("bricks", bricks, _I32, (bricks.shape[0], 17))))
    if not (1 <= K <= K_LIMIT and 1 <= P <= p_limit and T >= 1):
        raise ValueError(f"T={T}, P={P}, K={K}: the kernel takes K <= {K_LIMIT} "
                         f"and P <= {p_limit}")
    if T * P >= 2 ** 31:
        raise ValueError(f"{T} tiles of {P} rays: too many rays for one launch")
    if not (1 <= top_depth <= 10 and depth == top_depth + BRICK_LEVELS
            and depth <= S_MAX):
        raise ValueError(f"depth {depth} / top_depth {top_depth} out of range")
    return T, P, K


def _outputs(T, P, device):
    return (torch.empty((T, P), dtype=_I32, device=device),
            torch.empty((T, P), dtype=_F32, device=device),
            torch.empty((T, P), dtype=_I32, device=device))


def _walk_kernel(bricks, o, d, codes, ids, t_codes, depth, top_depth,
                 lanes=None):
    """Launch ``tile_walk`` on (T,P,3) CUDA rays and (T,K) candidate lists
    with `lanes` lanes a ray (None: ``lanes_per_ray`` of the shape)."""
    global launches
    T, P, K = _check(_TILE_WALK, bricks, o, d, codes, ids, t_codes, depth,
                     top_depth, 2 ** 31 - 1)
    if lanes is None:
        lanes = lanes_per_ray(T, P, thread_slots(o.device))
    if lanes not in LANES:
        raise ValueError(f"{lanes} lanes a ray: the kernel takes one of {LANES}")
    hit_leaf, hit_t, iters = _outputs(T, P, o.device)
    _TILE_WALK(o.device, bricks.data_ptr(), o.data_ptr(), d.data_ptr(),
               codes.data_ptr(), ids.data_ptr(), t_codes.data_ptr(), T, P, K,
               depth, top_depth, lanes, hit_leaf.data_ptr(), hit_t.data_ptr(),
               iters.data_ptr())
    launches += 1
    return hit_leaf, hit_t, iters


def _walk_serial_kernel(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """Launch ``tile_walk_serial``, one thread a ray (P <= 256)."""
    global serial_launches
    T, P, K = _check(_TILE_WALK_SERIAL, bricks, o, d, codes, ids, t_codes,
                     depth, top_depth, P_LIMIT)
    hit_leaf, hit_t, iters = _outputs(T, P, o.device)
    _TILE_WALK_SERIAL(o.device, bricks.data_ptr(), o.data_ptr(), d.data_ptr(),
                      codes.data_ptr(), ids.data_ptr(), t_codes.data_ptr(), T,
                      P, K, depth, top_depth, hit_leaf.data_ptr(),
                      hit_t.data_ptr(), iters.data_ptr())
    serial_launches += 1
    return hit_leaf, hit_t, iters


def tile_walk(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """Walk (T,P,3) rays through their tiles' (T,K) candidate lists
    (arguments and results as ``tile.walk_plain``). The kernel runs for
    CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cpu":
        return tile.walk_plain(bricks, o, d, codes, ids, t_codes, depth,
                               top_depth)
    return _walk_kernel(bricks, o, d, codes, ids, t_codes, depth, top_depth)


def tile_walk_serial(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """``tile_walk`` through the walker's first form, one thread a ray: the
    same results. The kernel runs for CUDA tensors, the plain version for
    CPU tensors."""
    if o.device.type == "cpu":
        return tile.walk_plain(bricks, o, d, codes, ids, t_codes, depth,
                               top_depth)
    return _walk_serial_kernel(bricks, o, d, codes, ids, t_codes, depth,
                               top_depth)


def level_widths(top_depth, caps, k_max):
    """The keys phase 1 keeps at each level 0..top_depth, a static rule that
    ``tile.candidates_plain`` follows by slicing: 1 at level 0, then
    min(cap_l, 8 * the last level's), where cap_l is min(caps[l], 8^l)
    (caps[-1] past its end) and, at the finest level, min(k_max, 8^l). A
    level drops keys, and lowers drop_t, where its width is below 8 times
    the last one's."""
    widths = [1]
    for l in range(1, top_depth + 1):
        cap = min(caps[l] if l < len(caps) else caps[-1], 8 ** l)
        if l == top_depth:
            cap = min(k_max, 8 ** l)
        widths.append(min(cap, 8 * widths[-1]))
    return tuple(widths)


def candidate_warps(widths):
    """Warps a tile for ``tile_candidates`` from the static `widths` of
    ``level_widths``: one (eight tiles a block, no block barrier) while the
    widest level expands at most WARP_SLOTS child slots, 8 * the widest width
    above the finest (the frame's main call: 480), else a block of eight (the
    frame's enlarged-K and sub-tile calls: 1,280, on a hundred tiles or
    fewer)."""
    return 1 if 8 * max(widths[:-1]) <= WARP_SLOTS else 8


def _candidates_check(kernel, pyr, cellmap, corners, apex, top_depth, caps,
                      k_max):
    """The one check of both phase-1 kernels' arguments; returns the
    widths and the four outputs, allocated."""
    if not 1 <= top_depth <= TOP_DEPTH_LIMIT:
        raise ValueError(f"top_depth {top_depth} out of range: the kernel "
                         f"takes 1 to {TOP_DEPTH_LIMIT}")
    if not 1 <= k_max <= WIDTH_LIMIT:
        raise ValueError(f"k_max {k_max} out of range: the kernel takes 1 to "
                         f"{WIDTH_LIMIT}")
    for l in range(1, top_depth):
        cap = caps[l] if l < len(caps) else caps[-1]
        if not 1 <= cap <= WIDTH_LIMIT:
            raise ValueError(f"caps[{min(l, len(caps) - 1)}] = {cap} out of "
                             f"range: the kernel takes 1 to {WIDTH_LIMIT}")
    if corners.dim() != 3:
        raise ValueError(f"corners has shape {tuple(corners.shape)}, "
                         f"expected (T, 4, 3)")
    T = corners.shape[0]
    if not 1 <= T < 2 ** 31:
        raise ValueError(f"corners holds {T} tiles: the kernel takes 1 to "
                         f"2**31 - 1")
    n_words = tile._pyr_layout(top_depth)[1]
    kernel.check(corners.device, (
        ("pyr", pyr, _I32, (n_words,)),
        ("cellmap", cellmap, _I32, (max(1, 8 ** top_depth // 32), 2)),
        ("corners", corners, _F32, (T, 4, 3)), ("apex", apex, _F32, (3,))))
    dev = corners.device
    return level_widths(top_depth, caps, k_max), (
        torch.empty((T, k_max), dtype=_I32, device=dev),
        torch.empty((T, k_max), dtype=_I32, device=dev),
        torch.empty((T, k_max), dtype=_F32, device=dev),
        torch.empty((T,), dtype=_F32, device=dev))


def candidates(pyr, cellmap, corners, apex, top_depth, caps, k_max,
               warps=None):
    """Launch ``tile_candidates`` on CUDA tensors: phase 1 for every tile of
    the (T, 4, 3) contiguous `corners` (arguments and results as
    ``tile.candidates_plain``), `warps` warps a tile (None:
    ``candidate_warps`` of the widths). `apex` is the (3,) float32 camera
    position on the card; nothing is read back to the host. top_depth must
    be 1..10, and k_max and every cap of levels 1..top_depth-1 1..256."""
    global candidates_launches
    if warps is not None and warps not in CANDIDATE_WARPS:
        raise ValueError(f"{warps} warps a tile: the kernel takes one of "
                         f"{CANDIDATE_WARPS}")
    widths, out = _candidates_check(_TILE_CANDIDATES, pyr, cellmap, corners,
                                    apex, top_depth, caps, k_max)
    if warps is None:
        warps = candidate_warps(widths)
    _TILE_CANDIDATES(corners.device, pyr.data_ptr(), cellmap.data_ptr(),
                     corners.data_ptr(), apex.data_ptr(), corners.shape[0],
                     top_depth, (ctypes.c_int * len(widths))(*widths), k_max,
                     warps, *(t.data_ptr() for t in out))
    candidates_launches += 1
    return out


def candidates_block(pyr, cellmap, corners, apex, top_depth, caps, k_max):
    """``candidates`` through the first form, ``tile_candidates_block`` (one
    block a tile, each level's keys sorted in full): the same results, on
    CUDA tensors."""
    global candidates_block_launches
    widths, out = _candidates_check(_TILE_CANDIDATES_BLOCK, pyr, cellmap,
                                    corners, apex, top_depth, caps, k_max)
    _TILE_CANDIDATES_BLOCK(corners.device, pyr.data_ptr(), cellmap.data_ptr(),
                           corners.data_ptr(), apex.data_ptr(),
                           corners.shape[0], top_depth,
                           (ctypes.c_int * len(widths))(*widths), k_max,
                           *(t.data_ptr() for t in out))
    candidates_block_launches += 1
    return out
