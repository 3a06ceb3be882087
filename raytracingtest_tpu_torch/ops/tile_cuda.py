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

``candidates`` launches phase 1, which computes what the reference's
``_candidates`` does and gives the same bits as its plain version,
``tile.candidates_plain`` (given a ``brickmap``, followed by
``tile.remap_ids``: the streamed world's brickmap mode). It has two forms
(``CANDIDATE_FORMS``). The first, the search form ``tile_candidates`` (brickmap mode
``tile_candidates_mapped_first``): a warp or a block a tile
(``candidate_warps``), each level's valid keys compacted, the ``width``
smallest selected by a bitwise search, and only the finest level's row
sorted; the tile frame's main path. The radix form (``tile_candidates_mapped``,
unmapped ``tile_candidates_radix``): the same steps with the pyramid's first
levels in shared memory, a level's words in one round trip, light levels a
lane a child slot, a radix selection, and ``PACKED_TILES`` tiles a warp
(or a block a tile with its light levels on one warp); the brickmap mode's
main path. ``probe_candidates`` runs either form with per-warp counters
(``CAND_PROBE_FIELDS``), for measurement only. ``candidates_block``
launches the first form of the unmapped kernel, ``tile_candidates_block``,
one block a tile that sorts each level's keys padded to a power of two: the
check of the others and their yardstick, which nothing on the main path
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
# the tiles a warp of the radix form at one warp a tile
# (csrc/tile_candidates.cu's PACKED_TILES)
PACKED_TILES = 2
# phase 1's forms and their codes in the probe (csrc/tile_candidates.cu's
# FORM_SELECT, FORM_RADIX): "first" is the search form (a level's slots 32 at
# a time, the bitwise search), "radix" the radix form
CANDIDATE_FORMS = ("radix", "first")
FORM_CODES = {"first": 0, "radix": 1}
# a warp's record in the probe form (csrc/tile_candidates.cu's CW_*): int64
# words, cycles by phase (each level's expansion and selection, levels
# 1..10), then the selection's passes, the levels that overflowed and the
# valid keys summed over the levels
CAND_PROBE_FIELDS = (("tile", "start", "end", "sm", "ns_start", "ns_end", "frustum")
                     + tuple(f"expand_l{l}" for l in range(1, TOP_DEPTH_LIMIT + 1))
                     + tuple(f"select_l{l}" for l in range(1, TOP_DEPTH_LIMIT + 1))
                     + ("keep", "sort", "write", "passes", "over", "valid"))

# kernel launches made by this process: tile_walk, its serial form,
# tile_candidates and its first form
launches = 0
serial_launches = 0
candidates_launches = 0
candidates_block_launches = 0
# the radix form in the brickmap mode (the streamed world's phase 1), the search
# form there (its first form), the radix form unmapped (off every path), and
# the probe form
candidates_mapped_launches = 0
candidates_mapped_first_launches = 0
candidates_radix_launches = 0
candidates_probe_launches = 0

_TILE_WALK = Kernel("tile_walk", tile_lib)
_TILE_WALK_SERIAL = Kernel("tile_walk_serial", tile_lib)
_TILE_CANDIDATES = Kernel("tile_candidates", candidates_lib)
_TILE_CANDIDATES_BLOCK = Kernel("tile_candidates_block", candidates_lib)
_TILE_CANDIDATES_MAPPED = Kernel("tile_candidates_mapped", candidates_lib)
_TILE_CANDIDATES_MAPPED_FIRST = Kernel("tile_candidates_mapped_first", candidates_lib)
_TILE_CANDIDATES_RADIX = Kernel("tile_candidates_radix", candidates_lib)
_TILE_CANDIDATES_PROBE = Kernel("tile_candidates_probe", candidates_lib)
# (brickmap mode, form) -> its kernel
_CANDIDATE_KERNELS = {(False, "first"): _TILE_CANDIDATES,
                      (False, "radix"): _TILE_CANDIDATES_RADIX,
                      (True, "first"): _TILE_CANDIDATES_MAPPED_FIRST,
                      (True, "radix"): _TILE_CANDIDATES_MAPPED}

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


def tiles_a_warp(form, warps):
    """Tiles a warp of a launch in `form` at `warps` warps a tile: the radix
    form packs PACKED_TILES at one warp a tile; else one."""
    return PACKED_TILES if (form, warps) == ("radix", 1) else 1


def _warps(widths, warps):
    """The warps a tile of a launch: the caller's, checked, or
    ``candidate_warps`` of the widths."""
    if warps is not None and warps not in CANDIDATE_WARPS:
        raise ValueError(f"{warps} warps a tile: the kernel takes one of "
                         f"{CANDIDATE_WARPS}")
    return candidate_warps(widths) if warps is None else warps


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


def _brickmap_check(kernel, brickmap, device):
    if brickmap.dim() != 1 or brickmap.shape[0] < 1:
        raise ValueError(f"brickmap has shape {tuple(brickmap.shape)}, "
                         f"expected (n,) with n >= 1")
    kernel.check(device, (("brickmap", brickmap, _I32, (brickmap.shape[0],)),))


def candidates(pyr, cellmap, corners, apex, top_depth, caps, k_max,
               warps=None, brickmap=None, form=None):
    """Launch phase 1 on CUDA tensors: every tile of the (T, 4, 3)
    contiguous `corners` (arguments and results as
    ``tile.candidates_plain``), `warps` warps a tile (None:
    ``candidate_warps`` of the widths). `apex` is the (3,) float32 camera
    position on the card; nothing is read back to the host. top_depth must
    be 1..10, and k_max and every cap of levels 1..top_depth-1 1..256.

    `brickmap` (int32, at least one entry an occupied cell of the pyramid):
    the brickmap mode, whose ids are ``tile.remap_ids`` of the plain
    version's, rows of a streaming arena's bricks.

    `form`, one of CANDIDATE_FORMS (None: the mode's main path, "radix" in
    the brickmap mode and "first" without): ``tile_candidates_mapped`` and
    ``tile_candidates_radix`` are the radix form in the two modes,
    ``tile_candidates_mapped_first`` and ``tile_candidates`` the search form's."""
    global candidates_launches, candidates_mapped_launches
    global candidates_mapped_first_launches, candidates_radix_launches
    if form is None:
        form = "first" if brickmap is None else "radix"
    kernel = _CANDIDATE_KERNELS.get((brickmap is not None, form))
    if kernel is None:
        raise ValueError(f"form {form!r}: phase 1 has {CANDIDATE_FORMS}")
    widths, out = _candidates_check(kernel, pyr, cellmap, corners, apex,
                                    top_depth, caps, k_max)
    warps = _warps(widths, warps)
    head = (corners.shape[0], top_depth, (ctypes.c_int * len(widths))(*widths),
            k_max, warps)
    if brickmap is None:
        kernel(corners.device, pyr.data_ptr(), cellmap.data_ptr(),
               corners.data_ptr(), apex.data_ptr(), *head,
               *(t.data_ptr() for t in out))
        if form == "first":
            candidates_launches += 1
        else:
            candidates_radix_launches += 1
    else:
        _brickmap_check(kernel, brickmap, corners.device)
        kernel(corners.device, pyr.data_ptr(), cellmap.data_ptr(),
               brickmap.data_ptr(), corners.data_ptr(), apex.data_ptr(), *head,
               *(t.data_ptr() for t in out))
        if form == "radix":
            candidates_mapped_launches += 1
        else:
            candidates_mapped_first_launches += 1
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


def probe_candidates(pyr, cellmap, corners, apex, top_depth, caps, k_max,
                     form, warps=None, brickmap=None):
    """``candidates`` in `form` (one of CANDIDATE_FORMS) through its probe
    form, on CUDA tensors, in the brickmap mode given a `brickmap`: the same
    four outputs, and a (warps of the launch, len(CAND_PROBE_FIELDS)) int64
    record, a row a warp (all zeros for a warp without a tile), for
    measurement only."""
    global candidates_probe_launches
    if form not in CANDIDATE_FORMS:
        raise ValueError(f"form {form!r}: phase 1 has {CANDIDATE_FORMS}")
    widths, out = _candidates_check(_TILE_CANDIDATES_PROBE, pyr, cellmap,
                                    corners, apex, top_depth, caps, k_max)
    warps = _warps(widths, warps)
    if brickmap is not None:
        _brickmap_check(_TILE_CANDIDATES_PROBE, brickmap, corners.device)
    T = corners.shape[0]
    groups, per_block = -(-T // tiles_a_warp(form, warps)), 8 // warps
    record = torch.zeros((-(-groups // per_block) * 8, len(CAND_PROBE_FIELDS)),
                         dtype=torch.int64, device=corners.device)
    _TILE_CANDIDATES_PROBE(
        corners.device, FORM_CODES[form], pyr.data_ptr(), cellmap.data_ptr(),
        None if brickmap is None else brickmap.data_ptr(), corners.data_ptr(),
        apex.data_ptr(), T, top_depth, (ctypes.c_int * len(widths))(*widths),
        k_max, warps, *(t.data_ptr() for t in out), record.data_ptr())
    candidates_probe_launches += 1
    return out, record
