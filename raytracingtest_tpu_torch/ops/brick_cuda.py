"""The per-ray stackless traces on the card: the wrappers of
``csrc/brick_trace.cu``.

Counterparts of ``raytracingtest_tpu/ops/traverse.py::trace_jax`` (the
stackless walk over the full tree, kernel ``esvo_stackless``) and
``raytracingtest_tpu/ops/brick.py::trace_brick_jax`` (the walk over the top
tree with the brick DDA, kernel ``brick_trace``), and of their k-segment
forms ``trace_multi_jax`` and ``trace_brick_multi_jax`` (kernels
``esvo_stackless_multi`` and ``brick_trace_multi``: ``trace_multi_cuda``,
``trace_brick_multi_cuda``), and of their LOD forms ``trace_lod_jax`` and
``trace_brick_lod_jax`` (kernels ``esvo_stackless_lod`` and
``brick_trace_lod``: ``trace_lod_cuda``, ``trace_brick_lod_cuda``). CUDA
tensors go to the kernels; CPU tensors go to the plain versions,
``traverse.trace_stackless``, ``brick.trace_brick``, ``traverse.trace_multi``,
``brick.trace_brick_multi``, ``traverse.trace_lod`` and
``brick.trace_brick_lod``, which give the same bits. Nothing else picks the
path: a build or launch failure raises.

The kernels' forms give the same results (FORMS; the source's header says
what each does, and PERF.md what it measured):

  * ``esvo_stackless``'s ``patched`` form, the main path's
    (``trace_stackless_cuda``): one thread a ray in blocks of 128, the walk
    over the tree's node row table (``traverse.node_rows``: one 16-byte row
    read where the ray's node changes, kept in registers), and with
    ``width=`` the rays of a row-major image walked in warps of 8 x 4 pixel
    patches (``patch_order``); ``width`` changes no output. Its ``first``
    form, one thread a ray in blocks of 128 reading the masks, child_base,
    parent_ptr and leaf_base arrays as the step needs them, in the rays' own
    order, is ``trace_stackless_cuda_serial``, the check and the yardstick.
    ``esvo_stackless_lod`` has the same two forms of the same body
    (``trace_lod_cuda``, ``trace_lod_cuda_serial``); its patched form walks
    the patches over the four arrays (the row table measured slower there).
  * ``brick_trace_lod``'s ``patched`` form, the main path's
    (``trace_brick_lod_cuda``): the body of ``brick_trace``'s wide form with
    the footprint stop (a parked ray's brick row staged in shared memory),
    one thread a ray in blocks of the caller's size, and with ``width=`` the
    rays of a row-major image walked in warps of 8 x 4 pixel patches. Its
    ``first`` form, the same body in blocks of 256 in the rays' own order,
    is ``trace_brick_lod_cuda_serial``.
  * ``brick_trace``'s ``wide`` form, the main path's (``trace_brick_cuda``):
    one thread a ray in blocks of 256, a parked ray's brick row staged in
    shared memory. Its ``first`` form, blocks of 128 and rows read as the
    DDA needs them, is ``trace_brick_cuda_serial``, the check and the
    yardstick; ``_brick_unstaged_kernel`` is the wide form without the
    staged row, which splits the wide form's gain between its two changes.
  * ``esvo_stackless_multi``'s ``patched`` form, the main path's
    (``trace_multi_cuda``): ``esvo_stackless``'s patched form in collect
    mode, a segment's leaf id taken from the row in registers. Its ``first``
    form, one thread a ray in blocks of 128 writing each segment as it is
    found, is ``trace_multi_cuda_serial``.
  * ``brick_trace_multi``'s ``staged`` form, the main path's
    (``trace_brick_multi_cuda``): the walk of ``brick_trace``'s wide form in
    collect mode, each ray's k slots staged in its warp's shared memory and
    written out when the warp's walks end, in one coalesced run, in blocks
    of 32 threads, up to k = ``STAGED_MAX_K``; above it the main path takes
    the ``first`` form. The first form, one thread a ray in blocks of 128
    writing each segment as it is found, is also
    ``trace_brick_multi_cuda_serial``, the check and the yardstick.

``clipmap_kernel`` launches the streamed world's stitched trace
(``clipmap_trace``, or with a brick arena ``clipmap_trace_brick``): the
rounds of ``stream/clipmap.py``'s ``trace_clipmap_device`` and
``trace_clipmap_device_brick``, whose plain versions are in that module.
Each has a ``wide`` form on the main path and its ``first`` form
(``clipmap_kernel(..., form="first")``; one thread a ray in blocks of 128),
the check and the yardstick. ``clipmap_trace``'s wide form makes the
direction's set-up once a ray and scales the origin by the exact reciprocal
of a size that is a power of two; ``clipmap_trace_brick``'s also walks the
chunk with the wide brick trace's body (blocks of 256, the parked brick's
row staged in shared memory). ``probe_clipmap`` and ``probe_clipmap_brick``
run either form with per-warp counters over ``CLIP_NODE_PHASES`` and
``CLIP_PHASES`` (``CLIP_NODE_PROBE_FIELDS``, ``CLIP_PROBE_FIELDS``).

``level_round_kernel`` launches one round of the level-sharded traces
(``level_round``, in its three modes), whose loops and plain version are in
``parallel/level_sharded.py``: its queued form, a thread a live ray or valid
packet, over the round's queue (kernel ``level_queue``: in one pass, a
stable compaction with decoupled look-back; ``level_queue_build`` is that
pass as a loop makes it before its host read). ``level_queue_kernel`` runs
the queue alone in either form, the one pass or its first form (a count
pass, ``torch.cumsum`` and a place pass). ``level_round_serial_kernel`` is
the round's first form, a thread for each ray or packet, the check and the
yardstick; ``probe_level_round`` the first form with per-warp counters.

``probe_stackless_cuda``, ``probe_brick_cuda``, ``probe_stackless_multi_cuda``,
``probe_brick_multi_cuda`` and ``probe_brick_lod_cuda`` launch a form with
per-warp counters
(``PROBE_FIELDS``), for measurement only.

All take any ray count and return a ``TraceResult`` (the k-segment forms a
``MultiTraceResult``); with
``with_stats=True`` also (N, 5) int32 statistics a ray
(``traverse.STAT_NAMES``): rounds begun, DDA steps, rounds stopped at the
top walk's cap, the most DDA steps in a round, and whether a bound stopped
the ray while it was still walking.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracingtest_tpu_torch._build import brick_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops import brick, traverse
from raytracingtest_tpu_torch.ops.traverse import (
    STAT_NAMES, S_MAX, MultiTraceResult, TraceResult)

_F32, _I32 = torch.float32, torch.int32

# kernel launches made by this process (plain counts, for checks of the
# path a run took): the main path's, the brick trace's other forms', the
# probe forms'
launches = {"esvo_stackless": 0, "brick_trace": 0, "esvo_stackless_multi": 0,
            "brick_trace_multi": 0, "esvo_stackless_lod": 0, "brick_trace_lod": 0,
            "clipmap_trace": 0, "clipmap_trace_brick": 0,
            "level_round_sharded": 0, "level_round_trunk": 0,
            "level_round_packets": 0, "level_queue": 0}
form_launches = {"brick_trace_serial": 0, "brick_trace_unstaged": 0,
                 "brick_trace_multi_serial": 0, "level_round_serial": 0,
                 "clipmap_trace_brick_serial": 0, "clipmap_trace_serial": 0,
                 "level_queue_serial": 0, "esvo_stackless_serial": 0,
                 "esvo_stackless_lod_serial": 0, "esvo_stackless_multi_serial": 0,
                 "brick_trace_lod_serial": 0}
probe_launches = {"esvo_stackless_probe": 0, "brick_trace_probe": 0,
                  "esvo_stackless_multi_probe": 0, "brick_trace_multi_probe": 0,
                  "level_round_probe": 0, "clipmap_trace_brick_probe": 0,
                  "clipmap_trace_probe": 0, "brick_trace_lod_probe": 0}

_ESVO_STACKLESS = Kernel("esvo_stackless", brick_lib)
_ESVO_STACKLESS_SERIAL = Kernel("esvo_stackless_serial", brick_lib)
_ESVO_STACKLESS_PROBE = Kernel("esvo_stackless_probe", brick_lib)
_BRICK_TRACE = Kernel("brick_trace", brick_lib)
_BRICK_TRACE_SERIAL = Kernel("brick_trace_serial", brick_lib)
_BRICK_TRACE_UNSTAGED = Kernel("brick_trace_unstaged", brick_lib)
_BRICK_TRACE_PROBE = Kernel("brick_trace_probe", brick_lib)
_ESVO_STACKLESS_MULTI = Kernel("esvo_stackless_multi", brick_lib)
_ESVO_STACKLESS_MULTI_SERIAL = Kernel("esvo_stackless_multi_serial", brick_lib)
_ESVO_STACKLESS_MULTI_PROBE = Kernel("esvo_stackless_multi_probe", brick_lib)
_BRICK_TRACE_MULTI = Kernel("brick_trace_multi", brick_lib)
_BRICK_TRACE_MULTI_SERIAL = Kernel("brick_trace_multi_serial", brick_lib)
_BRICK_TRACE_MULTI_PROBE = Kernel("brick_trace_multi_probe", brick_lib)
_ESVO_STACKLESS_LOD = Kernel("esvo_stackless_lod", brick_lib)
_ESVO_STACKLESS_LOD_SERIAL = Kernel("esvo_stackless_lod_serial", brick_lib)
_BRICK_TRACE_LOD = Kernel("brick_trace_lod", brick_lib)
_BRICK_TRACE_LOD_SERIAL = Kernel("brick_trace_lod_serial", brick_lib)
_BRICK_TRACE_LOD_PROBE = Kernel("brick_trace_lod_probe", brick_lib)
_CLIPMAP_TRACE = Kernel("clipmap_trace", brick_lib)
_CLIPMAP_TRACE_SERIAL = Kernel("clipmap_trace_serial", brick_lib)
_CLIPMAP_TRACE_PROBE = Kernel("clipmap_trace_probe", brick_lib)
_CLIPMAP_TRACE_BRICK = Kernel("clipmap_trace_brick", brick_lib)
_CLIPMAP_TRACE_BRICK_SERIAL = Kernel("clipmap_trace_brick_serial", brick_lib)
_CLIPMAP_TRACE_BRICK_PROBE = Kernel("clipmap_trace_brick_probe", brick_lib)
_LEVEL_ROUND = Kernel("level_round", brick_lib)
_LEVEL_ROUND_SERIAL = Kernel("level_round_serial", brick_lib)
_LEVEL_ROUND_PROBE = Kernel("level_round_probe", brick_lib)
_LEVEL_QUEUE = Kernel("level_queue", brick_lib)
_LEVEL_QUEUE_SERIAL = Kernel("level_queue_serial", brick_lib)

# level_round's modes (csrc/brick_trace.cu's LEVEL_*) and the words of an
# exchanged packet (o_cur, d, octant id and valid flag as int32 bits) and of
# its reply (leaf as int32 bits, t)
LEVEL_MODES = {"sharded": 0, "trunk": 1, "packets": 2}
PACKET_WORDS, REPLY_WORDS = 8, 2
# the queue passes' blocks, and the one pass's tiles (csrc/brick_trace.cu's
# QBLOCK, QTILE)
QBLOCK = 256
QTILE = 16 * QBLOCK

# each kernel's forms (a stackless trace's and the LOD brick trace's main
# path takes its first entry; esvo_stackless_lod has esvo_stackless's), the
# form numbers in the kernels, and the threads of each kernel's forms' blocks (csrc/
# brick_trace.cu's BLOCK, WIDE_BLOCK, MULTI_BLOCK and CLIP_BLOCK:
# clipmap_trace's wide form measured faster in blocks of 128 than of 256;
# the patched forms take their block at launch, up to PATCH_BLOCK_MAX)
FORMS = {"brick_trace": ("first", "wide", "unstaged"),
         "esvo_stackless": ("patched", "first"),
         "brick_trace_multi": ("staged", "first"),
         "esvo_stackless_multi": ("patched", "first"),
         "brick_trace_lod": ("patched", "first"),
         "clipmap_trace_brick": ("wide", "first"),
         "clipmap_trace": ("wide", "first"),
         "level_queue": ("one_pass", "first")}
FORM_CODES = {"first": 0, "wide": 1, "unstaged": 2, "staged": 3, "patched": 4}
BLOCKS = {("brick_trace", "first"): 128, ("brick_trace", "wide"): 256,
          ("brick_trace", "unstaged"): 256, ("esvo_stackless", "first"): 128,
          ("esvo_stackless", "patched"): 128,
          ("brick_trace_multi", "staged"): 32, ("brick_trace_multi", "first"): 128,
          ("esvo_stackless_multi", "first"): 128,
          ("esvo_stackless_multi", "patched"): 128,
          ("brick_trace_lod", "patched"): 128, ("brick_trace_lod", "first"): 256,
          ("clipmap_trace_brick", "wide"): 256, ("clipmap_trace_brick", "first"): 128,
          ("clipmap_trace", "wide"): 128, ("clipmap_trace", "first"): 128,
          ("level_round", "first"): 128}

# brick_trace_multi's staged form takes k up to STAGED_MAX_K: a block of
# 32 rays (csrc/brick_trace.cu's MULTI_BLOCK: the fastest block from k = 8
# on, and within 1.2% of blocks of 128 at k = 4; PERF.md) stages 32 *
# (33 + 3k) 4-byte words (brick_multi_words: the parked brick rows with
# their 16 prefix counts, and the k (leaf, t_in, t_out) slots), at most
# SMEM_MAX bytes, the most an H100 block may opt into. Beyond it the main
# path takes the first form.
STAGED_MAX_K = 594

# a warp's record in the probe forms: int64 words, in this order (the
# five phases' issues, lanes active summed over the issues, and cycles;
# "seg" is a k-segment trace's record of a segment)
PHASES = ("step", "descent", "dda", "ray", "seg")
PROBE_FIELDS = (("start", "end", "rays")
                + tuple(f"{ph}_{what}" for ph in PHASES
                        for what in ("issues", "lanes", "cycles"))
                + ("sm", "ns_start", "ns_end"))


# the stitched brick trace's probe record (csrc/brick_trace.cu's CP_*): the
# same layout over seven phases, a trunk step, a walk's set-up, a chunk's
# top step, the descent into a brick, a DDA step, the box exit, and a round
# (its lanes sum the rays' rounds)
CLIP_PHASES = ("trunk", "setup", "top", "descent", "dda", "exit", "round")
CLIP_PROBE_FIELDS = (("start", "end", "rays")
                     + tuple(f"{ph}_{what}" for ph in CLIP_PHASES
                             for what in ("issues", "lanes", "cycles"))
                     + ("sm", "ns_start", "ns_end"))
# the node arena's stitched probe record (csrc/brick_trace.cu's CN_*): the
# same layout over six phases, a trunk step, a walk's set-up, the origin's
# scaling (o_cur and o_trunk, then o_loc), a chunk's stackless step, the box
# exit, and a round
CLIP_NODE_PHASES = ("trunk", "setup", "scale", "step", "exit", "round")
CLIP_NODE_PROBE_FIELDS = (("start", "end", "rays")
                          + tuple(f"{ph}_{what}" for ph in CLIP_NODE_PHASES
                                  for what in ("issues", "lanes", "cycles"))
                          + ("sm", "ns_start", "ns_end"))


# the patched forms' pixel patch, a warp's (csrc/brick_trace.cu's PATCH_W,
# PATCH_H), and the largest block they are compiled for (PATCH_BLOCK_MAX)
PATCH_W, PATCH_H = 8, 4
PATCH_BLOCK_MAX = 256


def _width(n, width):
    """`width` as a patched launch takes it: 0 for None (the rays' own
    order), else an image width that divides the ray count."""
    if width is None:
        return 0
    if int(width) != width or width < 1 or n % width:
        raise ValueError(f"{n} rays are not a row-major image {width} wide")
    return int(width)


def patch_threads(n: int, width=None) -> int:
    """The threads a patched launch over `n` rays runs: `n` without a
    width, else every lane of the image's 8 x 4 patches."""
    w = _width(n, width)
    if not w:
        return n
    return -(-w // PATCH_W) * -(-(n // w) // PATCH_H) * 32


def patch_order(n: int, width=None) -> torch.Tensor:
    """The patched forms' thread order (csrc/brick_trace.cu's patch_ray):
    (patch_threads(n, width),) int64, entry t the ray that thread t walks,
    -1 for a lane with none. Without a width, the identity. For `n` rays of
    a row-major image `width` wide, warp p walks the p-th 8 x 4 pixel patch
    (patches in row-major order, ceil(width / 8) a patch row), lane l its
    pixel (l % 8, l / 8); lanes past the right or bottom edge idle, and
    every ray is walked once."""
    w = _width(n, width)
    t = torch.arange(patch_threads(n, width), dtype=torch.int64)
    if not w:
        return t
    p, lane = t // 32, t % 32
    pw = -(-w // PATCH_W)
    x = (p % pw) * PATCH_W + lane % PATCH_W
    y = (p // pw) * PATCH_H + lane // PATCH_W
    return torch.where((x < w) & (y < n // w), y * w + x, -1)


def warps_of(n: int, kernel: str, form: str, width=None, block=None) -> int:
    """Warps of a launch of `kernel` in `form` over `n` rays (a patched
    form's over an image `width` wide, in blocks of `block`, None: its
    BLOCKS): the rows of a probe form's record."""
    if n < 0 or (kernel, form) not in BLOCKS:
        raise ValueError(f"ray count {n}, {kernel} form {form!r}")
    span = BLOCKS[(kernel, form)] if block is None else block
    threads = patch_threads(n, width) if form == "patched" else n
    return (threads + span - 1) // span * (span // 32)


def _table(name, t):
    return (name, t, _I32, (t.shape[0],))


def _rays(origin, direction):
    if origin.dim() != 2:
        raise ValueError(f"origin has shape {tuple(origin.shape)}, expected (N, 3)")
    n = origin.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"ray count {n} out of range")
    return n, (("origin", origin, _F32, (n, 3)),
               ("direction", direction, _F32, (n, 3)))


def _outputs(n, device, with_stats):
    out = tuple(torch.empty(n, dtype=dtype, device=device)
                for dtype in (_I32, _F32, _I32, _I32, _I32))
    stats = (torch.empty((n, len(STAT_NAMES)), dtype=_I32, device=device)
             if with_stats else None)
    return out, stats


def _results(out, stats):
    return (*(t.data_ptr() for t in out),
            None if stats is None else stats.data_ptr())


def _form(kernel, form):
    if form not in FORMS[kernel]:
        raise ValueError(f"form {form!r}: {kernel} has {FORMS[kernel]}")
    return FORM_CODES[form]


def _multi_outputs(n, k, device, with_stats):
    """(hit_leaf, t_in, t_out (N, k); count, iters (N,)) and the stats of a
    k-segment launch."""
    out = (torch.empty((n, k), dtype=_I32, device=device),
           torch.empty((n, k), dtype=_F32, device=device),
           torch.empty((n, k), dtype=_F32, device=device),
           torch.empty(n, dtype=_I32, device=device),
           torch.empty(n, dtype=_I32, device=device))
    stats = (torch.empty((n, len(STAT_NAMES)), dtype=_I32, device=device)
             if with_stats else None)
    return out, stats


def _check_k(k, n):
    if not 1 <= k or n * k >= 2 ** 31:
        raise ValueError(f"k = {k} segments a ray for {n} rays out of range")


def _block(block):
    """A patched launch's block: whole warps, up to PATCH_BLOCK_MAX."""
    if not (32 <= block <= PATCH_BLOCK_MAX and block % 32 == 0):
        raise ValueError(f"block of {block} threads out of range")
    return block


def _stackless_args(kernel, svo, origin, direction, with_stats, k=None,
                    form="first", width=None, block=None, rows=None):
    """Check a stackless launch in `form` (a k-segment one with `k`);
    returns (n, the pointer arguments before the scalars, the scalars before
    k and the LOD constants, outputs, stats). The patched form takes the
    tree's node row table (unless `rows` is False: the LOD form's), the
    image width (0: none) and the block; the first form the four arrays,
    each read as the step needs it."""
    n, rays = _rays(origin, direction)
    if rows is None:
        rows = form == "patched"
    if rows:
        table = traverse.node_rows(svo)
        kernel.check(origin.device, rays + (
            ("rows", table, _I32, (svo.masks.shape[0], 4)),))
        heads = (table.data_ptr(),)
    else:
        parent_ptr = traverse.parent_ptr_of(svo)
        kernel.check(origin.device, rays + (
            _table("masks", svo.masks), _table("child_base", svo.child_base),
            _table("parent_ptr", parent_ptr), _table("leaf_base", svo.leaf_base)))
        heads = (svo.masks.data_ptr(), svo.child_base.data_ptr(),
                 parent_ptr.data_ptr(), svo.leaf_base.data_ptr())
    if not 1 <= svo.depth <= S_MAX - 1:
        raise ValueError(f"depth {svo.depth} out of range")
    scalars = (n, svo.depth)
    if form == "patched":
        block = BLOCKS[("esvo_stackless_multi" if k else "esvo_stackless",
                        form)] if block is None else _block(block)
        if patch_threads(n, width) + block >= 2 ** 31:
            raise ValueError(f"{n} rays in patches out of range")
        scalars += (_width(n, width), block)
    elif width is not None:
        raise ValueError("the first form walks the rays in their own order")
    if k is None:
        out, stats = _outputs(n, origin.device, with_stats)
    else:
        _check_k(k, n)
        out, stats = _multi_outputs(n, k, origin.device, with_stats)
    return n, heads + (origin.data_ptr(), direction.data_ptr()), scalars, out, stats


def _main(kernel, form):
    """`form` of the stackless `kernel` (None: its main path's), checked,
    and whether it is the main path's."""
    form = FORMS[kernel][0] if form is None else form
    _form(kernel, form)
    return form, form == FORMS[kernel][0]


def _count(name, main):
    if main:
        launches[name] += 1
    else:
        form_launches[name + "_serial"] += 1


def _stackless_kernel(svo, origin, direction, with_stats=False, width=None,
                      form=None, block=None):
    """Launch ``esvo_stackless`` in `form` (None: the main path's; the
    patched form over an image `width` wide, in blocks of `block`) on (N, 3)
    float32 CUDA rays."""
    form, main = _main("esvo_stackless", form)
    kernel = _ESVO_STACKLESS if form == "patched" else _ESVO_STACKLESS_SERIAL
    n, ptrs, scalars, out, stats = _stackless_args(
        kernel, svo, origin, direction, with_stats, form=form, width=width,
        block=block)
    kernel(origin.device, *ptrs, *scalars, *_results(out, stats))
    _count("esvo_stackless", main)
    return TraceResult(*out), stats


def _stackless_multi_kernel(svo, origin, direction, k, with_stats=False,
                            width=None, form=None, block=None):
    """Launch ``esvo_stackless_multi`` in `form` (None: the main path's) on
    (N, 3) float32 CUDA rays."""
    form, main = _main("esvo_stackless_multi", form)
    kernel = (_ESVO_STACKLESS_MULTI if form == "patched"
              else _ESVO_STACKLESS_MULTI_SERIAL)
    n, ptrs, scalars, out, stats = _stackless_args(
        kernel, svo, origin, direction, with_stats, k, form=form, width=width,
        block=block)
    kernel(origin.device, *ptrs, *scalars, k, *_results(out, stats))
    _count("esvo_stackless_multi", main)
    return MultiTraceResult(*out), stats


def _brick_args(kernel, bsvo, origin, direction, with_stats, k=None):
    """Check a brick launch (a k-segment one with `k`); returns (n, pointer
    arguments before the scalars, outputs, stats)."""
    n, rays = _rays(origin, direction)
    kernel.check(origin.device, rays + (
        _table("top_masks", bsvo.top_masks), _table("top_child", bsvo.top_child),
        _table("top_parent", bsvo.top_parent),
        ("bricks", bsvo.bricks, _I32, (bsvo.bricks.shape[0], 17))))
    if (bsvo.depth != bsvo.top_depth + brick.BRICK_LEVELS
            or not 1 <= bsvo.top_depth or bsvo.depth > S_MAX - 1):
        raise ValueError(f"depth {bsvo.depth} / top_depth {bsvo.top_depth} "
                         f"out of range")
    if k is None:
        out, stats = _outputs(n, origin.device, with_stats)
    else:
        _check_k(k, n)
        out, stats = _multi_outputs(n, k, origin.device, with_stats)
    tables = (bsvo.top_masks.data_ptr(), bsvo.top_child.data_ptr(),
              bsvo.top_parent.data_ptr(), bsvo.bricks.data_ptr(),
              origin.data_ptr(), direction.data_ptr())
    return n, tables, out, stats


def _brick_multi_kernel(bsvo, origin, direction, k, with_stats=False):
    """Launch ``brick_trace_multi``'s main path on (N, 3) float32 CUDA
    rays: the staged form up to k = STAGED_MAX_K, the first form above."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE_MULTI, bsvo, origin,
                                        direction, with_stats, k)
    if k <= STAGED_MAX_K:
        _BRICK_TRACE_MULTI(origin.device, *tables, n, bsvo.depth, bsvo.top_depth,
                           k, *_results(out, stats))
        launches["brick_trace_multi"] += 1
    else:
        _BRICK_TRACE_MULTI_SERIAL(origin.device, *tables, n, bsvo.depth,
                                  bsvo.top_depth, k, *_results(out, stats))
        form_launches["brick_trace_multi_serial"] += 1
    return MultiTraceResult(*out), stats


def _brick_multi_serial_kernel(bsvo, origin, direction, k, with_stats=False):
    """Launch ``brick_trace_multi_serial`` (the first form) on CUDA rays."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE_MULTI_SERIAL, bsvo, origin,
                                        direction, with_stats, k)
    _BRICK_TRACE_MULTI_SERIAL(origin.device, *tables, n, bsvo.depth,
                              bsvo.top_depth, k, *_results(out, stats))
    form_launches["brick_trace_multi_serial"] += 1
    return MultiTraceResult(*out), stats


def _brick_kernel(bsvo, origin, direction, with_stats=False):
    """Launch ``brick_trace`` (the wide form) on (N, 3) float32 CUDA rays."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE, bsvo, origin, direction,
                                        with_stats)
    _BRICK_TRACE(origin.device, *tables, n, bsvo.depth, bsvo.top_depth,
                 *_results(out, stats))
    launches["brick_trace"] += 1
    return TraceResult(*out), stats


def _brick_serial_kernel(bsvo, origin, direction, with_stats=False):
    """Launch ``brick_trace_serial`` (the first form) on CUDA rays."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE_SERIAL, bsvo, origin,
                                        direction, with_stats)
    _BRICK_TRACE_SERIAL(origin.device, *tables, n, bsvo.depth, bsvo.top_depth,
                        *_results(out, stats))
    form_launches["brick_trace_serial"] += 1
    return TraceResult(*out), stats


def _brick_unstaged_kernel(bsvo, origin, direction, with_stats=False):
    """Launch ``brick_trace_unstaged`` (the wide form without its staged
    row) on CUDA rays."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE_UNSTAGED, bsvo, origin,
                                        direction, with_stats)
    _BRICK_TRACE_UNSTAGED(origin.device, *tables, n, bsvo.depth, bsvo.top_depth,
                          *_results(out, stats))
    form_launches["brick_trace_unstaged"] += 1
    return TraceResult(*out), stats


def _lod_args(coef, bias):
    """coef and bias as the kernels take them: float32, each rounded once
    from the Python number (as ``jnp.float32`` rounds it)."""
    return float(np.float32(coef)), float(np.float32(bias))


def _lod_results(out, hit_node, stats):
    """The LOD kernels' output pointers: the trace's five, hit_node, stats."""
    return (*(t.data_ptr() for t in out), hit_node.data_ptr(),
            None if stats is None else stats.data_ptr())


def _stackless_lod_kernel(svo, origin, direction, coef, bias=0.0,
                          with_stats=False, width=None, form=None, block=None):
    """Launch ``esvo_stackless_lod`` in `form` (esvo_stackless's forms; None:
    the main path's) on (N, 3) float32 CUDA rays."""
    form, main = _main("esvo_stackless", form)
    kernel = _ESVO_STACKLESS_LOD if form == "patched" else _ESVO_STACKLESS_LOD_SERIAL
    n, ptrs, scalars, out, stats = _stackless_args(
        kernel, svo, origin, direction, with_stats, form=form, width=width,
        block=block, rows=False)
    hit_node = torch.empty(n, dtype=_I32, device=origin.device)
    kernel(origin.device, *ptrs, *scalars, *_lod_args(coef, bias),
           *_lod_results(out, hit_node, stats))
    _count("esvo_stackless_lod", main)
    return TraceResult(*out, hit_node), stats


def _brick_lod_args(kernel, bsvo, origin, direction, with_stats, form, width,
                    block):
    """Check a ``brick_trace_lod`` launch in `form`; returns (n, the
    arguments before coef and bias: the tables, the rays, n, the depths,
    n_top and, for the patched form, the image width (0: none) and the
    block; outputs, stats, hit_node)."""
    n, tables, out, stats = _brick_args(kernel, bsvo, origin, direction,
                                        with_stats)
    head = (*tables, n, bsvo.depth, bsvo.top_depth, bsvo.n_top)
    if form == "patched":
        block = (BLOCKS[("brick_trace_lod", form)] if block is None
                 else _block(block))
        if patch_threads(n, width) + block >= 2 ** 31:
            raise ValueError(f"{n} rays in patches out of range")
        head += (_width(n, width), block)
    elif width is not None or block is not None:
        raise ValueError(f"the first form walks the rays in their own order, "
                         f"in blocks of {BLOCKS[('brick_trace_lod', form)]}")
    hit_node = torch.empty(n, dtype=_I32, device=origin.device)
    return n, head, out, stats, hit_node


def _brick_lod_kernel(bsvo, origin, direction, coef, bias=0.0, with_stats=False,
                      width=None, form=None, block=None):
    """Launch ``brick_trace_lod`` in `form` (None: the main path's; the
    patched form over an image `width` wide, in blocks of `block`) on (N, 3)
    float32 CUDA rays."""
    form, main = _main("brick_trace_lod", form)
    kernel = _BRICK_TRACE_LOD if form == "patched" else _BRICK_TRACE_LOD_SERIAL
    _n, head, out, stats, hit_node = _brick_lod_args(
        kernel, bsvo, origin, direction, with_stats, form, width, block)
    kernel(origin.device, *head, *_lod_args(coef, bias),
           *_lod_results(out, hit_node, stats))
    _count("brick_trace_lod", main)
    return TraceResult(*out, hit_node), stats


def _probe_record(n, kernel, form, device):
    return torch.zeros((warps_of(n, kernel, form), len(PROBE_FIELDS)),
                       dtype=torch.int64, device=device)


def _probe_stackless_args(kernel, svo, origin, direction, k, form, width, block):
    """A stackless probe launch's arguments (both forms take the row table
    and the four arrays, the width and the block) and outputs."""
    kname = "esvo_stackless_multi" if k else "esvo_stackless"
    code = _form(kname, form)
    n, ptrs, scalars, out, stats = _stackless_args(
        kernel, svo, origin, direction, True, k, form=form, width=width,
        block=block)
    if form == "patched":
        arrays = (svo.masks, svo.child_base, traverse.parent_ptr_of(svo), svo.leaf_base)
        ptrs = (ptrs[0], *(t.data_ptr() for t in arrays), *ptrs[1:])
    else:
        ptrs = (traverse.node_rows(svo).data_ptr(), *ptrs)
        scalars += (0, BLOCKS[(kname, form)])
    record = torch.zeros((warps_of(n, kname, form, width, scalars[3]),
                          len(PROBE_FIELDS)), dtype=torch.int64, device=origin.device)
    return (code, *ptrs, *scalars), out, stats, record


def probe_stackless_cuda(svo, origin, direction, form="first", width=None,
                         block=None):
    """``esvo_stackless`` in `form` (the patched one over an image `width`
    wide, in blocks of `block`) with per-warp counters, on CUDA rays.
    Returns (TraceResult, stats, record): record is (warps,
    len(PROBE_FIELDS)) int64."""
    head, out, stats, record = _probe_stackless_args(
        _ESVO_STACKLESS_PROBE, svo, origin, direction, None, form, width, block)
    _ESVO_STACKLESS_PROBE(origin.device, *head, *_results(out, stats),
                          record.data_ptr())
    probe_launches["esvo_stackless_probe"] += 1
    return TraceResult(*out), stats, record


def probe_brick_cuda(bsvo, origin, direction, form):
    """``brick_trace`` in `form` (one of its FORMS) with per-warp counters,
    on CUDA rays. Returns (TraceResult, stats, record)."""
    code = _form("brick_trace", form)
    n, tables, out, stats = _brick_args(_BRICK_TRACE_PROBE, bsvo, origin,
                                        direction, True)
    record = _probe_record(n, "brick_trace", form, origin.device)
    _BRICK_TRACE_PROBE(origin.device, code, *tables, n, bsvo.depth,
                       bsvo.top_depth, *_results(out, stats), record.data_ptr())
    probe_launches["brick_trace_probe"] += 1
    return TraceResult(*out), stats, record


def probe_brick_lod_cuda(bsvo, origin, direction, coef, form="first",
                         width=None, block=None):
    """``brick_trace_lod`` in `form` (the patched one over an image `width`
    wide, in blocks of `block`) with per-warp counters, on CUDA rays.
    Returns (TraceResult, stats, record): record is (warps,
    len(PROBE_FIELDS)) int64."""
    code = _form("brick_trace_lod", form)
    n, head, out, stats, hit_node = _brick_lod_args(
        _BRICK_TRACE_LOD_PROBE, bsvo, origin, direction, True, form, width, block)
    if form == "first":
        head += (0, BLOCKS[("brick_trace_lod", form)])
    record = torch.zeros((warps_of(n, "brick_trace_lod", form, width, head[-1]),
                          len(PROBE_FIELDS)), dtype=torch.int64, device=origin.device)
    _BRICK_TRACE_LOD_PROBE(origin.device, code, *head, *_lod_args(coef, 0.0),
                           *_lod_results(out, hit_node, stats), record.data_ptr())
    probe_launches["brick_trace_lod_probe"] += 1
    return TraceResult(*out, hit_node), stats, record


def probe_stackless_multi_cuda(svo, origin, direction, k, form="first",
                               width=None, block=None):
    """``esvo_stackless_multi`` in `form` with per-warp counters, on CUDA
    rays. Returns (MultiTraceResult, stats, record)."""
    head, out, stats, record = _probe_stackless_args(
        _ESVO_STACKLESS_MULTI_PROBE, svo, origin, direction, k, form, width, block)
    _ESVO_STACKLESS_MULTI_PROBE(origin.device, *head, k, *_results(out, stats),
                                record.data_ptr())
    probe_launches["esvo_stackless_multi_probe"] += 1
    return MultiTraceResult(*out), stats, record


def probe_brick_multi_cuda(bsvo, origin, direction, k, form):
    """``brick_trace_multi`` in `form` ("staged" or "first") with per-warp
    counters, on CUDA rays. Returns (MultiTraceResult, stats, record)."""
    n, tables, out, stats = _brick_args(_BRICK_TRACE_MULTI_PROBE, bsvo, origin,
                                        direction, True, k)
    code = _form("brick_trace_multi", form)
    if form == "staged" and k > STAGED_MAX_K:
        raise ValueError(f"brick_trace_multi: k = {k} has no staged form")
    record = _probe_record(n, "brick_trace_multi", form, origin.device)
    _BRICK_TRACE_MULTI_PROBE(origin.device, code, *tables, n, bsvo.depth,
                             bsvo.top_depth, k, *_results(out, stats),
                             record.data_ptr())
    probe_launches["brick_trace_multi_probe"] += 1
    return MultiTraceResult(*out), stats, record


def trace_stackless_cuda(svo, origin, direction, with_stats=False, width=None):
    """The stackless trace of (N, 3) float32 rays in octree-local
    coordinates, any N: the kernel for CUDA tensors, the plain version for
    CPU tensors. `width`: the rays are a row-major image that wide (N a
    multiple of it), which the kernel walks in pixel patches; it changes no
    output, and the plain version has no use for it. Returns a TraceResult,
    or (TraceResult, stats)."""
    if origin.device.type == "cpu":
        _width(origin.shape[0], width)
        return traverse.trace_stackless(svo, origin, direction, with_stats)
    res, stats = _stackless_kernel(svo, origin, direction, with_stats, width)
    return (res, stats) if with_stats else res


def trace_stackless_cuda_serial(svo, origin, direction, with_stats=False):
    """``trace_stackless_cuda`` through the first form of the kernel, in the
    rays' own order: the same results."""
    if origin.device.type == "cpu":
        return traverse.trace_stackless(svo, origin, direction, with_stats)
    res, stats = _stackless_kernel(svo, origin, direction, with_stats, form="first")
    return (res, stats) if with_stats else res


def trace_brick_cuda(bsvo, origin, direction, with_stats=False):
    """The brick trace of (N, 3) float32 rays in octree-local coordinates,
    any N: the kernel for CUDA tensors, the plain version for CPU tensors.
    hit_parent and hit_child are the top tree's. Returns a TraceResult, or
    (TraceResult, stats)."""
    if origin.device.type == "cpu":
        return brick.trace_brick(bsvo, origin, direction, with_stats)
    res, stats = _brick_kernel(bsvo, origin, direction, with_stats)
    return (res, stats) if with_stats else res


def trace_brick_cuda_serial(bsvo, origin, direction, with_stats=False):
    """``trace_brick_cuda`` through the first form of the kernel: the same
    results."""
    if origin.device.type == "cpu":
        return brick.trace_brick(bsvo, origin, direction, with_stats)
    res, stats = _brick_serial_kernel(bsvo, origin, direction, with_stats)
    return (res, stats) if with_stats else res


def trace_multi_cuda(svo, origin, direction, k=4, with_stats=False, width=None):
    """The first `k` leaf segments of (N, 3) float32 rays in octree-local
    coordinates through `svo`, any N: kernel ``esvo_stackless_multi`` for
    CUDA tensors, the plain version ``traverse.trace_multi`` for CPU
    tensors. `width`: as ``trace_stackless_cuda``'s. Returns a
    MultiTraceResult, or (MultiTraceResult, stats (N, 5); all zero but
    `unfinished`)."""
    if origin.device.type == "cpu":
        _width(origin.shape[0], width)
        return traverse.trace_multi(svo, origin, direction, k, with_stats)
    res, stats = _stackless_multi_kernel(svo, origin, direction, k, with_stats,
                                         width)
    return (res, stats) if with_stats else res


def trace_multi_cuda_serial(svo, origin, direction, k=4, with_stats=False):
    """``trace_multi_cuda`` through the first form of the kernel: the same
    results."""
    if origin.device.type == "cpu":
        return traverse.trace_multi(svo, origin, direction, k, with_stats)
    res, stats = _stackless_multi_kernel(svo, origin, direction, k, with_stats,
                                         form="first")
    return (res, stats) if with_stats else res


def trace_brick_multi_cuda(bsvo, origin, direction, k=4, with_stats=False):
    """The first `k` leaf segments of (N, 3) float32 rays through the brick
    SVO `bsvo`, any N: kernel ``brick_trace_multi`` for CUDA tensors, the
    plain version ``brick.trace_brick_multi`` for CPU tensors; the segments
    are ``trace_multi_cuda``'s on the source SVO. Returns a
    MultiTraceResult, or (MultiTraceResult, stats (N, 5))."""
    if origin.device.type == "cpu":
        return brick.trace_brick_multi(bsvo, origin, direction, k, with_stats)
    res, stats = _brick_multi_kernel(bsvo, origin, direction, k, with_stats)
    return (res, stats) if with_stats else res


def trace_brick_multi_cuda_serial(bsvo, origin, direction, k=4, with_stats=False):
    """``trace_brick_multi_cuda`` through the first form of the kernel: the
    same results."""
    if origin.device.type == "cpu":
        return brick.trace_brick_multi(bsvo, origin, direction, k, with_stats)
    res, stats = _brick_multi_serial_kernel(bsvo, origin, direction, k, with_stats)
    return (res, stats) if with_stats else res


def trace_lod_cuda(svo, origin, direction, coef, bias=0.0, with_stats=False,
                   width=None):
    """The LOD stackless trace of (N, 3) float32 rays through `svo`, any N:
    kernel ``esvo_stackless_lod`` for CUDA tensors, the plain version
    ``traverse.trace_lod`` for CPU tensors. `width`: as
    ``trace_stackless_cuda``'s. Returns a TraceResult with hit_node, or
    (TraceResult, stats (N, 5); all zero but `unfinished`)."""
    if origin.device.type == "cpu":
        _width(origin.shape[0], width)
        return traverse.trace_lod(svo, origin, direction, coef, bias, with_stats)
    res, stats = _stackless_lod_kernel(svo, origin, direction, coef, bias,
                                       with_stats, width)
    return (res, stats) if with_stats else res


def trace_lod_cuda_serial(svo, origin, direction, coef, bias=0.0,
                          with_stats=False):
    """``trace_lod_cuda`` through the first form of the kernel: the same
    results."""
    if origin.device.type == "cpu":
        return traverse.trace_lod(svo, origin, direction, coef, bias, with_stats)
    res, stats = _stackless_lod_kernel(svo, origin, direction, coef, bias,
                                       with_stats, form="first")
    return (res, stats) if with_stats else res


def trace_brick_lod_cuda(bsvo, origin, direction, coef, bias=0.0,
                         with_stats=False, width=None):
    """The LOD brick trace of (N, 3) float32 rays through `bsvo`, any N:
    kernel ``brick_trace_lod`` for CUDA tensors, the plain version
    ``brick.trace_brick_lod`` for CPU tensors. hit_node rows are the source
    SVO's. `width`: as ``trace_stackless_cuda``'s. Returns a TraceResult, or
    (TraceResult, stats (N, 5))."""
    if origin.device.type == "cpu":
        _width(origin.shape[0], width)
        return brick.trace_brick_lod(bsvo, origin, direction, coef, bias,
                                     with_stats)
    res, stats = _brick_lod_kernel(bsvo, origin, direction, coef, bias,
                                   with_stats, width)
    return (res, stats) if with_stats else res


def trace_brick_lod_cuda_serial(bsvo, origin, direction, coef, bias=0.0,
                                with_stats=False):
    """``trace_brick_lod_cuda`` through the first form of the kernel: the
    same results."""
    if origin.device.type == "cpu":
        return brick.trace_brick_lod(bsvo, origin, direction, coef, bias,
                                     with_stats)
    res, stats = _brick_lod_kernel(bsvo, origin, direction, coef, bias,
                                   with_stats, form="first")
    return (res, stats) if with_stats else res


def _clip_args(kernel, trunk, org, size, roots, origins, sizes, arena, origin,
               direction, chunk_depth, n_max):
    """Check one stitched trace's tensors for `kernel`; returns (its
    arguments up to the outputs, the outputs)."""
    brick_arena = isinstance(arena, brick.BrickSVO)
    n, rays = _rays(origin, direction)
    c = roots.shape[0]
    trunk_pptr = traverse.parent_ptr_of(trunk)
    if brick_arena:
        chunk_tables = (_table("top_masks", arena.top_masks),
                        _table("top_child", arena.top_child),
                        _table("top_parent", arena.top_parent),
                        ("bricks", arena.bricks, _I32, (arena.bricks.shape[0], 17)))
        chunk_ptrs = (arena.top_masks, arena.top_child, arena.top_parent,
                      arena.bricks)
        low = brick.BRICK_LEVELS + 1
    else:
        pptr = traverse.parent_ptr_of(arena)
        chunk_tables = (_table("masks", arena.masks),
                        _table("child_base", arena.child_base),
                        _table("parent_ptr", pptr),
                        _table("leaf_base", arena.leaf_base))
        chunk_ptrs = (arena.masks, arena.child_base, pptr, arena.leaf_base)
        low = 1
    kernel.check(origin.device, rays + chunk_tables + (
        _table("trunk masks", trunk.masks), _table("trunk child_base", trunk.child_base),
        _table("trunk parent_ptr", trunk_pptr), _table("trunk leaf_base", trunk.leaf_base),
        ("roots", roots, _I32, (c,)), ("origins", origins, _F32, (c, 3)),
        ("sizes", sizes, _F32, (c,))))
    if not (1 <= trunk.depth <= S_MAX - 1 and low <= chunk_depth <= S_MAX - 1
            and 0 <= n_max < 2 ** 31):
        raise ValueError(f"trunk depth {trunk.depth}, chunk depth {chunk_depth}, "
                         f"{n_max} rounds out of range")
    dev = origin.device
    out = (torch.empty(n, dtype=_I32, device=dev), torch.empty(n, dtype=_F32, device=dev),
           torch.empty(n, dtype=_I32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    f32 = lambda v: float(np.float32(v))
    head = (trunk.masks.data_ptr(), trunk.child_base.data_ptr(), trunk_pptr.data_ptr(),
            trunk.leaf_base.data_ptr(), roots.data_ptr(), origins.data_ptr(),
            sizes.data_ptr(), *(f32(v) for v in org), f32(size),
            *(t.data_ptr() for t in chunk_ptrs), origin.data_ptr(),
            direction.data_ptr(), n, trunk.depth, chunk_depth, n_max,
            *(t.data_ptr() for t in out))
    return head, out


def clipmap_kernel(trunk, org, size, roots, origins, sizes, arena, origin,
                   direction, chunk_depth, n_max, form=None):
    """Launch ``clipmap_trace`` (`arena` an SVO of the node arena: masks,
    child_base, parent_ptr, leaf_base) or ``clipmap_trace_brick`` (`arena`
    a BrickSVO of the brick arena) on (N, 3) float32 CUDA rays in world
    coordinates: at most `n_max` rounds of the trunk's walk (`trunk` an SVO
    with parent_ptr; its world corner `org` and size `size`, Python floats
    rounded to float32 here) and the chunk's walk from roots[chunk] (chunk
    tables (C,) int32 `roots`, (C, 3) float32 `origins`, (C,) float32
    `sizes`). `form`: one of the kernel's FORMS, None for the main path's
    (each kernel's wide form; its first form, "first", is the check and the
    yardstick). Returns (hit_leaf, hit_t, hit_chunk, truncated (bool))."""
    kname = ("clipmap_trace_brick" if isinstance(arena, brick.BrickSVO)
             else "clipmap_trace")
    form = FORMS[kname][0] if form is None else form
    _form(kname, form)
    main = form == FORMS[kname][0]
    kernel = {("clipmap_trace", True): _CLIPMAP_TRACE,
              ("clipmap_trace", False): _CLIPMAP_TRACE_SERIAL,
              ("clipmap_trace_brick", True): _CLIPMAP_TRACE_BRICK,
              ("clipmap_trace_brick", False): _CLIPMAP_TRACE_BRICK_SERIAL}[(kname, main)]
    head, out = _clip_args(kernel, trunk, org, size, roots, origins, sizes, arena,
                           origin, direction, chunk_depth, n_max)
    kernel(origin.device, *head)
    if main:
        launches[kname] += 1
    else:
        form_launches[kname + "_serial"] += 1
    return out


def probe_clipmap(trunk, org, size, roots, origins, sizes, arena, origin,
                  direction, chunk_depth, n_max, form):
    """``clipmap_trace`` in `form` ("wide" or "first") with per-warp
    counters, on CUDA rays (the arguments of ``clipmap_kernel``, `arena` an
    SVO of the node arena). Returns (its results, record (warps,
    len(CLIP_NODE_PROBE_FIELDS)) int64), for measurement only."""
    code = _form("clipmap_trace", form)
    if isinstance(arena, brick.BrickSVO):
        raise ValueError("probe_clipmap takes the node arena")
    head, out = _clip_args(_CLIPMAP_TRACE_PROBE, trunk, org, size, roots, origins,
                           sizes, arena, origin, direction, chunk_depth, n_max)
    record = torch.zeros((warps_of(origin.shape[0], "clipmap_trace", form),
                          len(CLIP_NODE_PROBE_FIELDS)),
                         dtype=torch.int64, device=origin.device)
    _CLIPMAP_TRACE_PROBE(origin.device, code, *head, record.data_ptr())
    probe_launches["clipmap_trace_probe"] += 1
    return out, record


def probe_clipmap_brick(trunk, org, size, roots, origins, sizes, arena, origin,
                        direction, chunk_depth, n_max, form):
    """``clipmap_trace_brick`` in `form` ("wide" or "first") with per-warp
    counters, on CUDA rays (the arguments of ``clipmap_kernel``, `arena` a
    BrickSVO). Returns (its results, record (warps, len(CLIP_PROBE_FIELDS))
    int64), for measurement only."""
    code = _form("clipmap_trace_brick", form)
    if not isinstance(arena, brick.BrickSVO):
        raise ValueError("probe_clipmap_brick takes the brick arena")
    head, out = _clip_args(_CLIPMAP_TRACE_BRICK_PROBE, trunk, org, size, roots,
                           origins, sizes, arena, origin, direction, chunk_depth,
                           n_max)
    record = torch.zeros((warps_of(origin.shape[0], "clipmap_trace_brick", form),
                          len(CLIP_PROBE_FIELDS)),
                         dtype=torch.int64, device=origin.device)
    _CLIPMAP_TRACE_BRICK_PROBE(origin.device, code, *head, record.data_ptr())
    probe_launches["clipmap_trace_brick_probe"] += 1
    return out, record


def _level_args(mode, trunk, arena, owner, root, origin, size, rank, rays,
                direction, t_off, done, kernel, out=None):
    """Check one level_round call's tensors for `kernel`; returns (n, the
    C arguments before the rays, the ray pointers, the outputs (`out` if
    given, else new), their pointers)."""
    code = LEVEL_MODES[mode]
    dev, n = rays.device, rays.shape[0]
    c = owner.shape[0]
    trunk_pptr = traverse.parent_ptr_of(trunk)
    arena_pptr = traverse.parent_ptr_of(arena)
    specs = [_table("trunk masks", trunk.masks),
             _table("trunk child_base", trunk.child_base),
             _table("trunk parent_ptr", trunk_pptr),
             _table("trunk leaf_base", trunk.leaf_base),
             _table("masks", arena.masks), _table("child_base", arena.child_base),
             _table("parent_ptr", arena_pptr), _table("leaf_base", arena.leaf_base),
             ("owner", owner, _I32, (c,)), ("root", root, _I32, (c,)),
             ("origin", origin, _F32, (c, 3))]
    if mode == "packets":
        specs.append(("packets", rays, _F32, (n, PACKET_WORDS)))
    else:
        specs += [("origin", rays, _F32, (n, 3)), ("direction", direction, _F32, (n, 3)),
                  ("t_off", t_off, _F32, (n,)), ("done", done, torch.bool, (n,))]
    kernel.check(dev, specs)
    if not (1 <= trunk.depth <= S_MAX - 1 and 1 <= arena.depth <= S_MAX - 1
            and n < 2 ** 31):
        raise ValueError(f"trunk depth {trunk.depth}, arena depth {arena.depth} "
                         f"or {n} rays out of range")
    empty = lambda dtype: torch.empty(n, dtype=dtype, device=dev)
    null = 0
    if mode == "packets":
        out = (torch.empty((n, REPLY_WORDS), dtype=_F32, device=dev),)
        ptrs = (null, null, out[0].data_ptr(), null, null)
        ray_ptrs = (rays.data_ptr(), null, null, null)
    else:
        if out is None:
            out = tuple(empty(dt) for dt in ((_I32, _I32, _I32, _F32, _F32)
                                             if mode == "sharded" else (_I32, _F32)))
        if mode == "sharded":
            ptrs = tuple(t.data_ptr() for t in out)
        else:
            ptrs = (out[0].data_ptr(), null, null, null, out[1].data_ptr())
        ray_ptrs = (rays.data_ptr(), direction.data_ptr(), t_off.data_ptr(),
                    done.data_ptr())
    head = (code, trunk.masks.data_ptr(), trunk.child_base.data_ptr(),
            trunk_pptr.data_ptr(), trunk.leaf_base.data_ptr(), trunk.depth,
            arena.masks.data_ptr(), arena.child_base.data_ptr(),
            arena_pptr.data_ptr(), arena.leaf_base.data_ptr(), arena.depth,
            owner.data_ptr(), root.data_ptr(), origin.data_ptr(),
            float(np.float32(size)), int(rank))
    return n, head, ray_ptrs, out, ptrs


class RoundQueue(NamedTuple):
    """A round's queue on the card: ``queue``, whose first ``n_live``
    entries are the round's live rays in order (int32; the one pass keeps
    the count in its last word), and ``n_live``, their count, a (1,) int32
    tensor on the device (``live_count`` reads it)."""

    queue: torch.Tensor
    n_live: torch.Tensor


class LevelQueue:
    """One loop's queue across its rounds ("sharded" or "trunk"), on the
    card: the outputs, kept from round to round (a ray's outputs are written
    as a done ray's once, in the round after it was done, and stay), the
    last round's queue of live rays (None after a first round: every ray),
    its length on the device and a bound on it that the host holds, and the
    one pass's status words (``status``: zeroed once, when the loop's first
    queue is made). A loop makes one and passes it to every round; each
    round's queue then covers the last round's live rays, not every ray. A
    new one's first round must have no ray done, as a loop's first round
    has none: it runs with no queue (thread j, ray j)."""

    def __init__(self):
        self.out = None
        self.prev = None
        self.prev_count = None
        self.bound = 0
        self.status = None

    def entries(self, n):
        """(prev, its device count, the entries a pass covers) of a round
        over `n` rays."""
        if self.prev is None:
            return None, None, n
        return self.prev.data_ptr(), self.prev_count.data_ptr(), self.bound

    def status_words(self, n, device):
        """The one pass's status words for rounds over `n` rays: the
        control word (the launch's epoch and the next tile's ticket) and a
        word a tile, zeroed on first use."""
        if self.status is None:
            self.status = torch.zeros(1 + -(-n // QTILE), dtype=torch.int64,
                                      device=device)
        return self.status


def _out_ptrs(mode, out):
    """The output pointers a queue writes a done ray's outputs at: oct_id,
    hit, leaf, t_hit, t_next ("trunk": oct_id and t_next, the rest null)."""
    if mode == "sharded":
        return tuple(t.data_ptr() for t in out)
    return (out[0].data_ptr(), None, None, None, out[1].data_ptr())


def _new_outputs(mode, n, device):
    return tuple(torch.empty(n, dtype=dt, device=device)
                 for dt in ((_I32, _I32, _I32, _F32, _F32) if mode == "sharded"
                            else (_I32, _F32)))


def _queue_one_pass(mode, done, t_off, ptrs, queue):
    """level_queue's one pass ("sharded" or "trunk") over every ray, or over
    `queue`'s last round's live rays: the round's ``RoundQueue`` and the done
    rays' outputs at `ptrs`, in one launch; nothing crosses to the host."""
    dev, n = done.device, done.shape[0]
    prev, n_prev, grid = queue.entries(n)
    tiles = -(-grid // QTILE) if n else 0
    if not tiles:
        return RoundQueue(torch.empty(0, dtype=_I32, device=dev),
                          torch.zeros(1, dtype=_I32, device=dev))
    # the queue and its count in one allocation: the count in the last word
    order = torch.empty(tiles * QTILE + 1, dtype=_I32, device=dev)
    _LEVEL_QUEUE(dev, LEVEL_MODES[mode], n, done.data_ptr(), t_off.data_ptr(), prev,
                 n_prev, grid, None, 0, queue.status_words(n, dev).data_ptr(),
                 order.data_ptr(), order.data_ptr() + 4 * tiles * QTILE, *ptrs)
    launches["level_queue"] += 1
    return RoundQueue(order, order[-1:])


def _queue_serial(mode, done, t_off, ptrs, queue):
    """level_queue's first form: the count pass (kernel
    ``level_queue_serial``), ``torch.cumsum`` and the place pass (the same
    kernel), over every ray or over `queue`'s last round's live rays; the
    same ``RoundQueue`` and outputs as the one pass."""
    dev, n = done.device, done.shape[0]
    prev, n_prev, grid = queue.entries(n)
    counts = torch.zeros(-(-grid // QBLOCK), dtype=_I32, device=dev)
    order = torch.empty(grid, dtype=_I32, device=dev)
    if n and grid:
        _LEVEL_QUEUE_SERIAL(dev, LEVEL_MODES[mode], n, done.data_ptr(), None, prev,
                            n_prev, grid, counts.data_ptr(), None, None,
                            None, None, None, None, None)
    inclusive = torch.cumsum(counts, 0, dtype=_I32)
    if n and grid:
        _LEVEL_QUEUE_SERIAL(dev, LEVEL_MODES[mode], n, done.data_ptr(), t_off.data_ptr(),
                            prev, n_prev, grid, None, (inclusive - counts).data_ptr(),
                            order.data_ptr(), *ptrs)
        form_launches["level_queue_serial"] += 2
    return RoundQueue(order, inclusive[-1:] if inclusive.numel()
                      else torch.zeros(1, dtype=_I32, device=dev))


def level_queue_build(mode, done, t_off, queue):
    """A loop's round queue ("sharded" or "trunk") over the (N,) bool `done`
    and (N,) float32 `t_off` of the round, over `queue`'s (a
    ``LevelQueue`` after its first round) last round's live rays: kernel
    ``level_queue`` in one pass, the done rays' outputs written into
    ``queue.out``. Returns the ``RoundQueue``; nothing crosses to the
    host."""
    dev, n = done.device, done.shape[0]
    _LEVEL_QUEUE.check(dev, (("done", done, torch.bool, (n,)),
                             ("t_off", t_off, _F32, (n,))))
    if queue.out is None:
        raise ValueError("a loop's first round has no queue")
    return _queue_one_pass(mode, done, t_off, _out_ptrs(mode, queue.out), queue)


def live_count(rq: RoundQueue) -> int:
    """The live rays of a round's queue: one read on the host."""
    return int(rq.n_live)


def level_queue_kernel(mode, done, t_off, form=None, queue=None):
    """A round's queue alone ("sharded" or "trunk"), with nothing read on
    the host, for checks and timing: over every ray, or over the last
    round's live rays of `queue` (a ``LevelQueue``, whose status words the
    one pass uses; its outputs are not touched). `form`: "one_pass" (None:
    the main path's, kernel ``level_queue``) or "first" (``torch.cumsum``
    between the two passes of kernel ``level_queue_serial``). Returns (the
    ``RoundQueue``, the outputs with the done rays' written as the first
    form of the round writes them, the live rays' unset). Its plain version
    is ``level_sharded.level_queue_plain``."""
    form = FORMS["level_queue"][0] if form is None else form
    if form not in FORMS["level_queue"]:
        raise ValueError(f"form {form!r}: level_queue has {FORMS['level_queue']}")
    dev, n = done.device, done.shape[0]
    kernel = _LEVEL_QUEUE if form == "one_pass" else _LEVEL_QUEUE_SERIAL
    kernel.check(dev, (("done", done, torch.bool, (n,)),
                       ("t_off", t_off, _F32, (n,))))
    queue = LevelQueue() if queue is None else queue
    out = _new_outputs(mode, n, dev)
    build = _queue_one_pass if form == "one_pass" else _queue_serial
    return build(mode, done, t_off, _out_ptrs(mode, out), queue), out


def level_round_kernel(mode, trunk, arena, owner, root, origin, size, rank,
                       rays, direction=None, t_off=None, done=None, live=None,
                       built=None, seg=None, queue=None):
    """Launch one round of ``level_round`` in `mode` ("sharded", "trunk" or
    "packets") on CUDA tensors, in its queued form: a thread a live ray or
    valid packet (the first form, a thread for each, is
    ``level_round_serial_kernel``; they give the same bits). `trunk` and
    `arena` are SVOs (masks, child_base, leaf_base, parent_ptr; depths
    trunk_depth and sub_depth); `owner`, `root` (C,) int32 and `origin` (C,
    3) float32 the octant tables, `size` their size (a Python float, rounded
    to float32 here), `rank` this rank. "sharded" and "trunk": `rays` (N, 3)
    float32 origins, `direction` (N, 3), `t_off` (N,) float32 and `done`
    (N,) bool; returns (oct_id, hit, leaf, t_hit, t_next) ("trunk":
    (oct_id, t_next)). `queue`, a loop's ``LevelQueue``, makes the round's
    queue over the last round's live rays and keeps the outputs (the same
    tensors every round: read them before the next); `built` is the round's
    ``level_queue_build(mode, done, t_off, queue)`` if the caller made it
    (else the queue is made here, kernel ``level_queue`` in one pass).
    "packets": `rays` the (M, 8) float32 packets, whose valid ones lie at
    the start of each segment of `seg` slots (M by default), as
    ``make_exchange_trace``'s bucket lays them out; returns the (M, 2)
    float32 replies. `live`, a bound on the live rays or valid packets that
    the caller holds on the host, sizes the grid (N or M by default)."""
    keep = queue is not None and mode != "packets"
    n, head, ray_ptrs, out, ptrs = _level_args(
        mode, trunk, arena, owner, root, origin, size, rank, rays, direction,
        t_off, done, _LEVEL_ROUND, out=queue.out if keep else None)
    dev = rays.device
    grid_n = n if live is None else min(n, int(live))
    if mode == "packets":
        seg = n if seg is None else int(seg)
        if n and (seg < 1 or n % seg):
            raise ValueError(f"{n} packets are not segments of {seg}")
        seg_count = torch.empty(n // seg if n else 0, dtype=_I32, device=dev)
        if n:
            _LEVEL_QUEUE(dev, LEVEL_MODES[mode], n, None, None, None, None, n,
                         rays.data_ptr(), seg, None, seg_count.data_ptr(), None,
                         None, None, out[0].data_ptr(), None, None)
            launches["level_queue"] += 1
        queue_ptrs = (seg_count.data_ptr(), None, seg_count.shape[0], seg)
        built = None
    elif keep and queue.out is None:  # a loop's first round: no ray done
        queue_ptrs = (None, None, 0, 0)
        built = None
    else:
        if keep:
            grid_n = min(grid_n, queue.entries(n)[2])
        if built is None:
            built = _queue_one_pass(mode, done, t_off, ptrs,
                                    queue if keep else LevelQueue())
        queue_ptrs = (built.queue.data_ptr(), built.n_live.data_ptr(), 0, 0)
    if grid_n and (built is None or built.queue.numel()):
        _LEVEL_ROUND(dev, *head, *ray_ptrs, n, *ptrs, *queue_ptrs, grid_n)
        launches["level_round_" + mode] += 1
    if keep:
        queue.out = out
        if built is None:
            queue.prev, queue.prev_count, queue.bound = None, None, n
        else:
            queue.prev, queue.prev_count, queue.bound = built.queue, built.n_live, grid_n
    return out


def level_round_serial_kernel(mode, trunk, arena, owner, root, origin, size, rank,
                              rays, direction=None, t_off=None, done=None):
    """``level_round``'s first form (a thread for each ray or packet; a done
    ray or an invalid packet returns inside its warp): the queued form's
    check and yardstick, on no main path. The arguments and results of
    ``level_round_kernel`` without the queue's."""
    n, head, ray_ptrs, out, ptrs = _level_args(
        mode, trunk, arena, owner, root, origin, size, rank, rays, direction,
        t_off, done, _LEVEL_ROUND_SERIAL)
    _LEVEL_ROUND_SERIAL(rays.device, *head, *ray_ptrs, n, *ptrs)
    form_launches["level_round_serial"] += 1
    return out


def probe_level_round(mode, trunk, arena, owner, root, origin, size, rank,
                      rays, direction=None, t_off=None, done=None):
    """``level_round``'s first form with per-warp counters (``PROBE_FIELDS``;
    "step" a trunk or arena stackless step, "ray" a walk's set-up): (the
    results of ``level_round_serial_kernel``, record (warps, len(
    PROBE_FIELDS)) int64), for measurement only."""
    n, head, ray_ptrs, out, ptrs = _level_args(
        mode, trunk, arena, owner, root, origin, size, rank, rays, direction,
        t_off, done, _LEVEL_ROUND_PROBE)
    record = _probe_record(n, "level_round", "first", rays.device)
    _LEVEL_ROUND_PROBE(rays.device, *head, *ray_ptrs, n, *ptrs, record.data_ptr())
    probe_launches["level_round_probe"] += 1
    return out, record
