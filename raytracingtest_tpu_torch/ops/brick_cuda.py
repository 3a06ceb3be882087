"""The per-ray stackless traces on the card: the wrappers of
``csrc/brick_trace.cu``.

Counterparts of ``raytracingtest_tpu/ops/traverse.py::trace_jax`` (the
stackless walk over the full tree, kernel ``esvo_stackless``) and
``raytracingtest_tpu/ops/brick.py::trace_brick_jax`` (the walk over the top
tree with the brick DDA, kernel ``brick_trace``). CUDA tensors go to the
kernels; CPU tensors go to the plain versions, ``traverse.trace_stackless``
and ``brick.trace_brick``, which give the same bits. Nothing else picks the
path: a build or launch failure raises.

The kernels' forms give the same results (FORMS; the source's header says
what each does, and PERF.md what it measured):

  * ``esvo_stackless`` has one form, one thread a ray in blocks of 128:
    ``trace_stackless_cuda``.
  * ``brick_trace``'s ``wide`` form, the main path's (``trace_brick_cuda``):
    one thread a ray in blocks of 256, a parked ray's brick row staged in
    shared memory. Its ``first`` form, blocks of 128 and rows read as the
    DDA needs them, is ``trace_brick_cuda_serial``, the check and the
    yardstick; ``_brick_unstaged_kernel`` is the wide form without the
    staged row, which splits the wide form's gain between its two changes.

``probe_stackless_cuda`` and ``probe_brick_cuda`` launch a form with
per-warp counters (``PROBE_FIELDS``), for measurement only.

All take any ray count and return a ``TraceResult``; with
``with_stats=True`` also (N, 5) int32 statistics a ray
(``traverse.STAT_NAMES``): rounds begun, DDA steps, rounds stopped at the
top walk's cap, the most DDA steps in a round, and whether a bound stopped
the ray while it was still walking.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._build import brick_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops import brick, traverse
from raytracingtest_tpu_torch.ops.traverse import STAT_NAMES, S_MAX, TraceResult

_F32, _I32 = torch.float32, torch.int32

# kernel launches made by this process (plain counts, for checks of the
# path a run took): the main path's, the brick trace's other forms', the
# probe forms'
launches = {"esvo_stackless": 0, "brick_trace": 0}
form_launches = {"brick_trace_serial": 0, "brick_trace_unstaged": 0}
probe_launches = {"esvo_stackless_probe": 0, "brick_trace_probe": 0}

_ESVO_STACKLESS = Kernel("esvo_stackless", brick_lib)
_ESVO_STACKLESS_PROBE = Kernel("esvo_stackless_probe", brick_lib)
_BRICK_TRACE = Kernel("brick_trace", brick_lib)
_BRICK_TRACE_SERIAL = Kernel("brick_trace_serial", brick_lib)
_BRICK_TRACE_UNSTAGED = Kernel("brick_trace_unstaged", brick_lib)
_BRICK_TRACE_PROBE = Kernel("brick_trace_probe", brick_lib)

# each kernel's forms, the brick trace's form numbers in the kernel, and
# the threads of each form's blocks
FORMS = {"brick_trace": ("first", "wide", "unstaged"),
         "esvo_stackless": ("first",)}
FORM_CODES = {"first": 0, "wide": 1, "unstaged": 2}
BLOCKS = {"first": 128, "wide": 256, "unstaged": 256}

# a warp's record in the probe forms: int64 words, in this order (the
# four phases' issues, lanes active summed over the issues, and cycles)
PHASES = ("step", "descent", "dda", "ray")
PROBE_FIELDS = (("start", "end", "rays")
                + tuple(f"{ph}_{what}" for ph in PHASES
                        for what in ("issues", "lanes", "cycles"))
                + ("sm", "ns_start", "ns_end"))


def warps_of(n: int, form: str) -> int:
    """Warps of a launch of `form` over `n` rays: the rows of a probe
    form's record."""
    if n < 0 or form not in BLOCKS:
        raise ValueError(f"ray count {n}, form {form!r}")
    span = BLOCKS[form]
    return (n + span - 1) // span * (span // 32)


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


def _stackless_args(kernel, svo, origin, direction, with_stats):
    """Check a stackless launch; returns (n, pointer arguments before the
    scalars, outputs, stats)."""
    n, rays = _rays(origin, direction)
    parent_ptr = traverse.parent_ptr_of(svo)
    kernel.check(origin.device, rays + (
        _table("masks", svo.masks), _table("child_base", svo.child_base),
        _table("parent_ptr", parent_ptr), _table("leaf_base", svo.leaf_base)))
    if not 1 <= svo.depth <= S_MAX - 1:
        raise ValueError(f"depth {svo.depth} out of range")
    out, stats = _outputs(n, origin.device, with_stats)
    tables = (svo.masks.data_ptr(), svo.child_base.data_ptr(),
              parent_ptr.data_ptr(), svo.leaf_base.data_ptr(),
              origin.data_ptr(), direction.data_ptr())
    return n, tables, out, stats


def _stackless_kernel(svo, origin, direction, with_stats=False):
    """Launch ``esvo_stackless`` on (N, 3) float32 CUDA rays."""
    n, tables, out, stats = _stackless_args(_ESVO_STACKLESS, svo, origin,
                                            direction, with_stats)
    _ESVO_STACKLESS(origin.device, *tables, n, svo.depth, *_results(out, stats))
    launches["esvo_stackless"] += 1
    return TraceResult(*out), stats


def _brick_args(kernel, bsvo, origin, direction, with_stats):
    """Check a brick launch; returns (n, pointer arguments before the
    scalars, outputs, stats)."""
    n, rays = _rays(origin, direction)
    kernel.check(origin.device, rays + (
        _table("top_masks", bsvo.top_masks), _table("top_child", bsvo.top_child),
        _table("top_parent", bsvo.top_parent),
        ("bricks", bsvo.bricks, _I32, (bsvo.bricks.shape[0], 17))))
    if (bsvo.depth != bsvo.top_depth + brick.BRICK_LEVELS
            or not 1 <= bsvo.top_depth or bsvo.depth > S_MAX - 1):
        raise ValueError(f"depth {bsvo.depth} / top_depth {bsvo.top_depth} "
                         f"out of range")
    out, stats = _outputs(n, origin.device, with_stats)
    tables = (bsvo.top_masks.data_ptr(), bsvo.top_child.data_ptr(),
              bsvo.top_parent.data_ptr(), bsvo.bricks.data_ptr(),
              origin.data_ptr(), direction.data_ptr())
    return n, tables, out, stats


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


def _probe_record(n, form, device):
    return torch.zeros((warps_of(n, form), len(PROBE_FIELDS)),
                       dtype=torch.int64, device=device)


def probe_stackless_cuda(svo, origin, direction):
    """``esvo_stackless`` with per-warp counters, on CUDA rays. Returns
    (TraceResult, stats, record): record is (warps, len(PROBE_FIELDS))
    int64."""
    n, tables, out, stats = _stackless_args(_ESVO_STACKLESS_PROBE, svo, origin,
                                            direction, True)
    record = _probe_record(n, "first", origin.device)
    _ESVO_STACKLESS_PROBE(origin.device, *tables, n, svo.depth,
                          *_results(out, stats), record.data_ptr())
    probe_launches["esvo_stackless_probe"] += 1
    return TraceResult(*out), stats, record


def probe_brick_cuda(bsvo, origin, direction, form):
    """``brick_trace`` in `form` (one of its FORMS) with per-warp counters,
    on CUDA rays. Returns (TraceResult, stats, record)."""
    code = _form("brick_trace", form)
    n, tables, out, stats = _brick_args(_BRICK_TRACE_PROBE, bsvo, origin,
                                        direction, True)
    record = _probe_record(n, form, origin.device)
    _BRICK_TRACE_PROBE(origin.device, code, *tables, n, bsvo.depth,
                       bsvo.top_depth, *_results(out, stats), record.data_ptr())
    probe_launches["brick_trace_probe"] += 1
    return TraceResult(*out), stats, record


def trace_stackless_cuda(svo, origin, direction, with_stats=False):
    """The stackless trace of (N, 3) float32 rays in octree-local
    coordinates, any N: the kernel for CUDA tensors, the plain version for
    CPU tensors. Returns a TraceResult, or (TraceResult, stats)."""
    if origin.device.type == "cpu":
        return traverse.trace_stackless(svo, origin, direction, with_stats)
    res, stats = _stackless_kernel(svo, origin, direction, with_stats)
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
