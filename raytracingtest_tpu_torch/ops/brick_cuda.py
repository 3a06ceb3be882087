"""The per-ray stackless traces on the card: the wrappers of
``csrc/brick_trace.cu``.

Counterparts of ``raytracingtest_tpu/ops/traverse.py::trace_jax`` (the
stackless walk over the full tree, kernel ``esvo_stackless``) and
``raytracingtest_tpu/ops/brick.py::trace_brick_jax`` (the walk over the top
tree with the brick DDA, kernel ``brick_trace``). CUDA tensors go to the
kernels; CPU tensors go to the plain versions, ``traverse.trace_stackless``
and ``brick.trace_brick``, which give the same bits. Nothing else picks the
path: a build or launch failure raises.

Both take any ray count and return a ``TraceResult``; with
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

# kernel launches made by this process (a plain count, for checks of the
# path a run took)
launches = {"esvo_stackless": 0, "brick_trace": 0}

_ESVO_STACKLESS = Kernel("esvo_stackless", brick_lib)
_BRICK_TRACE = Kernel("brick_trace", brick_lib)


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


def _stackless_kernel(svo, origin, direction, with_stats=False):
    """Launch ``esvo_stackless`` on (N, 3) float32 CUDA rays."""
    n, rays = _rays(origin, direction)
    parent_ptr = traverse.parent_ptr_of(svo)
    _ESVO_STACKLESS.check(origin.device, rays + (
        _table("masks", svo.masks), _table("child_base", svo.child_base),
        _table("parent_ptr", parent_ptr), _table("leaf_base", svo.leaf_base)))
    if not 1 <= svo.depth <= S_MAX - 1:
        raise ValueError(f"depth {svo.depth} out of range")
    out, stats = _outputs(n, origin.device, with_stats)
    _ESVO_STACKLESS(origin.device, svo.masks.data_ptr(),
                    svo.child_base.data_ptr(), parent_ptr.data_ptr(),
                    svo.leaf_base.data_ptr(), origin.data_ptr(),
                    direction.data_ptr(), n, svo.depth,
                    *(t.data_ptr() for t in out),
                    None if stats is None else stats.data_ptr())
    launches["esvo_stackless"] += 1
    return TraceResult(*out), stats


def _brick_kernel(bsvo, origin, direction, with_stats=False):
    """Launch ``brick_trace`` on (N, 3) float32 CUDA rays."""
    n, rays = _rays(origin, direction)
    _BRICK_TRACE.check(origin.device, rays + (
        _table("top_masks", bsvo.top_masks), _table("top_child", bsvo.top_child),
        _table("top_parent", bsvo.top_parent),
        ("bricks", bsvo.bricks, _I32, (bsvo.bricks.shape[0], 17))))
    if (bsvo.depth != bsvo.top_depth + brick.BRICK_LEVELS
            or not 1 <= bsvo.top_depth or bsvo.depth > S_MAX - 1):
        raise ValueError(f"depth {bsvo.depth} / top_depth {bsvo.top_depth} "
                         f"out of range")
    out, stats = _outputs(n, origin.device, with_stats)
    _BRICK_TRACE(origin.device, bsvo.top_masks.data_ptr(),
                 bsvo.top_child.data_ptr(), bsvo.top_parent.data_ptr(),
                 bsvo.bricks.data_ptr(), origin.data_ptr(), direction.data_ptr(),
                 n, bsvo.depth, bsvo.top_depth, *(t.data_ptr() for t in out),
                 None if stats is None else stats.data_ptr())
    launches["brick_trace"] += 1
    return TraceResult(*out), stats


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
