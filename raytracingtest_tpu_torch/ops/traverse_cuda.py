"""ESVO traversal on the card: the wrapper of ``csrc/esvo_trace.cu``.

Counterpart of ``raytracingtest_tpu/ops/traverse_pallas.py``. CUDA tensors
go to the hand-written kernel (one thread per ray); CPU tensors go to the
plain PyTorch version in ``ops/traverse.py``. Nothing else picks the path:
a build or launch failure raises.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._build import trace_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops import traverse
from raytracingtest_tpu_torch.ops.traverse import S_MAX, TraceResult

_F32, _I32 = torch.float32, torch.int32

# trace_cuda keeps trace_pallas's contract: a multiple of one (8, 128) tile
TILE_N = 1024

# kernel launches made by this process (a plain count, for checks of the
# path a run took)
launches = 0

_ESVO_TRACE = Kernel("esvo_trace", trace_lib)


def _trace_kernel(svo, origin, direction) -> TraceResult:
    """Launch the traversal kernel on (N, 3) float32 CUDA rays, any N."""
    global launches
    device = origin.device
    if origin.dim() != 2:
        raise ValueError(f"origin has shape {tuple(origin.shape)}, expected (N, 3)")
    n = origin.shape[0]
    _ESVO_TRACE.check(device, (
        ("origin", origin, _F32, (n, 3)), ("direction", direction, _F32, (n, 3)),
        ("masks", svo.masks, _I32, (svo.masks.shape[0],)),
        ("child_base", svo.child_base, _I32, (svo.child_base.shape[0],)),
        ("leaf_base", svo.leaf_base, _I32, (svo.leaf_base.shape[0],))))
    if not 1 <= svo.depth <= S_MAX or n >= 2 ** 31:
        raise ValueError(f"depth {svo.depth} or ray count {n} out of range")
    hit_leaf = torch.empty(n, dtype=_I32, device=device)
    hit_t = torch.empty(n, dtype=_F32, device=device)
    hit_parent = torch.empty(n, dtype=_I32, device=device)
    hit_child = torch.empty(n, dtype=_I32, device=device)
    iters = torch.empty(n, dtype=_I32, device=device)
    _ESVO_TRACE(device, svo.masks.data_ptr(), svo.child_base.data_ptr(),
                svo.leaf_base.data_ptr(), origin.data_ptr(),
                direction.data_ptr(), n, svo.depth, hit_leaf.data_ptr(),
                hit_t.data_ptr(), hit_parent.data_ptr(), hit_child.data_ptr(),
                iters.data_ptr())
    launches += 1
    return TraceResult(hit_leaf, hit_t, hit_parent, hit_child, iters)


def trace_cuda(svo, origin, direction) -> TraceResult:
    """Trace (N, 3) float32 rays in octree-local coordinates; N must be a
    multiple of TILE_N (pad upstream). The kernel runs for CUDA tensors, the
    plain version for CPU tensors."""
    n = origin.shape[0]
    if n % TILE_N:
        raise ValueError(f"ray count {n} not a multiple of {TILE_N}")
    if origin.device.type == "cpu":
        return traverse.trace(svo, origin, direction)
    return _trace_kernel(svo, origin, direction)
