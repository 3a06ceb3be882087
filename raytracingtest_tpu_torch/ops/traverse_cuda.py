"""ESVO traversal on the card: the wrappers of ``csrc/esvo_trace.cu``.

Counterpart of ``raytracingtest_tpu/ops/traverse_pallas.py``. CUDA tensors
go to a hand-written kernel; CPU tensors go to the plain PyTorch version in
``ops/traverse.py``. Both kernels run one thread a ray and give the same
bits. ``esvo_trace``, the main path's, reads a node's mask only when the
ray's node changes and keeps a mask of written stack slots instead of
zeroing the stack; ``esvo_trace_serial`` is the first form, the check of the
other and its yardstick, which nothing on the main path launches. Nothing
else picks the path: a build or launch failure raises.
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
# path a run took): esvo_trace, and its serial form
launches = 0
serial_launches = 0

_ESVO_TRACE = Kernel("esvo_trace", trace_lib)
_ESVO_TRACE_SERIAL = Kernel("esvo_trace_serial", trace_lib)


def _check(kernel, svo, origin, direction):
    """The one check of both kernels' arguments; returns the ray count."""
    if origin.dim() != 2:
        raise ValueError(f"origin has shape {tuple(origin.shape)}, expected (N, 3)")
    n = origin.shape[0]
    kernel.check(origin.device, (
        ("origin", origin, _F32, (n, 3)), ("direction", direction, _F32, (n, 3)),
        ("masks", svo.masks, _I32, (svo.masks.shape[0],)),
        ("child_base", svo.child_base, _I32, (svo.child_base.shape[0],)),
        ("leaf_base", svo.leaf_base, _I32, (svo.leaf_base.shape[0],))))
    if not 1 <= svo.depth <= S_MAX or n >= 2 ** 31:
        raise ValueError(f"depth {svo.depth} or ray count {n} out of range")
    return n


def _outputs(n, device):
    return tuple(torch.empty(n, dtype=dtype, device=device)
                 for dtype in (_I32, _F32, _I32, _I32, _I32))


def _trace_kernel(svo, origin, direction) -> TraceResult:
    """Launch ``esvo_trace`` on (N, 3) float32 CUDA rays, any N."""
    global launches
    n = _check(_ESVO_TRACE, svo, origin, direction)
    out = _outputs(n, origin.device)
    _ESVO_TRACE(origin.device, svo.masks.data_ptr(), svo.child_base.data_ptr(),
                svo.leaf_base.data_ptr(), origin.data_ptr(),
                direction.data_ptr(), n, svo.depth,
                *(t.data_ptr() for t in out))
    launches += 1
    return TraceResult(*out)


def _trace_serial_kernel(svo, origin, direction) -> TraceResult:
    """Launch ``esvo_trace_serial`` on (N, 3) float32 CUDA rays, any N."""
    global serial_launches
    n = _check(_ESVO_TRACE_SERIAL, svo, origin, direction)
    out = _outputs(n, origin.device)
    _ESVO_TRACE_SERIAL(origin.device, svo.masks.data_ptr(),
                       svo.child_base.data_ptr(), svo.leaf_base.data_ptr(),
                       origin.data_ptr(), direction.data_ptr(), n, svo.depth,
                       *(t.data_ptr() for t in out))
    serial_launches += 1
    return TraceResult(*out)


def _aligned(origin):
    n = origin.shape[0]
    if n % TILE_N:
        raise ValueError(f"ray count {n} not a multiple of {TILE_N}")


def trace_cuda(svo, origin, direction) -> TraceResult:
    """Trace (N, 3) float32 rays in octree-local coordinates; N must be a
    multiple of TILE_N (pad upstream). The kernel runs for CUDA tensors, the
    plain version for CPU tensors."""
    _aligned(origin)
    if origin.device.type == "cpu":
        return traverse.trace(svo, origin, direction)
    return _trace_kernel(svo, origin, direction)


def trace_cuda_serial(svo, origin, direction) -> TraceResult:
    """``trace_cuda`` through the first form of the kernel: the same
    results. The kernel runs for CUDA tensors, the plain version for CPU
    tensors."""
    _aligned(origin)
    if origin.device.type == "cpu":
        return traverse.trace(svo, origin, direction)
    return _trace_serial_kernel(svo, origin, direction)
