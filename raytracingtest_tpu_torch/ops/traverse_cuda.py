"""ESVO traversal on the card: the wrapper of ``csrc/esvo_trace.cu``.

Counterpart of ``raytracingtest_tpu/ops/traverse_pallas.py``. CUDA tensors
go to the hand-written kernel (one thread per ray); CPU tensors go to the
plain PyTorch version in ``ops/traverse.py``. Nothing else picks the path:
a build or launch failure raises.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch.ops import traverse
from raytracingtest_tpu_torch.ops.traverse import S_MAX, TraceResult

# trace_cuda keeps trace_pallas's contract: a multiple of one (8, 128) tile
TILE_N = 1024

# kernel launches made by this process (a plain count, for checks of the
# path a run took)
launches = 0


def _check(t, name, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim or (ndim == 2 and t.shape[1] != 3):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _trace_kernel(svo, origin, direction) -> TraceResult:
    """Launch the traversal kernel on (N, 3) float32 CUDA rays, any N."""
    global launches
    device = origin.device
    if device.type != "cuda":
        raise ValueError(f"the traversal kernel takes CUDA tensors, got {device}")
    _check(origin, "origin", torch.float32, 2, device)
    _check(direction, "direction", torch.float32, 2, device)
    for name in ("masks", "child_base", "leaf_base"):
        _check(getattr(svo, name), name, torch.int32, 1, device)
    n = origin.shape[0]
    if direction.shape[0] != n:
        raise ValueError("origin and direction differ in length")
    if not 1 <= svo.depth <= S_MAX or n >= 2 ** 31:
        raise ValueError(f"depth {svo.depth} or ray count {n} out of range")

    from raytracingtest_tpu_torch._build import trace_lib

    lib = trace_lib()
    i32 = dict(dtype=torch.int32, device=device)
    hit_leaf = torch.empty(n, **i32)
    hit_t = torch.empty(n, dtype=torch.float32, device=device)
    hit_parent = torch.empty(n, **i32)
    hit_child = torch.empty(n, **i32)
    iters = torch.empty(n, **i32)
    with torch.cuda.device(device):
        err = lib.esvo_trace(
            svo.masks.data_ptr(), svo.child_base.data_ptr(),
            svo.leaf_base.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            n, svo.depth, hit_leaf.data_ptr(), hit_t.data_ptr(),
            hit_parent.data_ptr(), hit_child.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"esvo_trace launch failed: cudaError {err}")
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
