"""The tile walker on the card: the wrapper of ``tile_walk`` in
``csrc/tile_walk.cu``.

The kernel replaces what the reference's ``_walk_chunk_window`` and
``_resolve_hits`` compute (``raytracingtest_tpu/ops/tile.py``): one block
per tile, one thread per ray, the tile's candidate list and those bricks'
occupancy words staged in shared memory. CUDA tensors go to the kernel;
CPU tensors go to the plain version, ``tile.walk_plain``. Nothing else
picks the path: a build or launch failure raises.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._build import tile_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops import tile
from raytracingtest_tpu_torch.ops.brick import BRICK_LEVELS
from raytracingtest_tpu_torch.ops.traverse import S_MAX

_F32, _I32 = torch.float32, torch.int32

# the kernel's shared-memory arrays hold this many candidates, and a block
# this many rays
K_LIMIT = 256
P_LIMIT = 256

# kernel launches made by this process
launches = 0

_TILE_WALK = Kernel("tile_walk", tile_lib)


def _walk_kernel(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """Launch the walker on (T,P,3) CUDA rays and (T,K) candidate lists."""
    global launches
    device = o.device
    if o.dim() != 3 or o.shape[2] != 3:
        raise ValueError(f"o has shape {tuple(o.shape)}, expected (T, P, 3)")
    T, P = o.shape[0], o.shape[1]
    if ids.dim() != 2 or ids.shape[0] != T:
        raise ValueError(f"ids has shape {tuple(ids.shape)}, expected ({T}, K)")
    K = ids.shape[1]
    _TILE_WALK.check(device, (
        ("o", o, _F32, (T, P, 3)), ("d", d, _F32, (T, P, 3)),
        ("codes", codes, _I32, (T, K)), ("ids", ids, _I32, (T, K)),
        ("t_codes", t_codes, _F32, (T, K)),
        ("bricks", bricks, _I32, (bricks.shape[0], 17))))
    if not (1 <= K <= K_LIMIT and 1 <= P <= P_LIMIT and T >= 1):
        raise ValueError(f"T={T}, P={P}, K={K}: the kernel takes K <= {K_LIMIT} "
                         f"and P <= {P_LIMIT}")
    if not (1 <= top_depth <= 10 and depth == top_depth + BRICK_LEVELS
            and depth <= S_MAX):
        raise ValueError(f"depth {depth} / top_depth {top_depth} out of range")
    hit_leaf = torch.empty((T, P), dtype=_I32, device=device)
    hit_t = torch.empty((T, P), dtype=_F32, device=device)
    iters = torch.empty((T, P), dtype=_I32, device=device)
    _TILE_WALK(device, bricks.data_ptr(), o.data_ptr(), d.data_ptr(),
               codes.data_ptr(), ids.data_ptr(), t_codes.data_ptr(), T, P, K,
               depth, top_depth, hit_leaf.data_ptr(), hit_t.data_ptr(),
               iters.data_ptr())
    launches += 1
    return hit_leaf, hit_t, iters


def tile_walk(bricks, o, d, codes, ids, t_codes, depth, top_depth):
    """Walk (T,P,3) rays through their tiles' (T,K) candidate lists
    (arguments and results as ``tile.walk_plain``). The kernel runs for
    CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cpu":
        return tile.walk_plain(bricks, o, d, codes, ids, t_codes, depth,
                               top_depth)
    return _walk_kernel(bricks, o, d, codes, ids, t_codes, depth, top_depth)
