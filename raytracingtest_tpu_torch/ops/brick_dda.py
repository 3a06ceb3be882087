"""The exact 8^3 brick DDA over pre-staged per-ray state: the tile walker's
inner loop on its own.

Counterpart of ``scratch/r4_pallas2.py`` (``pallas_version``, body
``kernel``, math ``dda_steps``): STEPS masked DDA steps for N rays whose
brick-local state (position, t, the brick's 16 occupancy words, the ray's
plane coefficients) is already laid out per ray. ``brick_dda16`` launches
the hand-written kernel ``brick_dda16`` of ``csrc/tile_walk.cu`` for CUDA
tensors and runs the plain version ``dda_steps`` for CPU tensors.

``dda_step`` is the one step both plain versions share (this module's and
the tile walker's, ``ops/tile.py``), as the kernels share one device
function.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch._build import tile_lib
from raytracingtest_tpu_torch._launch import Kernel
from raytracingtest_tpu_torch.ops.brick import _spread3
from raytracingtest_tpu_torch.ops.traverse import S_MAX, _f2i

_F32, _I32 = torch.float32, torch.int32

# kernel launches made by this process
launches = 0

_BRICK_DDA16 = Kernel("brick_dda16", tile_lib)


def dda_step(bpos, t_cur, walking, hit_t, t_coef, t_bias, flip, word_of,
             depth):
    """One masked step of the exact voxel DDA inside an 8^3 brick.

    bpos (N,3) f32 mirrored voxel corner, t_cur (N,) f32, walking (N,) bool,
    hit_t (N,) f32 the ray's best hit so far, t_coef/t_bias (N,3) f32,
    flip (N,3) int32 (0 on mirrored axes, else 7), word_of(wsel) -> the
    ray's occupancy word `wsel` (int32 bit pattern). Returns (bpos, t_cur,
    hit_now, exit_b, stay, idx9): an occupied voxel is a hit only while
    t_cur < hit_t, otherwise the ray steps on; a ray that steps out of the
    brick exits."""
    vshift = S_MAX - depth
    vsize = 2.0 ** -depth
    li = (_f2i(bpos) >> vshift) & 7
    aa = li ^ flip
    idx9 = (_spread3(aa[:, 0]) | (_spread3(aa[:, 1]) << 1)
            | (_spread3(aa[:, 2]) << 2))
    w = word_of(idx9 >> 5)
    occ = ((w >> (idx9 & 31)) & 1) != 0
    hit_now = walking & occ & (t_cur < hit_t)

    t_corner = bpos * t_coef - t_bias
    tc_max = torch.amin(t_corner, dim=1)
    adv = walking & ~hit_now
    step_bits = t_corner <= tc_max[:, None]
    exit_b = adv & torch.any(step_bits & (li == 0), dim=1)
    stay = adv & ~exit_b
    bpos = bpos - torch.where(step_bits & stay[:, None], vsize, 0.0)
    t_cur = torch.where(adv, torch.maximum(t_cur, tc_max), t_cur)
    return bpos, t_cur, hit_now, exit_b, stay, idx9


def dda_steps(bpos, t_cur, walking, rw, tc, tb, flip, hit_t, depth=10,
              steps=16):
    """Plain version: `steps` DDA steps. bpos/tc/tb (N,3) f32, t_cur/hit_t
    (N,) f32, walking (N,) bool, rw (16,N) int32 word planes, flip (N,3)
    int32. Returns (hit_t (N,) f32, hit_idx9 (N,) int32, t_cur (N,) f32)."""
    word_of = lambda wsel: torch.gather(rw, 0, wsel.long()[None])[0]
    hit_idx9 = torch.zeros_like(t_cur, dtype=_I32)
    for _ in range(steps):
        bpos, t_cur, hit_now, _exit, walking, idx9 = dda_step(
            bpos, t_cur, walking, hit_t, tc, tb, flip, word_of, depth)
        hit_t = torch.where(hit_now, t_cur, hit_t)
        hit_idx9 = torch.where(hit_now, idx9, hit_idx9)
    return hit_t, hit_idx9, t_cur


def _dda_kernel(bpos, t_cur, walking, rw, tc, tb, flip, hit_t, depth, steps):
    global launches
    device = bpos.device
    n = t_cur.shape[0]
    walking = walking.to(_I32)
    _BRICK_DDA16.check(device, (
        ("bpos", bpos, _F32, (n, 3)), ("t_cur", t_cur, _F32, (n,)),
        ("walking", walking, _I32, (n,)), ("rw", rw, _I32, (16, n)),
        ("tc", tc, _F32, (n, 3)), ("tb", tb, _F32, (n, 3)),
        ("flip", flip, _I32, (n, 3)), ("hit_t", hit_t, _F32, (n,))))
    if not 4 <= depth <= S_MAX or steps < 0 or n >= 2 ** 31:
        raise ValueError(f"depth {depth}, steps {steps} or ray count {n} out of range")
    out_t = torch.empty(n, dtype=_F32, device=device)
    out_idx = torch.empty(n, dtype=_I32, device=device)
    out_tc = torch.empty(n, dtype=_F32, device=device)
    _BRICK_DDA16(device, bpos.data_ptr(), t_cur.data_ptr(), walking.data_ptr(),
                 rw.data_ptr(), tc.data_ptr(), tb.data_ptr(), flip.data_ptr(),
                 hit_t.data_ptr(), n, depth, steps, out_t.data_ptr(),
                 out_idx.data_ptr(), out_tc.data_ptr())
    launches += 1
    return out_t, out_idx, out_tc


def brick_dda16(bpos, t_cur, walking, rw, tc, tb, flip, hit_t, depth=10,
                steps=16):
    """`steps` exact brick-DDA steps for N pre-staged rays (arguments as
    ``dda_steps``). The kernel runs for CUDA tensors, the plain version for
    CPU tensors."""
    if bpos.device.type == "cpu":
        return dda_steps(bpos, t_cur, walking.bool(), rw, tc, tb, flip, hit_t,
                         depth, steps)
    return _dda_kernel(bpos, t_cur, walking, rw, tc, tb, flip, hit_t, depth,
                       steps)
