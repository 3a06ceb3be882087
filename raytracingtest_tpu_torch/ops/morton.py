"""3D Morton (Z-order) encode and decode.

Port of ``raytracingtest_tpu/ops/morton.py``: magic-number bit spreading,
x in bit 0 of each triple (x varies fastest, the octree's child order).

The 32-bit pair interleaves 10 bits an axis (octree depth <= 10). It takes
numpy arrays, as the reference's numpy path does (uint32 codes, int32
coordinates), or torch tensors: torch has no full uint32 arithmetic, so a
code is carried as an int32 bit pattern and every right shift is masked
(an int32 shifts in its sign bit). The 64-bit pair (21 bits an axis) takes
numpy (uint64 codes and int64 coordinates, as the reference has it); its
encoder also takes tensors (int64 codes: 63 bits fit).
"""

from __future__ import annotations

import numpy as np
import torch

# the spreading masks of the 32-bit pair, from one bit a triple to ten
# bits packed; all below 2^31, so they are int32 values too
_M32 = (0x09249249, 0x030C30C3, 0x0300F00F, 0x030000FF, 0x3FF)
_S32 = (2, 4, 8, 16)


def _part1by2_32(v):
    """Spread the low 10 bits of v to every third bit."""
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int32) & 0x3FF
        for shift, mask in zip(reversed(_S32), reversed(_M32[:-1])):
            v = (v | (v << shift)) & mask
        return v
    u = np.uint32
    v = np.asarray(v).astype(np.uint32) & u(0x3FF)
    for shift, mask in zip(reversed(_S32), reversed(_M32[:-1])):
        v = (v | (v << u(shift))) & u(mask)
    return v


def _compact1by2_32(v):
    """Gather every third bit of v into its low 10 bits."""
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int32) & _M32[0]
        for shift, mask in zip(_S32, _M32[1:]):
            # v is non-negative here, but a right shift of an int32 is
            # masked all the same (F1)
            v = (v | ((v >> shift) & (0x7FFFFFFF >> (shift - 1)))) & mask
        return v
    u = np.uint32
    v = np.asarray(v).astype(np.uint32) & u(_M32[0])
    for shift, mask in zip(_S32, _M32[1:]):
        v = (v | (v >> u(shift))) & u(mask)
    return v


def _shr32(code, shift):
    """code >> shift as a uint32 would shift: masked for an int32 tensor."""
    if isinstance(code, torch.Tensor):
        return (code.to(torch.int32) >> shift) & (0x7FFFFFFF >> (shift - 1))
    return np.asarray(code).astype(np.uint32) >> np.uint32(shift)


def morton_encode(x, y, z):
    """Interleave three coordinates of at most 10 bits into one 30-bit Morton
    code: uint32 for numpy input, an int32 tensor for tensor input."""
    if isinstance(x, torch.Tensor):
        return (_part1by2_32(x) | (_part1by2_32(y) << 1)
                | (_part1by2_32(z) << 2))
    u = np.uint32
    return (_part1by2_32(x) | (_part1by2_32(y) << u(1))
            | (_part1by2_32(z) << u(2)))


def morton_decode(code):
    """Inverse of morton_encode: (x, y, z) as int32 arrays or tensors."""
    if isinstance(code, torch.Tensor):
        code = code.to(torch.int32)
        return (_compact1by2_32(code), _compact1by2_32(_shr32(code, 1)),
                _compact1by2_32(_shr32(code, 2)))
    code = np.asarray(code).astype(np.uint32)
    return tuple(_compact1by2_32(c).astype(np.int32)
                 for c in (code, _shr32(code, 1), _shr32(code, 2)))


# the spreading shifts and masks of the 64-bit pair, from 21 bits packed to
# one bit a triple; all below 2^63, so they are int64 values too
_S64 = (32, 16, 8, 4, 2)
_M64 = (0x1F00000000FFFF, 0x1F0000FF0000FF, 0x100F00F00F00F00F,
        0x10C30C30C30C30C3, 0x1249249249249249)


def _part1by2_64(v):
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int64) & 0x1FFFFF
        for shift, mask in zip(_S64, _M64):
            v = (v | (v << shift)) & mask
        return v
    u = np.uint64
    v = np.asarray(v).astype(np.uint64) & u(0x1FFFFF)
    for shift, mask in zip(_S64, _M64):
        v = (v | (v << u(shift))) & u(mask)
    return v


def _compact1by2_64(v):
    u = np.uint64
    v = np.asarray(v).astype(np.uint64) & u(0x1249249249249249)
    v = (v | (v >> u(2))) & u(0x10C30C30C30C30C3)
    v = (v | (v >> u(4))) & u(0x100F00F00F00F00F)
    v = (v | (v >> u(8))) & u(0x1F0000FF0000FF)
    v = (v | (v >> u(16))) & u(0x1F00000000FFFF)
    v = (v | (v >> u(32))) & u(0x1FFFFF)
    return v


def morton_encode64(x, y, z):
    """64-bit Morton encode of three coordinates of at most 21 bits: uint64
    codes for numpy input, int64 for tensor input (63 bits: the same
    values)."""
    if isinstance(x, torch.Tensor):
        return _part1by2_64(x) | (_part1by2_64(y) << 1) | (_part1by2_64(z) << 2)
    u = np.uint64
    return (_part1by2_64(x) | (_part1by2_64(y) << u(1))
            | (_part1by2_64(z) << u(2)))


def morton_decode64(code):
    """Inverse of morton_encode64: (x, y, z) int64 arrays."""
    code = np.asarray(code).astype(np.uint64)
    u = np.uint64
    return tuple(_compact1by2_64(c).astype(np.int64)
                 for c in (code, code >> u(1), code >> u(2)))
