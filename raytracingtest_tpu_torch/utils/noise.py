"""Hash-based 3D gradient noise for the host-side SVO builder.

Port of ``raytracingtest_tpu/utils/noise.py`` (numpy path only: the builder
samples scenes on the host). The lattice hash stays in numpy's uint32
arithmetic, which wraps as the hash needs; torch's CPU uint32 operators are
incomplete.

Batches of ``NATIVE_MIN`` points or more go to the threaded C++ twin in
``csrc/noise.cpp``, built on first use (``_build.noise_lib``). That twin
matches the numpy path to about 1 ULP, not bitwise, so the threshold, the
source and the compiler flags are the JAX package's own: both packages then
produce byte-identical SVOs on one machine.
"""

from __future__ import annotations

import numpy as np

# Conservative Lipschitz bound for noise3 per unit coordinate (the JAX
# package's value, validated there by a dense finite-difference sweep).
NOISE3_LIPSCHITZ = 4.0

# batch size from which noise3/fbm3 run in the native library
NATIVE_MIN = 16384


def _native_call(fn, x, y, z, shape, *args):
    from raytracingtest_tpu_torch._build import noise_lib

    lib = noise_lib()
    cols = [np.ascontiguousarray(
        np.broadcast_to(np.asarray(c, np.float32), shape).ravel())
        for c in (x, y, z)]
    out = np.empty_like(cols[0])
    getattr(lib, fn)(*(c.ctypes.data for c in cols), out.ctypes.data,
                     out.size, *args)
    return out.reshape(shape)


def _hash3(ix, iy, iz, seed):
    """Integer lattice hash -> uint32 (wrapping u32 arithmetic)."""
    u = np.uint32
    h = (
        ix.astype(np.uint32) * u(0x8DA6B343)
        ^ iy.astype(np.uint32) * u(0xD8163841)
        ^ iz.astype(np.uint32) * u(0xCB1AB31F)
        ^ u((int(seed) * 0x9E3779B9) & 0xFFFFFFFF)
    )
    h = h ^ (h >> u(13))
    h = h * u(0x5BD1E995)
    h = h ^ (h >> u(15))
    return h


def _fade(t):
    # quintic fade: 6t^5 - 15t^4 + 10t^3
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise3(x, y, z, seed=0):
    """3D gradient noise in roughly [-1, 1]. Shape-preserving, elementwise,
    float32."""
    if np.size(x) >= NATIVE_MIN:
        return _native_call("rtt_noise3", x, y, z, np.shape(x), seed)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    z = np.asarray(z, np.float32)

    x0 = np.floor(x)
    y0 = np.floor(y)
    z0 = np.floor(z)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    ix = x0.astype(np.int32)
    iy = y0.astype(np.int32)
    iz = z0.astype(np.int32)

    u = _fade(fx)
    v = _fade(fy)
    w = _fade(fz)

    def corner(cx, cy, cz):
        h = _hash3(ix + cx, iy + cy, iz + cz, seed)
        gi = (h % np.uint32(12)).astype(np.int32)
        # branch-free decode of the 12 edge gradients (same values as a
        # table lookup)
        one = np.float32(1.0)
        s1 = one - np.float32(2.0) * (gi & 1).astype(np.float32)
        s2 = one - np.float32(2.0) * ((gi >> 1) & 1).astype(np.float32)
        lt4 = gi < 4
        lt8 = gi < 8
        zero = np.float32(0.0)
        gx = np.where(lt8, s1, zero)
        gy = np.where(lt4, s2, np.where(lt8, zero, s1))
        gz = np.where(lt4, zero, s2)
        return gx * (fx - cx) + gy * (fy - cy) + gz * (fz - cz)

    # trilinear blend of the 8 corner gradients with faded weights
    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)

    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def fbm3(x, y, z, seed=0, octaves=2, lacunarity=2.0, gain=0.5):
    """Fractal sum of noise3 octaves.

    The native path cascades amp/freq in float32 and the numpy path in
    float64, so the two agree bitwise only for gains and lacunarities that
    are exact binary fractions (the 0.5/2.0 defaults).
    """
    shape = np.broadcast_shapes(np.shape(x), np.shape(y), np.shape(z))
    if int(np.prod(shape, dtype=np.int64)) >= NATIVE_MIN:
        return _native_call("rtt_fbm3", x, y, z, shape, seed, octaves,
                            lacunarity, gain)
    total = np.zeros_like(np.asarray(x, np.float32))
    amp = 1.0
    freq = 1.0
    for i in range(octaves):
        total = total + amp * noise3(x * freq, y * freq, z * freq,
                                     seed=seed + i)
        amp *= gain
        freq *= lacunarity
    return total


def fbm3_lipschitz(octaves=2, lacunarity=2.0, gain=0.5):
    """Lipschitz bound of fbm3 per unit input coordinate."""
    total = 0.0
    amp = 1.0
    freq = 1.0
    for _ in range(octaves):
        total += amp * freq * NOISE3_LIPSCHITZ
        amp *= gain
        freq *= lacunarity
    return total
