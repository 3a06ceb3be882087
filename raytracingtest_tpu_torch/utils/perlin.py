"""Classic (improved) Perlin noise on the host, in float32.

Port of ``raytracingtest_tpu/utils/perlin.py`` (Ken Perlin's improved noise
as the reference's ``Perlin.cs`` has it): ``noise1``/``noise2``/``noise3``,
their octave sums ``fbm1``/``fbm3`` (lacunarity 2, gain 1/2) and the
certified Lipschitz bound the builder prunes with. Only the numpy path is
kept: scenes are sampled on the host. Every operation is float32 and in the
JAX package's order, so values match its numpy path bit for bit.
"""

from __future__ import annotations

import numpy as np

# Ken Perlin's canonical permutation (256 entries and a wrap duplicate, so
# the +1 reads at index 256 need no modulo)
PERM = np.array([
    151, 160, 137, 91, 90, 15,
    131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140, 36, 103, 30, 69, 142,
    8, 99, 37, 240, 21, 10, 23,
    190, 6, 148, 247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117,
    35, 11, 32, 57, 177, 33,
    88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165,
    71, 134, 139, 48, 27, 166,
    77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105, 92,
    41, 55, 46, 245, 40, 244,
    102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208,
    89, 18, 169, 200, 196,
    135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52,
    217, 226, 250, 124, 123,
    5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227, 47, 16,
    58, 17, 182, 189, 28, 42,
    223, 183, 170, 213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101,
    155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112,
    104, 218, 246, 97, 228,
    251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145,
    235, 249, 14, 239, 107,
    49, 192, 214, 31, 181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50,
    45, 127, 4, 150, 254,
    138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78,
    66, 215, 61, 156, 180,
    151,
], dtype=np.int32)


def _fade(t):
    # 6t^5 - 15t^4 + 10t^3
    return t * t * t * (t * (t * np.float32(6) - np.float32(15))
                        + np.float32(10))


def _lerp(t, a, b):
    return a + t * (b - a)


def _grad1(h, x):
    return np.where((h & 1) == 0, x, -x)


def _grad2(h, x, y):
    return np.where((h & 1) == 0, x, -x) + np.where((h & 2) == 0, y, -y)


def _grad3(h, x, y, z):
    # the 12-edge gradient select of improved noise
    h = h & 15
    u = np.where(h < 8, x, y)
    v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
    return np.where((h & 1) == 0, u, -u) + np.where((h & 2) == 0, v, -v)


def _floor_cell(x):
    """(cell index & 0xff, float32 fractional part)."""
    fx = np.floor(x)
    return np.asarray(fx, np.int32) & 0xFF, (x - fx).astype(np.float32)


def noise1(x):
    """1D Perlin noise with doubled amplitude, float32, in about [-1, 1]."""
    x = np.asarray(x, np.float32)
    X, x = _floor_cell(x)
    u = _fade(x)
    g0 = _grad1(np.take(PERM, X), x)
    g1 = _grad1(np.take(PERM, X + 1), x - np.float32(1))
    return _lerp(u, g0, g1) * np.float32(2)


def noise2(x, y):
    """2D Perlin noise, float32 (hash chain perm[perm[X] + Y])."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    X, x = _floor_cell(x)
    Y, y = _floor_cell(y)
    u = _fade(x)
    v = _fade(y)
    A = (np.take(PERM, X) + Y) & 0xFF
    B = (np.take(PERM, X + 1) + Y) & 0xFF
    one = np.float32(1)
    n00 = _grad2(np.take(PERM, A), x, y)
    n10 = _grad2(np.take(PERM, B), x - one, y)
    n01 = _grad2(np.take(PERM, A + 1), x, y - one)
    n11 = _grad2(np.take(PERM, B + 1), x - one, y - one)
    return _lerp(v, _lerp(u, n00, n10), _lerp(u, n01, n11))


def noise3(x, y, z):
    """3D Perlin noise, float32 (hash chain perm[perm[perm[X] + Y] + Z])."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    z = np.asarray(z, np.float32)
    X, x = _floor_cell(x)
    Y, y = _floor_cell(y)
    Z, z = _floor_cell(z)
    u = _fade(x)
    v = _fade(y)
    w = _fade(z)
    A = (np.take(PERM, X) + Y) & 0xFF
    B = (np.take(PERM, X + 1) + Y) & 0xFF
    AA = (np.take(PERM, A) + Z) & 0xFF
    BA = (np.take(PERM, B) + Z) & 0xFF
    AB = (np.take(PERM, A + 1) + Z) & 0xFF
    BB = (np.take(PERM, B + 1) + Z) & 0xFF
    one = np.float32(1)
    n000 = _grad3(np.take(PERM, AA), x, y, z)
    n100 = _grad3(np.take(PERM, BA), x - one, y, z)
    n010 = _grad3(np.take(PERM, AB), x, y - one, z)
    n110 = _grad3(np.take(PERM, BB), x - one, y - one, z)
    n001 = _grad3(np.take(PERM, AA + 1), x, y, z - one)
    n101 = _grad3(np.take(PERM, BA + 1), x - one, y, z - one)
    n011 = _grad3(np.take(PERM, AB + 1), x, y - one, z - one)
    n111 = _grad3(np.take(PERM, BB + 1), x - one, y - one, z - one)
    return _lerp(w,
                 _lerp(v, _lerp(u, n000, n100), _lerp(u, n010, n110)),
                 _lerp(v, _lerp(u, n001, n101), _lerp(u, n011, n111)))


def fbm3(x, y, z, octaves):
    """Octave sum of noise3: lacunarity 2, gain 1/2, float32."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    z = np.asarray(z, np.float32)
    f = np.zeros_like(x)
    wgt = np.float32(0.5)
    for _ in range(octaves):
        f = f + wgt * noise3(x, y, z)
        x = x * np.float32(2)
        y = y * np.float32(2)
        z = z * np.float32(2)
        wgt = np.float32(wgt * np.float32(0.5))
    return f


def fbm1(x, octaves):
    """Octave sum of noise1: lacunarity 2, gain 1/2, float32."""
    x = np.asarray(x, np.float32)
    f = np.zeros_like(x)
    wgt = np.float32(0.5)
    for _ in range(octaves):
        f = f + wgt * noise1(x)
        x = x * np.float32(2)
        wgt = np.float32(wgt * np.float32(0.5))
    return f


# Certified Lipschitz bound of noise3 (the JAX package's derivation: within a
# cell each corner term g.d has |g.d| <= 2 and slope <= 1 an axis, the x-lerp
# adds max fade' (1.875) times |b - a| <= 4, outer lerps are convex, so each
# partial is <= 8.5 and the gradient <= sqrt(3) * 8.5 < 14.73). Octave i of
# fbm3 has weight 2^-(i+1) at scale 2^i, so each contributes L / 2.
PERLIN3_LIPSCHITZ = 14.73


def perlin_fbm3_lipschitz(octaves: int) -> float:
    return octaves * PERLIN3_LIPSCHITZ / 2.0
