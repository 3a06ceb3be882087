"""OpenSimplex 3D noise on the host, numerically the reference's.

Port of ``raytracingtest_tpu/utils/opensimplex.py`` (Kurt Spencer's
public-domain OpenSimplex in its lookup-table form, seeded by the
reference's LCG Fisher-Yates). The per-point linked list of lattice
contributions is flattened into dense padded tables (hash, MAX_CHAIN), so
evaluation is a fixed number of masked, batched terms. Only the numpy path
is kept, in float64 and int64 as the JAX package evaluates it; the ``_ref``
scenes round to float32 at the end.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

STRETCH_3D = -1.0 / 6.0          # (1/sqrt(3+1)-1)/3
SQUISH_3D = 1.0 / 3.0            # (sqrt(3+1)-1)/3
NORM_3D = 1.0 / 103.0

# the gradient set: the 24 edge-ish directions (+-11,+-4,+-4) permutations
GRADIENTS_3D = np.array([
    -11, 4, 4, -4, 11, 4, -4, 4, 11,
    11, 4, 4, 4, 11, 4, 4, 4, 11,
    -11, -4, 4, -4, -11, 4, -4, -4, 11,
    11, -4, 4, 4, -11, 4, 4, -4, 11,
    -11, 4, -4, -4, 11, -4, -4, 4, -11,
    11, 4, -4, 4, 11, -4, 4, 4, -11,
    -11, -4, -4, -4, -11, -4, -4, -4, -11,
    11, -4, -4, 4, -11, -4, 4, -4, -11,
], np.float64).reshape(24, 3)

# Published OpenSimplex 3D lattice tables (public domain): the data
# constants of the algorithm.

_BASE3D = (
    (0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1),
    (2, 1, 1, 0, 2, 1, 0, 1, 2, 0, 1, 1, 3, 1, 1, 1),
    (1, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 2, 1, 1, 0, 2, 1, 0, 1, 2, 0, 1, 1),
)

_P3D = (
    0, 0, 1, -1, 0, 0, 1, 0, -1, 0, 0, -1, 1, 0, 0, 0,
    1, -1, 0, 0, -1, 0, 1, 0, 0, -1, 1, 0, 2, 1, 1, 0,
    1, 1, 1, -1, 0, 2, 1, 0, 1, 1, 1, -1, 1, 0, 2, 0,
    1, 1, 1, -1, 1, 1, 1, 3, 2, 1, 0, 3, 1, 2, 0, 1,
    3, 2, 0, 1, 3, 1, 0, 2, 1, 3, 0, 2, 1, 3, 0, 1,
    2, 1, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 0, 2,
    0, 2, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 0, 0,
    0, 1, 1, -1, 1, 2, 0, 0, 0, 0, 1, -1, 1, 1, 2, 0,
    0, 0, 0, 1, 1, 1, -1, 2, 3, 1, 1, 1, 2, 0, 0, 2,
    2, 3, 1, 1, 1, 2, 2, 0, 0, 2, 3, 1, 1, 1, 2, 0,
    2, 0, 2, 1, 1, -1, 1, 2, 0, 0, 2, 2, 1, 1, -1, 1,
    2, 2, 0, 0, 2, 1, -1, 1, 1, 2, 0, 0, 2, 2, 1, -1,
    1, 1, 2, 0, 2, 0, 2, 1, 1, 1, -1, 2, 2, 0, 0, 2,
    1, 1, 1, -1, 2, 0, 2, 0,
)

_LOOKUP_PAIRS_3D = (
    0, 2, 1, 1, 2, 2, 5, 1, 6, 0, 7, 0, 32, 2, 34, 2,
    129, 1, 133, 1, 160, 5, 161, 5, 518, 0, 519, 0, 546, 4, 550, 4,
    645, 3, 647, 3, 672, 5, 673, 5, 674, 4, 677, 3, 678, 4, 679, 3,
    680, 13, 681, 13, 682, 12, 685, 14, 686, 12, 687, 14, 712, 20, 714, 18,
    809, 21, 813, 23, 840, 20, 841, 21, 1198, 19, 1199, 22, 1226, 18, 1230, 19,
    1325, 23, 1327, 22, 1352, 15, 1353, 17, 1354, 15, 1357, 17, 1358, 16, 1359, 16,
    1360, 11, 1361, 10, 1362, 11, 1365, 10, 1366, 9, 1367, 9, 1392, 11, 1394, 11,
    1489, 10, 1493, 10, 1520, 8, 1521, 8, 1878, 9, 1879, 9, 1906, 7, 1910, 7,
    2005, 6, 2007, 6, 2032, 8, 2033, 8, 2034, 7, 2037, 6, 2038, 7, 2039, 6,
)


MAX_CHAIN = 9  # longest hash-class chain (6 base + 2 extra; padded)


def _build_contributions():
    """The linked contribution chains as dense padded tables: (lut_d
    (2048, MAX_CHAIN, 3) float64 offsets, lut_sb (2048, MAX_CHAIN, 3) int64
    lattice offsets, lut_n (2048,) chain lengths). Unused hash slots have
    length 0; padding entries have offsets of 1e30, so their attenuation is
    never positive."""
    chains = []
    for i in range(0, len(_P3D), 9):
        base = _BASE3D[_P3D[i]]
        chain = []
        for k in range(0, len(base), 4):
            chain.append((base[k], base[k + 1], base[k + 2], base[k + 3]))
        chain.append((_P3D[i + 1], _P3D[i + 2], _P3D[i + 3], _P3D[i + 4]))
        chain.append((_P3D[i + 5], _P3D[i + 6], _P3D[i + 7], _P3D[i + 8]))
        chains.append(chain)

    lut_d = np.full((2048, MAX_CHAIN, 3), 1e30, np.float64)
    lut_sb = np.zeros((2048, MAX_CHAIN, 3), np.int64)
    lut_n = np.zeros(2048, np.int64)
    for h, ci in zip(_LOOKUP_PAIRS_3D[::2], _LOOKUP_PAIRS_3D[1::2]):
        chain = chains[ci]
        lut_n[h] = len(chain)
        for j, (mult, xsb, ysb, zsb) in enumerate(chain):
            sb = np.array([xsb, ysb, zsb], np.int64)
            lut_d[h, j] = -sb - mult * SQUISH_3D
            lut_sb[h, j] = sb
    return lut_d, lut_sb, lut_n


_LUT_D, _LUT_SB, _LUT_N = _build_contributions()
# the same tables a chain slot and an axis at a time, contiguous: (MAX_CHAIN,
# 3, 2048), for one-dimensional gathers
_LUT_D_COLS = np.ascontiguousarray(_LUT_D.transpose(1, 2, 0))
_LUT_SB_COLS = np.ascontiguousarray(_LUT_SB.transpose(1, 2, 0))

_M64 = (1 << 64) - 1


def make_perm(seed: int):
    """Seeded permutation tables (perm, perm3d), int64 (256,): the
    reference's LCG Fisher-Yates with C#'s wrapping signed 64-bit
    arithmetic."""

    def step(s):
        return (s * 6364136223846793005 + 1442695040888963407) & _M64

    def signed(s):
        return s - (1 << 64) if s >= (1 << 63) else s

    perm = np.zeros(256, np.int64)
    perm3d = np.zeros(256, np.int64)
    source = np.arange(256, dtype=np.int64)
    s = seed & _M64
    for _ in range(3):
        s = step(s)
    for i in range(255, -1, -1):
        s = step(s)
        # C#'s % takes the dividend's sign; a negative remainder is fixed up
        r = int(np.fmod(signed((s + 31) & _M64), i + 1))
        if r < 0:
            r += i + 1
        perm[i] = source[r]
        perm3d[i] = (perm[i] % 24) * 3
        source[r] = source[i]
    return perm, perm3d


# points a block: evaluate() works through larger batches block by block,
# on up to EVAL_THREADS threads (numpy releases the interpreter lock in its
# array loops); every point's value is computed alone, so the blocks change
# no bit of the result
EVAL_BLOCK = 65536
EVAL_THREADS = min(8, os.cpu_count() or 1)


class OpenSimplex3D:
    """Batched OpenSimplex noise; ``evaluate`` broadcasts over coordinate
    arrays and returns float64."""

    def __init__(self, seed: int = 7):
        # the reference seeds its scene noise with 7
        self.perm, self.perm3d = make_perm(seed)
        self.grad_flat = GRADIENTS_3D.reshape(-1)

    def evaluate(self, x, y, z):
        f = np.float64
        x, y, z = np.broadcast_arrays(np.asarray(x, f), np.asarray(y, f),
                                      np.asarray(z, f))
        if x.size <= EVAL_BLOCK:
            return self._evaluate(x, y, z)
        cols = [np.ascontiguousarray(c).reshape(-1) for c in (x, y, z)]
        starts = range(0, x.size, EVAL_BLOCK)
        with ThreadPoolExecutor(EVAL_THREADS) as pool:
            parts = pool.map(lambda i: self._evaluate(
                *(c[i:i + EVAL_BLOCK] for c in cols)), starts)
            return np.concatenate(list(parts)).reshape(x.shape)

    def _evaluate(self, x, y, z):
        f, i64 = np.float64, np.int64
        perm, perm3d, grads = self.perm, self.perm3d, self.grad_flat

        stretch = (x + y + z) * STRETCH_3D
        xs, ys, zs = x + stretch, y + stretch, z + stretch
        xsb = np.floor(xs).astype(i64)
        ysb = np.floor(ys).astype(i64)
        zsb = np.floor(zs).astype(i64)
        squish = (xsb + ysb + zsb).astype(f) * SQUISH_3D
        dx0 = x - (xsb.astype(f) + squish)
        dy0 = y - (ysb.astype(f) + squish)
        dz0 = z - (zsb.astype(f) + squish)
        xins, yins, zins = xs - xsb.astype(f), ys - ysb.astype(f), zs - zsb.astype(f)
        insum = xins + yins + zins

        def trunc(v):  # the operands are >= 0
            return np.floor(v).astype(i64)

        h = (trunc(yins - zins + 1)
             | (trunc(xins - yins + 1) << 1)
             | (trunc(xins - zins + 1) << 2)
             | (trunc(insum) << 3)
             | (trunc(insum + zins) << 5)
             | (trunc(insum + yins) << 7)
             | (trunc(insum + xins) << 9))

        value = np.zeros_like(x)
        for j in range(MAX_CHAIN):
            cd, csb = _LUT_D_COLS[j], _LUT_SB_COLS[j]
            dx = dx0 + np.take(cd[0], h)
            dy = dy0 + np.take(cd[1], h)
            dz = dz0 + np.take(cd[2], h)
            attn = 2.0 - dx * dx - dy * dy - dz * dz
            live = attn > 0
            px = (xsb + np.take(csb[0], h)) & 0xFF
            py = (ysb + np.take(csb[1], h))
            pz = (zsb + np.take(csb[2], h))
            gi = np.take(perm3d,
                         (np.take(perm, (np.take(perm, px) + py) & 0xFF)
                          + pz) & 0xFF)
            gx = np.take(grads, gi)
            gy = np.take(grads, gi + 1)
            gz = np.take(grads, gi + 2)
            part = gx * dx + gy * dy + gz * dz
            a2 = np.where(live, attn, 0.0)
            a2 = a2 * a2
            value = value + a2 * a2 * part
        return value * NORM_3D


# Certified Lipschitz bound of evaluate(): per contribution,
# |grad(attn^4 (g.d))| <= |g| (2-r^2)^3 (2+7r^2) <= 12.37 * 20.2 (largest at
# r^2 = 2/7), times MAX_CHAIN overlapping contributions, times NORM_3D.
OPENSIMPLEX3_LIPSCHITZ = float(np.sqrt(153.0) * 20.2 * MAX_CHAIN * NORM_3D)
