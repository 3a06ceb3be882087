"""Scene library: signed density functions over the octree-local unit cube.

Port of ``raytracingtest_tpu/scenes.py``: all nine scenes, six on
``utils/noise.py``, ``perlin`` on ``utils/perlin.py`` and the reference's
own fields ``terrain_ref`` and ``simplex_ref`` on ``utils/opensimplex.py``.
density(p) <= 0 is solid; coordinates are in [0,1]^3.
Each scene declares a Lipschitz bound of its density, which the builder
uses to prune octants. Scenes are evaluated on the host in numpy float32,
with the JAX package's operation order, so builds match it byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from raytracingtest_tpu_torch.utils.noise import (
    NOISE3_LIPSCHITZ, fbm3, fbm3_lipschitz, noise3)
from raytracingtest_tpu_torch.utils.opensimplex import (
    OPENSIMPLEX3_LIPSCHITZ, OpenSimplex3D)
from raytracingtest_tpu_torch.utils.perlin import (
    fbm3 as perlin_fbm3, perlin_fbm3_lipschitz)


@dataclasses.dataclass(frozen=True)
class Scene:
    """A signed-density scene: fn(x, y, z) -> float32 density, elementwise
    over numpy coordinate arrays; lipschitz bounds |f(p) - f(q)| / |p - q|."""

    name: str
    fn: Callable
    lipschitz: float

    def __call__(self, x, y, z):
        return self.fn(x, y, z)


def _flat_ground(x, y, z):
    # solid below y = 0.30
    return np.asarray(y, np.float32) - 0.30


def _sphere(x, y, z):
    # radius 0.30 at the cube's center
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    z = np.asarray(z, np.float32)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return r - 0.30


_NOISE_FREQ = 4.0
_NOISE_AMP = 0.12


def _simplex_terrain(x, y, z):
    # one-octave noise heightfield
    h = noise3(
        np.asarray(x, np.float32) * _NOISE_FREQ,
        np.zeros_like(np.asarray(x, np.float32)),
        np.asarray(z, np.float32) * _NOISE_FREQ,
    )
    return np.asarray(y, np.float32) - (0.45 + _NOISE_AMP * h)


def _terrain(x, y, z):
    # two-octave fbm heightfield: the benchmark's scene
    h = fbm3(
        np.asarray(x, np.float32) * _NOISE_FREQ,
        np.zeros_like(np.asarray(x, np.float32)),
        np.asarray(z, np.float32) * _NOISE_FREQ,
        octaves=2,
    )
    return np.asarray(y, np.float32) - (0.45 + _NOISE_AMP * h)


def _perlin_terrain(x, y, z):
    # two-octave classic-Perlin fbm heightfield: `_terrain`'s family over
    # utils/perlin.py
    x = np.asarray(x, np.float32)
    h = perlin_fbm3(
        x * _NOISE_FREQ,
        np.zeros_like(x),
        np.asarray(z, np.float32) * _NOISE_FREQ,
        octaves=2,
    )
    return np.asarray(y, np.float32) - (0.45 + _NOISE_AMP * h)


def _rotated_cuboid(x, y, z):
    # box SDF rotated about y, then x
    x = np.asarray(x, np.float32) - 0.5
    y = np.asarray(y, np.float32) - 0.5
    z = np.asarray(z, np.float32) - 0.5
    ang = 0.6
    c, s = float(np.cos(ang)), float(np.sin(ang))
    x1 = c * x + s * z
    z1 = -s * x + c * z
    y1 = c * y - s * z1
    z2 = s * y + c * z1
    hx, hy, hz = 0.28, 0.16, 0.22
    qx = np.abs(x1) - hx
    qy = np.abs(y1) - hy
    qz = np.abs(z2) - hz
    outside = np.sqrt(
        np.maximum(qx, 0.0) ** 2 + np.maximum(qy, 0.0) ** 2
        + np.maximum(qz, 0.0) ** 2)
    inside = np.minimum(np.maximum(qx, np.maximum(qy, qz)), 0.0)
    return outside + inside


def _dense_cube(x, y, z):
    # solid cube spanning [1/4, 3/4]^3 (Chebyshev-distance box SDF, L <= 1)
    x = np.asarray(x, np.float32) - 0.5
    y = np.asarray(y, np.float32) - 0.5
    z = np.asarray(z, np.float32) - 0.5
    return np.maximum(np.abs(x), np.maximum(np.abs(y), np.abs(z))) - 0.25


_TERRAIN_L = 1.0 + _NOISE_AMP * _NOISE_FREQ * fbm3_lipschitz(octaves=2)
_SIMPLEX_L = 1.0 + _NOISE_AMP * _NOISE_FREQ * NOISE3_LIPSCHITZ


# The reference's own fields (OpenSimplex, seed 7), evaluated in float64 and
# rounded to float32 at the end. The reference samples its root cube over
# [1,2]^3; the local frame is [0,1]^3, so coordinates shift by +1.

_OS = None


def _opensimplex():
    global _OS
    if _OS is None:
        _OS = OpenSimplex3D(7)
    return _OS


def _terrain_ref(x, y, z):
    # the reference's default scene: y - 1.5 + 0.5 n(3p) + 0.15 n(24p)
    n = _opensimplex()
    x = np.asarray(x) + 1.0
    y = np.asarray(y) + 1.0
    z = np.asarray(z) + 1.0
    r, r2 = 3.0, 24.0
    out = (y - 1.5
           + 0.5 * n.evaluate(x * r, y * r, z * r)
           + 0.15 * n.evaluate(x * r2, y * r2, z * r2))
    return out.astype(np.float32)


def _simplex_ref(x, y, z):
    # the reference's raw simplex field at frequency 6 (its own 1132 gives
    # pixel noise with no coherent surface)
    n = _opensimplex()
    x = np.asarray(x) + 1.0
    y = np.asarray(y) + 1.0
    z = np.asarray(z) + 1.0
    return n.evaluate(x * 6.0, y * 6.0, z * 6.0).astype(np.float32)


def _ref_lipschitz():
    """The OpenSimplex evaluator's certified bound, the one source of every
    ``_ref`` scene's bound."""
    return OPENSIMPLEX3_LIPSCHITZ


SCENES = {
    s.name: s
    for s in [
        Scene("flat_ground", _flat_ground, 1.0),
        Scene("sphere", _sphere, 1.0),
        Scene("simplex", _simplex_terrain, _SIMPLEX_L),
        Scene("rotated_cuboid", _rotated_cuboid, 1.0),
        Scene("terrain", _terrain, _TERRAIN_L),
        Scene("dense_cube", _dense_cube, 1.0),
        Scene("perlin", _perlin_terrain,
              1.0 + _NOISE_AMP * _NOISE_FREQ * perlin_fbm3_lipschitz(2)),
        Scene("terrain_ref", _terrain_ref,
              1.0 + (0.5 * 3.0 + 0.15 * 24.0) * _ref_lipschitz()),
        Scene("simplex_ref", _simplex_ref, 6.0 * _ref_lipschitz()),
    ]
}


def get_scene(name: str) -> Scene:
    return SCENES[name]
