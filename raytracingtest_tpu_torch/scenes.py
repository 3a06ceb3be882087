"""Scene library: signed density functions over the octree-local unit cube.

Port of ``raytracingtest_tpu/scenes.py``: the six scenes built on
``utils/noise.py``. density(p) <= 0 is solid; coordinates are in [0,1]^3.
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

SCENES = {
    s.name: s
    for s in [
        Scene("flat_ground", _flat_ground, 1.0),
        Scene("sphere", _sphere, 1.0),
        Scene("simplex", _simplex_terrain, _SIMPLEX_L),
        Scene("rotated_cuboid", _rotated_cuboid, 1.0),
        Scene("terrain", _terrain, _TERRAIN_L),
        Scene("dense_cube", _dense_cube, 1.0),
    ]
}


def get_scene(name: str) -> Scene:
    return SCENES[name]
