"""Lighting and the sky (port of ``raytracingtest_tpu/render.py`` ``Light``,
``SKY_HORIZON``, ``SKY_ZENITH``, ``sky_color``, ``sky_texture`` and
``make_gradient_skybox``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Light:
    """Directional light."""

    direction: tuple = (-0.5, -1.0, -0.3)
    intensity: float = 1.3
    ambient: float = 0.08


SKY_HORIZON = (0.71, 0.82, 0.95)
SKY_ZENITH = (0.22, 0.42, 0.80)


def sky_color(d):
    """Procedural vertical-gradient sky for (..., 3) directions (miss
    shading), float32 on d's device."""
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    hor = torch.tensor(SKY_HORIZON, dtype=torch.float32, device=d.device)
    zen = torch.tensor(SKY_ZENITH, dtype=torch.float32, device=d.device)
    return hor * (1.0 - t) + zen * t


def sky_texture(d, tex):
    """Equirectangular skybox sample for (..., 3) directions, bilinear: v = 0
    at the zenith (+y), u wraps with the azimuth atan2(x, -z). `tex`:
    (H, W, 3) float32 on d's device."""
    h, w = tex.shape[0], tex.shape[1]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    u = torch.atan2(dx, -dz) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(dy, -1.0, 1.0)) / math.pi
    fu = u * (w - 1)
    fv = v * (h - 1)
    u0 = torch.clamp(torch.floor(fu).to(torch.int32), 0, w - 1)
    v0 = torch.clamp(torch.floor(fv).to(torch.int32), 0, h - 1)
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    au = (fu - u0)[..., None]
    av = (fv - v0)[..., None]
    flat = tex.reshape(-1, 3)
    c00 = flat[(v0 * w + u0).long()]
    c01 = flat[(v0 * w + u1).long()]
    c10 = flat[(v1 * w + u0).long()]
    c11 = flat[(v1 * w + u1).long()]
    top = c00 * (1 - au) + c01 * au
    bot = c10 * (1 - au) + c11 * au
    return top * (1 - av) + bot * av


def make_gradient_skybox(height: int = 64, width: int = 128) -> np.ndarray:
    """The procedural gradient baked into an (H, W, 3) float32 equirect
    texture on the host: a stand-in skybox asset; users load any such
    image."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # polar angle / pi
    y = np.cos(v * np.pi)  # direction.y of this row
    t = np.clip(y * 0.5 + 0.5, 0.0, 1.0)[:, None]
    hor = np.asarray(SKY_HORIZON, np.float32)
    zen = np.asarray(SKY_ZENITH, np.float32)
    row = hor[None, :] * (1 - t) + zen[None, :] * t
    return np.broadcast_to(row[:, None, :], (height, width, 3)).copy()
