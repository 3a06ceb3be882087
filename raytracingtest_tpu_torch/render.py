"""Lighting and the procedural sky (port of ``raytracingtest_tpu/render.py``
``Light``, ``SKY_HORIZON``, ``SKY_ZENITH`` and ``sky_color``)."""

from __future__ import annotations

import dataclasses

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
