"""The benchmark's pinhole camera: a pose's rays, made on the device.

Frozen copy of the port's ``ops/camera.py`` ``Camera.rays`` for a pinhole
camera (commit c4b99874d80592771fd0a8ae8a7eee3dc0040498): the same float32
operations in the same order, so a pose's rays here are the bits of the
program's own camera on one device. The benchmark makes every ray it hands
to the program and to the reference with it. It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def _normalize(v):
    sq = (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
          + v[..., 2:3] * v[..., 2:3])
    n = torch.sqrt(sq.double()).to(_F32)
    return v / torch.clamp(n, min=1e-12)


def basis(position, look_at, up, device):
    pos = torch.tensor(position, dtype=_F32, device=device)
    fwd = _normalize(torch.tensor(look_at, dtype=_F32, device=device) - pos)
    up0 = torch.tensor(up, dtype=_F32, device=device)
    right = _normalize(torch.linalg.cross(fwd, up0))
    return pos, fwd, right, torch.linalg.cross(right, fwd)


def rays(pose, width, height, device, jitter=None):
    """(origins, directions), each (height * width, 3) float32 on `device`,
    row-major with row 0 at the top, of the pinhole `pose` (a dict of
    ``position``, ``look_at``, ``up``, ``fov_y_deg``); `jitter` a (2,) pixel
    offset in [0, 1), None the pixel centres."""
    H, W = height, width
    pos, fwd, right, up = basis(pose["position"], pose["look_at"], pose["up"], device)
    jx = jy = 0.5
    if jitter is not None:
        j = torch.as_tensor(np.asarray(jitter, np.float32), device=device)
        jx, jy = j[..., 0], j[..., 1]
    ii = torch.arange(H, dtype=_F32, device=device)[:, None]
    jj = torch.arange(W, dtype=_F32, device=device)[None, :]
    u = ((jj + jx) / W * 2.0 - 1.0).expand(H, W)
    v = (1.0 - (ii + jy) / H * 2.0).expand(H, W)
    aspect = W / H
    tan_half = float(np.tan(np.radians(pose["fov_y_deg"]) * 0.5))
    d = (fwd + right * (u * aspect * tan_half)[..., None]
         + up * (v * tan_half)[..., None])
    d = _normalize(d).reshape(-1, 3)
    return pos.expand(H * W, 3).contiguous(), d
