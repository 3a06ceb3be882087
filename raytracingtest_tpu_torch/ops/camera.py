"""Camera ray generation and the world<->octree transform.

Port of ``raytracingtest_tpu/ops/camera.py``: an explicit camera dataclass
produces (N, 3) float32 origin/direction tensors on a given device, row-major
over the (H, W) image, with the numpy version's float32 operation order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve

_F32 = torch.float32


def _normalize(v):
    # the three squares are summed left to right, as numpy's short sum does.
    # torch's float32 CPU sqrt is not correctly rounded (1 ULP off numpy on
    # about 0.6% of inputs); a float64 sqrt rounded to float32 is, so rays
    # are bit-identical to the numpy camera's on every device
    sq = (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
          + v[..., 2:3] * v[..., 2:3])
    n = torch.sqrt(sq.double()).to(_F32)
    return v / torch.clamp(n, min=1e-12)


@dataclasses.dataclass(frozen=True)
class OctreeFrame:
    """Placement of the octree's unit cube in world space."""

    origin: tuple = (0.0, 0.0, 0.0)
    size: float = 1.0

    def world_to_local(self, o, d):
        org = torch.tensor(self.origin, dtype=_F32, device=o.device)
        return (o.to(_F32) - org) / float(np.float32(self.size)), d.to(_F32)

    def t_world(self, t_local):
        # directions stay unscaled, so t_world = size * t_local
        return float(np.float32(self.size)) * t_local


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole or orthographic camera."""

    position: tuple
    look_at: tuple
    up: tuple = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0       # perspective vertical FOV
    ortho_height: float = 0.0     # if > 0: orthographic with this extent
    width: int = 256
    height: int = 256

    def basis(self, device=None):
        """(position, forward, right, up) float32 (3,) tensors on `device`
        (None: the default device)."""
        device = resolve(device)
        pos = torch.tensor(self.position, dtype=_F32, device=device)
        fwd = _normalize(torch.tensor(self.look_at, dtype=_F32, device=device) - pos)
        up0 = torch.tensor(self.up, dtype=_F32, device=device)
        right = _normalize(torch.linalg.cross(fwd, up0))
        up = torch.linalg.cross(right, fwd)
        return pos, fwd, right, up

    def rays(self, device=None, jitter=None):
        """Per-pixel rays: (H*W, 3) origins and directions on `device`
        (None: the default device), row-major (H, W) with row 0 at the top.

        jitter: optional (2,) or (H, W, 2) pixel offsets in [0, 1); the
        default is 0.5, the pixel centers."""
        device = resolve(device)
        H, W = self.height, self.width
        pos, fwd, right, up = self.basis(device)
        jx = jy = 0.5
        if jitter is not None:
            j = torch.as_tensor(np.asarray(jitter, np.float32), device=device)
            jx, jy = j[..., 0], j[..., 1]
        ii = torch.arange(H, dtype=_F32, device=device)[:, None]
        jj = torch.arange(W, dtype=_F32, device=device)[None, :]
        u = ((jj + jx) / W * 2.0 - 1.0).expand(H, W)
        v = (1.0 - (ii + jy) / H * 2.0).expand(H, W)  # +v is up
        aspect = W / H

        if self.ortho_height > 0.0:
            hh = float(np.float32(self.ortho_height * 0.5))
            o = (pos + right * (u * aspect * hh)[..., None]
                 + up * (v * hh)[..., None])
            return o.reshape(-1, 3), fwd.expand(H * W, 3).contiguous()

        tan_half = float(np.tan(np.radians(self.fov_y_deg) * 0.5))
        d = (fwd + right * (u * aspect * tan_half)[..., None]
             + up * (v * tan_half)[..., None])
        d = _normalize(d).reshape(-1, 3)
        return pos.expand(H * W, 3).contiguous(), d

    def project(self, pts, device=None):
        """World points (N, 3) -> (pixel xy (N, 2) float32, in_front (N,)
        bool) on `device` (None: the default device): the inverse of
        ``rays``' pixel mapping, pixel (0, 0)'s center at xy (0, 0)."""
        device = resolve(device)
        pts = torch.as_tensor(pts, dtype=_F32, device=device)
        pos, fwd, right, up = self.basis(device)
        rel = pts - pos[None, :]
        # the dot products summed left to right, the same on every device
        # (numpy's float32 `@` rounds as its BLAS does)
        z, x, y = ((rel[:, 0] * a[0] + rel[:, 1] * a[1]) + rel[:, 2] * a[2]
                   for a in (fwd, right, up))
        aspect = self.width / self.height
        if self.ortho_height > 0.0:
            hh = self.ortho_height * 0.5
            u = x / (aspect * hh)
            v = y / hh
            in_front = z > 0.0
        else:
            tan_half = float(np.tan(np.radians(self.fov_y_deg) * 0.5))
            zs = torch.where(z.abs() < 1e-9, 1e-9, z)
            u = x / (zs * aspect * tan_half)
            v = y / (zs * tan_half)
            in_front = z > 1e-6
        px = (u + 1.0) * 0.5 * self.width - 0.5
        py = (1.0 - v) * 0.5 * self.height - 0.5
        return torch.stack([px, py], dim=-1), in_front
