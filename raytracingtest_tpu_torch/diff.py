"""Shading of traced rays from per-voxel parameters: the forward frame.

Port of the forward half of ``raytracingtest_tpu/diff.py``: the traversal
gives each ray a hit leaf (discrete structure, no gradient), and shading is
a function of the voxel parameters (albedo, normal, density). Two frames: ``render_diff_cuda``
traces ray by ray, ``render_diff_tile`` through the tile traversal. The
deterministic segment-sum backward belongs to the training slice.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch.ops import tile, traverse_cuda
from raytracingtest_tpu_torch.render import sky_color


def gather_voxel_params(albedo, normal, density, leaf_id):
    """Per-ray parameter rows for leaf ids in [0, n_leaves): the three
    arrays are packed into one (n_leaves, 7) table so the frame makes one
    row gather instead of three."""
    packed = torch.cat([albedo, normal, density[:, None]], dim=1)
    rows = packed[leaf_id.long()]
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6]


def shade_diff(hit_leaf, direction, albedo, normal, density,
               light_dir, light_intensity, light_ambient):
    """Lambert shading of traced rays, (N, 3) radiance. Misses shade to the
    sky; density sets the hit's opacity over the sky."""
    sky = sky_color(direction)
    if albedo.shape[0] == 0:
        return sky  # empty scene: every ray misses
    hit = hit_leaf >= 0
    safe_leaf = torch.where(hit, hit_leaf, 0)
    alb, nrm, den = gather_voxel_params(albedo, normal, density, safe_leaf)
    ldir = light_dir / torch.sqrt(torch.sum(light_dir * light_dir))
    nn = nrm / torch.sqrt(torch.clamp(
        torch.sum(nrm * nrm, -1, keepdim=True), min=1e-12))
    ndotl = torch.clamp(torch.sum(nn * (-ldir)[None, :], dim=-1), min=0.0)
    lit = alb * (ndotl * light_intensity + light_ambient)[:, None]
    alpha = torch.clamp(den, 0.0, 1.0)[:, None] * hit[:, None]
    return alpha * lit + (1.0 - alpha) * sky


def render_diff_cuda(albedo, normal, density, svo, o, d, light_dir,
                     light_intensity=1.3, light_ambient=0.08):
    """Render a flat batch of (N, 3) rays, N a multiple of 1024: trace
    (the CUDA kernel for CUDA tensors), then shade. Returns (N, 3)
    radiance."""
    with torch.no_grad():
        res = traverse_cuda.trace_cuda(svo, o, d)
    return shade_diff(res.hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def render_diff_tile(albedo, normal, density, tsvo, o, d, corners, light_dir,
                     light_intensity=1.3, light_ambient=0.08, k_max=64,
                     fb_tiles=128, fb_k=256, fb2_tiles=0, fb2_split=2):
    """Render through the tile traversal (``ops/tile.py``). o/d: (T, P, 3)
    tile-major rays and corners (T, 4, 3) from ``tile.tile_rays``, on the
    device of `tsvo`. Returns ((T*P, 3) radiance in tile-major order, the
    count of residual rays: those whose hit the tile passes could not
    certify, a 0-dim tensor). The count is returned, not acted on; a caller
    that needs every ray exact uses ``tile.trace_tile_exact``."""
    with torch.no_grad():
        res, residual = tile.trace_tile_fb(
            tsvo, o, d, corners, k_max=k_max, fb_tiles=fb_tiles, fb_k=fb_k,
            fb2_tiles=fb2_tiles, fb2_split=fb2_split)
    img = shade_diff(res.hit_leaf, d.reshape(-1, 3), albedo, normal, density,
                     light_dir, light_intensity, light_ambient)
    return img, torch.sum(residual)
