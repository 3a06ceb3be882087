"""The forward renderer: camera rays, traversal, shading, image.

Port of ``raytracingtest_tpu/render.py``: the light and the sky (``Light``,
``sky_color``, ``sky_texture``, ``make_gradient_skybox``), hard-surface
shading (``shade``: Lambert diffuse N.L x intensity x albedo plus ambient on
a hit, the sky on a miss), the images built on it, and the progressive
running average:

  * ``render_image``, the counterpart of ``render_jax``: the stackless trace
    (kernel ``esvo_stackless`` on the card) then ``shade``, with an optional
    equirect skybox;
  * ``render_progressive``: jittered samples of ``render_image`` in a
    float32 running average;
  * ``render_attachment``: shading from the compressed 64-bit node
    attachments (``ops/codecs.py``) instead of the float leaf arrays;
  * ``render_bounce``: mirror bounces through the brick trace (kernel
    ``brick_trace``), energy attenuated by `specular` at each hit.

Unlike ``diff.shade_diff``, ``shade`` uses the stored normal as it is and has
no density alpha. The images are tensors on the device the caller names
(None: the card); ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops import brick_cuda, codecs
from raytracingtest_tpu_torch.ops.camera import Camera, OctreeFrame


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


def _sum3(x):
    """(x0 + x1) + x2 over the last axis."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _lit(alb, nrm, light: Light, device):
    """Lambert diffuse plus ambient of rows `alb`, `nrm` (N, 3) under
    `light`, whose direction is normalised here."""
    ldir = torch.tensor(light.direction, dtype=torch.float32, device=device)
    ldir = ldir / torch.sqrt(_sum3(ldir * ldir))
    ndotl = torch.clamp(_sum3(nrm * (-ldir)[None, :]), min=0.0)
    return alb * (ndotl * light.intensity + light.ambient)[:, None]


def _sky(d, skybox):
    if skybox is None:
        return sky_color(d)
    return sky_texture(d, torch.as_tensor(np.asarray(skybox, np.float32),
                                          device=d.device))


def shade(hit_leaf, direction, leaf_albedo, leaf_normal, light: Light = Light(),
          skybox=None):
    """Shade traced rays, (N, 3): Lambert + ambient with the leaf's stored
    albedo and normal on a hit (`hit_leaf` >= 0), the sky on a miss: the
    procedural gradient, or the (H, W, 3) equirect texture `skybox`."""
    hit = hit_leaf >= 0
    safe = torch.where(hit, hit_leaf, 0).long()
    if leaf_albedo.shape[0] == 0:  # empty scene: no leaf can be hit
        leaf_albedo = leaf_normal = torch.zeros((1, 3), device=direction.device)
    lit = _lit(leaf_albedo[safe], leaf_normal[safe], light, direction.device)
    return torch.where(hit[:, None], lit, _sky(direction, skybox))


def _local_rays(camera: Camera, frame: OctreeFrame, device, jitter=None):
    o, d = camera.rays(device, jitter=jitter)
    return frame.world_to_local(o, d)


def render_image(svo, camera: Camera, light: Light = Light(),
                 frame: OctreeFrame = OctreeFrame(), jitter=None, skybox=None,
                 device=None):
    """One image on `device` (None: the card), (H, W, 3) float32: the
    camera's rays in octree-local coordinates, the stackless trace, then
    ``shade``. The counterpart of ``render_jax``. `skybox`: an optional (H,
    W, 3) equirect texture sampled on a miss. The trace walks the image in
    pixel patches (``trace_stackless_cuda``'s `width`)."""
    device = resolve(device)
    svo = svo.to(device)
    o, d = _local_rays(camera, frame, device, jitter)
    res = brick_cuda.trace_stackless_cuda(svo, o, d, width=camera.width)
    img = shade(res.hit_leaf, d, svo.leaf_albedo, svo.leaf_normal, light,
                skybox)
    return img.reshape(camera.height, camera.width, 3)


def render_progressive(svo, camera: Camera, n_samples: int = 8,
                       light: Light = Light(),
                       frame: OctreeFrame = OctreeFrame(), seed: int = 0,
                       skybox=None, device=None):
    """Progressive jittered accumulation: `n_samples` images of
    ``render_image``, each at a pixel offset drawn by numpy's generator
    (``rng.random(2, dtype=float32)``, the reference's stream), in a
    float32 running average acc + (img - acc) / (s + 1)."""
    rng = np.random.default_rng(seed)
    acc = None
    for s in range(n_samples):
        jitter = rng.random(2, dtype=np.float32)
        img = render_image(svo, camera, light=light, frame=frame,
                           jitter=jitter, skybox=skybox, device=device)
        acc = img if acc is None else acc + (img - acc) / (s + 1)
    return acc


def render_attachment(svo, word_a, word_b, origin, direction,
                      light: Light = Light(), skybox=None):
    """Shade hits from the compressed 64-bit node attachments, (N, 3), on
    the device of `origin`: the stackless trace's hit parent and slot pick
    the parent's words (int32 (n_nodes,) tensors of uint32 bits, as
    ``codecs.build_attachments`` or ``convert.attachments_from_numpy`` give
    them); the albedo is the slot's 2-bit palette entry of the parent's
    R5G6B5 endpoint pair, the normal the parent's cube-face normal16. The
    float leaf arrays are not read."""
    res = brick_cuda.trace_stackless_cuda(svo, origin, direction)
    hit = res.hit_leaf >= 0
    parent = torch.where(hit, res.hit_parent, 0).long()
    wa = word_a[parent]
    wb = word_b[parent]
    alb = codecs.decode_child_palette(wa & 0xFFFF, (wa >> 16) & 0xFFFF,
                                      wb & 0xFFFF, res.hit_child)
    nrm = codecs.unpack_normal16((wb >> 16) & 0xFFFF)
    lit = _lit(alb, nrm, light, origin.device)
    return torch.where(hit[:, None], lit, _sky(direction, skybox))


def render_bounce(bsvo, leaf_albedo, leaf_normal, camera: Camera,
                  light: Light = Light(), specular: float = 0.0,
                  bounces: int = 1, device=None):
    """Mirror-reflection render through the brick trace, (H, W, 3) on
    `device` (None: the card). Each bounce traces every ray (kernel
    ``brick_trace`` on the card) and adds energy * (the hit's local shading
    * (1 - specular), or the sky on a miss); a hit continues as its mirror
    reflection from just off the surface (2^-(depth + 2) along the
    normalised normal) with its energy times `specular`, a miss with none.
    specular=0, bounces=1 is ``render_image``'s image up to rounding."""
    device = resolve(device)
    bsvo = bsvo.to(device)
    leaf_albedo = torch.as_tensor(leaf_albedo, dtype=torch.float32, device=device)
    leaf_normal = torch.as_tensor(leaf_normal, dtype=torch.float32, device=device)
    o, d = camera.rays(device)
    n = o.shape[0]
    energy = torch.ones((n, 3), device=device)
    result = torch.zeros((n, 3), device=device)
    eps = 2.0 ** -(bsvo.depth + 2)
    for _ in range(bounces):
        res = brick_cuda.trace_brick_cuda(bsvo, o, d)
        hit = res.hit_leaf >= 0
        safe = torch.where(hit, res.hit_leaf, 0).long()
        nrm = leaf_normal[safe]
        # the float64 square root, rounded (F9)
        nrm = nrm / torch.sqrt(torch.clamp(_sum3(nrm * nrm), min=1e-12)
                               .double()).float()[:, None]
        local = _lit(leaf_albedo[safe], nrm, light, device)
        shade_b = torch.where(hit[:, None], local * (1.0 - specular), sky_color(d))
        result = result + energy * shade_b
        energy = energy * torch.where(hit, specular, 0.0)[:, None]
        hp = o + res.hit_t[:, None] * d
        d_ref = d - 2.0 * _sum3(d * nrm)[:, None] * nrm
        o = torch.where(hit[:, None], hp + nrm * eps, o)
        d = torch.where(hit[:, None], d_ref, d)
    return result.reshape(camera.height, camera.width, 3)
