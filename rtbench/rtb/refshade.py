"""The reference's shading, compositing, loss, gradients and Adam, in plain
torch operations.

Frozen copies at commit c4b99874d80592771fd0a8ae8a7eee3dc0040498 of the
port's plain versions: ``ops/shade_cuda.py`` ``shade_rows``,
``composite_rows``, ``softplus``, ``safe_leaf``, and ``render.py``
``sky_color``. The gradient of the L2 loss reaches each leaf as the sum of
its rays' row cotangents, added in float64; Adam is ``torch.optim.Adam``'s
update (betas 0.9, 0.999, eps 1e-8) written out in float64 and kept in
float32. `dtype` runs the per-voxel arithmetic (the rows, the shading, the
compositing and the cotangents) in a lower precision for the control. It
imports nothing of the program.
"""

from __future__ import annotations

import torch

SKY_HORIZON = (0.71, 0.82, 0.95)
SKY_ZENITH = (0.22, 0.42, 0.80)
BETAS = (0.9, 0.999)
EPS = 1e-8


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def sky_color(d):
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    hor = torch.tensor(SKY_HORIZON, dtype=d.dtype, device=d.device)
    zen = torch.tensor(SKY_ZENITH, dtype=d.dtype, device=d.device)
    return hor * (1.0 - t) + zen * t


def safe_leaf(hit_leaf, n_leaves):
    hit = hit_leaf >= 0
    return hit, torch.where(hit, hit_leaf, 0).long().clamp(max=n_leaves - 1)


def shade_rows(alb, nrm, den, hit, sky, light_dir, light_intensity, light_ambient):
    zero, one = den.new_zeros(()), den.new_ones(())
    ldir = light_dir / torch.sqrt(_sum3(light_dir * light_dir))
    floor = den.new_full((), 1e-12)
    nn = nrm / torch.sqrt(torch.maximum(_sum3(nrm * nrm), floor))[:, None]
    ndotl = torch.maximum(_sum3(nn * (-ldir)[None, :]), zero)
    lit = alb * (ndotl * light_intensity + light_ambient)[:, None]
    alpha = (torch.minimum(torch.maximum(den, zero), one) * hit)[:, None]
    return alpha * lit + (1.0 - alpha) * sky


def softplus(x):
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-torch.abs(x)))


def composite_rows(alb, nrm, den, valid, t_in, t_out, sky, light_dir,
                   light_intensity, light_ambient, density_scale):
    n, k = valid.shape
    zero = den.new_zeros(())
    ldir = light_dir / torch.sqrt(_sum3(light_dir * light_dir))
    nrm = nrm.reshape(n * k, 3)
    nn = nrm / torch.sqrt(torch.maximum(_sum3(nrm * nrm),
                                        den.new_full((), 1e-12)))[:, None]
    ndotl = torch.maximum(_sum3(nn * (-ldir)[None, :]), zero).reshape(n, k)
    color = alb * (ndotl * light_intensity + light_ambient)[..., None]
    seg_len = torch.maximum(t_out - t_in, zero)
    sigma = softplus(den) * density_scale
    alpha = (1.0 - torch.exp(-sigma * seg_len)) * valid
    t_before = [alpha.new_ones(n)]
    for i in range(1, k):
        t_before.append(t_before[-1] * (1.0 - alpha[:, i - 1] + 1e-9))
    out = t_before[0][:, None] * alpha[:, 0, None] * color[:, 0]
    for i in range(1, k):
        out = out + (t_before[i] * alpha[:, i])[:, None] * color[:, i]
    t_final = t_before[-1] * (1.0 - alpha[:, -1])
    return out + t_final[:, None] * sky


def surface_pixels(hit_leaf, d, albedo, normal, density, light, dtype=torch.float32):
    """Radiance (N, 3) float32 of traced rays under `light` (direction,
    intensity, ambient), the arithmetic in `dtype`."""
    hit, leaf = safe_leaf(hit_leaf, albedo.shape[0])
    direction, intensity, ambient = light
    ldir = torch.tensor(direction, dtype=torch.float32, device=d.device).to(dtype)
    img = shade_rows(albedo[leaf].to(dtype), normal[leaf].to(dtype),
                     density[leaf].to(dtype), hit, sky_color(d).to(dtype), ldir,
                     intensity, ambient)
    return img.float()


def volumetric_pixels(seg, d, albedo, normal, density, light, density_scale,
                      dtype=torch.float32):
    """Radiance (N, 3) float32 of rays' k segments (``refwalk.
    trace_brick_multi``'s dict), the arithmetic in `dtype`."""
    n, k = seg["hits_leaf"].shape
    valid, leaf = safe_leaf(seg["hits_leaf"].reshape(-1), albedo.shape[0])
    direction, intensity, ambient = light
    ldir = torch.tensor(direction, dtype=torch.float32, device=d.device).to(dtype)
    img = composite_rows(
        albedo[leaf].to(dtype).reshape(n, k, 3), normal[leaf].to(dtype).reshape(n, k, 3),
        density[leaf].to(dtype).reshape(n, k), valid.reshape(n, k).to(dtype),
        seg["t_in"].to(dtype), seg["t_out"].to(dtype), sky_color(d).to(dtype), ldir,
        intensity, ambient, density_scale)
    return img.float()


def l2_step(hit_leaf, d, target, albedo, normal, density, light,
            dtype=torch.float32):
    """(loss, albedo gradient) of the mean squared error of the shaded rays
    against `target`: the loss in float32 from the `dtype` image, the
    gradient (n_leaves, 3) float64, each leaf's rays' row cotangents added
    in float64."""
    hit, leaf = safe_leaf(hit_leaf, albedo.shape[0])
    direction, intensity, ambient = light
    ldir = torch.tensor(direction, dtype=torch.float32, device=d.device).to(dtype)
    rows = albedo[leaf].to(dtype).requires_grad_(True)
    with torch.enable_grad():
        img = shade_rows(rows, normal[leaf].to(dtype), density[leaf].to(dtype), hit,
                         sky_color(d).to(dtype), ldir, intensity, ambient)
        loss = torch.mean((img.float() - target) ** 2)
        (g_rows,) = torch.autograd.grad(loss, rows)
    grad = torch.zeros(albedo.shape, dtype=torch.float64, device=albedo.device)
    grad.index_add_(0, leaf[hit], g_rows[hit].double())
    return loss.detach(), grad


class Adam:
    """``torch.optim.Adam``'s update of one float32 parameter."""

    def __init__(self, param, lr):
        self.param, self.lr, self.t = param.clone(), lr, 0
        self.m = torch.zeros_like(param, dtype=torch.float64)
        self.v = torch.zeros_like(param, dtype=torch.float64)

    def step(self, grad):
        b1, b2 = BETAS
        self.t += 1
        self.m = b1 * self.m + (1.0 - b1) * grad
        self.v = b2 * self.v + (1.0 - b2) * grad * grad
        step_size = self.lr / (1.0 - b1 ** self.t)
        denom = self.v.sqrt() / (1.0 - b2 ** self.t) ** 0.5 + EPS
        self.param = (self.param.double() - step_size * self.m / denom).float()
        return self.param
