"""Differentiable rendering: pixel gradients to per-voxel parameters.

Port of ``raytracingtest_tpu/diff.py``: the traversal gives each ray a hit
leaf (discrete structure, no gradient), and shading is a differentiable
function of the voxel parameters (albedo, normal, density). Four frames, one
for each traversal: ``render_diff`` (the stackless walk, the reference's XLA
path), ``render_diff_brick`` (the brick trace), ``render_diff_cuda`` (the
ESVO walk with a stack, the reference's Pallas kernel's) and
``render_diff_tile`` (the tile traversal); ``loss_and_grads``,
``loss_and_grads_brick``, ``loss_and_grads_cuda`` and
``loss_and_grads_tile`` are their L2 training steps. ``render_volumetric``
and ``render_volumetric_brick`` composite the first k leaf segments of each
ray instead (the emission-absorption model), differentiable on the card
through ``shade_cuda.CompositeCuda``. The first three give
the same hits but on rays that a trace's step bound cuts short and on a few
that graze a voxel's corner or edge, which the traces round differently.

The backward routes a million pixel cotangents to far fewer voxel rows
without float atomics, so gradients are the same bits in every run. On the
card that is ``ops/shade_cuda.py``: fused shading forward, its per-ray
backward and a segment sum that adds each leaf's rows in ascending ray index,
all hand-written kernels. On the CPU it is the reference's two forms in
tensor operations (``gather_voxel_params``): seven rank-1 scatter-adds below
``SEG_MIN_ROWS`` rows, and sort + running sums + one boundary gather at or
above it.
"""

from __future__ import annotations

import torch

from raytracingtest_tpu_torch.ops import brick_cuda, shade_cuda, tile, traverse_cuda
from raytracingtest_tpu_torch.render import sky_color, sky_texture

# below this row count the plain backward adds with seven rank-1
# scatter-adds (the order of builtin autograd's, bit for bit on the CPU); at
# or above it, with the sort + running-sum form. The two differ by float32
# reassociation in the running sums.
SEG_MIN_ROWS = 1 << 16


def _segment_reduce_cols(leaf_id, cols, n_out):
    """Per-leaf column sums without a row scatter: stable sort of the rows
    by leaf id, running float32 column sums, per-leaf boundaries from a
    count histogram, one gather of the running sums at the n_out + 1
    boundaries, adjacent difference. `leaf_id` (n,) in [0, n_out), `cols`
    (n, C); returns (n_out, C)."""
    leaf_id = leaf_id.long()
    order = torch.argsort(leaf_id, stable=True)
    S = torch.cumsum(cols[order], dim=0)
    S = torch.cat([S.new_zeros((1, cols.shape[1])), S], dim=0)
    cnt = torch.bincount(leaf_id, minlength=n_out)
    start = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, dim=0)])
    G = S[start]
    return G[1:] - G[:-1]


def _gather_bwd(leaf_id, n_leaves, g_alb, g_nrm, g_den):
    """Cotangents of gathered rows summed back onto their leaves; returns
    (d_albedo, d_normal, d_density)."""
    cols7 = torch.cat([g_alb, g_nrm, g_den[:, None]], dim=1)
    if leaf_id.shape[0] >= SEG_MIN_ROWS:
        out = _segment_reduce_cols(leaf_id, cols7, n_leaves)
        return out[:, 0:3], out[:, 3:6], out[:, 6]
    return shade_cuda.scatter_add_rows(leaf_id, cols7, n_leaves)


class GatherVoxelParams(torch.autograd.Function):
    """Per-ray parameter rows for leaf ids in [0, n_leaves), with the
    deterministic backward of ``_gather_bwd``."""

    @staticmethod
    def forward(ctx, albedo, normal, density, leaf_id):
        ctx.save_for_backward(leaf_id)
        ctx.n_leaves = albedo.shape[0]
        return shade_cuda.index_rows(leaf_id, albedo, normal, density)

    @staticmethod
    def backward(ctx, g_alb, g_nrm, g_den):
        (leaf_id,) = ctx.saved_tensors
        return (*_gather_bwd(leaf_id, ctx.n_leaves, g_alb, g_nrm, g_den), None)


def gather_voxel_params(albedo, normal, density, leaf_id):
    """(alb (N, 3), nrm (N, 3), den (N,)) rows of each ray's leaf; leaf ids
    must already lie in [0, n_leaves). Masking of misses happens in the
    shading (their cotangents are zero)."""
    return GatherVoxelParams.apply(albedo, normal, density, leaf_id)


def shade_diff_plain(hit_leaf, direction, albedo, normal, density, light_dir,
                     light_intensity, light_ambient, sky=None):
    """``shade_diff`` in tensor operations, on any device: the plain version
    of the shading kernels, forward and (through ``gather_voxel_params``)
    backward. `sky` (N, 3) is the miss colour, None the procedural sky."""
    if sky is None:
        sky = sky_color(direction)
    hit, leaf = shade_cuda.safe_leaf(hit_leaf, albedo.shape[0])
    alb, nrm, den = gather_voxel_params(albedo, normal, density, leaf)
    return shade_cuda.shade_rows(alb, nrm, den, hit, sky, light_dir,
                                 light_intensity, light_ambient)


def shade_diff(hit_leaf, direction, albedo, normal, density,
               light_dir, light_intensity, light_ambient, skybox=None):
    """Differentiable Lambert shading of traced rays, (N, 3) radiance.
    Misses shade to the sky: the procedural gradient, or the (H, W, 3)
    equirect texture `skybox`, which gets no gradient. Density sets the
    hit's opacity over the sky. CUDA tensors go through the kernels of
    ``ops/shade_cuda.py``, CPU tensors through ``shade_diff_plain``."""
    sky = None
    if skybox is not None:
        sky = sky_texture(direction, skybox.detach())
    if albedo.shape[0] == 0:
        # empty scene: every ray misses, and there is no row to gather
        return sky_color(direction) if sky is None else sky
    if albedo.device.type == "cuda":
        return shade_cuda.ShadeCuda.apply(
            albedo, normal, density, hit_leaf, direction, light_dir,
            light_intensity, light_ambient, sky)
    return shade_diff_plain(hit_leaf, direction, albedo, normal, density,
                            light_dir, light_intensity, light_ambient, sky)


def render_diff_cuda(albedo, normal, density, svo, o, d, light_dir,
                     light_intensity=1.3, light_ambient=0.08):
    """Render a flat batch of (N, 3) rays, any N: trace
    (the CUDA kernel for CUDA tensors), then shade. Returns (N, 3)
    radiance, differentiable in the three parameter tensors."""
    with torch.no_grad():
        res = traverse_cuda.trace_cuda(svo, o, d)
    return shade_diff(res.hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def _value_and_grads(loss_fn, albedo, normal, density):
    """(what loss_fn returns, detached; the loss's gradients in the three
    parameter tensors). loss_fn gets fresh leaves and returns the loss, or a
    tuple that starts with it. A parameter the loss does not reach (an empty
    scene) gets zeros."""
    params = [p.detach().requires_grad_(True)
              for p in (albedo, normal, density)]
    with torch.enable_grad():
        out = loss_fn(*params)
        loss = out[0] if isinstance(out, tuple) else out
        grads = (torch.autograd.grad(loss, params, allow_unused=True)
                 if loss.requires_grad else (None, None, None))
    grads = tuple(torch.zeros_like(p) if g is None else g
                  for p, g in zip(params, grads))
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out), grads
    return out.detach(), grads


def l2_loss_cuda(albedo, normal, density, svo, o, d, light_dir, target):
    """Mean squared error of the per-ray frame against `target` (N, 3)."""
    img = render_diff_cuda(albedo, normal, density, svo, o, d, light_dir)
    return torch.mean((img - target) ** 2)


def loss_and_grads_cuda(albedo, normal, density, svo, o, d, light_dir,
                        target):
    """One forward + backward step of the per-ray frame: (loss, (g_albedo,
    g_normal, g_density))."""
    return _value_and_grads(
        lambda a, n, s: l2_loss_cuda(a, n, s, svo, o, d, light_dir, target),
        albedo, normal, density)


def render_diff(albedo, normal, density, svo, o, d, light_dir,
                light_intensity=1.3, light_ambient=0.08, width=None):
    """Render a flat batch of (N, 3) rays, any N, through the stackless
    trace (kernel ``esvo_stackless`` for CUDA tensors), then shade. Returns
    (N, 3) radiance, differentiable in the three parameter tensors. The SVO's
    parent_ptr, where it has none, is derived once and kept with the tree
    (``traverse.parent_ptr_of``). `width`: the rays are a row-major image
    that wide, which the kernel walks in pixel patches; no output changes."""
    with torch.no_grad():
        res = brick_cuda.trace_stackless_cuda(svo, o, d, width=width)
    return shade_diff(res.hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def l2_loss(albedo, normal, density, svo, o, d, light_dir, target, width=None):
    """Mean squared error of the stackless frame against `target` (N, 3)."""
    img = render_diff(albedo, normal, density, svo, o, d, light_dir, width=width)
    return torch.mean((img - target) ** 2)


def loss_and_grads(albedo, normal, density, svo, o, d, light_dir, target,
                   width=None):
    """One forward + backward step of the stackless frame: (loss,
    (g_albedo, g_normal, g_density)); `width` as ``render_diff``'s."""
    return _value_and_grads(
        lambda a, n, s: l2_loss(a, n, s, svo, o, d, light_dir, target, width),
        albedo, normal, density)


def render_diff_brick(albedo, normal, density, bsvo, o, d, light_dir,
                      light_intensity=1.3, light_ambient=0.08):
    """Render a flat batch of (N, 3) rays, any N, through the brick trace
    of `bsvo` (kernel ``brick_trace`` for CUDA tensors), then shade. The
    same hits as ``render_diff`` on the source SVO. Returns (N, 3) radiance,
    differentiable in the three parameter tensors."""
    with torch.no_grad():
        res = brick_cuda.trace_brick_cuda(bsvo, o, d)
    return shade_diff(res.hit_leaf, d, albedo, normal, density,
                      light_dir, light_intensity, light_ambient)


def l2_loss_brick(albedo, normal, density, bsvo, o, d, light_dir, target):
    """Mean squared error of the brick frame against `target` (N, 3)."""
    img = render_diff_brick(albedo, normal, density, bsvo, o, d, light_dir)
    return torch.mean((img - target) ** 2)


def loss_and_grads_brick(albedo, normal, density, bsvo, o, d, light_dir,
                         target):
    """One forward + backward step of the brick frame: (loss, (g_albedo,
    g_normal, g_density))."""
    return _value_and_grads(
        lambda a, n, s: l2_loss_brick(a, n, s, bsvo, o, d, light_dir, target),
        albedo, normal, density)


def render_diff_tile(albedo, normal, density, tsvo, o, d, corners, light_dir,
                     light_intensity=1.3, light_ambient=0.08, k_max=64,
                     fb_tiles=128, fb_k=256, fb2_tiles=0, fb2_split=2,
                     skybox=None):
    """Render through the tile traversal (``ops/tile.py``). o/d: (T, P, 3)
    tile-major rays and corners (T, 4, 3) from ``tile.tile_rays``, on the
    device of `tsvo`. Returns ((T*P, 3) radiance in tile-major order, the
    count of residual rays: those whose hit the tile passes could not
    certify, a 0-dim tensor). The count is returned, not acted on; a caller
    that needs every ray exact uses ``tile.trace_tile_exact``. `skybox`: an
    optional (H, W, 3) equirect texture sampled on a miss."""
    with torch.no_grad():
        res, residual = tile.trace_tile_fb(
            tsvo, o, d, corners, k_max=k_max, fb_tiles=fb_tiles, fb_k=fb_k,
            fb2_tiles=fb2_tiles, fb2_split=fb2_split)
    img = shade_diff(res.hit_leaf, d.reshape(-1, 3), albedo, normal, density,
                     light_dir, light_intensity, light_ambient, skybox=skybox)
    return img, torch.sum(residual)


def l2_loss_tile(albedo, normal, density, tsvo, o, d, corners, light_dir,
                 target, k_max=64, fb_tiles=128, fb_k=256, fb2_tiles=0,
                 fb2_split=2):
    """Tile-path training loss against `target` (T*P, 3), tile-major.
    Returns (loss, residual count): the number of rays whose hits are still
    cap-limited after every re-walk, so that loss and gradients over them
    use inexact hits. Callers must surface it."""
    img, residual = render_diff_tile(
        albedo, normal, density, tsvo, o, d, corners, light_dir, k_max=k_max,
        fb_tiles=fb_tiles, fb_k=fb_k, fb2_tiles=fb2_tiles, fb2_split=fb2_split)
    return torch.mean((img - target) ** 2), residual


def loss_and_grads_tile(albedo, normal, density, tsvo, o, d, corners,
                        light_dir, target, k_max=64, fb_tiles=128, fb_k=256,
                        fb2_tiles=0, fb2_split=2):
    """One forward + backward step of the tile frame: ((loss, residual
    count), (g_albedo, g_normal, g_density))."""
    return _value_and_grads(
        lambda a, n, s: l2_loss_tile(
            a, n, s, tsvo, o, d, corners, light_dir, target, k_max=k_max,
            fb_tiles=fb_tiles, fb_k=fb_k, fb2_tiles=fb2_tiles,
            fb2_split=fb2_split),
        albedo, normal, density)


# ---------------------------------------------------------------------------
# volumetric rendering: the first k leaf segments of each ray, composited
# ---------------------------------------------------------------------------

def composite_segments(albedo, normal, density, hit_leaf, t_in, t_out, d,
                       light_dir, light_intensity=1.3, light_ambient=0.08,
                       density_scale=64.0):
    """Emission-absorption radiance (N, 3) of rays from their first k leaf
    segments (`hit_leaf`, `t_in`, `t_out` (N, k), -1 padded): the
    counterpart of the reference's ``_composite_segments``, differentiable
    in the three parameter tensors. CUDA tensors go through
    ``shade_cuda.CompositeCuda`` (kernels ``composite_fwd``, and
    ``composite_bwd`` with ``segment_sum`` backward) where a parameter
    requires a gradient, and to ``composite_fwd`` alone where none does;
    CPU tensors through ``gather_voxel_params`` and
    ``shade_cuda.composite_rows``."""
    if albedo.shape[0] == 0:
        # empty scene: every slot is empty and the sky shows through
        return sky_color(d)
    if albedo.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in (albedo, normal, density)):
            return shade_cuda.CompositeCuda.apply(
                albedo, normal, density, hit_leaf, t_in, t_out, d, light_dir,
                light_intensity, light_ambient, density_scale)
        # nothing to differentiate: the forward kernel without the autograd
        # Function's host work, which a served frame would pay (PERF.md)
        return shade_cuda.composite_fwd(hit_leaf, t_in, t_out, d, albedo, normal,
                                        density, light_dir, light_intensity,
                                        light_ambient, density_scale)
    n, k = hit_leaf.shape
    valid, leaf = shade_cuda.safe_leaf(hit_leaf.reshape(-1), albedo.shape[0])
    alb, nrm, den = gather_voxel_params(albedo, normal, density, leaf)
    return shade_cuda.composite_rows(
        alb.reshape(n, k, 3), nrm.reshape(n, k, 3), den.reshape(n, k),
        valid.reshape(n, k), t_in, t_out, sky_color(d), light_dir,
        light_intensity, light_ambient, density_scale)


def render_volumetric(albedo, normal, density, svo, o, d, light_dir, k=4,
                      light_intensity=1.3, light_ambient=0.08,
                      density_scale=64.0, width=None):
    """Volumetric render of a flat batch of (N, 3) rays, any N: the first
    `k` leaf segments of each ray through the stackless trace (kernel
    ``esvo_stackless_multi`` for CUDA tensors), then ``composite_segments``.
    Per segment alpha = 1 - exp(-softplus(density) * density_scale *
    length), and the radiance sums the segments' transmitted Lambert
    colours and the sky behind them. Returns (N, 3) radiance,
    differentiable in the three parameter tensors. `width`: as
    ``render_diff``'s."""
    with torch.no_grad():
        res = brick_cuda.trace_multi_cuda(svo, o, d, k, width=width)
    return composite_segments(albedo, normal, density, res.hit_leaf, res.t_in,
                              res.t_out, d, light_dir, light_intensity,
                              light_ambient, density_scale)


def render_volumetric_brick(albedo, normal, density, bsvo, o, d, light_dir,
                            k=4, light_intensity=1.3, light_ambient=0.08,
                            density_scale=64.0):
    """``render_volumetric`` through the brick trace of `bsvo` (kernel
    ``brick_trace_multi`` for CUDA tensors): the same segments, so the same
    image."""
    with torch.no_grad():
        res = brick_cuda.trace_brick_multi_cuda(bsvo, o, d, k)
    return composite_segments(albedo, normal, density, res.hit_leaf, res.t_in,
                              res.t_out, d, light_dir, light_intensity,
                              light_ambient, density_scale)


def volumetric_l2_loss(albedo, normal, density, svo, o, d, light_dir, target,
                       k=4):
    """Mean squared error of ``render_volumetric`` against `target` (N, 3)."""
    img = render_volumetric(albedo, normal, density, svo, o, d, light_dir, k=k)
    return torch.mean((img - target) ** 2)
