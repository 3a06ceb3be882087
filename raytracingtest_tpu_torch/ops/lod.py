"""Interior-node attributes and LOD rendering.

Port of ``raytracingtest_tpu/ops/lod.py``: ``compute_node_attributes``
averages the children's albedo and normals into every interior node, bottom
up, on the host (numpy, operation for operation the reference's, so its
arrays come out byte-identical); ``render_lod`` traces with the footprint
stop (kernel ``esvo_stackless_lod`` on the card, ``traverse.trace_lod`` on
the CPU) and ``shade_lod`` shades a node hit from the node's averaged
attributes and a leaf hit from the leaf's, in tensor operations (the
reference computes it in plain ``jnp`` too). The LOD brick trace,
``brick_cuda.trace_brick_lod_cuda``, gives ``hit_node`` rows of the same
SVO, so ``shade_lod`` shades its results as well.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingtest_tpu_torch.ops import brick_cuda
from raytracingtest_tpu_torch.ops.codecs import _popc8_np
from raytracingtest_tpu_torch.render import Light, _lit, sky_color


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def compute_node_attributes(svo):
    """Bottom-up averaged attributes of every node of `svo`: (node_albedo
    (n_nodes, 3), node_normal (n_nodes, 3)) float32 tensors on the CPU. A
    node's albedo is the mean of its valid children's (a leaf child's
    albedo, a node child's average); its normal is the children's normals
    summed and normalised (zero where they cancel)."""
    masks = _host(svo.masks)
    child_base = _host(svo.child_base)
    leaf_base = _host(svo.leaf_base)
    albedo = _host(svo.leaf_albedo)
    normal = _host(svo.leaf_normal)
    n_nodes = masks.shape[0]

    node_albedo = np.zeros((n_nodes, 3), np.float32)
    node_normal = np.zeros((n_nodes, 3), np.float32)
    slots = np.arange(8)
    below = (1 << slots) - 1

    for level in range(svo.depth - 1, -1, -1):
        lo, hi = svo.level_start[level], svo.level_start[level + 1]
        if hi == lo:
            continue
        m = masks[lo:hi]
        vm = (m[:, None] >> 8) & 0xFF
        lm = m[:, None] & 0xFF
        v = ((vm >> slots) & 1).astype(bool)
        lf = ((lm >> slots) & 1).astype(bool) & v
        leaf_rank = _popc8_np(vm & lm & below[None, :])
        node_rank = _popc8_np(vm & ~lm & below[None, :])
        leaf_ids = np.clip(leaf_base[lo:hi, None] + leaf_rank, 0,
                           max(albedo.shape[0] - 1, 0))
        node_ids = np.clip(child_base[lo:hi, None] + node_rank, 0,
                           n_nodes - 1)
        ca = np.where(lf[..., None], albedo[leaf_ids],
                      np.where((v & ~lf)[..., None], node_albedo[node_ids],
                               0.0))
        cn = np.where(lf[..., None], normal[leaf_ids],
                      np.where((v & ~lf)[..., None], node_normal[node_ids],
                               0.0))
        cnt = np.maximum(v.sum(-1, keepdims=True), 1)
        node_albedo[lo:hi] = ca.sum(1) / cnt
        s = cn.sum(1)
        nn = np.linalg.norm(s, axis=-1, keepdims=True)
        node_normal[lo:hi] = s / np.maximum(nn, 1e-12)
    return torch.from_numpy(node_albedo), torch.from_numpy(node_normal)


def render_lod(svo, node_albedo, node_normal, o, d, pixel_size_coef,
               light: Light = Light(), width=None):
    """Forward render of (N, 3) rays with the LOD stop: the LOD stackless
    trace (kernel ``esvo_stackless_lod`` for CUDA tensors), then
    ``shade_lod``. `width`: the rays are a row-major image that wide, which
    the kernel walks in pixel patches; no output changes. Returns ((N, 3)
    radiance, the TraceResult)."""
    res = brick_cuda.trace_lod_cuda(svo, o, d, pixel_size_coef, width=width)
    return shade_lod(svo, node_albedo, node_normal, res, d, light), res


def shade_lod(svo, node_albedo, node_normal, res, d, light: Light = Light()):
    """Shade an LOD TraceResult (of ``trace_lod_cuda`` or
    ``trace_brick_lod_cuda``; hit_node rows are `svo`'s node rows in both):
    Lambert plus ambient with the node's averaged attributes where the ray
    stopped at a node, the leaf's where it hit a leaf, the sky elsewhere.
    Returns (N, 3) radiance."""
    is_node = res.hit_node >= 0
    is_leaf = res.hit_leaf >= 0
    leaf_albedo, leaf_normal = svo.leaf_albedo, svo.leaf_normal
    if leaf_albedo.shape[0] == 0:  # empty scene: no leaf can be hit
        leaf_albedo = leaf_normal = torch.zeros((1, 3), device=d.device)
    leaf = torch.where(is_leaf, res.hit_leaf, 0).long()
    node = torch.where(is_node, res.hit_node, 0).long()
    alb = torch.where(is_node[:, None], node_albedo[node], leaf_albedo[leaf])
    nrm = torch.where(is_node[:, None], node_normal[node], leaf_normal[leaf])
    lit = _lit(alb, nrm, light, d.device)
    return torch.where((is_node | is_leaf)[:, None], lit, sky_color(d))
