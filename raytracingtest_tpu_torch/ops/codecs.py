"""Compressed attribute and descriptor codecs.

Port of ``raytracingtest_tpu/ops/codecs.py``: the reference's packed formats,
kept for interchange and for the memory-lean shading of
``render.render_attachment``; the differentiable path uses float voxel
parameters.

  * R5G6B5 colour (R in bits 11-15, G 5-10, B 0-4)
  * a DXT-style palette a node: colours A and B and a 2-bit choice a child
    among {A, 2/3 A + 1/3 B, 1/3 A + 2/3 B, B}; B is the valid child farthest
    from A, with the running maximum kept (the reference's encoder forgets
    to update it)
  * a 16-bit cube-face normal: sign (bit 15), dominant axis (13-14), u (7
    bits, 6-12) and v (6 bits, 0-5)
  * a 64-bit node attachment, two words: A = colour A | colour B << 16,
    B = choices | normal16 << 16
  * the ESVO 16|8|8 child descriptor with relative child pointers

The host build (``pack_*``, ``encode_child_palette``, ``build_attachments``,
the descriptors) stays in numpy, operation for operation the reference's, so
its words come out bit-identical; it returns uint32 numpy words, and
``build_attachments`` int32 tensors of the same bits. The decoders
(``unpack_r5g6b5``, ``unpack_normal16``, ``decode_child_palette``) are torch
functions on int32 tensors that carry uint32 words as their bit patterns:
``>>`` on an int32 is an arithmetic shift, so every right shift is masked.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingtest_tpu_torch.ops.brick import _host, _words

_F32 = torch.float32

_DXT_WEIGHTS = np.array([1.0, 2.0 / 3.0, 1.0 / 3.0, 0.0], np.float32)


# ---------------------------------------------------------------------------
# R5G6B5
# ---------------------------------------------------------------------------

def pack_r5g6b5(rgb):
    """float (N, 3) in [0, 1] -> uint32 (N,) numpy words."""
    c = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    r = np.minimum((c[..., 0] * 32.0).astype(np.uint32), np.uint32(31))
    g = np.minimum((c[..., 1] * 64.0).astype(np.uint32), np.uint32(63))
    b = np.minimum((c[..., 2] * 32.0).astype(np.uint32), np.uint32(31))
    return (r << np.uint32(11)) | (g << np.uint32(5)) | b


def _unpack_r5g6b5_np(p):
    r = ((p >> np.uint32(11)) & np.uint32(31)).astype(np.float32)
    g = ((p >> np.uint32(5)) & np.uint32(63)).astype(np.float32)
    b = (p & np.uint32(31)).astype(np.float32)
    return np.stack([(r + 0.5) / 32.0, (g + 0.5) / 64.0, (b + 0.5) / 32.0],
                    axis=-1)


def unpack_r5g6b5(packed):
    """int32 (N,) words (uint32 bit patterns) -> float32 (N, 3), each
    channel at the middle of its step."""
    p = packed.to(torch.int32)
    r = ((p >> 11) & 31).to(_F32)
    g = ((p >> 5) & 63).to(_F32)
    b = (p & 31).to(_F32)
    return torch.stack([(r + 0.5) / 32.0, (g + 0.5) / 64.0, (b + 0.5) / 32.0],
                       dim=-1)


# ---------------------------------------------------------------------------
# 16-bit cube-face normal
# ---------------------------------------------------------------------------

def pack_normal16(n):
    """Unit normals (N, 3) -> uint32 (N,) numpy words: bit 15 the sign,
    bits 13-14 the dominant axis, bits 6-12 u (7 bits), bits 0-5 v (6
    bits), u and v the other two components over |dominant|."""
    n = np.asarray(n, np.float32)
    an = np.abs(n)
    axis = np.argmax(an, axis=-1).astype(np.int32)
    dom = np.take_along_axis(n, axis[..., None], axis=-1)[..., 0]
    sign = (dom < 0).astype(np.uint32)
    idx_u = (axis + 1) % 3
    idx_v = (axis + 2) % 3
    cu = np.take_along_axis(n, idx_u[..., None], axis=-1)[..., 0]
    cv = np.take_along_axis(n, idx_v[..., None], axis=-1)[..., 0]
    inv = 1.0 / np.maximum(np.abs(dom), 1e-12)
    u = np.clip(cu * inv, -1.0, 1.0)
    v = np.clip(cv * inv, -1.0, 1.0)
    uq = np.minimum(((u * 0.5 + 0.5) * 128.0).astype(np.uint32), np.uint32(127))
    vq = np.minimum(((v * 0.5 + 0.5) * 64.0).astype(np.uint32), np.uint32(63))
    return ((sign << np.uint32(15)) | (axis.astype(np.uint32) << np.uint32(13))
            | (uq << np.uint32(6)) | vq)


def unpack_normal16(packed):
    """int32 (N,) words (uint32 bit patterns) -> unit float32 (N, 3)
    normals. The three squares add left to right, and the square root is
    taken in float64 and rounded (F9), as numpy's float32 sum and sqrt
    give them."""
    p = packed.to(torch.int32)
    sign = ((p >> 15) & 1).to(_F32) * -2.0 + 1.0
    axis = (p >> 13) & 3
    u = (((p >> 6) & 127).to(_F32) + 0.5) / 128.0 * 2.0 - 1.0
    v = ((p & 63).to(_F32) + 0.5) / 64.0 * 2.0 - 1.0
    comps = []
    for a in range(3):
        is_dom = axis == a
        is_u = ((axis + 1) % 3) == a
        # u and v carry their own signs (they were divided by |dominant|)
        comps.append(torch.where(is_dom, sign, torch.where(is_u, u, v)))
    n = torch.stack(comps, dim=-1)
    sq = (n[..., 0:1] * n[..., 0:1] + n[..., 1:2] * n[..., 1:2]
          + n[..., 2:3] * n[..., 2:3])
    norm = torch.sqrt(sq.double()).to(_F32)
    return n / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# DXT-style palette a node
# ---------------------------------------------------------------------------

def encode_child_palette(child_colors, child_valid):
    """A palette a node: child colours (N, 8, 3) and validity (N, 8) ->
    (colour A, colour B, choices) uint32 (N,) numpy words, 2 bits of choice
    a child. A is the first valid child's colour, B the valid child's
    farthest from A; each child takes the nearest of the four entries of
    the quantised endpoints."""
    cc = np.asarray(child_colors, np.float32)
    valid = np.asarray(child_valid, bool)

    first_idx = np.argmax(valid, axis=-1)
    a = np.take_along_axis(cc, first_idx[:, None, None], axis=1)[:, 0, :]
    d2 = np.sum((cc - a[:, None, :]) ** 2, axis=-1)
    d2 = np.where(valid, d2, -1.0)
    far_idx = np.argmax(d2, axis=-1)
    b = np.take_along_axis(cc, far_idx[:, None, None], axis=1)[:, 0, :]

    # quantise the endpoints first, so the choices fit the decoded colours
    a_q = _unpack_r5g6b5_np(pack_r5g6b5(a))
    b_q = _unpack_r5g6b5_np(pack_r5g6b5(b))

    w = _DXT_WEIGHTS
    palette = (a_q[:, None, :] * w[None, :, None]
               + b_q[:, None, :] * (1.0 - w)[None, :, None])   # (N, 4, 3)
    err = np.sum((cc[:, :, None, :] - palette[:, None, :, :]) ** 2, axis=-1)
    choice = np.argmin(err, axis=-1).astype(np.uint32)       # (N, 8)
    shifts = (np.arange(8) * 2).astype(np.uint32)
    choices = np.sum(np.where(valid, choice, np.uint32(0)) << shifts[None, :],
                     axis=-1, dtype=np.uint32)
    return pack_r5g6b5(a), pack_r5g6b5(b), choices


def decode_child_palette(color_a, color_b, choices, child_slot):
    """One child's colour, float32 (N, 3): the palette entry its 2-bit
    choice selects. int32 tensors (uint32 bit patterns for the words,
    `child_slot` in 0..7)."""
    a = unpack_r5g6b5(color_a)
    b = unpack_r5g6b5(color_b)
    sel = (choices.to(torch.int32) >> (child_slot.to(torch.int32) * 2)) & 3
    weights = torch.from_numpy(_DXT_WEIGHTS).to(a.device)
    w = weights[sel.long()]
    return a * w[..., None] + b * (1.0 - w)[..., None]


# ---------------------------------------------------------------------------
# 64-bit node attachments
# ---------------------------------------------------------------------------

def _popc8_np(v):
    v = v & 0xFF
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def build_attachments(svo, leaf_albedo=None, leaf_normal=None):
    """The reference's 64-bit attachment of every node of `svo`, on the
    host: word A = colour A | colour B << 16, word B = choices | normal16 <<
    16. A leaf child's colour is its albedo, a node child's the mean of its
    own children's, bottom up; a node's normal is its children's normals
    summed and normalised. Returns (word_a, word_b), int32 (n_nodes,)
    tensors of the uint32 words' bits, on the CPU."""
    masks = _host(svo.masks)
    child_base = _host(svo.child_base)
    leaf_base = _host(svo.leaf_base)
    albedo = _host(svo.leaf_albedo if leaf_albedo is None else leaf_albedo)
    normal = _host(svo.leaf_normal if leaf_normal is None else leaf_normal)
    n_nodes = masks.shape[0]

    node_color = np.zeros((n_nodes, 3), np.float32)
    node_normal = np.zeros((n_nodes, 3), np.float32)
    child_colors = np.zeros((n_nodes, 8, 3), np.float32)
    valid = ((masks[:, None] >> (8 + np.arange(8))) & 1).astype(bool)
    leaf_bits = ((masks[:, None] >> np.arange(8)) & 1).astype(bool)

    # bottom up: fill the child colours, then average into the node
    for level in range(svo.depth - 1, -1, -1):
        lo, hi = svo.level_start[level], svo.level_start[level + 1]
        if hi == lo:
            continue
        m = masks[lo:hi]
        v = valid[lo:hi]
        lb = leaf_bits[lo:hi]
        below = (1 << np.arange(8)) - 1
        vm = (m[:, None] >> 8) & 0xFF
        lm = m[:, None] & 0xFF
        leaf_rank = _popc8_np(vm & lm & below[None, :])
        node_rank = _popc8_np(vm & ~lm & below[None, :])
        leaf_ids = np.clip(leaf_base[lo:hi, None] + leaf_rank, 0,
                           max(albedo.shape[0] - 1, 0))
        node_ids = np.clip(child_base[lo:hi, None] + node_rank, 0, n_nodes - 1)
        cc = np.where((lb & v)[..., None], albedo[leaf_ids],
                      np.where((v & ~lb)[..., None], node_color[node_ids], 0.0))
        child_colors[lo:hi] = cc
        nrm = np.where((lb & v)[..., None], normal[leaf_ids],
                       np.where((v & ~lb)[..., None], node_normal[node_ids], 0.0))
        cnt = np.maximum(v.sum(-1, keepdims=True), 1)
        node_color[lo:hi] = cc.sum(1) / cnt
        avg_n = nrm.sum(1)
        nn = np.linalg.norm(avg_n, axis=-1, keepdims=True)
        node_normal[lo:hi] = avg_n / np.maximum(nn, 1e-12)

    ca, cb, choices = encode_child_palette(child_colors, valid)
    n16 = pack_normal16(node_normal)
    word_a = (ca & np.uint32(0xFFFF)) | ((cb & np.uint32(0xFFFF)) << np.uint32(16))
    word_b = (choices & np.uint32(0xFFFF)) | (n16 << np.uint32(16))
    return _words(word_a), _words(word_b)


# ---------------------------------------------------------------------------
# ESVO 16|8|8 wire format (relative pointers)
# ---------------------------------------------------------------------------

def pack_esvo_descriptors(svo):
    """The reference wire format, one int32 (numpy) a node:
    (child pointer << 16) | (valid mask << 8) | non-leaf mask, the child
    pointer relative to the node's own row. Raises if a pointer needs more
    than 15 bits (the reference has no far pointers)."""
    masks = _host(svo.masks)
    child_base = _host(svo.child_base)
    vm = (masks >> 8) & 0xFF
    lm = masks & 0xFF
    nonleaf = vm & ~lm
    idx = np.arange(masks.shape[0], dtype=np.int64)
    rel = np.where(nonleaf != 0, child_base.astype(np.int64) - idx, 0)
    if rel.size and (rel.min() < 0 or rel.max() > 0x7FFF):
        raise ValueError(
            f"relative child pointer out of 15-bit range: max {rel.max()}")
    return ((rel.astype(np.int32) << 16) | (vm << 8) | nonleaf).astype(np.int32)


def unpack_esvo_descriptors(packed, level_start, depth):
    """The wire format back to the absolute layout: (masks, child_base,
    leaf_base) int32 numpy arrays. Leaves are numbered in node order by
    the leaf masks' popcounts."""
    packed = np.asarray(packed, np.int32)
    rel = packed >> 16
    vm = (packed >> 8) & 0xFF
    nonleaf = packed & 0xFF
    lm = vm & ~nonleaf
    idx = np.arange(packed.shape[0], dtype=np.int64)
    child_base = np.where(nonleaf != 0, idx + rel, 0).astype(np.int32)
    leaf_counts = _popc8_np(lm)
    leaf_base_all = np.concatenate(
        [[0], np.cumsum(leaf_counts)[:-1]]).astype(np.int32)
    leaf_base = np.where(lm != 0, leaf_base_all, 0).astype(np.int32)
    masks = ((vm << 8) | lm).astype(np.int32)
    return masks, child_base, leaf_base
