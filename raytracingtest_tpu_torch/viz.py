"""Debug visualisation: node-box overlays and ray-probe dumps.

Port of ``raytracingtest_tpu/viz.py``: wireframe boxes of the octree's nodes
at one level rasterised over a rendered image (the reference's gizmo
bounds), a world-space segment with its end markers (the draggable probe
ray), and a textual list of every leaf a ray passes through. Images are
(H, W, 3) float32 numpy arrays drawn on the host; points are projected by
``Camera.project`` on the CPU. ``ray_probe`` traces on the SVO's device:
kernel ``esvo_stackless_multi`` on the card, ``traverse.trace_multi`` on the
CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingtest_tpu_torch.ops import brick_cuda
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.ops.octree import CHILD_OFFSETS, SVO


def node_boxes(svo: SVO, level: int):
    """(origins (M, 3) float32, size) of every node's box at `level`, in
    octree-local coordinates, found by walking masks and child_base level
    by level."""
    masks = svo.masks.cpu().numpy()
    child_base = svo.child_base.cpu().numpy()
    if level >= svo.depth:
        raise ValueError(f"level {level} >= depth {svo.depth}")
    coords = np.zeros((1, 3), np.int64)
    rows = np.zeros(1, np.int64)
    for _ in range(level):
        m = masks[rows]
        nl = ((m >> 8) & 0xFF) & ~(m & 0xFF)
        hit = ((nl[:, None] >> np.arange(8)) & 1).astype(bool)
        ranks = np.cumsum(hit, axis=1) - 1
        pidx, slots = np.nonzero(hit)
        rows = child_base[rows][pidx] + ranks[pidx, slots]
        coords = coords[pidx] * 2 + CHILD_OFFSETS[slots]
    size = 2.0 ** (-level)
    return coords.astype(np.float32) * size, size


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def _project(camera: Camera, pts):
    pix, in_front = camera.project(pts, "cpu")
    return pix.numpy(), in_front.numpy()


def draw_boxes(image: np.ndarray, camera: Camera, origins, size,
               color=(1.0, 1.0, 1.0), max_boxes: int = 4096):
    """Rasterise the wireframes of the first `max_boxes` axis-aligned boxes
    (`origins` (M, 3), edge `size`) over an (H, W, 3) image in place; an
    edge is drawn when both its ends lie in front of the camera. Returns the
    image."""
    h, w = image.shape[:2]
    origins = np.asarray(origins, np.float32)[:max_boxes]
    corners = origins[:, None, :] + size * CHILD_OFFSETS[None, :, :]
    pts, in_front = _project(camera, corners.reshape(-1, 3))
    pts = pts.reshape(-1, 8, 2)
    in_front = in_front.reshape(-1, 8)
    col = np.asarray(color, np.float32)
    for bi in range(pts.shape[0]):
        for a, b in _BOX_EDGES:
            if not (in_front[bi, a] and in_front[bi, b]):
                continue
            _draw_line(image, pts[bi, a], pts[bi, b], col, h, w)
    return image


def _draw_line(image, p0, p1, col, h, w):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    n = min(n, 4 * max(h, w))
    ts = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip((p0[0] + (p1[0] - p0[0]) * ts).astype(np.int64), 0, w - 1)
    ys = np.clip((p0[1] + (p1[1] - p0[1]) * ts).astype(np.int64), 0, h - 1)
    ok = ((xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1))
    image[ys[ok], xs[ok]] = col


def draw_segment(image: np.ndarray, camera: Camera, p0, p1,
                 color=(1.0, 0.2, 0.2), endpoint_px: int = 2):
    """Rasterise the world-space segment p0-p1 over an (H, W, 3) image in
    place, with square markers at its ends (p0's in `color`, p1's green).
    Returns the image."""
    h, w = image.shape[:2]
    pts, in_front = _project(camera, np.asarray([p0, p1], np.float32))
    col = np.asarray(color, np.float32)
    if in_front[0] and in_front[1]:
        _draw_line(image, pts[0], pts[1], col, h, w)
    for i, pt in enumerate(pts):
        if not in_front[i]:
            continue
        x, y = int(pt[0]), int(pt[1])
        r = endpoint_px
        y0, y1 = max(y - r, 0), min(y + r + 1, h)
        x0, x1 = max(x - r, 0), min(x + r + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue  # the end is off the image
        image[y0:y1, x0:x1] = col if i == 0 else np.asarray(
            (0.2, 1.0, 0.2), np.float32)
    return image


@dataclasses.dataclass
class RayProbeEntry:
    node_row: int
    level: int
    t_enter: float
    is_leaf_hit: bool
    leaf_id: int


def ray_probe(svo: SVO, origin, direction, max_hits: int = 64):
    """Every leaf voxel one ray passes through, in t order, up to
    `max_hits`: the first `max_hits` leaf segments of the ray through `svo`
    on the SVO's device (``brick_cuda.trace_multi_cuda``). Returns a list of
    RayProbeEntry."""
    device = svo.masks.device
    o = torch.tensor(np.asarray(origin, np.float32).reshape(1, 3), device=device)
    d = torch.tensor(np.asarray(direction, np.float32).reshape(1, 3), device=device)
    res = brick_cuda.trace_multi_cuda(svo, o, d, k=max_hits)
    count = int(res.count[0])
    leafs = res.hit_leaf[0].cpu().numpy()
    tins = res.t_in[0].cpu().numpy()
    return [RayProbeEntry(node_row=-1, level=svo.depth, t_enter=float(tins[i]),
                          is_leaf_hit=True, leaf_id=int(leafs[i]))
            for i in range(count)]


def format_probe(entries) -> str:
    if not entries:
        return "(no intersections)"
    lines = [f"{i:3d}: leaf {e.leaf_id:8d}  t={e.t_enter:.6f}"
             for i, e in enumerate(entries)]
    return "\n".join(lines)
