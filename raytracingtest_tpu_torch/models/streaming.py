"""StreamingRenderer: the streamed world as a model. A camera-driven clipmap
of chunk SVOs in arenas on the card, rendered through the tile trace with
progressive accumulation on the device.

Port of ``raytracingtest_tpu/models/streaming.py``, the model over
``stream/clipmap.py`` that ``cli fly`` drives: a frame is a clipmap update,
a span copy to the card, the stitched pyramids (rebuilt when the resident
set changed) and one tile frame (``render_clipmap_tile``).

    sr = StreamingRenderer(get_scene("terrain"))
    sr.update(camera_pos)                # stream chunks
    img, residual = sr.render(camera)    # (H, W, 3) tensor on the card
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.ops import tile
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.render import Light
from raytracingtest_tpu_torch.scenes import Scene
from raytracingtest_tpu_torch.stream.clipmap import (
    Arena, BrickArena, Clipmap, DeviceArena, DeviceBrickArena,
    render_clipmap_tile)


class StreamingRenderer:
    """Clipmap LOD rings -> arenas on `device` (None: the card) -> stitched
    per-LOD pyramids -> one tile frame a render.

    Progressive accumulation follows the reference's: while consecutive
    render() calls keep the camera's pose, jittered frames average on the
    device; a pose change, or an update that changed the resident set,
    resets it."""

    def __init__(self, scene: Scene, min_chunk_size: float = 0.25,
                 radius: int = 2, lods: int = 2, chunk_depth: int = 5,
                 node_capacity: int = 2_000_000,
                 leaf_capacity: int = 4_000_000,
                 world_origin=(0.0, 0.0, 0.0), world_size: float = 1.0,
                 light: Light = Light(), seed: int = 0, device=None):
        self.device = resolve(device)
        self.arena = Arena(node_capacity=node_capacity, leaf_capacity=leaf_capacity)
        self.brick_arena = BrickArena(top_capacity=node_capacity,
                                      brick_capacity=leaf_capacity // 2)
        self.clipmap = Clipmap(scene, self.arena, min_chunk_size=min_chunk_size,
                               radius=radius, lods=lods, chunk_depth=chunk_depth,
                               world_origin=world_origin, world_size=world_size,
                               brick_arena=self.brick_arena)
        self.device_arena = DeviceArena(self.arena, self.device)
        self.device_bricks = DeviceBrickArena(self.brick_arena, self.device)
        self.light = light
        self._light_dir = torch.tensor(light.direction, dtype=torch.float32,
                                       device=self.device)
        self._rng = np.random.default_rng(seed)
        self._masters = None
        self._acc = None
        self._sample = 0
        self._pose = None

    def update(self, camera_pos) -> dict:
        """One streaming step: the rings follow the camera, the dirty arena
        spans go to the device, and the stitched pyramids are marked stale
        when the resident set changed. Returns the clipmap's stats with the
        spans synced (node_spans, brick_spans)."""
        st = self.clipmap.update(camera_pos)
        st["node_spans"] = self.device_arena.sync()
        st["brick_spans"] = self.device_bricks.sync()
        if st["added"] or st["evicted"]:
            self._masters = None    # stitched at the next render
            self._acc = None        # the resident set changed: restart
            self._sample = 0
        return st

    @property
    def sample_count(self) -> int:
        """Frames accumulated at the current pose."""
        return self._sample

    def render(self, camera: Camera, accumulate: bool = True,
               fetch: bool = True, k_max: int = 64, fb_tiles: int = 64,
               fb_k: int = 192, fb2_tiles: int = 16):
        """Render one frame. Returns ((H, W, 3) float32 image, residual
        count as an int) with `fetch`, else (the (T*P, 3) accumulator,
        residual count), both device tensors, with no read back to the host."""
        if not self.clipmap.resident:
            self.update(camera.position)
        if self._masters is None:
            self._masters = [m.to(self.device) for m in self.clipmap.master_tile()]
        pose = (tuple(np.asarray(camera.position, np.float64)),
                tuple(np.asarray(camera.look_at, np.float64)),
                camera.width, camera.height, camera.fov_y_deg)
        if pose != self._pose or not accumulate:
            self._acc = None
            self._sample = 0
            self._pose = pose
        jitter = self._rng.random(2, dtype=np.float32) if self._sample > 0 else None
        o, d, corners, grid = tile.tile_rays(camera, self.device, jitter=jitter)
        self._acc, un = render_clipmap_tile(
            self._masters, self.device_bricks, self.device_arena, o, d, corners,
            self._light_dir, acc=self._acc, sample=self._sample,
            world_origin=tuple(self.clipmap.world_origin),
            world_size=self.clipmap.world_size, k_max=k_max,
            fb_tiles=fb_tiles, fb_k=fb_k, fb2_tiles=fb2_tiles)
        self._sample += 1
        if not fetch:
            return self._acc, un
        img = tile.untile_image(self._acc, grid)
        return img.reshape(camera.height, camera.width, 3), int(un)
