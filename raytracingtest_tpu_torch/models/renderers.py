"""Model-level API over the functional ops (port of
``raytracingtest_tpu/models/renderers.py``).

Three models over the same packed SVO, each on one device:

  * ``SurfaceRenderer``: hard-surface Lambert images, on the reference's
    routes (the tile trace for a pinhole camera at multiples of 16 pixels,
    else the per-ray brick or stackless trace; ``render.render_image`` for a
    skybox off the tile route), and their progressive average;
  * ``VolumetricRenderer``: the first k leaf segments of each ray,
    composited (``diff.render_volumetric[_brick]``);
  * ``InverseRenderer``, the trainable model: a dictionary of voxel
    parameters, an Adam optimizer over the trained ones, and a train step,
    on one device or with rays sharded over the ranks of a
    ``torch.distributed`` world (``parallel/render_sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raytracingtest_tpu_torch import diff, render
from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.config import CameraConfig, RenderConfig
from raytracingtest_tpu_torch.ops import brick, tile
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.ops.octree import SVO
from raytracingtest_tpu_torch.parallel import render_sharded
from raytracingtest_tpu_torch.parallel.mesh import make_mesh, ray_sharding

PARAM_NAMES = ("albedo", "normal", "density")

# the tile train step's budgets (the reference's make_train_step_tile)
TILE_STEP_BUDGETS = dict(k_max=96, fb_tiles=128, fb_k=256)


def _camera(cfg: CameraConfig) -> Camera:
    return Camera(position=cfg.position, look_at=cfg.look_at, up=cfg.up,
                  fov_y_deg=cfg.fov_y_deg, ortho_height=cfg.ortho_height,
                  width=cfg.width, height=cfg.height)


def _accel_of(obj):
    """The acceleration structures of a model's SVO, built on first use and
    kept: (BrickSVO, TileSVO) on the SVO's device. Either can be None:
    bricks need depth >= BRICK_LEVELS + 1, and the tile pyramid also needs
    top_depth <= 10. The cache holds the SVO object itself and compares with
    `is`, so assigning another SVO to `obj.svo` always rebuilds. The host
    brick decomposition is built once and shared by both structures."""
    cache = getattr(obj, "_accel_cache", None)
    if cache is None or cache[0] is not obj.svo:
        bsvo_dev = tsvo_dev = None
        if obj.svo.depth >= brick.BRICK_LEVELS + 1:
            device = obj.svo.masks.device
            bsvo_host = brick.make_brick_svo(obj.svo)
            bsvo_dev = bsvo_host.to(device)
            if bsvo_host.top_depth <= 10:
                tsvo_host = tile.make_tile_svo(obj.svo, bsvo=bsvo_host)
                tsvo_dev = tile.TileSVO(bsvo=bsvo_dev,
                                        pyr=tsvo_host.pyr.to(device),
                                        cellmap=tsvo_host.cellmap.to(device))
        cache = (obj.svo, bsvo_dev, tsvo_dev)
        obj._accel_cache = cache
    return cache[1], cache[2]


def _tile_route(cam: Camera, obj):
    """The tile route's TileSVO when `cam` takes it (pinhole, both sizes
    multiples of 16, a tree with the pyramid), else None."""
    if cam.ortho_height > 0.0 or cam.width % 16 or cam.height % 16:
        return None
    return _accel_of(obj)[1]


@dataclasses.dataclass
class SurfaceRenderer:
    """Hard-surface renderer of `svo` on `device` (None: the card); the SVO
    is moved there. Images are (H, W, 3) float32 tensors on that device."""

    svo: SVO
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve(self.device)
        self.svo = self.svo.to(self.device)

    def render(self, camera_cfg: CameraConfig, render_cfg: RenderConfig,
               jitter=None, skybox=None):
        """One image on the reference's route:

          * a pinhole camera whose sizes are multiples of 16, on a tree with
            the tile pyramid: ``tile.trace_tile_exact`` (its defaults, the
            reference's) then ``diff.shade_diff`` with the skybox, untiled;
          * otherwise, with a skybox: ``render.render_image``;
          * otherwise ``diff.render_diff_brick`` on a tree with bricks, else
            ``diff.render_diff``.

        `jitter`: a (2,) pixel offset; `skybox`: an optional (H, W, 3)
        equirect texture sampled on a miss."""
        cam = _camera(camera_cfg)
        light = torch.tensor(render_cfg.light_direction, dtype=torch.float32,
                             device=self.device)
        shading = (render_cfg.light_intensity, render_cfg.light_ambient)
        params = (self.svo.leaf_albedo, self.svo.leaf_normal,
                  self.svo.leaf_density)
        shape = (camera_cfg.height, camera_cfg.width, 3)
        tsvo = _tile_route(cam, self)
        with torch.no_grad():
            if tsvo is not None:
                o_t, d_t, corners, grid = tile.tile_rays(cam, self.device,
                                                         jitter=jitter)
                res = tile.trace_tile_exact(tsvo, self.svo, o_t, d_t, corners)
                sky = None if skybox is None else torch.as_tensor(
                    np.asarray(skybox, np.float32), device=self.device)
                img = diff.shade_diff(res.hit_leaf, d_t.reshape(-1, 3), *params,
                                      light, *shading, skybox=sky)
                return tile.untile_image(img, grid).reshape(shape)
            if skybox is not None:
                return render.render_image(
                    self.svo, cam, light=render.Light(
                        direction=render_cfg.light_direction,
                        intensity=render_cfg.light_intensity,
                        ambient=render_cfg.light_ambient),
                    jitter=jitter, skybox=skybox, device=self.device)
            o, d = cam.rays(self.device, jitter=jitter)
            bsvo = _accel_of(self)[0]
            if bsvo is not None:
                img = diff.render_diff_brick(*params, bsvo, o, d, light, *shading)
            else:
                img = diff.render_diff(*params, self.svo, o, d, light, *shading,
                                       width=camera_cfg.width)
        return img.reshape(shape)

    def render_progressive(self, camera_cfg: CameraConfig,
                           render_cfg: RenderConfig, seed=0, skybox=None):
        """The running average of ``render_cfg.samples`` (at least one)
        images, each at a pixel offset drawn by numpy's generator
        (``rng.random(2, dtype=float32)``, the reference's stream)."""
        rng = np.random.default_rng(seed)
        acc = None
        for s in range(max(render_cfg.samples, 1)):
            img = self.render(camera_cfg, render_cfg,
                              jitter=rng.random(2, dtype=np.float32),
                              skybox=skybox)
            acc = img if acc is None else acc + (img - acc) / (s + 1)
        return acc


@dataclasses.dataclass
class VolumetricRenderer:
    """Emission-absorption renderer of `svo` over the first `k` leaf
    segments of each ray, on `device` (None: the card)."""

    svo: SVO
    k: int = 4
    density_scale: float = 64.0
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve(self.device)
        self.svo = self.svo.to(self.device)

    def render(self, camera_cfg: CameraConfig, render_cfg: RenderConfig,
               jitter=None):
        """One (H, W, 3) image: ``diff.render_volumetric_brick`` on a tree
        with bricks, else ``diff.render_volumetric``."""
        cam = _camera(camera_cfg)
        o, d = cam.rays(self.device, jitter=jitter)
        light = torch.tensor(render_cfg.light_direction, dtype=torch.float32,
                             device=self.device)
        params = (self.svo.leaf_albedo, self.svo.leaf_normal,
                  self.svo.leaf_density)
        kw = dict(k=self.k, light_intensity=render_cfg.light_intensity,
                  light_ambient=render_cfg.light_ambient,
                  density_scale=self.density_scale)
        bsvo = _accel_of(self)[0]
        with torch.no_grad():
            if bsvo is not None:
                img = diff.render_volumetric_brick(*params, bsvo, o, d, light, **kw)
            else:
                img = diff.render_volumetric(*params, self.svo, o, d, light, **kw,
                                             width=camera_cfg.width)
        return img.reshape(camera_cfg.height, camera_cfg.width, 3)


@dataclasses.dataclass
class InverseRenderer:
    """Trainable voxel-parameter model with a train step, on one device or
    sharded.

    `device` None means the default device (the card); the SVO is moved
    there. `optimize` names the trained parameters; the others are frozen
    and never change. With `n_devices` given, or inside a started
    ``torch.distributed`` world of more than one rank, the model is sharded
    over the world's ranks (``parallel.mesh.make_mesh(n_devices)``, which
    raises unless the world has `n_devices` ranks, and starts a world of one
    where none is started and `n_devices` is 1): each rank trains on its
    contiguous shard of the rays (``shard_rays``) and the gradients and loss
    are all-reduced, so every rank's parameters stay equal. Otherwise it
    trains on one device, with the faster unsharded steps, even inside a
    world of one.

    The parameters are a dictionary of tensors and the optimizer state is a
    ``torch.optim.Adam`` over the trained ones. A step updates both IN
    PLACE and hands the same objects back, where the reference returns new
    pytrees."""

    svo: SVO
    optimize: tuple = ("albedo",)
    learning_rate: float = 5e-2
    n_devices: Optional[int] = None
    device: Optional[object] = None

    def __post_init__(self):
        unknown = set(self.optimize) - set(PARAM_NAMES)
        if unknown or not self.optimize:
            raise ValueError(f"optimize={self.optimize!r}: expected a "
                             f"non-empty subset of {PARAM_NAMES}")
        sharded = self.n_devices is not None or (
            dist.is_initialized() and dist.get_world_size() > 1)
        self.mesh = make_mesh(self.n_devices, self.device) if sharded else None
        self.device = self.mesh.device if sharded else resolve(self.device)
        self.svo = self.svo.to(self.device)
        # the reference's routes: the tile step for step_view where the
        # tree has the pyramid; `step` through the brick trace where it has
        # bricks, else through the stackless trace
        self._bsvo, self._tsvo = _accel_of(self)
        if sharded:
            self._step_tile = render_sharded.make_train_step_tile(
                self.mesh, **TILE_STEP_BUDGETS)
            self._step = (render_sharded.make_train_step_brick(self.mesh)
                          if self._bsvo is not None
                          else render_sharded.make_train_step(self.mesh))

    def init_params(self, seed: int = 0, randomize=("albedo",)):
        """(params, opt_state): the SVO's parameters, those named in
        `randomize` replaced by uniform [0, 1) numbers from numpy's
        generator (the reference's stream), and Adam over the trained
        ones."""
        rng = np.random.default_rng(seed)
        params = {"albedo": self.svo.leaf_albedo.clone(),
                  "normal": self.svo.leaf_normal.clone(),
                  "density": self.svo.leaf_density.clone()}
        for name in randomize:
            params[name] = torch.from_numpy(rng.random(
                tuple(params[name].shape), dtype=np.float32)).to(self.device)
        opt_state = torch.optim.Adam(
            [params[name] for name in PARAM_NAMES if name in self.optimize],
            lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return params, opt_state

    def _light(self, light):
        return torch.as_tensor(light, dtype=torch.float32, device=self.device)

    def _update(self, params, opt_state, grads):
        for name, g in zip(PARAM_NAMES, grads):
            if name in self.optimize:
                params[name].grad = g
        opt_state.step()

    def shard_rays(self, o, d, target=None):
        """This rank's shards of full ray batches (N, 3) (and of the
        target), on the model's device; on one device, the batches
        themselves there."""
        put = ((lambda x: ray_sharding(self.mesh, x)) if self.mesh is not None
               else (lambda x: torch.as_tensor(x).to(self.device)))
        if target is None:
            return put(o), put(d)
        return put(o), put(d), put(target)

    def step(self, params, opt_state, o, d, light, target, width=None):
        """One train step on a flat batch of (N, 3) rays against `target`
        (N, 3), any N (sharded: this rank's shards, ``shard_rays``), on the
        reference's route: through the brick trace
        (``diff.loss_and_grads_brick``) when the tree has bricks (depth >=
        4), else through the stackless trace (``diff.loss_and_grads``; with
        `width`, the rays are a row-major image that wide, walked in pixel
        patches, which changes no result). Returns (params, opt_state,
        loss)."""
        if self.mesh is not None:
            tree = self._bsvo if self._bsvo is not None else self.svo
            return self._step(params, opt_state, tree, o, d, self._light(light),
                              target)
        values = tuple(params[name] for name in PARAM_NAMES)
        if self._bsvo is not None:
            loss, grads = diff.loss_and_grads_brick(
                *values, self._bsvo, o, d, self._light(light), target)
        else:
            loss, grads = diff.loss_and_grads(
                *values, self.svo, o, d, self._light(light), target, width)
        self._update(params, opt_state, grads)
        return params, opt_state, loss

    def step_view(self, params, opt_state, camera_cfg, light, target_img):
        """One train step against a posed target image, `target_img`
        (H*W, 3) row-major pixels: through the tile frame when the camera is
        pinhole, both sizes are multiples of 16 and the tree supports the
        pyramid, else through ``step``.

        Returns (params, opt_state, loss, residual). residual > 0 means some
        rays' loss terms used cap-limited (inexact) hits. It is 0 in normal
        operation and training loops must surface it."""
        cam = _camera(camera_cfg)
        target_img = torch.as_tensor(target_img, dtype=torch.float32,
                                     device=self.device)
        if (self._tsvo is not None and cam.ortho_height <= 0.0
                and camera_cfg.width % 16 == 0 and camera_cfg.height % 16 == 0):
            o_t, d_t, corners, grid = tile.tile_rays(cam, self.device)
            target = tile.tile_pixels(target_img, grid)
            if self.mesh is not None:
                shard = lambda x: ray_sharding(self.mesh, x)
                return self._step_tile(params, opt_state, self._tsvo, shard(o_t),
                                       shard(d_t), shard(corners),
                                       self._light(light), shard(target))
            (loss, residual), grads = diff.loss_and_grads_tile(
                *(params[name] for name in PARAM_NAMES), self._tsvo, o_t, d_t,
                corners, self._light(light), target, **TILE_STEP_BUDGETS)
            self._update(params, opt_state, grads)
            return params, opt_state, loss, residual
        o, d, target_img = self.shard_rays(*cam.rays(self.device), target_img)
        params, opt_state, loss = self.step(
            params, opt_state, o, d, light, target_img,
            width=camera_cfg.width if self.mesh is None else None)
        return params, opt_state, loss, torch.zeros(
            (), dtype=torch.int64, device=self.device)
