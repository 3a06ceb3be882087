"""The serving renderers against the JAX package on the CPU: ``render.py``'s
image paths (``render_image``, ``render_progressive``, ``render_attachment``,
``render_bounce``) and each route of ``SurfaceRenderer`` and
``VolumetricRenderer``, images to atol 1e-5 and the tile route's hits
exactly. Inputs come from numpy seeds; both packages see the same SVO
arrays."""

import functools

import numpy as np
import pytest
import torch

from raytracingtest_tpu import render as jax_render
from raytracingtest_tpu.config import CameraConfig as JaxCameraConfig
from raytracingtest_tpu.config import RenderConfig as JaxRenderConfig
from raytracingtest_tpu.models import renderers as jax_renderers
from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import codecs as jax_codecs
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import tile as jax_tile
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.ops.camera import Camera as JaxCamera
from raytracingtest_tpu.ops.camera import OctreeFrame as JaxFrame
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, render
from raytracingtest_tpu_torch.config import CameraConfig, RenderConfig
from raytracingtest_tpu_torch.models import SurfaceRenderer, VolumetricRenderer
from raytracingtest_tpu_torch.models import renderers
from raytracingtest_tpu_torch.ops import brick, codecs, tile, traverse
from raytracingtest_tpu_torch.ops.camera import Camera, OctreeFrame
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
PIN = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
ORTHO = dict(position=(0.5, 0.5, -1.2), look_at=(0.5, 0.5, 0.5), ortho_height=1.2)
LIGHT = dict(direction=(-0.3, -1.0, 0.2), intensity=1.1, ambient=0.1)


@functools.lru_cache(maxsize=None)
def trees(name, depth):
    """(the JAX SVO, the port's SVO on the CPU from its arrays)."""
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    return ref, convert.svo_from_numpy(ref, CPU)


def skybox(seed):
    """The gradient texture, tinted at random: a texture no sky formula
    matches."""
    rng = np.random.default_rng(seed)
    return (render.make_gradient_skybox(16, 32)
            * rng.uniform(0.5, 1.0, (16, 32, 3))).astype(np.float32)


def close(ours, ref, atol=1e-5, rtol=0.0):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,depth,view,sky", [
    ("sphere", 5, PIN, False), ("sphere", 5, ORTHO, True),
    ("terrain", 6, PIN, True), ("terrain", 6, ORTHO, False),
])
def test_render_image_matches_render_jax(name, depth, view, sky):
    ref, svo = trees(name, depth)
    light = dict(LIGHT)
    tex = skybox(depth) if sky else None
    jitter = np.asarray([0.25, 0.75], np.float32)
    ours = render.render_image(svo, Camera(**view, width=40, height=24),
                               light=render.Light(**light), jitter=jitter,
                               skybox=tex, device=CPU)
    want = jax_render.render_jax(ref, JaxCamera(**view, width=40, height=24),
                                 light=jax_render.Light(**light), jitter=jitter,
                                 skybox=tex)
    assert ours.shape == (24, 40, 3)
    close(ours, want)


def test_render_image_in_a_world_frame():
    ref, svo = trees("sphere", 5)
    view = dict(position=(12.0, 0.4, -1.8), look_at=(12.0, 0.0, 5.0),
                fov_y_deg=40.0, width=32, height=32)
    ours = render.render_image(svo, Camera(**view),
                               frame=OctreeFrame(origin=(10.0, -2.0, 3.0), size=4.0),
                               device=CPU)
    want = jax_render.render_jax(ref, JaxCamera(**view),
                                 frame=JaxFrame(origin=(10.0, -2.0, 3.0), size=4.0))
    close(ours, want)


def test_render_progressive_matches_jax():
    ref, svo = trees("sphere", 5)
    view = dict(PIN, width=32, height=32)
    ours = render.render_progressive(svo, Camera(**view), n_samples=3, seed=4,
                                     device=CPU)
    want = jax_render.render_progressive(ref, JaxCamera(**view), n_samples=3,
                                         seed=4, backend="jax")
    assert ours.dtype == torch.float32
    close(ours, want)


@pytest.mark.parametrize("sky", [False, True])
def test_render_attachment_matches_jax(sky):
    ref, svo = trees("terrain", 6)
    o, d = JaxCamera(**PIN, width=40, height=40).rays(np)
    tex = skybox(3) if sky else None
    ref_a, ref_b = jax_codecs.build_attachments(ref)
    want = jax_render.render_attachment(ref, ref_a, ref_b, o, d,
                                        light=jax_render.Light(**LIGHT),
                                        skybox=tex)
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    for words in (codecs.build_attachments(svo),
                  convert.attachments_from_numpy(ref_a, ref_b, CPU)):
        ours = render.render_attachment(svo, *words, to, td,
                                        light=render.Light(**LIGHT), skybox=tex)
        close(ours, want)
    # the compressed attributes differ from the float ones on the hits
    fp = render.shade(traverse.trace_stackless(svo, to, td).hit_leaf, td,
                      svo.leaf_albedo, svo.leaf_normal, render.Light(**LIGHT))
    assert float((ours - fp).abs().max()) > 1e-3


def test_render_bounce_matches_jax():
    ref, svo = trees("sphere", 5)
    ref_b, bsvo = jax_brick.make_brick_svo(ref), brick.make_brick_svo(svo)
    cam = dict(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
               fov_y_deg=45.0, width=32, height=32)
    light = render.Light(**LIGHT)

    def ours(specular, bounces):
        return render.render_bounce(bsvo, svo.leaf_albedo, svo.leaf_normal,
                                    Camera(**cam), light=light,
                                    specular=specular, bounces=bounces,
                                    device=CPU)

    live = ours(0.4, 3)
    close(live, jax_render.render_bounce(
        ref_b, ref.leaf_albedo, ref.leaf_normal, JaxCamera(**cam),
        light=jax_render.Light(**LIGHT), specular=0.4, bounces=3))
    # the reference's own checks: specular 0, one bounce is the plain image;
    # more bounces at specular 0 change nothing; live ones do
    one = ours(0.0, 1)
    close(one, render.render_image(svo, Camera(**cam), light=light, device=CPU),
          atol=1e-6, rtol=1e-5)
    assert torch.equal(ours(0.0, 3), one)
    assert float((live - one).abs().max()) > 1e-3


def configs(view, width, height, samples=1, **render_kw):
    """The port's and the reference's (CameraConfig, RenderConfig)."""
    cam = dict(view, width=width, height=height)
    rnd = dict(samples=samples, light_direction=LIGHT["direction"],
               light_intensity=LIGHT["intensity"], light_ambient=LIGHT["ambient"],
               **render_kw)
    return ((CameraConfig(**cam), RenderConfig(**rnd)),
            (JaxCameraConfig(**cam), JaxRenderConfig(**rnd)))


# (route, scene, depth, camera, width, height, skybox); the tile route
# needs a pinhole camera at multiples of 16 on a tree with bricks
ROUTES = [
    ("tile", "terrain", 6, PIN, 32, 48, False),
    ("tile, skybox", "terrain", 6, PIN, 32, 32, True),
    ("brick", "terrain", 6, PIN, 30, 34, False),
    ("brick, orthographic", "sphere", 5, ORTHO, 32, 32, False),
    ("render_image, skybox", "sphere", 5, PIN, 40, 24, True),
    ("stackless", "sphere", 3, PIN, 32, 32, False),
]


@pytest.mark.parametrize("route,name,depth,view,width,height,sky", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_surface_renderer_routes_match_jax(route, name, depth, view, width,
                                           height, sky, monkeypatch):
    ref, svo = trees(name, depth)
    (cfg, rcfg), (jcfg, jrcfg) = configs(view, width, height)
    tex = skybox(width) if sky else None
    model = SurfaceRenderer(svo, device=CPU)
    taken = []
    for fn in ("render_image",):
        real = getattr(render, fn)
        monkeypatch.setattr(render, fn, lambda *a, _r=real, **kw: taken.append(
            "render_image") or _r(*a, **kw))
    real_exact = tile.trace_tile_exact
    monkeypatch.setattr(tile, "trace_tile_exact", lambda *a, **kw: taken.append(
        "tile") or real_exact(*a, **kw))
    jitter = np.asarray([0.3, 0.6], np.float32)
    ours = model.render(cfg, rcfg, jitter=jitter, skybox=tex)
    want = jax_renderers.SurfaceRenderer(ref).render(jcfg, jrcfg, jitter=jitter,
                                                    skybox=tex)
    assert ours.shape == (height, width, 3) and ours.device.type == "cpu"
    close(ours, want)
    bsvo, tsvo = renderers._accel_of(model)
    expect = {"tile": ["tile"], "tile, skybox": ["tile"],
              "render_image, skybox": ["render_image"]}.get(route, [])
    assert taken == expect
    assert (bsvo is None) == (route == "stackless")
    if route.startswith("tile"):
        # the tile route's hits, exactly the reference's
        cam = Camera(**dict(view, width=width, height=height))
        o_t, d_t, corners, _grid = tile.tile_rays(cam, CPU, jitter=jitter)
        jo, jd, jc, _g = jax_tile.tile_rays(
            JaxCamera(**dict(view, width=width, height=height)), np, jitter=jitter)
        ours_hits = tile.trace_tile_exact(tsvo, model.svo, o_t, d_t, corners)
        want_hits = jax_tile.trace_tile_exact(
            jax_renderers._tile_of(jax_renderers.SurfaceRenderer(ref)), jo, jd, jc)
        assert np.array_equal(ours_hits.hit_leaf.numpy(),
                              np.asarray(want_hits.hit_leaf))


def test_surface_render_progressive_matches_jax():
    ref, svo = trees("terrain", 6)
    (cfg, rcfg), (jcfg, jrcfg) = configs(PIN, 32, 32, samples=3)
    ours = SurfaceRenderer(svo, device=CPU).render_progressive(cfg, rcfg, seed=2)
    want = jax_renderers.SurfaceRenderer(ref).render_progressive(jcfg, jrcfg,
                                                                seed=2)
    close(ours, want)


@pytest.mark.parametrize("route,name,depth", [("brick", "sphere", 5),
                                              ("stackless", "sphere", 3)])
def test_volumetric_renderer_routes_match_jax(route, name, depth):
    """The image on every ray whose segments XLA computes to the same bits
    (the others part by the F14 rounding of t; tests/test_torch_volumetric.py
    holds the compositing on identical segments)."""
    ref, svo = trees(name, depth)
    (cfg, rcfg), (jcfg, jrcfg) = configs(PIN, 32, 24)
    model = VolumetricRenderer(svo, k=3, density_scale=16.0, device=CPU)
    ours = model.render(cfg, rcfg)
    want = np.asarray(jax_renderers.VolumetricRenderer(
        ref, k=3, density_scale=16.0).render(jcfg, jrcfg))
    assert (renderers._accel_of(model)[0] is None) == (route == "stackless")
    o, d = Camera(**PIN, width=32, height=24).rays(CPU)
    segs = traverse.trace_multi(svo, o, d, 3)
    ref_segs = jax_traverse.trace_multi_jax(ref, o.numpy(), d.numpy(), 3)
    same = np.ones(o.shape[0], bool)
    for f in ("t_in", "t_out"):
        same &= np.all(getattr(segs, f).numpy().view(np.int32)
                       == np.asarray(getattr(ref_segs, f)).view(np.int32), axis=1)
    assert same.mean() > 0.5
    close(ours.reshape(-1, 3)[torch.from_numpy(same)],
          want.reshape(-1, 3)[same])
