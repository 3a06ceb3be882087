"""The reference (``refbuild``, ``refwalk``, ``refshade``, ``camera``)
against the port's plain CPU paths at a tiny size, and the work counts
against hand counts."""

import numpy as np
import pytest
import torch

from rtb import camera, refbuild, refshade, refwalk, work
from raytracingtest_tpu_torch import diff, get_scene
from raytracingtest_tpu_torch.ops import brick, octree
from raytracingtest_tpu_torch.ops.camera import Camera
from raytracingtest_tpu_torch.utils import noise

POSE = dict(position=(1.4, 0.7, 0.2), look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0),
            fov_y_deg=45.0)
LIGHT = ((-0.5, -1.0, -0.3), 1.3, 0.08)


@pytest.fixture(scope="module")
def trees():
    scene = refbuild.device_scene("terrain", "cpu")
    ref = refbuild.build_svo(scene, refbuild.LIPSCHITZ["terrain"], 5)
    port = octree.build_svo(get_scene("terrain"), 5).svo
    return ref, refbuild.make_brick_svo(ref), port, brick.make_brick_svo(port)


@pytest.fixture(scope="module")
def rays():
    o, d = camera.rays(POSE, 40, 24, "cpu", jitter=(0.25, 0.75))
    return o, d


def test_field_bitwise_against_numpy():
    rng = np.random.default_rng(3)
    x, y, z = (rng.uniform(-2.0, 3.0, 5000).astype(np.float32) for _ in range(3))
    t = [torch.from_numpy(c) for c in (x, y, z)]
    assert np.array_equal(refbuild.noise3(*t, seed=1).numpy(), noise.noise3(x, y, z, seed=1))
    assert np.array_equal(refbuild.terrain(*t).numpy(), get_scene("terrain")(x, y, z))
    assert refbuild.LIPSCHITZ["terrain"] == get_scene("terrain").lipschitz


def test_build_and_bricks_equal_the_port(trees):
    ref, ref_b, port, port_b = trees
    for k in ("masks", "child_base", "leaf_base", "parent_ptr"):
        assert np.array_equal(ref[k], getattr(port, k).numpy()), k
    for k, f in (("albedo", "leaf_albedo"), ("normal", "leaf_normal"),
                 ("density", "leaf_density")):
        assert np.array_equal(ref[k], getattr(port, f).numpy()), k
    assert tuple(ref["level_start"]) == tuple(port.level_start)
    for k in ("top_masks", "top_child", "top_parent", "bricks"):
        assert np.array_equal(ref_b[k], getattr(port_b, k).numpy()), k
    assert (ref_b["depth"], ref_b["top_depth"]) == (port_b.depth, port_b.top_depth)


def test_camera_bitwise(rays):
    o, d = rays
    cam = Camera(position=POSE["position"], look_at=POSE["look_at"], fov_y_deg=45.0,
                 width=40, height=24)
    po, pd = cam.rays("cpu", jitter=np.array([0.25, 0.75], np.float32))
    assert torch.equal(o, po) and torch.equal(d, pd)


def test_walks_equal_the_port(trees, rays):
    _, ref_b, _, port_b = trees
    o, d = rays
    b = refbuild.bricks_on(ref_b, "cpu")
    mine = refwalk.trace_brick(b, o, d)
    res, stats = brick.trace_brick(port_b, o, d, with_stats=True)
    assert int((mine["hit_leaf"] >= 0).sum()) > 100
    assert torch.equal(mine["hit_leaf"], res.hit_leaf)
    assert torch.equal(mine["hit_t"], res.hit_t)
    assert torch.equal(mine["iters"], res.iters)
    assert torch.equal(mine["dda_steps"], stats[:, 1])
    multi = refwalk.trace_brick_multi(b, o, d, 4)
    res, stats = brick.trace_brick_multi(port_b, o, d, 4, with_stats=True)
    for mk, pk in (("hits_leaf", "hit_leaf"), ("t_in", "t_in"), ("t_out", "t_out"),
                   ("count", "count"), ("iters", "iters")):
        assert torch.equal(multi[mk], getattr(res, pk)), mk
    assert torch.equal(multi["dda_steps"], stats[:, 1])


def test_shading_and_compositing_equal_the_port(trees, rays):
    ref, ref_b, port, port_b = trees
    o, d = rays
    b = refbuild.bricks_on(ref_b, "cpu")
    alb, nrm, den = (torch.from_numpy(ref[k]) for k in ("albedo", "normal", "density"))
    light = torch.tensor(LIGHT[0])
    res = refwalk.trace_brick(b, o, d)
    px = refshade.surface_pixels(res["hit_leaf"], d, alb, nrm, den, LIGHT)
    assert torch.equal(px, diff.render_diff_brick(alb, nrm, den, port_b, o, d, light))
    seg = refwalk.trace_brick_multi(b, o, d, 4)
    px = refshade.volumetric_pixels(seg, d, alb, nrm, den, LIGHT, 64.0)
    assert torch.equal(px, diff.render_volumetric_brick(alb, nrm, den, port_b, o, d,
                                                        light, k=4, density_scale=64.0))


def test_loss_gradient_and_adam_against_the_port(trees, rays):
    ref, ref_b, _, port_b = trees
    o, d = rays
    g = torch.Generator().manual_seed(5)
    target = torch.rand((o.shape[0], 3), generator=g)
    alb = torch.rand(ref["albedo"].shape, generator=g)
    nrm, den = torch.from_numpy(ref["normal"]), torch.from_numpy(ref["density"])
    res = refwalk.trace_brick(refbuild.bricks_on(ref_b, "cpu"), o, d)
    loss, grad = refshade.l2_step(res["hit_leaf"], d, target, alb, nrm, den, LIGHT)
    p_loss, (p_grad, _, _) = diff.loss_and_grads_brick(
        alb, nrm, den, port_b, o, d, torch.tensor(LIGHT[0]), target)
    assert float(loss) == float(p_loss)
    torch.testing.assert_close(grad.float(), p_grad, rtol=1e-5, atol=1e-9)
    p = alb.clone()
    opt = torch.optim.Adam([p], lr=5e-2, betas=refshade.BETAS, eps=refshade.EPS)
    mine = refshade.Adam(alb, 5e-2)
    for _ in range(3):
        p.grad = grad.float()
        opt.step()
        mine.step(grad.float().double())
    torch.testing.assert_close(mine.param, p, rtol=1e-6, atol=1e-7)


def test_work_counts_by_hand():
    w = dict(rays=2, top_steps=10, dda_steps=3, table_bytes=100, k=4, hits=1,
             touched=1, leaves=5)
    assert work.brick_trace(w) == (2 * 44 + 100, 10 * 40 + 3 * 32 + 2 * 40)
    assert work.brick_trace_multi(w) == (2 * (24 + 48 + 8) + 100, 576)
    assert work.shade_bwd(w) == (2 * 56 + 28 + 12, 100)
    assert work.segment_sum(w) == (8 + 28 + 140, 7)
    assert work.backward(w) == (152 + 176, 107)
    assert work.least_time(3.35e12, 0) == (1.0, "bytes")
    assert work.least_time(0, 67e12 * 2) == (2.0, "operations")


def test_walk_counts_by_hand(trees):
    _, ref_b, _, _ = trees
    b = refbuild.bricks_on(ref_b, "cpu")
    # a ray that misses the unit cube takes no step; one straight down the
    # middle of the sky takes its top steps down to the terrain and stops
    o = torch.tensor([[2.0, 2.0, 2.0], [0.5, 0.999, 0.5]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    out = refwalk.trace_brick(b, o, d)
    assert out["iters"][0] == 0 and out["dda_steps"][0] == 0
    assert out["hit_leaf"][0] == -1 and out["hit_leaf"][1] >= 0
    assert 0 < out["dda_steps"][1] <= out["iters"][1]
