"""The k-segment traces and volumetric rendering against the JAX package on
the CPU: ``traverse.trace_multi`` and ``brick.trace_brick_multi`` (the plain
versions of the kernels ``esvo_stackless_multi`` and ``brick_trace_multi``)
against ``trace_multi_jax`` / ``trace_brick_multi_jax``, and
``diff.render_volumetric[_brick]`` with their gradients against the
reference's; then the checks of the new launchers' arguments.

Hit leaves and counts are held exactly, t_in / t_out to rtol 1e-5 / atol
1e-6 against XLA, which contracts multiply-adds (F14); `iters` is not
compared (F11). Inputs come from numpy seeds."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.ops.camera import Camera as JaxCamera
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import _build, convert, diff
from raytracingtest_tpu_torch.ops import brick, brick_cuda, shade_cuda, traverse
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = (-0.5, -1.0, -0.3)
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)


@functools.lru_cache(maxsize=None)
def trees(name, depth):
    """(JAX SVO, JAX BrickSVO, the port's SVO, the port's BrickSVO) on the
    CPU, the port's moved from the reference's arrays."""
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    ref_b = jax_brick.make_brick_svo(ref)
    svo = convert.svo_from_numpy(ref, "cpu")
    return ref, ref_b, svo, brick.make_brick_svo(svo)


def shell_rays(n, seed):
    """Rays from a radius-2 shell aimed near the centre, and camera rays."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = 0.5 + 2.0 * v
    d = 0.5 + rng.normal(0.0, 0.35, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam_o, cam_d = JaxCamera(**CAM, width=32, height=32).rays(np)
    return (np.concatenate([o, cam_o]).astype(np.float32),
            np.concatenate([d, cam_d]).astype(np.float32))


def assert_segments(ours, ref):
    np.testing.assert_array_equal(ours.hit_leaf.numpy(), np.asarray(ref.hit_leaf))
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(ref.count))
    for name in ("t_in", "t_out"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


CASES = [("sphere", 5, 4), ("terrain", 6, 4), ("terrain", 6, 1),
         ("flat_ground", 4, 3)]


@pytest.mark.parametrize("name,depth,k", CASES)
def test_trace_multi_matches_jax(name, depth, k):
    ref, _ref_b, svo, _bsvo = trees(name, depth)
    o, d = shell_rays(2048, depth + k)
    ours, stats = traverse.trace_multi(svo, torch.from_numpy(o),
                                       torch.from_numpy(d), k, with_stats=True)
    assert_segments(ours, jax_traverse.trace_multi_jax(ref, o, d, k))
    # padding and order: -1 / 0.0 beyond the count; segments in t order
    pad = torch.arange(k)[None, :] >= ours.count[:, None]
    assert bool((ours.hit_leaf[pad] == -1).all() and (ours.t_in[pad] == 0).all()
                and (ours.t_out[pad] == 0).all())
    assert bool((ours.hit_leaf[~pad] >= 0).all())
    assert bool((ours.t_out[~pad] >= ours.t_in[~pad]).all())
    assert bool((ours.t_in[:, 1:] >= ours.t_out[:, :-1])[~pad[:, 1:]].all())
    assert int((ours.count > 0).sum()) > 100
    assert stats.shape == (o.shape[0], 5) and int(stats[:, :4].abs().sum()) == 0


@pytest.mark.parametrize("name,depth,k", CASES)
def test_trace_brick_multi_matches_jax_and_the_stackless_trace(name, depth, k):
    ref, ref_b, svo, bsvo = trees(name, depth)
    o, d = shell_rays(2048, depth + k + 1)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ours, stats = brick.trace_brick_multi(bsvo, to, td, k, with_stats=True)
    assert_segments(ours, jax_brick.trace_brick_multi_jax(ref_b, o, d, k))
    # the same segments as the stackless trace, bit for bit
    flat = traverse.trace_multi(svo, to, td, k)
    for name_ in ("hit_leaf", "t_in", "t_out", "count"):
        assert torch.equal(getattr(ours, name_), getattr(flat, name_)), name_
    assert int(stats[:, 4].sum()) == 0          # every ray finishes
    assert int(stats[:, 3].max()) <= brick.dda_multi_steps(k)


def test_multi_slot_zero_is_the_first_hit():
    """Slot 0 of the k-segment traces is the single-hit traces' hit."""
    _ref, _ref_b, svo, bsvo = trees("terrain", 6)
    o, d = (torch.from_numpy(a) for a in shell_rays(2048, 3))
    first = traverse.trace_stackless(svo, o, d)
    for multi in (traverse.trace_multi(svo, o, d, 2),
                  brick.trace_brick_multi(bsvo, o, d, 2)):
        assert torch.equal(multi.hit_leaf[:, 0], first.hit_leaf)
        hit = first.hit_leaf >= 0
        assert torch.equal(multi.t_in[hit, 0], first.hit_t[hit])


def params_for(svo, seed):
    """The scene's parameters with random albedo, normals of random length
    and densities over softplus's bend."""
    rng = np.random.default_rng(seed)
    n = svo.n_leaves
    albedo = rng.random((n, 3), dtype=np.float32)
    normal = (svo.leaf_normal.numpy()
              * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    density = rng.uniform(-3.0, 2.0, n).astype(np.float32)
    return albedo, normal, density


@pytest.mark.parametrize("route", ["stackless", "brick"])
def test_render_volumetric_and_grads_match_jax(route):
    """The image and its gradients against the reference's compositing fed
    the port's segments (atol 1e-5; gradients rtol 1e-4 / atol 1e-6); the
    image against the reference's whole render on every ray whose segments
    XLA computes to the same bits (atol 1e-5). Where XLA's contracted
    multiply-adds move a t by an ULP (F14), a short segment's opacity moves
    by up to density_scale * softplus(density) times that, so those rays
    are compared through the first check only."""
    ref, ref_b, svo, bsvo = trees("sphere", 5)
    o, d = shell_rays(1024, 17)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    albedo, normal, density = params_for(svo, 4)
    target = np.random.default_rng(5).random((o.shape[0], 3), dtype=np.float32)
    light = np.asarray(LIGHT, np.float32)
    k = 4
    if route == "stackless":
        ours_img = lambda a, n_, s: diff.render_volumetric(
            a, n_, s, svo, to, td, torch.from_numpy(light), k=k)
        segs = traverse.trace_multi(svo, to, td, k)
        ref_segs = jax_traverse.trace_multi_jax(ref, o, d, k)
        ref_whole = jax_diff.render_volumetric(
            albedo, normal, density, jnp.asarray(ref.masks),
            jnp.asarray(ref.child_base), jnp.asarray(ref.leaf_base),
            jnp.asarray(o), jnp.asarray(d), ref.depth, jnp.asarray(light), k=k)
    else:
        ours_img = lambda a, n_, s: diff.render_volumetric_brick(
            a, n_, s, bsvo, to, td, torch.from_numpy(light), k=k)
        segs = brick.trace_brick_multi(bsvo, to, td, k)
        ref_segs = jax_brick.trace_brick_multi_jax(ref_b, o, d, k)
        ref_whole = jax_diff.render_volumetric_brick(
            albedo, normal, density, jnp.asarray(ref_b.top_masks),
            jnp.asarray(ref_b.top_child), jnp.asarray(ref_b.top_parent),
            jnp.asarray(ref_b.bricks), jnp.asarray(o), jnp.asarray(d),
            ref_b.depth, ref_b.top_depth, jnp.asarray(light), k=k)

    def ref_img(a, n_, s):
        return jax_diff._composite_segments(
            a, n_, s, jnp.asarray(segs.hit_leaf.numpy()),
            jnp.asarray(segs.t_in.numpy()), jnp.asarray(segs.t_out.numpy()),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(light), k, 1.3, 0.08,
            64.0)

    want_img = np.asarray(ref_img(albedo, normal, density))
    want_loss, want_grads = jax.value_and_grad(
        lambda a, n_, s: jnp.mean((ref_img(a, n_, s) - target) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(albedo), jnp.asarray(normal),
                           jnp.asarray(density))

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (albedo, normal, density)]
    img = ours_img(*leaves)
    got = img.detach().numpy()
    np.testing.assert_allclose(got, want_img, rtol=0, atol=1e-5)
    loss = torch.mean((img - torch.from_numpy(target)) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, g, w in zip(("albedo", "normal", "density"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(grads[2].abs().max()) > 0.0

    same = np.ones(o.shape[0], bool)
    for name in ("t_in", "t_out"):
        same &= np.all(getattr(segs, name).numpy().view(np.int32)
                       == np.asarray(getattr(ref_segs, name)).view(np.int32), axis=1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(got[same], np.asarray(ref_whole)[same], rtol=0,
                               atol=1e-5)


def test_volumetric_l2_loss_is_the_stackless_render_s():
    _ref, _ref_b, svo, _bsvo = trees("sphere", 5)
    o, d = (torch.from_numpy(a) for a in shell_rays(256, 21))
    light = torch.tensor(LIGHT)
    params = tuple(torch.from_numpy(a) for a in params_for(svo, 6))
    target = torch.zeros((o.shape[0], 3))
    img = diff.render_volumetric(*params, svo, o, d, light)
    assert torch.equal(diff.volumetric_l2_loss(*params, svo, o, d, light, target),
                       torch.mean(img ** 2))


def test_composite_plain_is_the_differentiable_path_forward():
    """``shade_cuda.composite_fwd`` on CPU tensors (the kernel's plain
    version, plain indexing) gives the differentiable path's image."""
    _ref, _ref_b, svo, bsvo = trees("terrain", 6)
    o, d = (torch.from_numpy(a) for a in shell_rays(512, 8))
    res = brick.trace_brick_multi(bsvo, o, d, 4)
    params = tuple(torch.from_numpy(a) for a in params_for(svo, 7))
    light = torch.tensor(LIGHT)
    got = shade_cuda.composite_fwd(res.hit_leaf, res.t_in, res.t_out, d, *params,
                                   light, 1.3, 0.08, 64.0)
    want = diff.composite_segments(*params, res.hit_leaf, res.t_in, res.t_out, d,
                                   light)
    assert torch.equal(got, want)
    # the empty scene: the sky
    empty = diff.composite_segments(torch.zeros((0, 3)), torch.zeros((0, 3)),
                                    torch.zeros(0), torch.full((4, 2), -1),
                                    torch.zeros((4, 2)), torch.zeros((4, 2)),
                                    d[:4], light)
    assert torch.equal(empty, diff.sky_color(d[:4]))


def test_softplus_is_jax_s():
    x = np.linspace(-30.0, 30.0, 4001).astype(np.float32)
    np.testing.assert_allclose(shade_cuda.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def launch_counts():
    return (dict(brick_cuda.launches), dict(shade_cuda.launches))


@pytest.mark.parametrize("call", [
    lambda svo, bsvo, o, d: brick_cuda._stackless_multi_kernel(svo, o, d, 4),
    lambda svo, bsvo, o, d: brick_cuda._brick_multi_kernel(bsvo, o, d, 4),
    lambda svo, bsvo, o, d: shade_cuda._composite_kernel(
        torch.zeros((o.shape[0], 4), dtype=torch.int32), torch.zeros((o.shape[0], 4)),
        torch.zeros((o.shape[0], 4)), d, svo.leaf_albedo, svo.leaf_normal,
        svo.leaf_density, torch.tensor(LIGHT), 1.3, 0.08, 64.0),
], ids=["esvo_stackless_multi", "brick_trace_multi", "composite_fwd"])
def test_new_kernels_refuse_cpu_tensors_before_any_library(call):
    _ref, _ref_b, svo, bsvo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in shell_rays(64, 1))
    before, loaded = launch_counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        call(svo, bsvo, o, d)
    assert launch_counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what", ["k", "brick k", "rays", "depth", "brick depth",
                                  "composite rank", "composite k", "composite slots",
                                  "plain k", "plain brick k"])
def test_new_launchers_refuse_bad_arguments(what, monkeypatch):
    """k < 1, rays that are not (N, 3), trees out of range and segment
    tensors of another shape raise ValueError before any launch (the device
    check stood in for, so that CPU tensors reach the later checks)."""
    for kernel in (brick_cuda._ESVO_STACKLESS_MULTI, brick_cuda._BRICK_TRACE_MULTI,
                   shade_cuda._COMPOSITE_FWD):
        monkeypatch.setattr(kernel, "check", _launch_check)
    _ref, _ref_b, svo, bsvo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in shell_rays(64, 2))
    n = o.shape[0]
    segs = (torch.zeros((n, 4), dtype=torch.int32), torch.zeros((n, 4)),
            torch.zeros((n, 4)))
    rest = (d, svo.leaf_albedo, svo.leaf_normal, svo.leaf_density,
            torch.tensor(LIGHT), 1.3, 0.08, 64.0)
    calls = {
        "k": lambda: brick_cuda._stackless_multi_kernel(svo, o, d, 0),
        "brick k": lambda: brick_cuda._brick_multi_kernel(bsvo, o, d, -1),
        "rays": lambda: brick_cuda._stackless_multi_kernel(svo, o.reshape(-1), d, 4),
        "depth": lambda: brick_cuda._stackless_multi_kernel(
            dataclasses.replace(svo, depth=23), o, d, 4),
        "brick depth": lambda: brick_cuda._brick_multi_kernel(
            dataclasses.replace(bsvo, depth=bsvo.depth + 1), o, d, 4),
        "composite rank": lambda: shade_cuda._composite_kernel(
            segs[0].reshape(-1), *segs[1:], *rest),
        "composite k": lambda: shade_cuda._composite_kernel(
            segs[0][:, :0], segs[1][:, :0], segs[2][:, :0], *rest),
        "composite slots": lambda: shade_cuda._composite_kernel(
            segs[0], segs[1][:, :3], segs[2], *rest),
        "plain k": lambda: brick_cuda.trace_multi_cuda(svo, o, d, 0),
        "plain brick k": lambda: brick_cuda.trace_brick_multi_cuda(bsvo, o, d, 0),
    }
    before = launch_counts()
    with pytest.raises(ValueError):
        calls[what]()
    assert launch_counts() == before


def _launch_check(device, specs):
    """The launch path's checks of `specs` without its device check."""
    from raytracingtest_tpu_torch import _launch
    _launch.check_tensors(device, specs)
