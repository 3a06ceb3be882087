"""The port's stackless and brick training steps (``diff.loss_and_grads``,
``diff.loss_and_grads_brick``) against the JAX package's, and against each
other.

The same numpy parameters, rays and targets go into both packages; on the
CPU the port's traces and shading run their plain versions. Tolerances:

  * loss against JAX: rtol 1e-5.
  * gradients against JAX: rtol 1e-5, atol 1e-7, the tolerance of
    tests/test_torch_grad.py (shading normalises and sums in another order
    than XLA, which contracts multiply-adds).
  * gradients against builtin autograd through plain indexing (a serial
    scatter-add in ray order): equal below ``SEG_MIN_ROWS`` rows, where the
    backward adds with rank-1 scatter-adds in the same order; within 1e-4
    absolute at or above it, where it takes the sort + running-sum form
    (F4).
  * the brick step against the stackless step: bitwise, images and
    gradients alike (the reference's tests/test_brick.py holds its own two
    steps so), since the two traces give the same hits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff
from raytracingtest_tpu_torch.ops import brick, brick_cuda, shade_cuda
from raytracingtest_tpu_torch.render import sky_color
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = np.array([-0.5, -1.0, -0.3], np.float32)
RTOL, ATOL = 1e-5, 1e-7


class Setup:
    """`terrain` at depth 6 seen by the bench camera at `res` x `res`, in
    both packages."""

    def __init__(self, res):
        self.ref = jax_octree.build_svo(jax_get_scene("terrain"), 6).svo
        self.ref_bsvo = jax_brick.make_brick_svo(self.ref)
        cam = jax_camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                                fov_y_deg=50.0, width=res, height=res)
        self.o, self.d = (np.ascontiguousarray(a) for a in cam.rays(np))
        self.svo = convert.svo_from_numpy(self.ref, "cpu")
        self.bsvo = brick.make_brick_svo(self.svo)
        self.n = self.o.shape[0]

    def params(self):
        rng = np.random.default_rng(3)
        return (rng.random(self.ref.leaf_albedo.shape, dtype=np.float32),
                self.ref.leaf_normal, self.ref.leaf_density)

    def jax_step(self, route, params, target):
        p = [jnp.asarray(a) for a in params]
        o, d, light, t = (jnp.asarray(a) for a in (self.o, self.d, LIGHT, target))
        if route == "brick":
            b = self.ref_bsvo.device()
            loss, grads = jax_diff.loss_and_grads_brick(
                *p, b.top_masks, b.top_child, b.top_parent, b.bricks, o, d,
                b.depth, b.top_depth, light, t)
        else:
            s = self.ref.device()
            loss, grads = jax_diff.loss_and_grads(
                *p, s.masks, s.child_base, s.leaf_base, o, d, s.depth, light, t,
                parent_ptr=s.parent_ptr)
        return float(loss), [np.asarray(g) for g in grads]

    def port_step(self, route, params, target):
        fn, tree = ((diff.loss_and_grads_brick, self.bsvo) if route == "brick"
                    else (diff.loss_and_grads, self.svo))
        return fn(*convert.params_from_numpy(*params, "cpu"), tree,
                  torch.from_numpy(self.o), torch.from_numpy(self.d),
                  torch.from_numpy(LIGHT), torch.from_numpy(target))


@pytest.fixture(scope="module")
def small():
    return Setup(64)


def random_target(n, seed=0):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


def builtin_grads(setup, params, target):
    """Gradients through plain indexing of the hit rows: torch's builtin
    scatter-add backward, rows added in ray order."""
    hit_leaf = brick.trace_brick(setup.bsvo, torch.from_numpy(setup.o),
                                 torch.from_numpy(setup.d)).hit_leaf
    d = torch.from_numpy(setup.d)
    hit = hit_leaf >= 0
    safe = torch.where(hit, hit_leaf, 0).long()

    def loss_fn(albedo, normal, density):
        img = shade_cuda.shade_rows(albedo[safe], normal[safe], density[safe], hit,
                                    sky_color(d), torch.from_numpy(LIGHT), 1.3, 0.08)
        return torch.mean((img - torch.from_numpy(target)) ** 2)
    return diff._value_and_grads(loss_fn, *convert.params_from_numpy(*params, "cpu"))[1]


@pytest.mark.parametrize("target_seed", [None, 0])
@pytest.mark.parametrize("route", ["brick", "stackless"])
def test_step_matches_reference(small, route, target_seed):
    target = (np.zeros((small.n, 3), np.float32) if target_seed is None
              else random_target(small.n, target_seed))
    loss_ref, grads_ref = small.jax_step(route, small.params(), target)
    loss, grads = small.port_step(route, small.params(), target)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    for g, g_ref in zip(grads, grads_ref):
        assert g.shape == g_ref.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=RTOL, atol=ATOL)
    assert float(grads[0].abs().max()) > 0


def test_brick_and_stackless_steps_are_bitwise_equal(small):
    target = random_target(small.n, 1)
    args = (*convert.params_from_numpy(*small.params(), "cpu"),)
    o, d, light = (torch.from_numpy(a) for a in (small.o, small.d, LIGHT))
    img_b = diff.render_diff_brick(*args, small.bsvo, o, d, light)
    img_s = diff.render_diff(*args, small.svo, o, d, light)
    assert torch.equal(img_b.view(torch.int32), img_s.view(torch.int32))
    (loss_b, grads_b), (loss_s, grads_s) = (
        small.port_step(route, small.params(), target) for route in ("brick", "stackless"))
    assert torch.equal(loss_b, loss_s)
    for gb, gs in zip(grads_b, grads_s):
        assert torch.equal(gb.view(torch.int32), gs.view(torch.int32))
    # the reference's own pair is bitwise equal too
    ref = [small.jax_step(route, small.params(), target) for route in ("brick", "stackless")]
    assert ref[0][0] == ref[1][0]
    for a, b in zip(ref[0][1], ref[1][1]):
        np.testing.assert_array_equal(a, b)


def test_brick_step_equals_builtin_autograd_below_seg_min_rows(small):
    assert small.n < diff.SEG_MIN_ROWS
    target = random_target(small.n, 2)
    _loss, grads = small.port_step("brick", small.params(), target)
    for g, g_ref in zip(grads, builtin_grads(small, small.params(), target)):
        np.testing.assert_array_equal(g.numpy(), g_ref.numpy())


def test_brick_step_at_seg_min_rows():
    """256 x 256 rays, exactly SEG_MIN_ROWS: the sort + running-sum
    backward, within 1e-4 of builtin autograd (F4) and within rtol 1e-5 of
    the reference's loss."""
    big = Setup(256)
    assert big.n == diff.SEG_MIN_ROWS
    target = random_target(big.n, 4)
    loss, grads = big.port_step("brick", big.params(), target)
    for g, g_ref in zip(grads, builtin_grads(big, big.params(), target)):
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-4)
    loss_ref, _grads_ref = big.jax_step("brick", big.params(), target)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)


def test_steps_on_cpu_launch_nothing(small):
    before = dict(brick_cuda.launches), dict(shade_cuda.launches)
    for route in ("brick", "stackless"):
        small.port_step(route, small.params(), np.zeros((small.n, 3), np.float32))
    assert (dict(brick_cuda.launches), dict(shade_cuda.launches)) == before
