"""The port's differentiable path against the JAX package's: loss, the
deterministic backward, and the gradient at the bounds of max, min and clip.

The same numpy parameters, rays and targets go into both packages. On the
CPU the port runs the plain versions of its shading kernels. Tolerances:

  * loss: rtol 1e-6. Both sum a few thousand float32 squares, in another
    order.
  * gradients against JAX, and the custom backward against torch's builtin
    autograd: rtol 1e-5, atol 1e-7, the tolerance of the reference's own
    ``test_grads_match_builtin_autodiff``. Shading normalises and sums in
    another order than XLA, which contracts multiply-adds.
  * the rank-1 backward and the kernels' plain segment sums against builtin
    autograd's scatter-add: equal, since all three add a leaf's rows in ray
    order.
  * the sort + running-sum form at 65,536 rows against JAX's and against
    rank-1: rtol 1e-4, atol 2e-5 (float32 reassociation in the running
    sums; the reference's ``test_segment_reduce_matches_rank1_at_scale``).
  * finite differences: 5e-3 relative, as the reference's test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff
from raytracingtest_tpu_torch.ops import shade_cuda
from raytracingtest_tpu_torch.render import sky_color
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = np.array([-0.5, -1.0, -0.3], np.float32)
RTOL, ATOL = 1e-5, 1e-7


class Setup:
    """`sphere` at depth 4 seen by a 32x32 camera, in both packages."""

    def __init__(self, depth=4, width=32, height=32):
        self.ref = jax_octree.build_svo(jax_get_scene("sphere"), depth).svo
        cam = jax_camera.Camera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                                fov_y_deg=45.0, width=width, height=height)
        self.o, self.d = (np.ascontiguousarray(a) for a in cam.rays(np))
        self.svo = convert.svo_from_numpy(self.ref, "cpu")
        self.n = self.o.shape[0]

    def params(self, density_scale=1.0):
        return (self.ref.leaf_albedo, self.ref.leaf_normal,
                (self.ref.leaf_density * density_scale).astype(np.float32))

    def jax_step(self, params, target, light=LIGHT):
        dev = self.ref.device()
        loss, grads = jax_diff.loss_and_grads(
            *(jnp.asarray(p) for p in params), dev.masks, dev.child_base,
            dev.leaf_base, jnp.asarray(self.o), jnp.asarray(self.d),
            self.ref.depth, jnp.asarray(light), jnp.asarray(target))
        return float(loss), [np.asarray(g) for g in grads]

    def port_step(self, params, target, light=LIGHT):
        loss, grads = diff.loss_and_grads_cuda(
            *convert.params_from_numpy(*params, "cpu"), self.svo,
            torch.from_numpy(self.o), torch.from_numpy(self.d),
            torch.from_numpy(light), torch.from_numpy(target))
        return float(loss), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def setup():
    return Setup()


def random_target(n, seed=0):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


@pytest.mark.parametrize("target_seed", [None, 0])
def test_loss_and_grads_match_reference(setup, target_seed):
    target = (np.zeros((setup.n, 3), np.float32) if target_seed is None
              else random_target(setup.n, target_seed))
    loss_ref, grads_ref = setup.jax_step(setup.params(), target)
    loss, grads = setup.port_step(setup.params(), target)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        assert g.shape == g_ref.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, g_ref, rtol=RTOL, atol=ATOL)
    assert np.abs(grads[0]).max() > 0


def _builtin_loss(setup, hit_leaf, target, light):
    """The loss through plain indexing: torch's builtin scatter-add
    backward."""
    d = torch.from_numpy(setup.d)

    def loss_fn(albedo, normal, density):
        hit = hit_leaf >= 0
        safe = torch.where(hit, hit_leaf, 0).long()
        img = shade_cuda.shade_rows(albedo[safe], normal[safe], density[safe],
                                    hit, sky_color(d), light, 1.3, 0.08)
        return torch.mean((img - target) ** 2)
    return loss_fn


def test_grads_match_builtin_autograd(setup):
    """The custom backward (rank-1 scatter-adds at this row count) equals
    torch's builtin autograd through plain indexing."""
    from raytracingtest_tpu_torch.ops import traverse_cuda
    target = torch.zeros((setup.n, 3))
    light = torch.from_numpy(LIGHT)
    params = convert.params_from_numpy(*setup.params(), "cpu")
    _loss, g_custom = diff.loss_and_grads_cuda(
        *params, setup.svo, torch.from_numpy(setup.o),
        torch.from_numpy(setup.d), light, target)
    hit_leaf = traverse_cuda.trace_cuda(
        setup.svo, torch.from_numpy(setup.o), torch.from_numpy(setup.d)).hit_leaf
    _loss_b, g_builtin = diff._value_and_grads(
        _builtin_loss(setup, hit_leaf, target, light), *params)
    for gc, gb in zip(g_custom, g_builtin):
        np.testing.assert_allclose(gc.numpy(), gb.numpy(), rtol=RTOL, atol=ATOL)


def test_shade_function_on_cpu_equals_the_plain_backward(setup):
    """``ShadeCuda`` on CPU tensors runs the plain versions of its three
    kernels (shading, per-ray cotangents, serial segment sum): its
    gradients equal the gather function's rank-1 scatter-adds, which add
    each leaf's rows in the same (ray) order."""
    from raytracingtest_tpu_torch.ops import traverse_cuda
    d = torch.from_numpy(setup.d)
    light = torch.from_numpy(LIGHT)
    target = torch.from_numpy(random_target(setup.n, 3))
    hit_leaf = traverse_cuda.trace_cuda(setup.svo, torch.from_numpy(setup.o), d).hit_leaf
    params = convert.params_from_numpy(*setup.params(0.5), "cpu")
    before = dict(shade_cuda.launches)

    def through(shade):
        return diff._value_and_grads(
            lambda a, n, s: torch.mean((shade(a, n, s) - target) ** 2), *params)

    loss_f, g_f = through(lambda a, n, s: shade_cuda.ShadeCuda.apply(
        a, n, s, hit_leaf, d, light, 1.3, 0.08, None))
    loss_p, g_p = through(lambda a, n, s: diff.shade_diff_plain(
        hit_leaf, d, a, n, s, light, 1.3, 0.08))
    assert float(loss_f) == float(loss_p)
    for a, b in zip(g_f, g_p):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert shade_cuda.launches == before  # CPU tensors never launch


def test_grads_match_finite_differences(setup):
    target = random_target(setup.n, 0)
    params = setup.params()
    _loss, grads = setup.port_step(params, target)
    g_alb = grads[0]
    probe = np.argsort(np.abs(g_alb).ravel())[-5:]
    eps = 1e-3
    for pi in probe:
        i, c = divmod(int(pi), 3)
        ap, am = params[0].copy(), params[0].copy()
        ap[i, c] += eps
        am[i, c] -= eps
        fd = (setup.port_step((ap, *params[1:]), target)[0]
              - setup.port_step((am, *params[1:]), target)[0]) / (2 * eps)
        assert abs(fd - g_alb[i, c]) < 5e-3 * max(1.0, abs(fd)), (i, c, fd, g_alb[i, c])


def test_untouched_voxels_get_zero_grad(setup):
    target = np.zeros((setup.n, 3), np.float32)
    _loss, grads = setup.port_step(setup.params(), target)
    row_mag = np.abs(grads[0]).sum(axis=1)
    assert (row_mag == 0.0).any() and (row_mag > 0.0).any()
    _loss_ref, grads_ref = setup.jax_step(setup.params(), target)
    np.testing.assert_array_equal(row_mag == 0.0,
                                  np.abs(grads_ref[0]).sum(axis=1) == 0.0)


@pytest.mark.parametrize("scale", [0.5, 1.0, 0.0])
def test_density_gradient_matches_reference_at_the_clip_bounds(setup, scale):
    """At density 1.0 (every default scene) and 0.0 the clip is at a tie:
    JAX passes half the cotangent, and so must the port (torch.clamp would
    pass all of it, and double the gradient)."""
    target = np.zeros((setup.n, 3), np.float32)
    params = setup.params(scale)
    assert (params[2] == scale).all()
    _l, grads_ref = setup.jax_step(params, target)
    _l, grads = setup.port_step(params, target)
    assert np.abs(grads_ref[2]).max() > 0.0
    np.testing.assert_allclose(grads[2], grads_ref[2], rtol=RTOL, atol=ATOL)
    if scale != 0.5:
        # half of what the open interval next to the bound gives
        inside = np.full_like(params[2], abs(scale - 1e-4))
        _l, g_in = setup.port_step((*params[:2], inside), target)
        np.testing.assert_allclose(2 * grads[2], g_in[2], rtol=1e-2, atol=ATOL)


def test_normal_perpendicular_to_light_matches_reference(setup):
    """n.l == 0 exactly is a tie of max(., 0): half the cotangent reaches
    the normal, in both packages."""
    light = np.array([0.0, -1.0, 0.0], np.float32)
    albedo, _normal, density = setup.params()
    normal = np.zeros_like(albedo)
    normal[:, 0] = 1.0
    target = random_target(setup.n, 1)
    _l, grads_ref = setup.jax_step((albedo, normal, density), target, light)
    _l, grads = setup.port_step((albedo, normal, density), target, light)
    assert np.abs(grads_ref[1]).max() > 0.0
    for g, g_ref in zip(grads, grads_ref):
        np.testing.assert_allclose(g, g_ref, rtol=RTOL, atol=ATOL)


def test_loss_and_grads_match_interpreted_pallas():
    """`sphere` depth 5, 64x16: the reference's traversal in its Pallas
    kernel, interpreted (tests/test_pallas.py)."""
    s = Setup(depth=5, width=64, height=16)
    rng = np.random.default_rng(0)
    n = s.ref.n_leaves
    params = (rng.random((n, 3), dtype=np.float32),
              s.ref.leaf_normal, np.full(n, 0.7, np.float32))
    target = random_target(s.n, 1)
    dev = s.ref.device()
    loss_ref, grads_ref = jax_diff.loss_and_grads_pallas(
        *(jnp.asarray(p) for p in params), dev.masks, dev.child_base,
        dev.leaf_base, jnp.asarray(s.o), jnp.asarray(s.d), s.ref.depth,
        jnp.asarray(LIGHT), jnp.asarray(target), interpret=True)
    loss, grads = s.port_step(params, target)
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)


def test_segment_reduce_matches_reference_and_rank1_at_scale(monkeypatch):
    rng = np.random.default_rng(5)
    n, m = diff.SEG_MIN_ROWS, 40_000
    assert n == jax_diff.SEG_MIN_ROWS == 1 << 16
    ids = rng.integers(0, m, n, dtype=np.int32)
    cols = rng.random((n, 7), dtype=np.float32) - 0.5
    seg = diff._segment_reduce_cols(torch.from_numpy(ids), torch.from_numpy(cols), m)
    seg_ref = jax_diff._segment_reduce_cols(jnp.asarray(ids), jnp.asarray(cols), m)
    rank1 = np.zeros((m, 7), np.float32)
    np.add.at(rank1, ids, cols)
    assert seg.shape == (m, 7) and seg.dtype == torch.float32
    np.testing.assert_allclose(seg.numpy(), np.asarray(seg_ref), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(seg.numpy(), rank1, rtol=1e-4, atol=2e-5)

    # _gather_bwd takes the segment form at this row count and rank-1 below
    # it; rank-1 is the serial scatter-add, bit for bit
    t = torch.from_numpy
    args = (t(ids), m, t(cols[:, 0:3].copy()), t(cols[:, 3:6].copy()), t(cols[:, 6].copy()))
    out = torch.cat([x.reshape(m, -1) for x in diff._gather_bwd(*args)], dim=1)
    assert torch.equal(out, seg)
    monkeypatch.setattr(diff, "SEG_MIN_ROWS", n + 1)
    out = torch.cat([x.reshape(m, -1) for x in diff._gather_bwd(*args)], dim=1)
    np.testing.assert_array_equal(out.numpy(), rank1)

    # the sorted form's plain segment sum: the same serial order after the
    # sort; and the sort-free form's, which takes the hits as they come
    keys, order = shade_cuda.sort_by_leaf(t(ids), m)
    out = torch.cat([x.reshape(m, -1) for x in
                     shade_cuda.segment_sum_sorted(t(cols), keys, order, m)], dim=1)
    np.testing.assert_array_equal(out.numpy(), rank1)
    out = torch.cat([x.reshape(m, -1) for x in
                     shade_cuda.segment_sum(t(cols), t(ids), m)], dim=1)
    np.testing.assert_array_equal(out.numpy(), rank1)


def _shade_grads(shade, hit_leaf, d, params, target):
    return diff._value_and_grads(
        lambda a, n, s: torch.mean((shade(hit_leaf, d, a, n, s) - target) ** 2),
        *params)[1]


@pytest.mark.parametrize("hits", [
    [-1] * 8,                        # every ray misses
    [0, -1, -1, 0, 2, -1, 0, 2],     # leaf 0 is hit, and misses read it too
])
def test_misses_add_nothing(hits):
    """A miss's cotangents are exactly zero, so leaving misses out of the
    sort and the segment sum (as the kernels do) changes no gradient: all
    rays missing gives all-zero gradients, and leaf 0, which every miss
    reads in the plain version, gets only its hits' sums."""
    rng = np.random.default_rng(2)
    hit_leaf = torch.tensor(hits, dtype=torch.int32)
    d = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    params = (torch.from_numpy(rng.random((3, 3), dtype=np.float32)),
              torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)),
              torch.from_numpy(rng.uniform(0.2, 0.8, 3).astype(np.float32)))
    target = torch.from_numpy(rng.random((8, 3), dtype=np.float32))
    light = torch.from_numpy(LIGHT)
    plain = lambda h, dd, a, n, s: diff.shade_diff(h, dd, a, n, s, light, 1.3, 0.08)
    fused = lambda h, dd, a, n, s: shade_cuda.ShadeCuda.apply(
        a, n, s, h, dd, light, 1.3, 0.08, None)
    g_plain = _shade_grads(plain, hit_leaf, d, params, target)
    g_fused = _shade_grads(fused, hit_leaf, d, params, target)
    # builtin autograd over the hit rays alone
    keep = hit_leaf >= 0
    def only_hits(h, dd, a, n, s):
        img = torch.zeros((8, 3))
        if bool(keep.any()):
            img[keep] = plain(h[keep], dd[keep], a, n, s)
        return torch.where(keep[:, None], img, target)
    g_hits = _shade_grads(only_hits, hit_leaf, d, params, target)
    for a, b, c in zip(g_plain, g_fused, g_hits):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=RTOL, atol=ATOL)
    touched = sorted(set(h for h in hits if h >= 0))
    for g in g_fused:
        untouched = [i for i in range(3) if i not in touched]
        assert not g[untouched].any()
        assert all(bool(g[i].any()) for i in touched)


def test_empty_scene_step_is_sky_loss_and_empty_grads():
    d = torch.tensor([[0.0, 1.0, 0.0], [0.3, -0.2, 0.9]])
    hit_leaf = torch.full((2,), -1, dtype=torch.int32)
    empty = (torch.zeros((0, 3)), torch.zeros((0, 3)), torch.zeros(0))
    target = torch.zeros((2, 3))
    light = torch.from_numpy(LIGHT)
    loss, grads = diff._value_and_grads(
        lambda a, n, s: torch.mean(
            (diff.shade_diff(hit_leaf, d, a, n, s, light, 1.3, 0.08) - target) ** 2),
        *empty)
    assert float(loss) == float(torch.mean(sky_color(d) ** 2))
    assert [tuple(g.shape) for g in grads] == [(0, 3), (0, 3), (0,)]


def test_skybox_shades_misses_and_gets_no_gradient(setup):
    """`skybox=`: misses sample the texture as the reference's
    ``sky_texture`` does (atol 1e-5: atan2 and acos differ in the last bits
    between the two libraries, and the bilinear weights scale them by the
    texture's width)."""
    from raytracingtest_tpu.render import make_gradient_skybox as jax_skybox
    from raytracingtest_tpu_torch.render import make_gradient_skybox
    from raytracingtest_tpu_torch.ops import traverse_cuda
    tex = make_gradient_skybox(16, 32)
    np.testing.assert_array_equal(tex, jax_skybox(16, 32))
    tex = (tex * np.random.default_rng(4).uniform(0.5, 1.0, tex.shape)).astype(np.float32)
    o, d = torch.from_numpy(setup.o), torch.from_numpy(setup.d)
    hit_leaf = traverse_cuda.trace_cuda(setup.svo, o, d).hit_leaf
    params = [p.requires_grad_(True)
              for p in convert.params_from_numpy(*setup.params(0.5), "cpu")]
    sky = torch.from_numpy(tex).requires_grad_(True)
    img = diff.shade_diff(hit_leaf, d, *params, torch.from_numpy(LIGHT), 1.3,
                          0.08, skybox=sky)
    img_ref = jax_diff.shade_diff(
        jnp.asarray(hit_leaf.numpy()), jnp.asarray(setup.d),
        *(jnp.asarray(p) for p in setup.params(0.5)), jnp.asarray(LIGHT), 1.3,
        0.08, skybox=jnp.asarray(tex))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_ref),
                               rtol=0, atol=1e-5)
    img.sum().backward()
    assert sky.grad is None and params[0].grad is not None
