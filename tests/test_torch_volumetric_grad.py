"""The volumetric gradient against the JAX package on the CPU: the card's
backward, ``shade_cuda.composite_bwd`` (kernel ``composite_bwd``) with
``segment_sum`` behind ``shade_cuda.CompositeCuda``, in its plain versions,
against ``jax.vjp`` of the reference's ``_composite_segments`` and against
builtin autograd of ``shade_cuda.composite_rows``; and the twins of the
reference's gradient tests of ``tests/test_volumetric.py``.

Rows and gradients are held to rtol 1e-4 / atol 1e-6 (sums of float32
products taken in another order). The cases include a slot whose opacity
is exactly 1 in float32, rays whose k slots are all valid (the sky's term
t_before(k-1) * (1 - alpha(k-1)), which has no 1e-9), and shading at an
exact N.L tie. Inputs come from numpy seeds."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops.camera import Camera as JaxCamera
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import convert, diff
from raytracingtest_tpu_torch.ops import brick_cuda, shade_cuda
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LIGHT = (-0.5, -1.0, -0.3)
SCALARS = (1.3, 0.08, 64.0)   # intensity, ambient, density scale
K = 4


@functools.lru_cache(maxsize=None)
def sphere5():
    ref = jax_octree.build_svo(jax_get_scene("sphere"), 5).svo
    return ref, convert.svo_from_numpy(ref, "cpu")


def segments(seed, n=96, n_leaves=40):
    """Random (N, K) segments over a table of `n_leaves` rows: a quarter of
    the rays with all K slots valid, the rest padded after a random count;
    t's in [0.5, 1.5) with lengths from 0 to 0.3. Slot 0 of ray 0 holds a
    long segment of a dense leaf (leaf 0, density 3): its opacity is 1.0 in
    float32. Leaf 1's normal is perpendicular to the light of
    `tie_light`."""
    rng = np.random.default_rng(seed)
    count = np.where(np.arange(n) % 4 == 0, K, rng.integers(0, K + 1, n))
    leaf = rng.integers(0, n_leaves, (n, K)).astype(np.int32)
    leaf[np.arange(K)[None, :] >= count[:, None]] = -1
    t_in = np.sort(rng.uniform(0.5, 1.5, (n, K)), axis=1).astype(np.float32)
    t_out = (t_in + rng.uniform(0.0, 0.3, (n, K))).astype(np.float32)
    t_out[:, 1] = np.maximum(t_out[:, 1], t_in[:, 1])   # some zero lengths
    t_out[::7, 2] = t_in[::7, 2]
    leaf[0, 0], t_in[0, 0], t_out[0, 0] = 0, 0.5, 0.9
    pad = leaf < 0
    t_in[pad] = t_out[pad] = 0.0
    albedo = rng.random((n_leaves, 3), dtype=np.float32)
    normal = (rng.normal(size=(n_leaves, 3)) * rng.uniform(0.5, 2.0, (n_leaves, 1))
              ).astype(np.float32)
    normal[1] = (1.0, 0.0, 0.0)
    density = rng.uniform(-3.0, 2.0, n_leaves).astype(np.float32)
    density[0] = 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    return leaf, t_in, t_out, d, albedo, normal, density, g


def jax_rows(leaf, t_in, t_out, d, albedo, normal, density, g, light):
    """The reference's per-slot cotangent rows: ``jax.vjp`` of
    ``_composite_segments`` with each valid slot given its own copy of its
    leaf's row, so that the cotangent of row i * K + j is slot j's alone."""
    n = leaf.shape[0]
    valid = leaf >= 0
    safe = np.where(valid, leaf, 0).reshape(-1)
    own = np.where(valid, np.arange(n * K).reshape(n, K), -1).astype(np.int32)
    rows = tuple(jnp.asarray(a[safe]) for a in (albedo, normal, density))
    fn = lambda a, nr, s: jax_diff._composite_segments(
        a, nr, s, jnp.asarray(own), jnp.asarray(t_in), jnp.asarray(t_out),
        jnp.zeros((n, 3), jnp.float32), jnp.asarray(d), jnp.asarray(light), K,
        *SCALARS)
    img, vjp = jax.vjp(fn, *rows)
    g_alb, g_nrm, g_den = vjp(jnp.asarray(g))
    return np.asarray(img), np.concatenate(
        [np.asarray(g_alb), np.asarray(g_nrm), np.asarray(g_den)[:, None]], axis=1)


def as_t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("light", [LIGHT, (0.0, -1.0, 0.0)], ids=["light", "tie_light"])
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_bwd_plain_rows_match_jax_vjp(seed, light):
    leaf, t_in, t_out, d, albedo, normal, density, g = segments(seed)
    want_img, want = jax_rows(leaf, t_in, t_out, d, albedo, normal, density, g,
                              np.asarray(light, np.float32))
    tl = as_t(leaf, t_in, t_out, d, albedo, normal, density, g,
              np.asarray(light, np.float32))
    got = shade_cuda.composite_bwd_plain(tl[7], *tl[:7], tl[8], *SCALARS)
    # the case is what it claims: an opaque slot, full rays, an N.L tie
    alpha0 = 1.0 - torch.exp(-(shade_cuda.softplus(tl[6][0]) * 64.0) * (tl[2][0, 0] - tl[1][0, 0]))
    assert float(alpha0) == 1.0 and int((leaf >= 0).all(axis=1).sum()) >= 24
    if light[0] == 0.0:
        assert (leaf == 1).any()
    valid = (leaf >= 0).reshape(-1)
    assert got.shape == (leaf.size, 7)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-4, atol=1e-6)
    assert not got.numpy()[~valid].any()
    # the forward the rows belong to is the reference's
    img = shade_cuda.composite_fwd(*tl[:7], tl[8], *SCALARS)
    np.testing.assert_allclose(img.numpy(), want_img, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_cuda_cpu_path_matches_builtin_autograd(seed):
    """``CompositeCuda`` on CPU tensors (``composite_fwd``, then
    ``composite_bwd`` and ``segment_sum`` in their plain versions) against
    builtin autograd of ``composite_rows`` through plain indexing, and both
    against ``jax.grad`` of the reference's compositing."""
    leaf, t_in, t_out, d, albedo, normal, density, g = segments(seed + 10)
    light = np.asarray(LIGHT, np.float32)
    tl, tin, tout, td, tlight, tg = as_t(leaf, t_in, t_out, d, light, g)
    n = leaf.shape[0]

    def run(fn):
        params = [torch.from_numpy(a).requires_grad_(True) for a in (albedo, normal, density)]
        img = fn(*params)
        return img.detach(), torch.autograd.grad(img, params, tg)

    img, grads = run(lambda a, nr, s: shade_cuda.CompositeCuda.apply(
        a, nr, s, tl, tin, tout, td, tlight, *SCALARS))

    def builtin(a, nr, s):
        valid, safe = shade_cuda.safe_leaf(tl.reshape(-1), a.shape[0])
        return shade_cuda.composite_rows(
            a[safe].reshape(n, K, 3), nr[safe].reshape(n, K, 3),
            s[safe].reshape(n, K), valid.reshape(n, K), tin, tout,
            diff.sky_color(td), tlight, *SCALARS)

    want_img, want = run(builtin)
    assert torch.equal(img, want_img)
    for name, a, b in zip(("albedo", "normal", "density"), grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    ref_grads = jax.grad(
        lambda a, nr, s: jnp.sum(jax_diff._composite_segments(
            a, nr, s, jnp.asarray(leaf), jnp.asarray(t_in), jnp.asarray(t_out),
            jnp.zeros((n, 3), jnp.float32), jnp.asarray(d), jnp.asarray(light),
            K, *SCALARS) * jnp.asarray(g)), argnums=(0, 1, 2))(
        jnp.asarray(albedo), jnp.asarray(normal), jnp.asarray(density))
    for name, a, b in zip(("albedo", "normal", "density"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert float(grads[2].abs().max()) > 0.0


def card_route_loss(albedo, normal, density, svo, o, d, light, target):
    """``volumetric_l2_loss`` with the compositing through ``CompositeCuda``,
    the card's function, run here in its plain versions."""
    res = brick_cuda.trace_multi_cuda(svo, o, d, K)
    img = shade_cuda.CompositeCuda.apply(albedo, normal, density, res.hit_leaf,
                                         res.t_in, res.t_out, d, light, *SCALARS)
    return torch.mean((img - target) ** 2)


ROUTES = {"cpu_path": lambda *a: diff.volumetric_l2_loss(*a, k=K),
          "card_function": card_route_loss}


# ---- twins of tests/test_volumetric.py ---------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_density_gradcheck(route):
    _ref, svo = sphere5()
    cam = JaxCamera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                    fov_y_deg=45.0, width=16, height=16)
    o, d = as_t(*(a.astype(np.float32) for a in cam.rays(np)))
    target = torch.from_numpy(np.random.default_rng(0).random((o.shape[0], 3),
                                                              dtype=np.float32))
    light = torch.tensor(LIGHT)
    loss = lambda den: ROUTES[route](svo.leaf_albedo, svo.leaf_normal, den, svo,
                                     o, d, light, target)
    density = torch.zeros(svo.n_leaves, requires_grad=True)
    g = torch.autograd.grad(loss(density), density)[0].numpy()
    assert np.abs(g).max() > 0
    eps = 1e-2
    with torch.no_grad():
        for pi in np.argsort(np.abs(g))[-4:]:
            dp = np.zeros(svo.n_leaves, np.float32)
            dm = dp.copy()
            dp[pi], dm[pi] = eps, -eps
            fd = (float(loss(torch.from_numpy(dp))) - float(loss(torch.from_numpy(dm)))) / (2 * eps)
            assert abs(fd - g[pi]) < 2e-2 * max(1.0, abs(fd)), (pi, fd, g[pi])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_volumetric_albedo_grads_flow(route):
    _ref, svo = sphere5()
    rng = np.random.default_rng(43)
    v = rng.normal(size=(256, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = 0.5 + 2.0 * v
    d = 0.5 + rng.normal(0.0, 0.35, (256, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = as_t(o.astype(np.float32), d.astype(np.float32))
    albedo = svo.leaf_albedo.clone().requires_grad_(True)
    loss = ROUTES[route](albedo, svo.leaf_normal, torch.zeros(svo.n_leaves), svo,
                         o, d, torch.tensor(LIGHT), torch.zeros((256, 3)))
    g = torch.autograd.grad(loss, albedo)[0].numpy()
    assert np.abs(g).max() > 0
    assert (np.abs(g).sum(1) == 0).any()  # untouched voxels stay zero


def test_card_function_matches_the_cpu_path_on_a_frame():
    """The two routes' gradients of the same loss on the same segments."""
    _ref, svo = sphere5()
    cam = JaxCamera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                    fov_y_deg=45.0, width=32, height=32)
    o, d = as_t(*(a.astype(np.float32) for a in cam.rays(np)))
    rng = np.random.default_rng(2)
    dens = torch.from_numpy(rng.uniform(-3.0, 2.0, svo.n_leaves).astype(np.float32))
    light, target = torch.tensor(LIGHT), torch.zeros((o.shape[0], 3))
    grads = {}
    for route, fn in ROUTES.items():
        params = [t.clone().requires_grad_(True)
                  for t in (svo.leaf_albedo, svo.leaf_normal, dens)]
        grads[route] = torch.autograd.grad(fn(*params, svo, o, d, light, target), params)
    for name, a, b in zip(("albedo", "normal", "density"), grads["card_function"],
                          grads["cpu_path"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert float(grads["cpu_path"][2].abs().max()) > 0.0


# ---- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("what", ["cpu", "k", "g", "rank", "slots"])
def test_composite_bwd_launcher_refuses(what, monkeypatch):
    """CPU tensors, more slots than the kernel keeps, and a cotangent or
    segments of another shape raise ValueError before any launch or build
    (the device check stood in for, so that CPU tensors reach the later
    checks)."""
    from raytracingtest_tpu_torch import _build, _launch
    if what != "cpu":
        monkeypatch.setattr(shade_cuda._COMPOSITE_BWD, "check",
                            lambda device, specs: _launch.check_tensors(device, specs))
    leaf, t_in, t_out, d, albedo, normal, density, g = segments(3, n=8, n_leaves=4)
    args = list(as_t(g, leaf, t_in, t_out, d, albedo, normal, density,
                     np.asarray(LIGHT, np.float32)))
    wide = shade_cuda.COMPOSITE_BWD_MAX_K + 1
    if what == "k":
        args[1:4] = as_t(np.full((8, wide), -1, np.int32),
                         np.zeros((8, wide), np.float32), np.zeros((8, wide), np.float32))
    elif what == "g":
        args[0] = args[0][:, :2]
    elif what == "rank":
        args[1] = args[1].reshape(-1)
    elif what == "slots":
        args[2] = args[2][:, :2].contiguous()
    before, loaded = dict(shade_cuda.launches), set(_build._libs)
    with pytest.raises(ValueError, match="CUDA tensors" if what == "cpu" else None):
        shade_cuda._composite_bwd_kernel(*args, *SCALARS)
    assert shade_cuda.launches == before and set(_build._libs) == loaded
