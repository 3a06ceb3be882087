"""The port's stackless trace (``traverse.trace_stackless``, the plain
version of the ``esvo_stackless`` kernel) against the JAX package's
``trace_jax`` and its numpy oracle ``trace_numpy``; the parent pointers.

On the CPU the wrapper ``brick_cuda.trace_stackless_cuda`` runs the plain
version; the kernel is held to it on the card by chip_smoke.py.
Tolerances:

  * against ``trace_jax`` (XLA on the CPU): hit_leaf, hit_parent, hit_child
    and iters exactly; hit_t to rtol 1e-5 / atol 1e-6 (F14), or to 4 ULP of
    the ray's largest plane term |t_bias| where that is larger. XLA
    contracts pos * t_coef - t_bias into one multiply-add, which moves a
    plane crossing by up to an ULP of its terms: 1.3e-6 to 4.2e-5 on a few
    rays that start inside the cube (t of 1e-3, terms of 10) or run nearly
    parallel to an axis (terms of 280), 2.5 ULP of the term at most.
  * against ``trace_numpy``: hit_leaf, hit_parent, hit_child and hit_t bit
    for bit, off the rays with two equal direction components, where the
    oracle's POP sums the stepped axes' bits and may climb too far (it then
    runs into its step bound); ``iters`` counts other steps there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingtest_tpu.io import checkpoint as jax_ckpt
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.scenes import get_scene as jax_get_scene
from tests.test_traverse import random_rays

from raytracingtest_tpu_torch import convert
from raytracingtest_tpu_torch.io import checkpoint
from raytracingtest_tpu_torch.ops import brick_cuda, octree, traverse
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SCENES = [("sphere", 5), ("terrain", 5), ("terrain", 6), ("flat_ground", 4),
          ("rotated_cuboid", 5)]
N_RAYS = 4096
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0,
           width=64, height=64)
INTS = ("hit_leaf", "hit_parent", "hit_child", "iters")


def _svos(name, depth):
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    return ref, convert.svo_from_numpy(ref, "cpu")


def make_rays(kind, seed):
    """(o, d) float32 numpy (N_RAYS, 3): the bench camera's rays, rays from
    a shell aimed near the centre, or rays from inside the cube."""
    if kind == "camera":
        o, d = jax_camera.Camera(**CAM).rays(np)
    elif kind == "random":
        o, d = random_rays(N_RAYS, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        o = rng.random((N_RAYS, 3), dtype=np.float32)
        d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


def tied(d):
    """Rays with two equal direction components (in magnitude)."""
    a = np.abs(d)
    return (a[:, 0] == a[:, 1]) | (a[:, 1] == a[:, 2]) | (a[:, 0] == a[:, 2])


def assert_t_close_to_xla(ours_t, ref_t, o, d):
    """hit_t against XLA's: rtol 1e-5 / atol 1e-6, or 4 ULP of the ray's
    largest plane term where that is larger (see the module's docstring)."""
    _coef, t_bias, _om, _t0, _t1 = traverse.ray_setup(torch.as_tensor(o),
                                                      torch.as_tensor(d))
    term = np.maximum(t_bias.abs().amax(dim=1).numpy(), 1.0).astype(np.float32)
    ref_t = np.asarray(ref_t)
    tol = np.maximum(1e-6 + 1e-5 * np.abs(ref_t), 4 * np.spacing(term))
    off = np.abs(ours_t.numpy() - ref_t) > tol
    assert not off.any(), (np.flatnonzero(off), ours_t.numpy()[off], ref_t[off])


def assert_matches_jax(ours, ref, o, d, names=INTS, iters_parting=0):
    """`names` exactly; but `iters` may part by one step on up to
    `iters_parting` rays (F11's rule: see tests/test_torch_brick_trace.py)."""
    for name in names:
        a = getattr(ours, name).numpy()
        assert a.dtype == np.int32, name
        want = np.asarray(getattr(ref, name))
        if name == "iters" and iters_parting:
            parted = a != want
            assert parted.sum() <= iters_parting and (np.abs(a - want) <= 1).all()
            a = np.where(parted, want, a)
        np.testing.assert_array_equal(a, want, err_msg=name)
    assert_t_close_to_xla(ours.hit_t, ref.hit_t, o, d)


def assert_matches_oracle(ours, ref, d, names=("hit_leaf", "hit_parent", "hit_child")):
    """Bit for bit off the tied rays; on them the oracle may only part by
    missing at its step bound."""
    off = ~tied(d)
    for name in names:
        np.testing.assert_array_equal(getattr(ours, name).numpy()[off],
                                      getattr(ref, name)[off], err_msg=name)
    np.testing.assert_array_equal(ours.hit_t.numpy()[off].view(np.int32),
                                  np.asarray(ref.hit_t, np.float32)[off].view(np.int32))
    parted = ours.hit_leaf.numpy() != ref.hit_leaf
    assert (ref.hit_leaf[parted] == -1).all()
    return int(parted.sum())


@pytest.mark.parametrize("kind", ["camera", "random", "inside"])
@pytest.mark.parametrize("name,depth", SCENES)
def test_stackless_matches_reference_and_oracle(name, depth, kind):
    ref_svo, svo = _svos(name, depth)
    o, d = make_rays(kind, seed=depth)
    ours, stats = traverse.trace_stackless(svo, torch.from_numpy(o),
                                           torch.from_numpy(d), with_stats=True)
    assert_matches_jax(ours, jax_traverse.trace_jax(ref_svo.device(), jnp.asarray(o),
                                                    jnp.asarray(d)), o, d)
    assert_matches_oracle(ours, jax_traverse.trace_numpy(ref_svo, o, d), d)
    assert int((ours.hit_leaf >= 0).sum()) > 100
    assert int(stats[:, traverse.STAT_NAMES.index("unfinished")].sum()) == 0
    assert int(ours.iters.max()) < traverse.max_iters_for_depth(depth)


def test_stackless_diagonal_ties():
    """The frame of the oracle's diagonal fault (tests/test_torch_traverse.py):
    the oracle misses 4 tied rays at its step bound; the stackless walk
    climbs one level a step and hits them, as the reference does. On tied
    rays XLA's step count may part by one from the port's (F11's rule):
    XLA contracts pos * t_coef - t_bias into a multiply-add, so two corner
    planes that tie in the port (built without contraction, as the kernel
    is) may not tie there, and its ray steps the two axes one after the
    other instead of at once."""
    ref_svo, svo = _svos("sphere", 5)
    cam = jax_camera.Camera(position=(0.5, 0.5, -0.8), look_at=(0.5, 0.5, 0.5),
                            fov_y_deg=45.0, width=64, height=16)
    o, d = (np.ascontiguousarray(a) for a in cam.rays(np))
    ours = traverse.trace_stackless(svo, torch.from_numpy(o), torch.from_numpy(d))
    ref = jax_traverse.trace_jax(ref_svo.device(), jnp.asarray(o), jnp.asarray(d))
    assert_matches_jax(ours, ref, o, d, names=("hit_leaf", "hit_parent", "hit_child"))
    steps = ours.iters.numpy() - np.asarray(ref.iters)
    assert (steps[~tied(d)] == 0).all() and (np.abs(steps) <= 1).all()
    assert 0 < np.count_nonzero(steps) <= 8
    assert assert_matches_oracle(ours, jax_traverse.trace_numpy(ref_svo, o, d), d) == 4


def test_stackless_step_bound_binds(monkeypatch):
    """With the bound cut to 24 steps, many rays stop short in both
    packages, at the same step and with the same (missing) hit: the bound
    is per ray in both."""
    ref_svo, svo = _svos("terrain", 6)
    o, d = make_rays("camera", seed=0)
    o, d = o[2048:2825], d[2048:2825]  # a shape no other test traces with the patch
    for mod in (jax_traverse, traverse):
        monkeypatch.setattr(mod, "max_iters_for_depth", lambda depth: 24)
    try:
        ref = jax_traverse.trace_jax(ref_svo.device(), jnp.asarray(o), jnp.asarray(d))
        ours, stats = traverse.trace_stackless(svo, torch.from_numpy(o),
                                               torch.from_numpy(d), with_stats=True)
    finally:
        jax.clear_caches()
    assert_matches_jax(ours, ref, o, d)
    unfinished = stats[:, traverse.STAT_NAMES.index("unfinished")].numpy() == 1
    assert 50 < unfinished.sum() < len(o)
    assert (ours.iters.numpy()[unfinished] == 24).all()
    assert (ours.hit_leaf.numpy()[unfinished] == -1).all()


@pytest.mark.parametrize("name,depth", SCENES + [("sphere", 3)])
def test_derive_parent_ptr(name, depth):
    ref_svo, svo = _svos(name, depth)
    ours = traverse.derive_parent_ptr(svo.masks, svo.child_base)
    assert ours.dtype == torch.int32
    want = jax_traverse.derive_parent_ptr_jnp(jnp.asarray(ref_svo.masks),
                                              jnp.asarray(ref_svo.child_base))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ours.numpy(), octree.compute_parent_ptr(svo.masks.numpy(), svo.child_base.numpy()))


def test_parent_ptr_of_derives_for_a_loaded_svo(tmp_path):
    ref_svo, svo = _svos("terrain", 5)
    path = str(tmp_path / "svo.npz")
    jax_ckpt.save_svo(ref_svo, path)
    loaded = checkpoint.load_svo(path, "cpu")
    assert loaded.parent_ptr is None and svo.parent_ptr is not None
    assert torch.equal(traverse.parent_ptr_of(loaded), svo.parent_ptr)
    assert traverse.parent_ptr_of(svo) is svo.parent_ptr
    o, d = (torch.from_numpy(a) for a in make_rays("random", seed=3))
    a, b = (traverse.trace_stackless(s, o, d) for s in (loaded, svo))
    for name in INTS + ("hit_t",):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_stackless_wrapper_on_cpu_runs_the_plain_version():
    _ref, svo = _svos("terrain", 5)
    o, d = (torch.from_numpy(a) for a in make_rays("camera", seed=0))
    before = dict(brick_cuda.launches)
    ours, stats = brick_cuda.trace_stackless_cuda(svo, o, d, with_stats=True)
    plain, plain_stats = traverse.trace_stackless(svo, o, d, with_stats=True)
    assert brick_cuda.launches == before  # no kernel launch on the CPU
    for name in INTS + ("hit_t",):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name
    assert torch.equal(stats, plain_stats)
    assert stats.shape == (o.shape[0], len(traverse.STAT_NAMES))
    # any ray count, one ray included
    one = brick_cuda.trace_stackless_cuda(svo, o[:1], d[:1])
    assert one.hit_leaf.shape == (1,) and int(one.hit_leaf[0]) == int(plain.hit_leaf[0])


def test_stackless_kernel_refuses_cpu_tensors():
    """The kernel's wrapper has no CPU path: it raises before any build."""
    _ref, svo = _svos("sphere", 3)
    with pytest.raises(ValueError, match="CUDA"):
        brick_cuda._stackless_kernel(svo, torch.zeros((10, 3)), torch.ones((10, 3)))


def test_stackless_misses_and_axis_rays():
    """Zero direction components (the eps clamp), rays from inside the
    cube, rays that miss it, and an empty batch."""
    ref_svo, svo = _svos("flat_ground", 4)
    o = np.array([[0.5, 0.9, 0.5], [0.5, 0.9, 0.5], [0.2, 0.1, 0.7],
                  [-1.0, 0.2, 0.5], [3.0, 3.0, 3.0], [0.5, 2.0, 0.5]], np.float32)
    d = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                  [1.0, 0.0, -0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    ours = traverse.trace_stackless(svo, torch.from_numpy(o), torch.from_numpy(d))
    assert_matches_jax(ours, jax_traverse.trace_jax(ref_svo.device(), jnp.asarray(o),
                                                    jnp.asarray(d)), o, d)
    assert_matches_oracle(ours, jax_traverse.trace_numpy(ref_svo, o, d), d)
    assert int(ours.hit_leaf[0]) >= 0 and int(ours.hit_leaf[4]) == -1
    assert int(ours.iters[4]) == 0
    empty = traverse.trace_stackless(svo, torch.zeros((0, 3)), torch.ones((0, 3)))
    assert empty.hit_leaf.shape == (0,)


def test_walk_state_is_init_state_without_the_stack():
    o, d = (torch.from_numpy(a) for a in make_rays("inside", seed=1))
    st = traverse.walk_state(o, d, 6)
    full = traverse.init_state(o, d, 6)
    for name, value in st.items():
        if name == "popped":
            assert not bool(value.any())
            continue
        assert torch.equal(value, getattr(full, name)), name
