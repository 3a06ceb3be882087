"""The port's runtime checks (``utils/checks.py``): each predicate passes on
a healthy trace, render and gradient, and raises with the JAX package's
message on an injected bad value. The predicates are held against the JAX
package's checkify wrappers on the same inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch.ops import camera, octree, traverse
from raytracingtest_tpu_torch.scenes import get_scene
from raytracingtest_tpu_torch.utils import checks
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    svo = octree.build_svo(get_scene("sphere"), 4).svo
    cam = camera.Camera(position=(0.5, 0.6, -1.0), look_at=(0.5, 0.5, 0.5),
                        fov_y_deg=45.0, width=16, height=16)
    o, d = cam.rays("cpu")
    light = torch.tensor([-0.5, -1.0, -0.3])
    return svo, o, d, light


def test_checked_trace_clean(setup):
    svo, o, d, _light = setup
    err, res = checks.checked_trace(svo, o, d)
    err.throw()
    assert err.get() is None
    assert int((res.hit_leaf >= 0).sum()) > 0
    assert torch.equal(res.hit_leaf, traverse.trace_stackless(svo, o, d).hit_leaf)


def test_checked_trace_catches_bounds_violation(setup):
    svo, o, d, _light = setup
    err, _res = checks.checked_trace(svo, o, d, n_leaves=1)
    with pytest.raises(RuntimeError, match="out of bounds"):
        err.throw()


@pytest.mark.parametrize("field,value,message", [
    ("hit_leaf", -2, "hit_leaf < -1"),
    ("hit_t", float("nan"), "non-finite hit_t"),
    ("hit_t", -0.5, "negative hit_t"),
])
def test_trace_predicates_fire(setup, field, value, message):
    svo, o, d, _light = setup
    res = traverse.trace_stackless(svo, o, d)
    ok = checks._first_failure(checks._trace_checks(res, svo.n_leaves))
    assert ok.get() is None
    hit = int(torch.nonzero(res.hit_leaf >= 0)[0, 0])
    bad = getattr(res, field).clone()
    bad[hit] = value
    res = dataclasses.replace(res, **{field: bad})
    err = checks._first_failure(checks._trace_checks(res, svo.n_leaves))
    with pytest.raises(RuntimeError, match=message):
        err.throw()


def test_checked_render_clean_and_nan_poison(setup):
    svo, o, d, light = setup
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    err, img = checks.checked_render_diff(*params, svo, o, d, light)
    err.throw()
    assert img.shape == (256, 3) and bool(torch.isfinite(img).all())
    err, _img = checks.checked_render_diff(params[0] * float("nan"), *params[1:],
                                           svo, o, d, light)
    with pytest.raises(RuntimeError, match="non-finite radiance"):
        err.throw()


def test_checked_grads_clean_and_poisoned(setup):
    svo, o, d, light = setup
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    target = torch.zeros((o.shape[0], 3))
    err, (loss, grads) = checks.checked_grads(*params, svo, o, d, light, target)
    err.throw()
    assert np.isfinite(float(loss)) and len(grads) == 3
    bad_target = target.clone()
    bad_target[0] = float("inf")
    err, _ = checks.checked_grads(*params, svo, o, d, light, bad_target)
    with pytest.raises(RuntimeError, match="non-finite voxel-parameter gradient"):
        err.throw()


def test_predicates_agree_with_jax(setup):
    """The same verdicts as the JAX package's checkify wrappers on the same
    tree, rays and poisoned inputs."""
    import jax.numpy as jnp
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.ops import traverse as jax_traverse
    from raytracingtest_tpu.utils import checks as jax_checks

    svo, o, d, light = setup
    ref = rt.build_svo(rt.get_scene("sphere"), 4).svo.device()
    jo, jd, jl = jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(light.numpy())
    for n_leaves in (svo.n_leaves, 1):
        jerr, _ = jax_checks.checked_trace(
            ref.masks, ref.child_base, ref.leaf_base, jax_traverse.parent_ptr_of(ref),
            jo, jd, ref.depth, n_leaves)
        err, _ = checks.checked_trace(svo, o, d, n_leaves)
        assert (jerr.get() is None) == (err.get() is None)
    alb = svo.leaf_albedo * float("nan")
    jerr, _ = jax_checks.checked_render_diff(
        jnp.asarray(alb.numpy()), jnp.asarray(ref.leaf_normal),
        jnp.asarray(ref.leaf_density), ref.masks, ref.child_base, ref.leaf_base,
        jo, jd, ref.depth, jl)
    err, _ = checks.checked_render_diff(alb, svo.leaf_normal, svo.leaf_density,
                                        svo, o, d, light)
    assert jerr.get() is not None and err.get() is not None
    assert "non-finite radiance" in jerr.get() and "non-finite radiance" in err.get()
