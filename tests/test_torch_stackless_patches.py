"""The stackless traces' patched form, as far as it runs without a card:
the thread order of its pixel patches (``brick_cuda.patch_order``, the map
``csrc/brick_trace.cu``'s ``patch_ray`` computes on the card), that the
``width`` hint changes no output of the wrappers and the serving paths that
pass it (``trace_stackless_cuda``, ``trace_lod_cuda``, ``trace_multi_cuda``,
``render.render_image``, ``diff.render_diff``, ``diff.loss_and_grads``,
``diff.render_volumetric``, ``lod.render_lod``), each held against the JAX
package's ``trace_jax``, ``trace_lod_jax`` and ``trace_multi_jax`` on the
CPU; the per-tree node row table (``traverse.node_rows``) and the parent
pointers derived once a tree; and the launchers' checks and routing, with
the C functions stood in.

Tolerances against XLA: hit ids, counts, hit_parent, hit_child and iters
exactly; hit_t, t_in and t_out to rtol 1e-5 / atol 1e-6, or 4 ULP of the
ray's largest plane term where that is larger (F14: XLA contracts
pos * t_coef - t_bias into a multiply-add). With and without ``width``
the port's outputs are held bit for bit.
"""

import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingtest_tpu.io import checkpoint as jax_ckpt
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import _build, convert, diff, render
from raytracingtest_tpu_torch.io import checkpoint
from raytracingtest_tpu_torch.ops import brick_cuda, camera, lod, traverse
from tests.test_torch_stackless import assert_t_close_to_xla
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SOURCE = _build._CSRC + "/brick_trace.cu"
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
# (width, height) of the cameras the serving paths are held on: a square
# image, and a ragged one (neither side a multiple of its patch's)
IMAGES = [(64, 48), (37, 29)]
LIGHT = (-0.5, -1.0, -0.3)
INTS = ("hit_leaf", "hit_parent", "hit_child", "iters")


@functools.lru_cache(maxsize=None)
def trees(name, depth):
    ref = jax_octree.build_svo(jax_get_scene(name), depth).svo
    return ref, convert.svo_from_numpy(ref, "cpu")


@functools.lru_cache(maxsize=None)
def image_rays(width, height):
    o, d = jax_camera.Camera(**CAM, width=width, height=height).rays(np)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


def bitwise(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:
            continue
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y), name


# ---- the patch order ---------------------------------------------------------

def test_patch_constants_follow_the_source():
    """PATCH_W, PATCH_H, PATCH_BLOCK_MAX and the patched form's code are the
    source's; a warp is one patch."""
    src = open(SOURCE).read()
    found = dict(re.findall(r"\b(PATCH_W|PATCH_H|PATCH_BLOCK_MAX|FORM_PATCHED) = (\d+)",
                            src))
    assert int(found["PATCH_W"]) == brick_cuda.PATCH_W == 8
    assert int(found["PATCH_H"]) == brick_cuda.PATCH_H == 4
    assert brick_cuda.PATCH_W * brick_cuda.PATCH_H == 32
    assert int(found["PATCH_BLOCK_MAX"]) == brick_cuda.PATCH_BLOCK_MAX
    assert int(found["FORM_PATCHED"]) == brick_cuda.FORM_CODES["patched"]
    for kname in ("esvo_stackless", "esvo_stackless_multi"):
        assert brick_cuda.FORMS[kname] == ("patched", "first")
        assert brick_cuda.BLOCKS[(kname, "patched")] % 32 == 0
        assert brick_cuda.BLOCKS[(kname, "patched")] <= brick_cuda.PATCH_BLOCK_MAX


@pytest.mark.parametrize("width,height", [
    (1000, 8), (1023, 17), (12, 5), (64, 48), (37, 29), (8, 4), (9, 5),
    (1, 1), (1, 9), (128, 3), (7, 128)])
def test_patch_order_walks_every_ray_once_in_patches(width, height):
    """A permutation of range(n) with idle lanes past the ragged edges; warp
    p holds patch p (patches in row-major order), lane l its pixel (l % 8,
    l / 8); a full warp covers its whole 8 x 4 patch."""
    n = width * height
    order = brick_cuda.patch_order(n, width)
    pw, ph = -(-width // 8), -(-height // 4)
    assert order.dtype == torch.int64 and order.shape == (pw * ph * 32,)
    assert order.shape[0] == brick_cuda.patch_threads(n, width)
    valid = order[order >= 0]
    assert torch.equal(valid.sort().values, torch.arange(n))
    warps = order.reshape(-1, 32)
    lane = torch.arange(32)
    for p, w in enumerate(warps):
        x0, y0 = (p % pw) * 8, (p // pw) * 4
        x, y = x0 + lane % 8, y0 + lane // 8
        inside = (x < width) & (y < height)
        assert torch.equal(w >= 0, inside)
        assert torch.equal(w[inside], y[inside] * width + x[inside])
        if x0 + 8 <= width and y0 + 4 <= height:
            assert bool(inside.all())
    assert int((order < 0).sum()) == order.shape[0] - n


@pytest.mark.parametrize("n", [0, 1, 37, 4096])
def test_patch_order_without_a_width_is_the_identity(n):
    assert torch.equal(brick_cuda.patch_order(n), torch.arange(n))
    assert brick_cuda.patch_threads(n) == n


@pytest.mark.parametrize("n,width", [(10, 3), (10, 0), (10, -2), (10, 2.5),
                                     (12, 24)])
def test_patch_order_refuses_a_width_that_does_not_divide(n, width):
    with pytest.raises(ValueError, match="row-major image"):
        brick_cuda.patch_order(n, width)


@pytest.mark.parametrize("n,width,block,want", [
    (1024 * 1024, 1024, 128, 1024 * 1024 // 32), (1024 * 1024, None, 128, 32768),
    (1000 * 8, 1000, 64, 250), (1000 * 8, 1000, 128, 252), (1023 * 17, 1023, 256, 640),
    (12 * 5, 12, 128, 4), (0, 7, 128, 0)])
def test_patched_probe_records_have_a_row_a_warp(n, width, block, want):
    """The patched form's launch runs patch_threads lanes in blocks of
    `block`: its probe record has a row for each warp, idle ones included."""
    assert brick_cuda.warps_of(n, "esvo_stackless", "patched", width, block) == want
    threads = brick_cuda.patch_threads(n, width)
    assert want == -(-threads // block) * (block // 32)


# ---- the width changes no output --------------------------------------------

@pytest.mark.parametrize("width,height", IMAGES)
def test_stackless_with_width_equals_without_and_jax(width, height):
    ref, svo = trees("terrain", 6)
    o, d = image_rays(width, height)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got, stats = brick_cuda.trace_stackless_cuda(svo, ot, dt, True, width=width)
    plain, plain_stats = brick_cuda.trace_stackless_cuda(svo, ot, dt, True)
    bitwise(got, plain, INTS + ("hit_t",))
    assert torch.equal(stats, plain_stats)
    want = jax_traverse.trace_jax(ref.device(), jnp.asarray(o), jnp.asarray(d))
    for name in INTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert_t_close_to_xla(got.hit_t, want.hit_t, o, d)
    assert int((got.hit_leaf >= 0).sum()) > 100


@pytest.mark.parametrize("coef", [2.0 * np.tan(np.radians(25.0)) / 48,
                                  16.0 * np.tan(np.radians(25.0)) / 48])
def test_lod_with_width_equals_without_and_jax(coef):
    ref, svo = trees("terrain", 6)
    width, height = IMAGES[0]
    o, d = image_rays(width, height)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = brick_cuda.trace_lod_cuda(svo, ot, dt, coef, width=width)
    bitwise(got, brick_cuda.trace_lod_cuda(svo, ot, dt, coef), INTS + ("hit_t", "hit_node"))
    want = jax_traverse.trace_lod_jax(ref, jnp.asarray(o), jnp.asarray(d), coef)
    for name in INTS + ("hit_node",):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert_t_close_to_xla(got.hit_t, want.hit_t, o, d)


@pytest.mark.parametrize("width,height", IMAGES)
def test_multi_with_width_equals_without_and_jax(width, height):
    ref, svo = trees("terrain", 6)
    o, d = image_rays(width, height)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = brick_cuda.trace_multi_cuda(svo, ot, dt, 4, width=width)
    bitwise(got, brick_cuda.trace_multi_cuda(svo, ot, dt, 4),
            ("hit_leaf", "t_in", "t_out", "count", "iters"))
    want = jax_traverse.trace_multi_jax(ref, o, d, 4)
    np.testing.assert_array_equal(got.hit_leaf.numpy(), np.asarray(want.hit_leaf))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for name in ("t_in", "t_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("trace", ["stackless", "lod", "multi"])
def test_wrappers_refuse_a_width_that_does_not_divide(trace):
    _ref, svo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in image_rays(12, 5))
    call = {"stackless": lambda: brick_cuda.trace_stackless_cuda(svo, o, d, width=7),
            "lod": lambda: brick_cuda.trace_lod_cuda(svo, o, d, 0.01, width=7),
            "multi": lambda: brick_cuda.trace_multi_cuda(svo, o, d, 4, width=7)}[trace]
    with pytest.raises(ValueError, match="row-major image"):
        call()


@pytest.mark.parametrize("width,height", IMAGES)
def test_serving_paths_pass_the_width_and_change_nothing(width, height, monkeypatch):
    """render_image, render_diff, loss_and_grads, render_volumetric and
    render_lod with the camera's width give the images, losses and
    gradients they give without it; render_image passes its camera's."""
    _ref, svo = trees("terrain", 6)
    o, d = (torch.from_numpy(a) for a in image_rays(width, height))
    light = torch.tensor(LIGHT)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    target = torch.full((o.shape[0], 3), 0.25)
    for with_w, without in (
            (diff.render_diff(*params, svo, o, d, light, width=width),
             diff.render_diff(*params, svo, o, d, light)),
            (diff.render_volumetric(*params, svo, o, d, light, width=width),
             diff.render_volumetric(*params, svo, o, d, light))):
        assert torch.equal(with_w, without)
    (loss_w, grads_w), (loss, grads) = (
        diff.loss_and_grads(*params, svo, o, d, light, target, width=w)
        for w in (width, None))
    assert torch.equal(loss_w, loss)
    assert all(torch.equal(a, b) for a, b in zip(grads_w, grads))
    node_albedo, node_normal = lod.compute_node_attributes(svo)
    coef = 2.0 * np.tan(np.radians(25.0)) / height
    img_w, res_w = lod.render_lod(svo, node_albedo, node_normal, o, d, coef, width=width)
    img, res = lod.render_lod(svo, node_albedo, node_normal, o, d, coef)
    assert torch.equal(img_w, img) and torch.equal(res_w.hit_node, res.hit_node)

    cam = camera.Camera(**CAM, width=width, height=height)
    img_w = render.render_image(svo, cam, device="cpu")
    seen = []
    trace = brick_cuda.trace_stackless_cuda
    monkeypatch.setattr(brick_cuda, "trace_stackless_cuda", lambda s, o_, d_, width=None:
                        seen.append(width) or trace(s, o_, d_))
    img = render.render_image(svo, cam, device="cpu")
    assert seen == [width] and torch.equal(img_w, img)


# ---- the node row table and the parent pointers a tree ----------------------

@pytest.mark.parametrize("name,depth", [("sphere", 4), ("terrain", 6)])
def test_node_rows_is_the_four_arrays_side_by_side(name, depth):
    _ref, svo = trees(name, depth)
    rows = traverse.node_rows(svo)
    want = torch.stack([svo.masks, svo.child_base, traverse.parent_ptr_of(svo),
                        svo.leaf_base], 1)
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    assert torch.equal(rows, want) and rows.shape == (svo.n_nodes, 4)
    assert traverse.node_rows(svo) is rows      # kept with the tree


@pytest.fixture
def derive_calls(monkeypatch):
    calls = []
    derive = traverse.derive_parent_ptr
    monkeypatch.setattr(traverse, "derive_parent_ptr",
                        lambda masks, child_base: calls.append(1) or derive(masks, child_base))
    return calls


def test_a_loaded_tree_derives_its_parent_pointers_once(tmp_path, derive_calls):
    """A tree loaded by load_svo carries no parent pointers: the traces and
    a progressive render of it derive them once, and another tree object
    (even of the same arrays) never reuses them."""
    ref, svo = trees("terrain", 5)
    path = str(tmp_path / "svo.npz")
    jax_ckpt.save_svo(ref, path)
    loaded = checkpoint.load_svo(path, "cpu")
    assert loaded.parent_ptr is None
    o, d = (torch.from_numpy(a) for a in image_rays(*IMAGES[1]))
    first = brick_cuda.trace_stackless_cuda(loaded, o, d, width=IMAGES[1][0])
    second = brick_cuda.trace_stackless_cuda(loaded, o, d)
    brick_cuda.trace_multi_cuda(loaded, o, d, 2)
    brick_cuda.trace_lod_cuda(loaded, o, d, 0.01)
    bitwise(first, second, INTS + ("hit_t",))
    bitwise(first, brick_cuda.trace_stackless_cuda(svo, o, d), INTS + ("hit_t",))
    assert len(derive_calls) == 1
    assert torch.equal(traverse.node_rows(loaded)[:, 2], svo.parent_ptr)
    render.render_progressive(loaded, camera.Camera(**CAM, width=16, height=8),
                              n_samples=2, device="cpu")
    assert len(derive_calls) == 1 and loaded.to("cpu") is loaded
    other = dataclasses.replace(loaded)
    brick_cuda.trace_stackless_cuda(other, o, d)
    assert len(derive_calls) == 2


def test_node_rows_follow_a_tree_changed_in_place():
    """A tensor of the tree changed in place (its version counter moves)
    makes the kept tables again."""
    _ref, svo = trees("sphere", 4)
    tree = dataclasses.replace(svo, masks=svo.masks.clone(), parent_ptr=None)
    rows = traverse.node_rows(tree)
    tree.masks[0] = tree.masks[0] ^ 1
    again = traverse.node_rows(tree)
    assert again is not rows and int(again[0, 0]) == int(tree.masks[0])
    assert torch.equal(again[:, [1, 3]], rows[:, [1, 3]])


# ---- the launchers: checks and routing ---------------------------------------

def counts():
    return tuple(dict(c) for c in (brick_cuda.launches, brick_cuda.form_launches,
                                   brick_cuda.probe_launches))


def small():
    _ref, svo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in image_rays(12, 5))
    return svo, o, d


LAUNCHERS = {
    "stackless": lambda svo, o, d: brick_cuda._stackless_kernel(svo, o, d, width=12),
    "stackless first": lambda svo, o, d: brick_cuda._stackless_kernel(svo, o, d,
                                                                      form="first"),
    "lod": lambda svo, o, d: brick_cuda._stackless_lod_kernel(svo, o, d, 0.01, width=12),
    "lod first": lambda svo, o, d: brick_cuda._stackless_lod_kernel(svo, o, d, 0.01,
                                                                    form="first"),
    "multi": lambda svo, o, d: brick_cuda._stackless_multi_kernel(svo, o, d, 4, width=12),
    "multi first": lambda svo, o, d: brick_cuda._stackless_multi_kernel(
        svo, o, d, 4, form="first"),
    "probe patched": lambda svo, o, d: brick_cuda.probe_stackless_cuda(
        svo, o, d, "patched", 12),
    "probe multi patched": lambda svo, o, d: brick_cuda.probe_stackless_multi_cuda(
        svo, o, d, 4, "patched", 12),
}


@pytest.mark.parametrize("which", sorted(LAUNCHERS))
def test_forms_refuse_cpu_tensors_before_any_library(which):
    svo, o, d = small()
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        LAUNCHERS[which](svo, o, d)
    assert counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what", ["form", "probe form", "width", "first with width",
                                  "block", "odd block", "probe block"])
def test_forms_refuse_bad_forms_and_arguments(what, monkeypatch):
    """A form the trace lacks, a width that does not divide the rays, a
    width given to the first form and a block the patched form is not built
    for raise ValueError before any launch (the device check stood in for)."""
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
    svo, o, d = small()
    call = {
        "form": lambda: brick_cuda._stackless_kernel(svo, o, d, form="wide"),
        "probe form": lambda: brick_cuda.probe_stackless_cuda(svo, o, d, "staged"),
        "width": lambda: brick_cuda._stackless_multi_kernel(svo, o, d, 4, width=7),
        "first with width": lambda: brick_cuda._stackless_lod_kernel(
            svo, o, d, 0.01, width=12, form="first"),
        "block": lambda: brick_cuda._stackless_kernel(svo, o, d, block=512),
        "odd block": lambda: brick_cuda._stackless_kernel(svo, o, d, block=48),
        "probe block": lambda: brick_cuda.probe_stackless_multi_cuda(
            svo, o, d, 4, "patched", None, 16),
    }[what]
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError):
        call()
    assert counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("call,entry,tail", [
    ("stackless", "esvo_stackless", 7), ("lod", "esvo_stackless_lod", 10),
    ("multi", "esvo_stackless_multi", 8),
    ("stackless first", "esvo_stackless_serial", None),
    ("lod first", "esvo_stackless_lod_serial", None),
    ("multi first", "esvo_stackless_multi_serial", None),
    ("probe patched", "esvo_stackless_probe", 8),
    ("probe multi patched", "esvo_stackless_multi_probe", 9)])
def test_launchers_pass_the_row_table_width_and_block(call, entry, tail, monkeypatch):
    """With the C functions stood in: the main paths launch the patched
    entries with the tree's row table (the LOD form with the four arrays),
    the width and the rule's block; the first forms their `_serial` entries
    with the four arrays; each counts the launch it made, a first form's as
    an off-path form's."""
    launched = []
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
            monkeypatch.setattr(kernel, "_fn", lambda *a, _n=kernel.name: launched.append(
                (_n, a)) or 0)
            monkeypatch.setattr(kernel, "_raw_stream", lambda index: 0)
            monkeypatch.setattr(kernel, "_current_device", lambda: None)
    svo, o, d = small()
    before = counts()
    LAUNCHERS[call](svo, o, d)
    (name, args), = launched
    assert name == entry
    rows = traverse.node_rows(svo).data_ptr()
    arrays = (svo.masks.data_ptr(), svo.child_base.data_ptr(),
              traverse.parent_ptr_of(svo).data_ptr(), svo.leaf_base.data_ptr())
    if tail is None or entry == "esvo_stackless_lod":
        assert args[:4] == arrays and rows not in args
    if tail is not None and entry != "esvo_stackless_lod":
        probe = entry.endswith("_probe")
        assert args[1 if probe else 0] == rows
        if probe:
            assert args[0] == brick_cuda.FORM_CODES["patched"]
    if tail is not None:
        # (..., n, depth, width, block, ...): the width 12 and the block 128
        assert args[-tail - 4:-tail] == (60, svo.depth, 12, 128)
    after = counts()
    changed = {key for b, a in zip(before, after) for key in a if a[key] != b[key]}
    if entry.endswith("_probe"):
        assert changed == {entry}
    elif tail is None:
        assert changed == {entry}          # form_launches' "<kernel>_serial"
    else:
        assert changed == {entry} and after[0][entry] == before[0][entry] + 1
