"""The LOD brick trace's patched form, as far as it runs without a card:
``trace_brick_lod_cuda`` with and without the ``width`` hint held against
the JAX package's ``trace_brick_lod_jax`` on the CPU, the hint changing no
output, ``cli render --lod-coef``'s brick branch passing its camera's width,
the width's refusals, and the launchers' checks and routing with the C
functions stood in (the patched form on the main path, the first form
through ``brick_trace_lod_serial``, the probe's form, width and block).

Tolerances against XLA: hit_leaf, hit_node, hit_parent, hit_child and iters
exactly; hit_t to rtol 1e-5 / atol 1e-6, or 4 ULP of the ray's largest
plane term where that is larger (F14: XLA contracts pos * t_coef - t_bias
into a multiply-add). With and without ``width`` the port's outputs are
held bit for bit.
"""

import functools
import re

import numpy as np
import pytest
import torch
from PIL import Image

from raytracingtest_tpu.ops import brick as jax_brick
from raytracingtest_tpu.ops import camera as jax_camera
from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch import _build, convert
from raytracingtest_tpu_torch.ops import brick, brick_cuda
from tests.test_torch_cli import port, ref
from tests.test_torch_stackless import assert_t_close_to_xla
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SOURCE = _build._CSRC + "/brick_trace.cu"
CAM = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5), fov_y_deg=50.0)
# (width, height): a square-ish image, and a ragged one (neither side a
# multiple of its patch's)
IMAGES = [(64, 48), (37, 29)]
INTS = ("hit_leaf", "hit_node", "hit_parent", "hit_child", "iters")
# multiples of the 48-pixel-high image's pixel footprint 2 tan(fov / 2) /
# 48, on both images: at depth 7 the first stops some rays at bricks and
# walks the rest to leaves, the second stops every ray that meets the
# terrain, most above the brick level
COEF_SCALES = (0.0, 3.0, 8.0)


@functools.lru_cache(maxsize=None)
def trees(name, depth):
    """(the JAX BrickSVO, the port's BrickSVO) on the CPU."""
    ref_svo = jax_octree.build_svo(jax_get_scene(name), depth).svo
    return (jax_brick.make_brick_svo(ref_svo),
            brick.make_brick_svo(convert.svo_from_numpy(ref_svo, "cpu")))


@functools.lru_cache(maxsize=None)
def image_rays(width, height):
    o, d = jax_camera.Camera(**CAM, width=width, height=height).rays(np)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32)


def coef_of(scale):
    return scale * 2.0 * np.tan(np.radians(25.0)) / 48


def bitwise(a, b):
    for name in INTS + ("hit_t",):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y), name


# ---- the width changes no output, against the JAX package --------------------

@pytest.mark.parametrize("scale", COEF_SCALES, ids=["0", "3c0", "8c0"])
@pytest.mark.parametrize("width,height", IMAGES)
def test_brick_lod_with_width_equals_without_and_jax(width, height, scale):
    ref_b, bsvo = trees("terrain", 7)
    o, d = image_rays(width, height)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    coef = coef_of(scale)
    got, stats = brick_cuda.trace_brick_lod_cuda(bsvo, ot, dt, coef, with_stats=True,
                                                 width=width)
    plain, plain_stats = brick_cuda.trace_brick_lod_cuda(bsvo, ot, dt, coef,
                                                         with_stats=True)
    bitwise(got, plain)
    assert torch.equal(stats, plain_stats)
    serial = brick_cuda.trace_brick_lod_cuda_serial(bsvo, ot, dt, coef)
    bitwise(got, serial)
    want = jax_brick.trace_brick_lod_jax(ref_b, o, d, coef)
    for name in INTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert_t_close_to_xla(got.hit_t, want.hit_t, o, d)
    assert int(stats[:, 4].sum()) == 0     # every ray finishes
    nodes, leaves = int((got.hit_node >= 0).sum()), int((got.hit_leaf >= 0).sum())
    if scale == 0.0:
        assert nodes == 0 and leaves > 100
    elif scale == 3.0:
        assert nodes > 20 and leaves > 100
        assert bool((got.hit_node[got.hit_node >= 0] >= bsvo.n_top).all())
    else:
        assert nodes > 300 and bool((got.hit_node[got.hit_node >= 0] < bsvo.n_top).any())


@pytest.mark.parametrize("width", [7, 0, -37, 37.5, 2 * 37 * 29])
def test_brick_lod_refuses_a_width_that_does_not_divide(width):
    _ref_b, bsvo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in image_rays(37, 29))
    with pytest.raises(ValueError, match="row-major image"):
        brick_cuda.trace_brick_lod_cuda(bsvo, o, d, 0.01, width=width)


def test_cli_lod_brick_branch_passes_the_width(tmp_path, monkeypatch):
    """`render --lod-coef` on a tree with bricks passes its camera's width
    to trace_brick_lod_cuda; the PNG is the one without the width, and the
    JAX command's, pixel for pixel, on a ragged image."""
    cache = tmp_path / "cache"
    args = ("render", "--scene", "terrain", "--depth", "5", "--width", "37",
            "--height", "29", "--lod-coef", "0.05")
    trace = brick_cuda.trace_brick_lod_cuda
    seen = []

    def recorded(*a, width=None, **kw):
        seen.append(width)
        return trace(*a, width=width, **kw)

    monkeypatch.setattr(brick_cuda, "trace_brick_lod_cuda", recorded)
    port(cache, *args, "--out", str(tmp_path / "with.png"))
    assert seen == [37]
    monkeypatch.setattr(brick_cuda, "trace_brick_lod_cuda",
                        lambda *a, width=None, **kw: trace(*a, **kw))
    port(cache, *args, "--out", str(tmp_path / "without.png"))
    ref(cache, *args, "--out", str(tmp_path / "ref.png"))
    with_w, without, theirs = (np.asarray(Image.open(tmp_path / f"{n}.png"))
                               for n in ("with", "without", "ref"))
    assert with_w.shape == (29, 37, 3) and with_w.std() > 1.0
    np.testing.assert_array_equal(with_w, without)
    np.testing.assert_array_equal(with_w, theirs)
    assert (tmp_path / "with.png").read_bytes() == (tmp_path / "without.png").read_bytes()


# ---- the forms, the blocks and the probe record ------------------------------

def test_forms_and_blocks_follow_the_source():
    """The LOD brick trace's forms and blocks: the patched form's block a
    whole number of warps up to PATCH_BLOCK_MAX, the first form's the
    source's WIDE_BLOCK; the C entries of both forms and the probe are the
    source's."""
    src = open(SOURCE).read()
    consts = dict(re.findall(r"\b(WIDE_BLOCK|PATCH_BLOCK_MAX|FORM_FIRST|FORM_PATCHED) = (\d+)",
                             src))
    assert brick_cuda.FORMS["brick_trace_lod"] == ("patched", "first")
    block = brick_cuda.BLOCKS[("brick_trace_lod", "patched")]
    assert block % 32 == 0 and 32 <= block <= int(consts["PATCH_BLOCK_MAX"])
    assert brick_cuda.BLOCKS[("brick_trace_lod", "first")] == int(consts["WIDE_BLOCK"])
    assert brick_cuda.FORM_CODES["first"] == int(consts["FORM_FIRST"])
    assert brick_cuda.FORM_CODES["patched"] == int(consts["FORM_PATCHED"])
    for entry in ("brick_trace_lod", "brick_trace_lod_serial", "brick_trace_lod_probe"):
        assert re.search(rf'extern "C" int {entry}\(', src), entry
    assert "brick_trace_lod_patched_kernel" in src
    assert "brick_trace_lod_serial" in brick_cuda.form_launches
    assert "brick_trace_lod_probe" in brick_cuda.probe_launches


@pytest.mark.parametrize("n,form,width,block,want", [
    (1024 * 1024, "patched", 1024, 128, 32768), (1024 * 1024, "patched", None, 64, 32768),
    (1024 * 1024, "first", None, None, 32768), (1000 * 8, "patched", 1000, 64, 250),
    (1000 * 8, "patched", 1000, 256, 256), (1023 * 17, "patched", 1023, 128, 640),
    (37 * 29, "first", None, None, 40), (37 * 29, "patched", 37, None, 40),
    (0, "patched", 7, 128, 0), (0, "first", None, None, 0)])
def test_lod_probe_records_have_a_row_a_warp(n, form, width, block, want):
    """A probe record has a row for each warp of the launch: the patched
    form's patch_threads lanes in blocks of `block`, the first form's n
    rays in blocks of 256, idle warps of the last block included."""
    got = brick_cuda.warps_of(n, "brick_trace_lod", form, width, block)
    assert got == want
    span = brick_cuda.BLOCKS[("brick_trace_lod", form)] if block is None else block
    threads = brick_cuda.patch_threads(n, width) if form == "patched" else n
    assert want == -(-threads // span) * (span // 32)


# ---- the launchers: checks and routing ---------------------------------------

def counts():
    return tuple(dict(c) for c in (brick_cuda.launches, brick_cuda.form_launches,
                                   brick_cuda.probe_launches))


def small():
    _ref_b, bsvo = trees("sphere", 4)
    o, d = (torch.from_numpy(a) for a in image_rays(12, 5))
    return bsvo, o, d


LAUNCHERS = {
    "main": lambda bsvo, o, d: brick_cuda._brick_lod_kernel(bsvo, o, d, 0.01, width=12),
    "main in order": lambda bsvo, o, d: brick_cuda._brick_lod_kernel(bsvo, o, d, 0.01),
    "main block 64": lambda bsvo, o, d: brick_cuda._brick_lod_kernel(
        bsvo, o, d, 0.01, width=12, block=64),
    "first": lambda bsvo, o, d: brick_cuda._brick_lod_kernel(bsvo, o, d, 0.01,
                                                             form="first"),
    "probe patched": lambda bsvo, o, d: brick_cuda.probe_brick_lod_cuda(
        bsvo, o, d, 0.01, "patched", 12, 256),
    "probe first": lambda bsvo, o, d: brick_cuda.probe_brick_lod_cuda(
        bsvo, o, d, 0.01, "first"),
}


@pytest.mark.parametrize("which", sorted(LAUNCHERS))
def test_forms_refuse_cpu_tensors_before_any_library(which):
    bsvo, o, d = small()
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        LAUNCHERS[which](bsvo, o, d)
    assert counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what", ["form", "probe form", "width", "first with width",
                                  "first with a block", "block", "odd block",
                                  "probe block", "probe first with width"])
def test_forms_refuse_bad_forms_and_arguments(what, monkeypatch):
    """A form the trace lacks, a width that does not divide the rays, a
    width or a block given to the first form and a block the patched form
    is not built for raise ValueError before any launch (the device check
    stood in for)."""
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
    bsvo, o, d = small()
    lod = brick_cuda._brick_lod_kernel
    call = {
        "form": lambda: lod(bsvo, o, d, 0.01, form="wide"),
        "probe form": lambda: brick_cuda.probe_brick_lod_cuda(bsvo, o, d, 0.01, "staged"),
        "width": lambda: lod(bsvo, o, d, 0.01, width=7),
        "first with width": lambda: lod(bsvo, o, d, 0.01, width=12, form="first"),
        "first with a block": lambda: lod(bsvo, o, d, 0.01, form="first", block=128),
        "block": lambda: lod(bsvo, o, d, 0.01, width=12, block=512),
        "odd block": lambda: lod(bsvo, o, d, 0.01, block=48),
        "probe block": lambda: brick_cuda.probe_brick_lod_cuda(
            bsvo, o, d, 0.01, "patched", None, 16),
        "probe first with width": lambda: brick_cuda.probe_brick_lod_cuda(
            bsvo, o, d, 0.01, "first", 12),
    }[what]
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError):
        call()
    assert counts() == before and set(_build._libs) == loaded


MAIN_BLOCK = brick_cuda.BLOCKS[("brick_trace_lod", "patched")]


@pytest.mark.parametrize("call,entry,form,width,block", [
    ("main", "brick_trace_lod", "patched", 12, MAIN_BLOCK),
    ("main in order", "brick_trace_lod", "patched", 0, MAIN_BLOCK),
    ("main block 64", "brick_trace_lod", "patched", 12, 64),
    ("first", "brick_trace_lod_serial", "first", None, None),
    ("probe patched", "brick_trace_lod_probe", "patched", 12, 256),
    ("probe first", "brick_trace_lod_probe", "first", 0, 256)])
def test_launchers_pass_the_form_width_and_block(call, entry, form, width, block,
                                                 monkeypatch):
    """With the C functions stood in: the main path launches the patched
    entry with the image width and the rule's block, the first form its
    `_serial` entry with neither, the probe entry its form's code, width and
    block and a record of a row a warp; each counts the launch it made, a
    first form's as an off-path form's, a probe's as a probe's."""
    launched = []
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
            monkeypatch.setattr(kernel, "_fn", lambda *a, _n=kernel.name: launched.append(
                (_n, a)) or 0)
            monkeypatch.setattr(kernel, "_raw_stream", lambda index: 0)
            monkeypatch.setattr(kernel, "_current_device", lambda: None)
    bsvo, o, d = small()
    before = counts()
    out = LAUNCHERS[call](bsvo, o, d)
    (name, args), = launched
    assert name == entry
    # (..., stream): the stand-in gets the stream the launch appends
    probe = entry.endswith("_probe")
    if probe:
        assert args[0] == brick_cuda.FORM_CODES[form]
        args = args[1:]
    assert args[-1] == 0
    tables = (bsvo.top_masks.data_ptr(), bsvo.top_child.data_ptr(),
              bsvo.top_parent.data_ptr(), bsvo.bricks.data_ptr(),
              o.data_ptr(), d.data_ptr())
    assert args[:6] == tables
    scalars = (60, bsvo.depth, bsvo.top_depth, bsvo.n_top)
    if width is None:
        assert args[6:10] == scalars and len(args) == 20
        coef_at = 10
    else:
        # the probe's record before the stream
        assert args[6:12] == scalars + (width, block)
        assert len(args) == 22 + probe
        coef_at = 12
    assert args[coef_at:coef_at + 2] == (float(np.float32(0.01)), 0.0)
    if probe:
        record = out[2]
        assert record.shape == (brick_cuda.warps_of(60, "brick_trace_lod", form,
                                                    width or None, block),
                                len(brick_cuda.PROBE_FIELDS))
        assert args[-2] == record.data_ptr()
    after = counts()
    changed = {key for b, a in zip(before, after) for key in a if a[key] != b[key]}
    assert changed == {entry}
    assert after[0].get(entry, 0) == before[0].get(entry, 0) + (entry == "brick_trace_lod")
