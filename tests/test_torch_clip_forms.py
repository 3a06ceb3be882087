"""The stitched brick trace's forms (``brick_cuda.clipmap_kernel``'s `form`,
``probe_clipmap_brick``) on the CPU: the wrappers' routes and checks, the
probe record's layout against csrc/brick_trace.cu's constants, chip_smoke's
reader of that record, and the plain route (``trace_clipmap_rounds``, which
both CUDA forms are held to bit for bit on the card) against the JAX
package's ``trace_clipmap_device_brick`` on a depth-5 chunk world at 64².
hit_t is held to F14's rtol 1e-5 / atol 1e-6 of XLA on the CPU, the rest
exactly."""

import re

import numpy as np
import pytest
import torch

from raytracingtest_tpu.stream import clipmap as jax_cm

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import brick_cuda, camera
from raytracingtest_tpu_torch.stream import clipmap
from tests.test_torch_stream_trace import _pair, _same_stitched, _world_rays
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SOURCE = f"{_build._CSRC}/brick_trace.cu"


def clip_constants(prefix="CP"):
    src = open(SOURCE).read()
    return {name: int(v) for name, v in re.findall(rf"\b({prefix}_\w+) = (\d+)", src)}


def pow2_reciprocal(size):
    """The wide form's test of a size (csrc/brick_trace.cu's
    pow2_reciprocal) on float32 bits: (whether it takes the product, the
    reciprocal it multiplies by)."""
    bits = int(np.float32(size).view(np.int32))
    e = (bits >> 23) & 0xFF
    inv = np.int32(((254 - e) << 23) & 0xFFFFFFFF).view(np.float32) if 1 <= e <= 253 else None
    return (bits & 0x807FFFFF) == 0 and 1 <= e <= 253, inv


# the sizes a Clipmap makes: chunks of min_chunk_size * 2^lod (the fly
# configuration's 0.125 and 0.25 among them) in a world of size 1
CLIPMAP_SIZES = [0.125 * 2 ** lod for lod in range(4)] + [0.25, 0.5, 1.0]


def test_clip_probe_record_layout_names_the_seven_phases():
    """CLIP_PROBE_FIELDS names the stitched probe's record word for word:
    the phases in CP_* order, then the SM and the global timer (6 + 3 x 7
    words)."""
    c = clip_constants()
    assert c["CP_PHASES"] == len(brick_cuda.CLIP_PHASES) == 7
    for ph in brick_cuda.CLIP_PHASES:
        assert brick_cuda.CLIP_PHASES.index(ph) == c[f"CP_{ph.upper()}"], ph
    fields = brick_cuda.CLIP_PROBE_FIELDS
    assert len(fields) == 6 + 3 * c["CP_PHASES"]
    assert fields[:3] == ("start", "end", "rays")
    base = 3 + 3 * c["CP_ROUND"]
    assert fields[base:base + 3] == ("round_issues", "round_lanes", "round_cycles")
    assert fields[-3:] == ("sm", "ns_start", "ns_end")
    # the record's sizes are Probe<true, NPH>'s
    src = open(SOURCE).read()
    assert "static constexpr int WORDS = PW_PHASES + 3 * NPH + 3;" in src
    assert "Probe<true, CP_PHASES> probe;" in src


def test_clip_warps_line_reads_the_phases_and_rounds(capsys):
    """chip_smoke's stitched [warps] reader on a made-up record of two
    wide-form blocks (eight warps each): a phase's issues a warp, SIMT
    efficiency and cycle share, and the rounds a ray from the round phase's
    lanes."""
    import chip_smoke

    fields = brick_cuda.CLIP_PROBE_FIELDS
    warps = 16
    col = {f: i for i, f in enumerate(fields)}
    rec = np.zeros((warps, len(fields)), np.int64)
    rec[:, col["end"]] = 1000
    rec[:, col["ns_start"]] = np.arange(warps) * 10
    rec[:, col["ns_end"]] = 5000 + np.arange(warps) * 100
    rec[:, col["rays"]] = 32
    rec[:, col["trunk_issues"]], rec[:, col["trunk_lanes"]] = 10, 320
    rec[:, col["trunk_cycles"]] = 200
    rec[:, col["dda_issues"]], rec[:, col["dda_lanes"]] = 8, 128
    rec[:, col["dda_cycles"]] = 250
    rec[:, col["round_issues"]], rec[:, col["round_lanes"]] = 5, 144
    got = chip_smoke.clip_warps_line("clipmap_trace_brick", "wide",
                                     torch.from_numpy(rec))
    assert got["phases"]["trunk"] == dict(issues_a_warp=10, simt=1.0, cycle_share=0.2)
    assert got["phases"]["dda"]["simt"] == 0.5
    assert got["phases"]["dda"]["cycle_share"] == pytest.approx(0.25)
    assert got["rounds_a_ray"] == pytest.approx(144 / 32)
    assert got["round_passes_a_warp"] == 5
    assert "top" not in got["phases"]
    assert "256-thread blocks" in capsys.readouterr().out


@pytest.mark.parametrize("form,rows", [("wide", 4096 // 32), ("first", 4096 // 32),
                                       ("wide", 8), ("first", 4)])
def test_probe_rows_are_the_forms_warps(form, rows):
    """The stitched probe's record has a row for each warp of the form's
    launch: blocks of 256 threads for the wide form, of 128 for the first."""
    n = 4096 if rows > 8 else 100
    assert brick_cuda.warps_of(n, "clipmap_trace_brick", form) == rows
    assert brick_cuda.FORMS["clipmap_trace_brick"] == ("wide", "first")


@pytest.mark.parametrize("form,rows", [("wide", 4096 // 32), ("first", 4096 // 32),
                                       ("wide", 4), ("first", 4)])
def test_node_probe_rows_are_the_forms_warps(form, rows):
    """The node arena's stitched probe has a row for each warp of the form's
    launch: blocks of 128 threads for both forms (CLIP_BLOCK, BLOCK)."""
    n = 4096 if rows > 4 else 100
    assert brick_cuda.warps_of(n, "clipmap_trace", form) == rows
    block = re.search(r"constexpr int CLIP_BLOCK = (\d+);", open(SOURCE).read())
    assert brick_cuda.BLOCKS[("clipmap_trace", "wide")] == int(block.group(1))


@pytest.fixture(scope="module")
def sphere_world():
    """A small sphere clipmap with both arenas (the port's on the CPU) and
    the reference's beside it, its tables, and 64² camera rays."""
    ref, ref_dev, ref_devb, ours, dev, devb = _pair(
        "sphere", arenas=(60000, 120000, 60000, 30000), min_chunk_size=0.25,
        radius=1, lods=1, chunk_depth=5)
    ours.update((0.5, 0.5, 0.5))
    ref.update((0.5, 0.5, 0.5))
    for d_ in (ref_dev, ref_devb, dev, devb):
        d_.sync()
    cam = camera.Camera(position=(0.5, 0.6, -0.3), look_at=(0.5, 0.5, 0.5),
                        fov_y_deg=55.0, width=64, height=64)
    o, d = cam.rays("cpu")
    return dict(ref=ref, ref_devb=ref_devb, ours=ours, devb=devb, o=o, d=d)


@pytest.mark.parametrize("form", [None, "wide", "first"])
def test_clipmap_kernel_forms_refuse_cpu_tensors(sphere_world, form):
    """Each brick form of ``clipmap_kernel`` (None: the main path's) and the
    probe take CUDA tensors only and say so before any library is asked
    for; no launch is counted."""
    w = sphere_world
    trunk, roots, origins, sizes = w["ours"].master_brick()
    tree = w["devb"].tree(5)
    before = (dict(brick_cuda.launches), dict(brick_cuda.form_launches),
              dict(brick_cuda.probe_launches))
    loaded = set(_build._libs)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.clipmap_kernel(trunk, (0.0, 0.0, 0.0), 1.0, roots, origins, sizes,
                                  tree, w["o"], w["d"], 5, 8, form=form)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.probe_clipmap_brick(trunk, (0.0, 0.0, 0.0), 1.0, roots, origins,
                                       sizes, tree, w["o"], w["d"], 5, 8, form or "wide")
    assert set(_build._libs) == loaded
    assert before == (brick_cuda.launches, brick_cuda.form_launches,
                      brick_cuda.probe_launches)


@pytest.mark.parametrize("arena,form", [("brick", "flat"), ("brick", "staged"),
                                        ("node", "staged"), ("node", "probe")])
def test_clipmap_kernel_refuses_a_form_it_lacks(sphere_world, arena, form):
    """A form the kernel does not have, or the probe of the node arena, is
    refused before the tensors are looked at."""
    w = sphere_world
    tables = w["ours"].master_brick() if arena == "brick" else w["ours"].master()
    tree = w["devb"].tree(5) if arena == "brick" else None
    if form == "probe":
        with pytest.raises(ValueError, match="brick arena"):
            brick_cuda.probe_clipmap_brick(tables[0], (0.0, 0.0, 0.0), 1.0, *tables[1:],
                                           tree, w["o"], w["d"], 5, 8, "wide")
        return
    with pytest.raises(ValueError, match="form"):
        brick_cuda.clipmap_kernel(tables[0], (0.0, 0.0, 0.0), 1.0, *tables[1:], tree,
                                  w["o"], w["d"], 5, 8, form=form)


def test_plain_route_matches_jax_brick_trace(sphere_world):
    """trace_clipmap_device_brick on CPU rays (the plain rounds, which the
    wide form and the first form equal bit for bit on the card) against the
    JAX package's trace_clipmap_device_brick on the same world and rays;
    and against itself with the rounds capped."""
    w = sphere_world
    org, size = tuple(w["ours"].octree.root.position), w["ours"].octree.root.size
    trunk, roots, origins, sizes = w["ours"].master_brick()
    rt, rr, ro, rs = w["ref"].master_brick()
    got = clipmap.trace_clipmap_device_brick(trunk, org, size, roots, origins, sizes, 5,
                                             w["devb"], w["o"], w["d"])
    want = jax_cm.trace_clipmap_device_brick(rt, org, size, rr, ro, rs, 5, w["ref_devb"],
                                             w["o"].numpy(), w["d"].numpy())
    _same_stitched(got, want, "brick arena, 64² rays")
    assert int((got[0] >= 0).sum()) > 1000 and not bool(got[3].any())
    o, d = (torch.from_numpy(a) for a in _world_rays(256, 3, center=(0.5, 0.5, 0.5),
                                                     radius=1.5))
    capped = clipmap.trace_clipmap_device_brick(trunk, org, size, roots, origins, sizes,
                                                5, w["devb"], o, d, max_chunks=1)
    full = clipmap.trace_clipmap_device_brick(trunk, org, size, roots, origins, sizes,
                                              5, w["devb"], o, d)
    done = ~capped[3]
    assert torch.equal(capped[0][done], full[0][done])


def test_node_probe_record_layout_names_the_six_phases():
    """CLIP_NODE_PROBE_FIELDS names the node arena's probe record word for
    word: the phases in CN_* order, then the SM and the global timer (6 + 3
    x 6 words), in Probe<true, CN_PHASES>'s layout."""
    c = clip_constants("CN")
    assert c["CN_PHASES"] == len(brick_cuda.CLIP_NODE_PHASES) == 6
    for ph in brick_cuda.CLIP_NODE_PHASES:
        assert brick_cuda.CLIP_NODE_PHASES.index(ph) == c[f"CN_{ph.upper()}"], ph
    fields = brick_cuda.CLIP_NODE_PROBE_FIELDS
    assert len(fields) == 6 + 3 * c["CN_PHASES"]
    base = 3 + 3 * c["CN_SCALE"]
    assert fields[base:base + 3] == ("scale_issues", "scale_lanes", "scale_cycles")
    assert fields[:3] == ("start", "end", "rays") and fields[-3:] == ("sm", "ns_start", "ns_end")
    assert "Probe<true, CN_PHASES> probe;" in open(SOURCE).read()


def test_node_warps_line_reads_the_six_phases(capsys):
    """chip_smoke's [warps] reader on a made-up record of the node arena's
    probe (four wide-form blocks of 128): the scaling phase's issues, SIMT and cycle
    share, and the rounds a ray."""
    import chip_smoke

    fields = brick_cuda.CLIP_NODE_PROBE_FIELDS
    col = {f: i for i, f in enumerate(fields)}
    rec = np.zeros((16, len(fields)), np.int64)
    rec[:, col["end"]] = 1000
    rec[:, col["ns_end"]] = 4000
    rec[:, col["rays"]] = 32
    rec[:, col["scale_issues"]], rec[:, col["scale_lanes"]] = 4, 64
    rec[:, col["scale_cycles"]] = 100
    rec[:, col["step_issues"]], rec[:, col["step_lanes"]] = 20, 640
    rec[:, col["step_cycles"]] = 400
    rec[:, col["round_issues"]], rec[:, col["round_lanes"]] = 3, 96
    got = chip_smoke.clip_warps_line("clipmap_trace", "wide", torch.from_numpy(rec))
    assert got["phases"]["scale"] == dict(issues_a_warp=4, simt=0.5, cycle_share=0.1)
    assert got["phases"]["step"]["cycle_share"] == pytest.approx(0.4)
    assert got["rounds_a_ray"] == pytest.approx(3.0)
    assert "top" not in got["phases"] and "dda" not in got["phases"]
    assert "scale 4.0 issues a warp" in capsys.readouterr().out


@pytest.mark.parametrize("form", [None, "wide", "first"])
def test_node_forms_refuse_cpu_tensors(sphere_world, form):
    """Each form of ``clipmap_trace`` through ``clipmap_kernel`` (None: the
    main path's wide form) and its probe take CUDA tensors only and say so
    before any library is asked for; no launch is counted."""
    w = sphere_world
    trunk, roots, origins, sizes = w["ours"].master()
    tree = clipmap.DeviceArena(w["ours"].arena, "cpu").tree(5)
    before = (dict(brick_cuda.launches), dict(brick_cuda.form_launches),
              dict(brick_cuda.probe_launches))
    loaded = set(_build._libs)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.clipmap_kernel(trunk, (0.0, 0.0, 0.0), 1.0, roots, origins, sizes,
                                  tree, w["o"], w["d"], 5, 8, form=form)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.probe_clipmap(trunk, (0.0, 0.0, 0.0), 1.0, roots, origins, sizes,
                                 tree, w["o"], w["d"], 5, 8, form or "wide")
    with pytest.raises(ValueError, match="node arena"):
        brick_cuda.probe_clipmap(*w["ours"].master_brick()[:1], (0.0, 0.0, 0.0), 1.0,
                                 *w["ours"].master_brick()[1:], w["devb"].tree(5),
                                 w["o"], w["d"], 5, 8, "wide")
    assert set(_build._libs) == loaded
    assert before == (brick_cuda.launches, brick_cuda.form_launches,
                      brick_cuda.probe_launches)


def test_exact_reciprocal_identity():
    """x / 2^k and x * 2^-k are the same float32, bit for bit, for every k
    whose 2^k and 2^-k are normal: random finite bit patterns, subnormals,
    the smallest and largest normals, +-0 and +-inf; the sizes a Clipmap
    makes among the k."""
    rng = np.random.default_rng(19)
    raw = rng.integers(0, 2 ** 32, size=20000, dtype=np.uint64).astype(np.uint32)
    x = raw.view(np.float32)
    x = x[np.isfinite(x)]
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.17549435e-38,
                        -1.17549435e-38, 5.877472e-39, 3.4028235e38, -3.4028235e38,
                        1.0, -1.0, 0.1, 1e-5], np.float32)
    sub = (rng.integers(1, 1 << 23, size=2000, dtype=np.int64).astype(np.int32)
           .view(np.float32))
    xs = torch.from_numpy(np.concatenate([x, special, sub, -sub]))
    ks = list(range(-126, 127))
    assert all(float(np.log2(s)) in ks for s in CLIPMAP_SIZES)
    for k in ks:
        size = torch.tensor(2.0 ** k, dtype=torch.float32)
        inv = torch.tensor(2.0 ** -k, dtype=torch.float32)
        assert float(size) == 2.0 ** k and float(inv) == 2.0 ** -k
        got, want = xs * inv, xs / size
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


def test_power_of_two_model():
    """Which sizes the wide form scales by the product: every size a Clipmap
    makes and every normal power of two whose reciprocal is normal, with that
    reciprocal exactly; the division for the rest (other sizes, 2^127 and
    2^-127, whose reciprocals are not normal, subnormals, 0, inf, negative
    sizes). The model's bit test is the source's."""
    for size in CLIPMAP_SIZES + [2.0 ** k for k in range(-126, 127)]:
        exact, inv = pow2_reciprocal(size)
        assert exact and float(inv) == 1.0 / size, size
    for size in (0.3, 0.75, 3.0, 1.5, 0.125 * 3, 2.0 ** 127, 2.0 ** -127, 1e-40,
                 0.0, np.inf, -0.5, -1.0, np.float32(0.1)):
        assert not pow2_reciprocal(size)[0], size
    src = open(SOURCE).read()
    assert "(bits & 0x807fffff) == 0 && e >= 1 && e <= 253" in src
    assert "inv = __int_as_float((254 - e) << 23);" in src
    assert "if (exact) return (x - org) * inv;" in src
    assert "return (x - org) / size;" in src
