"""The launch path every kernel's wrapper goes through
(``raytracingtest_tpu_torch/_launch.py``), as far as it runs without a card:
its checks, that they come before the library is asked for, and what a call
does with the stream, the device and the error code (against a stand-in for
the C function); the tile walker's rule for its lanes a ray and the
checks of its arguments; phase 1's rule for its warps a tile; the brick and
stackless traces' probe records and the checks of their forms' arguments;
and the first forms' wrappers on the CPU. The launcher (``csrc/launch.cpp``)
builds here too: it calls, with the arguments of every entry point that
``_build`` declares, a C function of that entry point's parameter types
that records what it was given."""

import ctypes
import dataclasses
import subprocess
import types

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch import _build, _launch
from raytracingtest_tpu_torch.ops import (
    brick, brick_cuda, brick_dda, gather, octree_cuda, rowread, shade_cuda,
    tile_cuda, traverse, traverse_cuda)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")

KERNELS = {
    "esvo_trace": traverse_cuda._ESVO_TRACE,
    "esvo_trace_serial": traverse_cuda._ESVO_TRACE_SERIAL,
    "tile_walk": tile_cuda._TILE_WALK,
    "tile_walk_serial": tile_cuda._TILE_WALK_SERIAL,
    "tile_candidates": tile_cuda._TILE_CANDIDATES,
    "tile_candidates_block": tile_cuda._TILE_CANDIDATES_BLOCK,
    "tile_candidates_mapped": tile_cuda._TILE_CANDIDATES_MAPPED,
    "tile_candidates_mapped_first": tile_cuda._TILE_CANDIDATES_MAPPED_FIRST,
    "tile_candidates_radix": tile_cuda._TILE_CANDIDATES_RADIX,
    "tile_candidates_probe": tile_cuda._TILE_CANDIDATES_PROBE,
    "brick_dda16": brick_dda._BRICK_DDA16,
    "rowread": rowread._ROWREAD,
    "take": gather._TAKE,
    "loop_probe": gather._LOOP_PROBE,
    "loop_probe_serial": gather._LOOP_PROBE_SERIAL,
    "shade_fwd": shade_cuda._SHADE_FWD,
    "shade_bwd": shade_cuda._SHADE_BWD,
    "shade_bwd_serial": shade_cuda._SHADE_BWD_SERIAL,
    "segment_sum": shade_cuda._SEGMENT_SUM,
    "segment_sum_sorted": shade_cuda._SEGMENT_SUM_SORTED,
    "esvo_stackless": brick_cuda._ESVO_STACKLESS,
    "esvo_stackless_probe": brick_cuda._ESVO_STACKLESS_PROBE,
    "brick_trace": brick_cuda._BRICK_TRACE,
    "brick_trace_serial": brick_cuda._BRICK_TRACE_SERIAL,
    "brick_trace_unstaged": brick_cuda._BRICK_TRACE_UNSTAGED,
    "brick_trace_probe": brick_cuda._BRICK_TRACE_PROBE,
    "esvo_stackless_multi": brick_cuda._ESVO_STACKLESS_MULTI,
    "esvo_stackless_multi_probe": brick_cuda._ESVO_STACKLESS_MULTI_PROBE,
    "brick_trace_multi": brick_cuda._BRICK_TRACE_MULTI,
    "brick_trace_multi_serial": brick_cuda._BRICK_TRACE_MULTI_SERIAL,
    "brick_trace_multi_probe": brick_cuda._BRICK_TRACE_MULTI_PROBE,
    "composite_fwd": shade_cuda._COMPOSITE_FWD,
    "esvo_stackless_lod": brick_cuda._ESVO_STACKLESS_LOD,
    "brick_trace_lod": brick_cuda._BRICK_TRACE_LOD,
    "composite_bwd": shade_cuda._COMPOSITE_BWD,
    "svo_level_pass": octree_cuda._SVO_LEVEL_PASS,
}


def good():
    return torch.zeros((4, 3), dtype=torch.float32)


@pytest.mark.parametrize("what,tensor,dtype,shape,says", [
    ("device", torch.zeros((4, 3), device="meta"), torch.float32, (4, 3), "on meta"),
    ("dtype", good().to(torch.float64), torch.float32, (4, 3), "torch.float64"),
    ("shape", good(), torch.float32, (3, 4), "(4, 3)"),
    ("rank", good(), torch.float32, (12,), "(4, 3)"),
    ("contiguity", torch.zeros((3, 4)).t(), torch.float32, (4, 3), "non-contiguous"),
])
def test_check_tensors_names_the_argument(what, tensor, dtype, shape, says):
    _launch.check_tensors(CPU, (("fine", good(), torch.float32, (4, 3)),))
    with pytest.raises(ValueError) as err:
        _launch.check_tensors(CPU, (("fine", good(), torch.float32, (4, 3)),
                                    ("the_bad_one", tensor, dtype, shape)))
    assert "the_bad_one" in str(err.value) and says in str(err.value)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_refuses_cpu_before_any_library(name):
    """A CPU device is refused by name, and neither making the launcher nor
    refusing asks ``_build`` for a library."""
    kernel = KERNELS[name]
    resolved, loaded = kernel._fn, set(_build._libs)
    assert kernel.name == name
    with pytest.raises(ValueError, match=f"the {name} kernel takes CUDA tensors"):
        kernel.check(CPU, (("x", good(), torch.float32, (4, 3)),))
    assert kernel._fn is resolved and set(_build._libs) == loaded


def test_check_comes_before_the_library():
    def no_library():
        raise AssertionError("the library was asked for")
    kernel = _launch.Kernel("probe", no_library)
    cuda0 = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="x: expected contiguous"):
        kernel.check(cuda0, (("x", good(), torch.float32, (4, 3)),))   # on the CPU
    with pytest.raises(AssertionError):
        kernel(cuda0, 1, 2)            # only a launch asks for it


class FakeFn:
    """Stands in for a ctypes function: records its arguments."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def wired(err, current=0):
    kernel = _launch.Kernel("probe", lambda: None)
    kernel._fn = FakeFn(err)
    kernel._raw_stream = lambda index: 1000 + index
    kernel._current_device = lambda: current
    return kernel


def test_call_appends_the_raw_stream_of_the_tensors_device():
    kernel = wired(0)
    assert kernel(torch.device("cuda", 0), 11, 2.5) is None
    assert kernel._fn.calls == [(11, 2.5, 1000)]


def test_call_raises_on_the_error_code():
    kernel = wired(700)
    with pytest.raises(RuntimeError, match="probe launch failed: cudaError 700"):
        kernel(torch.device("cuda", 0), 1)


def test_call_switches_device_only_for_another_one(monkeypatch):
    entered = []

    class Guard:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Guard)
    kernel = wired(0, current=0)
    kernel(torch.device("cuda", 0), 5)
    assert entered == []
    kernel(torch.device("cuda", 1), 5)
    assert entered == [1] and kernel._fn.calls[-1] == (5, 1001)


def declared_entry_points():
    """(library.entry point, argtypes, restype) of every C entry point of the
    CUDA libraries, from ``_build``'s declarations run on a stand-in."""
    class StandIn:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    out = []
    for lib, declare in (("esvo_trace", _build._declare_trace),
                         ("tile_walk", _build._declare_tile),
                         ("shade", _build._declare_shade),
                         ("tile_candidates", _build._declare_candidates),
                         ("brick_trace", _build._declare_brick),
                         ("svo_build", _build._declare_svo)):
        stand_in = StandIn()
        declare(stand_in)
        out += [(f"{lib}.{name}", fn.argtypes, fn.restype)
                for name, fn in stand_in.fns.items()]
    return out


ENTRY_POINTS = declared_entry_points()
C_TYPES = {"p": "void*", "i": "int", "l": "long long", "f": "float"}


@pytest.fixture(scope="module")
def echo_lib(tmp_path_factory):
    """A C library with, for each parameter list of ENTRY_POINTS, a function
    echo_<kinds> that stores its arguments as doubles in rec[] and returns
    their count; and echo_pif."""
    lines = ["#include <stdint.h>", "double rec[64];"]
    for kinds in sorted({_launch.kinds(a) for _n, a, _r in ENTRY_POINTS} | {"pif"}):
        params = ", ".join(f"{C_TYPES[c]} a{k}" for k, c in enumerate(kinds))
        body = " ".join(f"rec[{k}] = (double)" + ("(uintptr_t)" if c == "p" else "")
                        + f"a{k};" for k, c in enumerate(kinds))
        lines.append(f"int echo_{kinds}({params}) {{ {body} return {len(kinds)}; }}")
    src = tmp_path_factory.mktemp("echo") / "echo.c"
    src.write_text("\n".join(lines) + "\n")
    so = src.with_suffix(".so")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    return ctypes.CDLL(str(so))


def echo(lib, argtypes):
    fn = getattr(lib, f"echo_{_launch.kinds(argtypes)}")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def arguments(kinds):
    """A value of each kind, none repeated: pointers high in the address
    space (one NULL), negative ints, long longs past 2**32, floats."""
    return [None if (c, k) == ("p", 1) else {"p": 0x7F00_0000_0000 + 64 * k,
                                              "i": -1001 * (k + 1), "l": 2**40 + k,
                                              "f": k + 0.25}[c]
            for k, c in enumerate(kinds)]


@pytest.mark.parametrize("name,argtypes,restype", ENTRY_POINTS,
                         ids=[e[0] for e in ENTRY_POINTS])
def test_launcher_passes_every_entry_points_arguments(echo_lib, name, argtypes,
                                                      restype):
    """Every argument arrives where the entry point's own type puts it: in
    the registers and, past them, the stack slots, floats among the others."""
    assert restype is ctypes.c_int
    kinds = _launch.kinds(argtypes)
    values = arguments(kinds)
    assert _launch.bind(echo(echo_lib, argtypes))(*values) == len(kinds)
    rec = (ctypes.c_double * 64).in_dll(echo_lib, "rec")
    assert list(rec[:len(kinds)]) == [float(v or 0) for v in values]


def test_launcher_takes_a_buffer_and_refuses_what_ctypes_would_cut(echo_lib):
    """A pointer may come as a ctypes array, as the phase-1 and row-read
    wrappers pass their widths and scalars: its address arrives."""
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    call = _launch.bind(echo(echo_lib, argtypes))
    widths = (ctypes.c_int * 3)(4, 5, 6)
    assert call(widths, -3, 0.5) == 3
    rec = (ctypes.c_double * 64).in_dll(echo_lib, "rec")
    assert list(rec[:3]) == [ctypes.addressof(widths), -3, 0.5]
    with pytest.raises(OverflowError, match="argument 1"):
        call(0, 2**31, 1.0)
    with pytest.raises(TypeError):
        call(0, 1)                       # too few
    with pytest.raises(TypeError):
        call(0, 1.5, 1.0)                # a float for an int
    with pytest.raises(TypeError):
        call("0", 1, 1.0)                # a string for a pointer
    with pytest.raises(TypeError, match="c_double"):
        _launch.kinds([ctypes.c_void_p, ctypes.c_double])
    fn = echo(echo_lib, argtypes)
    fn.restype = ctypes.c_float
    with pytest.raises(TypeError, match="not an int"):
        _launch.bind(fn)
    module = _build.launch_lib()
    address = ctypes.cast(fn, ctypes.c_void_p).value
    with pytest.raises(ValueError, match="at most"):
        module.bind(address, "f" * (module.MAX_FLOATS + 1))
    with pytest.raises(ValueError, match="expected p, i, l or f"):
        module.bind(address, "pd")


def test_kernel_launches_through_the_launcher(echo_lib):
    """``Kernel.__call__`` with the launcher bound in: the stream goes last
    and the entry point's nonzero return raises."""
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    kernel = wired(0)
    kernel._fn = _launch.bind(echo(echo_lib, argtypes))
    with pytest.raises(RuntimeError, match="probe launch failed: cudaError 8"):
        kernel(torch.device("cuda", 0), 8, 16, 24, 5, 6, 7, 0)
    rec = (ctypes.c_double * 64).in_dll(echo_lib, "rec")
    assert list(rec[:8]) == [8, 16, 24, 5, 6, 7, 0, 1000]


@pytest.mark.parametrize("call", [
    lambda: rowread._launch(torch.zeros((4, 8), dtype=torch.int32),
                            rowread.MODE_ROWS, 0,
                            torch.zeros(2, dtype=torch.int32), 2),
    lambda: gather._take_kernel(torch.zeros(8), torch.zeros(4, dtype=torch.int32),
                                gather.TAKE_1D),
    lambda: gather._loop_kernel(torch.zeros((2, 8)), None, 1, 1, 0, gather.LOOP_FLOAT),
    lambda: gather._loop_kernel(torch.zeros((2, 8), dtype=torch.int32),
                                torch.zeros((4, 8), dtype=torch.int32), 1, 0, 4,
                                gather.LOOP_INT, gather._LOOP_PROBE_SERIAL),
], ids=["rowread", "take", "loop_probe", "loop_probe_serial"])
def test_kernel_level_calls_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        call()


def test_rowread_batch_forms_on_the_cpu():
    table = torch.arange(64 * 128, dtype=torch.int32).reshape(64, 128)
    rows = rowread.rowread_scalar(table, [3, 99, -2, 17])
    assert torch.equal(rows, table[[3, 63, 0, 17]])
    with pytest.raises(ValueError):
        rowread.rowread_scalar(table, list(range(rowread.SCALAR_BATCH + 1)))
    cursors = torch.tensor([[9, 70, 12], [5, 6, 7], [-4, 3, 2]], dtype=torch.int32)
    assert torch.equal(rowread.rowread_min_batch(table, cursors), table[[9, 5, 0]])
    singles = [rowread.rowread_min(table, c) for c in cursors]
    assert torch.equal(rowread.rowread_min_batch(table, cursors), torch.cat(singles))


H100_SLOTS = 132 * 2048   # SMs times resident threads an SM


@pytest.mark.parametrize("tiles,rays,want", [
    (4096, 256, 1),     # the frame's main walk fills the card alone
    (96, 256, 16),      # the enlarged-K walk: 24,576 rays
    (64, 64, 32),       # the sub-tile walk: 4,096 rays
    (1, 1, 32),
    (2112, 256, 1),     # exactly two fills at G = 1
    (1056, 256, 2),
])
def test_lanes_rule_on_the_frames_walks(tiles, rays, want):
    assert tile_cuda.lanes_per_ray(tiles, rays, H100_SLOTS) == want


def test_lanes_rule_is_a_power_of_two_that_fills_the_card():
    """A pure function of the shape: a power of two up to 32, never more
    threads than FILLS fills of the slots unless one lane a ray already
    takes more, never fewer than half of that unless at 32 lanes, and no
    larger for more rays."""
    last = 64
    for rays in [1, 3, 64, 100, 1000, 4096, 24576, 65536, 10 ** 6, 5 * 10 ** 6]:
        g = tile_cuda.lanes_per_ray(1, rays, H100_SLOTS)
        assert g in tile_cuda.LANES and g <= last
        limit = tile_cuda.FILLS * H100_SLOTS
        assert g == 1 or rays * g <= limit
        assert g == 32 or rays * g * 2 > limit
        assert tile_cuda.lanes_per_ray(1, rays, H100_SLOTS) == g   # pure
        last = g
    for bad in [(0, 256, H100_SLOTS), (4, 0, H100_SLOTS), (4, 256, 0)]:
        with pytest.raises(ValueError):
            tile_cuda.lanes_per_ray(*bad)


def walk_args(T=2, P=8, K=4):
    return (torch.zeros((10, 17), dtype=torch.int32), torch.zeros((T, P, 3)),
            torch.zeros((T, P, 3)), torch.zeros((T, K), dtype=torch.int32),
            torch.zeros((T, K), dtype=torch.int32), torch.zeros((T, K)), 7, 4)


@pytest.mark.parametrize("what", ["lanes", "K", "o", "ids", "depth", "serial P"])
def test_walk_kernels_refuse_bad_arguments(what, monkeypatch):
    """Bad shapes and lane counts raise ValueError before any launch (the
    device check stood in for, so that CPU tensors reach the later ones)."""
    for kernel in (tile_cuda._TILE_WALK, tile_cuda._TILE_WALK_SERIAL):
        monkeypatch.setattr(kernel, "check", lambda device, specs: None)
    args, kw, launch = list(walk_args()), {}, tile_cuda._walk_kernel
    if what == "lanes":
        kw = dict(lanes=3)
    elif what == "K":
        args = list(walk_args(K=tile_cuda.K_LIMIT + 1))
    elif what == "o":
        args[1] = torch.zeros((16, 3))
    elif what == "ids":
        args[4] = torch.zeros((3, 4), dtype=torch.int32)
    elif what == "depth":
        args[6] = 9
    else:
        args, launch = list(walk_args(P=tile_cuda.P_LIMIT + 1)), tile_cuda._walk_serial_kernel
    before = (tile_cuda.launches, tile_cuda.serial_launches)
    with pytest.raises(ValueError):
        launch(*args, **kw)
    assert (tile_cuda.launches, tile_cuda.serial_launches) == before


@pytest.mark.parametrize("which,widths,warps", [
    ("main", (1, 8, 12, 18, 27, 40, 60, 96), 1),         # 480 child slots
    ("wide", (1, 8, 64, 160, 160, 160, 160, 160), 8),    # 1,280
    ("fb2", (1, 8, 32, 64, 128, 160, 160, 160), 8),      # 1,280
])
def test_candidate_warps_on_the_frames_budgets(which, widths, warps):
    """The rule's warps a tile for the depth-10 frame's three phase-1 calls
    (top_depth 7): bench.py's main budgets, the enlarged-K ("wide") and the
    sub-tile ("fb2") budgets of tests/test_torch_candidates.py's
    ``budget``, with the widths ``level_widths`` gives them."""
    from tests.test_torch_candidates import budget

    caps, k_max, _mode = budget(which, 7)
    assert tile_cuda.level_widths(7, caps, k_max) == widths
    assert tile_cuda.candidate_warps(widths) == warps


def test_candidate_warps_bound():
    """One warp a tile up to WARP_SLOTS child slots a level, a block above;
    only the levels above the finest expand."""
    slots = tile_cuda.WARP_SLOTS
    assert tile_cuda.candidate_warps((1, 8, slots // 8, 256)) == 1
    assert tile_cuda.candidate_warps((1, 8, slots // 8 + 1, 256)) == 8
    assert tile_cuda.candidate_warps((1, 2)) == 1
    assert set(tile_cuda.CANDIDATE_WARPS) == {1, 8}


def test_first_forms_take_the_plain_version_on_the_cpu():
    """``tile_walk_serial``, ``trace_cuda_serial`` and ``shade_bwd_serial``
    on CPU tensors are the plain versions, and launch nothing."""
    from raytracingtest_tpu_torch.ops import octree, tile
    from raytracingtest_tpu_torch.scenes import get_scene

    args = walk_args(T=1, P=4, K=2)
    before = (tile_cuda.serial_launches, traverse_cuda.serial_launches)
    got = tile_cuda.tile_walk_serial(*args)
    want = tile.walk_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    svo = octree.build_svo(get_scene("sphere"), 3).svo
    o = np.random.default_rng(0).random((1024, 3), dtype=np.float32) * 0.2 - 0.5
    d = 0.5 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    got = traverse_cuda.trace_cuda_serial(svo, o, d)
    want = traverse_cuda.trace_cuda(svo, o, d)
    assert all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("hit_leaf", "hit_t", "hit_parent", "hit_child", "iters"))
    assert int((got.hit_leaf >= 0).sum()) > 0
    assert (tile_cuda.serial_launches, traverse_cuda.serial_launches) == before
    hit_leaf = got.hit_leaf
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (1024, 3)).astype(np.float32))
    args = (g, hit_leaf, d, svo.leaf_albedo, svo.leaf_normal, svo.leaf_density,
            torch.tensor([-0.5, -1.0, -0.3]), 1.3, 0.08)
    before = dict(shade_cuda.launches)
    got = shade_cuda.shade_bwd_serial(*args)
    assert torch.equal(got, shade_cuda.shade_bwd_plain(*args))
    assert torch.equal(got, shade_cuda.shade_bwd(*args))
    assert bool(got[hit_leaf >= 0].any()) and not bool(got[hit_leaf < 0].any())
    assert shade_cuda.launches == before


def small_trees():
    """A depth-4 sphere SVO and its brick SVO (top depth 1), and 256 rays
    from a shell aimed at the centre, made with numpy from a seed."""
    from raytracingtest_tpu_torch.ops import octree
    from raytracingtest_tpu_torch.scenes import get_scene

    svo = octree.build_svo(get_scene("sphere"), 4).svo
    rng = np.random.default_rng(9)
    v = rng.normal(size=(256, 3))
    o = 0.5 + 2.0 * v / np.linalg.norm(v, axis=1, keepdims=True)
    d = 0.5 + rng.normal(0, 0.3, (256, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (svo, brick.make_brick_svo(svo), torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def brick_counts():
    return tuple(dict(c) for c in (brick_cuda.launches, brick_cuda.form_launches,
                                   brick_cuda.probe_launches))


def test_brick_first_forms_take_the_plain_version_on_the_cpu():
    """``trace_brick_cuda_serial`` and ``trace_stackless_cuda`` (whose one
    form is the first) on CPU tensors are ``brick.trace_brick`` and
    ``traverse.trace_stackless``, statistics included, and launch
    nothing."""
    svo, bsvo, o, d = small_trees()
    before = brick_counts()
    fields = ("hit_leaf", "hit_t", "hit_parent", "hit_child", "iters")
    for got, want in (
            (brick_cuda.trace_brick_cuda_serial(bsvo, o, d, with_stats=True),
             brick.trace_brick(bsvo, o, d, True)),
            (brick_cuda.trace_stackless_cuda(svo, o, d, with_stats=True),
             traverse.trace_stackless(svo, o, d, True))):
        assert all(torch.equal(getattr(got[0], f), getattr(want[0], f)) for f in fields)
        assert torch.equal(got[1], want[1])
        assert int((got[0].hit_leaf >= 0).sum()) > 0
    plain = brick_cuda.trace_brick_cuda_serial(bsvo, o, d)
    assert torch.equal(plain.hit_leaf, brick_cuda.trace_brick_cuda(bsvo, o, d).hit_leaf)
    assert brick_counts() == before


@pytest.mark.parametrize("call", [
    lambda svo, bsvo, o, d: brick_cuda._brick_kernel(bsvo, o, d),
    lambda svo, bsvo, o, d: brick_cuda._brick_serial_kernel(bsvo, o, d),
    lambda svo, bsvo, o, d: brick_cuda._brick_unstaged_kernel(bsvo, o, d),
    lambda svo, bsvo, o, d: brick_cuda.probe_brick_cuda(bsvo, o, d, "wide"),
    lambda svo, bsvo, o, d: brick_cuda.probe_brick_cuda(bsvo, o, d, "first"),
    lambda svo, bsvo, o, d: brick_cuda._stackless_kernel(svo, o, d),
    lambda svo, bsvo, o, d: brick_cuda.probe_stackless_cuda(svo, o, d),
], ids=["brick", "brick serial", "brick unstaged", "brick probe",
        "brick first probe", "stackless", "stackless probe"])
def test_brick_kernels_refuse_cpu_tensors_before_any_library(call):
    """Every form's launcher refuses CPU tensors by the kernel's name, asks
    ``_build`` for no library and counts no launch."""
    svo, bsvo, o, d = small_trees()
    before, loaded = brick_counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        call(svo, bsvo, o, d)
    assert brick_counts() == before and set(_build._libs) == loaded


@pytest.mark.parametrize("what", ["brick form", "depth", "stackless depth",
                                  "rays"])
def test_brick_kernels_refuse_bad_arguments(what, monkeypatch):
    """A form the brick trace does not have, trees whose depths are out of
    range and rays that are not (N, 3) raise ValueError before any launch
    (the device check stood in for, so that CPU tensors reach the later
    ones)."""
    for kernel in (brick_cuda._BRICK_TRACE_PROBE, brick_cuda._ESVO_STACKLESS,
                   brick_cuda._BRICK_TRACE):
        monkeypatch.setattr(kernel, "check", lambda device, specs: None)
    svo, bsvo, o, d = small_trees()
    calls = {
        "brick form": lambda: brick_cuda.probe_brick_cuda(bsvo, o, d, "serial"),
        "depth": lambda: brick_cuda._brick_kernel(
            brick.BrickSVO(bsvo.top_masks, bsvo.top_child, bsvo.top_parent,
                           bsvo.bricks, bsvo.depth + 1, bsvo.top_depth), o, d),
        "stackless depth": lambda: brick_cuda._stackless_kernel(
            dataclasses.replace(svo, depth=23), o, d),
        "rays": lambda: brick_cuda._brick_kernel(bsvo, o.reshape(-1), d),
    }
    before = brick_counts()
    with pytest.raises(ValueError):
        calls[what]()
    assert brick_counts() == before


@pytest.mark.parametrize("n,form,want", [
    (1024 * 1024, "first", 1024 * 1024 // 32), (1024 * 1024, "wide", 1024 * 1024 // 32),
    (1024 * 1024, "unstaged", 1024 * 1024 // 32), (1000, "first", 8 * 4),
    (1000, "wide", 4 * 8), (129, "first", 2 * 4), (129, "wide", 1 * 8),
    (0, "wide", 0), (1000, "staged", 32), (129, "staged", 5),
])
def test_probe_record_rows_are_the_launch_warps(n, form, want):
    """A probe record has a row for each warp of the form's launch: blocks
    of 128 threads for the first form, of 256 for the wide forms, of 32 for
    brick_trace_multi's staged form, the last block's idle warps included."""
    kernel = "brick_trace_multi" if form == "staged" else "brick_trace"
    assert brick_cuda.warps_of(n, kernel, form) == want
    assert len(brick_cuda.PROBE_FIELDS) == 21


@pytest.mark.parametrize("n,form", [(10, "serial"), (10, "refill"), (-1, "first")])
def test_probe_record_refuses_a_form_or_count_it_lacks(n, form):
    with pytest.raises(ValueError):
        brick_cuda.warps_of(n, "brick_trace", form)
