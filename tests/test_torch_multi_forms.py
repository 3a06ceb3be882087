"""The k-segment traces' forms as far as they run without a card: the
brick trace's rule for its staged form (and the k at which it turns to the
first form), a numpy model of the staged form's write-out, the C entry
points and their declared arguments, the wrappers' checks, the first
form's wrapper on the CPU, and the probe record's segment phase.

The kernels themselves run only on the card: ``chip_smoke.py`` holds every
form bitwise against the plain versions there. Inputs come from numpy
seeds; the trees are a few levels deep."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import brick, brick_cuda, octree, traverse
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SOURCE = _build._CSRC + "/brick_trace.cu"


def source_constants():
    """brick_trace.cu's integer constexprs, by name (one defined from
    another is evaluated)."""
    found = {}
    for name, expr in re.findall(r"\b([A-Z][A-Z0-9_]+) = ([^,;]+)[,;]", open(SOURCE).read()):
        try:
            found[name] = int(eval(expr, {}, dict(found)))
        except (NameError, SyntaxError, TypeError):
            pass
    return found


def staged_bytes(c, k):
    """A staged block's shared memory at k, as the source lays it out:
    MULTI_BLOCK rays of brick_multi_words(k) 4-byte words."""
    words = re.search(r"brick_multi_words\(int k\) \{\s*return ([^;]+);",
                      open(SOURCE).read()).group(1)
    return 4 * c["MULTI_BLOCK"] * eval(words, {}, dict(c, k=k))


@pytest.mark.parametrize("k,staged", [(1, True), (4, True), (117, True), (118, True),
                                      (594, True), (595, False), (2000, False)])
def test_multi_block_rule(k, staged):
    """The main path takes the staged form up to STAGED_MAX_K and the first
    form above, and the staged form takes k exactly where its block's slots
    fit in SMEM_MAX bytes, as the source lays them out."""
    c = source_constants()
    assert (k <= brick_cuda.STAGED_MAX_K) == staged
    assert (staged_bytes(c, k) <= c["SMEM_MAX"]) == staged


def test_multi_block_rule_fits_and_switches_once():
    """STAGED_MAX_K, the staged form's block and its shared memory follow
    the source's constants: blocks of MULTI_BLOCK threads, the slots past
    SMEM_STATIC from k = 118 (the launch opts in to more), past SMEM_MAX
    from k = 595, and the staged row long enough for the statistics that
    the write-out stages over it."""
    c = source_constants()
    assert brick_cuda.BLOCKS[("brick_trace_multi", "staged")] == c["MULTI_BLOCK"] == 32
    fits = [k for k in range(1, 800) if staged_bytes(c, k) <= c["SMEM_MAX"]]
    assert fits == list(range(1, brick_cuda.STAGED_MAX_K + 1))
    assert min(k for k in fits if staged_bytes(c, k) > c["SMEM_STATIC"]) == 118
    assert c["PREFIX_ROW_WORDS"] == c["ROW_WORDS"] + 16 == 33
    assert c["PREFIX_ROW_WORDS"] >= c["N_STATS"] == len(traverse.STAT_NAMES)


def staged_write_out(segs, stats, k, block, row_words, n_stats=5):
    """The staged form's shared memory and write-out for every block of a
    launch, as csrc/brick_trace.cu's brick_trace_multi_staged_kernel and
    write_warp do it: each warp's region holds its 32 rays' staged rows
    (row_words words a lane), then their k leaves, t_in and t_out (32k
    words each; lane l's slot s at l * k + s), padded (-1, 0, 0) at set-up
    and filled in slot order by the lanes that have a ray. The warp's rays
    [w0, w0 + nw), nw = min(32, n - w0) (below 32 in the ragged last warp,
    at most 0 in a warp past the last ray), own words [w0 k, (w0 + nw) k)
    of each (N, k) array, written by lane j % 32 at word w0 k + j; count
    and iters a word a lane below nw; the statistics staged over the rows
    (lane l's at l * n_stats) and written as the run [w0 n_stats, (w0 + nw)
    n_stats). Returns the arrays (unwritten words hold 7777 or NaN) and the
    words each array received."""
    n = len(segs)
    out = {"hit_leaf": np.full(n * k, 7777, np.int32),
           "t_in": np.full(n * k, np.nan, np.float32),
           "t_out": np.full(n * k, np.nan, np.float32),
           "count": np.full(n, 7777, np.int32),
           "stats": np.full(n * n_stats, 7777, np.int32)}
    written = {name: np.zeros(a.size, np.int64) for name, a in out.items()}
    region = 32 * (row_words + 3 * k)
    for b0 in range(0, n, block):
        smem = np.zeros(block // 32 * region, np.int32)
        for warp in range(block // 32):
            w0 = b0 + 32 * warp
            reg = smem[warp * region:(warp + 1) * region]
            rows = reg[:32 * row_words]
            s_leaf = reg[32 * row_words:32 * row_words + 32 * k]
            s_tin = reg[32 * row_words + 32 * k:32 * row_words + 64 * k].view(np.float32)
            s_tout = reg[32 * row_words + 64 * k:].view(np.float32)
            s_leaf[:], s_tin[:], s_tout[:] = -1, 0.0, 0.0
            for lane in range(32):
                i = w0 + lane
                rows[lane * row_words:(lane + 1) * row_words] = 12345  # the walk's rows
                if i < n:
                    for slot, (leaf, t_in, t_out) in enumerate(segs[i]):
                        s_leaf[lane * k + slot] = leaf
                        s_tin[lane * k + slot], s_tout[lane * k + slot] = t_in, t_out
            nw = min(32, n - w0)
            for lane in range(32):
                for j in range(lane, nw * k, 32):
                    for name, src in (("hit_leaf", s_leaf), ("t_in", s_tin), ("t_out", s_tout)):
                        out[name][w0 * k + j] = src[j]
                        written[name][w0 * k + j] += 1
                if lane < nw:
                    out["count"][w0 + lane] = len(segs[w0 + lane])
                    written["count"][w0 + lane] += 1
            for lane in range(32):   # after every slot is read
                rows[lane * n_stats:(lane + 1) * n_stats] = (
                    stats[w0 + lane] if w0 + lane < n else 0)
            for lane in range(32):
                for j in range(lane, nw * n_stats, 32):
                    out["stats"][w0 * n_stats + j] = rows[j]
                    written["stats"][w0 * n_stats + j] += 1
    return {name: a.reshape(n, -1) for name, a in out.items()}, written


def slot_by_slot(segs, stats, k):
    """The first form's writes: each segment to its (N, k) slot as it is
    found, then the empty slots padded, the count, and the statistics a ray
    at a time."""
    n = len(segs)
    hit_leaf = np.empty((n, k), np.int32)
    t_in = np.empty((n, k), np.float32)
    t_out = np.empty((n, k), np.float32)
    for i, ray in enumerate(segs):
        for slot, (leaf, a, b) in enumerate(ray):
            hit_leaf[i, slot], t_in[i, slot], t_out[i, slot] = leaf, a, b
        for slot in range(len(ray), k):
            hit_leaf[i, slot], t_in[i, slot], t_out[i, slot] = -1, 0.0, 0.0
    return {"hit_leaf": hit_leaf, "t_in": t_in, "t_out": t_out,
            "count": np.array([len(r) for r in segs], np.int32)[:, None],
            "stats": np.asarray(stats, np.int32)}


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_staged_write_out_equals_slot_by_slot(k, block):
    """Ragged per-lane segment lists (0 to k segments a ray) staged and
    written out warp by warp as the staged form does, in blocks of 32 (the
    launch's) and of 128 (whose last block has a warp past the last ray),
    with a ragged last warp, equal the (N, k) arrays written slot by slot,
    every word written once; the statistics, staged over the rows, too."""
    row_words = source_constants()["PREFIX_ROW_WORDS"]
    rng = np.random.default_rng(k)
    n = 2 * 128 + 37          # a ragged last warp; at 128, a last block of 2 warps
    segs = []
    for _ in range(n):
        count = int(rng.integers(0, k + 1))
        t = np.sort(rng.random(2 * count).astype(np.float32))
        segs.append([(int(rng.integers(0, 10_000)), t[2 * s], t[2 * s + 1])
                     for s in range(count)])
    stats = rng.integers(0, 50, (n, 5)).astype(np.int32)
    got, written = staged_write_out(segs, stats, k, block, row_words)
    want = slot_by_slot(segs, stats, k)
    assert n % 32 and (block == 32 or n % block < block - 32)
    for name in want:
        np.testing.assert_array_equal(got[name].view(np.int32), want[name].view(np.int32))
        assert (written[name] == 1).all(), name


def c_entry_arity():
    """Each C entry point of brick_trace.cu and its number of arguments."""
    src = open(SOURCE).read()
    arity = {}
    for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S):
        arity[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return arity


class _Declared:
    """Stands in for the loaded library: records what _declare_brick sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        fn = self.fns.setdefault(name, type("Fn", (), {})())
        return fn


def test_c_entries_are_declared_with_their_arity():
    """Every C entry point of brick_trace.cu (the k-segment traces' first
    form and probe forms among them, the streamed world's stitched traces,
    the level-sharded rounds' queued, first and probe forms and their
    queue in one pass and its first form) has ctypes argument types of its
    own length, the stream included, and a wrapper's Kernel."""
    arity = c_entry_arity()
    new = {"esvo_stackless_multi_probe", "brick_trace_multi_serial",
           "brick_trace_multi_probe", "clipmap_trace", "clipmap_trace_brick",
           "level_round", "level_round_serial", "level_round_probe", "level_queue",
           "clipmap_trace_brick_serial", "clipmap_trace_brick_probe",
           "clipmap_trace_serial", "clipmap_trace_probe", "level_queue_serial",
           "esvo_stackless_serial", "esvo_stackless_lod_serial",
           "esvo_stackless_multi_serial", "brick_trace_lod_serial",
           "brick_trace_lod_probe"}
    assert new <= set(arity) and len(arity) == 29
    lib = _Declared()
    _build._declare_brick(lib)
    assert set(lib.fns) == set(arity)
    for name, n_args in arity.items():
        assert len(lib.fns[name].argtypes) == n_args, name
    kernels = {v.name for v in vars(brick_cuda).values()
               if isinstance(v, brick_cuda.Kernel)}
    assert set(arity) <= kernels
    # both brick forms take the same arguments; a probe form adds its record
    # (and the brick probe its form)
    assert arity["brick_trace_multi"] == arity["brick_trace_multi_serial"]
    # a stackless trace's patched form takes the row table for the four
    # arrays (the LOD form keeps the arrays), and the width and the block;
    # its probe takes both forms' arguments, its form and the record
    for kname in ("esvo_stackless", "esvo_stackless_multi"):
        assert arity[kname] == arity[kname + "_serial"] - 3 + 2
    assert arity["esvo_stackless_lod"] == arity["esvo_stackless_lod_serial"] + 2
    # the LOD brick trace's patched form adds the width and the block to its
    # first form's arguments; its probe adds its form and the record
    assert arity["brick_trace_lod"] == arity["brick_trace_lod_serial"] + 2
    assert arity["brick_trace_lod_probe"] == arity["brick_trace_lod"] + 2
    assert arity["esvo_stackless_multi_probe"] == arity["esvo_stackless_multi_serial"] + 5
    assert arity["esvo_stackless_probe"] == arity["esvo_stackless_serial"] + 5
    assert arity["brick_trace_multi_probe"] == arity["brick_trace_multi"] + 2
    # the stitched traces differ only in the arena their chunk walks read
    assert arity["clipmap_trace"] == arity["clipmap_trace_brick"]
    # each stitched trace's first form takes its wide form's arguments; its
    # probe adds the form and the record
    for kname in ("clipmap_trace", "clipmap_trace_brick"):
        assert arity[kname + "_serial"] == arity[kname]
        assert arity[kname + "_probe"] == arity[kname] + 2
    # the queue's first form takes no packets, their segment, status words
    # nor device count, but the counts and their scan
    assert arity["level_queue_serial"] == arity["level_queue"] - 2
    # level_round's queued form adds its queue (the queue, the live count,
    # the segments, their length, the grid's bound) to the first form's
    # arguments; the probe form adds its record
    assert arity["level_round"] == arity["level_round_serial"] + 5
    assert arity["level_round_probe"] == arity["level_round_serial"] + 1


def small_trees():
    svo = octree.build_svo(get_scene("sphere"), 4).svo
    rng = np.random.default_rng(5)
    v = rng.normal(size=(200, 3))
    o = 0.5 + 2.0 * v / np.linalg.norm(v, axis=1, keepdims=True)
    d = 0.5 + rng.normal(0, 0.3, (200, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (svo, brick.make_brick_svo(svo), torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def counts():
    return tuple(dict(c) for c in (brick_cuda.launches, brick_cuda.form_launches,
                                   brick_cuda.probe_launches))


LAUNCHERS = {
    "staged brick": lambda svo, bsvo, o, d, k: brick_cuda._brick_multi_kernel(bsvo, o, d, k),
    "first stackless": lambda svo, bsvo, o, d, k: brick_cuda._stackless_multi_kernel(
        svo, o, d, k),
    "first brick": lambda svo, bsvo, o, d, k: brick_cuda._brick_multi_serial_kernel(
        bsvo, o, d, k),
    "probe stackless": lambda svo, bsvo, o, d, k: brick_cuda.probe_stackless_multi_cuda(
        svo, o, d, k),
    "probe brick first": lambda svo, bsvo, o, d, k: brick_cuda.probe_brick_multi_cuda(
        bsvo, o, d, k, "first"),
    "probe brick staged": lambda svo, bsvo, o, d, k: brick_cuda.probe_brick_multi_cuda(
        bsvo, o, d, k, "staged"),
}


@pytest.mark.parametrize("which", sorted(LAUNCHERS))
def test_multi_launchers_refuse_cpu_tensors_and_k_below_one(which, monkeypatch):
    """CPU tensors are refused by the kernel's name before any library; with
    the device check stood in, k < 1 raises ValueError; neither counts a
    launch."""
    svo, bsvo, o, d = small_trees()
    before, loaded = counts(), set(_build._libs)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        LAUNCHERS[which](svo, bsvo, o, d, 4)
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
    with pytest.raises(ValueError):
        LAUNCHERS[which](svo, bsvo, o, d, 0)
    assert counts() == before and set(_build._libs) == loaded


def test_probe_forms_refuse_a_form_they_lack(monkeypatch):
    """The brick probe takes its two forms, the staged one up to
    STAGED_MAX_K."""
    monkeypatch.setattr(brick_cuda._BRICK_TRACE_MULTI_PROBE, "check",
                        lambda device, specs: None)
    _svo, bsvo, o, d = small_trees()
    before = counts()
    for call in (lambda: brick_cuda.probe_brick_multi_cuda(bsvo, o, d, 4, "wide"),
                 lambda: brick_cuda.probe_brick_multi_cuda(bsvo, o, d, 4, "unstaged"),
                 lambda: brick_cuda.probe_brick_multi_cuda(bsvo, o, d, 595, "staged")):
        with pytest.raises(ValueError):
            call()
    assert counts() == before


def test_forms_off_the_main_path_take_the_plain_version_on_the_cpu():
    """``trace_brick_multi_cuda_serial``, like the main paths' wrappers, on
    CPU tensors is the plain version, statistics included, and launches
    nothing."""
    svo, bsvo, o, d = small_trees()
    before = counts()
    for got, want in (
            (brick_cuda.trace_brick_multi_cuda_serial(bsvo, o, d, 3, with_stats=True),
             brick.trace_brick_multi(bsvo, o, d, 3, True)),
            (brick_cuda.trace_brick_multi_cuda(bsvo, o, d, 3, with_stats=True),
             brick.trace_brick_multi(bsvo, o, d, 3, True)),
            (brick_cuda.trace_multi_cuda(svo, o, d, 3, with_stats=True),
             traverse.trace_multi(svo, o, d, 3, True))):
        for a, b in zip(dataclasses.astuple(got[0]) + (got[1],),
                        dataclasses.astuple(want[0]) + (want[1],)):
            assert torch.equal(a, b)
        assert int(got[0].count.sum()) > 0
    assert counts() == before


def probe_constants():
    src = open(SOURCE).read()
    return {name: int(v) for name, v in re.findall(r"\b(P[WH]_\w+|N_PHASES|PROBE_WORDS) = (\d+)",
                                                   src)}


def test_probe_record_layout_has_the_segment_phase():
    """PROBE_FIELDS names the kernels' record word for word: five phases,
    the segment phase last, then the SM and the global timer."""
    c = probe_constants()
    fields = brick_cuda.PROBE_FIELDS
    assert len(fields) == c["PROBE_WORDS"] == 21
    assert c["N_PHASES"] == len(brick_cuda.PHASES) == 5
    assert brick_cuda.PHASES.index("seg") == c["PH_SEG"]
    base = c["PW_PHASES"] + 3 * c["PH_SEG"]
    assert fields[base:base + 3] == ("seg_issues", "seg_lanes", "seg_cycles")
    assert fields.index("sm") == c["PW_SM"]
    assert fields.index("ns_start") == c["PW_NS_START"]
    assert fields.index("ns_end") == c["PW_NS_END"]


def test_warps_line_reads_the_segment_phase(capsys):
    """chip_smoke's [warps] reader on a made-up record of four blocks of the
    staged form (32 threads each): the segment phase's issues a warp, SIMT
    efficiency and cycle share come out of their words."""
    import chip_smoke

    fields = brick_cuda.PROBE_FIELDS
    warps = 4
    rec = np.zeros((warps, len(fields)), np.int64)
    col = {f: i for i, f in enumerate(fields)}
    rec[:, col["start"]], rec[:, col["end"]] = 0, 1000
    rec[:, col["ns_start"]] = [0, 10, 20, 30]
    rec[:, col["ns_end"]] = [1000, 2000, 3000, 9000]
    rec[:, col["step_issues"]], rec[:, col["step_lanes"]] = 10, 320
    rec[:, col["step_cycles"]] = 600
    rec[:, col["seg_issues"]], rec[:, col["seg_lanes"]] = 4, 32
    rec[:, col["seg_cycles"]] = 100
    got = chip_smoke.warps_line("brick_trace_multi", "staged", torch.from_numpy(rec),
                                np.arange(warps * 32))
    seg = got["phases"]["seg"]
    assert seg["issues_a_warp"] == 4 and seg["simt"] == 32 / (32 * 4)
    assert seg["cycle_share"] == pytest.approx(0.1)
    assert got["phases"]["step"]["simt"] == 1.0
    assert "32-thread blocks" in capsys.readouterr().out


def test_prefix_row_leaf_equals_the_plain_lookup():
    """The staged brick trace's leaf id from its row's prefix counts (the
    first leaf plus the set bits of the words below word w, staged beside
    the row at its descent; then one popcount below the voxel's bit) equals
    the plain version's ``brick._leaf_in_brick`` on random rows, words with
    bit 31 set among them, at every one of a brick's 512 voxels."""
    rng = np.random.default_rng(12)
    n = 64
    words = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)
    words[::5] |= np.uint32(0x80000000)
    words[::7] = 0xFFFFFFFF
    bleaf = rng.integers(0, 2 ** 30, n).astype(np.int32)
    popc = np.array([[bin(int(w)).count("1") for w in row] for row in words])
    prefix = bleaf[:, None] + np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(popc, axis=1)[:, :-1]], axis=1)
    idx9 = np.tile(np.arange(512, dtype=np.int32), (n, 1))
    wsel = idx9 >> 5
    below = np.take_along_axis(words, wsel, axis=1).astype(np.uint64) & (
        (np.uint64(1) << (idx9 & 31).astype(np.uint64)) - np.uint64(1))
    got = np.take_along_axis(prefix, wsel, axis=1) + np.vectorize(
        lambda v: bin(int(v)).count("1"))(below)
    want = brick._leaf_in_brick(
        torch.from_numpy(np.repeat(words.view(np.int32), 512, axis=0)),
        torch.from_numpy(np.repeat(bleaf, 512)),
        torch.from_numpy(idx9.reshape(-1)))
    np.testing.assert_array_equal(got.reshape(-1), want.numpy())


@pytest.mark.parametrize("call,k,entry", [
    ("brick", 4, "brick_trace_multi"), ("brick", 594, "brick_trace_multi"),
    ("brick", 595, "brick_trace_multi_serial"),
    ("stackless", 4, "esvo_stackless_multi"),
    ("stackless", 595, "esvo_stackless_multi"),
])
def test_main_paths_launch_the_rules_form(call, k, entry, monkeypatch):
    """With the C functions stood in: the brick trace's main path launches
    its staged form up to STAGED_MAX_K and its first form above; the
    stackless trace's main path its patched form at every k; each passes k
    and counts the kernel it launched."""
    launched = []
    for kernel in vars(brick_cuda).values():
        if isinstance(kernel, brick_cuda.Kernel):
            monkeypatch.setattr(kernel, "check", lambda device, specs: None)
            monkeypatch.setattr(kernel, "_fn", lambda *a, _n=kernel.name: launched.append(
                (_n, a)) or 0)
            monkeypatch.setattr(kernel, "_raw_stream", lambda index: 0)
            monkeypatch.setattr(kernel, "_current_device", lambda: None)
    svo, bsvo, o, d = small_trees()
    before = counts()
    {"brick": lambda: brick_cuda._brick_multi_kernel(bsvo, o, d, k),
     "stackless": lambda: brick_cuda._stackless_multi_kernel(svo, o, d, k)}[call]()
    (name, args), = launched
    assert name == entry
    assert args[-8] == k     # (..., k, six outputs, the stream)
    after = counts()
    changed = {key for b, a in zip(before, after) for key in a if a[key] != b[key]}
    assert changed == {entry}
