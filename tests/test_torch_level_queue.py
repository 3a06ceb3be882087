"""The queued form of kernel ``level_round`` (parallel/level_sharded.py,
ops/brick_cuda.py) on the CPU: plain models of its queue's passes against
the queue they must give, the queued round against the unqueued plain
version round by round, and the level-sharded loops with queued rounds
against the unqueued loops and the JAX package at 1, 2 and 4 ranks (worlds
of spawned gloo ranks, ``tests/torch_ranks.py``), rounds and per-rank
traced counts included. Tolerances: leaves, owners, truncation, rounds and
traced exactly, and the queued loops' t bit for bit against the unqueued
ones; t against the reference to rtol 1e-5 / atol 1e-6 (F14).
"""

import inspect
import re

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import brick_cuda, camera
from raytracingtest_tpu_torch.ops.octree import build_svo
from raytracingtest_tpu_torch.parallel import level_sharded
from raytracingtest_tpu_torch.parallel.mesh import make_mesh
from raytracingtest_tpu_torch.scenes import get_scene
from tests import torch_ranks
from tests.test_torch_level_sharded import (
    HOT, RAYS, assert_trace_equal, ref_exchange, ref_trace)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)
QBLOCK = brick_cuda.QBLOCK
SOURCE = f"{_build._CSRC}/brick_trace.cu"
HOT_ROUNDS = 80


def place_model(done):
    """The count and place passes in numpy: each block of QBLOCK rays' live
    count, their exclusive scan, and each live ray's place from its warp's
    ballot, the warps below it and the block's base."""
    n = done.shape[0]
    live = np.zeros(-(-n // QBLOCK) * QBLOCK, bool)
    live[:n] = ~done
    blocks = live.reshape(-1, QBLOCK)
    base = np.concatenate([[0], np.cumsum(blocks.sum(1))[:-1]])
    queue = np.full(int(live.sum()), -1, np.int64)
    for b, row in enumerate(blocks):
        warps = row.reshape(-1, 32)
        totals = warps.sum(1)
        for w, lanes in enumerate(warps):
            ballot = sum(1 << lane for lane in range(32) if lanes[lane])
            for lane in np.flatnonzero(lanes):
                below = bin(ballot & ((1 << lane) - 1)).count("1")
                queue[base[b] + below + totals[:w].sum()] = b * QBLOCK + w * 32 + lane
    return queue


def lookback_model(done, prev=None, seed=0, block=QBLOCK, items=16, look=1):
    """level_queue_lookback_kernel in numpy, with its tile's shape (`block`
    threads of `items` entries each, `look` status words a lane of the
    look-back reads at a time) as parameters: the entries (every ray, or the
    last round's queue `prev`) in tiles; warp w of a tile holds entries w *
    32 items + 32 k + lane; each tile publishes its aggregate (tile 0 its
    inclusive prefix) in a status word tagged with the launch's epoch, over
    words an earlier launch left, looks back window by window (lane l reads
    the words hi - look l - j), and places its live rays from its
    exclusive prefix, its warp's first place and the ballots. The tiles run
    their steps in a seeded random order; a look-back that meets an
    unpublished word waits. Returns (queue, n_live)."""
    rng = np.random.default_rng(seed)
    entries = np.arange(done.shape[0]) if prev is None else np.asarray(prev)
    m = entries.shape[0]
    tile_n, warp_n = block * items, 32 * items
    tiles = -(-m // tile_n)
    if tiles == 0:
        return np.zeros(0, np.int64), 0
    epoch = 5
    # (epoch, flag, value): an earlier launch's words, some of them prefixes
    words = [(epoch - 1, int(rng.integers(0, 3)), int(rng.integers(0, 1 << 20)))
             for _ in range(tiles)]
    ballots, counts = [], []
    for t in range(tiles):
        local = np.arange(tile_n).reshape(block // 32, items, 32)
        e = t * tile_n + local
        ray = np.where(e < m, entries[np.minimum(e, m - 1)], -1)
        live = (ray >= 0) & ~done[np.maximum(ray, 0)]
        ballots.append((ray, live))
        counts.append(live.sum(axis=(1, 2)))
    state = ["start"] * tiles
    progress = [None] * tiles  # (hi, exclusive) of a tile looking back
    base = [0] * tiles
    n_live = None
    while any(st != "done" for st in state):
        t = int(rng.choice([k for k in range(tiles) if state[k] != "done"]))
        agg = int(counts[t].sum())
        if state[t] == "start":
            words[t] = (epoch, 2 if t == 0 else 1, agg)
            state[t] = "done" if t == 0 else "looking"
            progress[t] = (t - 1, 0)
            continue
        hi, excl = progress[t]
        window = [[hi - look * lane - j for j in range(look)] for lane in range(32)]
        read = [[(2, 0) if p < 0 else (words[p][1] if words[p][0] == epoch else 0,
                                       words[p][2]) for p in lane] for lane in window]
        if any(f == 0 for lane in read for f, _ in lane):
            continue  # a word not yet published: the warp spins
        sums, found = [], []
        for lane in read:
            acc, hit = 0, False
            for f, v in lane:
                if not hit:
                    acc += v
                hit = hit or f == 2
            sums.append(acc)
            found.append(hit)
        stop = found.index(True) if any(found) else 31
        excl += sum(sums[:stop + 1])
        if any(found):
            words[t] = (epoch, 2, excl + agg)
            base[t], state[t] = excl, "done"
        else:
            progress[t] = (hi - 32 * look, excl)
    base[0] = 0
    queue = np.full(tile_n * tiles, -1, np.int64)
    for t in range(tiles):
        ray, live = ballots[t]
        warp_first = base[t] + np.concatenate([[0], np.cumsum(counts[t])[:-1]])
        for w in range(block // 32):
            pos = int(warp_first[w])
            for k in range(items):
                ballot = sum(1 << lane for lane in range(32) if live[w, k, lane])
                for lane in np.flatnonzero(live[w, k]):
                    queue[pos + bin(ballot & ((1 << lane) - 1)).count("1")] = ray[w, k, lane]
                pos += bin(ballot).count("1")
        if t == tiles - 1:
            n_live = base[t] + int(counts[t].sum())
    return queue[:n_live], n_live


def segment_search_model(valid, seg):
    """level_queue_packets_kernel's search in numpy: each segment's count of
    leading valid slots, QBLOCK samples a step."""
    counts = []
    for s in range(valid.shape[0] // seg):
        flags = valid[s * seg:(s + 1) * seg]
        a, b = 0, seg
        while a < b:
            step = (b - a + QBLOCK - 1) // QBLOCK
            xs = [a + t * step for t in range(QBLOCK)]
            cnt = sum(1 for x in xs if x < b and flags[x])
            samples = (b - a + step - 1) // step
            if cnt == 0:
                b = a
            else:
                a, b = a + (cnt - 1) * step + 1, (a + cnt * step if cnt < samples else b)
        counts.append(a)
    return np.asarray(counts, np.int64)


def queued_slots_model(counts, seg, grid_n):
    """level_round_queued_kernel's packets mode: thread j's slot, counting
    the segments' valid slots in order; threads past them take none."""
    out = []
    for j in range(grid_n):
        base = 0
        for s, c in enumerate(counts):
            if j < base + c:
                out.append(s * seg + j - base)
                break
            base += c
    return np.asarray(out, np.int64)


# the look-back model at the kernel's tile and at a small one (tiles of 128
# entries; a window of 32 words, and of 64 in two words a lane), so that the
# sizes below span many tiles and windows
SMALL_TILE = dict(block=64, items=2, look=1)
SMALL_WIDE = dict(block=64, items=2, look=2)


@pytest.mark.parametrize("model,over", [("place", "rays"), ("lookback", "rays"),
                                        ("lookback", "queue"), ("small", "rays"),
                                        ("small", "queue")])
@pytest.mark.parametrize("n,p", [(1, 0.5), (255, 0.3), (256, 1.0), (257, 0.0),
                                 (5000, 0.1), (5000, 0.9)])
def test_place_pass_is_the_stable_compaction(n, p, model, over):
    """The first form's count and place passes' model, and the one pass's
    look-back model with its tiles finishing in seeded random orders (at
    the kernel's tile and at a small one), give the rays not done in order,
    which ``level_queue_plain`` gives too: over every ray, and over a
    previous round's queue (the look-back models)."""
    rng = np.random.default_rng(n)
    done = rng.random(n) >= p
    prev = None
    if over == "queue":  # a previous round's queue: about half the rays, in order
        prev = np.flatnonzero(rng.random(n) < 0.5 + 0.5 * (done.mean() < 0.5))
        if prev.shape[0] == 0:
            prev = np.arange(n)
    want = np.flatnonzero(~done) if prev is None else prev[~done[prev]]
    if model == "place":
        queue = place_model(done)
    else:
        for seed in range(3):
            queue, count = lookback_model(done, prev, seed=seed,
                                          **(SMALL_TILE if model == "small" else {}))
            assert count == want.shape[0]
            np.testing.assert_array_equal(queue, want)
    np.testing.assert_array_equal(queue, want)
    np.testing.assert_array_equal(
        level_sharded.level_queue_plain(
            "sharded", None, torch.from_numpy(done),
            prev=None if prev is None else torch.from_numpy(prev)).numpy(),
        queue)


def test_lookback_model_matches_the_source():
    """The look-back model's tile shape and status word are the kernel's:
    QITEMS entries a thread in blocks of QBLOCK, one word a lane, and a
    word's epoch, flag and value where q_publish puts them."""
    src = open(SOURCE).read()
    consts = {k: int(v) for k, v in re.findall(r"\b(Q\w+) = (\d+)", src)}
    params = inspect.signature(lookback_model).parameters
    assert consts["QBLOCK"] == params["block"].default == brick_cuda.QBLOCK
    assert consts["QITEMS"] == params["items"].default
    assert params["look"].default == 1
    assert "for (int hi = tile - 1; tile > 0; hi -= 32) {" in src
    assert "const int p = hi - lane;" in src
    assert brick_cuda.QTILE == consts["QBLOCK"] * consts["QITEMS"]
    assert "((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value" in src
    assert "Q_AGGREGATE = 1, Q_PREFIX = 2" in src
    assert "first = (long long)tile * QTILE + warp * QWARP + lane;" in src
    assert "const long long e = first + 32 * k;" in src


def test_one_pass_over_many_tiles():
    """The small tile's look-back model over 20,000 rays (157 tiles, five
    windows of one word a lane, three of two) and over a queue of them, in
    five seeded orders."""
    rng = np.random.default_rng(7)
    done = rng.random(20000) < 0.4
    prev = np.flatnonzero(rng.random(20000) < 0.7)
    for seed in range(5):
        for p in (None, prev):
            want = np.flatnonzero(~done) if p is None else p[~done[p]]
            for tile in (SMALL_TILE, SMALL_WIDE):
                queue, count = lookback_model(done, p, seed=seed, **tile)
                assert count == want.shape[0]
                np.testing.assert_array_equal(queue, want)


@pytest.mark.parametrize("form", [None, "one_pass", "first"])
def test_queue_forms_refuse_cpu_tensors(form):
    """The queue alone in each form (None: the one pass, the main path's) and
    a loop's one pass take CUDA tensors only and say so before any library
    is asked for; no launch is counted. A form the queue lacks is refused."""
    done = torch.zeros(100, dtype=torch.bool)
    t_off = torch.zeros(100)
    before = (dict(brick_cuda.launches), dict(brick_cuda.form_launches))
    loaded = set(_build._libs)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.level_queue_kernel("sharded", done, t_off, form=form)
    queue = brick_cuda.LevelQueue()
    queue.out = (torch.zeros(100, dtype=torch.int32), torch.zeros(100))
    with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
        brick_cuda.level_queue_build("trunk", done, t_off, queue)
    with pytest.raises(ValueError, match="form"):
        brick_cuda.level_queue_kernel("sharded", done, t_off, form="two_pass")
    assert set(_build._libs) == loaded and queue.status is None
    assert before == (brick_cuda.launches, brick_cuda.form_launches)


@pytest.mark.parametrize("seg", [1, 7, 256, 257, 1000, 70001])
def test_segment_search_finds_each_prefix(seg):
    """The packets' search counts every segment's valid prefix, empty and
    full ones included, and the queued threads walk exactly the valid
    slots in order."""
    rng = np.random.default_rng(seg)
    counts = [0, seg, 1, seg - 1, int(rng.integers(0, seg + 1))]
    valid = np.concatenate([np.arange(seg) < c for c in counts])
    got = segment_search_model(valid, seg)
    np.testing.assert_array_equal(got, counts)
    packets = torch.zeros((valid.shape[0], 8))
    packets[:, 7] = torch.from_numpy(valid.astype(np.int32)).view(torch.float32)
    want = np.flatnonzero(valid)
    np.testing.assert_array_equal(
        level_sharded.level_queue_plain("packets", packets, seg=seg).numpy(), want)
    # a grid larger than the queue: the threads past it take no slot
    np.testing.assert_array_equal(queued_slots_model(got, seg, valid.shape[0]), want)


def test_packets_off_their_prefix_are_refused():
    """The model refuses valid packets that are not a prefix of their
    segment, the layout the kernel's search assumes."""
    packets = torch.zeros((8, 8))
    packets[[0, 2], 7] = torch.tensor([1, 1], dtype=torch.int32).view(torch.float32)
    with pytest.raises(ValueError, match="prefix"):
        level_sharded.level_queue_plain("packets", packets, seg=4)
    assert level_sharded.level_queue_plain("packets", packets, seg=2).tolist() == [0, 2]


@pytest.fixture(scope="module")
def rounds():
    """Every level_round call of a sharded trace and an exchange trace at
    world 1 (terrain at depth 6 split at level 2, 64² rays, cap_factor 1)."""
    mesh = make_mesh(1, "cpu")
    try:
        ls = level_sharded.split_svo(build_svo(get_scene("terrain"), 6), 2, 1)
        o, d = camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                             fov_y_deg=50.0, width=64, height=64).rays("cpu")
        calls, plain = [], level_sharded.level_round

        def recording(mode, tb, *args, **kw):
            calls.append((mode, tb, args, kw))
            return plain(mode, tb, *args, **kw)
        level_sharded.level_round = recording
        try:
            level_sharded.make_sharded_trace(mesh, ls)(o, d)
            level_sharded.make_exchange_trace(mesh, ls, cap_factor=1)(o, d)
        finally:
            level_sharded.level_round = plain
    finally:
        torch.distributed.destroy_process_group()
    return calls


def test_queued_rounds_equal_the_plain_version(rounds):
    """Round by round and mode by mode, the queued form's model gives the
    plain version's outputs bit for bit, and the same walks and steps; the
    bound each loop passed covers its queue."""
    modes = [c[0] for c in rounds]
    assert modes.count("sharded") > 2 and modes.count("packets") > 2
    for mode, tb, args, kw in rounds:
        kw = {k: v for k, v in kw.items() if k != "counts"}
        c_q, c_p = {}, {}
        got = level_sharded.level_round_queued_plain(mode, tb, *args, counts=c_q, **kw)
        want = level_sharded.level_round_plain(mode, tb, *args, counts=c_p)
        assert c_q == c_p
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert g.numpy().tobytes() == w.numpy().tobytes(), mode


@pytest.fixture(scope="module")
def ours():
    """Every world's queued and unqueued loops (one spawn a world size)."""
    inputs = {"rays": RAYS, "hot": HOT, "hot_rounds": HOT_ROUNDS}
    return {w: torch_ranks.run(w, "level_queued", inputs) for w in WORLDS}


@pytest.fixture(scope="module")
def builds():
    from raytracingtest_tpu.ops import octree as jax_octree
    from raytracingtest_tpu.scenes import get_scene as jax_get_scene
    return (jax_octree.build_svo(jax_get_scene("sphere"), 6),
            build_svo(get_scene("sphere"), 6))


@pytest.mark.parametrize("world", WORLDS)
def test_queued_loops_equal_the_unqueued_loops(ours, world):
    """The queued rounds change no bit of either trace, nor their rounds
    nor the per-rank traced counts."""
    for r in ours[world]:
        q, u = r["queued"], r["unqueued"]
        assert q["trace_rounds"] == u["trace_rounds"] > 1
        assert q["exchange_rounds"] == u["exchange_rounds"] >= 1
        for key in ("trace", "exchange"):
            for a, b in zip(q[key], u[key]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("world", WORLDS)
def test_queued_loops_match_the_reference(builds, ours, world):
    """The queued loops against the JAX package's at the same device count:
    the sharded trace on every rank, the exchange trace's shards together,
    traced per rank."""
    ref = ref_trace(builds, world, *RAYS)
    for r in ours[world]:
        assert_trace_equal(r["queued"]["trace"], ref)
    ref = ref_exchange(builds, world, *HOT, max_rounds=HOT_ROUNDS, cap_factor=1)
    got = [np.concatenate([r["queued"]["exchange"][k] for r in ours[world]])
           for k in range(5)]
    for k in (0, 2, 3, 4):
        np.testing.assert_array_equal(got[k], ref[k])
    hit = got[0] >= 0
    assert hit.any() and not got[4].any()
    np.testing.assert_allclose(got[1][hit], ref[1][hit], rtol=1e-5, atol=1e-6)
