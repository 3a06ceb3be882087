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

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("n,p", [(1, 0.5), (255, 0.3), (256, 1.0), (257, 0.0),
                                 (5000, 0.1), (5000, 0.9)])
def test_place_pass_is_the_stable_compaction(n, p):
    """The count and place passes' model gives the rays not done in order,
    which ``level_queue_plain`` gives too."""
    rng = np.random.default_rng(n)
    done = rng.random(n) >= p
    queue = place_model(done)
    np.testing.assert_array_equal(queue, np.flatnonzero(~done))
    np.testing.assert_array_equal(
        level_sharded.level_queue_plain("sharded", None, torch.from_numpy(done)).numpy(),
        queue)


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
