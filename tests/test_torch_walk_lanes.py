"""A model of the tile walker's lanes decomposition (``csrc/tile_walk.cu``,
``tile_walk_kernel``) held against the serial walk.

The kernel gives each ray G lanes. A round of G candidates is walked side by
side, each lane bound by the hit the ray carries into the round, and the
serial result is rebuilt from an exclusive prefix minimum of the lanes'
hits: where the walk stops, which candidates it enters, what each costs in
DDA steps, and which holds the hit. ``lanes_model`` below does the same in
tensor ops, round by round and lane by lane as the kernel does (with the
port's ``dda_step``), so the tests can hold the decomposition bitwise to
``tile.walk_plain`` on the CPU, where no CUDA kernel runs. The kernel itself
is held to ``walk_plain`` and to its serial form on the card by
chip_smoke.py.

Lists: the main walk's (k_max 48) and the fallback's shape (K = 160, every
level kept); lists whose every candidate appears twice in a row, which
gives exact t ties between candidates in one round and makes the second of
each pair resume its DDA past a voxel that no longer beats the running hit;
and lists whose candidates are shuffled within each tile, on which a later
candidate often holds a nearer hit than an earlier one (in t-ascending
lists a ray meets the bricks nearly in list order, so that is rare). The
walk is a function of any list, and the kernel must compute it for any.
"""

import numpy as np
import pytest
import torch

from raytracingtest_tpu.ops import tile as jax_tile

from raytracingtest_tpu_torch.ops import tile
from raytracingtest_tpu_torch.ops.brick import BRICK_LEVELS
from raytracingtest_tpu_torch.ops.brick_dda import dda_step
from raytracingtest_tpu_torch.ops.traverse import ray_setup
from tests.test_torch_tile_trace import (
    HIT_T_ATOL, HIT_T_RTOL, setup, tensors)

_F32, _I32 = torch.float32, torch.int32
INF = float("inf")
STEP_BOUND = 24   # the kernels' bound on a brick's DDA loop


def lanes_model(bricks, o, d, codes, ids, t_codes, depth, top_depth, G):
    """The kernel's walk with G lanes a ray, in tensor ops. Arguments and
    results as ``tile.walk_plain``, plus the number of hits that replaced an
    earlier hit of the same ray (a later candidate nearer than it)."""
    T, P = o.shape[0], o.shape[1]
    K = ids.shape[1]
    n = T * P
    t_coef, t_bias, om, t0, t_max = ray_setup(o.reshape(n, 3), d.reshape(n, 3))
    bsize = 2.0 ** -top_depth
    om_bits = torch.stack([om & 1, (om >> 1) & 1, (om >> 2) & 1], dim=-1)
    flip = torch.where(om_bits == 1, 0, 7).to(_I32)
    tile_of = torch.arange(n) // P
    bricks_f = bricks.reshape(-1)
    lane = torch.arange(G)
    # one row a (ray, lane), ray-major
    rep = lambda x: x.repeat_interleave(G, dim=0)
    tc_l, tb_l, om_l, flip_l, t0_l = (rep(x) for x in (t_coef, t_bias, om, flip, t0))

    H = torch.full((n,), INF, dtype=_F32)
    hit_bid = torch.full((n,), -1, dtype=_I32)
    hit_idx9 = torch.zeros(n, dtype=_I32)
    iters = torch.zeros(n, dtype=_I32)
    replaced = 0
    walking = ~(t0 >= t_max)
    for base in range(0, K + G, G):
        if not bool(walking.any()):
            break
        # ---- every lane's candidate, bound by the ray's carried hit H
        k = base + lane[None, :].expand(n, G)
        kc = torch.clamp(k, max=K - 1)
        id_k = ids[tile_of[:, None], kc]
        tlb = t_codes[tile_of[:, None], kc]
        code = codes[tile_of[:, None], kc]
        hard_stop = (k >= K) | (id_k < 0)
        Hr = H[:, None].expand(n, G)
        work = walking[:, None] & ~hard_stop & ~(tlb >= Hr)

        pos_b = tile._mirrored_brick_corner(code.reshape(-1), om_l, top_depth)
        t_in = torch.maximum(torch.amax((pos_b + bsize) * tc_l - tb_l, dim=1), t0_l)
        t_out = torch.amin(pos_b * tc_l - tb_l, dim=1)
        box_ok = (t_in < t_out).reshape(n, G)
        walk_a = (work & box_ok & (t_in.reshape(n, G) < Hr)).reshape(-1)
        bpos = pos_b
        for l in range(1, BRICK_LEVELS + 1):
            half = bsize * 2.0 ** -l
            t_center = half * tc_l + (bpos * tc_l - tb_l)
            bpos = bpos + torch.where(t_center > t_in[:, None], half, 0.0)
        bid = torch.clamp(id_k.reshape(-1), min=0).long()
        word_of = lambda wsel: bricks_f[bid * 17 + wsel.long()]
        t_cur = t_in.clone()
        H_l = Hr.reshape(-1)
        steps = torch.zeros(n * G, dtype=_I32)
        found = torch.zeros(n * G, dtype=torch.bool)
        v = torch.full((n * G,), INF, dtype=_F32)
        idx9 = torch.zeros(n * G, dtype=_I32)
        live = walk_a
        for _ in range(STEP_BOUND):
            if not bool(live.any()):
                break
            steps = steps + live.to(_I32)
            bpos, t_cur, hit_now, _exit, live, idx9_now = dda_step(
                bpos, t_cur, live, H_l, tc_l, tb_l, flip_l, word_of, depth)
            found = found | hit_now
            v = torch.where(hit_now, t_cur, v)
            idx9 = torch.where(hit_now, idx9_now, idx9)

        # ---- H_j: an exclusive prefix minimum of the lanes' hits, from H
        v2 = v.reshape(n, G)
        before = torch.cat([torch.full((n, 1), INF), torch.cummin(v2, dim=1).values[:, :-1]], 1)
        Hj = torch.minimum(Hr, before)
        stop = hard_stop | (tlb >= Hj)
        first_stop = torch.where(stop.any(1), torch.argmax(stop.to(_I32), dim=1),
                                 torch.tensor(G))
        counted = lane[None, :] < first_stop[:, None]
        enter = walking[:, None] & counted & box_ok & (t_in.reshape(n, G) < Hj)
        wins = enter & found.reshape(n, G) & (v2 < Hj)
        steps2 = steps.reshape(n, G)
        # a voxel that beat H but not H_j: resume there with bound H_j and
        # walk on to the brick's exit, inside the loop's bound
        resume = (enter & found.reshape(n, G) & ~wins).reshape(-1)
        more = torch.zeros(n * G, dtype=_I32)
        live = resume
        Hj_l = Hj.reshape(-1)
        for s in range(STEP_BOUND):
            live = live & (steps - 1 + s < STEP_BOUND)
            if not bool(live.any()):
                break
            more = more + live.to(_I32)
            bpos, t_cur, hit_now, _exit, live, _i = dda_step(
                bpos, t_cur, live, Hj_l, tc_l, tb_l, flip_l, word_of, depth)
            assert not bool(hit_now.any())   # nothing past it beats H_j
        cost = torch.where(resume.reshape(n, G), steps2 - 1 + more.reshape(n, G),
                           steps2)
        iters = iters + torch.sum(torch.where(enter, cost, 0), dim=1, dtype=_I32)

        # ---- the last new hit of the round holds the hit
        has = wins.any(1)
        w = G - 1 - torch.argmax(torch.flip(wins, [1]).to(_I32), dim=1)
        rows = torch.arange(n)
        replaced += int((has & (hit_bid >= 0)).sum()) + int(
            (wins.sum(1) - 1).clamp(min=0).sum())
        H = torch.where(has, v2[rows, w], H)
        hit_bid = torch.where(has, id_k[rows, w], hit_bid)
        hit_idx9 = torch.where(has, idx9.reshape(n, G)[rows, w], hit_idx9)
        walking = walking & (first_stop == G)

    hit_leaf, hit_t = tile._resolve_hits(hit_bid, hit_idx9, H, bricks)
    return (hit_leaf.reshape(T, P), hit_t.reshape(T, P), iters.reshape(T, P)), replaced


def walk_args(name, depth, shape, res=64):
    """The walker's arguments on a scene: lists of the main walk's shape
    ("main", k_max 48), the fallback's ("fallback", K = 160, every level
    kept), or the main lists with each candidate twice ("doubled") or with
    each tile's candidates in a seeded random order ("shuffled")."""
    _ref_ts, ts, _svo, rays = setup(name, depth, res)
    o, d, corners = tensors(rays)
    td = ts.top_depth
    if shape == "fallback":
        caps, k = tuple(min(160, 8 ** l) for l in range(td + 1)), 160
    else:
        caps, k = tile._default_caps(td, 48), 48
    codes, ids, t_codes, _drop = tile._candidates(
        ts.pyr, ts.cellmap, corners, o[0, 0], td, caps, k)
    if shape == "doubled":
        codes, ids, t_codes = (x.repeat_interleave(2, dim=1).contiguous()
                               for x in (codes, ids, t_codes))
    if shape == "shuffled":
        rng = np.random.default_rng(depth)
        order = torch.from_numpy(np.argsort(rng.random(ids.shape), axis=1))
        # the valid candidates shuffled, the -1 padding kept at the end
        order = torch.gather(order, 1, torch.argsort(
            (torch.gather(ids, 1, order) < 0).to(torch.int8), dim=1, stable=True))
        codes, ids, t_codes = (torch.gather(x, 1, order).contiguous()
                               for x in (codes, ids, t_codes))
    return ts.bsvo.bricks, o, d, codes, ids, t_codes, ts.depth, td


def bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


_plain = {}


def plain_walk(case):
    if case not in _plain:
        _plain[case] = tile.walk_plain(*walk_args(*case))
    return _plain[case]


CASES = [("terrain", 6, "main"), ("terrain", 7, "fallback"),
         ("flat_ground", 6, "fallback"), ("sphere", 5, "doubled"),
         ("terrain", 6, "shuffled")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
@pytest.mark.parametrize("G", [1, 2, 8, 32])
def test_lanes_model_equals_the_serial_walk(case, G):
    """Bitwise on hit_leaf, hit_t and iters, for every G."""
    got, replaced = lanes_model(*walk_args(*case), G)
    want = plain_walk(case)
    for what, a, b in zip(("hit_leaf", "hit_t", "iters"), got, want):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b)), (case, G, what)
    assert int((want[0] >= 0).sum()) > 100
    if case[2] == "shuffled":   # later candidates hold nearer hits
        assert replaced > 100


def test_doubled_lists_tie_and_resume():
    """Each candidate twice in a row: the copy that follows a hit meets a
    voxel whose t equals the running hit exactly, which is no new hit
    (strict <), and walks on to its exit; iters counts those steps."""
    case = ("terrain", 6, "doubled")
    single = plain_walk(("terrain", 6, "main"))
    doubled = plain_walk(case)
    assert torch.equal(doubled[0], single[0])
    assert torch.equal(bits(doubled[1]), bits(single[1]))
    assert bool((doubled[2] > single[2]).any())   # the copies' exit walks
    got, _ = lanes_model(*walk_args(*case), 2)
    assert torch.equal(got[2], doubled[2])


def test_lanes_model_against_the_reference_walk():
    """On one small scene, the model at G = 8 against the JAX package's
    walk (``_walk_chunk_window`` inside its ``trace_tile``, XLA on the
    CPU): leaf ids and steps exact, hit_t within F14's tolerance."""
    ref_ts, _ts, _svo, rays = setup("terrain", 6)
    ref, _un = jax_tile.trace_tile(ref_ts, *rays)
    got, _ = lanes_model(*walk_args("terrain", 6, "main"), 8)
    np.testing.assert_array_equal(got[0].reshape(-1).numpy(), np.asarray(ref.hit_leaf))
    np.testing.assert_array_equal(got[2].reshape(-1).numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got[1].reshape(-1).numpy(), np.asarray(ref.hit_t),
                               rtol=HIT_T_RTOL, atol=HIT_T_ATOL)
