"""Phases C and D of the device build in one pass a level (kernel
``svo_level_pass``, ops/octree_cuda.py ``level_up``) on the CPU: its plain
version against the first forms' plain versions (``level_up_plain``, then
``compact_plain`` of its flags, then ``parent_ptr_plain`` of the assembled
tree), and a numpy model of the kernel (rows of 32 entries a warp, the
run's suffix OR by shuffles, heads by ballots, the tile prefix by a
decoupled look-back with the tiles finishing in seeded random orders)
against the plain version. Every comparison is exact: the pass moves
integers.
"""

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import octree_cuda
from raytracingtest_tpu_torch.ops.octree import compute_parent_ptr
from tests.test_torch_threads import one_torch_thread  # noqa: F401

I32 = torch.int32
BLOCK = octree_cuda.BLOCK
TILE = octree_cuda.LEVEL_TILE
SOURCE = f"{_build._CSRC}/svo_build.cu"


def parent_major(n_par, seed, runs=(1, 8), keep=0.6, empty=0.2):
    """Seeded child candidates of `n_par` parents, parent-major (each
    parent's children in ascending slots, `runs` their count's range, a
    share `empty` of parents with none), and the surviving ones' indices in
    order (each candidate kept with probability `keep`): (rows, par, slot)
    as int32 tensors."""
    rng = np.random.default_rng(seed)
    n = rng.integers(runs[0], runs[1] + 1, n_par)
    n[rng.random(n_par) < empty] = 0
    par = np.repeat(np.arange(n_par), n)
    slot = np.concatenate([np.sort(rng.permutation(8)[:c]) for c in n] or [np.zeros(0)])
    rows = np.flatnonzero(rng.random(par.shape[0]) < keep)
    return tuple(torch.from_numpy(np.asarray(a, np.int32)) for a in (rows, par, slot))


def first_forms(rows, par, slot, n_par, root=False):
    """The first forms' plain versions: level_up_plain, the root's survival
    (as the build before the pass had it), compact_plain of the flags:
    (nodes, below, count) of the surviving parents, and each survivor's
    parent rank (its parent's place among them)."""
    rec, surv = octree_cuda.level_up_plain(rows, par, slot, n_par)
    if root:
        surv[0] = 1
    counts = octree_cuda.count_plain(surv)
    below, nodes = octree_cuda.compact_plain(surv, None, int(counts.sum()), rec)
    ranks = torch.searchsorted(below, par[rows.long()]).to(I32)
    return nodes, below, below.shape[0], ranks


def nodes_of(out, c):
    """(c, 2) [valid mask, first child] of a LevelPass's first c parents."""
    return torch.stack([out.masks[:c], out.first[:c]], 1)


def assert_pass_equal(out, nodes, below, c, ranks, m):
    assert int(out.count[0]) == c
    assert torch.equal(nodes_of(out, c), nodes) and torch.equal(out.below[:c], below)
    if out.ranks is not None:
        assert torch.equal(out.ranks[:m], ranks[:m])


# ---- the plain version against the first forms -------------------------------

CASES = {
    "runs 1 to 8": dict(n_par=300, runs=(1, 8)),
    "runs of 8": dict(n_par=300, runs=(8, 8), keep=1.0, empty=0.0),
    "runs of 1": dict(n_par=300, runs=(1, 1), keep=1.0),
    "across rows and tiles": dict(n_par=2 * TILE, runs=(5, 8), keep=0.9, empty=0.05),
    "sparse": dict(n_par=5000, runs=(1, 3), keep=0.2, empty=0.5),
    "one parent": dict(n_par=1, runs=(1, 8), keep=1.0, empty=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_pass_equals_the_first_forms(case, seed):
    """level_pass_plain's surviving parents, their masks, first children,
    indices and count, and each survivor's parent rank, equal level_up_plain
    + compact_plain's on parent-major inputs, all rows valid."""
    rows, par, slot = parent_major(seed=seed, **CASES[case])
    n_par = CASES[case]["n_par"]
    out = octree_cuda.level_pass_plain(rows, par * 8 + slot, n_par)
    assert_pass_equal(out, *first_forms(rows, par, slot, n_par), rows.shape[0])
    assert out.masks.shape == out.first.shape == (min(rows.shape[0], n_par),)
    assert out.ranks.shape == rows.shape


@pytest.mark.parametrize("valid", [0, 1, 31, 32, 33, TILE - 1, TILE, TILE + 1])
def test_plain_pass_reads_only_the_valid_rows(valid):
    """With a count on the device (n_rows), only the first n_rows rows are
    read: the bound's tail may hold anything."""
    rows, par, slot = parent_major(2 * TILE, seed=valid, runs=(2, 8), keep=0.8)
    junk = rows.clone()
    junk[valid:] = rows.flip(0)[:rows.shape[0] - valid]  # out of order
    n_rows = torch.tensor([valid], dtype=I32)
    out = octree_cuda.level_pass_plain(junk, par * 8 + slot, 2 * TILE, n_rows)
    want = first_forms(rows[:valid], par, slot, 2 * TILE)
    assert_pass_equal(out, *want, valid)
    assert out.ranks.shape == junk.shape


@pytest.mark.parametrize("n_par", [1, 5])
def test_level_with_no_survivor(n_par):
    """No survivor below: no parent, count 0, as the first forms give it
    (the root's one candidate too: an empty world's root row, (0, BIG) in
    the first form, is the build's to make, test_empty_world_keeps_a_root)."""
    rows, par, slot = parent_major(n_par, seed=3, keep=0.0)
    assert rows.shape == (0,)
    out = octree_cuda.level_pass_plain(rows, par * 8 + slot, n_par)
    assert out.count.tolist() == [0] and out.masks.shape == (0,)
    assert first_forms(rows, par, slot, n_par)[2] == 0
    nodes, below, c, _ = first_forms(rows, par, slot, 1, root=True)
    assert c == 1 and nodes.tolist() == [[0, octree_cuda.BIG]] and below.tolist() == [0]


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """level_up on CPU tensors is level_pass_plain, launches nothing, and
    writes its count into the tensor it is given."""
    rows, par, slot = parent_major(100, seed=9)
    before = dict(octree_cuda.launches)
    count = torch.full((3,), -1, dtype=I32)
    out = octree_cuda.level_up(rows, par * 8 + slot, 100, count=count[1:2], ranks=False)
    want = octree_cuda.level_pass_plain(rows, par * 8 + slot, 100)
    assert out.ranks is None and count.tolist() == [-1, int(want.count[0]), -1]
    c = int(want.count[0])
    assert torch.equal(nodes_of(out, c), nodes_of(want, c))
    assert octree_cuda.launches == before


def test_level_pass_kernel_refuses_cpu_tensors():
    """The kernel's launcher refuses a CPU device by its name, before any
    library is built."""
    loaded = set(_build._libs)
    with pytest.raises(ValueError, match="the svo_level_pass kernel takes CUDA tensors"):
        octree_cuda._SVO_LEVEL_PASS.check(torch.device("cpu"), ())
    assert set(_build._libs) == loaded


def build_levels(depth, seed, branch=(1, 8)):
    """A seeded tree's levels bottom up, as phase A leaves them: for each
    level k + 1, its candidates' parents and slots (parent-major), and the
    leaves' rows among the finest candidates."""
    rng = np.random.default_rng(seed)
    pars, slots, n = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], 1
    for _ in range(depth):
        c = rng.integers(branch[0], branch[1] + 1, n)
        pars.append(np.repeat(np.arange(n), c))
        slots.append(np.concatenate([np.sort(rng.permutation(8)[:k]) for k in c]))
        n = int(c.sum())
    leaves = np.flatnonzero(rng.random(n) < 0.3)
    if leaves.size == 0:  # the build takes an empty world apart
        leaves = np.zeros(1, np.int64)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return [t(p) for p in pars], [t(s) for s in slots], t(leaves)


@pytest.mark.parametrize("depth,seed", [(1, 0), (3, 1), (5, 2)])
def test_passes_assemble_the_first_forms_tree(depth, seed):
    """The build's phases C and D over seeded levels: the plain passes
    bottom up (each reading the last one's rows and count), the assembly's
    masks, child bases, leaf bases and parent pointers, against the first
    forms' tree (level_up_plain, compact_plain, then parent_ptr_plain of its
    masks and child bases)."""
    from raytracingtest_tpu_torch.ops.octree_device import _assemble
    pars, slots, leaves = build_levels(depth, seed)
    counts = torch.zeros(depth, dtype=I32)
    valid, first_k, ff = [None] * depth, [None] * depth, [None] * depth
    ranks = [None] * (depth + 1)
    below, ff_below, n_rows = leaves, leaves, None
    for k in range(depth - 1, -1, -1):
        n_par = pars[k].shape[0]
        valid[k], first_k[k], below, ranks[k + 1], _ = octree_cuda.level_pass_plain(
            below, pars[k + 1] * 8 + slots[k + 1], n_par, n_rows, ranks=k + 1 < depth,
            count=counts[k:k + 1])
        n_rows = counts[k:k + 1]
        ff[k], ff_below, _, _ = first_forms(ff_below, pars[k + 1], slots[k + 1], n_par,
                                            root=k == 0)
    level_counts = counts.tolist()
    assert level_counts == [f.shape[0] for f in ff]
    starts = np.concatenate([[0], np.cumsum(level_counts)]).tolist()
    masks, child_base, leaf_base, pptr = _assemble(valid, first_k, ranks, level_counts,
                                                   starts)
    # the first forms' tree, as the build assembled it before the pass
    vm = torch.cat([f[:, 0] for f in ff])
    first = torch.cat([f[:, 1] for f in ff])
    last = slice(starts[depth - 1], starts[depth])
    want_masks = vm << 8
    want_masks[last] |= vm[last]
    offsets = torch.cat([torch.full((c,), starts[k + 1], dtype=I32)
                         for k, c in enumerate(level_counts)])
    want_child = torch.where(first == octree_cuda.BIG, 0, first + offsets)
    want_child[last] = 0
    want_leaf = torch.zeros_like(vm)
    want_leaf[last] = first[last]
    assert torch.equal(masks, want_masks) and torch.equal(child_base, want_child)
    assert torch.equal(leaf_base, want_leaf)
    assert torch.equal(pptr, octree_cuda.parent_ptr_plain(masks, child_base))
    assert np.array_equal(pptr.numpy(), compute_parent_ptr(masks.numpy(),
                                                           child_base.numpy()))


# ---- a numpy model of the kernel ------------------------------------------------

def lookback_prefix(aggregates, seed, look=1):
    """The tiles' exclusive prefixes by decoupled look-back, the tiles'
    steps in a seeded random order: each publishes its aggregate (tile 0 its
    inclusive prefix) in a status word tagged with the launch's epoch, over
    words an earlier launch left, then looks back window by window (lane l
    reads the words hi - look l - j), waiting at a word not yet published,
    summing aggregates down to the nearest inclusive prefix, and publishes
    its own."""
    rng = np.random.default_rng(seed)
    tiles = len(aggregates)
    epoch = 9
    words = [(epoch - 1, int(rng.integers(0, 3)), int(rng.integers(0, 1 << 20)))
             for _ in range(tiles)]
    state, progress, base = ["start"] * tiles, [None] * tiles, [0] * tiles
    while any(st != "done" for st in state):
        t = int(rng.choice([k for k in range(tiles) if state[k] != "done"]))
        if state[t] == "start":
            words[t] = (epoch, 2 if t == 0 else 1, aggregates[t])
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
            words[t] = (epoch, 2, excl + aggregates[t])
            base[t], state[t] = excl, "done"
        else:
            progress[t] = (hi - 32 * look, excl)
    return base


def shifted(a, o, fill):
    """Lane l gets lane l + o's value (o > 0, shuffle down) or lane l - o's
    (o < 0, shuffle up); lanes whose source is outside the warp keep
    `fill`."""
    out = np.full_like(a, fill)
    if o > 0:
        out[..., :32 - o] = a[..., o:]
    else:
        out[..., -o:] = a[..., :32 + o]
    return out


def level_pass_model(rows, code, m, n_par, seed=0, block=BLOCK, items=8, run=8,
                     look=1):
    """svo_level_pass_kernel in numpy, its tile's shape (`block` threads,
    `items` rows of 32 a warp) as parameters: (nodes, below, ranks, count)
    of the first m rows, each candidate's parent * 8 + slot in `code`."""
    rows, code = (np.asarray(a, np.int64) for a in (rows, code))
    tile_n, warp_n, warps = block * items, 32 * items, block // 32
    b_out = min(rows.shape[0], n_par)
    nodes = np.zeros((b_out, 2), np.int64)
    below = np.zeros(b_out, np.int64)
    ranks = np.zeros(rows.shape[0], np.int64)
    if m == 0:  # tile 0 writes the count
        return nodes, below, ranks, 0
    tiles = -(-m // tile_n)
    lane = np.arange(32)
    k_rows = np.arange(items + 1)[:, None]
    heads_of, per_warp = {}, np.zeros((tiles, warps), np.int64)
    for t in range(tiles):
        for w in range(warps):
            wbase = t * tile_n + w * warp_n
            e = wbase + 32 * k_rows + lane  # (items + 1, 32)
            ok = (e < m) & ((k_rows < items) | (lane < run))
            r = np.where(ok, rows[np.minimum(e, m - 1)], -1)
            c = np.where(ok, code[np.maximum(r, 0)], -8)
            p = c >> 3
            b = np.where(ok, 1 << (c & 7), 0)
            for o in (1, 2, 4):  # a run is at most 8
                same = shifted(p, o, -2) == p
                b = b | np.where(same, shifted(b, o, 0), 0)
            p_before = code[rows[wbase - 1]] >> 3 if 0 < wbase < m else -1
            head = np.zeros((items, 32), bool)
            for k in range(items):
                # the next row's lane 0 continues the run that reaches the
                # row's end, if any
                b[k] |= np.where((p[k] >= 0) & (p[k + 1, 0] == p[k]), b[k + 1, 0], 0)
                up = shifted(p[k], -1, -3)
                up[0] = p[k - 1, 31] if k > 0 else p_before
                head[k] = (p[k] >= 0) & (up != p[k])
            heads_of[(t, w)] = (e[:items], p[:items], b[:items], head)
            per_warp[t, w] = head.sum()
    tile_base = lookback_prefix(per_warp.sum(1).tolist(), seed, look)
    count = tile_base[-1] + int(per_warp[-1].sum())
    for (t, w), (e, p, b, head) in heads_of.items():
        rank = tile_base[t] + int(per_warp[t, :w].sum())
        for k in range(items):
            mine = rank + np.cumsum(head[k]) - head[k]
            for ln in np.flatnonzero(head[k]):
                nodes[mine[ln]] = (b[k, ln], e[k, ln])
                below[mine[ln]] = p[k, ln]
            valid = p[k] >= 0
            ranks[e[k][valid]] = np.where(head[k], mine, mine - 1)[valid]
            rank += int(head[k].sum())
    return nodes, below, ranks, count


MODEL_CASES = {
    "runs 1 to 8": dict(n_par=900, runs=(1, 8)),
    "runs of 8, every row crossed": dict(n_par=700, runs=(8, 8), keep=1.0, empty=0.0),
    "runs of 1": dict(n_par=600, runs=(1, 1), keep=1.0),
    "sparse": dict(n_par=3000, runs=(1, 2), keep=0.3, empty=0.6),
    "one parent": dict(n_par=1, runs=(1, 8), keep=1.0, empty=0.0),
}
# the kernel's tile (2048 survivors) and small ones (64 and 128), so that
# the cases span many tiles and look-back windows
SHAPES = {"kernel": dict(), "small": dict(block=32, items=2),
          "small, two words a lane": dict(block=64, items=2, look=2)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_model_equals_the_plain_pass(case, shape, seed):
    """The kernel's model, its tiles finishing in seeded random orders,
    gives level_pass_plain's parents, masks, first children, indices, parent
    ranks and count, all rows valid and with a count on the device below
    the bound (the rows past it left as junk)."""
    rows, par, slot = parent_major(seed=seed, **MODEL_CASES[case])
    n_par = MODEL_CASES[case]["n_par"]
    for m in sorted({rows.shape[0], rows.shape[0] * 2 // 3}):
        n_rows = torch.tensor([m], dtype=I32)
        want = octree_cuda.level_pass_plain(rows, par * 8 + slot, n_par, n_rows)
        nodes, below, ranks, count = level_pass_model(rows, par * 8 + slot, m, n_par,
                                                      seed=seed, **SHAPES[shape])
        c = int(want.count[0])
        assert count == c
        np.testing.assert_array_equal(nodes[:c], nodes_of(want, c).numpy())
        np.testing.assert_array_equal(below[:c], want.below[:c].numpy())
        np.testing.assert_array_equal(ranks[:m], want.ranks[:m].numpy())


@pytest.mark.parametrize("n_par", [1, 5])
def test_kernel_model_with_nothing_valid(n_par):
    """A bound above a count of 0 on the device: no parent, count 0."""
    rows, par, slot = parent_major(n_par, seed=4, keep=1.0, empty=0.0)
    n_rows = torch.zeros(1, dtype=I32)
    nodes, below, _, count = level_pass_model(rows, par * 8 + slot, 0, n_par)
    want = octree_cuda.level_pass_plain(rows, par * 8 + slot, n_par, n_rows)
    assert count == int(want.count[0]) == 0


def test_model_shape_is_the_sources():
    """The model's defaults are svo_build.cu's: blocks of BLOCK threads,
    LITEMS rows a warp, runs of at most 8, LTILE a tile (LEVEL_TILE)."""
    with open(SOURCE) as f:
        src = f.read()
    assert "constexpr int BLOCK = 256;" in src and BLOCK == 256
    assert "constexpr int LITEMS = 8, LWARP = 32 * LITEMS, LTILE = BLOCK * LITEMS;" in src
    assert "constexpr int RUN = 8;" in src and TILE == BLOCK * 8
