"""The sort-free segment sum: its function against the JAX package's
backward, and its algorithm against a serial scatter-add.

``shade_cuda.segment_sum(cot, hit_leaf, n_leaves)`` adds each leaf's rows in
ascending ray index from +0. On the CPU it runs its plain version; the
kernels (``csrc/shade.cu``: count, base, place, per-leaf sum with the ray
ids taken in ascending order) run only on the card. Two things are held
here:

  * the function, on CPU tensors, against ``raytracingtest_tpu.diff.
    _gather_bwd`` on the same numpy-seeded rows: bitwise (the sign of zero
    included) below ``SEG_MIN_ROWS``, where the reference adds with rank-1
    scatter-adds in ray order; within 1e-4 abs at or above it, where the
    reference's running sums reassociate (9.5e-5 measured there).
  * the design's claim, that taking a leaf's ray ids in ascending order
    erases the order in which the place pass wrote them: a numpy model of
    the kernels' algorithm (the same selection loop for short runs, the same
    comparator network for long ones, float32 adds one after another) is
    placed with seeded permutations and held bitwise against ``np.add.at``
    in ray order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingtest_tpu import diff as jax_diff

from raytracingtest_tpu_torch import diff
from raytracingtest_tpu_torch.ops import shade_cuda
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SEG_SHORT = shade_cuda.SEG_SHORT


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def rows_for(rng, n, with_negative_zero=False):
    cot = (rng.random((n, 7), dtype=np.float32) - np.float32(0.5))
    if with_negative_zero:
        cot[rng.random((n, 7)) < 0.3] = np.float32(-0.0)
    return cot


def case(name):
    """(hit_leaf (n,) int32, cot (n, 7) float32, n_leaves) of a named case,
    from a numpy seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random hits":
        n, m = 4096, 500
        leaf = rng.integers(0, m, n).astype(np.int32)
        leaf[rng.random(n) < 0.4] = -1
    elif name == "all misses":
        n, m = 1024, 50
        leaf = np.full(n, -1, np.int32)
    elif name == "every ray on one leaf":
        n, m = 3000, 40
        leaf = np.full(n, 7, np.int32)
    elif name == "one leaf in all":
        n, m = 2000, 1
        leaf = np.where(rng.random(n) < 0.5, 0, -1).astype(np.int32)
    elif name == "ids at and above the last leaf":
        n, m = 2048, 64
        leaf = rng.integers(m - 2, m + 5, n).astype(np.int32)
        leaf[::5] = -1
    elif name == "a run longer than a block sorts in shared memory":
        n, m = 6000, 30
        leaf = rng.integers(0, m, n).astype(np.int32)
        leaf[rng.permutation(n)[:2500]] = 11
    elif name == "rows holding -0.0":
        n, m = 4096, 300
        leaf = rng.integers(-1, m, n).astype(np.int32)
        return leaf, rows_for(rng, n, with_negative_zero=True), m
    elif name == "at the running-sum row count":
        n, m = diff.SEG_MIN_ROWS, 40_000
        leaf = rng.integers(-1, m, n).astype(np.int32)
    else:
        raise KeyError(name)
    return leaf, rows_for(rng, n), m


CASES = ["random hits", "all misses", "every ray on one leaf",
         "one leaf in all", "ids at and above the last leaf",
         "a run longer than a block sorts in shared memory",
         "rows holding -0.0", "at the running-sum row count"]


def serial(leaf, cot, m):
    """np.add.at in ray order: the serial float32 scatter-add."""
    hit = leaf >= 0
    out = np.zeros((m, 7), np.float32)
    np.add.at(out, np.minimum(leaf[hit], m - 1), cot[hit])
    return out


def port_sums(leaf, cot, m):
    out = shade_cuda.segment_sum(torch.from_numpy(cot), torch.from_numpy(leaf), m)
    assert [tuple(g.shape) for g in out] == [(m, 3), (m, 3), (m,)]
    return torch.cat([out[0], out[1], out[2][:, None]], dim=1).numpy()


@pytest.mark.parametrize("name", CASES)
def test_segment_sum_matches_reference_backward(name):
    leaf, cot, m = case(name)
    assert diff.SEG_MIN_ROWS == jax_diff.SEG_MIN_ROWS
    ours = port_sums(leaf, cot, m)
    # the reference takes ids in [0, m) and relies on a miss's rows being
    # zero, as the shading's backward makes them
    hit = leaf >= 0
    ids = np.where(hit, np.minimum(leaf, m - 1), 0).astype(np.int32)
    rows = np.where(hit[:, None], cot, np.float32(0.0))
    ref = jax_diff._gather_bwd(
        (jnp.asarray(ids), m),
        (jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3:6]), jnp.asarray(rows[:, 6])))
    ref = np.concatenate([np.asarray(ref[0]), np.asarray(ref[1]),
                          np.asarray(ref[2])[:, None]], axis=1)
    if leaf.shape[0] < diff.SEG_MIN_ROWS:
        np.testing.assert_array_equal(bits(ours), bits(ref))
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    # and the serial scatter-add, bitwise at any row count
    np.testing.assert_array_equal(bits(ours), bits(serial(leaf, cot, m)))
    untouched = np.ones(m, bool)
    untouched[np.minimum(leaf[hit], m - 1)] = False
    assert not bits(ours)[untouched].any()          # +0, not -0


@pytest.mark.parametrize("name", CASES[:7])
def test_sorted_form_equals_the_sort_free_form(name):
    leaf, cot, m = case(name)
    keys, order = shade_cuda.sort_by_leaf(torch.from_numpy(leaf), m)
    out = shade_cuda.segment_sum_sorted(torch.from_numpy(cot), keys, order, m)
    out = torch.cat([out[0], out[1], out[2][:, None]], dim=1).numpy()
    np.testing.assert_array_equal(bits(out), bits(port_sums(leaf, cot, m)))


# ---- a model of the kernels' algorithm --------------------------------------

def seg_sort_model(ids):
    """``seg_sort`` of csrc/shade.cu, pass by pass: a bitonic network whose
    comparators all put the smaller id at the lower index, positions from c
    up counted as +infinity and never touched."""
    ids = np.array(ids, np.int64)
    c = len(ids)
    i = np.arange(c)
    k = 2
    while k < 2 * c:
        mask = k - 1
        while mask > 0:
            l = i ^ mask
            pair = (l > i) & (l < c)
            lo, hi = i[pair], l[pair]
            swap = ids[hi] < ids[lo]
            ids[lo[swap]], ids[hi[swap]] = ids[hi[swap]], ids[lo[swap]]
            mask = k >> 2 if mask == k - 1 else mask >> 1
        k <<= 1
    return ids


def select_model(seg):
    """``seg_sum``'s short-run order: repeatedly the smallest id above the
    last one taken."""
    taken, prev = [], -1
    for _ in range(len(seg)):
        nxt = min(r for r in seg if r > prev)
        taken.append(nxt)
        prev = nxt
    return taken


def kernel_model(leaf, cot, m, placement, segment_order):
    """count, base, place and sum as the kernels do them, with the two orders
    the hardware is free to choose given as arguments: `placement`, the order
    in which the hit rays reach the place pass, and `segment_order`, the
    order in which the touched leaves reserve their segments."""
    leaf = np.where(leaf >= 0, np.minimum(leaf, m - 1), -1)
    count = np.bincount(leaf[leaf >= 0], minlength=m)
    cursor = np.zeros(m, np.int64)
    total = 0
    for l in segment_order:
        if count[l]:
            cursor[l] = total
            total += count[l]
    rays = np.full(total, -1, np.int64)
    for r in placement:
        if leaf[r] >= 0:
            rays[cursor[leaf[r]]] = r
            cursor[leaf[r]] += 1
    out = np.zeros((m, 7), np.float32)
    for l in range(m):
        seg = rays[cursor[l] - count[l]:cursor[l]]
        order = select_model(list(seg)) if count[l] <= SEG_SHORT else seg_sort_model(seg)
        s = np.zeros(7, np.float32)
        for r in order:
            s = s + cot[r]
        out[l] = s
    return out


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 17, 31, 32, 33, 100, 255, 257,
                               1000, 2048, 2049, 5000])
def test_sort_network_sorts_any_length(c):
    rng = np.random.default_rng(c)
    ids = rng.permutation(3 * c)[:c]
    np.testing.assert_array_equal(seg_sort_model(ids), np.sort(ids))
    np.testing.assert_array_equal(seg_sort_model(np.sort(ids)[::-1]), np.sort(ids))


@pytest.mark.parametrize("placement", ["ray order", "reversed", 1, 2, 3, 4])
def test_in_leaf_order_erases_the_placement_order(placement):
    rng = np.random.default_rng(77)
    n, m = 5000, 300
    leaf = rng.integers(-3, m + 3, n).astype(np.int32)       # misses, clamped ids
    leaf[rng.permutation(n)[:2300]] = 41                     # one long run
    leaf[rng.permutation(n)[:40]] = 5                        # one just over SEG_SHORT
    cot = rows_for(rng, n, with_negative_zero=True)
    if placement == "ray order":
        place, segs = np.arange(n), np.arange(m)
    elif placement == "reversed":
        place, segs = np.arange(n)[::-1], np.arange(m)[::-1]
    else:
        prng = np.random.default_rng(placement)
        place, segs = prng.permutation(n), prng.permutation(m)
    got = kernel_model(leaf, cot, m, place, segs)
    np.testing.assert_array_equal(bits(got), bits(serial(leaf, cot, m)))
    np.testing.assert_array_equal(bits(got), bits(port_sums(leaf, cot, m)))


def test_scratch_words_cover_the_kernels_layout():
    """count and cursor a leaf, two counters, a slot a ray, and at most
    n / (SEG_SHORT + 1) leaves can hold a run above SEG_SHORT."""
    n, m = 1 << 20, 1_062_524
    words = shade_cuda.segment_scratch_words(n, m)
    assert words == 2 * m + 2 + n + n // (SEG_SHORT + 1) + 1
    assert words * 4 < 16 << 20
    assert shade_cuda.segment_scratch_words(0, 1) == 5


def test_backward_takes_the_sort_free_form(monkeypatch):
    """``ShadeCuda.backward`` sums with ``segment_sum`` and sorts nothing."""
    calls = []
    real = shade_cuda.segment_sum
    monkeypatch.setattr(shade_cuda, "segment_sum",
                        lambda *a: calls.append("sum") or real(*a))
    monkeypatch.setattr(shade_cuda, "sort_by_leaf",
                        lambda *a: pytest.fail("the backward sorted the rays"))
    rng = np.random.default_rng(9)
    n, m = 64, 10
    hit_leaf = torch.from_numpy(rng.integers(-1, m, n).astype(np.int32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    params = [torch.from_numpy(rng.random(s, dtype=np.float32)).requires_grad_(True)
              for s in ((m, 3), (m, 3), (m,))]
    light = torch.tensor([-0.5, -1.0, -0.3])
    img = shade_cuda.ShadeCuda.apply(*params, hit_leaf, d, light, 1.3, 0.08, None)
    img.sum().backward()
    assert calls == ["sum"] and all(p.grad is not None for p in params)
