"""The leaf test's redesign (kernel ``svo_leaves``, ops/octree_cuda.py) on
the CPU: the premise it rests on, in the reference's own arithmetic, and a
plain model of its neighbour lookup against brute force.

At the finest level every probe px +- fin of a candidate is bit for bit the
centre of its face neighbour c +- 1, and the expansion of the last level
recorded the scene there for every child of a kept parent, kept or not. The
kernel reads those values instead of evaluating the scene: a sibling by its
slot, a child of another kept parent through a search over the kept
parents (Morton order), and evaluates only where no kept parent covers the
probe. The scene values are the JAX package's scenes on their numpy host
path, which the port's host build is already held to byte for byte.
"""

import numpy as np
import pytest
import torch

import raytracingtest_tpu as jrt

from raytracingtest_tpu_torch.ops import octree, octree_cuda, octree_device
from raytracingtest_tpu_torch.scenes import get_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# the scenes of the card's library, at depths 5 and 6
SCENE_CASES = [(name, 5 if name.endswith("_ref") or name == "perlin" else 6)
               for name in sorted(octree_cuda.SCENE_IDS)]
# an octant build: the octant (1, 0, 0) at level 1 of terrain, to depth 6
OCTANT = dict(name="terrain", depth=6, root_level=1, root_coord=(1, 0, 0))


def leaf_call(name, depth, **kw):
    """The arguments of the leaf test of a CPU device build: (rec, par,
    parents, full)."""
    got = {}
    leaves = octree_cuda.leaves

    def recording(ds, rec, d, par, parents, full, **k):
        got.update(rec=rec, par=par, parents=parents, full=full)
        return leaves(ds, rec, d, par, parents, full, **k)

    octree_cuda.leaves = recording
    try:
        octree_device.build_svo_device(get_scene(name), depth, device="cpu", **kw)
    finally:
        octree_cuda.leaves = leaves
    return got["rec"], got["par"], got["parents"], got["full"]


@pytest.fixture(scope="module")
def calls():
    out = {(name, depth): leaf_call(name, depth) for name, depth in SCENE_CASES}
    out["octant"] = leaf_call(OCTANT["name"], OCTANT["depth"],
                              root_level=OCTANT["root_level"],
                              root_coord=OCTANT["root_coord"])
    return out


CASES = SCENE_CASES + [("octant", OCTANT["depth"])]


def _key(name, depth):
    return "octant" if name == "octant" else (name, depth)


def _scene(name):
    return jrt.get_scene(OCTANT["name"] if name == "octant" else name)


def brute_sources(rec, parents, depth):
    """Every probe's row among the last level's children by a dictionary of
    all of them (coordinates -> row), -1 where none is there."""
    pc = parents[:, :3].numpy().astype(np.int64)
    rows = {}
    for q in range(pc.shape[0]):
        for s in range(8):
            child = pc[q] * 2 + octree.CHILD_OFFSETS[s]
            rows[tuple(child)] = 8 * q + s
    c = rec[:, :3].numpy().astype(np.int64)
    src = np.full((c.shape[0], 6), -1, np.int64)
    for k, (a, sgn) in enumerate(octree_cuda.PROBES):
        nb = c.copy()
        nb[:, a] += sgn
        for i in range(c.shape[0]):
            src[i, k] = rows.get(tuple(nb[i]), -1)
    return src


def morton_less(a, b):
    """csrc/svo_build.cu's morton_less: the axis of the highest differing
    bit decides, z before y before x on a tie."""
    dx, dy, dz = (int(a[i]) ^ int(b[i]) for i in range(3))
    axis, m = 2, dz
    if m < dy and m < (m ^ dy):
        axis, m = 1, dy
    if m < dx and m < (m ^ dx):
        axis = 0
    return a[axis] < b[axis]


def find_parent(parents, p, q, forward):
    """csrc/svo_build.cu's find_parent: the galloping search from row p
    for the parent at q, or -1."""
    n = len(parents)
    before = lambda row: morton_less(parents[row], q)
    after = lambda row: morton_less(q, parents[row])
    if forward:
        lo, hi, step = p, p + 1, 1
        while hi < n and before(hi):
            lo, step = hi, step * 2
            hi = p + step
        hi = min(hi, n)
        while hi - lo > 1:
            mid = lo + (hi - lo) // 2
            lo, hi = (mid, hi) if before(mid) else (lo, mid)
        return hi if hi < n and not after(hi) else -1
    hi, lo, step = p, p - 1, 1
    while lo >= 0 and after(lo):
        hi, step = lo, step * 2
        lo = p - step
    lo = max(lo, -1)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        hi, lo = (mid, lo) if after(mid) else (hi, mid)
    return lo if lo >= 0 and not before(lo) else -1


def neighbour_table(parents, depth):
    """svo_leaf_neighbours_kernel in numpy: a table of -1, then each kept
    parent's three + face neighbours by find_parent from its own row, each
    found one given this parent as its - neighbour along the same axis."""
    pc = [tuple(r) for r in parents[:, :3].numpy().astype(np.int64)]
    table = np.full((len(pc), 6), -1, np.int64)
    for p, c in enumerate(pc):
        for a in range(3):
            q = list(c)
            q[a] += 1
            if q[a] < (1 << (depth - 1)):
                row = find_parent(pc, p, tuple(q), True)
                if row >= 0:
                    assert table[row, 2 * a + 1] == -1  # one writer
                    table[p, 2 * a], table[row, 2 * a + 1] = row, p
    return table


def kernel_sources(rec, par, parents, depth):
    """The kernel's lookup, probe by probe, in numpy: a sibling at slot s ^
    2^a, a crossing probe through the neighbour table, -1 where the table
    has no parent (outside the world, or none kept)."""
    table = neighbour_table(parents, depth)
    c = rec[:, :3].numpy().astype(np.int64)
    own = par.numpy()
    src = np.full((c.shape[0], 6), -1, np.int64)
    for i in range(c.shape[0]):
        s = int((c[i, 0] & 1) | ((c[i, 1] & 1) << 1) | ((c[i, 2] & 1) << 2))
        for k, (a, sgn) in enumerate(octree_cuda.PROBES):
            up = (s >> a) & 1
            if (sgn > 0) != bool(up):  # stays inside the parent
                src[i, k] = 8 * own[i] + (s ^ (1 << a))
                continue
            row = table[own[i], 2 * a + (0 if up else 1)]
            if row >= 0:
                src[i, k] = 8 * row + (s ^ (1 << a))
    return src


@pytest.mark.parametrize("name,depth", CASES)
def test_probes_are_the_neighbours_centres_and_the_expansion_recorded_them(
        name, depth, calls):
    """(a) Every probe point of a candidate equals the centre of its face
    neighbour bit for bit, and where that neighbour is a child of a kept
    parent, the f the expansion recorded for it is the reference scene's
    value at the probe, bit for bit."""
    rec, par, parents, full = calls[_key(name, depth)]
    fin = np.float32(2.0 ** -depth)
    solid = rec[:, 3].contiguous().view(torch.float32) <= 0
    r = rec[solid]
    probes = octree_cuda._probe_points(r, fin).reshape(3, 6, -1)
    c = r[:, :3].numpy().astype(np.int64)
    for k, (a, sgn) in enumerate(octree_cuda.PROBES):
        nb = c.copy()
        nb[:, a] += sgn
        centre = (nb.astype(np.float32) + np.float32(0.5)) * fin
        assert probes[:, k].T.tobytes() == centre.astype(np.float32).tobytes()
    src, _kind = octree_cuda.leaf_probe_sources(rec, par, parents, depth)
    src = src[solid].T.numpy()  # (6, m)
    cov = src >= 0
    assert cov.any()
    f_ref = np.asarray(_scene(name)(probes[0][cov], probes[1][cov], probes[2][cov]),
                       np.float32)
    f_rec = full[:, 3].contiguous().view(torch.float32).numpy()[src[cov]]
    assert f_rec.tobytes() == f_ref.tobytes()


@pytest.mark.parametrize("name,depth", CASES)
def test_lookup_matches_brute_force(name, depth, calls):
    """(b) The plain model of the lookup (``leaf_probe_sources``) and a
    probe-by-probe model of the kernel's (sibling by slot, the neighbour
    table of galloping searches, or evaluate) give the row a dictionary of
    every child of a kept
    parent gives, -1 (evaluate) for a probe no kept parent covers: outside
    the world, outside the octant, or under a pruned parent."""
    rec, par, parents, _full = calls[_key(name, depth)]
    want = brute_sources(rec, parents, depth)
    src, kind = octree_cuda.leaf_probe_sources(rec, par, parents, depth)
    np.testing.assert_array_equal(src.numpy(), want)
    kind = kind.numpy()
    assert ((kind == octree_cuda.EVALUATE) == (want < 0)).all()
    own_block = (want >> 3) == par.numpy()[:, None]
    assert ((kind == octree_cuda.SIBLING) == (own_block & (want >= 0))).all()
    # the kernel's search, on a sample of the candidates (every one at
    # depth 5)
    step = max(1, rec.shape[0] // 4000)
    np.testing.assert_array_equal(
        kernel_sources(rec[::step], par[::step], parents, depth), want[::step])


def test_lookup_covers_most_probes_and_every_kind_occurs(calls):
    """The cases hold every kind of probe: siblings, children of other kept
    parents, and probes left to the scene outside the world (terrain),
    under a pruned parent inside it (the sphere) and outside an octant
    build's octant."""
    rec, par, parents, _full = calls[("terrain", 6)]
    _src, kind = octree_cuda.leaf_probe_sources(rec, par, parents, 6)
    solid = rec[:, 3].contiguous().view(torch.float32) <= 0
    ks = kind[solid]
    for k in (octree_cuda.SIBLING, octree_cuda.COUSIN, octree_cuda.EVALUATE):
        assert int((ks == k).sum()) > 0
    assert float((ks != octree_cuda.EVALUATE).float().mean()) > 0.95
    c = rec[:, :3].to(torch.int64)
    out_world = torch.stack([(c[:, a] + s < 0) | (c[:, a] + s >= 64)
                             for a, s in octree_cuda.PROBES], 1)
    assert bool(out_world.any())
    assert bool((kind[out_world] == octree_cuda.EVALUATE).all())
    # the sphere's shell: probes of solid candidates under a pruned parent,
    # inside the world
    rec, par, parents, _full = calls[("sphere", 6)]
    _src, kind = octree_cuda.leaf_probe_sources(rec, par, parents, 6)
    c = rec[:, :3].to(torch.int64)
    inside = torch.stack([(c[:, a] + s >= 0) & (c[:, a] + s < 64)
                          for a, s in octree_cuda.PROBES], 1)
    solid = rec[:, 3].contiguous().view(torch.float32) <= 0
    assert bool(((kind == octree_cuda.EVALUATE) & inside)[solid].any())
    # the octant's candidates: probes past the octant's faces, inside the
    # world, are evaluated
    rec, par, parents, _full = calls["octant"]
    _src, kind = octree_cuda.leaf_probe_sources(rec, par, parents, OCTANT["depth"])
    c = rec[:, :3].to(torch.int64)
    lo = np.array(OCTANT["root_coord"]) << (OCTANT["depth"] - OCTANT["root_level"])
    size = 1 << (OCTANT["depth"] - OCTANT["root_level"])
    past = torch.stack([((c[:, a] + s < int(lo[a])) | (c[:, a] + s >= int(lo[a]) + size))
                        & (c[:, a] + s >= 0) & (c[:, a] + s < 64)
                        for a, s in octree_cuda.PROBES], 1)
    assert bool(past.any())
    assert bool((kind[past] == octree_cuda.EVALUATE).all())


@pytest.mark.parametrize("name,depth", [("terrain", 6), ("sphere", 6), ("octant", 6)])
def test_plain_leaf_test_and_dense_attributes_match_the_first_form(name, depth, calls):
    """The plain versions of the two passes (``leaves_plain``, then
    ``leaf_attrs_plain`` over the compacted leaves) give the first form's
    plain version's flags, counts and attributes at the leaves' rows."""
    rec, par, parents, full = calls[_key(name, depth)]
    scene = get_scene(OCTANT["name"] if name == "octant" else name)
    survive, counts = octree_cuda.leaves_plain(scene, rec, depth, par, parents, full)
    first = octree_cuda.leaves_serial_plain(scene, rec, depth)
    assert torch.equal(survive, first[0]) and torch.equal(counts, first[2])
    rows = torch.nonzero(survive).reshape(-1)
    assert rows.numel() > 0
    dense = octree_cuda.leaf_attrs_plain(scene, rec[rows], depth)
    assert dense.numpy().tobytes() == first[1][rows].numpy().tobytes()
    assert not bool(first[1][survive == 0].any())
