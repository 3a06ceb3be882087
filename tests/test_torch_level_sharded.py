"""The level-sharded octree: ``parallel/level_sharded.py`` against the JAX
package's.

The host part (``extract_subtree``, ``split_svo``) must give the
reference's arrays byte for byte for 1, 2, 4 and 8 arenas. The sharded
trace (K10b, rays replicated) and the exchange trace (K10c, rays sharded)
run in a world of one in this process and in gloo worlds of 2 and 4 spawned
ranks (``tests/torch_ranks.py``, one spawn a world size), on CPU tensors,
where kernel ``level_round``'s wrapper runs its plain version. The
reference runs on a mesh of as many of conftest's CPU devices. Tolerances:
leaves, owners, truncation and per-rank traced counts exactly; t to rtol
1e-5 / atol 1e-6 (F14: XLA contracts multiply-adds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingtest_tpu.ops import octree as jax_octree
from raytracingtest_tpu.ops import traverse as jax_traverse
from raytracingtest_tpu.parallel import level_sharded as jax_ls
from raytracingtest_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracingtest_tpu.scenes import get_scene as jax_get_scene

from raytracingtest_tpu_torch.ops import octree, traverse
from raytracingtest_tpu_torch.ops.octree import SVO
from raytracingtest_tpu_torch.parallel import level_sharded
from raytracingtest_tpu_torch.scenes import get_scene
from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_traverse import random_rays

WORLDS = (1, 2, 4)
T_TOL = dict(rtol=1e-5, atol=1e-6)
HOT_ROUNDS = (1, 80)


def grazing_rays(n=128):
    """The reference's adversarial rays: nearly tangent to the sphere's
    shell, so they cross a long run of occupied octants before a hit."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    o = np.stack([0.5 + 0.49 * np.cos(ang), np.full(n, 0.5),
                  0.5 + 0.49 * np.sin(ang)], 1).astype(np.float32)
    tangent = np.stack([-np.sin(ang), np.zeros(n), np.cos(ang)], 1)
    inward = np.stack([0.5 - o[:, 0], np.zeros(n), 0.5 - o[:, 2]], 1)
    inward /= np.linalg.norm(inward, axis=1, keepdims=True)
    d = (tangent + 1.45 * inward).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def hotspot_rays(n=512):
    """The reference's hotspot: every ray enters through one octant."""
    rng = np.random.default_rng(5)
    o = np.tile(np.asarray([[1.4, 0.5, 0.5]], np.float32), (n, 1))
    aim = np.asarray([0.85, 0.5, 0.5], np.float32)
    d = aim[None, :] - o + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


RAND = random_rays(256, seed=7)
GRAZE = grazing_rays()
RAYS = tuple(np.concatenate([a, b]) for a, b in zip(RAND, GRAZE))
HOT = hotspot_rays()


@pytest.fixture(scope="module")
def builds():
    return (jax_octree.build_svo(jax_get_scene("sphere"), 6),
            octree.build_svo(get_scene("sphere"), 6))


@pytest.fixture(scope="module")
def ours():
    """Every world's results of the port (one spawn a world size)."""
    inputs = {"rays": RAYS, "hot": HOT, "hot_rounds": list(HOT_ROUNDS)}
    return {w: torch_ranks.run(w, "level_sharded", inputs) for w in WORLDS}


def _ref_args(ls, o, d, leaf_off=True):
    arrays = [ls.trunk_masks, ls.trunk_child, ls.trunk_leaf, ls.octant_owner,
              ls.octant_root] + ([ls.octant_leaf_off] if leaf_off else []) + [
        ls.octant_origin, ls.arena_masks, ls.arena_child, ls.arena_leaf, o, d]
    return tuple(jnp.asarray(a) for a in arrays)


def ref_trace(builds, n, o, d, max_octants=None):
    ls = jax_ls.split_svo(builds[0], 2, n)
    fn = jax_ls.make_sharded_trace(jax_make_mesh(n), ls, max_octants=max_octants)
    return tuple(np.asarray(a) for a in jax.jit(fn)(*_ref_args(ls, o, d)))


def ref_exchange(builds, n, o, d, max_rounds, cap_factor):
    ls = jax_ls.split_svo(builds[0], 2, n)
    fn = jax_ls.make_exchange_trace(jax_make_mesh(n), ls, max_rounds=max_rounds,
                                    cap_factor=cap_factor)
    return tuple(np.asarray(a) for a in jax.jit(fn)(*_ref_args(ls, o, d, False)))


def assert_trace_equal(got, ref):
    """(leaf, t, owner, truncated): all exact but t, to F14."""
    leaf, t, owner, trunc = got
    np.testing.assert_array_equal(leaf, ref[0])
    np.testing.assert_array_equal(owner, ref[2])
    np.testing.assert_array_equal(trunc, ref[3])
    hit = leaf >= 0
    np.testing.assert_allclose(t[hit], ref[1][hit], **T_TOL)


def assert_fields_identical(ours, ref):
    for name in ref.__dataclass_fields__:
        a, b = getattr(ours, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        else:
            assert a == b, name


def test_extract_subtree_matches_reference(builds):
    ref_svo, ours_svo = builds[0].svo, builds[1].svo
    level = 2
    for i in range(ref_svo.level_start[level + 1] - ref_svo.level_start[level]):
        a = level_sharded.extract_subtree(ours_svo, level, i)
        b = jax_ls.extract_subtree(ref_svo, level, i)
        for name in ("masks", "child_base", "leaf_base", "leaf_albedo",
                     "leaf_normal", "leaf_density"):
            x, y = getattr(a, name).numpy(), np.asarray(getattr(b, name))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (i, name)
        assert a.depth == b.depth and a.level_start == b.level_start


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_split_svo_matches_reference(builds, n_devices):
    ref = jax_ls.split_svo(builds[0], 2, n_devices)
    # from the BuildResult's coordinates, and derived from the bare tree
    assert_fields_identical(level_sharded.split_svo(builds[1], 2, n_devices), ref)
    assert_fields_identical(level_sharded.split_svo(builds[1].svo, 2, n_devices), ref)


def test_extract_subtree_traces_identically(builds):
    """Rays aimed at an octant hit the same voxel at the same t through its
    extracted subtree (octant-local, t scaled) as through the whole tree."""
    svo, res = builds[1].svo, builds[1]
    level, size = 2, 0.25
    checked = 0
    for i in range(svo.level_start[level + 1] - svo.level_start[level]):
        sub = level_sharded.extract_subtree(svo, level, i)
        if sub.n_leaves == 0:
            continue
        org = res.node_coords[level][i].astype(np.float32) * size
        o, d = random_rays(64, seed=i, toward=tuple(org + size / 2), spread=size / 6)
        r_sub = traverse.trace_stackless(sub, torch.from_numpy((o - org) / size),
                                         torch.from_numpy(d))
        r_full = traverse.trace_stackless(svo, torch.from_numpy(o), torch.from_numpy(d))
        t_full = r_full.hit_t.numpy()
        p = o + t_full[:, None] * d
        in_oct = np.all((p >= org - 1e-5) & (p <= org + size + 1e-5), axis=1)
        both = (r_full.hit_leaf >= 0).numpy() & (r_sub.hit_leaf >= 0).numpy() & in_oct
        if both.sum() == 0:
            continue
        np.testing.assert_allclose(r_sub.hit_t.numpy()[both] * size, t_full[both],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(
            sub.leaf_albedo.numpy()[r_sub.hit_leaf.numpy()[both]],
            svo.leaf_albedo.numpy()[r_full.hit_leaf.numpy()[both]])
        checked += 1
    assert checked >= 4


def test_split_trunk_hits_octants(builds):
    """The trunk's leaves are the octants: a trunk hit lies in its octant."""
    ls = level_sharded.split_svo(builds[1], 2, 8)
    n_oct = len(ls.octant_root)
    trunk = SVO(masks=torch.from_numpy(ls.trunk_masks),
                child_base=torch.from_numpy(ls.trunk_child),
                leaf_base=torch.from_numpy(ls.trunk_leaf),
                leaf_albedo=torch.zeros(n_oct, 3), leaf_normal=torch.zeros(n_oct, 3),
                leaf_density=torch.ones(n_oct), depth=ls.trunk_depth,
                level_start=ls.trunk_level_start)
    o, d = random_rays(200, seed=3)
    r = traverse.trace_stackless(trunk, torch.from_numpy(o), torch.from_numpy(d))
    leaf, t = r.hit_leaf.numpy(), r.hit_t.numpy()
    hit = leaf >= 0
    assert hit.sum() > 100 and leaf[hit].max() < len(ls.octant_root)
    p = o + t[:, None] * d
    org = ls.octant_origin[np.where(hit, leaf, 0)]
    inside = np.all((p >= org - 1e-4) & (p <= org + ls.octant_size + 1e-4), axis=1)
    assert inside[hit].all()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_trace_matches_reference(builds, ours, world):
    """Random and grazing rays: every rank's all-reduced answer is the
    reference's at the same device count, with no ray truncated."""
    ref = ref_trace(builds, world, *RAYS)
    assert not ref[3].any()
    for r in ours[world]:
        assert_trace_equal(r["trace"], ref)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_trace_truncation_matches_reference(builds, ours, world):
    """With max_octants=2 the rays still pending are flagged, the same ones
    as the reference's."""
    ref = ref_trace(builds, world, *RAYS, max_octants=2)
    assert ref[3].any()
    for r in ours[world]:
        assert_trace_equal(r["capped"], ref)


@pytest.mark.parametrize("world", WORLDS)
def test_grazing_ray_many_octants_no_silent_loss(ours, world):
    """The grazing rays cross many octants; the provable bound resolves
    every one, and the hits are the direct trace's (the numpy oracle)."""
    from raytracingtest_tpu.ops.octree import build_svo as jax_build

    leaf, t, _owner, trunc = (a[len(RAND[0]):] for a in ours[world][0]["trace"])
    assert not trunc.any()
    ref = jax_traverse.trace_numpy(jax_build(jax_get_scene("sphere"), 6).svo, *GRAZE)
    hit = ref.hit_leaf >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(hit, leaf >= 0)
    np.testing.assert_allclose(t[hit], ref.hit_t[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("max_rounds", HOT_ROUNDS)
def test_exchange_hotspot_truncation_is_flagged(builds, ours, world, max_rounds):
    """Every ray enters through one octant, with a per-peer cap of 1 x the
    fair share: a starved run (one round) flags the rays it could not
    serve, never a silent miss, with the reference's counts; a generous one
    resolves them all."""
    ref = ref_exchange(builds, world, *HOT, max_rounds=max_rounds, cap_factor=1)
    got = [np.concatenate([r[f"hot{max_rounds}"][k] for r in ours[world]])
           for k in range(5)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])   # traced, per rank
    np.testing.assert_array_equal(got[4], ref[4])
    hit = got[0] >= 0
    np.testing.assert_allclose(got[1][hit], ref[1][hit], **T_TOL)
    oracle = jax_traverse.trace_numpy(builds[0].svo, *HOT).hit_leaf >= 0
    assert not (oracle & ~hit & ~got[4]).any()
    if max_rounds == 1:
        assert got[4].any()
    else:
        assert not got[4].any()
        np.testing.assert_array_equal(oracle, hit)
