"""The port's SVO builder on the card (ops/octree_device.py), run on the CPU
through its kernels' plain versions, against the JAX package: its device
build (structure and parent pointers bitwise, albedo within 1e-5, normals
within 2e-3, the reference's own tolerances) and its host build (every
array byte-identical). The scene library of the kernels (csrc/scene.cuh),
compiled for the host, is held bitwise against the port's numpy scenes."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import raytracingtest_tpu as jrt
from raytracingtest_tpu.ops import octree_device as jax_device

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import octree, octree_cuda, octree_device
from raytracingtest_tpu_torch.scenes import SCENES, Scene, get_scene
from raytracingtest_tpu_torch.utils import opensimplex
from tests.test_torch_build import assert_svo_identical
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DEVICE_CASES = [("sphere", 5), ("terrain", 6), ("flat_ground", 5), ("sphere", 3)]
STRUCTURE = ("masks", "child_base", "leaf_base", "parent_ptr")


@pytest.fixture(scope="module")
def jax_device_builds():
    """The JAX device builds of DEVICE_CASES, made once (XLA compiles each
    level's programs)."""
    return {case: jax_device.build_svo_device(jrt.get_scene(case[0]), case[1])
            for case in DEVICE_CASES}


def build_cpu(name, depth, **kw):
    return build_cpu_scene(get_scene(name), depth, **kw)


def build_cpu_scene(scene, depth, **kw):
    return octree_device.build_svo_device(scene, depth, device="cpu", **kw)


@pytest.mark.parametrize("name,depth", DEVICE_CASES)
def test_matches_jax_device_build(name, depth, jax_device_builds):
    ours = build_cpu(name, depth)
    ref = jax_device_builds[(name, depth)]
    assert ours.level_start == ref.level_start and ours.depth == ref.depth
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(ours.leaf_albedo.numpy(),
                               np.asarray(ref.leaf_albedo), atol=1e-5)
    np.testing.assert_allclose(ours.leaf_normal.numpy(),
                               np.asarray(ref.leaf_normal), atol=2e-3)
    np.testing.assert_array_equal(ours.leaf_density.numpy(),
                                  np.asarray(ref.leaf_density))
    # against the host build: every array the same bytes
    assert_svo_identical(ours, jrt.build_svo(jrt.get_scene(name), depth).svo)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_every_scene_matches_jax_host_build(name):
    ours = build_cpu(name, 4)
    ref = jrt.build_svo(jrt.get_scene(name), 4).svo
    assert ours.n_leaves > 0
    assert_svo_identical(ours, ref)


def test_chunked_expansion_matches(monkeypatch):
    """Chunks of 512 parents (levels 4 to 6 of terrain at depth 6 take
    several): the same bits as the host build."""
    monkeypatch.setattr(octree_device, "CHUNK_PARENTS", 512)
    ours = build_cpu("terrain", 6)
    assert_svo_identical(ours, jrt.build_svo(jrt.get_scene("terrain"), 6).svo)


@pytest.mark.parametrize("name,depth,split", [("sphere", 5, 1), ("terrain", 6, 2)])
def test_split_build_matches_monolithic(name, depth, split):
    mono = build_cpu(name, depth)
    split_svo = octree_device.build_svo_device_split(
        get_scene(name), depth, split_level=split, device="cpu")
    assert_svo_identical(split_svo, mono)


def test_empty_world_keeps_a_root():
    empty = Scene("empty", lambda x, y, z: np.ones(np.shape(x), np.float32), 1.0)
    for svo in (build_cpu_scene(empty, 4),
                octree_device.build_svo_device_split(empty, 4, device="cpu")):
        assert svo.n_nodes == 1 and svo.n_leaves == 0
        assert svo.leaf_albedo.shape == svo.leaf_normal.shape == (0, 3)
        assert_svo_identical(svo, octree.build_svo(empty, 4).svo)


def test_rejects_bad_depth():
    with pytest.raises(ValueError):
        build_cpu("sphere", 0)
    with pytest.raises(ValueError):
        octree_device.build_svo_device_split(get_scene("sphere"), 2,
                                             split_level=2, device="cpu")


def test_keep_bounds_round_to_float32():
    # the host builder compares float32 f with float64 bounds that numpy
    # rounds to float32 first; the bounds are those float32 values
    scene = get_scene("terrain")
    rounded_up = 0
    for level in range(1, 11):
        hi, lo = octree_device.keep_bounds(scene.lipschitz, level, 10)
        assert hi == float(np.float32(hi)) and lo == float(np.float32(lo))
        r = float(np.sqrt(3.0)) * 2.0 ** -(level + 1)
        bound = scene.lipschitz * r + 1e-6
        f = np.array([hi, np.nextafter(np.float32(hi), np.float32(np.inf))],
                     np.float32)
        np.testing.assert_array_equal(f <= bound, [True, False])
        rounded_up += hi > bound
    assert rounded_up  # levels where a float64 comparison would part


def test_unknown_scene_raises_for_the_card():
    """The card evaluates scenes by id; a scene the library lacks raises
    before anything touches a device (so here, with no card)."""
    fake = Scene("terrain_but_not", get_scene("terrain").fn, 1.0)
    with pytest.raises(ValueError, match="no scene"):
        octree_cuda.device_scene(fake, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="no scene"):
        octree_device.build_svo_device(fake, 4, device="cuda")
    # on the CPU any scene builds, through the plain versions
    assert build_cpu_scene(fake, 3).n_leaves > 0


def test_scene_ids_are_the_librarys():
    with open(f"{_build._CSRC}/scene.cuh") as f:
        text = f.read()
    enum = dict((name.lower(), int(v)) for name, v in
                re.findall(r"^\s+([A-Z_]+) = (\d+),", text, re.M))
    assert enum.pop("n_scenes") == len(SCENES)
    assert enum == octree_cuda.SCENE_IDS
    assert sorted(enum) == sorted(SCENES)


def test_plain_versions_count_as_the_kernels_do():
    """Each plain version returns what its kernel's wrapper does: the
    blocks' counts of 256 rows, ranks in order, BIG for no child."""
    rng = np.random.default_rng(5)
    flags = torch.from_numpy((rng.random(1000) < 0.3).astype(np.uint8))
    counts = octree_cuda.count(flags)
    assert counts.shape == (4,) and counts.dtype == torch.int32
    assert int(counts.sum()) == int(flags.sum())
    np.testing.assert_array_equal(
        counts.numpy(), [int(flags[i:i + 256].sum()) for i in range(0, 1000, 256)])
    src = torch.from_numpy(rng.integers(0, 100, (1000, 3)).astype(np.int32))
    base = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rows, words = octree_cuda.compact(flags, base, int(flags.sum()), src)
    np.testing.assert_array_equal(rows.numpy(), np.flatnonzero(flags.numpy()))
    assert torch.equal(words, src[rows.long()])
    # three parents; children of parent 0 and 2 survive, parent 1 none
    par = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int32)
    slot = torch.tensor([1, 5, 0, 0, 3, 7], dtype=torch.int32)
    rows = torch.tensor([0, 1, 4, 5], dtype=torch.int32)
    rec, surv = octree_cuda.level_up_serial(rows, par, slot, 3)
    assert rec.tolist() == [[0b100010, 0], [0, octree_cuda.BIG], [0b10001000, 2]]
    assert surv.tolist() == [1, 0, 1]
    # the one pass: the surviving parents alone, at their ranks
    out = octree_cuda.level_up(rows, par * 8 + slot, 3)
    assert out.masks[:2].tolist() == [0b100010, 0b10001000]
    assert out.first[:2].tolist() == [0, 2]
    assert out.below[:2].tolist() == [0, 2]
    assert out.ranks.tolist() == [0, 0, 1, 1] and out.count.tolist() == [2]


def _host_scene_library(tmp_path):
    """csrc/scene.cuh compiled for the host with g++ (no contraction, as
    nvcc's --fmad=false): scene::eval and scene::sampler_normal over
    arrays."""
    src = tmp_path / "scene_host.cpp"
    src.write_text(
        "#include <math.h>\n#include <stdint.h>\n"
        "#define __device__\n#define __forceinline__ inline\n"
        "#define __noinline__ __attribute__((noinline))\n"
        f'#include "{_build._CSRC}/scene.cuh"\n'
        "#define ARGS int id, const float* x, const float* y, const float* z, "
        "long n, const long long* p, const long long* p3, const double* d, "
        "const long long* sb, const double* g, float* out\n"
        'extern "C" void eval_n(ARGS) { scene::Tables t{p, p3, d, sb, g};\n'
        "  for (long i = 0; i < n; ++i) out[i] = scene::eval(id, x[i], y[i], z[i], t); }\n"
        'extern "C" void normal_n(ARGS) { scene::Tables t{p, p3, d, sb, g};\n'
        "  for (long i = 0; i < n; ++i)\n"
        "    scene::sampler_normal(id, x[i], y[i], z[i], t, out + 3 * i); }\n")
    so = tmp_path / "scene_host.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_scene_library_matches_host_scenes_bitwise(tmp_path):
    """Every scene's f, and every scene's normal, from scene.cuh's own
    arithmetic equal the port's host path bit for bit: at dyadic centres
    and random points, in one batch above the native noise's threshold and
    in small ones below it."""
    lib = _host_scene_library(tmp_path)
    noise = opensimplex.OpenSimplex3D(7)
    tables = [np.ascontiguousarray(a) for a in (
        noise.perm, noise.perm3d, opensimplex._LUT_D_COLS,
        opensimplex._LUT_SB_COLS, opensimplex.GRADIENTS_3D.reshape(-1))]
    rng = np.random.default_rng(6)
    n = 20000
    dyadic = (rng.integers(0, 1024, (3, n)).astype(np.float32)
              + np.float32(0.5)) * np.float32(2.0 ** -10)
    random = rng.random((3, n), dtype=np.float32) * np.float32(1.2) - np.float32(0.1)

    def call(fn, sid, pts, width):
        out = np.empty((pts.shape[1], width), np.float32)
        ptrs = [np.ascontiguousarray(c).ctypes.data_as(ctypes.c_void_p) for c in pts]
        getattr(lib, fn)(sid, *ptrs, ctypes.c_long(pts.shape[1]),
                         *(t.ctypes.data_as(ctypes.c_void_p) for t in tables),
                         out.ctypes.data_as(ctypes.c_void_p))
        return out

    for name, scene in SCENES.items():
        sid = octree_cuda.SCENE_IDS[name]
        for pts in (dyadic, random):
            f = call("eval_n", sid, pts, 1)[:, 0]
            whole = np.asarray(scene(*pts), np.float32)
            small = np.concatenate([np.asarray(scene(*pts[:, i:i + 1000]), np.float32)
                                    for i in range(0, n, 1000)])
            assert f.tobytes() == whole.tobytes() == small.tobytes(), name
            m = 2000
            nrm = call("normal_n", sid, pts[:, :m], 3)
            ref = octree.sampler_normal(scene, *pts[:, :m]).astype(np.float32)
            assert nrm.tobytes() == ref.tobytes(), name


class _Declared:
    """Stands in for the loaded library: records what _declare_svo sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def test_c_entries_are_declared_with_their_arity():
    """Every C entry point of svo_build.cu has ctypes argument types of its
    own length (the stream included) and a wrapper's Kernel."""
    with open(f"{_build._CSRC}/svo_build.cu") as f:
        src = f.read()
    arity = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
             for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S)}
    assert set(arity) == set(octree_cuda.launches)
    lib = _Declared()
    _build._declare_svo(lib)
    assert set(lib.fns) == set(arity)
    for name, n_args in arity.items():
        assert len(lib.fns[name].argtypes) == n_args, name
    kernels = {v.name for v in vars(octree_cuda).values()
               if isinstance(v, octree_cuda.Kernel)}
    assert kernels == set(arity)
