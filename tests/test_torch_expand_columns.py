"""The device build's expansion over a heightfield's columns (svo_columns,
svo_expand; ops/octree_cuda.py ``columns``, ``expand``), on the CPU.

A heightfield's f is y - h(x, z), so the expansion evaluates h once a child
column and forms y - h a child. Three things hold that up: scene.cuh's
``height`` with the ``y -`` step gives scene::eval's bits, the host scenes'
and the JAX package's ``_expand_eval``'s (the last run without FMA
instructions, ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, as the card runs without
contraction); the column square of a whole build and of an octant build
is the root cell's columns and holds every child column of the level's
parents (all of it, in a whole build of a heightfield); and
``HEIGHTFIELDS`` names exactly the scenes of that form."""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import octree_cuda, octree_device
from raytracingtest_tpu_torch.ops.octree import CHILD_OFFSETS
from raytracingtest_tpu_torch.scenes import SCENES, get_scene
from raytracingtest_tpu_torch.utils import opensimplex
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LEVELS = range(1, 13)
PARENTS = 512  # parents a level (all of them below level 5)
ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def level_parents(level):
    """The parents (coordinates at level - 1) whose children the checks
    take: every cell up to 512, else 512 drawn from a seed."""
    cells = 1 << (level - 1)
    if cells ** 3 <= PARENTS:
        g = np.arange(cells, dtype=np.int32)
        return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(level)
    return rng.integers(0, cells, (PARENTS, 3)).astype(np.int32)


_JAX_EXPAND = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
import raytracingtest_tpu as jrt
from raytracingtest_tpu.ops.octree_device import _expand_eval
from tests.test_torch_expand_columns import LEVELS, level_parents
out = {}
for name in json.loads(sys.argv[1]):
    scene = jrt.get_scene(name)
    for level in LEVELS:
        cc = level_parents(level)
        child, _keep, f = _expand_eval(jnp.asarray(cc), jnp.ones(cc.shape[0], bool),
                                       scene=scene, level=level, depth=level,
                                       lipschitz=float(scene.lipschitz))
        out[f"{name} {level}"] = [np.asarray(child).tolist(),
                                  np.asarray(f, np.float32).view(np.int32).tolist()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_expansions():
    """``_expand_eval``'s children and f bits for each heightfield and level,
    from a JAX process without FMA instructions."""
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_EXPAND, json.dumps(octree_cuda.HEIGHTFIELDS)],
        cwd=ROOT_DIR, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def scene_lib(tmp_path_factory):
    """csrc/scene.cuh compiled for the host with g++ (no contraction, as
    nvcc's --fmad=false): scene::eval and scene::height over arrays."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("scene_columns")
    src = tmp / "scene_columns.cpp"
    src.write_text(
        "#include <math.h>\n#include <stdint.h>\n"
        "#define __device__\n#define __forceinline__ inline\n"
        "#define __noinline__ __attribute__((noinline))\n"
        f'#include "{_build._CSRC}/scene.cuh"\n'
        'extern "C" void eval_n(int id, const float* x, const float* y, const float* z,\n'
        "    long n, const long long* p, const long long* p3, const double* d,\n"
        "    const long long* sb, const double* g, float* out) {\n"
        "  scene::Tables t{p, p3, d, sb, g};\n"
        "  for (long i = 0; i < n; ++i) out[i] = scene::eval(id, x[i], y[i], z[i], t); }\n"
        'extern "C" void height_n(int id, const float* x, const float* z, long n,\n'
        "    float* out) {\n"
        "  for (long i = 0; i < n; ++i) out[i] = scene::height(id, x[i], z[i]); }\n")
    so = tmp / "scene_columns.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)


def lib_eval(lib, sid, px, py, pz):
    noise = opensimplex.OpenSimplex3D(7)
    tables = [np.ascontiguousarray(a) for a in (
        noise.perm, noise.perm3d, opensimplex._LUT_D_COLS,
        opensimplex._LUT_SB_COLS, opensimplex.GRADIENTS_3D.reshape(-1))]
    out = np.empty(px.shape[0], np.float32)
    lib.eval_n(sid, _ptr(px), _ptr(py), _ptr(pz), ctypes.c_long(px.shape[0]),
               *(_ptr(t) for t in tables), _ptr(out))
    return out


def lib_height(lib, sid, px, pz):
    out = np.empty(px.shape[0], np.float32)
    lib.height_n(sid, _ptr(px), _ptr(pz), ctypes.c_long(px.shape[0]), _ptr(out))
    return out


@pytest.mark.parametrize("name", octree_cuda.HEIGHTFIELDS)
def test_y_minus_height_is_every_evaluation_bitwise(name, scene_lib, jax_expansions):
    """y - height(x, z) at the children of each level 1-12 (dyadic centres)
    equals scene::eval, the port's host scene and the JAX package's
    ``_expand_eval`` bit for bit, with the children in the reference's
    order."""
    sid = octree_cuda.SCENE_IDS[name]
    for level in LEVELS:
        cc = level_parents(level)
        child = (cc[:, None, :] * 2 + CHILD_OFFSETS[None]).reshape(-1, 3)
        ref_child, ref_bits = jax_expansions[f"{name} {level}"]
        np.testing.assert_array_equal(child, np.asarray(ref_child))
        scale = np.float32(2.0 ** -level)
        px, py, pz = ((child[:, a].astype(np.float32) + np.float32(0.5)) * scale
                      for a in range(3))
        split = py - lib_height(scene_lib, sid, px, pz)
        want = np.asarray(ref_bits, np.int32)
        for got, what in ((split, "y - height"),
                          (lib_eval(scene_lib, sid, px, py, pz), "scene::eval"),
                          (np.asarray(get_scene(name)(px, py, pz), np.float32),
                           "the host scene")):
            assert np.array_equal(got.view(np.int32), want), (name, level, what)


def test_column_plain_height_is_the_librarys(scene_lib):
    """``columns_plain``'s h (the host scene at y = 0, negated) equals
    scene.cuh's height bit for bit over a level-9 square."""
    for name in octree_cuda.HEIGHTFIELDS:
        level = 9
        cols = octree_cuda.columns_plain(get_scene(name), level,
                                         octree_cuda.column_square(level), "cpu")
        j = np.arange(cols.side ** 2)
        scale = np.float32(2.0 ** -level)
        px = ((j % cols.side).astype(np.float32) + np.float32(0.5)) * scale
        pz = ((j // cols.side).astype(np.float32) + np.float32(0.5)) * scale
        want = lib_height(scene_lib, octree_cuda.SCENE_IDS[name], px, pz)
        assert np.array_equal(cols.h.numpy().view(np.int32), want.view(np.int32)), name


def recorded_expansions(monkeypatch, scene, depth, **kw):
    """A CPU device build of `scene`; each level's expansion: (parents,
    level, its column table)."""
    calls = []
    real = octree_cuda.expand

    def recording(ds, parents, level, hi, lo, cols=None):
        calls.append((parents, level, cols))
        return real(ds, parents, level, hi, lo, cols)
    monkeypatch.setattr(octree_cuda, "expand", recording)
    svo = octree_device.build_svo_device(scene, depth, device="cpu", **kw)
    return svo, calls


def child_columns(parents):
    """The set of child columns (x, z) of (n, 4) parent records."""
    p = parents[:, :3].numpy().astype(np.int64)
    return {(2 * x + bx, 2 * z + bz) for x, _, z in p for bx in (0, 1) for bz in (0, 1)}


@pytest.mark.parametrize("root_level,root_coord", [
    (0, (0, 0, 0)), (2, (1, 1, 2)), (2, (0, 1, 3)), (2, (0, 2, 2)), (2, (3, 2, 1))])
def test_column_square_covers_the_parents_child_columns(monkeypatch, root_level,
                                                        root_coord):
    """At every level of a terrain build (a whole one, and octant builds at
    root level 2), the column table is the root cell's square of columns at
    that level, and it holds every child column of the level's parents; in
    the whole build the parents' child columns are the whole square (the
    surface crosses every column)."""
    scene = get_scene("terrain")
    depth = 7
    svo, calls = recorded_expansions(monkeypatch, scene, depth, root_level=root_level,
                                     root_coord=root_coord)
    assert svo.n_leaves > 0
    assert [lv for _, lv, _ in calls] == list(range(root_level + 1, depth + 1))
    for parents, level, cols in calls:
        k = level - root_level
        assert (cols.x0, cols.z0, cols.side) == (root_coord[0] << k,
                                                 root_coord[2] << k, 1 << k)
        assert cols.h.shape == (cols.side ** 2,) and not bool(torch.isnan(cols.h).any())
        square = {(cols.x0 + x, cols.z0 + z) for x in range(cols.side)
                  for z in range(cols.side)}
        want = child_columns(parents)
        assert want <= square, level
        if root_level == 0:
            assert want == square, level


def _of_form_y_minus_h(scene):
    """Whether f(x, y, z) - y depends on (x, z) alone, at random points."""
    rng = np.random.default_rng(1)
    x, z = (rng.random(2000, dtype=np.float32) for _ in range(2))
    a = np.float64(scene(x, np.full_like(x, 0.25), z)) - 0.25
    b = np.float64(scene(x, np.full_like(x, 0.75), z)) - 0.75
    return bool(np.allclose(a, b, atol=1e-6))


def test_heightfield_table_names_the_y_minus_h_scenes():
    """HEIGHTFIELDS names exactly the library's scenes whose f is y - h(x,
    z); scene.cuh's height and svo_columns' id check take the same four;
    ``columns`` gives no table for a 3-D scene."""
    assert {n for n, s in SCENES.items() if _of_form_y_minus_h(s)} == set(
        octree_cuda.HEIGHTFIELDS) == {"flat_ground", "simplex", "terrain", "perlin"}
    ids = {"FLAT_GROUND": "flat_ground", "SIMPLEX": "simplex", "TERRAIN": "terrain",
           "PERLIN": "perlin"}
    src = open(os.path.join(_build._CSRC, "scene.cuh")).read()
    body = re.search(r"float height\(int id.*?\n}\n", src, re.S).group(0)
    named = set(re.findall(r"case (\w+):", body)) | set(re.findall(r"default:\s*// (\w+)", body))
    assert {ids[n] for n in named} == set(octree_cuda.HEIGHTFIELDS)
    build = open(os.path.join(_build._CSRC, "svo_build.cu")).read()
    check = re.search(r"const bool heightfield = (.*?);", build, re.S).group(1)
    assert {ids[n] for n in re.findall(r"scene::(\w+)", check)} == set(
        octree_cuda.HEIGHTFIELDS)
    for name in SCENES:
        got = octree_cuda.columns(octree_cuda.device_scene(get_scene(name), "cpu"),
                                  1, device="cpu")
        assert (got is None) == (name not in octree_cuda.HEIGHTFIELDS), name


def test_first_form_and_new_form_agree_on_the_cpu():
    """``expand_serial`` and ``expand`` (with its level's columns) take the
    plain version on CPU tensors and give the same records, flags and
    counts; the square refuses a level at or above the root's."""
    ds = octree_cuda.device_scene(get_scene("terrain"), "cpu")
    parents = torch.tensor([[1, 1, 2, 0], [2, 1, 2, 0]], dtype=torch.int32)
    hi, lo = octree_device.keep_bounds(ds.scene.lipschitz, 3, 5)
    cols = octree_cuda.columns(ds, 3, device="cpu")
    for a, b in zip(octree_cuda.expand(ds, parents, 3, hi, lo, cols),
                    octree_cuda.expand_serial(ds, parents, 3, hi, lo)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        octree_cuda.column_square(2, root_level=2)
