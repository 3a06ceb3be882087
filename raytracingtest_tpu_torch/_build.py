"""Build and load the port's native libraries (plain C interfaces) and the
launcher that calls them.

Eight libraries, each built on first use into
``build/raytracingtest_tpu_torch/`` at the root of the checkout:

  * ``noise``      — ``csrc/noise.cpp`` with g++, the threaded host noise the
                     SVO builder samples (same source and flags as the JAX
                     package's ``csrc/Makefile``, so its SVOs come out
                     byte-identical);
  * ``esvo_trace`` — ``csrc/esvo_trace.cu`` with nvcc for ``sm_90a``, the
                     per-ray ESVO traversal kernel and its first form;
  * ``tile_walk``  — ``csrc/tile_walk.cu`` with nvcc for ``sm_90a``: the tile
                     walker and its first form, the brick DDA and the row
                     read;
  * ``shade``      — ``csrc/shade.cu`` with nvcc for ``sm_90a``: the gathers,
                     the loop probe (and its first form), fused shading, its backward (and that
                     backward's first form), the
                     deterministic segment sum (sort-free, and its earlier
                     sorted form) and the emission-absorption compositing of
                     k segments a ray (``composite_fwd``) with its backward
                     (``composite_bwd``);
  * ``tile_candidates`` — ``csrc/tile_candidates.cu`` with nvcc for ``sm_90a``:
                     phase 1 of the tile trace, each tile's candidate list,
                     in its brickmap mode too (the streamed world), and its
                     first form;
  * ``brick_trace`` — ``csrc/brick_trace.cu`` with nvcc for ``sm_90a``: the
                     per-ray stackless trace (a patched form and its
                     first form) and the per-ray brick trace
                     in its forms, each also with counters, their
                     k-segment forms (``esvo_stackless_multi``,
                     ``brick_trace_multi``, the latter in a staged form and
                     its first form; each with counters too) for volumetric
                     rendering and
                     their LOD forms (``esvo_stackless_lod``,
                     ``brick_trace_lod``, each a patched form and its first
                     form, ``brick_trace_lod``'s with counters too), the
                     streamed world's
                     stitched traces (``clipmap_trace`` and
                     ``clipmap_trace_brick``, each in a wide form and its
                     first form, with counters too) and the level-sharded
                     rounds (``level_round``, three modes, and its queue
                     ``level_queue`` in one pass and its first form);
  * ``svo_build``  — ``csrc/svo_build.cu`` with nvcc for ``sm_90a``: the SVO
                     builder on the card (``svo_columns``, ``svo_expand``
                     and its first form, ``svo_compact``, ``svo_leaves``,
                     ``svo_level_pass``, and the first forms
                     ``svo_level_up`` and ``svo_parent_ptr``)
                     over the scene library ``csrc/scene.cuh``, and
                     ``scene_eval``, that library at given points;
  * ``launch``     — ``csrc/launch.cpp`` with g++ against this interpreter's
                     headers: the CPython extension ``rtt_launch`` through
                     which ``_launch.Kernel`` calls the CUDA libraries' entry
                     points (their ctypes functions give the address and the
                     argument types; the call skips ctypes).

``csrc/brick_dda.cuh`` holds the brick DDA that ``tile_walk.cu`` and
``brick_trace.cu`` share.

``build_all`` builds them side by side, one compiler process each.

Each library's build log (what the compiler printed, for a CUDA library
ptxas's registers and spills of each kernel) is kept beside it as
``<library>.so.log``; ``build_log`` reads it.

The file name of each library carries a hash of its source, its flags and,
for a CUDA source, the headers under ``csrc/``, so a stale build is never
loaded. Each compiles to a temporary name and is moved
into place with ``os.replace``: concurrent processes (pytest workers) never
load a half-written file. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raytracingtest_tpu_torch")

# csrc/Makefile's flags (-Wall dropped: warnings change no code)
NOISE_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
               "-std=c++17", "-shared", "-pthread"]
# --fmad=false: the traversal's hits depend on a*b-c rounding in two steps;
# -Xptxas -v: each kernel's registers, spills and shared memory, kept in the
# library's build log (build_log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the launcher: a CPython extension for this interpreter (its headers' path,
# which names its version, is part of the key)
LAUNCH_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared",
                "-I" + sysconfig.get_paths()["include"]]

_lock = threading.Lock()      # guards the two tables below
_build_locks: dict = {}       # one lock a library, so builds run side by side
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _host_cpu() -> bytes:
    """The CPU's feature flags: -march=native code is only valid on a CPU
    that has them, so they are part of a host library's key."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _build(name: str, compiler: str, flags: list, source: str) -> str:
    """Compile `source` into a hash-keyed shared library; returns its path."""
    headers = (sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
               if source.endswith(".cu") else [])
    text = b""
    for path in [source] + headers:
        with open(path, "rb") as f:
            text += f.read()
    text += " ".join(flags).encode()
    if "-march=native" in flags:
        text += _host_cpu()
    key = hashlib.sha256(text).hexdigest()
    so = os.path.join(BUILD_DIR, f"lib{name}-{key[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run([compiler, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({compiler}, rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    with open(f"{so}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_log(name: str) -> str:
    """What the compiler printed when it built the loaded library `name`
    (for a CUDA library, ptxas's report of each kernel)."""
    path = f"{_libs[name]._name}.log"
    with open(path) as f:
        return f.read()


def _load(name: str, compiler_fn, flags: list, source: str, declare,
          opener=ctypes.CDLL):
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = opener(_build(name, compiler_fn(), flags, source))
            declare(lib)
            _libs[name] = lib
        return lib


def _import_launcher(path: str):
    loader = importlib.machinery.ExtensionFileLoader("rtt_launch", path)
    spec = importlib.util.spec_from_file_location("rtt_launch", path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def _declare_noise(lib):
    p = ctypes.c_void_p
    lib.rtt_noise3.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_uint32]
    lib.rtt_noise3.restype = None
    lib.rtt_fbm3.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.rtt_fbm3.restype = None


def _declare_trace(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    for fn in (lib.esvo_trace, lib.esvo_trace_serial):
        fn.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p, p]
        fn.restype = i


def _declare_tile(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_walk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p, p, p]
    lib.tile_walk_serial.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p, p,
                                     p]
    lib.brick_dda16.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.rowread.argtypes = [p, i, i, i, p, i, p, i, p, i, p]
    for fn in (lib.tile_walk, lib.tile_walk_serial, lib.brick_dda16,
               lib.rowread):
        fn.restype = i


def _declare_shade(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.take.argtypes = [p, p, p, i, i, i, i, p]
    for fn in (lib.loop_probe, lib.loop_probe_serial):
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.shade_fwd.argtypes = [p, p, p, p, p, i, p, f, f, p, p, i, p]
    for fn in (lib.shade_bwd, lib.shade_bwd_serial):
        fn.argtypes = [p, p, p, p, p, p, i, p, f, f, p, p, i, p]
    lib.segment_sum.argtypes = [p, p, i, i, p, ctypes.c_longlong, p, p, p, p]
    lib.segment_sum_sorted.argtypes = [p, p, p, i, i, p, p, p, p]
    lib.composite_fwd.argtypes = [p] * 7 + [i, p, f, f, f, i, p, i, p]
    lib.composite_bwd.argtypes = [p] * 8 + [i, p, f, f, f, i, p, i, p]
    for fn in (lib.take, lib.loop_probe, lib.loop_probe_serial, lib.shade_fwd,
               lib.shade_bwd, lib.shade_bwd_serial, lib.segment_sum,
               lib.segment_sum_sorted, lib.composite_fwd, lib.composite_bwd):
        fn.restype = i


def _declare_candidates(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # the unmapped entries; the brickmap mode's take the brickmap third and
    # the probe its form first and its record last
    lib.tile_candidates.argtypes = [p] * 4 + [i, i, p, i, i] + [p] * 5
    lib.tile_candidates_radix.argtypes = lib.tile_candidates.argtypes
    lib.tile_candidates_mapped.argtypes = [p] * 5 + [i, i, p, i, i] + [p] * 5
    lib.tile_candidates_mapped_first.argtypes = lib.tile_candidates_mapped.argtypes
    lib.tile_candidates_probe.argtypes = [i] + [p] * 5 + [i, i, p, i, i] + [p] * 6
    lib.tile_candidates_block.argtypes = [p] * 4 + [i, i, p, i] + [p] * 5
    for fn in (lib.tile_candidates, lib.tile_candidates_block,
               lib.tile_candidates_mapped, lib.tile_candidates_mapped_first,
               lib.tile_candidates_radix, lib.tile_candidates_probe):
        fn.restype = i


def _declare_brick(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # the stackless traces' patched forms take the node row table (the LOD
    # form the four arrays), the image width and the block; their first
    # forms the four arrays
    lib.esvo_stackless.argtypes = [p] * 3 + [i] * 4 + [p] * 7
    lib.esvo_stackless_serial.argtypes = [p] * 6 + [i] * 2 + [p] * 7
    lib.esvo_stackless_probe.argtypes = [i] + [p] * 7 + [i] * 4 + [p] * 8
    for fn in (lib.brick_trace, lib.brick_trace_serial, lib.brick_trace_unstaged):
        fn.argtypes = [p] * 6 + [i] * 3 + [p] * 7
    lib.brick_trace_probe.argtypes = [i] + [p] * 6 + [i] * 3 + [p] * 8
    lib.esvo_stackless_multi.argtypes = [p] * 3 + [i] * 5 + [p] * 7
    lib.esvo_stackless_multi_serial.argtypes = [p] * 6 + [i] * 3 + [p] * 7
    lib.esvo_stackless_multi_probe.argtypes = [i] + [p] * 7 + [i] * 5 + [p] * 8
    lib.brick_trace_multi.argtypes = [p] * 6 + [i] * 4 + [p] * 7
    lib.brick_trace_multi_serial.argtypes = [p] * 6 + [i] * 4 + [p] * 7
    lib.brick_trace_multi_probe.argtypes = [i] + [p] * 6 + [i] * 4 + [p] * 8
    f = ctypes.c_float
    lib.esvo_stackless_lod.argtypes = [p] * 6 + [i] * 4 + [f] * 2 + [p] * 8
    lib.esvo_stackless_lod_serial.argtypes = [p] * 6 + [i] * 2 + [f] * 2 + [p] * 8
    # brick_trace_lod's patched form takes the image width and the block; its
    # probe both forms' arguments, its form and the record
    lib.brick_trace_lod.argtypes = [p] * 6 + [i] * 6 + [f] * 2 + [p] * 8
    lib.brick_trace_lod_serial.argtypes = [p] * 6 + [i] * 4 + [f] * 2 + [p] * 8
    lib.brick_trace_lod_probe.argtypes = [i] + [p] * 6 + [i] * 6 + [f] * 2 + [p] * 9
    clip = [p] * 7 + [f] * 4 + [p] * 6 + [i] * 4 + [p] * 4
    for fn in (lib.clipmap_trace, lib.clipmap_trace_serial, lib.clipmap_trace_brick,
               lib.clipmap_trace_brick_serial):
        fn.argtypes = clip + [p]
        fn.restype = i
    for fn in (lib.clipmap_trace_probe, lib.clipmap_trace_brick_probe):
        fn.argtypes = [i] + clip + [p, p]
        fn.restype = i
    # level_round's shared arguments: the trees, the octant tables, the rays
    # and the five outputs
    level = ([i] + [p] * 4 + [i] + [p] * 4 + [i] + [p] * 3 + [f, i] + [p] * 4
             + [i] + [p] * 5)
    lib.level_round.argtypes = level + [p, p, i, i, i, p]
    lib.level_round_serial.argtypes = level + [p]
    lib.level_round_probe.argtypes = level + [p, p]
    lib.level_queue.argtypes = [i, i, p, p, p, p, i, p, i] + [p] * 8 + [p]
    lib.level_queue_serial.argtypes = [i, i, p, p, p, p, i] + [p] * 8 + [p]
    for fn in (lib.level_round, lib.level_round_serial, lib.level_round_probe,
               lib.level_queue, lib.level_queue_serial):
        fn.restype = i
    for fn in (lib.esvo_stackless, lib.esvo_stackless_serial,
               lib.esvo_stackless_probe, lib.brick_trace,
               lib.brick_trace_serial, lib.brick_trace_unstaged,
               lib.brick_trace_probe, lib.esvo_stackless_multi,
               lib.esvo_stackless_multi_serial, lib.esvo_stackless_multi_probe,
               lib.brick_trace_multi, lib.brick_trace_multi_serial,
               lib.brick_trace_multi_probe, lib.esvo_stackless_lod,
               lib.esvo_stackless_lod_serial, lib.brick_trace_lod,
               lib.brick_trace_lod_serial, lib.brick_trace_lod_probe):
        fn.restype = i


def _declare_svo(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = [p] * 5
    lib.svo_columns.argtypes = [i, i, i, f, i, p, p]
    lib.svo_expand.argtypes = [p, i, f, f, f, i] + tables + [p, i, i, i, p, p, p, p]
    lib.svo_expand_serial.argtypes = [p, i, f, f, f, i] + tables + [p, p, p, p]
    lib.svo_compact.argtypes = [p, i, p, p, i, p, p, p, p]
    lib.svo_leaves.argtypes = [p, i, p, p, i, p, f, i, i] + tables + [p, p, p, p, p]
    lib.svo_leaf_attrs.argtypes = [p, i, f, i] + tables + [p, p]
    lib.svo_leaves_serial.argtypes = [p, i, f, i] + tables + [p, p, p, p]
    lib.svo_level_pass.argtypes = [p, i, p, p, p, p, p, p, p, p, p]
    lib.svo_level_up.argtypes = [p, i, p, p, p, p, p]
    lib.svo_parent_ptr.argtypes = [p, p, i, p, p]
    lib.scene_eval.argtypes = [p, p, p, i, i] + tables + [p, p]
    for fn in (lib.svo_columns, lib.svo_expand, lib.svo_expand_serial,
               lib.svo_compact, lib.svo_leaves,
               lib.svo_leaf_attrs, lib.svo_leaves_serial, lib.svo_level_pass,
               lib.svo_level_up, lib.svo_parent_ptr, lib.scene_eval):
        fn.restype = i


def noise_lib():
    """The host noise library (built with g++ on first call)."""
    return _load("noise", lambda: "g++", NOISE_FLAGS,
                 os.path.join(_CSRC, "noise.cpp"), _declare_noise)


def trace_lib():
    """The ESVO traversal kernel library (built with nvcc on first call)."""
    return _load("esvo_trace", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "esvo_trace.cu"), _declare_trace)


def tile_lib():
    """The tile walker, brick DDA and row-read kernels (built with nvcc on
    first call)."""
    return _load("tile_walk", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "tile_walk.cu"), _declare_tile)


def shade_lib():
    """The gather, loop-probe, shading and segment-sum kernels (built with
    nvcc on first call)."""
    return _load("shade", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "shade.cu"), _declare_shade)


def candidates_lib():
    """The tile trace's phase-1 kernel (built with nvcc on first call)."""
    return _load("tile_candidates", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "tile_candidates.cu"), _declare_candidates)


def brick_lib():
    """The per-ray stackless and brick trace kernels (built with nvcc on
    first call)."""
    return _load("brick_trace", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "brick_trace.cu"), _declare_brick)


def svo_lib():
    """The SVO builder's kernels and the scene library (built with nvcc on
    first call)."""
    return _load("svo_build", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "svo_build.cu"), _declare_svo)


def launch_lib():
    """The launcher, the CPython extension ``rtt_launch`` (built with g++ on
    first call): ``bind(address, kinds)``."""
    return _load("launch", lambda: "g++", LAUNCH_FLAGS,
                 os.path.join(_CSRC, "launch.cpp"), lambda module: None,
                 _import_launcher)


def build_all() -> dict:
    """Build and load every library at once, one thread (and so one
    compiler process) each; returns seconds by library name. The first
    failure raises."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    libs = {"esvo_trace": trace_lib, "tile_walk": tile_lib,
            "shade": shade_lib, "tile_candidates": candidates_lib,
            "brick_trace": brick_lib, "svo_build": svo_lib,
            "noise": noise_lib, "launch": launch_lib}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in libs.items()}
        return {name: f.result() for name, f in futures.items()}
