"""Build and load the port's native libraries (ctypes, plain C interfaces).

Two libraries, each built on first use into ``build/raytracingtest_tpu_torch/``
at the root of the checkout:

  * ``noise``      — ``csrc/noise.cpp`` with g++, the threaded host noise the
                     SVO builder samples (same source and flags as the JAX
                     package's ``csrc/Makefile``, so its SVOs come out
                     byte-identical);
  * ``esvo_trace`` — ``csrc/esvo_trace.cu`` with nvcc for ``sm_90a``, the
                     per-ray ESVO traversal kernel.

The file name of each library carries a hash of its source and flags, so a
stale build is never loaded. Each compiles to a temporary name and is moved
into place with ``os.replace``: concurrent processes (pytest workers) never
load a half-written file. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raytracingtest_tpu_torch")

# csrc/Makefile's flags (-Wall dropped: warnings change no code)
NOISE_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
               "-std=c++17", "-shared", "-pthread"]
# --fmad=false: the traversal's hits depend on a*b-c rounding in two steps
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
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
    with open(source, "rb") as f:
        text = f.read() + " ".join(flags).encode()
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
    os.replace(tmp, so)
    return so


def _load(name: str, compiler_fn, flags: list, source: str, declare):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name, compiler_fn(), flags, source))
            declare(lib)
            _libs[name] = lib
        return lib


def _declare_noise(lib):
    p = ctypes.c_void_p
    lib.rtt_noise3.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_uint32]
    lib.rtt_noise3.restype = None
    lib.rtt_fbm3.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.rtt_fbm3.restype = None


def _declare_trace(lib):
    p = ctypes.c_void_p
    lib.esvo_trace.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                               p, p, p, p, p, p]
    lib.esvo_trace.restype = ctypes.c_int


def noise_lib():
    """The host noise library (built with g++ on first call)."""
    return _load("noise", lambda: "g++", NOISE_FLAGS,
                 os.path.join(_CSRC, "noise.cpp"), _declare_noise)


def trace_lib():
    """The ESVO traversal kernel library (built with nvcc on first call)."""
    return _load("esvo_trace", _nvcc, NVCC_FLAGS,
                 os.path.join(_CSRC, "esvo_trace.cu"), _declare_trace)
