"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's native libraries from this checkout (into
build/raytracingtest_tpu_torch/), checks the ESVO traversal kernel against
its plain PyTorch version on the card, then renders the benchmark frame:
the depth-10 `terrain` SVO seen by bench.py's camera at 1024x1024, through
`diff.render_diff_cuda`. One line per phase; any failure raises and the exit
code is non-zero. The last two lines are a JSON record of the kernels and
the device. Without a CUDA device it fails before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from raytracingtest_tpu_torch import _build, diff
from raytracingtest_tpu_torch.io import checkpoint
from raytracingtest_tpu_torch.ops import camera, octree, traverse, traverse_cuda
from raytracingtest_tpu_torch.scenes import get_scene

KERNEL_SOURCE = "raytracingtest_tpu_torch/csrc/esvo_trace.cu"
REPLACES = "raytracingtest_tpu/ops/traverse_pallas.py:55"
OUTPUTS = ("hit_leaf", "hit_parent", "hit_child", "iters")


def say(*parts):
    print(*parts, flush=True)


def random_rays(n, seed, toward=(0.5, 0.5, 0.5), spread=0.35):
    """Rays from random points on a radius-2 shell aimed near `toward`."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = np.asarray(toward) + 2.0 * v
    target = np.asarray(toward) + rng.normal(0, spread, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def compare(kern, plain, what):
    """Exact equality of every trace output (hit_t bitwise); returns the
    largest absolute difference seen (0.0 when exact)."""
    err = float((kern.hit_t - plain.hit_t).abs().max()) if kern.hit_t.numel() else 0.0
    for name in OUTPUTS:
        a, b = getattr(kern, name), getattr(plain, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: {name} differs on {bad} rays")
    if not torch.equal(kern.hit_t.view(torch.int32), plain.hit_t.view(torch.int32)):
        raise AssertionError(f"{what}: hit_t differs bitwise (max abs {err})")
    return err


def cuda_ms(fn, reps, warmup):
    """Milliseconds of each of `reps` calls of fn() on the card, from CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return np.asarray(times)


def main():
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.trace_lib()
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.noise_lib()
    t_noise = time.perf_counter() - t0
    say(f"[build] esvo_trace (nvcc sm_90a) {t_trace:.2f} s, "
        f"noise (g++) {t_noise:.2f} s, into {_build.BUILD_DIR}")

    # ---- 3. kernel vs plain on the card -----------------------------------
    max_err = 0.0
    for name, depth in (("sphere", 5), ("terrain", 6)):
        svo = octree.build_svo(get_scene(name), depth).to(dev)
        for n in (1000, 4096):
            o, d = (torch.from_numpy(a).to(dev)
                    for a in random_rays(n, seed=depth + n))
            kern = traverse_cuda._trace_kernel(svo, o, d)
            plain = traverse.trace(svo, o, d)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(kern, plain, f"{name} d{depth} N={n}"))
            hits = int((kern.hit_leaf >= 0).sum())
            say(f"[parity] {name} depth {depth} N={n}: kernel == plain "
                f"(hit ids, iters, hit_t bitwise), {hits} hits")

    # ---- 4. main path: the depth-10 1024^2 terrain frame --------------------
    depth, res = 10, 1024
    cache = os.path.join(_build.BUILD_DIR, f"terrain_d{depth}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        host_svo, how = checkpoint.load_svo(cache), "cached"
    else:
        host_svo, how = octree.build_svo(get_scene("terrain"), depth), "built"
        checkpoint.save_svo(host_svo, cache)
    build_s = time.perf_counter() - t0
    say(f"[svo] terrain depth {depth}: {host_svo.n_nodes} nodes, "
        f"{host_svo.n_leaves} leaves, {how} on the host in {build_s:.2f} s")

    svo = host_svo.to(dev)
    cam = camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                        fov_y_deg=50.0, width=res, height=res)
    o, d = cam.rays(dev)
    light = torch.tensor([-0.5, -1.0, -0.3], dtype=torch.float32, device=dev)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    n_rays = o.shape[0]

    traverse_cuda.launches = 0
    img = diff.render_diff_cuda(*params, svo, o, d, light)
    torch.cuda.synchronize()
    main_launches = traverse_cuda.launches
    if main_launches < 1:
        raise AssertionError("the frame did not launch the traversal kernel")
    if img.shape != (n_rays, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: shape {tuple(img.shape)} or non-finite")

    # the frame against its plain version on the same card and inputs
    plain = traverse.trace(svo, o, d)
    kern = traverse_cuda.trace_cuda(svo, o, d)
    max_err = max(max_err, compare(kern, plain, "terrain d10 frame"))
    img_plain = diff.shade_diff(plain.hit_leaf, d, *params, light, 1.3, 0.08)
    img_err = float((img - img_plain).abs().max())
    if img_err > 1e-6:
        raise AssertionError(f"frame differs from the plain path by {img_err}")
    hits = int((kern.hit_leaf >= 0).sum())
    say(f"[frame] {res}x{res}: {main_launches} kernel launch(es) in the frame, "
        f"{hits} hits, hits == plain trace, image == plain path "
        f"(max abs {img_err}), finite")

    # 50 samples: the 80th percentile has 10 beyond it
    kernel_t = cuda_ms(lambda: traverse_cuda.trace_cuda(svo, o, d), 50, 3)
    plain_t = cuda_ms(lambda: traverse.trace(svo, o, d), 3, 1)
    frame_t = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    kernel_ms, plain_ms, frame_ms = (float(np.median(t))
                                     for t in (kernel_t, plain_t, frame_t))
    say(f"[timing] {card}: kernel trace median {kernel_ms:.4f} ms "
        f"(p80 {np.percentile(kernel_t, 80):.4f}, n=50); plain trace median "
        f"{plain_ms:.3f} ms (n=3); frame median {frame_ms:.4f} ms "
        f"(p80 {np.percentile(frame_t, 80):.4f}, n=50) = "
        f"{n_rays / frame_ms / 1e3:.2f} Mrays/s at {res}x{res} depth {depth}")

    say(json.dumps({"kernels": [{
        "name": "esvo_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
