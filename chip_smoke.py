"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's native libraries from this checkout (into
build/raytracingtest_tpu_torch/, all at once), checks every hand-written
kernel against its plain PyTorch version on the card, then renders the
benchmark frame two ways: the depth-10 `terrain` SVO seen by bench.py's
camera at 1024x1024,

  * ray by ray, through `diff.render_diff_cuda` (kernel `esvo_trace`), and
  * tile by tile, through `diff.render_diff_tile` with bench.py's budgets
    (kernel `tile_walk`, three launches a frame),

and runs the two probe kernels (`brick_dda16`, `rowread`) at the sizes of
the probes they replace. One line per phase; any failure raises and the exit
code is non-zero. The last two lines are a JSON record of the kernels and the
device. Without a CUDA device it fails before printing any result.
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
from raytracingtest_tpu_torch.ops import (
    brick_dda, camera, octree, rowread, tile, tile_cuda, traverse,
    traverse_cuda)
from raytracingtest_tpu_torch.scenes import get_scene

OUTPUTS = ("hit_leaf", "hit_parent", "hit_child", "iters")

# the tile frame's budgets: bench.py's BENCH_PATH=tile defaults
TILE_BUDGETS = dict(k_max=96, fb_tiles=96, fb_k=160, fb2_tiles=16, fb2_split=2)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and the float32 rate outside the tensor cores, which is the rate of these
# kernels' scalar float and integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Arithmetic and logic operations of one trip of each kernel's loop, counted
# from the source: one PUSH/ADVANCE/POP step of esvo_trace, one DDA step of
# tile_walk and brick_dda16, and the setup of one ray.
OPS_ESVO_STEP = 40
OPS_DDA_STEP = 32
OPS_RAY_SETUP = 40


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


def bits(t):
    """A float32 tensor's bits, for bitwise comparison."""
    return t.contiguous().view(torch.int32)


def compare(kern, plain, what):
    """Exact equality of every trace output (hit_t bitwise); returns the
    largest absolute difference seen (0.0 when exact)."""
    err = float((kern.hit_t - plain.hit_t).abs().max()) if kern.hit_t.numel() else 0.0
    for name in OUTPUTS:
        a, b = getattr(kern, name), getattr(plain, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: {name} differs on {bad} rays")
    if not torch.equal(bits(kern.hit_t), bits(plain.hit_t)):
        raise AssertionError(f"{what}: hit_t differs bitwise (max abs {err})")
    return err


def compare_tensors(kern, plain, names, what):
    """Bitwise equality of tuples of tensors; returns the largest absolute
    difference among the float ones (0.0 when exact)."""
    err = 0.0
    for name, a, b in zip(names, kern, plain):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {name} has another shape or type")
        same = torch.equal(bits(a), bits(b)) if a.is_floating_point() else torch.equal(a, b)
        if not same:
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: {name} differs on {bad} elements")
        if a.is_floating_point():
            finite = torch.isfinite(a) & torch.isfinite(b)
            if bool(finite.any()):
                err = max(err, float((a[finite] - b[finite]).abs().max()))
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


def med_p80(times):
    return float(np.median(times)), float(np.percentile(times, 80))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the float32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def reset_counts():
    for mod in (traverse_cuda, tile_cuda, brick_dda, rowread):
        mod.launches = 0


def dda_inputs(n, seed, dev):
    """Pre-staged brick-DDA state with the distributions of
    scratch/r4_pallas2.py::make_inputs, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = (
        (1.0 + rng.random((n, 3), dtype=f32) * f32(0.9)).astype(f32),   # bpos
        rng.random(n, dtype=f32),                                       # t_cur
        (rng.random(n) < 0.7).astype(np.int32),                         # walking
        rng.integers(0, 2 ** 31 - 1, (16, n), dtype=np.int64).astype(np.int32),
        (-1.0 - rng.random((n, 3), dtype=f32)).astype(f32),             # tc
        rng.random((n, 3), dtype=f32),                                  # tb
        (rng.integers(0, 2, (n, 3)) * 7).astype(np.int32),              # flip
        np.full(n, np.inf, f32),                                        # hit_t
    )
    return tuple(torch.from_numpy(a).to(dev) for a in host)


def walk_inputs(ts, o, d, corners, mode):
    """The walker's arguments for one of the frame's three walks over all of
    the given tiles: the main walk, the enlarged-K re-walk, or the 2x2
    sub-tile re-walk (64 rays a block)."""
    td, k, fb_k = ts.top_depth, TILE_BUDGETS["k_max"], TILE_BUDGETS["fb_k"]
    if mode == "main":
        caps, k_max = tile._default_caps(td, k), k
    elif mode == "enlarged-K":
        caps, k_max = tuple(min(fb_k, 8 ** l) for l in range(td + 1)), fb_k
    else:
        o, d, corners = tile._subtile_split(o, d, corners, 2)
        o, d = o.contiguous(), d.contiguous()
        caps, k_max = tile._fb2_caps(td, fb_k), fb_k
    codes, ids, t_codes, _drop = tile._candidates(
        ts.pyr, ts.cellmap, corners, o[0, 0], td, caps, k_max)
    return (ts.bsvo.bricks, o, d, codes, ids, t_codes, ts.depth, td)


WALK_NAMES = ("hit_leaf", "hit_t", "iters")

# The referee's tolerances, in units of t (a depth-10 voxel is 9.8e-4 wide):
# a chord shorter than GRAZE is a graze of a corner or an edge, which float32
# paths may count or not; more rays than MAX_DIFFER apart is a fault outright.
GRAZE = 1e-5
MAX_DIFFER = 64
# two walks to the same voxel may differ in hit_t by a few ULP (t is about 1)
HIT_T_ATOL = 1e-6


def leaf_voxels(ts):
    """Integer voxel coordinates (n_leaves, 3) of every leaf, in leaf order,
    read back from the tile SVO on the host: finest pyramid cells in morton
    order are the bricks, and a brick's set bits in hierarchical-morton order
    are its leaves."""
    td = ts.top_depth
    offs, _ = tile._pyr_layout(td)
    pyr = ts.pyr.cpu().numpy().view(np.uint32)[offs[td]:]
    shifts = np.arange(32, dtype=np.uint32)
    cells = np.flatnonzero(((pyr[:, None] >> shifts) & 1).reshape(-1))
    bricks = ts.bsvo.bricks.cpu().numpy().view(np.uint32)[:, :16]
    brick, bit = np.nonzero(((bricks[:, :, None] >> shifts) & 1).reshape(-1, 512))
    axis = lambda a: ((((bit >> (6 + a)) & 1) << 2) | (((bit >> (3 + a)) & 1) << 1)
                      | ((bit >> a) & 1))
    return np.stack([c[brick] * 8 + axis(a)
                     for a, c in enumerate(tile.unmorton3(cells))], axis=1)


def referee(voxels, depth, o, d, answers):
    """Judge hit leaves in float64 against every leaf voxel. For each ray
    (o, d float32 (n,3)) the truth is the first voxel the ray crosses with a
    chord longer than GRAZE. An answer (a leaf id, or -1 for a miss) is
    acceptable if it is that voxel, or a voxel the ray grazes (chord within
    GRAZE of zero, either side) no later than that voxel; a miss is
    acceptable when the ray crosses nothing. `answers`: dict name ->
    int array (n,). Returns dict name -> bool array (n,)."""
    size = 2.0 ** -depth
    lo = voxels * size
    verdict = {name: np.zeros(len(o), bool) for name in answers}
    for r in range(len(o)):
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo - o[r].astype(np.float64)) / d[r].astype(np.float64)
            t2 = (lo + size - o[r].astype(np.float64)) / d[r].astype(np.float64)
        t_in = np.minimum(t1, t2).max(axis=1)
        t_out = np.maximum(t1, t2).min(axis=1)
        chord = t_out - t_in
        solid = (chord > GRAZE) & (t_out > 0)
        first = np.where(solid, t_in, np.inf).argmin() if solid.any() else -1
        limit = t_in[first] + GRAZE if first >= 0 else np.inf
        for name, ans in answers.items():
            a = int(ans[r])
            if a < 0:
                verdict[name][r] = first < 0
            else:
                verdict[name][r] = a == first or (
                    abs(chord[a]) <= GRAZE and t_in[a] <= limit)
    return verdict


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

    # ---- 2. build: every library at once ----------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    say(f"[build] esvo_trace (nvcc sm_90a) {secs['esvo_trace']:.2f} s, "
        f"tile_walk (nvcc sm_90a) {secs['tile_walk']:.2f} s, "
        f"noise (g++) {secs['noise']:.2f} s, side by side in "
        f"{time.perf_counter() - t0:.2f} s, into {_build.BUILD_DIR}")

    # ---- 3. kernels vs plain versions on the card ---------------------------
    err = dict(esvo_trace=0.0, tile_walk=0.0, brick_dda16=0.0, rowread=0.0)
    for name, depth in (("sphere", 5), ("terrain", 6)):
        svo = octree.build_svo(get_scene(name), depth).to(dev)
        for n in (1000, 4096):
            o, d = (torch.from_numpy(a).to(dev)
                    for a in random_rays(n, seed=depth + n))
            kern = traverse_cuda._trace_kernel(svo, o, d)
            plain = traverse.trace(svo, o, d)
            torch.cuda.synchronize()
            err["esvo_trace"] = max(err["esvo_trace"],
                                    compare(kern, plain, f"{name} d{depth} N={n}"))
            hits = int((kern.hit_leaf >= 0).sum())
            say(f"[parity] esvo_trace {name} depth {depth} N={n}: kernel == plain "
                f"(hit ids, iters, hit_t bitwise), {hits} hits")

    bench_cam = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                     fov_y_deg=50.0)
    small_cam = camera.Camera(**bench_cam, width=128, height=128)
    for name, depth in (("terrain", 6), ("terrain", 7), ("flat_ground", 6)):
        ts = tile.make_tile_svo(octree.build_svo(get_scene(name), depth)).to(dev)
        o, d, corners, _grid = tile.tile_rays(small_cam, dev)
        for mode in ("main", "enlarged-K", "sub-tile"):
            args = walk_inputs(ts, o, d, corners, mode)
            kern = tile_cuda._walk_kernel(*args)
            plain = tile.walk_plain(*args)
            torch.cuda.synchronize()
            what = f"tile_walk {name} d{depth} {mode}"
            err["tile_walk"] = max(err["tile_walk"],
                                   compare_tensors(kern, plain, WALK_NAMES, what))
            say(f"[parity] {what}: kernel == plain (hit_leaf, iters, hit_t "
                f"bitwise), T={args[1].shape[0]} P={args[1].shape[1]} "
                f"K={args[4].shape[1]}, {int((kern[0] >= 0).sum())} hits")

    n_dda = 65536
    dda_args = dda_inputs(n_dda, 0, dev)
    kern = brick_dda._dda_kernel(*dda_args, 10, 16)
    plain = brick_dda.dda_steps(dda_args[0], dda_args[1], dda_args[2].bool(),
                                *dda_args[3:], depth=10, steps=16)
    torch.cuda.synchronize()
    err["brick_dda16"] = compare_tensors(
        kern, plain, ("hit_t", "hit_idx9", "t_cur"), "brick_dda16")
    say(f"[parity] brick_dda16 N={n_dda} depth 10, 16 steps: kernel == plain "
        f"(hit_t, hit_idx9, t_cur bitwise), "
        f"{int(torch.isfinite(kern[0]).sum())} hits")

    table = torch.arange(64 * 128, dtype=torch.int32, device=dev).reshape(64, 128)
    cursors = torch.from_numpy(np.random.default_rng(1).integers(
        9, 64, (8, 128)).astype(np.int32)).to(dev)
    rows8 = torch.arange(8, dtype=torch.int32, device=dev) * 3
    row_checks = (
        ("scalar", rowread.rowread_scalar(table, 17), table[17:18]),
        ("min", rowread.rowread_min(table, cursors), table[cursors.min().long()][None]),
        ("rows", rowread.rowread_rows(table, rows8), table[rows8.long()]),
    )
    torch.cuda.synchronize()
    for mode, got, want in row_checks:
        err["rowread"] = max(err["rowread"], compare_tensors(
            (got,), (want,), (mode,), f"rowread {mode}"))
    say("[parity] rowread (64,128) int32: kernel == table[idx] in the scalar, "
        "min-of-cursors and eight-rows modes")

    # ---- 4. the depth-10 SVO -------------------------------------------------
    depth, res = 10, 1024
    cache = os.path.join(_build.BUILD_DIR, f"terrain_d{depth}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        host_svo, how = checkpoint.load_svo(cache, "cpu"), "cached"
    else:
        host_svo, how = octree.build_svo(get_scene("terrain"), depth), "built"
        checkpoint.save_svo(host_svo, cache)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_ts = tile.make_tile_svo(host_svo)
    say(f"[svo] terrain depth {depth}: {host_svo.n_nodes} nodes, "
        f"{host_svo.n_leaves} leaves, {how} on the host in {build_s:.2f} s; "
        f"{host_ts.bsvo.n_bricks} bricks and {host_ts.pyr.numel()} pyramid "
        f"words in {time.perf_counter() - t0:.2f} s")

    svo = host_svo.to(dev)
    ts = host_ts.to(dev)
    cam = camera.Camera(**bench_cam, width=res, height=res)
    o, d = cam.rays(dev)
    light = torch.tensor([-0.5, -1.0, -0.3], dtype=torch.float32, device=dev)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    n_rays = o.shape[0]

    # ---- 5. main path, ray by ray ----------------------------------------------
    reset_counts()
    img = diff.render_diff_cuda(*params, svo, o, d, light)
    torch.cuda.synchronize()
    esvo_launches = traverse_cuda.launches
    if esvo_launches < 1:
        raise AssertionError("the frame did not launch the traversal kernel")
    if img.shape != (n_rays, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: shape {tuple(img.shape)} or non-finite")

    # the frame against its plain version on the same card and inputs
    t0 = time.perf_counter()
    plain = traverse.trace(svo, o, d)
    torch.cuda.synchronize()
    esvo_plain_ms = (time.perf_counter() - t0) * 1e3
    kern = traverse_cuda.trace_cuda(svo, o, d)
    err["esvo_trace"] = max(err["esvo_trace"],
                            compare(kern, plain, "terrain d10 frame"))
    img_plain = diff.shade_diff(plain.hit_leaf, d, *params, light, 1.3, 0.08)
    img_err = float((img - img_plain).abs().max())
    if img_err > 1e-6:
        raise AssertionError(f"frame differs from the plain path by {img_err}")
    hits = int((kern.hit_leaf >= 0).sum())
    esvo_steps = int(kern.iters.sum())
    say(f"[frame] {res}x{res}: {esvo_launches} kernel launch(es) in the frame, "
        f"{hits} hits, {esvo_steps / n_rays:.2f} steps a ray, hits == plain "
        f"trace, image == plain path (max abs {img_err}), finite")

    # ---- 6. main path, tile by tile ----------------------------------------------
    o_t, d_t, corners, grid = tile.tile_rays(cam, dev)
    reset_counts()
    img_t, residual = diff.render_diff_tile(*params, ts, o_t, d_t, corners,
                                            light, **TILE_BUDGETS)
    torch.cuda.synchronize()
    tile_launches = tile_cuda.launches
    if tile_launches != 3:
        raise AssertionError(f"the tile frame launched the walker "
                             f"{tile_launches} times, expected 3")
    if traverse_cuda.launches or brick_dda.launches or rowread.launches:
        raise AssertionError("the tile frame launched a kernel it has no use for")
    if img_t.shape != (n_rays, 3) or not bool(torch.isfinite(img_t).all()):
        raise AssertionError("bad tile image: shape or non-finite")
    n_residual = int(residual)

    # hits against the per-ray kernel on the same (tile-major) rays
    o_f, d_f = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    golden = traverse_cuda.trace_cuda(svo, o_f, d_f)
    res_fb, mask = tile.trace_tile_fb(ts, o_t, d_t, corners, **TILE_BUDGETS)
    if int(mask.sum()) != n_residual:
        raise AssertionError("residual count differs between two frames")
    # The two traversals are different algorithms and may part on a few
    # rays: a ray that only grazes a voxel's corner, and a ray on which the
    # per-ray ESVO walk runs into its step bound. Every ray on which they
    # part goes to a float64 referee; the tile frame must be right on each.
    ok = ~mask
    differ = ok & (res_fb.hit_leaf != golden.hit_leaf)
    n_differ = int(differ.sum())
    if n_differ > MAX_DIFFER:
        raise AssertionError(f"tile frame: {n_differ} resolved rays hit another "
                             f"leaf than the per-ray kernel")
    at_bound = differ & (golden.iters >= traverse.max_iters_for_depth(depth))
    verdict = referee(
        leaf_voxels(host_ts), depth, o_f[differ].cpu().numpy(),
        d_f[differ].cpu().numpy(),
        dict(tile=res_fb.hit_leaf[differ].cpu().numpy(),
             per_ray=golden.hit_leaf[differ].cpu().numpy()))
    if not verdict["tile"].all():
        raise AssertionError(
            f"tile frame: wrong on {int((~verdict['tile']).sum())} of the "
            f"{n_differ} rays where it parts from the per-ray kernel")
    same = ok & ~differ
    hit = same & (golden.hit_leaf >= 0)
    # hit_t is the largest of the plane crossings on the ray's way in; the
    # two walks cross other planes on the way to the same voxel, and a
    # rounded crossing may exceed a later one, so a few hits differ by ULPs
    t_off = hit & (bits(res_fb.hit_t) != bits(golden.hit_t))
    n_t_off = int(t_off.sum())
    t_off_max = float((res_fb.hit_t - golden.hit_t)[t_off].abs().max()) if n_t_off else 0.0
    if n_t_off > MAX_DIFFER or t_off_max > HIT_T_ATOL:
        raise AssertionError(f"tile frame: hit_t differs on {n_t_off} resolved "
                             f"hits of the same leaf, by up to {t_off_max}")
    # the exact trace: the tile frame's hits with every residual ray replaced
    # by the per-ray kernel's
    exact = tile.trace_tile_exact(ts, svo, o_t, d_t, corners, **TILE_BUDGETS)
    want_leaf = torch.where(mask, golden.hit_leaf, res_fb.hit_leaf)
    want_t = torch.where(mask, golden.hit_t, res_fb.hit_t)
    if not (torch.equal(exact.hit_leaf, want_leaf)
            and torch.equal(bits(exact.hit_t), bits(want_t))):
        raise AssertionError("trace_tile_exact is not the tile frame with its "
                             "residual rays re-traced")
    if not torch.equal(exact.hit_leaf[~differ], golden.hit_leaf[~differ]):
        raise AssertionError("trace_tile_exact differs from the per-ray kernel "
                             "beyond the refereed rays")
    keep = ~tile.untile_image(mask | differ, grid)
    img_tile_err = float((tile.untile_image(img_t, grid)[keep] - img[keep]).abs().max())
    if img_tile_err > 1e-6:
        raise AssertionError(f"tile image differs from the per-ray frame's by "
                             f"{img_tile_err}")

    # the walker against its plain version on the whole frame (main walk)
    main_args = walk_inputs(ts, o_t, d_t, corners, "main")
    kern_w = tile_cuda._walk_kernel(*main_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_w = tile.walk_plain(*main_args)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    err["tile_walk"] = max(err["tile_walk"], compare_tensors(
        kern_w, plain_w, WALK_NAMES, "tile_walk terrain d10 frame"))
    ids_main = main_args[4]
    dda_steps_main = int(kern_w[2].sum())
    say(f"[frame-tile] {res}x{res} in {o_t.shape[0]} tiles: {tile_launches} "
        f"walker launches in the frame, {n_residual} residual rays, "
        f"{int((res_fb.hit_leaf >= 0).sum())} hits; resolved hits == per-ray "
        f"kernel on all but {n_differ} rays, hit_t bitwise on all but "
        f"{n_t_off} of them (max abs {t_off_max}); on the {n_differ} the "
        f"float64 referee finds the tile frame right on "
        f"{int(verdict['tile'].sum())} and the per-ray kernel right on "
        f"{int(verdict['per_ray'].sum())} ({int(at_bound.sum())} of them ran "
        f"into its {traverse.max_iters_for_depth(depth)}-step bound); "
        f"trace_tile_exact == the tile frame with residual rays re-traced, and "
        f"== per-ray kernel off the refereed rays; image == per-ray frame off "
        f"them (max abs {img_tile_err}); main walk: "
        f"{int((ids_main >= 0).sum()) / ids_main.shape[0]:.1f} candidates a "
        f"tile, {dda_steps_main / n_rays:.2f} DDA steps a ray, kernel == plain")

    # ---- 7. the probe kernels at the probes' sizes --------------------------
    reset_counts()
    dda_out = brick_dda.brick_dda16(dda_args[0], dda_args[1], dda_args[2],
                                    *dda_args[3:], depth=10, steps=16)
    rowread.rowread_scalar(table, 17)
    rowread.rowread_min(table, cursors)
    rowread.rowread_rows(table, rows8)
    torch.cuda.synchronize()
    dda_launches, row_launches = brick_dda.launches, rowread.launches
    if dda_launches != 1 or row_launches != 3:
        raise AssertionError("the probes did not launch their kernels")
    if not bool(torch.isfinite(dda_out[2]).all()):
        raise AssertionError("brick_dda16: non-finite t_cur")
    # the DDA steps this data takes: walking rays, step by step
    bpos, t_cur, walking = dda_args[0], dda_args[1], dda_args[2].bool()
    rw, hit_t = dda_args[3], dda_args[7]
    word_of = lambda wsel: torch.gather(rw, 0, wsel.long()[None])[0]
    dda_walked = 0
    for _ in range(16):
        dda_walked += int(walking.sum())
        bpos, t_cur, hit_now, _exit, walking, _idx9 = brick_dda.dda_step(
            bpos, t_cur, walking, hit_t, dda_args[4], dda_args[5], dda_args[6],
            word_of, 10)
        hit_t = torch.where(hit_now, t_cur, hit_t)
    say(f"[probes] brick_dda16 N={n_dda}: {dda_launches} launch, "
        f"{dda_walked / n_dda:.2f} steps a ray; rowread: {row_launches} "
        f"launches (scalar, min, rows)")

    # ---- 8. timing: both frames within this one call -----------------------
    # 50 samples: the 80th percentile has 10 beyond it
    t = {}
    t["esvo"] = cuda_ms(lambda: traverse_cuda.trace_cuda(svo, o, d), 50, 3)
    t["frame"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["tile_frame"] = cuda_ms(lambda: diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), 50, 3)
    t["walk"] = cuda_ms(lambda: tile_cuda.tile_walk(*main_args), 50, 3)
    caps = tile._default_caps(ts.top_depth, TILE_BUDGETS["k_max"])
    t["phase1"] = cuda_ms(lambda: tile._candidates(
        ts.pyr, ts.cellmap, corners, o_t[0, 0], ts.top_depth, caps,
        TILE_BUDGETS["k_max"]), 50, 3)
    t["frame_again"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["dda"] = cuda_ms(lambda: brick_dda.brick_dda16(
        dda_args[0], dda_args[1], dda_args[2], *dda_args[3:], depth=10, steps=16), 50, 3)
    t["dda_plain"] = cuda_ms(lambda: brick_dda.dda_steps(
        dda_args[0], dda_args[1], dda_args[2].bool(), *dda_args[3:], depth=10,
        steps=16), 5, 1)
    t["row"] = cuda_ms(lambda: rowread.rowread_rows(table, rows8), 50, 3)
    rows8_long = rows8.long()
    t["row_plain"] = cuda_ms(lambda: table[rows8_long], 50, 3)
    t["row_library"] = cuda_ms(lambda: torch.index_select(table, 0, rows8), 50, 3)
    t["row_scalar"] = cuda_ms(lambda: rowread.rowread_scalar(table, 17), 50, 3)
    t["row_min"] = cuda_ms(lambda: rowread.rowread_min(table, cursors), 50, 3)
    m = {k: med_p80(v) for k, v in t.items()}
    say(f"[timing] {card}: per-ray frame median {m['frame'][0]:.4f} ms (p80 "
        f"{m['frame'][1]:.4f}, n=50; again after the tile frame "
        f"{m['frame_again'][0]:.4f}, p80 {m['frame_again'][1]:.4f}) = "
        f"{n_rays / m['frame'][0] / 1e3:.2f} Mrays/s; esvo_trace median "
        f"{m['esvo'][0]:.4f} ms (p80 {m['esvo'][1]:.4f}); plain trace "
        f"{esvo_plain_ms:.3f} ms (n=1)")
    say(f"[timing] {card}: tile frame median {m['tile_frame'][0]:.4f} ms (p80 "
        f"{m['tile_frame'][1]:.4f}, n=50) = "
        f"{n_rays / m['tile_frame'][0] / 1e3:.2f} Mrays/s at {res}x{res} depth "
        f"{depth}, {n_residual} residual rays; tile_walk (main walk) median "
        f"{m['walk'][0]:.4f} ms (p80 {m['walk'][1]:.4f}); phase 1 (main) median "
        f"{m['phase1'][0]:.4f} ms (p80 {m['phase1'][1]:.4f}); plain walk "
        f"{walk_plain_ms:.3f} ms (n=1)")
    say(f"[timing] {card}: brick_dda16 N={n_dda} median {m['dda'][0]:.4f} ms "
        f"(p80 {m['dda'][1]:.4f}), plain {m['dda_plain'][0]:.4f} ms (n=5); "
        f"rowread rows {m['row'][0]:.4f} ms, scalar {m['row_scalar'][0]:.4f}, "
        f"min {m['row_min'][0]:.4f}, table[idx] {m['row_plain'][0]:.4f}, "
        f"index_select {m['row_library'][0]:.4f} (n=50 each)")

    # one profiler pass over 20 tile frames: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            diff.render_diff_tile(*params, ts, o_t, d_t, corners, light,
                                  **TILE_BUDGETS)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    say(f"[profile] tile frame, 20 frames: {total_us / 20:.1f} us of device "
        f"time a frame; the ten largest, us a frame (launches a frame):")
    for e in rows[:10]:
        say(f"[profile]   {dev_us(e) / 20:9.1f}  ({e.count / 20:6.1f})  {e.key[:90]}")

    # ---- 9. the record --------------------------------------------------------
    # bounds: every input read once and every output written once, against
    # the operations this run's data needed (steps actually taken)
    esvo_bound = bound(
        nbytes(o, d, svo.masks, svo.child_base, svo.leaf_base) + n_rays * 5 * 4,
        esvo_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)
    n_cand = int((ids_main >= 0).sum())
    walk_bound = bound(
        nbytes(o_t, d_t, main_args[3], main_args[4], main_args[5])
        + n_cand * 64 + n_rays * 3 * 4,
        dda_steps_main * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP)
    dda_bound = bound(nbytes(*dda_args) + n_dda * 3 * 4, dda_walked * OPS_DDA_STEP)
    row_bound = bound(nbytes(rows8) + 2 * 8 * 128 * 4, 0)
    src = "raytracingtest_tpu_torch/csrc/"
    kernels = [
        dict(name="esvo_trace", route="cuda", source=src + "esvo_trace.cu",
             replaces="raytracingtest_tpu/ops/traverse_pallas.py:55",
             path="diff.render_diff_cuda", launches=esvo_launches,
             max_abs_err=err["esvo_trace"], ms=m["esvo"][0],
             plain_ms=esvo_plain_ms, bound_ms=esvo_bound[0],
             bound_by=esvo_bound[1], library_ms=None),
        dict(name="tile_walk", route="cuda", source=src + "tile_walk.cu",
             replaces="raytracingtest_tpu/ops/tile.py:432",
             path="diff.render_diff_tile", launches=tile_launches,
             max_abs_err=err["tile_walk"], ms=m["walk"][0],
             plain_ms=walk_plain_ms, bound_ms=walk_bound[0],
             bound_by=walk_bound[1], library_ms=None),
        dict(name="brick_dda16", route="cuda", source=src + "tile_walk.cu",
             replaces="scratch/r4_pallas2.py:115",
             path="brick_dda.brick_dda16", launches=dda_launches,
             max_abs_err=err["brick_dda16"], ms=m["dda"][0],
             plain_ms=m["dda_plain"][0], bound_ms=dda_bound[0],
             bound_by=dda_bound[1], library_ms=None),
        dict(name="rowread", route="cuda", source=src + "tile_walk.cu",
             replaces="scratch/r4_pallas.py:38",
             path="rowread.rowread_scalar/_min/_rows", launches=row_launches,
             max_abs_err=err["rowread"], ms=m["row"][0],
             plain_ms=m["row_plain"][0], bound_ms=row_bound[0],
             bound_by=row_bound[1], library_ms=m["row_library"][0]),
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
