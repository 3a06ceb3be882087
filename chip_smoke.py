"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's native libraries from this checkout (into
build/raytracingtest_tpu_torch/, all at once), checks every hand-written
kernel against its plain PyTorch version on the card, then drives the
benchmark frame, the depth-10 `terrain` SVO seen by bench.py's camera at
1024x1024, forward two ways:

  * ray by ray, through `diff.render_diff_cuda` (kernels `esvo_trace` and
    `shade_fwd`), and
  * tile by tile, through `diff.render_diff_tile` with bench.py's budgets
    (kernels `tile_candidates` and `tile_walk`, three launches each a frame,
    and `shade_fwd`),

  * ray by ray through the brick trace, `diff.render_diff_brick` (kernels
    `brick_trace` and `shade_fwd`; bench.py's BENCH_PATH=brick), and
  * ray by ray through the stackless trace, `diff.render_diff` (kernels
    `esvo_stackless` and `shade_fwd`; bench.py's BENCH_PATH=plain),

and as a training step on all four traversals (`diff.loss_and_grads_cuda`,
`diff.loss_and_grads_tile`, `diff.loss_and_grads_brick`,
`diff.loss_and_grads`: the forward frame, then `shade_bwd` and the
sort-free `segment_sum`), and takes three `InverseRenderer.step_view` steps
on that view and three `InverseRenderer.step` steps on its flat batch of
rays (the brick step). `brick_trace` and `esvo_stackless` are held bitwise
against their plain versions (hits, hit_t bits, step counts and statistics)
on small cases and on the full frame, the brick trace in its forms (wide,
the main path's; first; wide without staged rows) and both in their probe
forms; the rays on which the frames part from `esvo_trace` go to a float64
referee; no call of their plain versions, and no launch of another form,
may happen on their paths. `[warps]` runs each form's probe on the frame
and prints where its warps spend their issues and cycles and when the last
warps end. The two traversal kernels of the first slices
keep their first forms beside them, `esvo_trace_serial` and
`tile_walk_serial` (one thread a ray, off the main path): each kernel is held bitwise against its plain version and its first
form, the walker on each of the frame's three launches and at every number
of lanes a ray, and each pair is timed in turns. `tile_candidates` (phase 1
of the tile trace) is held bitwise against `tile.candidates_plain` on each
of the frame's three calls and on small cases, and timed in turns against
it; no call of the plain version may happen on the tile frame's or the tile
step's path. It runs the probe kernels
(`brick_dda16`, `rowread`, `take`, `loop_probe`, and the sorted form of the
segment sum) at the sizes of the probes they replace, `take` also at the
main path's size, times the parts of one wrapper's launch path on the
host, and counts the tile frame's and tile step's eager ops on the host by
group. One line per phase; any failure raises and the exit code is non-zero.
The last two lines are a JSON record of the kernels and the device. Without
a CUDA device it fails before printing any result.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from raytracingtest_tpu_torch import _build, diff
from raytracingtest_tpu_torch.config import CameraConfig
from raytracingtest_tpu_torch.io import checkpoint
from raytracingtest_tpu_torch.models import InverseRenderer
from raytracingtest_tpu_torch.ops import (
    brick, brick_cuda, brick_dda, camera, gather, octree, rowread, shade_cuda,
    tile, tile_cuda, traverse, traverse_cuda)
from raytracingtest_tpu_torch.render import (
    make_gradient_skybox, sky_color, sky_texture)
from raytracingtest_tpu_torch.scenes import Scene, get_scene

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
# shading one hit ray forward, and its backward (which repeats the forward);
# one trip of the loop probe's body (multiply, add, floor, subtract)
OPS_SHADE_FWD = 45
OPS_SHADE_BWD = 100
OPS_LOOP_ELEM = 4
# phase 1 (tile_candidates): the occupancy test of a child slot (its parent
# from shared memory, the bit of the pyramid word), and the cull and key of
# an occupied child: unmorton 41, the cell's offset from the apex 12, four
# plane tests 28, the half-space 7, t_lb 15, the key 7
OPS_CAND_SLOT = 6
OPS_CAND_CHILD = 110

# calls of plain versions that the main path must not make, counted by
# count_plain_calls()
PLAIN_CALLS = {"candidates_plain": 0, "trace_brick": 0, "trace_stackless": 0}
STAT = traverse.STAT_NAMES.index
# the brick and stackless traces' launch counts: the main path's wrapper,
# the brick trace's other forms' and the probe forms'
BRICK_COUNTS = (brick_cuda.launches, brick_cuda.form_launches,
                brick_cuda.probe_launches)
# each form's kernel, as torch.profiler names it, and the main path's form
FORM_KERNELS = {
    ("brick_trace", "wide"): "brick_trace_kernel<true, false, 256>",
    ("brick_trace", "first"): "brick_trace_kernel<false, false, 128>",
    ("brick_trace", "unstaged"): "brick_trace_kernel<false, false, 256>",
    ("esvo_stackless", "first"): "esvo_stackless_kernel<false>",
}
MAIN_FORM = {"brick_trace": "wide", "esvo_stackless": "first"}
# the err key of a trace_forms entry
FORM_ERR = {"main": "", "first": "_serial", "unstaged": "_unstaged"}


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


def in_turns(variants, rounds=3, reps=50):
    """name -> the milliseconds of rounds * reps calls of each of `variants`
    (name -> fn), every round timing each variant in turn: a host's mood
    lasts longer than one variant's 50 calls, and would favour one of them."""
    samples = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            samples[name].append(cuda_ms(fn, reps, 3))
    return {name: np.concatenate(v) for name, v in samples.items()}


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
    traverse_cuda.serial_launches = tile_cuda.serial_launches = 0
    tile_cuda.candidates_launches = tile_cuda.candidates_block_launches = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0
    for counts in (gather.launches, shade_cuda.launches, *BRICK_COUNTS):
        for name in counts:
            counts[name] = 0


def count_plain_calls():
    """From here on, count every call of ``tile.candidates_plain``,
    ``brick.trace_brick`` and ``traverse.trace_stackless`` in PLAIN_CALLS
    (their callers look them up in their modules at each call)."""
    for mod, name, key in ((tile, "candidates_plain", "candidates_plain"),
                           (brick, "trace_brick", "trace_brick"),
                           (traverse, "trace_stackless", "trace_stackless")):
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _key=key):
            PLAIN_CALLS[_key] += 1
            return _plain(*args)
        setattr(mod, name, counted)


def compare_stats(kern, plain, what):
    """A trace and its statistics ((TraceResult, stats) pairs) bitwise, as
    ``compare`` does; returns the largest absolute difference of hit_t."""
    err = compare(kern[0], plain[0], what)
    if not torch.equal(kern[1], plain[1]):
        bad = int((kern[1] != plain[1]).any(dim=1).sum())
        raise AssertionError(f"{what}: the statistics differ on {bad} rays")
    return err


def ray_sets(dev, cam, n, seed):
    """(name, o, d) on `dev`: a camera's rays, rays from a shell aimed near
    the centre, and rays from inside the cube in random directions."""
    rng = np.random.default_rng(seed)
    inside_d = rng.normal(size=(n, 3))
    inside_d /= np.linalg.norm(inside_d, axis=1, keepdims=True)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return [("camera", *cam.rays(dev)),
            ("random", *(as_dev(a) for a in random_rays(n, seed))),
            ("inside", as_dev(rng.random((n, 3))), as_dev(inside_d))]


def route_line(res, stats):
    """A per-ray route's frame in words: hits, steps a ray and the rays
    that reach each bound."""
    dda = stats[:, STAT("dda_steps")].double()
    top = res.iters.double() - dda
    return (f"{int((res.hit_leaf >= 0).sum())} hits; {float(top.mean()):.2f} top "
            f"steps and {float(dda.mean()):.2f} DDA steps a ray (most "
            f"{int(res.iters.max())} steps, {int(stats[:, STAT('rounds')].max())} "
            f"rounds, {int(stats[:, STAT('dda_max')].max())} DDA steps in one "
            f"round); {int((stats[:, STAT('top_capped')] > 0).sum())} rays reach "
            f"a round's top-step cap, {int(stats[:, STAT('unfinished')].sum())} "
            f"stop unfinished at the route's bound")


def trace_forms(bsvo, svo, o, d):
    """(kernel, form) -> (TraceResult, stats) of brick_trace and
    esvo_stackless on these rays through the main path's wrapper ("main"),
    the brick trace also in its other forms, and every form in its probe
    form (form "... probe")."""
    out = {
        ("brick_trace", "main"): brick_cuda._brick_kernel(bsvo, o, d, True),
        ("brick_trace", "first"): brick_cuda._brick_serial_kernel(bsvo, o, d, True),
        ("brick_trace", "unstaged"): brick_cuda._brick_unstaged_kernel(bsvo, o, d, True),
        ("esvo_stackless", "main"): brick_cuda._stackless_kernel(svo, o, d, True),
        ("esvo_stackless", "first probe"): brick_cuda.probe_stackless_cuda(
            svo, o, d)[:2]}
    for form in brick_cuda.FORMS["brick_trace"]:
        out[("brick_trace", f"{form} probe")] = brick_cuda.probe_brick_cuda(
            bsvo, o, d, form)[:2]
    return out


def ptxas_report(log):
    """(kernel, registers, spill bytes stored, shared bytes) for each
    kernel of brick_trace.cu's ptxas report, named as torch.profiler names
    them."""
    rows, name, stores = [], None, 0
    for line in log.splitlines():
        m = re.search(r"(brick_trace_kernel|esvo_stackless_kernel)I(\w*?)EEv", line)
        if "Compiling entry function" in line:
            name = None
            if m:
                args = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
                name, stores = f"{m.group(1)}<{', '.join(args)}>", 0
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            stores = int(spill.group(1))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name:
            rows.append((name, int(used.group(1)), stores, int(used.group(2) or 0)))
            name = None
    return rows


def warps_line(kernel, form, record, iters):
    """[warps]: one form's per-warp counters on the frame in words: each
    phase's issues a warp, SIMT efficiency (lanes active a issue over 32)
    and share of warp cycles; warp durations; each block's tail; the
    kernel's span and how much of it follows the end of 99 in 100 warps;
    the last warp to end, with its issues against its longest ray's steps.
    Returns the numbers."""
    r = record.cpu().numpy().astype(np.float64)
    f = {k: r[:, i] for i, k in enumerate(brick_cuda.PROBE_FIELDS)}
    cycles = f["end"] - f["start"]
    phases = {}
    for ph in brick_cuda.PHASES:
        issues = f[f"{ph}_issues"].sum()
        if issues:
            phases[ph] = (issues / len(cycles), f[f"{ph}_lanes"].sum() / (32 * issues),
                          f[f"{ph}_cycles"].sum() / cycles.sum())
    t0 = f["ns_start"].min()
    start, end = (f["ns_start"] - t0) / 1e3, (f["ns_end"] - t0) / 1e3
    dur = end - start
    span, t99 = float(end.max()), float(np.percentile(end, 99))
    per_block = brick_cuda.BLOCKS[form] // 32
    ends = end[: len(end) // per_block * per_block].reshape(-1, per_block)
    tail = ends.max(axis=1) - np.median(ends, axis=1)
    last = int(np.argmax(end))
    steps_total = f["step_issues"][last] + f["dda_issues"][last]
    longest = ""
    if last * 32 < len(iters):
        lane_steps = max(int(iters[last * 32:(last + 1) * 32].max()), 1)
        longest = (f", {steps_total:.0f} step and DDA issues for its longest ray's "
                   f"{lane_steps} steps ({steps_total / lane_steps:.2f} issues a step)")
    say(f"[warps] {kernel} {form} ({len(cycles)} warps of {brick_cuda.BLOCKS[form]}-thread "
        f"blocks): " + "; ".join(
            f"{ph} {n:.1f} issues a warp, SIMT {e:.3f}, {c:.3f} of warp cycles"
            for ph, (n, e, c) in phases.items())
        + f"; warp time median {np.median(dur):.2f} us, p99 {np.percentile(dur, 99):.1f}, "
        f"max {dur.max():.1f}; block tail (last warp's end - median warp's end) "
        f"median {np.median(tail):.2f} us, max {tail.max():.1f}; the kernel spans "
        f"{span:.1f} us, 99% of warps ended by {t99:.1f} ({(span - t99) / span:.2f} of "
        f"the span after it); the last warp {last} started at {start[last]:.1f} us "
        f"and ran {dur[last]:.1f}{longest}")
    return dict(phases={ph: dict(issues_a_warp=n, simt=e, cycle_share=c)
                        for ph, (n, e, c) in phases.items()},
                warp_us_median=float(np.median(dur)), warp_us_p99=float(np.percentile(dur, 99)),
                warp_us_max=float(dur.max()), block_tail_us_median=float(np.median(tail)),
                block_tail_us_max=float(tail.max()), span_us=span, t99_us=t99,
                last_warp_start_us=float(start[last]), last_warp_us=float(dur[last]))


def probe_idx(shape, rows, dev):
    """The probes' index pattern: (arange * 7919) mod rows, int32."""
    n = shape[0] * shape[1]
    idx = (torch.arange(n, dtype=torch.int64) * 7919) % rows
    return idx.to(torch.int32).reshape(shape).to(dev)


def gather_cases(dev):
    """(what, kernel call, plain call) for every shape of the S3 and S4
    gather probes (scratch/probe_kernel.py p2a-p2d, scratch/probe2.py
    gather_axis0)."""
    i32 = dict(dtype=torch.int32, device=dev)
    t1 = torch.arange(16384, **i32)
    i1 = probe_idx((8, 128), 16384, dev)
    t4 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4096, 1)).astype(np.float32)).to(dev)
    i4 = probe_idx((8, 128), 4096, dev)
    x = torch.arange(8 * 128, **i32).reshape(8, 128)
    lane = (x * 13) % 128
    cases = [
        ("take_1d int32 table[16384], idx (8,128)",
         lambda: gather.take_1d(t1, i1), lambda: t1[i1.long()]),
        ("take_1d float32 table[16384], idx (8,128)",
         lambda: gather.take_1d(t1.float(), i1), lambda: t1.float()[i1.long()]),
        ("take_onehot float32 table[4096,1], idx (8,128)",
         lambda: gather.take_onehot(t4, i4),
         lambda: gather.onehot_take_plain(t4, i4)),
        ("take_onehot against the gather table[idx]",
         lambda: gather.take_onehot(t4, i4),
         lambda: t4.reshape(-1)[i4.long()]),
        ("take_along_lane int32 x (8,128)",
         lambda: gather.take_along_lane(x, lane),
         lambda: torch.gather(x, 1, lane.long())),
    ]
    for rows, n_idx in ((16384, 8), (8, 8), (16, 16), (32, 32), (64, 64),
                        (256, 256), (1024, 1024)):
        table = torch.arange(rows * 128, **i32).reshape(rows, 128)
        idx = probe_idx((n_idx, 128), rows, dev)
        cases.append((f"take_along0 int32 table ({rows},128), idx ({n_idx},128)",
                      lambda t=table, i=idx: gather.take_along0(t, i),
                      lambda t=table, i=idx: torch.gather(t, 0, i.long())))
    tf = torch.from_numpy(np.random.default_rng(7).random(
        (256, 128), dtype=np.float32)).to(dev)
    idx = probe_idx((256, 128), 256, dev)
    cases.append(("take_along0 float32 table (256,128), idx (256,128)",
                  lambda: gather.take_along0(tf, idx),
                  lambda: torch.gather(tf, 0, idx.long())))
    return cases, (t1, i1), (t4, i4)


def check_grads(got, want, what, rtol=1e-5, atol=1e-7):
    """The three gradients within rtol/atol of the wanted ones; returns the
    largest absolute difference and the largest wanted magnitude."""
    worst = scale = 0.0
    for name, a, b in zip(("albedo", "normal", "density"), got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: d_{name} has a bad shape or value")
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{what}: d_{name} differs by up to {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    return worst, scale


def builtin_grads(hit_leaf, d, target, params, light):
    """The L2 step's gradients by builtin autograd through plain indexing of
    the hit rays' rows alone: no kernel of the port, no custom backward, no
    running sum. A miss's pixel is the sky whatever the parameters are, so it
    adds a constant to the loss and nothing to a gradient."""
    hit = hit_leaf >= 0
    leaf, sky = hit_leaf[hit].long(), sky_color(d[hit])
    every = torch.ones_like(leaf, dtype=torch.bool)

    def loss(a, n, s):
        img = shade_cuda.shade_rows(a[leaf], n[leaf], s[leaf], every, sky,
                                    light, 1.3, 0.08)
        return torch.sum((img - target[hit]) ** 2) / target.numel()
    return diff._value_and_grads(loss, *params)[1]


def serial_scatter_add(hit_leaf, cot, n_leaves):
    """The float32 scatter-add of the hit rays' rows in ray order, one after
    another, on the host (numpy's unbuffered add.at)."""
    leaf = hit_leaf.cpu().numpy()
    hit = leaf >= 0
    out = np.zeros((n_leaves, 7), np.float32)
    np.add.at(out, np.minimum(leaf[hit], n_leaves - 1), cot.cpu().numpy()[hit])
    return out


def join7(grads):
    """(g_albedo, g_normal, g_density) as one (n_leaves, 7) tensor."""
    return torch.cat([grads[0], grads[1], grads[2][:, None]], dim=1)


def check_segment_sum(what, cot, hit_leaf, n_leaves):
    """The sort-free segment sum held bitwise, the sign of zero included,
    against the serial float32 scatter-add in ray order on the host, against
    the sorted form, and against itself over two runs. Returns the sums as
    one (n_leaves, 7) tensor, and the largest absolute difference from the
    serial sums of the sort-free and of the sorted form (0.0 when exact)."""
    sums = join7(shade_cuda.segment_sum(cot, hit_leaf, n_leaves))
    again = join7(shade_cuda.segment_sum(cot, hit_leaf, n_leaves))
    by_sort = join7(shade_cuda.segment_sum_sorted(
        cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves))
    torch.cuda.synchronize()
    serial = torch.from_numpy(
        serial_scatter_add(hit_leaf, cot, n_leaves)).to(cot.device)
    e_new = compare_tensors((sums,), (serial,), ("sums",),
                            f"segment_sum, {what}, against the serial scatter-add")
    e_sorted = compare_tensors(
        (by_sort,), (serial,), ("sums",),
        f"segment_sum_sorted, {what}, against the serial scatter-add")
    compare_tensors((sums,), (by_sort,), ("sums",),
                    f"segment_sum, {what}, against the sorted form")
    compare_tensors((again,), (sums,), ("sums",), f"segment_sum, {what}, run twice")
    return sums, e_new, e_sorted


def check_bwd_forms(cot, args, what):
    """`cot` (shade_bwd's) bitwise against shade_bwd_serial on `args`;
    returns the first form's cot."""
    first = shade_cuda.shade_bwd_serial(*args)
    torch.cuda.synchronize()
    compare_tensors((cot,), (first,), ("cot",), f"{what}, against the first form")
    return first


# The tile frame's host work in groups: the functions of the tile trace and of
# the frame that hold its eager tensor ops, from the innermost out. An op
# counts for the innermost group that it runs in.
HOST_GROUPS = (
    ("phase 1 (tile._candidates)", tile, "_candidates"),
    ("walk launch, ray set-up, unresolved mask (tile._walk_tiles_chunk)", tile,
     "_walk_tiles_chunk"),
    ("tile selection (tile._unresolved_first)", tile, "_unresolved_first"),
    ("sub-tile split (tile._subtile_split)", tile, "_subtile_split"),
    ("sub-tile merge (tile._subtile_merge)", tile, "_subtile_merge"),
    ("the rest of the fallbacks: gathers, substitution (tile._trace_tile_fb)",
     tile, "_trace_tile_fb"),
    ("argument checks (tile.trace_tile_fb)", tile, "trace_tile_fb"),
    ("shading (diff.shade_diff)", diff, "shade_diff"),
    ("loss (diff.l2_loss_tile)", diff, "l2_loss_tile"),
)


def host_groups(fn):
    """One fn() on the host's clock, the functions of HOST_GROUPS wrapped in
    profiler ranges: group -> (top-level aten ops, their host us), where
    an op is top-level if no other aten op called it, and ops outside every
    group (autograd's backward, the residual count) count as "other"."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    saved = []
    for label, mod, name in HOST_GROUPS:
        orig = getattr(mod, name)

        def ranged(*args, _orig=orig, _label=label, **kw):
            with record_function(_label):
                return _orig(*args, **kw)
        saved.append((mod, name, orig))
        setattr(mod, name, ranged)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    labels = {label for label, _m, _n in HOST_GROUPS}
    out = {}
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        up = e.cpu_parent
        if up is not None and up.name.startswith("aten::"):
            continue
        while up is not None and up.name not in labels:
            up = up.cpu_parent
        group = up.name if up is not None else "other"
        ops, us = out.get(group, (0, 0.0))
        out[group] = (ops + 1, us + e.cpu_time_total)
    return out


def us_or(v):
    """A time in us for a line, or "not measured" where the tracer saw none."""
    return "not measured" if v is None else f"{v:.2f}"


def kernel_us(rows, *parts):
    """For each of `parts`, us a launch of the kernel whose name holds it,
    from a profile pass's rows; None where the tracer saw none."""
    return tuple(next((v for k, v in rows.items() if part in k), None)
                 for part in parts)


def host_us(fn, calls=3000):
    """Microseconds of the host's clock for one call of fn(), over `calls`
    calls issued back to back without waiting for the card."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def rowread_rows_old_path(table, idx):
    """``rowread.rowread_rows`` as every wrapper's launch path stood before
    ``_launch.py``, kept here only to time the two paths side by side in one
    run: a check a tensor, the library looked up on every call, a device
    context around the call, a ``torch.cuda.Stream`` object built to read
    its handle."""
    def check(name, t, dtype, shape, device):
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(name)
    device = table.device
    if device.type != "cuda" or table.dim() != 2 or table.numel() == 0:
        raise ValueError("table")
    check("table", table, torch.int32, table.shape, device)
    rows, cols = table.shape
    n_idx = idx.numel()
    check("indices", idx, torch.int32, (n_idx,), device)

    from raytracingtest_tpu_torch._build import tile_lib

    lib = tile_lib()
    out = torch.empty((n_idx, cols), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rowread(
            table.data_ptr(), rows, cols, rowread.MODE_ROWS, None, 0,
            idx.data_ptr(), n_idx, out.data_ptr(), n_idx,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rowread launch failed: cudaError {err}")
    return out


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
CAND_NAMES = ("codes", "ids", "t_codes", "drop_t")
CAND_CALLS = ("main", "enlarged-K", "sub-tile")
# the small cases' budgets that make levels overflow their widths
NARROW = ("narrow", "narrow top")


def check_candidates(args, what):
    """tile_candidates (at the rule's warps a tile and at each of them) and
    its first form, tile_candidates_block, each bitwise against
    candidates_plain on the card (codes, ids, t_codes and drop_t bits).
    Returns the largest float differences of the new and of the first form
    (0.0 when exact) and the number of valid candidates."""
    kern = tile_cuda.candidates(*args)
    every = [tile_cuda.candidates(*args, warps=w) for w in tile_cuda.CANDIDATE_WARPS]
    first = tile_cuda.candidates_block(*args)
    plain = tile.candidates_plain(*args)
    torch.cuda.synchronize()
    e_new = compare_tensors(kern, plain, CAND_NAMES, what)
    for w, got in zip(tile_cuda.CANDIDATE_WARPS, every):
        e_new = max(e_new, compare_tensors(got, plain, CAND_NAMES,
                                           f"{what}, {w} warps a tile"))
    e_first = compare_tensors(first, plain, CAND_NAMES, f"{what}, first form")
    return e_new, e_first, int((kern[1] >= 0).sum())


def candidate_cases(dev, small_cam, inside_cam, horizon_cam):
    """(what, tile_candidates arguments) of the small cases: the tests'
    budgets (tiny, default, wide), bench.py's, the sub-tile pass's on 2x2
    sub-tile corners, the trainer's fb_k = 256, shallow trees whose lists are
    shorter than k_max, a camera inside the solid, the empty scene, and the
    cases of the selection: narrow intermediate levels that overflow in
    many tiles ("narrow"), a finest level that overflows ("narrow top"), and
    a camera on the horizon, whose upper tiles see nothing and whose lower
    ones overflow bench.py's budgets."""
    def budgets(td):
        return {
            "tiny": ((1, 2, 2, 2), 2), "default": (tile._default_caps(td, 48), 48),
            "wide": (tuple(min(160, 8 ** l) for l in range(td + 1)), 160),
            "bench": (tile._default_caps(td, 96), 96),
            "fb2": (tile._fb2_caps(td, 160), 160),
            "fb_k 256": (tuple(min(256, 8 ** l) for l in range(td + 1)), 256),
            "narrow": ((1, 8) + (3,) * (td - 1), 96),
            "narrow top": (tuple(min(64, 8 ** l) for l in range(td + 1)), 40)}
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    cases = []
    for name, depth, cam, which in (
            ("terrain", 6, small_cam, None), ("terrain", 7, small_cam, None),
            ("flat_ground", 6, small_cam, None), ("sphere", 5, small_cam, None),
            ("flat_ground", 4, small_cam, None),
            ("terrain", 6, inside_cam, ("default", "fb_k 256")),
            ("empty", 4, small_cam, ("default",)),
            ("terrain", 7, small_cam, NARROW),
            ("terrain", 7, horizon_cam, ("bench",) + NARROW)):
        scene = empty if name == "empty" else get_scene(name)
        ts = tile.make_tile_svo(octree.build_svo(scene, depth)).to(dev)
        o, d, corners, _grid = tile.tile_rays(cam, dev)
        sub = tile._subtile_split(o, d, corners, 2)[2].contiguous()
        where = ("inside the solid" if cam is inside_cam else
                 "on the horizon" if cam is horizon_cam else "bench camera")
        for b, (caps, k_max) in budgets(ts.top_depth).items():
            if (which is None and b not in NARROW) or (which and b in which):
                c = sub if b == "fb2" else corners
                cases.append((f"{name} d{depth} {where} {b}",
                              (ts.pyr, ts.cellmap, c, o[0, 0], ts.top_depth,
                               caps, k_max)))
    return cases


def candidate_work(args):
    """(bytes, operations) that phase 1 on these arguments needs, counted from
    this run's data: each tile's corners and the apex read once, one pyramid
    word for each kept cell of a level above the finest, one cellmap row for
    each valid candidate, the outputs written once; the occupancy test of
    every child slot of a kept cell, and the cull and key of every occupied
    child. The sort's comparisons are not counted: the function needs the
    smallest `width` keys of a level, which a selection finds without a full
    sort, so they are this implementation's cost, not the work's. A level's
    kept cells are the valid codes of the kernel stopped at that level."""
    pyr, cellmap, corners, apex, td, caps, k_max = args
    widths = tile_cuda.level_widths(td, caps, k_max)
    T = corners.shape[0]
    offs, _ = tile._pyr_layout(td)
    n_words = lambda l: tile._pyr_layout(l)[1]
    codes = torch.zeros((T, 1), dtype=torch.int32, device=corners.device)
    words = slots = occupied = 0
    for l in range(1, td + 1):
        if l > 1:
            codes = tile_cuda.candidates(
                pyr[:n_words(l - 1)], cellmap[:max(1, 8 ** (l - 1) // 32)],
                corners, apex, l - 1, caps, widths[l - 1])[0]
        valid = codes >= 0
        safe = torch.where(valid, codes, 0)
        word = pyr[(offs[l] + (safe >> 2)).long()]
        eight = (word >> ((safe & 3) << 3)) & 0xFF
        words += int(valid.sum())
        slots += 8 * int(valid.sum())
        occupied += int(torch.where(valid, tile._popcount32(eight), 0).sum())
    final = tile_cuda.candidates(*args)
    n_bytes = (nbytes(corners, apex) + words * 4 + int((final[1] >= 0).sum()) * 8
               + nbytes(*final))
    return n_bytes, slots * OPS_CAND_SLOT + occupied * OPS_CAND_CHILD, widths


def level_counts(args):
    """(T, top_depth) int64: for each tile and each level 1..top_depth, the
    valid (non-sentinel) keys phase 1 sees at that level before it keeps
    `width` of them, and the static widths. Counted by the plain version
    stopped at each level with room for every child of the kept cells
    there, so that nothing at that level is dropped."""
    pyr, cellmap, corners, apex, td, caps, k_max = args
    widths = tile_cuda.level_widths(td, caps, k_max)
    cols = [(tile.candidates_plain(pyr, cellmap, corners, apex, l, caps,
                                   8 * widths[l - 1])[0] >= 0).sum(dim=1)
            for l in range(1, td + 1)]
    return torch.stack(cols, dim=1), widths


def work_line(cname, args):
    """The [work] text of one phase-1 call: per level, the mean and the
    largest count of valid keys a tile, the width, and the tiles whose
    count is above the width."""
    counts, widths = level_counts(args)
    counts = counts.float()
    parts = [f"l{l} {float(counts[:, l - 1].mean()):.2f}/"
             f"{int(counts[:, l - 1].max())} of {widths[l]} "
             f"({int((counts[:, l - 1] > widths[l]).sum())} over)"
             for l in range(1, len(widths))]
    return (f"{cname} T={counts.shape[0]} K={args[6]}, "
            f"{int((counts[:, -1] == 0).sum())} tiles see nothing: "
            + ", ".join(parts))


def check_walk(args, what):
    """tile_walk at the rule's G and at every G, and its first form, each
    bitwise against the plain walk. Returns the largest float differences
    of the new and of the first form (0.0 when exact), the rule's G, and the
    hit count."""
    plain = tile.walk_plain(*args)
    first = tile_cuda._walk_serial_kernel(*args)
    kern = tile_cuda._walk_kernel(*args)
    every = [tile_cuda._walk_kernel(*args, lanes=g) for g in tile_cuda.LANES]
    torch.cuda.synchronize()
    e_new = compare_tensors(kern, plain, WALK_NAMES, what)
    e_first = compare_tensors(first, plain, WALK_NAMES, f"{what}, first form")
    for g, got in zip(tile_cuda.LANES, every):
        e_new = max(e_new, compare_tensors(got, plain, WALK_NAMES, f"{what}, G={g}"))
    T, P = args[1].shape[0], args[1].shape[1]
    g = tile_cuda.lanes_per_ray(T, P, tile_cuda.thread_slots(args[1].device))
    return e_new, e_first, g, int((kern[0] >= 0).sum())


def walk_shape(args):
    """(G, blocks, threads a block) of a tile_walk launch at the rule's G,
    as the C launcher computes them."""
    T, P = args[1].shape[0], args[1].shape[1]
    g = tile_cuda.lanes_per_ray(T, P, tile_cuda.thread_slots(args[1].device))
    per_block = min(P, 256 // g)
    return g, T * -(-P // per_block), per_block * g


def walk_bound(args, iters):
    """A walk launch's own bound: its rays' bytes (24 B in, 12 B out a ray),
    its lists (12 B a candidate slot) and its valid candidates' 17-word rows
    read once, against the DDA steps its rays took and their set-up."""
    o, d, codes, ids, t_codes = args[1], args[2], args[3], args[4], args[5]
    n_rays = o.shape[0] * o.shape[1]
    n_bytes = (nbytes(o, d, codes, ids, t_codes) + int((ids >= 0).sum()) * 68
               + n_rays * 12)
    return bound(n_bytes, int(iters.sum()) * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP)

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
        f"brick_trace (nvcc sm_90a) {secs['brick_trace']:.2f} s, "
        f"tile_walk (nvcc sm_90a) {secs['tile_walk']:.2f} s, "
        f"shade (nvcc sm_90a) {secs['shade']:.2f} s, "
        f"tile_candidates (nvcc sm_90a) {secs['tile_candidates']:.2f} s, "
        f"noise (g++) {secs['noise']:.2f} s, side by side in "
        f"{time.perf_counter() - t0:.2f} s, into {_build.BUILD_DIR}")
    ptxas = ptxas_report(_build.build_log("brick_trace"))
    if len(ptxas) != 8:
        raise AssertionError(f"ptxas reported {len(ptxas)} brick_trace.cu kernels, "
                             f"expected 8")
    say("[build] brick_trace.cu, ptxas -v (kernel<staged rows, probe, block>, "
        "esvo_stackless_kernel<probe>: "
        "registers, spill bytes, shared bytes): " + "; ".join(
            f"{k} {r} regs, {sp} spilled, {sm} B shared" for k, r, sp, sm in ptxas))

    # ---- 3. kernels vs plain versions on the card ---------------------------
    count_plain_calls()
    err = dict(esvo_trace=0.0, esvo_trace_serial=0.0, tile_walk=0.0,
               tile_walk_serial=0.0, tile_candidates=0.0,
               tile_candidates_block=0.0, brick_dda16=0.0, rowread=0.0,
               take=0.0, loop_probe=0.0, shade_fwd=0.0, shade_bwd=0.0,
               shade_bwd_serial=0.0, segment_sum=0.0, segment_sum_sorted=0.0,
               brick_trace=0.0, esvo_stackless=0.0, brick_trace_serial=0.0,
               brick_trace_unstaged=0.0)
    for name, depth in (("sphere", 5), ("terrain", 6)):
        svo = octree.build_svo(get_scene(name), depth).to(dev)
        for n in (1000, 4096):
            o, d = (torch.from_numpy(a).to(dev)
                    for a in random_rays(n, seed=depth + n))
            kern = traverse_cuda._trace_kernel(svo, o, d)
            first = traverse_cuda._trace_serial_kernel(svo, o, d)
            plain = traverse.trace(svo, o, d)
            torch.cuda.synchronize()
            err["esvo_trace"] = max(err["esvo_trace"],
                                    compare(kern, plain, f"{name} d{depth} N={n}"))
            err["esvo_trace_serial"] = max(err["esvo_trace_serial"], compare(
                first, plain, f"first form, {name} d{depth} N={n}"))
            compare(kern, first, f"{name} d{depth} N={n}, against the first form")
            hits = int((kern.hit_leaf >= 0).sum())
            say(f"[parity] esvo_trace {name} depth {depth} N={n}: kernel == plain "
                f"== first form (hit ids, iters, hit_t bitwise), {hits} hits")

    bench_cam = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                     fov_y_deg=50.0)
    small_cam = camera.Camera(**bench_cam, width=128, height=128)
    inside_cam = camera.Camera(position=(0.5, 0.05, 0.5), look_at=(0.5, 0.5, 0.5),
                               fov_y_deg=60.0, width=128, height=128)
    horizon_cam = camera.Camera(position=(0.5, 0.5, -0.3), look_at=(0.5, 0.5, 1.0),
                                fov_y_deg=50.0, width=128, height=128)
    cand_cases = candidate_cases(dev, small_cam, inside_cam, horizon_cam)
    cand_valid = []
    # tiles of the selection's cases in which an intermediate level, the
    # finest level overflows its width, and which see nothing at the finest
    selection = dict(intermediate=0, finest=0, nothing=0)
    for what, args in cand_cases:
        e_new, e_first, n_valid = check_candidates(args, f"tile_candidates {what}")
        err["tile_candidates"] = max(err["tile_candidates"], e_new)
        err["tile_candidates_block"] = max(err["tile_candidates_block"], e_first)
        cand_valid.append(n_valid)
        if "narrow" in what or "horizon" in what:
            counts, widths = level_counts(args)
            over = counts > torch.tensor(widths[1:], device=counts.device)
            selection["intermediate"] += int(over[:, :-1].any(dim=1).sum())
            selection["finest"] += int(over[:, -1].sum())
            selection["nothing"] += int((counts[:, -1] == 0).sum())
    if not all(selection.values()):
        raise AssertionError(f"the selection's cases lack a kind of tile: "
                             f"{selection}")
    say(f"[parity] tile_candidates (at the rule's warps a tile and at each of "
        f"{tile_cuda.CANDIDATE_WARPS}) == candidates_plain == "
        f"tile_candidates_block bitwise (codes, ids, t_codes and drop_t bits) "
        f"on {len(cand_cases)} small cases, among them tiles whose "
        f"intermediate levels overflow ({selection['intermediate']}), whose "
        f"finest level overflows ({selection['finest']}) and which see "
        f"nothing ({selection['nothing']}): "
        + ", ".join(f"{what} ({n})" for (what, _a), n in zip(cand_cases, cand_valid))
        + " (valid candidates in brackets)")
    for name, depth in (("terrain", 6), ("terrain", 7), ("flat_ground", 6)):
        ts = tile.make_tile_svo(octree.build_svo(get_scene(name), depth)).to(dev)
        o, d, corners, _grid = tile.tile_rays(small_cam, dev)
        for mode in ("main", "enlarged-K", "sub-tile"):
            args = walk_inputs(ts, o, d, corners, mode)
            e_new, e_first, g, hits = check_walk(args, f"tile_walk {name} d{depth} {mode}")
            err["tile_walk"] = max(err["tile_walk"], e_new)
            err["tile_walk_serial"] = max(err["tile_walk_serial"], e_first)
            say(f"[parity] tile_walk {name} d{depth} {mode}: kernel (G={g} by "
                f"the rule, and every G of {tile_cuda.LANES}) == plain == first "
                f"form (hit_leaf, iters, hit_t bitwise), T={args[1].shape[0]} "
                f"P={args[1].shape[1]} K={args[4].shape[1]}, {hits} hits")

    # the per-ray stackless traces, each kernel against its plain version:
    # small trees, the empty tree (one zero brick row) and a depth-4 tree
    # (a top tree of one level); camera rays, rays from a shell, rays from
    # inside the cube
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    dda_most, parity_lines, n_small = 0, [], 0
    for name, depth in (("sphere", 5), ("terrain", 6), ("terrain", 7),
                        ("flat_ground", 6), ("empty", 5), ("sphere", 4)):
        host = octree.build_svo(empty if name == "empty" else get_scene(name), depth)
        small_svo, small_bsvo = host.to(dev), brick.make_brick_svo(host).to(dev)
        found = []
        for kind, o, d in ray_sets(dev, small_cam, 4096, depth):
            what = f"{name} d{depth} {kind} rays N={o.shape[0]}"
            forms = trace_forms(small_bsvo, small_svo, o, d)
            plain = {"brick_trace": brick.trace_brick(small_bsvo, o, d, True),
                     "esvo_stackless": traverse.trace_stackless(small_svo, o, d, True)}
            torch.cuda.synchronize()
            for (kname, form), got in forms.items():
                e = compare_stats(got, plain[kname], f"{kname} {form}, {what}")
                if form in FORM_ERR:
                    err[kname + FORM_ERR[form]] = max(err[kname + FORM_ERR[form]], e)
            n_small += 1
            kb, ks = forms[("brick_trace", "main")], forms[("esvo_stackless", "main")]
            dda_most = max(dda_most, int(kb[1][:, STAT("dda_max")].max()))
            hits = int((kb[0].hit_leaf >= 0).sum())
            if name == "empty" and (hits or int((ks[0].hit_leaf >= 0).sum())):
                raise AssertionError(f"{what}: a hit in the empty tree")
            found.append(f"{kind} {hits} hits, "
                         f"{int((kb[0].hit_leaf != ks[0].hit_leaf).sum())} parting")
        parity_lines.append(f"{name} d{depth} (top depth {small_bsvo.top_depth}): "
                            + ", ".join(found))
    if dda_most > 22:
        raise AssertionError(f"a brick walk took {dda_most} DDA steps in one "
                             f"round; an 8^3 brick needs at most 22")
    say(f"[parity] brick_trace (through the main path's wrapper, and in its "
        f"forms {brick_cuda.FORMS['brick_trace']}) and esvo_stackless, and every "
        f"probe form == their plain versions (brick.trace_brick, "
        f"traverse.trace_stackless) bitwise (hit_leaf, hit_t bits, hit_parent, "
        f"hit_child, iters, and the statistics a ray), on {n_small} cases: "
        f"camera rays (128x128) and 4,096 rays from a shell and from inside "
        f"the cube: " + "; ".join(parity_lines) + f" (hits of brick_trace; rays "
        f"on which the two traces part in hit_leaf); at most {dda_most} DDA "
        f"steps in a round (the cap of {brick.DDA_ROUND_STEPS} never binds)")

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
    # rows that allow 16-byte loads (the probes' table), rows that do not
    # (130 words a row), and rows of 128 words that start 4 bytes off
    narrow = torch.arange(64 * 130, dtype=torch.int32, device=dev).reshape(64, 130)
    shifted = torch.arange(64 * 128 + 1, dtype=torch.int32,
                           device=dev)[1:].view(64, 128)
    cursors3 = cursors.reshape(4, 256)
    row_checks = [
        ("scalar", rowread.rowread_scalar(table, 17), table[17:18]),
        ("scalars", rowread.rowread_scalar(table, [17, 99, -3, 0, 63, 5, 5, 40]),
         table[[17, 63, 0, 0, 63, 5, 5, 40]]),
        ("min", rowread.rowread_min(table, cursors), table[cursors.min().long()][None]),
        ("min batch", rowread.rowread_min_batch(table, cursors3),
         table[cursors3.amin(dim=1).long()]),
        ("rows", rowread.rowread_rows(table, rows8), table[rows8.long()]),
    ]
    for what, other in (("130-word rows", narrow), ("rows 4 bytes off", shifted)):
        row_checks += [
            (f"rows, {what}", rowread.rowread_rows(other, rows8), other[rows8.long()]),
            (f"scalar, {what}", rowread.rowread_scalar(other, 17), other[17:18]),
            (f"min batch, {what}", rowread.rowread_min_batch(other, cursors3),
             other[cursors3.amin(dim=1).long()])]
    torch.cuda.synchronize()
    for mode, got, want in row_checks:
        err["rowread"] = max(err["rowread"], compare_tensors(
            (got,), (want,), (mode,), f"rowread {mode}"))
    say(f"[parity] rowread (64,128) int32: kernel == table[idx] in the scalar, "
        f"min-of-cursors and eight-rows modes and in their batch forms (eight "
        f"scalars a launch, four cursor blocks a launch), with 16-byte loads, "
        f"and with word loads on 130-word rows and on rows 4 bytes off "
        f"({len(row_checks)} checks)")

    cases, (take_table, take_idx), (hot_table, hot_idx) = gather_cases(dev)
    for what, kernel_call, plain_call in cases:
        got, want = kernel_call(), plain_call()
        torch.cuda.synchronize()
        err["take"] = max(err["take"], compare_tensors((got,), (want,), (what,), what))
    say(f"[parity] take: kernel == plain bitwise on {len(cases)} gathers (1-D "
        f"int32 and float32 of 16,384 rows; the one-hot product of 4,096 rows; "
        f"along rows for 8 to 16,384 rows; along lanes)")

    loop_x = torch.linspace(0, 1, 512 * 128, device=dev).reshape(512, 128)
    loop_table = torch.from_numpy(np.random.default_rng(8).random(
        (512, 128), dtype=np.float32)).to(dev)
    loop_plain_ms = {}
    for iters, rows in ((64, 0), (2048, 0), (64, 512), (2048, 512)):
        got = gather.loop_probe(loop_x, loop_table, iters, 8, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = gather.loop_probe_plain(loop_x, loop_table, iters, 8, rows,
                                       gather.LOOP_FLOAT)
        torch.cuda.synchronize()
        loop_plain_ms[(iters, rows)] = (time.perf_counter() - t0) * 1e3
        what = f"loop_probe float (512,128), {iters} trips, gather rows {rows}"
        err["loop_probe"] = max(err["loop_probe"], compare_tensors(
            (got,), (want,), ("x",), what))
    int_table = torch.arange(16384 * 128, dtype=torch.int32,
                             device=dev).reshape(16384, 128)
    int_idx = probe_idx((8, 128), 16384, dev)
    got = gather.loop_probe(int_idx, int_table, 256, 0, 16384, gather.LOOP_INT)
    want = gather.loop_probe_plain(int_idx, int_table, 256, 0, 16384,
                                   gather.LOOP_INT)
    torch.cuda.synchronize()
    compare_tensors((got,), (want,), ("acc",), "loop_probe int")
    say("[parity] loop_probe: kernel == plain bitwise, float mode (512,128) at "
        "64 and 2048 trips of 8 steps, without and with a 512-row gather each "
        "trip; integer mode (8,128) summing 256 gathered rows of a "
        "(16384,128) table")

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
    # the stackless trace climbs through parent pointers: derived once on the
    # card (a loaded SVO carries none), held against the host's
    pptr = traverse.derive_parent_ptr(svo.masks, svo.child_base)
    if not torch.equal(pptr.cpu(), torch.from_numpy(octree.compute_parent_ptr(
            host_svo.masks.numpy(), host_svo.child_base.numpy()))):
        raise AssertionError("derive_parent_ptr on the card differs from the host's")
    svo = dataclasses.replace(svo, parent_ptr=pptr)
    bsvo = ts.bsvo
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
    if (esvo_launches != 1 or shade_cuda.launches["shade_fwd"] != 1
            or traverse_cuda.serial_launches):
        raise AssertionError("the frame did not launch the traversal and the "
                             "shading kernel once each")
    if img.shape != (n_rays, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: shape {tuple(img.shape)} or non-finite")

    # the frame against its plain version on the same card and inputs
    t0 = time.perf_counter()
    plain = traverse.trace(svo, o, d)
    torch.cuda.synchronize()
    esvo_plain_ms = (time.perf_counter() - t0) * 1e3
    kern = traverse_cuda.trace_cuda(svo, o, d)
    first = traverse_cuda.trace_cuda_serial(svo, o, d)
    err["esvo_trace"] = max(err["esvo_trace"],
                            compare(kern, plain, "terrain d10 frame"))
    err["esvo_trace_serial"] = max(err["esvo_trace_serial"], compare(
        first, plain, "terrain d10 frame, first form"))
    compare(kern, first, "terrain d10 frame, against the first form")
    img_plain = diff.shade_diff_plain(plain.hit_leaf, d, *params, light, 1.3, 0.08)
    img_err = float((img - img_plain).abs().max())
    if img_err > 1e-6:
        raise AssertionError(f"frame differs from the plain path by {img_err}")
    hits = int((kern.hit_leaf >= 0).sum())
    esvo_steps = int(kern.iters.sum())
    say(f"[frame] {res}x{res}: {esvo_launches} kernel launch(es) in the frame, "
        f"{hits} hits, {esvo_steps / n_rays:.2f} steps a ray, hits == plain "
        f"trace == esvo_trace_serial (bitwise: hit_leaf, hit_t, hit_parent, "
        f"hit_child, iters), image == plain path (max abs {img_err}), finite")

    # ---- 5c. main path ray by ray through the brick and stackless traces -----
    per_ray = kern
    voxels = leaf_voxels(host_ts)
    routes = {}
    for route, kname, render, kernel_call, plain_call in (
            ("brick", "brick_trace",
             lambda: diff.render_diff_brick(*params, bsvo, o, d, light),
             lambda: brick_cuda._brick_kernel(bsvo, o, d, True),
             lambda: brick.trace_brick(bsvo, o, d, True)),
            ("plain", "esvo_stackless",
             lambda: diff.render_diff(*params, svo, o, d, light),
             lambda: brick_cuda._stackless_kernel(svo, o, d, True),
             lambda: traverse.trace_stackless(svo, o, d, True))):
        reset_counts()
        img_r = render()
        torch.cuda.synchronize()
        launched = dict(brick_cuda.launches)
        want = dict(brick_trace=int(route == "brick"),
                    esvo_stackless=int(route == "plain"))
        other_forms = {**brick_cuda.form_launches, **brick_cuda.probe_launches}
        if (launched != want or any(other_forms.values()) or traverse_cuda.launches
                or shade_cuda.launches["shade_fwd"] != 1
                or PLAIN_CALLS["trace_brick"] or PLAIN_CALLS["trace_stackless"]):
            raise AssertionError(f"the {route} frame launched {launched} and "
                                 f"{other_forms}, esvo_trace "
                                 f"{traverse_cuda.launches} times, plain calls "
                                 f"{PLAIN_CALLS}; expected {want}")
        if img_r.shape != (n_rays, 3) or not bool(torch.isfinite(img_r).all()):
            raise AssertionError(f"bad {route} image: shape or non-finite")
        # the kernel against its plain version on the same card and inputs
        t0 = time.perf_counter()
        plain_r = plain_call()
        torch.cuda.synchronize()
        route_plain_ms = (time.perf_counter() - t0) * 1e3
        res_r, st_r = kernel_call()
        err[kname] = max(err[kname], compare_stats(
            (res_r, st_r), plain_r, f"{kname}, terrain d10 frame"))
        img_plain_r = diff.shade_diff_plain(plain_r[0].hit_leaf, d, *params,
                                            light, 1.3, 0.08)
        img_err_r = float((img_r - img_plain_r).abs().max())
        if img_err_r > 1e-6:
            raise AssertionError(f"{route} frame differs from its plain path by "
                                 f"{img_err_r}")
        # rays on which the route parts from esvo_trace, to the referee; a
        # ray that this route's bound stopped is counted, not excused
        unfinished = st_r[:, STAT("unfinished")] == 1
        differ = res_r.hit_leaf != per_ray.hit_leaf
        n_differ = int(differ.sum())
        if n_differ > MAX_DIFFER + int(unfinished.sum()):
            raise AssertionError(f"{route} frame: {n_differ} rays hit another "
                                 f"leaf than esvo_trace")
        verdict_r = referee(
            voxels, depth, o[differ].cpu().numpy(), d[differ].cpu().numpy(),
            dict(route=res_r.hit_leaf[differ].cpu().numpy(),
                 per_ray=per_ray.hit_leaf[differ].cpu().numpy()))
        cut_here = unfinished[differ].cpu().numpy()
        wrong = ~verdict_r["route"] & ~cut_here
        if wrong.any():
            raise AssertionError(f"{route} frame: wrong on {int(wrong.sum())} "
                                 f"finished rays of the {n_differ} where it parts "
                                 f"from esvo_trace")
        per_ray_cut = differ & (per_ray.iters >= traverse.max_iters_for_depth(depth))
        routes[route] = dict(res=res_r, stats=st_r, differ=differ,
                             unfinished=unfinished, plain_ms=route_plain_ms,
                             launches=launched[kname])
        say(f"[frame-{route}] {res}x{res} depth {depth}: {kname} (its "
            f"{MAIN_FORM[kname]} form) launched {launched[kname]} time(s) in the frame, shade_fwd once, no "
            f"other form and no plain call; " + route_line(res_r, st_r) + f"; kernel == plain version "
            f"on the card, bitwise (hit_leaf, hit_t, hit_parent, hit_child, "
            f"iters, statistics; the plain version {route_plain_ms:.1f} ms, n=1); "
            f"image == plain path (max abs {img_err_r}); parts from esvo_trace "
            f"on {n_differ} rays, where the float64 referee finds this route "
            f"right on {int(verdict_r['route'].sum())} and esvo_trace right on "
            f"{int(verdict_r['per_ray'].sum())}; of them {int(cut_here.sum())} "
            f"stopped unfinished at this route's bound (the referee finds "
            f"esvo_trace right on {int(verdict_r['per_ray'][cut_here].sum())} of "
            f"those) and {int(per_ray_cut.sum())} ran into esvo_trace's "
            f"{traverse.max_iters_for_depth(depth)}-step bound")
    both = ~routes["plain"]["unfinished"]
    apart = both & (routes["brick"]["res"].hit_leaf != routes["plain"]["res"].hit_leaf)
    say(f"[frame-brick] the brick and stackless frames part on {int(apart.sum())} "
        f"of the rays the stackless trace finishes (each refereed above where it "
        f"parts from esvo_trace), and the brick trace finishes all "
        f"{int((~both).sum())} that the stackless trace leaves: "
        f"{int((routes['brick']['res'].hit_leaf[~both] >= 0).sum())} of them hits")

    # ---- 5d. every form of the two traces on the frame, and their warps -------
    reference = {"brick_trace": (routes["brick"]["res"], routes["brick"]["stats"]),
                 "esvo_stackless": (routes["plain"]["res"], routes["plain"]["stats"])}
    for (kname, form), got in trace_forms(bsvo, svo, o, d).items():
        e = compare_stats(got, reference[kname], f"{kname} {form}, terrain d10 frame")
        if form in FORM_ERR:
            err[kname + FORM_ERR[form]] = max(err[kname + FORM_ERR[form]], e)
    torch.cuda.synchronize()
    say(f"[frame-forms] {res}x{res} depth {depth}: brick_trace in its forms "
        f"{brick_cuda.FORMS['brick_trace']}, esvo_stackless, and every probe form "
        f"== the plain versions bitwise (hit_leaf, hit_t, hit_parent, hit_child, "
        f"iters, statistics)")
    warp_counts = {}
    for kname in ("brick_trace", "esvo_stackless"):
        for form in brick_cuda.FORMS[kname]:
            probe = (brick_cuda.probe_brick_cuda(bsvo, o, d, form) if kname == "brick_trace"
                     else brick_cuda.probe_stackless_cuda(svo, o, d))
            torch.cuda.synchronize()
            compare_stats(probe[:2], reference[kname], f"{kname} {form} probe, frame")
            warp_counts[(kname, form)] = warps_line(kname, form, probe[2],
                                              reference[kname][0].iters.cpu().numpy())
    say("[warps] the probe forms' results == the plain versions' bitwise; issue "
        "and lane counts are exact, cycle shares inside divergent code are "
        "approximate (another branch's lanes may run between a phase's two "
        "clock reads); times from the card's global timer")

    # ---- 5b. the shading kernels on that frame vs their plain versions ----------
    hit_leaf = kern.hit_leaf
    n_leaves = svo.n_leaves
    rng = np.random.default_rng(10)
    as_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    density = rng.uniform(-0.2, 1.3, n_leaves)
    density[::7], density[3::7] = 1.0, 0.0     # ties of the clip
    perturbed = (
        params[0] * as_dev(rng.uniform(0.5, 1.0, (n_leaves, 1))),
        params[1] * as_dev(rng.uniform(0.5, 2.0, (n_leaves, 1))),
        as_dev(density))
    sky_tex = sky_texture(d, as_dev(make_gradient_skybox()
                                    * rng.uniform(0.5, 1.0, (64, 128, 3))))
    g_unit = as_dev(rng.uniform(-0.5, 0.5, (n_rays, 3)))
    fwd_bits = 0
    for what, pset, sky in (("the scene's parameters", params, None),
                            ("perturbed parameters", perturbed, None),
                            ("perturbed parameters, textured sky", perturbed,
                             sky_tex)):
        got = shade_cuda.shade_fwd(hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        want = diff.shade_diff_plain(hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if got.shape != want.shape or not e <= 1e-6:
            raise AssertionError(f"shade_fwd, {what}: max abs {e} against the "
                                 f"plain version")
        err["shade_fwd"] = max(err["shade_fwd"], e)
        fwd_bits += int((bits(got) != bits(want)).any(dim=1).sum())
        got = shade_cuda.shade_bwd(g_unit, hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        want = shade_cuda.shade_bwd_plain(g_unit, hit_leaf, d, *pset, light,
                                          1.3, 0.08, sky)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"shade_bwd, {what}: max abs {e} against "
                                 f"autograd through the plain version")
        if bool(got[hit_leaf < 0].any()):
            raise AssertionError("shade_bwd: a miss has a cotangent")
        err["shade_bwd"] = max(err["shade_bwd"], e)
        first = check_bwd_forms(got, (g_unit, hit_leaf, d, *pset, light, 1.3,
                                      0.08, sky), f"shade_bwd, {what}")
        err["shade_bwd_serial"] = max(err["shade_bwd_serial"], float(
            (first - want).abs().max()))
    # the cotangent 4 bytes off a 16-byte boundary: the word-by-word staging
    g_off = torch.empty(n_rays * 3 + 1, device=dev)[1:].view(n_rays, 3)
    g_off.copy_(g_unit)
    check_bwd_forms(shade_cuda.shade_bwd(g_off, hit_leaf, d, *perturbed, light,
                                         1.3, 0.08),
                    (g_unit, hit_leaf, d, *perturbed, light, 1.3, 0.08),
                    "shade_bwd, a cotangent 4 bytes off")
    say(f"[parity] shade_fwd on the {res}x{res} frame, three parameter sets: "
        f"max abs {err['shade_fwd']} against the plain version (limit 1e-6), "
        f"{fwd_bits} of {3 * n_rays} pixels differ in bits; shade_bwd with a "
        f"cotangent in [-0.5, 0.5): == shade_bwd_serial bitwise (also on a "
        f"cotangent 4 bytes off a 16-byte boundary), max abs "
        f"{err['shade_bwd']} against autograd "
        f"through the plain version (rtol 1e-5, atol 1e-6), rows of misses "
        f"zero")

    keys, order = shade_cuda.sort_by_leaf(hit_leaf, n_leaves)
    safe_leaf = torch.where(hit_leaf >= 0, hit_leaf, 0)
    seg_plain_err = 0.0
    for what, g in (("a unit cotangent", g_unit),
                    ("the step's cotangent", 2.0 * img / img.numel())):
        cot = shade_cuda.shade_bwd(g, hit_leaf, d, *perturbed, light, 1.3, 0.08)
        check_bwd_forms(cot, (g, hit_leaf, d, *perturbed, light, 1.3, 0.08),
                        f"shade_bwd, {what}")
        sums, e_new, e_sorted = check_segment_sum(what, cot, hit_leaf, n_leaves)
        err["segment_sum"] = max(err["segment_sum"], e_new)
        err["segment_sum_sorted"] = max(err["segment_sum_sorted"], e_sorted)
        plain_sums = diff._segment_reduce_cols(safe_leaf, cot, n_leaves)
        e = float((sums - plain_sums).abs().max())
        if not e <= 1e-4:
            raise AssertionError(f"segment_sum, {what}: {e} off the plain sort "
                                 f"+ running-sum form")
        seg_plain_err = max(seg_plain_err, e)
    seg_cot = cot
    say(f"[parity] segment_sum, {n_rays} rows into {n_leaves} leaves, two "
        f"cotangents: the sort-free kernels == serial float32 scatter-add in "
        f"ray order == the sorted form, bitwise with the sign of zero; two "
        f"runs bitwise equal; max abs {seg_plain_err} off the plain sort + "
        f"running-sum form (limit 1e-4)")

    # long runs, which take the block-a-leaf route: one leaf hit by 70,000
    # more rays (sorted in place in the ray list), a few hundred leaves with
    # 17 to 2,048 rays (sorted in shared memory), and every hit on one leaf.
    # The rows are random with -0.0 among them, the misses' rows too: a miss
    # adds nothing whatever its row holds.
    wild = rng.uniform(-0.5, 0.5, (n_rays, 7)).astype(np.float32)
    wild[rng.random((n_rays, 7)) < 0.2] = np.float32(-0.0)
    wild = torch.from_numpy(wild).to(dev)
    long_leaf = hit_leaf.clone()
    pick = torch.from_numpy(rng.permutation(n_rays)).to(dev)
    long_leaf[pick[:70000]] = 12345
    at = 70000
    for k, run in enumerate((17, 18, 31, 33, 100, 511, 512, 513, 1000, 2047,
                             2048, 2049, 4097) * 20):
        long_leaf[pick[at:at + run]] = 20000 + 7 * k
        at += run
    long_leaf[pick[at:at + 50000]] = n_leaves + 5          # clamps to the last
    longest = int(torch.bincount(long_leaf[long_leaf >= 0].long().clamp(
        max=n_leaves - 1)).max())
    if longest < 65536:
        raise AssertionError(f"the long-run case's longest run is {longest}")
    seg_case_ms = {}
    for what, leafs, leaves in (
            (f"one leaf hit by {longest} rays and 260 leaves given 17 to 4,097 "
             f"more",
             long_leaf, n_leaves),
            (f"one leaf in all, hit by {hits} rays", hit_leaf, 1)):
        _sums, e_new, e_sorted = check_segment_sum(what, wild, leafs, leaves)
        err["segment_sum"] = max(err["segment_sum"], e_new)
        err["segment_sum_sorted"] = max(err["segment_sum_sorted"], e_sorted)
        seg_case_ms[what] = (
            float(np.median(cuda_ms(lambda: shade_cuda.segment_sum(
                wild, leafs, leaves), 3, 1))),
            float(np.median(cuda_ms(lambda: shade_cuda.segment_sum_sorted(
                wild, *shade_cuda.sort_by_leaf(leafs, leaves), leaves), 3, 1))))
    say("[parity] segment_sum on long runs, random rows with -0.0 and with "
        "rows on the misses: == serial scatter-add == the sorted form, "
        "bitwise, two runs equal; " + "; ".join(
            f"{what}: {new:.4f} ms (the sorted form with its sort {old:.4f})"
            for what, (new, old) in seg_case_ms.items()) + " (medians of 3)")

    # ---- 6. main path, tile by tile ----------------------------------------------
    o_t, d_t, corners, grid = tile.tile_rays(cam, dev)
    reset_counts()
    img_t, residual = diff.render_diff_tile(*params, ts, o_t, d_t, corners,
                                            light, **TILE_BUDGETS)
    torch.cuda.synchronize()
    tile_launches = tile_cuda.launches
    cand_launches = tile_cuda.candidates_launches
    if tile_launches != 3 or cand_launches != 3:
        raise AssertionError(f"the tile frame launched the walker "
                             f"{tile_launches} times and tile_candidates "
                             f"{cand_launches} times, expected 3 each")
    if PLAIN_CALLS["candidates_plain"]:
        raise AssertionError(f"the tile frame called candidates_plain "
                             f"{PLAIN_CALLS['candidates_plain']} times")
    if (traverse_cuda.launches or brick_dda.launches or rowread.launches
            or tile_cuda.serial_launches or tile_cuda.candidates_block_launches
            or shade_cuda.launches["shade_fwd"] != 1):
        raise AssertionError("the tile frame launched a kernel it has no use "
                             "for, or not the shading kernel once")
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

    # the frame's three phase-1 calls and three walks (main, enlarged-K,
    # sub-tile) with the very arguments the frame gives them: each call held
    # bitwise against candidates_plain, each walk against the plain walk and
    # the first form, at the rule's G and at every G
    walks, cands = [], []
    walk_kernel, cand_kernel = tile_cuda.tile_walk, tile_cuda.candidates
    tile_cuda.tile_walk = lambda *args: walks.append(args) or walk_kernel(*args)
    tile_cuda.candidates = lambda *args: cands.append(args) or cand_kernel(*args)
    try:
        tile.trace_tile_fb(ts, o_t, d_t, corners, **TILE_BUDGETS)
    finally:
        tile_cuda.tile_walk, tile_cuda.candidates = walk_kernel, cand_kernel
    if len(walks) != 3 or len(cands) != 3:
        raise AssertionError(f"the tile frame made {len(walks)} walks and "
                             f"{len(cands)} phase-1 calls, expected 3 each")
    cand_rows = {}
    for cname, args in zip(CAND_CALLS, cands):
        e_new, e_first, n_valid = check_candidates(
            args, f"tile_candidates d10 frame, {cname}")
        err["tile_candidates"] = max(err["tile_candidates"], e_new)
        err["tile_candidates_block"] = max(err["tile_candidates_block"], e_first)
        n_bytes, n_ops, widths = candidate_work(args)
        b = bound(n_bytes, n_ops)
        cand_rows[cname] = dict(
            T=args[2].shape[0], K=args[6], widths=widths,
            warps=tile_cuda.candidate_warps(widths),
            children_a_tile=8 * sum(widths[:-1]),
            widest_sort=max(8 * w for w in widths[:-1]),
            valid_a_tile=n_valid / args[2].shape[0], bytes=n_bytes, ops=n_ops,
            bound_ms=b[0], bound_by=b[1])
    say("[parity] tile_candidates d10 frame: kernel (at the rule's warps a "
        "tile and at each) == candidates_plain == tile_candidates_block bitwise "
        "(codes, ids, t_codes and drop_t bits) on the frame's three calls: "
        + "; ".join(f"{c} T={r['T']} K={r['K']} widths {r['widths']} "
                    f"({r['children_a_tile']} child slots a tile, widest level "
                    f"{r['widest_sort']}), {r['warps']} warps a tile by the "
                    f"rule, {r['valid_a_tile']:.2f} valid a tile"
                    for c, r in cand_rows.items()))
    say("[work] valid keys a tile at each level of the frame's phase-1 calls, "
        "mean/largest of the width kept there (tiles above the width): "
        + "; ".join(work_line(c, a) for c, a in zip(CAND_CALLS, cands)))
    WALKS = ("main", "enlarged-K", "sub-tile")
    walk_rows = {}
    for wname, args in zip(WALKS, walks):
        e_new, e_first, g, _hits = check_walk(args, f"tile_walk d10 frame, {wname}")
        err["tile_walk"] = max(err["tile_walk"], e_new)
        err["tile_walk_serial"] = max(err["tile_walk_serial"], e_first)
        iters_w = tile_cuda._walk_kernel(*args)[2]
        g, blocks, threads = walk_shape(args)
        b = walk_bound(args, iters_w)
        walk_rows[wname] = dict(
            T=args[1].shape[0], P=args[1].shape[1], K=args[4].shape[1], G=g,
            blocks=blocks, threads=threads, bound_ms=b[0], bound_by=b[1],
            dda_steps_a_ray=float(iters_w.float().mean()))
        say(f"[frame-tile] walk {wname}: T={args[1].shape[0]} P={args[1].shape[1]} "
            f"K={args[4].shape[1]}, G={g} lanes a ray, {blocks} blocks of "
            f"{threads} threads, {float(iters_w.float().mean()):.2f} DDA steps a "
            f"ray, bound {b[0]:.5f} ms ({b[1]}); kernel at every G == plain == "
            f"first form, bitwise")
    main_args = walks[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_w = tile.walk_plain(*main_args)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    ids_main = main_args[4]
    dda_steps_main = int(plain_w[2].sum())
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
    for _what, kernel_call, _plain in cases:
        kernel_call()
    loop_out = [gather.loop_probe(loop_x, loop_table, iters, 8, rows)
                for iters, rows in loop_plain_ms]
    gather.loop_probe(int_idx, int_table, 256, 0, 16384, gather.LOOP_INT)
    shade_cuda.segment_sum_sorted(seg_cot, keys, order, n_leaves)
    traverse_cuda.trace_cuda_serial(svo, o, d)
    tile_cuda.tile_walk_serial(*main_args)
    tile_cuda.candidates_block(*cands[0])
    shade_cuda.shade_bwd_serial(g_unit, hit_leaf, d, *params, light, 1.3, 0.08)
    brick_cuda.trace_brick_cuda_serial(bsvo, o, d)
    brick_cuda._brick_unstaged_kernel(bsvo, o, d)
    torch.cuda.synchronize()
    dda_launches, row_launches = brick_dda.launches, rowread.launches
    first_launches = dict(esvo_trace_serial=traverse_cuda.serial_launches,
                          tile_walk_serial=tile_cuda.serial_launches,
                          tile_candidates_block=tile_cuda.candidates_block_launches,
                          shade_bwd_serial=shade_cuda.launches["shade_bwd_serial"],
                          **brick_cuda.form_launches)
    take_launches = gather.launches["take"]
    loop_launches = gather.launches["loop_probe"]
    sorted_launches = shade_cuda.launches["segment_sum_sorted"]
    if (dda_launches != 1 or row_launches != 3 or take_launches != len(cases)
            or loop_launches != 5 or sorted_launches != 1
            or first_launches != dict(esvo_trace_serial=1, tile_walk_serial=1,
                                      tile_candidates_block=1, shade_bwd_serial=1,
                                      brick_trace_serial=1, brick_trace_unstaged=1)
            or any(brick_cuda.launches.values())
            or traverse_cuda.launches or tile_cuda.launches
            or tile_cuda.candidates_launches or shade_cuda.launches["shade_bwd"]):
        raise AssertionError("the probes did not launch their kernels")
    if not all(bool(((x >= 0) & (x < 1.001)).all()) for x in loop_out):
        raise AssertionError("loop_probe: a fraction left [0, 1)")
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
        f"launches (scalar, min, rows); take: {take_launches} launches; "
        f"loop_probe: {loop_launches} launches; segment_sum_sorted (the "
        f"sorted form, off the training path): {sorted_launches} launch; the "
        f"first forms and the unstaged wide form, off the main path: {first_launches}")

    # ---- 7b. the training step, on all four traversals -----------------------
    hit_tile = res_fb.hit_leaf
    d_flat = d_t.reshape(-1, 3)
    target_rand = torch.from_numpy(np.random.default_rng(11).random(
        (n_rays, 3), dtype=np.float32)).to(dev)
    touched = torch.bincount(hit_leaf[hit_leaf >= 0].long(), minlength=n_leaves) > 0
    grads_by_path = {}
    train_launches = {}
    for what, target in (("target 0", torch.zeros_like(target_rand)),
                         ("a seeded random target", target_rand)):
        steps = (
            ("per-ray", lambda: diff.loss_and_grads_cuda(
                *params, svo, o, d, light, target), hit_leaf, d, target),
            ("tile", lambda: diff.loss_and_grads_tile(
                *params, ts, o_t, d_t, corners, light,
                tile.tile_pixels(target, grid), **TILE_BUDGETS),
             hit_tile, d_flat, tile.tile_pixels(target, grid)),
            ("brick", lambda: diff.loss_and_grads_brick(
                *params, bsvo, o, d, light, target),
             routes["brick"]["res"].hit_leaf, d, target),
            ("plain", lambda: diff.loss_and_grads(
                *params, svo, o, d, light, target),
             routes["plain"]["res"].hit_leaf, d, target))
        for path, step, leafs, dirs, tgt in steps:
            reset_counts()
            out, grads = step()
            torch.cuda.synchronize()
            counts = dict(esvo_trace=traverse_cuda.launches,
                          tile_walk=tile_cuda.launches,
                          tile_candidates=tile_cuda.candidates_launches,
                          tile_candidates_block=tile_cuda.candidates_block_launches,
                          **brick_cuda.launches, **PLAIN_CALLS,
                          **shade_cuda.launches)
            others = [k for c in BRICK_COUNTS[1:] for k, v in c.items() if v]
            want = dict(esvo_trace=int(path == "per-ray"),
                        tile_walk=3 if path == "tile" else 0,
                        tile_candidates=3 if path == "tile" else 0,
                        tile_candidates_block=0,
                        brick_trace=int(path == "brick"),
                        esvo_stackless=int(path == "plain"),
                        candidates_plain=0, trace_brick=0, trace_stackless=0,
                        shade_fwd=1, shade_bwd=1, shade_bwd_serial=0,
                        segment_sum=1, segment_sum_sorted=0)
            if counts != want or others:
                raise AssertionError(f"{path} step, {what}: launches {counts}, "
                                     f"expected {want}; other forms: {others}")
            train_launches[path] = counts
            loss, n_res = (out[0], int(out[1])) if path == "tile" else (out, 0)
            if not bool(torch.isfinite(loss)) or n_res != 0:
                raise AssertionError(f"{path} step, {what}: loss {float(loss)}, "
                                     f"{n_res} residual rays")
            # the same loss through the plain autograd path on the card
            loss_plain, grads_plain = diff._value_and_grads(
                lambda a, n, s: torch.mean((diff.shade_diff_plain(
                    leafs, dirs, a, n, s, light, 1.3, 0.08) - tgt) ** 2), *params)
            worst, scale = check_grads(grads, grads_plain, f"{path} step, {what}")
            # the tight check: builtin autograd over the hit rows. A leaf one
            # ray hits has a gradient some hundredth of the largest, so the
            # absolute tolerance is scaled to the run.
            tight_atol = 1e-6 * scale
            worst_tight, _ = check_grads(
                grads, builtin_grads(leafs, dirs, tgt, params, light),
                f"{path} step, {what}, against builtin autograd", atol=tight_atol)
            if not torch.allclose(loss, loss_plain, rtol=1e-5):
                raise AssertionError(f"{path} step, {what}: loss {float(loss)} "
                                     f"against plain {float(loss_plain)}")
            touched_p = torch.bincount(leafs[leafs >= 0].long(),
                                       minlength=n_leaves) > 0
            if path != "tile" and bool(join7(grads)[~touched_p].any()):
                raise AssertionError(f"{path} step, {what}: a leaf no ray hit "
                                     f"has a gradient")
            grads_by_path[(path, what)] = grads
            say(f"[train] {path} step, {what}: launches {counts}; loss "
                f"{float(loss):.6f}; gradients within rtol 1e-5 / atol "
                f"{tight_atol:.1e} (1e-6 of the largest gradient, {scale:.3e}) "
                f"of builtin autograd through plain indexing of the hit rows "
                f"(max abs {worst_tight:.3e}), and within rtol 1e-5 / atol 1e-7 "
                f"of the plain sort + running-sum backward on the card (max "
                f"abs {worst:.3e}); "
                + (f"{int(touched_p.sum())} of {n_leaves} leaves touched, the "
                   f"others exactly zero" if path != "tile" else
                   f"{n_res} residual rays"))
        # the two traversals give the same gradients, off the leaves of the
        # rays the referee judged (their rows differ by those rays' terms);
        # the rays of a leaf add in another order (row-major, tile-major)
        refereed = torch.cat([res_fb.hit_leaf[mask | differ],
                              golden.hit_leaf[mask | differ]])
        keep = torch.ones(n_leaves, dtype=torch.bool, device=dev)
        keep[refereed[refereed >= 0].long()] = False
        a = join7(grads_by_path[("per-ray", what)])[keep]
        b = join7(grads_by_path[("tile", what)])[keep]
        paths_err = float((a - b).abs().max())
        if not paths_err <= 1e-5 * float(a.abs().max()):
            raise AssertionError(f"{what}: the two traversals' gradients differ "
                                 f"by {paths_err}")
        say(f"[train] {what}: per-ray and tile gradients agree on the "
            f"{int(keep.sum())} leaves off the refereed rays (max abs "
            f"{paths_err:.3e}, limit 1e-5 of the largest gradient "
            f"{float(a.abs().max()):.3e})")
        # the brick and stackless steps against the per-ray step, off the
        # leaves of the rays where their frames part from esvo_trace (the
        # rays of a leaf add in the same order: all three are row-major)
        for path in ("brick", "plain"):
            parted = routes[path]["differ"]
            off = torch.cat([routes[path]["res"].hit_leaf[parted],
                             per_ray.hit_leaf[parted]])
            keep = torch.ones(n_leaves, dtype=torch.bool, device=dev)
            keep[off[off >= 0].long()] = False
            a = join7(grads_by_path[("per-ray", what)])[keep]
            b = join7(grads_by_path[(path, what)])[keep]
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the {path} step's gradients differ "
                                     f"from the per-ray step's off the refereed "
                                     f"rays by {float((a - b).abs().max())}")
            say(f"[train] {what}: the {path} step's gradients == the per-ray "
                f"step's, bitwise, on the {int(keep.sum())} leaves off the "
                f"{int(parted.sum())} rays where the frames part")

    # three Adam steps on the view, from random albedo towards the scene's own
    model = InverseRenderer(host_svo, device=dev)
    train_params, opt_state = model.init_params(seed=0)
    view = CameraConfig(**bench_cam, width=res, height=res)
    frozen = train_params["normal"].clone()
    losses, residuals = [], []
    reset_counts()
    for _ in range(3):
        train_params, opt_state, loss, n_res = model.step_view(
            train_params, opt_state, view, (-0.5, -1.0, -0.3), img)
        losses.append(float(loss))
        residuals.append(int(n_res))
    torch.cuda.synchronize()
    # two walks and two phase-1 calls a step: the trainer's budgets have no
    # sub-tile pass
    if (tile_cuda.launches != 6 or tile_cuda.candidates_launches != 6
            or tile_cuda.candidates_block_launches
            or PLAIN_CALLS["candidates_plain"] or shade_cuda.launches != dict(
                shade_fwd=3, shade_bwd=3, shade_bwd_serial=0, segment_sum=3,
                segment_sum_sorted=0)):
        raise AssertionError("step_view did not take the tile step's kernels")
    # The trainer keeps the reference's budgets (k_max=96, fb_tiles=128,
    # fb_k=256, no sub-tile pass), which leave a few rays of this view
    # cap-limited where bench.py's budgets leave none. The step returns
    # their count; it must be the tile frame's own at those budgets, the same
    # every step, and under a ten-thousandth of the rays.
    _img, want_res = diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, k_max=96, fb_tiles=128, fb_k=256)
    if residuals != [int(want_res)] * 3 or residuals[0] * 10000 > n_rays:
        raise AssertionError(f"step_view: residual rays {residuals}, the tile "
                             f"frame at the trainer's budgets has {int(want_res)}")
    if not (losses[0] > losses[1] > losses[2] > 0.0):
        raise AssertionError(f"step_view: the loss does not fall: {losses}")
    if not torch.equal(train_params["normal"], frozen):
        raise AssertionError("step_view changed a frozen parameter")
    say(f"[train] InverseRenderer.step_view, 3 Adam steps on the {res}x{res} "
        f"view from random albedo: loss {losses[0]:.6f} -> {losses[1]:.6f} -> "
        f"{losses[2]:.6f}, {residuals[0]} residual rays a step at the "
        f"trainer's budgets (the tile frame's own count there; 0 at bench.py's "
        f"budgets above), 6 walker and 6 tile_candidates launches, no launch "
        f"of a first form and no call of candidates_plain, frozen parameters "
        f"unchanged")

    # three Adam steps on the view's flat batch of rays: InverseRenderer.step,
    # the brick step on this tree, as the reference's trainer takes it
    flat_params, flat_state = model.init_params(seed=0)
    flat_losses = []
    reset_counts()
    for _ in range(3):
        flat_params, flat_state, loss = model.step(
            flat_params, flat_state, o, d, (-0.5, -1.0, -0.3), img)
        flat_losses.append(float(loss))
    torch.cuda.synchronize()
    flat_counts = dict(esvo_trace=traverse_cuda.launches, **brick_cuda.launches,
                       **PLAIN_CALLS, **shade_cuda.launches,
                       **brick_cuda.form_launches, **brick_cuda.probe_launches)
    want = dict(esvo_trace=0, brick_trace=3, esvo_stackless=0, candidates_plain=0,
                trace_brick=0, trace_stackless=0, shade_fwd=3, shade_bwd=3,
                shade_bwd_serial=0, segment_sum=3, segment_sum_sorted=0,
                brick_trace_serial=0, brick_trace_unstaged=0,
                esvo_stackless_probe=0, brick_trace_probe=0)
    if flat_counts != want:
        raise AssertionError(f"InverseRenderer.step launched {flat_counts}, "
                             f"expected {want}")
    if not (flat_losses[0] > flat_losses[1] > flat_losses[2] > 0.0):
        raise AssertionError(f"InverseRenderer.step: the loss does not fall: "
                             f"{flat_losses}")
    if not torch.equal(flat_params["normal"], frozen):
        raise AssertionError("InverseRenderer.step changed a frozen parameter")
    say(f"[train] InverseRenderer.step, 3 Adam steps on the {res}x{res} view's "
        f"flat batch of {n_rays} rays from random albedo: loss "
        f"{flat_losses[0]:.6f} -> {flat_losses[1]:.6f} -> {flat_losses[2]:.6f}, "
        f"through the brick step (launches {flat_counts}), frozen parameters "
        f"unchanged")

    # ---- 8. timing: both frames within this one call -----------------------
    # 50 samples: the 80th percentile has 10 beyond it
    t = {}
    t["esvo"] = cuda_ms(lambda: traverse_cuda.trace_cuda(svo, o, d), 50, 3)
    t["frame"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["tile_frame"] = cuda_ms(lambda: diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), 50, 3)
    t["walk"] = cuda_ms(lambda: tile_cuda.tile_walk(*main_args), 50, 3)
    # phase 1: the frame's three calls, each at the rule's warps a tile, at
    # the other, in its first form and in its plain version, in turns (the
    # plain version takes tens of milliseconds a call)
    variants = {}
    for cname, args in zip(CAND_CALLS, cands):
        other = 9 - cand_rows[cname]["warps"]
        variants[f"phase1 {cname}"] = lambda a=args: tile_cuda.candidates(*a)
        variants[f"phase1 {cname} other"] = (
            lambda a=args, w=other: tile_cuda.candidates(*a, warps=w))
        variants[f"phase1 {cname} first"] = lambda a=args: tile_cuda.candidates_block(*a)
        variants[f"phase1 {cname} plain"] = lambda a=args: tile.candidates_plain(*a)
    t.update(in_turns(variants, rounds=3, reps=10))
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
    take_idx_flat = take_idx.reshape(-1)
    turns = in_turns({
        "nothing": lambda: None,
        "row_old_path": lambda: rowread_rows_old_path(table, rows8),
        "row": lambda: rowread.rowread_rows(table, rows8),
        "row_library": lambda: torch.index_select(table, 0, rows8),
        "take": lambda: gather.take_1d(take_table, take_idx),
        "take_library": lambda: torch.index_select(take_table, 0, take_idx_flat)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    # take at the main path's size: the gather take_row makes in shade_fwd,
    # one leaf's value for each of the frame's rays (misses read leaf 0)
    big_table, big_idx = svo.leaf_density, safe_leaf
    got = gather.take_1d(big_table, big_idx)
    torch.cuda.synchronize()
    err["take"] = max(err["take"], compare_tensors(
        (got,), (big_table[big_idx.long()],), ("take_1d",), "take_1d, full size"))
    turns = in_turns({
        "take_full": lambda: gather.take_1d(big_table, big_idx),
        "take_full_library": lambda: torch.index_select(big_table, 0, big_idx)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    # the two traversals' kernels against their first forms, in turns, and
    # the frame's three walks at every G
    turns = in_turns({
        "esvo": lambda: traverse_cuda.trace_cuda(svo, o, d),
        "esvo_first": lambda: traverse_cuda.trace_cuda_serial(svo, o, d)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    for wname, args in zip(WALKS, walks):
        variants = {"first": lambda a=args: tile_cuda._walk_serial_kernel(*a)}
        variants.update({f"G={g}": lambda a=args, g=g: tile_cuda._walk_kernel(*a, lanes=g)
                         for g in tile_cuda.LANES})
        for name, v in in_turns(variants, rounds=2, reps=30).items():
            t[f"walk {wname} {name}"] = v
    target0 = torch.zeros_like(target_rand)
    t["step"] = cuda_ms(lambda: diff.loss_and_grads_cuda(
        *params, svo, o, d, light, target0), 50, 3)
    t["step_tile"] = cuda_ms(lambda: diff.loss_and_grads_tile(
        *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS), 50, 3)
    t["frame_last"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["tile_frame_last"] = cuda_ms(lambda: diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), 20, 2)
    # bench.py's BENCH_PATH=brick and plain: each frame, and its step beside it
    route_calls = {
        "brick": (lambda: diff.render_diff_brick(*params, bsvo, o, d, light),
                  lambda: diff.loss_and_grads_brick(*params, bsvo, o, d, light,
                                                    target0)),
        "plain": (lambda: diff.render_diff(*params, svo, o, d, light),
                  lambda: diff.loss_and_grads(*params, svo, o, d, light, target0))}
    for route, (fwd, fwdbwd) in route_calls.items():
        t[f"{route}_frame"] = cuda_ms(fwd, 50, 3)
        t[f"{route}_step"] = cuda_ms(fwdbwd, 50, 3)
    # the per-ray traces in turns, the brick trace in each of its forms
    # through its own wrapper, and the plain versions
    turns = in_turns({
        "trace_esvo": lambda: traverse_cuda.trace_cuda(svo, o, d),
        "trace_brick": lambda: brick_cuda.trace_brick_cuda(bsvo, o, d),
        "trace_brick_first": lambda: brick_cuda.trace_brick_cuda_serial(bsvo, o, d),
        "trace_brick_unstaged": lambda: brick_cuda._brick_unstaged_kernel(bsvo, o, d),
        "trace_stackless": lambda: brick_cuda.trace_stackless_cuda(svo, o, d)},
        rounds=4)
    t.update({f"{name}_turns": v for name, v in turns.items()})
    t["brick_plain"] = cuda_ms(lambda: brick.trace_brick(bsvo, o, d), 2, 0)
    t["stackless_plain"] = cuda_ms(lambda: traverse.trace_stackless(svo, o, d), 2, 0)
    g_step = 2.0 * img / img.numel()
    shade_args = (hit_leaf, d, *params, light, 1.3, 0.08)
    t["shade_fwd"] = cuda_ms(lambda: shade_cuda.shade_fwd(*shade_args), 50, 3)
    t["shade_fwd_plain"] = cuda_ms(lambda: diff.shade_diff_plain(*shade_args), 20, 2)
    t["shade_bwd"] = cuda_ms(lambda: shade_cuda.shade_bwd(g_step, *shade_args), 50, 3)
    # shade_bwd against its first form, in turns
    turns = in_turns({
        "bwd": lambda: shade_cuda.shade_bwd(g_step, *shade_args),
        "bwd_first": lambda: shade_cuda.shade_bwd_serial(g_step, *shade_args)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    t["shade_bwd_plain"] = cuda_ms(lambda: shade_cuda.shade_bwd_plain(
        g_step, *shade_args), 20, 2)
    # the whole function each time, from (cot, hit_leaf) to the three
    # tensors: scratch, fills and, for the sorted form, its sort included
    t["segment_sum"] = cuda_ms(lambda: shade_cuda.segment_sum(
        seg_cot, hit_leaf, n_leaves), 50, 3)
    t["segment_sorted_whole"] = cuda_ms(lambda: shade_cuda.segment_sum_sorted(
        seg_cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves), 50, 3)
    t["sort"] = cuda_ms(lambda: shade_cuda.sort_by_leaf(hit_leaf, n_leaves), 50, 3)
    t["segment_sorted"] = cuda_ms(lambda: shade_cuda.segment_sum_sorted(
        seg_cot, keys, order, n_leaves), 50, 3)
    t["segment_sum_again"] = cuda_ms(lambda: shade_cuda.segment_sum(
        seg_cot, hit_leaf, n_leaves), 50, 3)
    t["segment_plain"] = cuda_ms(lambda: diff._segment_reduce_cols(
        safe_leaf, seg_cot, n_leaves), 20, 2)
    # the library call on the work the kernel does: the hit rows alone
    was_hit = hit_leaf >= 0
    hit_long, hit_cot = hit_leaf[was_hit].long(), seg_cot[was_hit]
    t["segment_library"] = cuda_ms(lambda: torch.zeros(
        (n_leaves, 7), device=dev).index_add_(0, hit_long, hit_cot), 50, 3)
    take_idx_long = take_idx.long()
    t["take"] = cuda_ms(lambda: gather.take_1d(take_table, take_idx), 50, 3)
    t["take_plain"] = cuda_ms(lambda: take_table[take_idx_long], 50, 3)
    t["take_library"] = cuda_ms(lambda: torch.index_select(
        take_table, 0, take_idx_flat), 50, 3)
    t["take_onehot"] = cuda_ms(lambda: gather.take_onehot(hot_table, hot_idx), 50, 3)
    t["take_onehot_plain"] = cuda_ms(lambda: gather.onehot_take_plain(
        hot_table, hot_idx), 20, 2)
    for iters, rows in loop_plain_ms:
        t[f"loop_{iters}_{rows}"] = cuda_ms(lambda: gather.loop_probe(
            loop_x, loop_table, iters, 8, rows), 20, 2)
    m = {k: med_p80(v) for k, v in t.items()}
    slope = {rows: (m[f"loop_2048_{rows}"][0] - m[f"loop_64_{rows}"][0]) / 1984 * 1e3
             for rows in (0, 512)}
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
        f"{m['walk'][0]:.4f} ms (p80 {m['walk'][1]:.4f}); plain walk "
        f"{walk_plain_ms:.3f} ms (n=1); phase 1 in turns (three rounds of 10): "
        + ", ".join(
            f"{c}: tile_candidates at {cand_rows[c]['warps']} warps a tile "
            f"{m[f'phase1 {c}'][0]:.4f} ms (p80 {m[f'phase1 {c}'][1]:.4f}), at "
            f"{9 - cand_rows[c]['warps']} {m[f'phase1 {c} other'][0]:.4f}, "
            f"tile_candidates_block {m[f'phase1 {c} first'][0]:.4f}, "
            f"candidates_plain {m[f'phase1 {c} plain'][0]:.4f}" for c in CAND_CALLS))
    say(f"[timing] {card}: brick_dda16 N={n_dda} median {m['dda'][0]:.4f} ms "
        f"(p80 {m['dda'][1]:.4f}), plain {m['dda_plain'][0]:.4f} ms (n=5); "
        f"rowread rows {m['row'][0]:.4f} ms, scalar {m['row_scalar'][0]:.4f}, "
        f"min {m['row_min'][0]:.4f}, table[idx] {m['row_plain'][0]:.4f}, "
        f"index_select {m['row_library'][0]:.4f} (n=50 each); in turns, three "
        f"rounds of 50 each: two events around nothing "
        f"{m['nothing_turns'][0]:.4f}, rowread rows through the launch path as "
        f"it stood before {m['row_old_path_turns'][0]:.4f}, through the launcher "
        f"{m['row_turns'][0]:.4f}, index_select {m['row_library_turns'][0]:.4f}; "
        f"take_1d {m['take_turns'][0]:.4f}, its index_select "
        f"{m['take_library_turns'][0]:.4f}")

    say(f"[timing] {card}: per-ray fwd+bwd step median {m['step'][0]:.4f} ms "
        f"(p80 {m['step'][1]:.4f}, n=50) = "
        f"{n_rays / m['step'][0] / 1e3:.2f} Mrays/s, fwdbwd_over_fwd "
        f"{m['step'][0] / m['frame_last'][0]:.2f} (forward frame beside it "
        f"{m['frame_last'][0]:.4f} ms); tile fwd+bwd step median "
        f"{m['step_tile'][0]:.4f} ms (p80 {m['step_tile'][1]:.4f}, n=50) = "
        f"{n_rays / m['step_tile'][0] / 1e3:.2f} Mrays/s, fwdbwd_over_fwd "
        f"{m['step_tile'][0] / m['tile_frame_last'][0]:.2f} (forward frame "
        f"beside it {m['tile_frame_last'][0]:.4f} ms, n=20)")
    say(f"[timing] {card}: shade_fwd median {m['shade_fwd'][0]:.4f} ms (p80 "
        f"{m['shade_fwd'][1]:.4f}), plain {m['shade_fwd_plain'][0]:.4f}; "
        f"shade_bwd {m['shade_bwd'][0]:.4f} (p80 {m['shade_bwd'][1]:.4f}), "
        f"plain {m['shade_bwd_plain'][0]:.4f} (kernels n=50, plain n=20); in "
        f"turns, three rounds of 50: shade_bwd {m['bwd_turns'][0]:.4f}, "
        f"shade_bwd_serial {m['bwd_first_turns'][0]:.4f}")
    say(f"[timing] {card}: segment_sum, (cot, hit_leaf) to the three gradients, "
        f"scratch included: median {m['segment_sum'][0]:.4f} ms (p80 "
        f"{m['segment_sum'][1]:.4f}; again {m['segment_sum_again'][0]:.4f}); "
        f"the sorted form with its sort {m['segment_sorted_whole'][0]:.4f} (p80 "
        f"{m['segment_sorted_whole'][1]:.4f}): the stable sort of {n_rays} keys "
        f"{m['sort'][0]:.4f}, segment_sum_sorted after it "
        f"{m['segment_sorted'][0]:.4f}; index_add_ of the hit rows onto zeros "
        f"{m['segment_library'][0]:.4f} (n=50 each); plain sort + running "
        f"sums {m['segment_plain'][0]:.4f} (n=20)")
    say(f"[timing] {card}: take_1d (8,128) of 16,384 rows {m['take'][0]:.4f} "
        f"ms, table[idx] {m['take_plain'][0]:.4f}, index_select "
        f"{m['take_library'][0]:.4f} (n=50); take_onehot (8,128) of 4,096 rows "
        f"{m['take_onehot'][0]:.4f}, one_hot @ table "
        f"{m['take_onehot_plain'][0]:.4f} (n=20); loop_probe (512,128), 8 steps a "
        f"trip: 64 trips {m['loop_64_0'][0]:.4f} ms, 2048 trips "
        f"{m['loop_2048_0'][0]:.4f}, slope {slope[0]:.4f} us a trip; with a "
        f"512-row gather a trip: {m['loop_64_512'][0]:.4f} and "
        f"{m['loop_2048_512'][0]:.4f}, slope {slope[512]:.4f} us a trip "
        f"(n=20); plain loop of 2048 trips {loop_plain_ms[(2048, 0)]:.1f} ms, "
        f"with the gather {loop_plain_ms[(2048, 512)]:.1f} (n=1)")

    say(f"[timing] {card}: esvo_trace {m['esvo_turns'][0]:.4f} ms against its "
        f"first form {m['esvo_first_turns'][0]:.4f} (in turns, three rounds of "
        f"50); take_1d at the main path's size ({big_table.shape[0]} float32 "
        f"entries, {big_idx.shape[0]} int32 indices) {m['take_full_turns'][0]:.4f} "
        f"ms against index_select {m['take_full_library_turns'][0]:.4f} (in turns)")
    for route in route_calls:
        f, st = m[f"{route}_frame"], m[f"{route}_step"]
        say(f"[timing] {card}: BENCH_PATH={route}: fwd median {f[0]:.4f} ms (p80 "
            f"{f[1]:.4f}, n=50) = {n_rays / f[0] / 1e3:.2f} Mrays/s; fwdbwd median "
            f"{st[0]:.4f} ms (p80 {st[1]:.4f}, n=50) = "
            f"{n_rays / st[0] / 1e3:.2f} Mrays/s; fwdbwd_over_fwd "
            f"{st[0] / f[0]:.2f}")
    say(f"[timing] {card}: the per-ray traces in turns (four rounds of 50, "
        f"median and p80): esvo_trace {m['trace_esvo_turns'][0]:.4f} ms; "
        f"brick_trace through the main path's wrapper (wide form: blocks of 256, "
        f"staged rows) {m['trace_brick_turns'][0]:.4f} "
        f"({m['trace_brick_turns'][1]:.4f}), the wide form without staged rows "
        f"{m['trace_brick_unstaged_turns'][0]:.4f} "
        f"({m['trace_brick_unstaged_turns'][1]:.4f}), the first form (blocks of "
        f"128) {m['trace_brick_first_turns'][0]:.4f} "
        f"({m['trace_brick_first_turns'][1]:.4f}); esvo_stackless "
        f"{m['trace_stackless_turns'][0]:.4f} ({m['trace_stackless_turns'][1]:.4f})"
        + f"; their plain versions brick.trace_brick {m['brick_plain'][0]:.1f} ms "
        f"and traverse.trace_stackless {m['stackless_plain'][0]:.1f} ms (n=2)")
    for wname in WALKS:
        row = walk_rows[wname]
        say(f"[lanes] {card}: walk {wname} (T={row['T']}, P={row['P']}, "
            f"K={row['K']}; the rule's G={row['G']}), ms in turns (two rounds of "
            f"30): first form {m[f'walk {wname} first'][0]:.4f}, " + ", ".join(
                f"G={g} {m[f'walk {wname} G={g}'][0]:.4f}" for g in tile_cuda.LANES))

    # ---- 8b. the launch path, part by part, on the host's clock -------------
    # Each part of one rowread_rows call alone, a few thousand calls back to
    # back without waiting for the card (its kernel is shorter than any of
    # them, so the queue never fills), beside the parts the path had before
    # _launch.py and beside index_select, which does the same in C++.
    kern = rowread._ROWREAD
    specs = (("table", table, torch.int32, (64, 128)),
             ("indices", rows8, torch.int32, (8,)))
    row_out = torch.empty((8, 128), dtype=torch.int32, device=dev)
    row_fn, raw_stream = kern._fn, torch._C._cuda_getCurrentRawStream
    row_args = (table.data_ptr(), 64, 128, rowread.MODE_ROWS, None, 0,
                rows8.data_ptr(), 8, row_out.data_ptr(), 8)

    def device_context():
        with torch.cuda.device(dev):
            pass
    w = {
        "an empty call": host_us(lambda: None),
        "checks": host_us(lambda: kern.check(dev, specs)),
        "library lookup (before)": host_us(_build.tile_lib),
        "torch.empty": host_us(lambda: torch.empty(
            (8, 128), dtype=torch.int32, device=dev)),
        "device context (before)": host_us(device_context),
        "current_device (now)": host_us(torch.cuda.current_device),
        "Stream object (before)": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw stream (now)": host_us(lambda: raw_stream(0)),
        "bare ctypes call": host_us(lambda: row_fn(*row_args, raw_stream(0))),
        "launcher call": host_us(lambda: kern(dev, *row_args)),
        "rowread_rows (before)": host_us(lambda: rowread_rows_old_path(table, rows8)),
        "rowread_rows (now)": host_us(lambda: rowread.rowread_rows(table, rows8)),
        "index_select": host_us(lambda: torch.index_select(table, 0, rows8)),
        "take_1d (now)": host_us(lambda: gather.take_1d(take_table, take_idx)),
    }
    say(f"[wrapper] {card}: host us a call, 3000 calls each, not waiting for "
        f"the card: " + ", ".join(f"{k} {v:.2f}" for k, v in w.items()))

    # profiler passes of 20 runs each: device time by kernel. Only the
    # kernels' own events are summed; an operator's row repeats the time of
    # the kernels it launched. The tracer drops the launches made while it
    # starts up, which can be all of a short pass: each pass is preceded by
    # a warm-up cycle whose events are discarded, and a pass in which no
    # kernel was seen all the same is repeated with more runs. If the tracer
    # still shows nothing the pass says so and gives no time (the times
    # taken with CUDA events above stand); that is a fault of the tracing,
    # not of a kernel, whose launch errors the wrappers raise.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced_kernels(fn, runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            prof.step()
        # the cycle's own "ProfilerStep" span is mirrored onto the card's
        # timeline and is no kernel
        return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]

    def profile_kernels(what, fn, unit, top, launches=None):
        """(us of kernel time a unit, us a launch by kernel, launches a
        unit) of `runs` units of fn(), and a line for each of the `top`
        largest kernels. A pass that sees no kernel, or fewer than nine in
        ten of the `launches` a unit that fn() makes, is repeated with
        more runs."""
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
        for runs in (20, 80, 320):
            rows = sorted(traced_kernels(fn, runs), key=dev_us, reverse=True)
            total_us = sum(dev_us(e) for e in rows) / runs
            seen = sum(e.count for e in rows) / runs
            if total_us > 0.0 and (launches is None or seen >= 0.9 * launches):
                break
        else:
            say(f"[profile] {what}: the profiler saw no kernel in 20, 80 or 320 "
                f"{unit}s; not measured here")
            return None, {}, None
        n_launches = sum(e.count for e in rows) / runs
        say(f"[profile] {what}, {runs} {unit}s: {total_us:.1f} us of kernel time a "
            f"{unit} in {n_launches:.1f} launches; the "
            f"{min(top, len(rows))} largest, us a {unit} (launches a {unit}):")
        for e in rows[:top]:
            say(f"[profile]   {dev_us(e) / runs:9.1f}  ({e.count / runs:6.1f})  {e.key[:90]}")
        # by kernel, us a launch: the tracer may still drop a few launches
        # of a short pass, which lowers a sum over the pass but not this
        return (total_us, {e.key: dev_us(e) / e.count for e in rows if e.count},
                n_launches)

    tile_us, tile_rows, tile_n = profile_kernels(
        "tile frame", lambda: diff.render_diff_tile(
            *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), "frame", 10)
    say("[profile] the tile frame's walks, us a launch: " + ", ".join(
        f"{k.split('(')[-2].split('::')[-1]} {v:.1f}" for k, v in tile_rows.items()
        if "tile_walk" in k))
    say("[profile] the tile frame's phase-1 calls, us a launch: " + ", ".join(
        f"{v:.1f}" for k, v in tile_rows.items() if "tile_candidates" in k))
    tile_step_us, _rows, tile_step_n = profile_kernels(
        "tile fwd+bwd step", lambda: diff.loss_and_grads_tile(
            *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS),
        "step", 10)
    step_us, step_rows, _n = profile_kernels(
        "per-ray fwd+bwd step", lambda: diff.loss_and_grads_cuda(
            *params, svo, o, d, light, target0), "step", 14)
    sorts = [k for k in step_rows if "sort" in k.lower() and "seg_" not in k]
    if sorts:
        raise AssertionError(f"the per-ray step launched a sort: {sorts}")
    # the sort-free segment sum's kernels alone (each is launched once a
    # call, so us a launch is us a call), and the sorted form's
    _, seg_rows, _n = profile_kernels(
        "segment_sum alone (the memset and its five kernels)",
        lambda: shade_cuda.segment_sum(seg_cot, hit_leaf, n_leaves), "call", 6)
    seg_kernel_us = {
        k.replace("(anonymous namespace)::", "").split("(")[0].strip(): round(v, 2)
        for k, v in seg_rows.items()}
    profile_kernels(
        "the sorted form alone (where, clamp, the radix sort, three fills, "
        "segment_sum_sorted)", lambda: shade_cuda.segment_sum_sorted(
            seg_cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves),
        "call", 8)
    # the two forms of each traversal kernel side by side, one call of each a
    # round: us a launch of each, the frame's three walks one by one
    alone = {}
    for wname, args in zip(WALKS, walks):
        _, rows, _n = profile_kernels(
            f"walk {wname} alone: tile_walk at G={walk_rows[wname]['G']} and its "
            f"first form", lambda a=args: (tile_cuda._walk_kernel(*a),
                                            tile_cuda._walk_serial_kernel(*a)),
            "round", 2)
        alone[wname] = kernel_us(rows, "tile_walk_kernel", "tile_walk_serial_kernel")
    _, rows, _n = profile_kernels(
        "esvo_trace alone, and its first form", lambda: (
            traverse_cuda.trace_cuda(svo, o, d),
            traverse_cuda.trace_cuda_serial(svo, o, d)), "round", 2)
    alone["esvo"] = kernel_us(rows, "esvo_kernel<false>", "esvo_kernel<true>")
    _, rows, _n = profile_kernels(
        "brick_trace alone in its three forms, and esvo_stackless and "
        "esvo_trace beside them",
        lambda: (brick_cuda.trace_brick_cuda(bsvo, o, d),
                 brick_cuda.trace_brick_cuda_serial(bsvo, o, d),
                 brick_cuda._brick_unstaged_kernel(bsvo, o, d),
                 brick_cuda.trace_stackless_cuda(svo, o, d),
                 traverse_cuda.trace_cuda(svo, o, d)), "round", 5, launches=5)
    for key, name in FORM_KERNELS.items():
        alone[key] = kernel_us(rows, name)[0]
    for kname, form in MAIN_FORM.items():
        alone[kname] = alone[(kname, form)]
    alone["esvo_beside"] = kernel_us(rows, "esvo_kernel<false>")[0]
    route_prof = {}
    for route, (fwd, fwdbwd) in route_calls.items():
        f_us, _rows, f_n = profile_kernels(f"{route} frame", fwd, "frame", 4)
        s_us, _rows, s_n = profile_kernels(f"{route} fwd+bwd step", fwdbwd, "step", 10)
        route_prof[route] = (f_us, f_n, s_us, s_n)
    _, rows, _n = profile_kernels(
        "take_1d at the main path's size alone, and index_select", lambda: (
            gather.take_1d(big_table, big_idx),
            torch.index_select(big_table, 0, big_idx)), "round", 2)
    # index_select of a 1-D table runs PyTorch's gather kernel
    alone["take"] = kernel_us(rows, "take_kernel", "gather")
    # phase 1's three calls alone: the rule's variant, the other and the
    # first form, one call of each a round
    for cname, args in zip(CAND_CALLS, cands):
        warps = cand_rows[cname]["warps"]
        _, rows, _n = profile_kernels(
            f"tile_candidates {cname} alone at {warps} and {9 - warps} warps a "
            f"tile, and tile_candidates_block", lambda a=args, w=warps: (
                tile_cuda.candidates(*a), tile_cuda.candidates(*a, warps=9 - w),
                tile_cuda.candidates_block(*a)), "round", 3, launches=3)
        alone[f"phase1 {cname}"] = kernel_us(
            rows, f"tile_candidates_kernel<{warps}>",
            "tile_candidates_block_kernel", f"tile_candidates_kernel<{9 - warps}>")
    _, rows, _n = profile_kernels(
        "shade_bwd alone, and shade_bwd_serial", lambda: (
            shade_cuda.shade_bwd(g_step, *shade_args),
            shade_cuda.shade_bwd_serial(g_step, *shade_args)), "round", 2,
        launches=2)
    alone["shade_bwd"] = kernel_us(rows, "shade_bwd_kernel", "shade_bwd_serial_kernel")
    say(f"[profile] {card}: shade_bwd {us_or(alone['shade_bwd'][0])} us alone, "
        f"shade_bwd_serial {us_or(alone['shade_bwd'][1])} us; tile_candidates "
        f"alone at the rule's warps a tile, at the other, and "
        f"tile_candidates_block, us: " + "; ".join(
            f"{c} " + ", ".join(us_or(x) for x in (
                alone[f"phase1 {c}"][0], alone[f"phase1 {c}"][2],
                alone[f"phase1 {c}"][1])) for c in CAND_CALLS))
    idle = lambda us, ms: "not measured" if us is None else f"{1 - us / 1e3 / ms:.2f}"
    count = lambda n: "not measured" if n is None else f"{n:.1f}"
    say(f"[profile] {card}: idle share of the card: tile frame {count(tile_n)} "
        f"launches a frame, idle {idle(tile_us, m['tile_frame'][0])} of its "
        f"median {m['tile_frame'][0]:.4f} ms; tile fwd+bwd step "
        f"{count(tile_step_n)} launches a step, idle "
        f"{idle(tile_step_us, m['step_tile'][0])} of its median "
        f"{m['step_tile'][0]:.4f} ms; per-ray fwd+bwd step idle "
        f"{idle(step_us, m['step'][0])} of its median {m['step'][0]:.4f} ms")
    say(f"[profile] {card}: us alone: " + "; ".join(
            f"{k} " + ", ".join(f"{form} form {us_or(alone[(k, form)])}"
                                for form in brick_cuda.FORMS[k])
            for k in ("brick_trace", "esvo_stackless"))
        + f"; esvo_trace beside them {us_or(alone['esvo_beside'])}; " + "; ".join(
            f"{route} frame {us_or(f_us)} us of kernels in {count(f_n)} launches, "
            f"idle {idle(f_us, m[f'{route}_frame'][0])} of its median "
            f"{m[f'{route}_frame'][0]:.4f} ms; {route} fwd+bwd step {us_or(s_us)} us "
            f"in {count(s_n)} launches, idle {idle(s_us, m[f'{route}_step'][0])} of "
            f"its median {m[f'{route}_step'][0]:.4f} ms"
            for route, (f_us, f_n, s_us, s_n) in route_prof.items()))

    # where the tile frame's and the tile step's host time goes, by group
    for what, fn in (
            ("tile frame", lambda: diff.render_diff_tile(
                *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS)),
            ("tile fwd+bwd step", lambda: diff.loss_and_grads_tile(
                *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS))):
        groups = sorted(host_groups(fn).items(), key=lambda kv: -kv[1][1])
        say(f"[host] {card}: {what}, top-level aten ops and their host us by "
            f"group (one pass, CPU profiler): " + "; ".join(
                f"{g} {n} ops {us:.0f} us" for g, (n, us) in groups)
            + f"; in all {sum(n for n, _u in dict(groups).values())} ops "
            f"{sum(u for _n, u in dict(groups).values()):.0f} us")

    # the probe kernels without their wrappers: one call of each a round
    def probe_round():
        brick_dda.brick_dda16(dda_args[0], dda_args[1], dda_args[2],
                              *dda_args[3:], depth=10, steps=16)
        rowread.rowread_rows(table, rows8)
        gather.take_1d(take_table, take_idx)
        gather.loop_probe(loop_x, loop_table, 2048, 8, 0)
        torch.index_select(table, 0, rows8)
    _, probe_rows, _n = profile_kernels(
        "probe kernels alone (brick_dda16, rowread, take_1d, loop_probe at 2048 "
        "trips, and index_select beside them)", probe_round, "round", 5)
    alone["loop_probe"] = kernel_us(probe_rows, "loop_probe_kernel")[0]
    say(f"[profile] {card}: loop_probe (512,128), 2048 trips of 8 steps, "
        f"{us_or(alone['loop_probe'])} us alone")
    # the same kernel in its one-hot mode, on its own so the two do not merge
    profile_kernels("take in its one-hot mode alone", lambda: gather.take_onehot(
        hot_table, hot_idx), "call", 1)

    # ---- 9. the record --------------------------------------------------------
    # bounds: every input read once and every output written once, against
    # the operations this run's data needed (steps actually taken)
    esvo_bound = bound(
        nbytes(o, d, svo.masks, svo.child_base, svo.leaf_base) + n_rays * 5 * 4,
        esvo_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)
    # the per-ray routes: rays and results, their tables read once, and the
    # top steps and DDA steps this frame's rays took
    b_res, b_st = routes["brick"]["res"], routes["brick"]["stats"]
    b_dda = int(b_st[:, STAT("dda_steps")].sum())
    b_top = int(b_res.iters.sum()) - b_dda
    brick_bound = bound(
        nbytes(o, d, bsvo.top_masks, bsvo.top_child, bsvo.top_parent, bsvo.bricks)
        + n_rays * 5 * 4,
        b_top * OPS_ESVO_STEP + b_dda * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP)
    s_steps = int(routes["plain"]["res"].iters.sum())
    stackless_bound = bound(
        nbytes(o, d, svo.masks, svo.child_base, svo.parent_ptr, svo.leaf_base)
        + n_rays * 5 * 4, s_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)
    # take at full size reads each index once and at most each touched entry
    # once, and writes one value a ray
    take_full_bound = bound(nbytes(big_idx) + int(touched.sum()) * 4
                            + big_idx.numel() * 4, 0)
    us = us_or
    main_walk = walk_rows["main"]
    for wname in WALKS:
        walk_rows[wname].update(
            ms=m[f"walk {wname} G={walk_rows[wname]['G']}"][0],
            ms_first_form=m[f"walk {wname} first"][0],
            us_alone=alone[wname][0], us_alone_first_form=alone[wname][1])
    say(f"[bound] the frame's walks, each launch's own (its rays, lists and "
        f"rows at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, its DDA steps at "
        f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s): " + "; ".join(
            f"{w} {r['bound_ms']:.5f} ms ({r['bound_by']}), tile_walk "
            f"{us(r['us_alone'])} us alone at G={r['G']}, first form "
            f"{us(r['us_alone_first_form'])} us" for w, r in walk_rows.items())
        + f"; esvo_trace {us(alone['esvo'][0])} us alone, first form "
        f"{us(alone['esvo'][1])} us, bound {esvo_bound[0]:.5f} ms; take_1d at "
        f"full size {us(alone['take'][0])} us alone, index_select "
        f"{us(alone['take'][1])} us, bound {take_full_bound[0]:.5f} ms")
    say(f"[bound] the per-ray routes (24 B of ray in and 20 B of results out a "
        f"ray and their tables once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{OPS_ESVO_STEP} operations a top step, {OPS_DDA_STEP} a DDA step and "
        f"{OPS_RAY_SETUP} a ray's set-up at {PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s): "
        f"brick_trace {b_top} top steps and {b_dda} DDA steps, bound "
        f"{brick_bound[0]:.5f} ms ({brick_bound[1]}), {us(alone['brick_trace'])} "
        f"us alone (first form {us(alone[('brick_trace', 'first')])}, wide form "
        f"without staged rows {us(alone[('brick_trace', 'unstaged')])}); "
        f"esvo_stackless {s_steps} steps, "
        f"bound {stackless_bound[0]:.5f} ms ({stackless_bound[1]}), "
        f"{us(alone['esvo_stackless'])} us alone; esvo_trace {esvo_steps} steps, "
        f"bound {esvo_bound[0]:.5f} ms")
    for cname in CAND_CALLS:
        new_us, first_us, other_us = alone[f"phase1 {cname}"]
        cand_rows[cname].update(
            ms=m[f"phase1 {cname}"][0], plain_ms=m[f"phase1 {cname} plain"][0],
            ms_first_form=m[f"phase1 {cname} first"][0],
            ms_other_warps=m[f"phase1 {cname} other"][0], us_alone=new_us,
            us_alone_first_form=first_us, us_alone_other_warps=other_us)
    say(f"[bound] tile_candidates, each of the frame's calls (its corners, a "
        f"pyramid word a kept cell, a cellmap row a valid candidate and its "
        f"outputs at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {OPS_CAND_SLOT} "
        f"operations a child slot and {OPS_CAND_CHILD} an occupied child at "
        f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s; the sort not counted): " + "; ".join(
            f"{c} {r['bound_ms']:.5f} ms ({r['bound_by']}; {r['bytes'] / 1e6:.3f} "
            f"MB, {r['ops'] / 1e6:.1f} M operations), {us(r['us_alone'])} us "
            f"alone at {r['warps']} warps a tile ({us(r['us_alone_other_warps'])} "
            f"at {9 - r['warps']}; the first form {us(r['us_alone_first_form'])}), "
            f"{r['ms']:.4f} ms in turns against the first form's "
            f"{r['ms_first_form']:.4f} and the plain version's {r['plain_ms']:.4f}"
            for c, r in cand_rows.items()))
    dda_bound = bound(nbytes(*dda_args) + n_dda * 3 * 4, dda_walked * OPS_DDA_STEP)
    row_bound = bound(nbytes(rows8) + 2 * 8 * 128 * 4, 0)
    n_hits = int((hit_leaf >= 0).sum())
    # a parameter row is read only for a hit: count each touched leaf's
    # 28 B once, not the whole table
    row_bytes = int(touched.sum()) * 28 + nbytes(light)
    fwd_bound = bound(nbytes(hit_leaf, d) + n_rays * 12 + row_bytes,
                      n_hits * OPS_SHADE_FWD)
    bwd_bound = bound(nbytes(hit_leaf, d, g_step) + n_rays * 28 + row_bytes,
                      n_hits * OPS_SHADE_BWD)
    # segment_sum's bound reads the function, not an implementation: every
    # ray's hit_leaf once, each hit's 28 B cotangent row once, each output
    # once (28 B a leaf). The sorted form computes the same function, so the
    # same bound stands beside it; its keys and permutation do not count.
    seg_bound = bound(nbytes(hit_leaf) + n_hits * 28 + n_leaves * 28, n_hits * 7)
    say(f"[bound] {n_hits} hits on {int(touched.sum())} leaves: shade_fwd "
        f"{fwd_bound[0]:.4f} ms, shade_bwd {bwd_bound[0]:.4f}, segment_sum "
        f"{seg_bound[0]:.4f} ({(nbytes(hit_leaf) + n_hits * 28 + n_leaves * 28) / 1e6:.1f} "
        f"MB: hit_leaf, the hits' rows, every output) against "
        f"{m['segment_sum'][0]:.4f} for the sort-free form and "
        f"{m['segment_sorted_whole'][0]:.4f} for the sorted form with its sort")
    take_bound = bound(nbytes(take_table, take_idx) + take_idx.numel() * 4, 0)
    loop_bound = bound(2 * nbytes(loop_x),
                       loop_x.numel() * 2048 * 8 * OPS_LOOP_ELEM)
    src = "raytracingtest_tpu_torch/csrc/"
    kernels = [
        dict(name="esvo_trace", route="cuda", source=src + "esvo_trace.cu",
             replaces="raytracingtest_tpu/ops/traverse_pallas.py:55",
             path="diff.render_diff_cuda", launches=esvo_launches,
             max_abs_err=err["esvo_trace"], ms=m["esvo_turns"][0],
             plain_ms=esvo_plain_ms, bound_ms=esvo_bound[0],
             bound_by=esvo_bound[1], library_ms=None,
             ms_first_form=m["esvo_first_turns"][0], us_alone=alone["esvo"][0],
             us_alone_first_form=alone["esvo"][1]),
        dict(name="esvo_trace_serial", route="cuda",
             source=src + "esvo_trace.cu",
             replaces="raytracingtest_tpu/ops/traverse_pallas.py:55",
             path="traverse_cuda.trace_cuda_serial (the first form, off the "
                  "main path)", launches=first_launches["esvo_trace_serial"],
             max_abs_err=err["esvo_trace_serial"], ms=m["esvo_first_turns"][0],
             plain_ms=esvo_plain_ms, bound_ms=esvo_bound[0],
             bound_by=esvo_bound[1], library_ms=None),
        dict(name="tile_walk", route="cuda", source=src + "tile_walk.cu",
             replaces="raytracingtest_tpu/ops/tile.py:432",
             path="diff.render_diff_tile", launches=tile_launches,
             max_abs_err=err["tile_walk"], ms=main_walk["ms"],
             plain_ms=walk_plain_ms, bound_ms=main_walk["bound_ms"],
             bound_by=main_walk["bound_by"], library_ms=None, walks=walk_rows),
        dict(name="tile_walk_serial", route="cuda", source=src + "tile_walk.cu",
             replaces="raytracingtest_tpu/ops/tile.py:432",
             path="tile_cuda.tile_walk_serial (the first form, off the main "
                  "path)", launches=first_launches["tile_walk_serial"],
             max_abs_err=err["tile_walk_serial"],
             ms=main_walk["ms_first_form"], plain_ms=walk_plain_ms,
             bound_ms=main_walk["bound_ms"], bound_by=main_walk["bound_by"],
             library_ms=None),
        dict(name="tile_candidates", route="cuda",
             source=src + "tile_candidates.cu",
             replaces="raytracingtest_tpu/ops/tile.py:288",
             path="diff.render_diff_tile / diff.loss_and_grads_tile",
             launches=cand_launches, max_abs_err=err["tile_candidates"],
             ms=cand_rows["main"]["ms"], plain_ms=cand_rows["main"]["plain_ms"],
             bound_ms=cand_rows["main"]["bound_ms"],
             bound_by=cand_rows["main"]["bound_by"], library_ms=None,
             us_alone=cand_rows["main"]["us_alone"],
             ms_first_form=cand_rows["main"]["ms_first_form"],
             us_alone_first_form=cand_rows["main"]["us_alone_first_form"],
             calls=cand_rows),
        dict(name="tile_candidates_block", route="cuda",
             source=src + "tile_candidates.cu",
             replaces="raytracingtest_tpu/ops/tile.py:288",
             path="tile_cuda.candidates_block (the first form, off the main "
                  "path)", launches=first_launches["tile_candidates_block"],
             max_abs_err=err["tile_candidates_block"],
             ms=cand_rows["main"]["ms_first_form"],
             plain_ms=cand_rows["main"]["plain_ms"],
             bound_ms=cand_rows["main"]["bound_ms"],
             bound_by=cand_rows["main"]["bound_by"], library_ms=None,
             us_alone=cand_rows["main"]["us_alone_first_form"]),
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
        dict(name="take", route="cuda", source=src + "shade.cu",
             replaces="scratch/probe_kernel.py:85",
             path="gather.take_1d/_onehot/_along0/_along_lane",
             launches=take_launches, max_abs_err=err["take"], ms=m["take"][0],
             plain_ms=m["take_plain"][0], bound_ms=take_bound[0],
             bound_by=take_bound[1], library_ms=m["take_library"][0],
             ms_full_size=m["take_full_turns"][0],
             library_ms_full_size=m["take_full_library_turns"][0],
             us_alone_full_size=alone["take"][0],
             library_us_alone_full_size=alone["take"][1],
             bound_ms_full_size=take_full_bound[0]),
        dict(name="loop_probe", route="cuda", source=src + "shade.cu",
             replaces="scratch/probe2.py:80", path="gather.loop_probe",
             launches=loop_launches, max_abs_err=err["loop_probe"],
             ms=m["loop_2048_0"][0], plain_ms=loop_plain_ms[(2048, 0)],
             bound_ms=loop_bound[0], bound_by=loop_bound[1], library_ms=None,
             us_alone=alone["loop_probe"]),
        dict(name="shade_fwd", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:35",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["shade_fwd"],
             max_abs_err=err["shade_fwd"], ms=m["shade_fwd"][0],
             plain_ms=m["shade_fwd_plain"][0], bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None),
        dict(name="shade_bwd", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:132",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["shade_bwd"],
             max_abs_err=err["shade_bwd"], ms=m["bwd_turns"][0],
             plain_ms=m["shade_bwd_plain"][0], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             ms_first_form=m["bwd_first_turns"][0],
             us_alone=alone["shade_bwd"][0],
             us_alone_first_form=alone["shade_bwd"][1],
             us_in_step=kernel_us(step_rows, "shade_bwd_kernel")[0]),
        dict(name="shade_bwd_serial", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:132",
             path="shade_cuda.shade_bwd_serial (the first form, off the "
                  "training path)", launches=first_launches["shade_bwd_serial"],
             max_abs_err=err["shade_bwd_serial"], ms=m["bwd_first_turns"][0],
             plain_ms=m["shade_bwd_plain"][0], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             us_alone=alone["shade_bwd"][1]),
        dict(name="segment_sum", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:72",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["segment_sum"],
             max_abs_err=err["segment_sum"], ms=m["segment_sum"][0],
             plain_ms=m["segment_plain"][0], bound_ms=seg_bound[0],
             bound_by=seg_bound[1], library_ms=m["segment_library"][0],
             kernels_us=seg_kernel_us),
        dict(name="segment_sum_sorted", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:72",
             path="shade_cuda.sort_by_leaf + segment_sum_sorted (the sorted "
                  "form, off the training path)",
             launches=sorted_launches, max_abs_err=err["segment_sum_sorted"],
             ms=m["segment_sorted_whole"][0], plain_ms=m["segment_plain"][0],
             bound_ms=seg_bound[0], bound_by=seg_bound[1],
             library_ms=m["segment_library"][0]),
    ]
    # the brick and stackless traces: the main path's line carries the other
    # forms' times and every form's warp counters; the brick trace's other
    # forms have lines of their own
    per_ray = dict(
        brick_trace=dict(replaces="raytracingtest_tpu/ops/brick.py:492",
                         path="diff.render_diff_brick / diff.loss_and_grads_brick / "
                              "InverseRenderer.step", route="brick", turns="trace_brick",
                         plain="brick_plain", bound=brick_bound),
        esvo_stackless=dict(replaces="raytracingtest_tpu/ops/traverse.py:530",
                            path="diff.render_diff / diff.loss_and_grads",
                            route="plain", turns="trace_stackless",
                            plain="stackless_plain", bound=stackless_bound))
    for kname, row in per_ray.items():
        common = dict(route="cuda", source=src + "brick_trace.cu",
                      replaces=row["replaces"], plain_ms=m[row["plain"]][0],
                      bound_ms=row["bound"][0], bound_by=row["bound"][1],
                      library_ms=None)
        kernels.append(dict(
            name=kname, **common, path=row["path"] + f" (the {MAIN_FORM[kname]} form)",
            launches=routes[row["route"]]["launches"], max_abs_err=err[kname],
            ms=m[f"{row['turns']}_turns"][0], us_alone=alone[kname],
            launches_train_step=train_launches[row["route"]][kname],
            **({} if kname != "brick_trace" else dict(
                ms_first_form=m["trace_brick_first_turns"][0],
                us_alone_first_form=alone[(kname, "first")],
                ms_unstaged_form=m["trace_brick_unstaged_turns"][0],
                us_alone_unstaged_form=alone[(kname, "unstaged")])),
            warps={form: warp_counts[(kname, form)] for form in brick_cuda.FORMS[kname]}))
        if kname == "brick_trace":
            kernels += [dict(name=f"brick_trace_{suffix}", **common,
                             path=f"brick_cuda.{call} ({what}, off the main path)",
                             launches=first_launches[f"brick_trace_{suffix}"],
                             max_abs_err=err[f"brick_trace_{suffix}"],
                             ms=m[f"trace_brick_{form}_turns"][0],
                             us_alone=alone[(kname, form)])
                        for suffix, form, call, what in (
                            ("serial", "first", "trace_brick_cuda_serial", "the first form"),
                            ("unstaged", "unstaged", "_brick_unstaged_kernel",
                             "the wide form without staged rows"))]
    kernels[0]["launches_train_step"] = train_launches["per-ray"]["esvo_trace"]
    kernels[2]["launches_train_step"] = train_launches["tile"]["tile_walk"]
    kernels[4]["launches_train_step"] = train_launches["tile"]["tile_candidates"]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
