"""Trace the SVO build on one NVIDIA GPU by phase, in a process of its own.

    env PYTHONPATH=. python3 build_phases.py LABEL [DEPTH]

Builds the port's libraries and, for `octree_device.build_svo_device` of
`terrain` at DEPTH (10 by default) on the card and for its octant of
`build_svo_device_split(terrain, DEPTH, 2)` with the most nodes, prints
LABEL with: the wall seconds of 20 calls after a first (median, lowest,
highest, each between two synchronisations); then from one traced call
(`torch.profiler`), by phase, the kernels' microseconds and launches, the
memory copies and sets, the host synchronisations, and each phase's
kernels by name. The phases are the build's (ops/octree_device.py): A the
expansions, from the call to the leaf test; B the leaf test, its compaction
and the leaves' attributes; C, from there, the upward pass and the
assembly; D the parent pointers, where the build still calls
`octree_cuda.parent_ptr` (its first form). The script marks each phase's
start on the stream with a one-cycle `torch.cuda._sleep` kernel inside a
`record_function` range (three launches a build, counted apart), so that
the card's order splits the kernels and the host's clock the
synchronisations. The idle share is 1 less the traced call's kernel time
over the untraced calls' median wall. Run it from the roots of two
checkouts in turns (parent, change, change, parent) to compare them.
"""

import contextlib
import re
import sys
import time

import numpy as np
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import octree_cuda, octree_device
from raytracingtest_tpu_torch.ops.morton import morton_decode
from raytracingtest_tpu_torch.scenes import get_scene

MARK = "spin_kernel"  # torch.cuda._sleep's kernel
PHASES = ("A", "B", "C", "D")


def _mark(phase):
    with torch.profiler.record_function(f"phase {phase}"):
        torch.cuda._sleep(1)


@contextlib.contextmanager
def phase_marks():
    """Inside the block a build marks the starts of phases B (the leaf test's
    call), C (the return of the leaves' attributes) and D (a call of
    octree_cuda.parent_ptr) on the stream."""
    leaves, leaf_attrs, parent_ptr = (octree_cuda.leaves, octree_cuda.leaf_attrs,
                                      octree_cuda.parent_ptr)

    def marked_leaves(*a, **k):
        _mark("B")
        return leaves(*a, **k)

    def marked_attrs(*a, **k):
        out = leaf_attrs(*a, **k)
        _mark("C")
        return out

    def marked_pptr(*a, **k):
        _mark("D")
        return parent_ptr(*a, **k)

    octree_cuda.leaves, octree_cuda.leaf_attrs, octree_cuda.parent_ptr = (
        marked_leaves, marked_attrs, marked_pptr)
    try:
        yield
    finally:
        octree_cuda.leaves, octree_cuda.leaf_attrs, octree_cuda.parent_ptr = (
            leaves, leaf_attrs, parent_ptr)


def short_name(name):
    """A kernel's or runtime call's name without its namespaces, template
    arguments and parameters."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:  # drop <...> and (...) at any depth
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    words = "".join(out).replace("void ", "").split("::")
    return words[-1].strip() or name[:40]


def is_sync(name):
    return "Synchronize" in name


def is_annotation(name):
    """The tracer mirrors the host's ranges onto the card's timeline: no
    kernel."""
    return name == "build" or name.startswith(("phase ", "ProfilerStep"))


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def split_events(events):
    """(kernel rows, copy rows, sync times, mark times) of a trace's events:
    kernels and copies on the card as (start, us, name) in start order, the
    host's synchronisations' start times inside the "build" range, and each
    phase mark's host start and card start."""
    from torch.autograd import DeviceType
    kernels, copies, syncs, host_marks = [], [], [], {}
    call = (float("-inf"), float("inf"))
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not is_annotation(e.name):
                (copies if is_copy(e.name) else kernels).append(
                    (start, end - start, e.name))
        elif e.name == "build":
            call = (start, end)
        elif e.name.startswith("phase "):
            host_marks[e.name[6:]] = start
        elif is_sync(e.name):
            syncs.append(start)
    # the build's own synchronisations, not the caller's after it
    syncs = [s for s in syncs if call[0] <= s <= call[1]]
    kernels.sort()
    copies.sort()
    card_marks = [k for k in kernels if MARK in k[2]]
    kernels = [k for k in kernels if MARK not in k[2]]
    marks = {p: (host_marks[p], card[0]) for p, card in
             zip(sorted(host_marks, key=host_marks.get), card_marks)}
    return kernels, copies, sorted(syncs), marks


def by_phase(kernels, copies, syncs, marks):
    """Each phase's kernels, copies and synchronisations, split at the
    marks (a phase without a mark is empty)."""
    bounds = [("A", float("-inf"), float("-inf"))] + [
        (p, *marks[p]) for p in PHASES[1:] if p in marks]
    out = {p: dict(kernels=[], copies=0, syncs=0) for p in PHASES}
    for i, (p, host0, card0) in enumerate(bounds):
        host1, card1 = ((bounds[i + 1][1], bounds[i + 1][2]) if i + 1 < len(bounds)
                        else (float("inf"), float("inf")))
        out[p]["kernels"] = [k for k in kernels if card0 <= k[0] < card1]
        out[p]["copies"] = sum(1 for c in copies if card0 <= c[0] < card1)
        out[p]["syncs"] = sum(1 for s in syncs if host0 <= s < host1)
    return out


def trace_build(fn):
    """One call of fn() (a build) under torch.profiler, in a "build" range,
    after one call in the profiler's warm-up cycle; returns by_phase's
    split."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with phase_marks():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            with torch.profiler.record_function("build"):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return by_phase(*split_events(prof.events()))


def phase_rows(split):
    """Per phase: (us, launches, copies, syncs, [(name, us, launches)] by
    us, largest first)."""
    rows = {}
    for p, part in split.items():
        named = {}
        for _, us, name in part["kernels"]:
            key = short_name(name)
            u, n = named.get(key, (0.0, 0))
            named[key] = (u + us, n + 1)
        rows[p] = (sum(us for _, us, _ in part["kernels"]), len(part["kernels"]),
                   part["copies"], part["syncs"],
                   sorted(((k, u, n) for k, (u, n) in named.items()), key=lambda r: -r[1]))
    return rows


def launches_named(split, key):
    """The device us of each launch whose kernel's name holds `key`, in
    launch order, over every phase."""
    return [us for p in PHASES for _, us, name in split[p]["kernels"] if key in name]


def wall_seconds(fn, calls=20):
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def report(label, what, fn):
    """Print `what`'s walls and its traced call's phases; returns the
    phases' rows and the median wall."""
    fn()
    torch.cuda.synchronize()
    times = wall_seconds(fn)
    split = trace_build(fn)
    rows = phase_rows(split)
    total_us = sum(r[0] for r in rows.values())
    wall = float(np.median(times))
    print(f"{label} {what}: wall s median {wall:.5f}, min {min(times):.5f}, max "
          f"{max(times):.5f} (20 calls); traced call: {total_us:.1f} us of kernels in "
          f"{sum(r[1] for r in rows.values())} launches, "
          f"{sum(r[2] for r in rows.values())} copies and sets, "
          f"{sum(r[3] for r in rows.values())} host syncs; idle share "
          f"{1 - total_us * 1e-6 / wall:.4f} of the median wall", flush=True)
    for p, (us, n, copies, syncs, named) in rows.items():
        print(f"{label}   phase {p}: {us:.1f} us in {n} launches, {copies} copies and "
              f"sets, {syncs} host syncs; " + ", ".join(
                  f"{k} {u:.1f} ({c})" for k, u, c in named), flush=True)
    for key in ("svo_level_pass", "svo_level_up"):
        us = launches_named(split, key)
        if us:
            print(f"{label}   {key}, each launch (finest level first): "
                  + ", ".join(f"{u:.1f}" for u in us), flush=True)
    return rows, wall


def main(label, depth):
    if not torch.cuda.is_available():
        raise SystemExit("build_phases: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    _build.build_all()
    scene = get_scene("terrain")
    report(label, f"build_svo_device(terrain, {depth})",
           lambda: octree_device.build_svo_device(scene, depth, device=dev))
    # the split build's octant with the most nodes
    cx, cy, cz = morton_decode(np.arange(64, dtype=np.uint32))
    roots = [(int(x), int(y), int(z)) for x, y, z in zip(cx, cy, cz)]
    sizes = [octree_device.build_svo_device(scene, depth, root_level=2, root_coord=r,
                                            device=dev).n_nodes for r in roots]
    o = int(np.argmax(sizes))
    report(label, f"octant {o} {roots[o]} of build_svo_device_split(terrain, {depth}, 2) "
           f"({sizes[o]} nodes)",
           lambda: octree_device.build_svo_device(scene, depth, root_level=2,
                                                  root_coord=roots[o], device=dev))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "build",
         int(sys.argv[2]) if len(sys.argv) > 2 else 10)
