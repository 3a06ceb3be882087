"""The traced stretch: ``torch.profiler`` over a run of calls, read into
device time by kernel, the device's busy time, and what the host was doing
while the device idled.

The tracer drops the launches it sees while it starts, so the stretch runs
under ``schedule(wait=0, warmup=1, active=1)``: a warm-up pass of calls,
then the recorded pass. A recorded pass counts only when every launch the
host made in it (each runtime call that puts a kernel, a copy or a set on
the device) has its device activity in the trace, matched by correlation
id; ``Stretch.complete`` says whether it did.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

import torch

WINDOW = "rtbench.window"
# host runtime calls that put work on the device
_LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")
TOP = 10


@dataclasses.dataclass
class Stretch:
    window_s: float
    busy_s: float
    complete: bool
    launches: int
    lost: int
    kernels: list        # (name, start_s, duration_s) on the device, in order
    device_ops: list     # [[name, seconds]], the most time first
    idle_gaps: list      # [[host activity, seconds]], the most idle first


def short_name(name):
    """A kernel's name without its return type and argument list."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].rstrip()
    return name


def record(call, n_warm, n_active, sync):
    """Run ``call(j)`` n_warm times untraced and n_active times traced
    (j counting on from 0 over both passes), ``sync()`` after each pass; the
    recorded pass read into a ``Stretch``."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    ready = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: ready.append(
                     list(p.profiler.kineto_results.events()))) as prof:
        for j in range(n_warm):
            call(j)
        sync()
        prof.step()
        with record_function(WINDOW):
            for j in range(n_warm, n_warm + n_active):
                call(j)
            sync()
        prof.step()
    if not ready:
        raise RuntimeError("the profiler handed back no trace")
    return read(ready[-1])


def read(events):
    host, dev, win = [], [], None
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(ev)
        elif ev.name() == WINDOW:
            win = (ev.start_ns(), ev.end_ns())
        else:
            host.append(ev)
    if win is None:
        raise RuntimeError("the traced window's span is missing from the trace")
    # a host annotation's mirror on the card carries the annotation's name:
    # it is no work on the card
    host_names = {ev.name() for ev in host} | {WINDOW}
    dev = [ev for ev in dev if ev.name() not in host_names]
    w0, w1 = win
    launches = [ev for ev in host if _LAUNCH.match(ev.name())
                and w0 <= ev.start_ns() <= w1]
    seen = {ev.correlation_id() for ev in dev}
    lost = sum(ev.correlation_id() not in seen for ev in launches)
    inside = sorted((ev for ev in dev if ev.end_ns() > w0 and ev.start_ns() < w1),
                    key=lambda ev: ev.start_ns())

    # the device's busy intervals, merged, clipped to the window
    busy, merged = 0, []
    for ev in inside:
        a, b = max(ev.start_ns(), w0), min(ev.end_ns(), w1)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)

    by_name = collections.defaultdict(int)
    for ev in inside:
        by_name[short_name(ev.name())] += ev.end_ns() - ev.start_ns()
    device_ops = [[n, t * 1e-9] for n, t in sorted(by_name.items(),
                                                    key=lambda kv: -kv[1])[:TOP]]

    # each idle gap named by the innermost host op running at its start
    ops = sorted((ev for ev in host if ev.end_ns() > w0 and ev.start_ns() < w1
                  and not ev.name().startswith("ProfilerStep")),
                 key=lambda ev: ev.start_ns())
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    starts = [ev.start_ns() for ev in ops]
    idle = collections.defaultdict(int)
    for a, b in gaps:
        # the op that started last among those still running at a is the
        # innermost; look back a bounded way
        name, last_end = "no traced host op", None
        top = bisect.bisect_right(starts, a)
        for j in range(top - 1, max(top - 400, -1), -1):
            if ops[j].end_ns() > a:
                name = ops[j].name()
                break
            if last_end is None or ops[j].end_ns() > last_end:
                last_end, name = ops[j].end_ns(), "after " + ops[j].name()
        idle[name] += b - a
    idle_gaps = [[n, t * 1e-9] for n, t in sorted(idle.items(),
                                                   key=lambda kv: -kv[1])[:TOP]]
    kernels = [(ev.name(), ev.start_ns() * 1e-9, (ev.end_ns() - ev.start_ns()) * 1e-9)
               for ev in inside]
    return Stretch(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   complete=lost == 0, launches=len(launches), lost=lost,
                   kernels=kernels, device_ops=device_ops, idle_gaps=idle_gaps)
