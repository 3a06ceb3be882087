"""Helpers of the metrics' readers (``rtbench/metrics/<metric>.py``): a
kernel's share of its roofline over the traced stretch, and a mean of host
spans. A reader that finds nothing to read returns None, and the metric is
left out of the result line."""

from __future__ import annotations

import re

from rtb import trace, work


def kernel_seconds(run, pattern):
    """The device seconds of the traced stretch's kernels whose name
    matches `pattern`, one entry a launch; None without a whole trace."""
    st = run.stretch
    if st is None or not st.complete:
        return None
    rx = re.compile(pattern)
    return [dur for name, _start, dur in st.kernels if rx.search(trace.short_name(name))]


def roofline(run, pattern, work_fn, launches_per_call=None):
    """100 x the least time of the traced calls' work (``work_fn`` of each
    call's work, ``work.least_time``) over the device time of the kernels
    that match `pattern`; None where the trace is not whole, no such kernel
    ran, the work is unknown, or (with `launches_per_call`) the launches do
    not match the calls."""
    durs = kernel_seconds(run, pattern)
    if not durs or not run.work or len(run.work) != run.stretch_calls:
        return None
    if launches_per_call is not None and len(durs) != launches_per_call * run.stretch_calls:
        return None
    least = sum(work.least_time(*work_fn(w))[0] for w in run.work)
    return 100.0 * least / sum(durs)


def mean_ms(spans):
    return 1e3 * sum(spans) / len(spans) if spans else None


def idle_share(run):
    st = run.stretch
    if st is None or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
