"""The yardstick's arithmetic: the card's peaks, the operations a kernel's
loop trip costs, and each timed kernel's least time from the work its inputs
need.

Frozen copy of ``chip_smoke.py``'s ``bound()``, ``PEAK_*`` and ``OPS_*``
(commit c4b99874d80592771fd0a8ae8a7eee3dc0040498). The counts of steps, hits
and touched leaves come from the benchmark's own plain walk
(``refwalk``), never from the program's counters.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and the float32 rate outside the tensor cores, which is the rate of these
# kernels' scalar float and integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Arithmetic and logic operations of one trip of each kernel's loop, counted
# from the kernels' source: a top step of the brick trace (as an ESVO step), a
# DDA step, a ray's set-up, a shaded hit forward and backward (which repeats
# the forward), and a segment sum's row.
OPS_ESVO_STEP = 40
OPS_DDA_STEP = 32
OPS_RAY_SETUP = 40
OPS_SHADE_FWD = 45
OPS_SHADE_BWD = 100
OPS_SEGMENT_ROW = 7

# bytes of a ray in (origin and direction, float32), of the brick trace's
# results out (hit_leaf, hit_t, hit_parent, hit_child, iters), of a leaf's
# parameter row (albedo, normal, density) and of a k-segment slot
# (leaf, t_in, t_out) with a ray's count and steps
RAY_BYTES = 24
BRICK_OUT_BYTES = 20
ROW_BYTES = 28
SLOT_BYTES = 12
MULTI_RAY_OUT_BYTES = 8


def least_time(n_bytes, n_ops):
    """(seconds, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the float32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S
    by_ops = n_ops / PEAK_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def brick_trace(w):
    """(bytes, operations) of one ``brick_trace`` call: its rays in and
    results out, its tables read once, and the top and DDA steps and ray
    set-ups these rays need."""
    n = w["rays"]
    n_bytes = n * (RAY_BYTES + BRICK_OUT_BYTES) + w["table_bytes"]
    n_ops = (w["top_steps"] * OPS_ESVO_STEP + w["dda_steps"] * OPS_DDA_STEP
             + n * OPS_RAY_SETUP)
    return n_bytes, n_ops


def brick_trace_multi(w):
    """(bytes, operations) of one ``brick_trace_multi`` call: as
    ``brick_trace``'s, with k slots and a count a ray out."""
    n, k = w["rays"], w["k"]
    n_bytes = (n * (RAY_BYTES + k * SLOT_BYTES + MULTI_RAY_OUT_BYTES)
               + w["table_bytes"])
    n_ops = (w["top_steps"] * OPS_ESVO_STEP + w["dda_steps"] * OPS_DDA_STEP
             + n * OPS_RAY_SETUP)
    return n_bytes, n_ops


def shade_bwd(w):
    """(bytes, operations) of one ``shade_bwd`` call: each ray's leaf,
    direction and image cotangent in, its 28 B of row cotangents out, each
    touched leaf's row and the light read once; 100 operations a hit."""
    n = w["rays"]
    n_bytes = n * (4 + 12 + 12 + ROW_BYTES) + w["touched"] * ROW_BYTES + 12
    return n_bytes, w["hits"] * OPS_SHADE_BWD


def segment_sum(w):
    """(bytes, operations) of one ``segment_sum`` call, the function and not
    an implementation: every ray's leaf once, each hit's cotangent row once,
    each leaf's summed row written once."""
    n_bytes = w["rays"] * 4 + w["hits"] * ROW_BYTES + w["leaves"] * ROW_BYTES
    return n_bytes, w["hits"] * OPS_SEGMENT_ROW


def backward(w):
    """(bytes, operations) of ``shade_bwd`` and ``segment_sum`` together."""
    a, b = shade_bwd(w), segment_sum(w)
    return a[0] + b[0], a[1] + b[1]
