"""brick_trace_multi_roofline.serve: ``brick_trace_multi``'s share of its
roofline in the traced frames (``work.brick_trace_multi``, one launch a
frame, its staged or first form)."""

from rtb import readers, work

PATTERN = r"(?<![A-Za-z_])brick_trace_multi(_staged)?_kernel"


def read(run):
    return readers.roofline(run, PATTERN, work.brick_trace_multi, launches_per_call=1)
