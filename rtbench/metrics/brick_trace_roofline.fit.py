"""brick_trace_roofline.fit: ``brick_trace``'s share of its roofline in the
traced train steps (``work.brick_trace``, one launch a step)."""

from rtb import readers, work

PATTERN = r"(?<![A-Za-z_])brick_trace_kernel"


def read(run):
    return readers.roofline(run, PATTERN, work.brick_trace, launches_per_call=1)
