"""backward_roofline.fit: the share of their roofline of ``shade_bwd`` and
``segment_sum``'s kernels together in the traced train steps
(``work.backward``: their summed work over their summed device time)."""

from rtb import readers, work

PATTERN = r"(?<![A-Za-z_])(shade_bwd_kernel|seg_(count|base|place|sum|long)_kernel)"


def read(run):
    return readers.roofline(run, PATTERN, work.backward)
