"""device_idle_share.serve: the share of the traced stretch of frames in
which no kernel, copy or set ran on the card."""

from rtb import readers


def read(run):
    return readers.idle_share(run)
