"""device_idle_share.fit: the share of the traced stretch of train steps in
which no kernel, copy or set ran on the card."""

from rtb import readers


def read(run):
    return readers.idle_share(run)
