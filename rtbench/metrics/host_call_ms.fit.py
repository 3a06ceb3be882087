"""host_call_ms.fit: the mean host time of ``InverseRenderer.step`` from call
to return, each call made on an idle card (synchronised before it), so no
call waits on the launch queue."""

from rtb import readers


def read(run):
    return readers.mean_ms(run.synced_host_s)
