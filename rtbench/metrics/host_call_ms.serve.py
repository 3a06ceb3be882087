"""host_call_ms.serve: the mean host time of the renderer's ``render`` from
call to return over the window's frames (each asked for on an idle card),
the copies that wait for the card included."""

from rtb import readers


def read(run):
    return readers.mean_ms(run.call_host_s)
