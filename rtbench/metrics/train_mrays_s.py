"""train_mrays_s: every ray of every train step issued in the window, over
the window (its last step waited for), in millions a second."""


def read(run):
    return run.rays / run.window_s / 1e6 if run.window_s else None
