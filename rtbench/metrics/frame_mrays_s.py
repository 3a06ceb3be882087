"""frame_mrays_s: every ray of every frame finished in the window, over the
window, in millions a second."""


def read(run):
    return run.rays / run.window_s / 1e6 if run.window_s else None
