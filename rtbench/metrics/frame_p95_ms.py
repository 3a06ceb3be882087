"""frame_p95_ms: the 95th percentile of every window frame's time from the
call to the frame's end, read on the card's clock (CUDA events recorded at
the call and after the frame's last launch, the card idle before the call);
numpy's linear interpolation."""

import numpy as np


def read(run):
    return float(np.percentile(run.frame_s, 95)) * 1e3 if run.frame_s else None
