"""Time the per-ray fwd+bwd step on one NVIDIA GPU, in a process of its own.

    env PYTHONPATH=. python3 step_timing.py LABEL

Builds the port's libraries, loads or builds the depth-10 `terrain` SVO
(cached under build/), and prints LABEL and three medians of 50 steps of
`diff.loss_and_grads_cuda` on bench.py's 1024x1024 view, timed by CUDA
events after three warm-up steps each. Run it from the roots of two
checkouts in turns to compare the step's host time between them without the
state of a longer script.
"""

import os
import sys

import numpy as np
import torch

from raytracingtest_tpu_torch import _build, diff
from raytracingtest_tpu_torch.io import checkpoint
from raytracingtest_tpu_torch.ops import camera, octree
from raytracingtest_tpu_torch.scenes import get_scene


def main(label):
    if not torch.cuda.is_available():
        raise SystemExit("step_timing: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    _build.build_all()
    cache = os.path.join(_build.BUILD_DIR, "terrain_d10.npz")
    if os.path.exists(cache):
        host = checkpoint.load_svo(cache, "cpu")
    else:
        host = octree.build_svo(get_scene("terrain"), 10).svo
        checkpoint.save_svo(host, cache)
    svo = host.to(dev)
    o, d = camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                         fov_y_deg=50.0, width=1024, height=1024).rays(dev)
    light = torch.tensor([-0.5, -1.0, -0.3], device=dev)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    target0 = torch.zeros((o.shape[0], 3), device=dev)
    step = lambda: diff.loss_and_grads_cuda(*params, svo, o, d, light, target0)
    medians = []
    for _ in range(3):
        for _ in range(3):
            step()
        times = []
        for _ in range(50):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        medians.append(float(np.median(times)))
    print(label, "per-ray step medians (ms, 3 x 50):",
          " ".join(f"{m:.4f}" for m in medians), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
