"""Time the SVO build on one NVIDIA GPU, in a process of its own.

    env PYTHONPATH=. python3 build_timing.py LABEL [DEPTH]

Builds the port's libraries and prints LABEL with the wall seconds of
`octree_device.build_svo_device` of `terrain` at DEPTH (10 by default) on the
card: the first call, then the median, lowest and highest of 20 calls after
it, each between two synchronisations. Run it from the roots of two
checkouts in turns (parent, change, change, parent) to compare their builds
without the state of a longer script.
"""

import sys
import time

import numpy as np
import torch

from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import octree_device
from raytracingtest_tpu_torch.scenes import get_scene


def main(label, depth):
    if not torch.cuda.is_available():
        raise SystemExit("build_timing: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    _build.build_all()
    scene = get_scene("terrain")

    def build():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        octree_device.build_svo_device(scene, depth, device=dev)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    first = build()
    times = [build() for _ in range(20)]
    print(label, f"build_svo_device(terrain, {depth}) s: first {first:.4f}, then "
          f"median {np.median(times):.4f}, min {min(times):.4f}, max {max(times):.4f} "
          "(20 calls)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "build",
         int(sys.argv[2]) if len(sys.argv) > 2 else 10)
