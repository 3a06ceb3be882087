"""Profiling: a rays/s counter, torch.profiler traces, and a first-order
roofline of the traversal loop.

Port of ``raytracingtest_tpu/utils/profiling.py``. ``RaysPerSecond`` waits
for the card before it reads the clock, so a frame's time is the frame's,
not its launch's. ``device_trace`` and ``device_op_breakdown`` run
``torch.profiler`` and read the CUDA kernels' device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

# the NVIDIA H100 SXM's HBM3 bandwidth, GB/s
H100_HBM_GBPS = 3350.0


def _synchronize(device):
    """Wait for `device`'s queued work when it is a CUDA device; None means
    every CUDA device this process has used."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RaysPerSecond:
    """Accumulating rays/s counter (the frame counter's analogue)."""

    rays: int = 0
    seconds: float = 0.0
    frames: int = 0

    @contextlib.contextmanager
    def frame(self, n_rays: int, device=None):
        """Time one frame of `n_rays` rays on `device` (None: every CUDA
        device in use): the card's queued work is waited for before the
        clock starts and again before it stops."""
        _synchronize(device)
        t0 = time.perf_counter()
        yield
        _synchronize(device)
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays
        self.frames += 1

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (f"{self.frames} frames, {self.rays:.3g} rays in "
                f"{self.seconds:.2f}s = {self.rays_per_s/1e6:.2f} Mrays/s")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block, written as a Chrome trace under
    `logdir` (open it in Perfetto or chrome://tracing)."""
    import os

    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=_activities(),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def traversal_roofline(n_rays: int, depth: int, mean_iters: float,
                       hbm_gbps: float = H100_HBM_GBPS):
    """First-order cost model of the traversal loop a frame: one packed
    (8 B) node fetch and about 32 B of state traffic a ray and iteration,
    over the memory bandwidth `hbm_gbps` (the loop is memory-bound).
    Returns the ideal frame time and the rays/s ceiling it implies."""
    bytes_per_iter = 8 + 32
    total_bytes = n_rays * mean_iters * bytes_per_iter
    t_ideal = total_bytes / (hbm_gbps * 1e9)
    return {
        "bytes": total_bytes,
        "ideal_s": t_ideal,
        "rays_per_s_ceiling": n_rays / t_ideal if t_ideal else float("inf"),
    }


def iter_stats(iters) -> dict:
    it = iters.cpu().numpy() if isinstance(iters, torch.Tensor) else np.asarray(iters)
    return {
        "mean": float(it.mean()),
        "p50": float(np.percentile(it, 50)),
        "p99": float(np.percentile(it, 99)),
        "max": int(it.max()),
    }


def device_op_breakdown(fn, *args, calls: int = 3, top: int = 30) -> list:
    """Run `fn(*args)` `calls` times under torch.profiler, after one warm-up
    call, and total the CUDA kernels' device time by kernel name. Returns
    [(kernel name, total ms, launches)] by total time, at most `top` rows;
    divide by `calls` for one call's share. Without a CUDA device there
    are no kernel rows and the list is empty."""
    fn(*args)  # warm: builds and first launches stay out of the trace
    _synchronize(None)
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(calls):
            fn(*args)
        _synchronize(None)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]
