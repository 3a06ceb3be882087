"""Multi-process start-up from the environment, and each process's rows.

Port of ``raytracingtest_tpu/parallel/multihost.py``:

  * ``init_from_env`` starts ``torch.distributed`` when a coordinator is
    configured: JAX_COORDINATOR_ADDRESS (host:port), JAX_NUM_PROCESSES and
    JAX_PROCESS_ID, the reference's variables; or RAYT_MULTIHOST=auto,
    which reads torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    Any other case runs one process and starts nothing, as the reference
    does. NCCL for a CUDA device, gloo for the CPU.
  * ``ProcessRays`` and ``process_rows`` give each process its contiguous
    block of image rows; ``local_camera_rays`` makes only those rays.
  * ``global_ray_array``: in the reference it assembles one global array
    from the processes' rows. Here a process holds one device, so its rows
    are its shard of the mesh (``mesh.ray_sharding``'s rows), and the
    sharded entry points take them as they are.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from raytracingtest_tpu_torch._device import resolve
from raytracingtest_tpu_torch.parallel.mesh import backend_for


def init_from_env(verbose: bool = True, device=None) -> dict:
    """Start ``torch.distributed`` from the environment if a coordinator
    is configured, on `device`'s backend (None: the card); otherwise do
    nothing. Returns the reference's status dict."""
    mode = os.environ.get("RAYT_MULTIHOST", "")
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if not coord and mode != "auto":
        return {
            "initialized": False,
            "process_index": 0,
            "process_count": 1,
            "reason": "single-host (no JAX_COORDINATOR_ADDRESS / "
                      "RAYT_MULTIHOST)",
        }
    if not dist.is_initialized():
        backend = backend_for(resolve(device))
        if coord:
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}",
                world_size=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
                rank=int(os.environ.get("JAX_PROCESS_ID", "0")))
        else:
            dist.init_process_group(backend, init_method="env://")
    info = {
        "initialized": True,
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
    if verbose and dist.get_rank() == 0:
        print(f"# torch.distributed: {info}")
    return info


@dataclasses.dataclass(frozen=True)
class ProcessRays:
    """This process's slice of a global pixel-row range."""

    row_start: int
    row_stop: int
    height: int
    width: int

    @property
    def n_local(self) -> int:
        return (self.row_stop - self.row_start) * self.width


def process_rows(height: int, width: int, process_index: int | None = None,
                 process_count: int | None = None) -> ProcessRays:
    """Image rows partitioned over the processes in contiguous blocks
    (None: this process's rank and the world's size, or 0 and 1 with no
    world); the height must divide evenly (pad the image otherwise)."""
    started = dist.is_initialized()
    pi = (dist.get_rank() if started else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if started else 1) if process_count is None else process_count
    if height % pc:
        raise ValueError(f"height {height} not divisible by {pc} processes")
    rows = height // pc
    return ProcessRays(row_start=pi * rows, row_stop=(pi + 1) * rows,
                       height=height, width=width)


def local_camera_rays(camera, pr: ProcessRays, device=None, jitter=None):
    """Only this process's rays: rows [row_start, row_stop) of the camera's
    pixel grid, (n_local, 3) origins and directions on `device` (None: the
    card)."""
    o, d = camera.rays(device, jitter=jitter)
    o = o.reshape(pr.height, pr.width, 3)[pr.row_start:pr.row_stop]
    d = d.reshape(pr.height, pr.width, 3)[pr.row_start:pr.row_stop]
    return o.reshape(-1, 3), d.reshape(-1, 3)


def global_ray_array(mesh, pr: ProcessRays, local_rows):
    """This process's rows as its shard of the global (height * width, ...)
    ray array, on the mesh's device. The rows must be the mesh rank's
    contiguous block."""
    local_rows = torch.as_tensor(local_rows)
    n = pr.height * pr.width
    if n % mesh.world or pr.n_local != n // mesh.world \
            or pr.row_start * pr.width != mesh.rank * (n // mesh.world):
        raise ValueError(f"rows [{pr.row_start}, {pr.row_stop}) are not rank "
                         f"{mesh.rank}'s shard of {mesh.world}")
    if local_rows.shape[0] != pr.n_local:
        raise ValueError(f"{local_rows.shape[0]} rows, expected {pr.n_local}")
    return local_rows.to(mesh.device).contiguous()
