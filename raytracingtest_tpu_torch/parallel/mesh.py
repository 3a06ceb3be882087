"""The ray mesh: one ``torch.distributed`` process a device.

Port of ``raytracingtest_tpu/parallel/mesh.py``. The reference's mesh is n
devices of one JAX process with a "rays" axis; here it is a world of n
processes, each holding one device, and a collective over the world takes
the place of a psum over the axis. ``make_mesh`` joins the world that
``multihost.init_from_env`` (or the caller) started, or, when there is
none, starts a world of one itself: NCCL for a CUDA device, gloo only for
the CPU. So every collective of the sharded paths is a real call, on the
card too.

``ray_sharding`` takes a rank's contiguous shard of a ray batch (rank r
holds rows [r N / n, (r + 1) N / n), the reference's ``P("rays")``), and
``replicated`` puts one full tensor on every rank (``P()``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from raytracingtest_tpu_torch._device import resolve


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """This process's place in the world: its rank, the world's size, its
    device, and the process group of the collectives."""

    rank: int
    world: int
    device: torch.device
    group: object


def rank_device(device=None) -> torch.device:
    """The device of this rank: `device` when named, else its card,
    ``cuda:(LOCAL_RANK or rank) % cards`` (one card a process); with no world
    the default device. Raises where there is no card and none is named."""
    if device is not None:
        return torch.device(device)
    if dist.is_initialized() and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve(None)


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, device=None) -> RayMesh:
    """The mesh of the current world (`n_devices` None: all of it). With no
    world started, a world of one is started here (`n_devices` None or 1).
    Raises ValueError when `n_devices` is not the world's size, and when a
    CUDA device would meet a gloo world."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"n_devices={n_devices} needs a torch.distributed world of "
                f"{n_devices} processes (multihost.init_from_env); none is "
                "started")
        dev = resolve(device)
        # a world of one needs no rendezvous: an in-process store
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    else:
        dev = rank_device(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the world has {world} "
                         "processes")
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(f"device {dev} in a {dist.get_backend()} world: a "
                         "CUDA device takes NCCL")
    return RayMesh(rank=dist.get_rank(), world=world, device=dev,
                   group=dist.group.WORLD)


def ray_sharding(mesh: RayMesh, x):
    """This rank's contiguous shard of `x` along its leading axis, on the
    mesh's device. The leading size must divide evenly (pad the batch)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not divide over {mesh.world} ranks")
    k = n // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device).contiguous()


def replicated(mesh: RayMesh, x):
    """`x` on the mesh's device, equal on every rank: rank 0's copy is
    broadcast to the others."""
    x = torch.as_tensor(x).to(mesh.device).contiguous()
    dist.broadcast(x, src=0, group=mesh.group)
    return x


def all_sum(mesh: RayMesh, x):
    """`x` summed over the ranks, in place (``all_reduce`` SUM): the
    reference's psum. Returns `x`."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x
