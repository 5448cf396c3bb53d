"""The ("dp", "tp") mesh over an initialised torch.distributed world (port
of sdtpu/parallel/mesh.py).

sdtpu builds a jax.sharding.Mesh over the devices of one controller and lets
XLA insert the collectives. Here every rank is a process that runs the same
program on its own part: rank r sits at (r // tp, r % tp) of the dp x tp
grid, sdtpu's reshape(dp, tp) of the device list. The mesh holds the process
groups along each axis (`dp_group`: the ranks of one tp column, which hold
the same shards and different batch slices; `tp_group`: the ranks of one dp
row, which share a batch slice and hold different shards) and this rank's
coordinates.

Axes:
- "dp": data parallel, the batch dim split over the ranks of a tp column;
- "tp": tensor parallel, the heads and channel dims of the large weights
  split over the ranks of a dp row (sharding.py).

The backend is the one the caller gave torch.distributed.init_process_group
(`nccl` where each rank has its own card; `gloo` where ranks share a card or
run on the CPU); the mesh reports it and chooses nothing. The device is the
caller's too (launch.local_device() gives a card by the local rank).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A rank's view of the ("dp", "tp") grid. `shape` is sdtpu's
    Mesh.shape, {"dp": dp, "tp": tp}; `active` is False on a rank that
    allow_idle left out of the grid (its coordinates and groups are None)."""
    dp: int
    tp: int
    rank: int
    world: int
    backend: str
    device: torch.device
    dp_rank: Optional[int]
    tp_rank: Optional[int]
    dp_group: Any = field(repr=False)
    tp_group: Any = field(repr=False)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def active(self) -> bool:
        return self.dp_rank is not None


def make_mesh(dp: Optional[int] = None, tp: int = 1, allow_idle: bool = False,
              device=None) -> Mesh:
    """Build the ("dp", "tp") mesh of the initialised world; dp defaults to
    world // tp. Every rank must call it, with the same arguments: it
    creates the process groups of both axes (torch.distributed.new_group is
    collective).

    dp*tp must cover every rank: an idle rank is a provisioning bug, not a
    layout choice. allow_idle=True (with a warning) runs a sub-mesh on the
    first dp*tp ranks. device: this rank's device (torch.device or str);
    None is the current CUDA device when a card is present, else an error:
    nothing falls back to the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(parallel.launch.spawn or init_from_env)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the {n} devices")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    if dp * tp < n:
        if not allow_idle:
            raise ValueError(
                f"mesh {dp}x{tp} uses {dp * tp} of {n} devices; {n - dp * tp} "
                f"would sit idle. Pass allow_idle=True if that is intended.")
        warnings.warn(f"mesh {dp}x{tp} leaves {n - dp * tp} of {n} devices idle",
                      stacklevel=2)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the host")
        device = torch.device("cuda", torch.cuda.current_device())
    # every rank creates every group, in the same order
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    active = rank < dp * tp
    d_r, t_r = (rank // tp, rank % tp) if active else (None, None)
    return Mesh(dp, tp, rank, n, str(dist.get_backend()), torch.device(device), d_r, t_r,
                dp_groups[t_r] if active else None, tp_groups[d_r] if active else None)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's `obj` (anything picklable) on every rank of the world: a
    collective, which every rank calls in the same order (the others pass
    None). So one rank decides what a step runs, and every rank then runs
    the same code on it (serve.Batcher on a mesh). On gloo through a host
    tensor; on nccl through one on the mesh's device."""
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, device=torch.device("cpu") if mesh.backend == "gloo"
                               else mesh.device)
    return box[0]
