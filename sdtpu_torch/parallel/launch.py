"""Starting the ranks of a torch.distributed world.

sdtpu is single-controller: one process drives every device of its mesh,
so it needs no launcher. Here each rank is a process:

- spawn(world, fn, *args, backend=...) starts `world` ranks on this host
  with torch.multiprocessing.spawn and a file:// rendezvous in a fresh
  temporary directory, runs fn(*args) in each inside an initialised world,
  and returns each rank's return value (a list in rank order);
- init_from_env(backend) joins the world torchrun describes (its RANK,
  WORLD_SIZE, MASTER_ADDR and MASTER_PORT: the env:// rendezvous);
- local_device() is the card of this rank on its host, cuda:{LOCAL_RANK %
  device count}; with no card it raises (run on the host with
  device="cpu" explicitly).

The backend is always the caller's: `nccl` where each rank has a card of
its own, `gloo` where ranks share a card (NCCL refuses two ranks on one
device; gloo takes CUDA tensors through the host) or run on the CPU.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def local_device() -> torch.device:
    """cuda:{LOCAL_RANK % torch.cuda.device_count()}, made current."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank (pass device='cpu' to run on the host)")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_from_env(backend: str) -> tuple[int, int]:
    """Join the world torchrun started (env:// rendezvous); returns (rank,
    world size)."""
    _check_backend(backend)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("init_from_env: RANK and WORLD_SIZE are not set (run under torchrun)")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def _rank_main(rank, world, backend, rendezvous, out_dir, fn, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        if dist.is_initialized():  # fn may have ended the world (serve.Batcher)
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, *args, backend: str, timeout: float | None = None):
    """Run fn(*args) on `world` new ranks of one host, each inside an
    initialised torch.distributed world on `backend`; fn must be importable
    by name (a module-level function). Returns [fn's return value of rank r
    for r in range(world)] (returned through torch.save, so tensors come
    back on the device they were on). A rank that raises makes spawn
    raise; past `timeout` seconds (None: no limit) every rank is killed and
    spawn raises TimeoutError."""
    import torch.multiprocessing as mp

    _check_backend(backend)
    tmp = tempfile.mkdtemp(prefix="sdtpu_torch_spawn_")
    try:
        ctx = mp.start_processes(_rank_main, args=(world, backend,
                                                   os.path.join(tmp, "rendezvous"), tmp, fn,
                                                   args), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"spawn: {world} ranks of {fn.__name__} ran past "
                                   f"{timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
