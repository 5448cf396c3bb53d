"""Tensor-parallel primitives: the four conjugate autograd functions of
Megatron-LM's tensor parallelism, and the context that tells the models
which tp group they run in.

sdtpu needs none of this: GSPMD propagates its shardings and inserts the
collectives, forward and backward. Here a rank computes on its shards and
calls the collectives itself, and torch.distributed's collectives record no
gradient, so each one sits inside a torch.autograd.Function whose backward
is the conjugate collective:

- copy_to_tp:      forward identity,            backward all-reduce
  (where a replicated activation enters a column-parallel product);
- reduce_from_tp:  forward all-reduce,          backward identity
  (after a row-parallel product);
- gather_from_tp:  forward all-gather on a dim, backward this rank's slice
  (after an out-channel-sharded convolution);
- scatter_to_tp:   forward this rank's slice,   backward all-gather
  (a shard derived from a whole leaf inside a differentiated step).

A slice may be taken in `blocks` equal blocks of the dim: rank r's slice of
[a | b] (blocks=2) is [a_r | b_r], the layout of the fused attn1.qkv leaf
(3 blocks) and of GEGLU's [value | gate] projection (2 blocks).

Without them every leaf upstream of the first sharded product would train
on a partial gradient. The state is a context variable (as
ops/dispatch.py's), so it belongs to the thread that entered it; the
collectives' groups are captured by each function at its forward.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class TP(NamedTuple):
    """A rank's place in its tp group: rank, size and the process group."""
    rank: int
    size: int
    group: object


_TP = contextvars.ContextVar("sdtpu_torch_tp", default=None)


@contextlib.contextmanager
def use(state: Optional[TP]):
    """Run the models inside the given tp group (None: whole weights)."""
    token = _TP.set(state if state is not None and state.size > 1 else None)
    try:
        yield
    finally:
        _TP.reset(token)


def of_mesh(mesh) -> Optional[TP]:
    """The TP of a parallel.mesh.Mesh (None at tp = 1 or without a mesh)."""
    if mesh is None or mesh.tp == 1:
        return None
    return TP(mesh.tp_rank, mesh.tp, mesh.tp_group)


def current() -> Optional[TP]:
    """The tp group the models run in, or None."""
    return _TP.get()


def _narrow(x, tp: TP, dim: int, blocks: int):
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % (blocks * tp.size):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {blocks} "
                         f"block(s) over {tp.size} ranks")
    xb = x.unflatten(dim, (blocks, n // blocks))
    part = n // blocks // tp.size
    return xb.narrow(dim + 1, tp.rank * part, part).flatten(dim, dim + 1)


def _all_gather(x, tp: TP, dim: int, blocks: int):
    dim = dim % x.ndim
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    if blocks == 1:
        return torch.cat(parts, dim=dim)
    n = x.shape[dim] // blocks
    pb = [p.unflatten(dim, (blocks, n)) for p in parts]
    return torch.cat(pb, dim=dim + 1).flatten(dim, dim + 1)


def _all_reduce(x, tp: TP):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=tp.group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, blocks):
        ctx.tp, ctx.dim, ctx.blocks = tp, dim, blocks
        return _all_gather(x, tp, dim, blocks)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.tp, ctx.dim, ctx.blocks).contiguous(), None, None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, blocks):
        ctx.tp, ctx.dim, ctx.blocks = tp, dim, blocks
        return _narrow(x, tp, dim, blocks).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim, ctx.blocks), None, None, None


def copy_to_tp(x, tp: Optional[TP]):
    """Identity forward, all-reduce of the gradient over tp backward."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: Optional[TP]):
    """All-reduce (sum) over tp forward, identity backward."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp: Optional[TP], dim: int = -1, blocks: int = 1):
    """All-gather of the ranks' slices on `dim` forward (in `blocks`
    blocks), this rank's slice of the gradient backward."""
    return x if tp is None else _GatherFromTP.apply(x, tp, dim, blocks)


def scatter_to_tp(x, tp: Optional[TP], dim: int = -1, blocks: int = 1):
    """This rank's slice of `dim` forward (in `blocks` blocks), all-gather
    of the gradient backward. None passes through."""
    return x if tp is None or x is None else _ScatterToTP.apply(x, tp, dim, blocks)
