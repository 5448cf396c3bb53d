"""Sharding rules: map param-tree paths to specs, and move trees and
batches between their whole and their local form (port of
sdtpu/parallel/sharding.py).

The rules are sdtpu's (its GSPMD specs, kept here as tuples of None and
"tp", sdtpu's PartitionSpec entries): the contraction-friendly dims of the
large weights are split over "tp".

- attention / MLP input projections (query, key, value, fc1, geglu.proj):
  linear w [in, out] -> (None, "tp")   (column parallel)
- output projections (out, fc2, mlp.lin): w [in, out] -> ("tp", None)
  (row parallel; the models all-reduce after the product)
- conv kernels [kh, kw, in, out] with >= 256 output channels: out-channel
  sharded (None,)*3 + ("tp",)
- everything else (norms, biases, embeddings, time-embed MLP): replicated, ()

sdtpu's spec tree is the storage layout: a rank holds the local tree,
each leaf its slice under the spec. Where the models cannot compute on a
slice (a head split between ranks) they gather the weights and compute the
sublayer whole (models/unet.py, models/clip.py, models/vae.py). Two leaves
are column shards taken block by block (tp.py): GEGLU's [value | gate]
projection, whose rank r shard is [value_r | gate_r], and the port's fused
self-attention leaf attn1.qkv (models/unet.py:fuse_qkv, not in sdtpu's
tree), [q_r | k_r | v_r].

Batch ("dp") sharding applies to activations only: a dp rank runs the
rows dp_rank·B/dp .. of every batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from sdtpu_torch.parallel.tp import _all_gather, _narrow, gather_from_tp, of_mesh

_COLUMN_PARALLEL = ("query/w", "key/w", "value/w", "fc1/w", "geglu/proj/w")
_ROW_PARALLEL = ("out/w", "fc2/w", "mlp/lin/w")
# column shards taken block by block: path suffix -> blocks
_BLOCKS = {"geglu/proj/w": 2, "attn1/qkv/w": 3}


def _spec_for(path: str, shape: Tuple[int, ...], tp: int) -> tuple:
    """sdtpu's rule (sdtpu/parallel/sharding.py:_spec_for) as a tuple."""
    if tp <= 1:
        return ()
    for suffix in _COLUMN_PARALLEL:
        if path.endswith(suffix) and shape[-1] % tp == 0:
            return (None,) * (len(shape) - 1) + ("tp",)
    for suffix in _ROW_PARALLEL:
        if path.endswith(suffix) and shape[0] % tp == 0:
            return ("tp",) + (None,) * (len(shape) - 1)
    if path.endswith("/w") and len(shape) == 4 and shape[-1] >= 256 and shape[-1] % tp == 0:
        return (None, None, None, "tp")
    return ()


def _blocks(path: str) -> int:
    return next((n for suffix, n in _BLOCKS.items() if path.endswith(suffix)), 1)


def leaf_spec(path: str, shape: Tuple[int, ...], tp: int) -> tuple:
    """The spec of one leaf: sdtpu's rule, and for the fused attn1.qkv leaf
    (no leaf of sdtpu's tree) a column shard of each third."""
    if tp > 1 and path.endswith("attn1/qkv/w") and (shape[-1] // 3) % tp == 0:
        return (None,) * (len(shape) - 1) + ("tp",)
    return _spec_for(path, shape, tp)


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):  # the CLIP blocks; a spec is a tuple leaf
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params, tp: int):
    """The tree of specs of a parameter tree (any leaves with a .shape;
    leaves without one, such as n_steps, get ())."""
    return _map_with_path(
        lambda path, leaf: leaf_spec(path, tuple(getattr(leaf, "shape", ())), tp), params)


def _split_dim(spec: tuple):
    return spec.index("tp") if "tp" in spec else None


@dataclass(frozen=True)
class Split:
    """Where a leaf is a tp shard: the dim split over the tp ranks and the
    blocks it is taken in (rank r's part of each block, tp.py)."""
    dim: int
    blocks: int = 1

    def whole_shape(self, shape, tp: int) -> tuple:
        """The whole leaf's shape from a rank's part of it."""
        return tuple(n * tp if i == self.dim else n for i, n in enumerate(shape))


def split_of(path: str, shape: Tuple[int, ...], tp: int) -> Optional[Split]:
    """The Split of the leaf at `path` with the whole `shape` under the rule
    at `tp`; None where every rank holds it whole."""
    d = _split_dim(leaf_spec(path, tuple(shape), tp))
    return None if d is None else Split(d % len(shape), _blocks(path))


def splits(params, tp: int):
    """The tree of each leaf's Split (split_of) of a whole tree (leaves with
    a .shape; others get None)."""
    return _map_with_path(
        lambda path, leaf: (split_of(path, tuple(leaf.shape), tp)
                            if hasattr(leaf, "shape") and len(leaf.shape) else None), params)


def local_part(x, split: Optional[Split], tp):
    """This tp rank's part of the whole tensor x under `split` (a copy of
    its own, with no gradient); x itself where split or tp is None."""
    if split is None or tp is None:
        return x
    return _narrow(x, tp, split.dim, split.blocks).clone()


def gather_part(x, split: Optional[Split], tp):
    """The whole tensor from every tp rank's part x (an all-gather over the
    tp group, which every rank of it calls; no gradient); x itself where
    split or tp is None."""
    if split is None or tp is None:
        return x
    return _all_gather(x, tp, split.dim, split.blocks)


def shard_params(params, mesh):
    """This rank's local tree: each sharded leaf's slice along its spec's
    "tp" dim (block by block for GEGLU's projection and the fused qkv), a
    copy of its own with no gradient, so the whole tree can be freed; other
    leaves as they are."""
    tp = of_mesh(mesh)
    if tp is None:
        return params

    def local(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        return local_part(leaf, split_of(path, tuple(leaf.shape), tp.size), tp)

    with torch.no_grad():
        return _map_with_path(local, params)


def gather_params(params, mesh, specs):
    """The inverse of shard_params: the whole tree from every tp rank's
    local tree (each rank gets it). specs: param_specs of the whole tree at
    the mesh's tp (a local shape alone does not tell a shard of a 512-wide
    conv from a whole 256-wide one)."""
    tp = of_mesh(mesh)
    if tp is None:
        return params
    flat = {}
    _map_with_path(lambda path, spec: flat.__setitem__(path, spec), specs)

    def whole(path, leaf):
        d = _split_dim(flat.get(path, ()))
        if not torch.is_tensor(leaf) or d is None:
            return leaf
        return gather_from_tp(leaf, tp, d, _blocks(path))

    return _map_with_path(whole, params)


def shard_batch(x, mesh):
    """This dp rank's rows of x (dim 0), dp_rank·B/dp .. (dp_rank+1)·B/dp;
    B must be a multiple of dp. x as it is without a mesh or at dp = 1."""
    if x is None or mesh is None or mesh.dp == 1:
        return x
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch {b} is not divisible by dp={mesh.dp}")
    n = b // mesh.dp
    return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def gather_batch(x, mesh):
    """The inverse of shard_batch: every dp rank's rows, in rank order, on
    every rank (an all-gather over the dp group; no gradient)."""
    if mesh is None or mesh.dp == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts, dim=0)
