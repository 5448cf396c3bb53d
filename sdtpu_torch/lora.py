"""LoRA adapters: training and inference (port of sdtpu/lora.py).

An adapter is a second tree mirroring the UNet's attention linears: for
each adapted linear {"a": [in, rank], "b": [rank, out]}. apply_lora
merges it functionally, w_eff = w + (a @ b) * scale in f32, cast back to
w's dtype; every other leaf is passed through by reference. The train step
differentiates through that merge with respect to the adapter only: the
base tree is frozen and shared, and the optimizer state covers the
adapter (MBs where a full fine-tune's AdamW keeps 6.9 GB). List positions
of the parameter tree are string indices in the adapter ("3"), so a sparse
adapter survives the '/'-flattened file without io.native's
digit-keys-to-list coercion.

Files are sdtpu's: safetensors with format=sdtpu-lora, rank and alpha in
the metadata (scale = alpha / rank), read and written by the port's own
safetensors code (io/native.py), so each package reads the other's.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Any, Dict, Tuple

import torch

from sdtpu_torch.io.native import flatten_tree, load_safetensors, save_safetensors
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.sharding import split_of
from sdtpu_torch.training import (diffusion_loss, dp_mean, ema_update, micro_batch_grads,
                                  refuse_graphs_on_mesh, run_step, step_inputs, tree_leaves)

# the standard recipe: the attention projections, self- and cross-attention
# query/key/value/out (models/unet.py:_init_cross_attn)
DEFAULT_TARGETS = ("query", "key", "value", "out")


def init_lora(generator: torch.Generator, params, rank: int = 8, targets=DEFAULT_TARGETS):
    """An adapter tree for every 2-D linear named in `targets`, in the
    order sdtpu's init_lora walks the tree: a ~ N(0, 1) / sqrt(rank), drawn
    from `generator` on its device, b = 0 (the adapter starts as an exact
    no-op), f32 on the weight's device. sdtpu's tree, without the fused
    attn1.qkv leaves (models/unet.py:unfuse_qkv), gives sdtpu's targets."""
    def rec(node, name):
        if isinstance(node, dict):
            w = node.get("w")
            if name in targets and torch.is_tensor(w) and w.ndim == 2:
                n_in, n_out = w.shape
                a = torch.randn((n_in, rank), generator=generator, device=generator.device)
                return {"a": (a / math.sqrt(rank)).to(w.device),
                        "b": torch.zeros((rank, n_out), device=w.device)}
            sub = {k: rec(v, k) for k, v in node.items()}
            return {k: v for k, v in sub.items() if v is not None} or None
        if isinstance(node, (list, tuple)):
            sub = {str(i): rec(v, name) for i, v in enumerate(node)}
            return {k: v for k, v in sub.items() if v is not None} or None
        return None

    lora = rec(params, "")
    if not lora:
        raise ValueError(f"no {targets} linears found to adapt")
    return lora


def lora_param_count(lora) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(lora))


def make_lora_train_step(cfg, optimizer, scale: float, compute_dtype=torch.float32,
                         remat: bool | str = False, accum: int = 1, accum_dtype=None,
                         mesh=None, ema_decay=None, graphs=None):
    """train_step(lora, opt_state, base, batch, generator=None, *, t=None,
    noise=None) -> (lora, opt_state, loss), sdtpu's make_lora_train_step.
    lora: the adapter, f32 leaves that require grad (training.master_params),
    updated in place; base: the frozen UNet tree (sdtpu's, unfused), which
    no step copies or changes. Only the adapter gets gradients. Under a
    bf16 compute dtype the merged weights are cast to bf16, as sdtpu's
    eff_dtype does. batch, t, noise, accum and mesh as in
    training.make_train_step: on a mesh the adapter and its state are
    whole on every rank (sdtpu does not shard them), the base is this
    rank's tp parts (parallel.shard_params), and each adapted part gets its
    part of a @ b (apply_lora), so the gradients of a and b come back
    whole.

    ema_decay set: train_step(lora, opt_state, ema, base, batch, ...) ->
    (lora, opt_state, ema, loss), the adapter's EMA updated in place as
    the step's last op. graphs: as training.make_train_step's (the body,
    the merge of a·b into the base included, one CUDA graph a key)."""
    refuse_graphs_on_mesh(graphs, mesh)
    eff_dtype = None if compute_dtype == torch.float32 else compute_dtype
    tp = tpc.of_mesh(mesh)
    statics = {"config": cfg, "optimizer": optimizer.flags(), "scale": scale, "accum": accum,
               "accum_dtype": accum_dtype, "remat": remat, "compute_dtype": compute_dtype,
               "ema_decay": ema_decay}

    def body(lora, opt_state, ema, base, inp):
        latents, context, t, noise = (inp[k] for k in ("latents", "context", "t", "noise"))
        ctx_valid = inp.get("ctx_valid")

        def loss_of(sl):
            with tpc.use(tp):
                p = apply_lora(base, lora, scale, dtype=eff_dtype)
                return diffusion_loss(p, cfg, latents[sl], context[sl], t[sl], noise[sl],
                                      None if ctx_valid is None else ctx_valid[sl],
                                      compute_dtype=compute_dtype, remat=remat)

        loss, grads = dp_mean(*micro_batch_grads(loss_of, tree_leaves(lora), latents.shape[0],
                                                 accum, accum_dtype), mesh)
        optimizer.apply(lora, grads, opt_state)
        del grads
        if ema is not None:
            ema_update(ema, lora, ema_decay)
        return loss

    def step(lora, opt_state, ema, base, batch, generator, t, noise):
        inputs = step_inputs(cfg, batch, ("latents", "context", "ctx_valid"), generator, t,
                             noise, mesh)
        optimizer.stage(opt_state)
        trees = (lora, opt_state.tensors(), base) + (() if ema is None else (ema,))
        return run_step(graphs, "lora", statics, inputs,
                        functools.partial(body, lora, opt_state, ema, base), trees)

    if ema_decay is None:
        def train_step(lora, opt_state, base, batch, generator=None, *, t=None, noise=None):
            return lora, opt_state, step(lora, opt_state, None, base, batch, generator, t,
                                         noise)

        return train_step

    def train_step_ema(lora, opt_state, ema, base, batch, generator=None, *, t=None,
                       noise=None):
        return lora, opt_state, ema, step(lora, opt_state, ema, base, batch, generator, t,
                                          noise)

    return train_step_ema


def _part(delta, w, path: str):
    """This tp rank's part of the whole product delta, where w is the
    adapted linear at `path` as the rank holds it (parallel.tp.current()'s
    group): the part the sharding rule gives that leaf (sharding.split_of,
    GEGLU's [value | gate] block by block), through scatter_to_tp, whose
    backward gathers the whole gradient. delta itself where the leaf is
    whole."""
    tp = tpc.current()
    split = None if tp is None else split_of(path, tuple(delta.shape), tp.size)
    if split is not None:
        delta = tpc.scatter_to_tp(delta, tp, split.dim, split.blocks)
    if delta.shape != w.shape:
        raise ValueError(f"an adapter of {path} gives {tuple(delta.shape)}, the weight is "
                         f"{tuple(w.shape)}" + ("" if tp is None else f" at tp={tp.size}"))
    return delta


def apply_lora(params, lora, scale: float, dtype=None):
    """Effective params: each adapted w -> w + (a @ b) * scale, computed in
    f32 on w's device and cast to `dtype` (default: w's dtype). Every other
    leaf is the given one, by reference. Inside a tp group (parallel.tp.use)
    params are this rank's tp parts of sdtpu's unfused tree: a part adds
    the part of the product that the sharding rule gives its path (_part)."""

    def rec(p, l, path):
        if l is None:
            return p
        if isinstance(p, dict):
            if "a" in l and "w" in p:
                w = p["w"]
                a, b = (torch.as_tensor(l[k]).to(w.device, torch.float32) for k in ("a", "b"))
                new = dict(p)
                new["w"] = (w.float() + _part((a @ b) * scale, w, f"{path}/w")).to(
                    dtype or w.dtype)
                return new
            return {k: rec(v, l.get(k), f"{path}/{k}" if path else str(k))
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(rec(v, l.get(str(i)), f"{path}/{i}" if path else str(i))
                           for i, v in enumerate(p))
        return p

    return rec(params, lora, "")


def _unflatten(flat: Dict[str, torch.Tensor]) -> Any:
    # no digit-keys-to-list coercion: adapters are sparse
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def save_lora(lora, path: str, rank: int, alpha: float, config_name: str = "") -> None:
    flat = {k: torch.as_tensor(v) for k, v in flatten_tree(lora).items()}
    save_safetensors(flat, path, {"format": "sdtpu-lora", "rank": str(int(rank)),
                                  "alpha": str(float(alpha)), "config": config_name})


def load_lora(path: str, device="cpu") -> Tuple[Any, float, Dict[str, str]]:
    """-> (adapter tree of tensors on `device`, scale = alpha / rank, metadata)."""
    flat, meta = load_safetensors(path, device)
    if meta.get("format") != "sdtpu-lora":
        raise ValueError(f"{path}: not an sdtpu LoRA file "
                         f"(metadata {json.dumps(meta)[:120]})")
    return _unflatten(flat), float(meta["alpha"]) / float(meta["rank"]), meta
