"""LoRA adapters at inference (port of the inference half of sdtpu/lora.py).

An adapter is a second tree mirroring the UNet's attention linears: for
each adapted linear {"a": [in, rank], "b": [rank, out]}. apply_lora
merges it functionally, w_eff = w + (a @ b) * scale in f32, cast back to
w's dtype; every other leaf is passed through by reference. List positions
of the parameter tree are string indices in the adapter ("3"), so a sparse
adapter survives the '/'-flattened file without io.native's
digit-keys-to-list coercion.

Files are sdtpu's: safetensors with format=sdtpu-lora, rank and alpha in
the metadata (scale = alpha / rank), read and written by the port's own
safetensors code (io/native.py), so each package reads the other's.
Training an adapter is not ported.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import torch

from sdtpu_torch.io.native import flatten_tree, load_safetensors, save_safetensors

# the standard recipe: the attention projections, self- and cross-attention
# query/key/value/out (models/unet.py:_init_cross_attn)
DEFAULT_TARGETS = ("query", "key", "value", "out")


def apply_lora(params, lora, scale: float, dtype=None):
    """Effective params: each adapted w -> w + (a @ b) * scale, computed in
    f32 on w's device and cast to `dtype` (default: w's dtype). Every other
    leaf is the given one, by reference."""

    def rec(p, l):
        if l is None:
            return p
        if isinstance(p, dict):
            if "a" in l and "w" in p:
                w = p["w"]
                a, b = (torch.as_tensor(l[k]).to(w.device, torch.float32) for k in ("a", "b"))
                new = dict(p)
                new["w"] = (w.float() + (a @ b) * scale).to(dtype or w.dtype)
                return new
            return {k: rec(v, l.get(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(rec(v, l.get(str(i))) for i, v in enumerate(p))
        return p

    return rec(params, lora)


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
