"""sdtpu's native model format (port of sdtpu/io/native.py): one
safetensors file with '/'-flattened tree keys and a JSON metadata header.

The safetensors layout is written and read here by hand, since the card's
machine does not promise the `safetensors` package: an 8-byte little-endian
header length, a JSON header mapping each key to its `dtype`, `shape` and
`data_offsets` (plus `__metadata__`, string values only), padded with
spaces to a multiple of 8 bytes, then the raw little-endian bytes of every
tensor back to back (save_safetensors / load_safetensors, which the LoRA
files of sdtpu_torch.lora and the concept files of
sdtpu_torch.textual_inversion use too). The metadata keys are sdtpu's (`format`, `config`,
`config_json`, `scalars`), so each package reads the other's files; the
version field names the port. 0-d leaves (`n_steps`) are kept in the
metadata as scalars, as sdtpu keeps them. bf16 leaves are written as BF16,
which sdtpu's reader (safetensors' numpy backend) cannot read: a model
trained in bf16 compute carries its CLIP and VAE weights in bf16, as sdtpu
saves its own bf16 trees.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict

import numpy as np
import torch

import sdtpu_torch
from sdtpu_torch.config import (PRESETS, SD_V1_4, StableDiffusionConfig, config_from_dict,
                                config_to_dict)

_CODES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
          torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_DTYPES = {code: dt for dt, code in _CODES.items()}


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/0/c": leaf} of a tree of dicts and lists."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """Inverse of flatten_tree: a node whose keys are all digits is a list."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _as_tensor(leaf) -> torch.Tensor:
    if torch.is_tensor(leaf):
        return leaf.detach()
    return torch.from_numpy(np.asarray(leaf))


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Dict[str, str]) -> None:
    """Write {key: tensor} and the string-valued `metadata` (the header's
    __metadata__) as one safetensors file."""
    bad = [f"{k}: {t.dtype}" for k, t in tensors.items() if t.dtype not in _CODES]
    if bad:
        raise TypeError(f"no safetensors code for {', '.join(bad)}")
    # widest elements first, so every tensor starts aligned to its element size
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for k in names:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            t = tensors[k].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def load_safetensors(path: str, device="cpu"):
    """Read a safetensors file -> ({key: tensor on `device`}, the header's
    __metadata__ as a dict of strings, empty when absent)."""
    raw = np.fromfile(path, dtype=np.uint8)
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    header = json.loads(raw[8:8 + n].tobytes())
    meta = header.pop("__metadata__", None) or {}
    data = raw[8 + n:]
    flat = {}
    for k, info in header.items():
        start, end = info["data_offsets"]
        t = torch.empty(info["shape"], dtype=_DTYPES[info["dtype"]])
        t.reshape(-1).view(torch.uint8).numpy()[:] = data[start:end]
        flat[k] = t.to(device)
    return flat, meta


def save_native(params, path: str, config: StableDiffusionConfig = SD_V1_4) -> None:
    """Write a parameter tree (torch tensors, numpy arrays or Python numbers
    as leaves) and its configuration to `path`."""
    tensors, scalars = {}, {}
    for k, leaf in flatten_tree(params).items():
        t = _as_tensor(leaf)
        if t.ndim == 0:  # safetensors stores tensors; scalars go in the metadata
            scalars[k] = float(t)
        else:
            tensors[k] = t
    save_safetensors(tensors, path, {
        "format": "sdtpu-native-v1",
        "sdtpu_torch_version": sdtpu_torch.__version__,
        "config": config.name,
        "config_json": json.dumps(config_to_dict(config)),
        "scalars": json.dumps(scalars),
    })


def load_native(path: str, device="cuda"):
    """Returns (params, config): the tree of tensors on `device` (the card
    unless the caller asks for another), `n_steps` an int."""
    flat, meta = load_safetensors(path, device)
    params = unflatten_tree(flat)
    for k, v in json.loads(meta.get("scalars", "{}")).items():
        parts = k.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    if "n_steps" in params:
        params["n_steps"] = int(params["n_steps"])
    if "config_json" in meta:
        return params, config_from_dict(json.loads(meta["config_json"]))
    name = meta.get("config")
    if name is None:
        raise ValueError(f"{path}: no sdtpu config metadata (not written by save_native?)")
    if name not in PRESETS:
        raise ValueError(f"{path}: unknown config preset {name!r} in the metadata and no "
                         f"config_json (known: {', '.join(sorted(PRESETS))})")
    return params, PRESETS[name]
