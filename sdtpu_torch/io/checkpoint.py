"""Train-state save and resume (counterpart of sdtpu/io/checkpoint.py):
the trained tree, the optimizer state, the step and the EMA shadow, saved
at optimizer-step boundaries and restored by `finetune --resume`.

sdtpu writes an orbax PyTree checkpoint. The port writes a directory of its
own, which needs no orbax:

    train_state.json             {"format", "file", "step", "opt_count", "flags"}
    state-<step>.safetensors     every tensor, by '/'-flattened key:
                                 params/..., opt_state/<field>/<leaf>, ema/...

through its own safetensors writer (io/native.py). "flags" are the
run's options that decide what the state holds (optimizer, accumulation,
LoRA rank and alpha, EMA); a resume under others is refused. A save is
atomic: the tensor file is written under a temporary name and renamed,
then the JSON is replaced by a rename, and only then are older tensor
files (and any temporary file of a save that broke off) removed; a save
that breaks off leaves the previous state readable.
A directory without train_state.json (an orbax state among them) is
refused with an error that names what it holds.

A state whose optimizer state has a tp layout (training.py: the trained
tree, the state and the EMA held as tp parts) is saved whole: every rank
of the tp group calls save_train_state, each sharded tensor is gathered
leaf by leaf, and the rank told to write writes the file one process
writes. A resume takes each rank's part of the whole tensors by the same
rule, so a state saved at one tp resumes at any other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from sdtpu_torch.io.native import flatten_tree, load_safetensors, save_safetensors
from sdtpu_torch.parallel.sharding import gather_part, local_part

FORMAT = "sdtpu_torch-train-state-v1"
STATE_JSON = "train_state.json"
# what an orbax checkpoint directory holds at its top level
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding")


def _tensors(params, opt_state, ema) -> Dict[str, torch.Tensor]:
    """{key: tensor} of a train state: the trees' leaves under params/ and
    ema/, each list field of the optimizer's state dataclass under
    opt_state/<field>/<leaf index> (absent entries skipped)."""
    out = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    for f in dataclasses.fields(opt_state):
        value = getattr(opt_state, f.name)
        if isinstance(value, list):
            out.update({f"opt_state/{f.name}/{i}": t for i, t in enumerate(value)
                        if t is not None})
    if ema is not None:
        out.update({f"ema/{k}": v for k, v in flatten_tree(ema).items()})
    return out


def _splits(params, opt_state, ema) -> Dict[str, Any]:
    """{key: Split or None} of _tensors' keys under the state's layout."""
    layout = opt_state.layout
    tree = dict(zip(flatten_tree(params), layout.splits))
    out = {f"params/{k}": s for k, s in tree.items()}
    for name, parts in opt_state.splits().items():
        out.update({f"opt_state/{name}/{i}": s for i, s in enumerate(parts)})
    if ema is not None:
        out.update({f"ema/{k}": s for k, s in tree.items()})
    return out


def _fsync_replace(tmp: str, final: str) -> None:
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)


def save_train_state(path: str, params, opt_state, step: int, ema: Optional[Any] = None,
                     flags: Optional[Dict[str, Any]] = None, write: bool = True) -> None:
    """Atomic save of the train state under the directory `path` (made if
    missing): params (a tree of tensors), opt_state (training.AdamWState
    or AdafactorState), the number of completed optimizer steps, the EMA
    shadow (a tree like params) when kept, and the run's flags. With a tp
    layout every rank of the tp group calls it and the whole tensors are
    gathered (the module docstring); write=False: this rank takes part in
    the gathers and writes nothing."""
    tensors = _tensors(params, opt_state, ema)
    layout = opt_state.layout
    if layout is not None:
        parts = _splits(params, opt_state, ema)
        if not write:
            for k, t in tensors.items():
                gather_part(t.detach(), parts[k], layout.tp)
            return
        tensors = {k: gather_part(t.detach(), parts[k], layout.tp) for k, t in tensors.items()}
    if not write:
        return
    os.makedirs(path, exist_ok=True)
    name = f"state-{int(step):08d}.safetensors"
    tmp = os.path.join(path, f".{name}.{os.getpid()}.tmp")
    save_safetensors(tensors, tmp, {"format": FORMAT})
    _fsync_replace(tmp, os.path.join(path, name))
    meta = {"format": FORMAT, "file": name, "step": int(step), "opt_count": opt_state.count,
            "opt_state": type(opt_state).__name__, "ema": ema is not None,
            "flags": flags or {}}
    tmp = os.path.join(path, f".{STATE_JSON}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    _fsync_replace(tmp, os.path.join(path, STATE_JSON))
    for old in os.listdir(path):  # older states, and what a broken-off save left
        if (old != name and old.startswith("state-") and old.endswith(".safetensors")
                or old.startswith(".") and old.endswith(".tmp")):
            os.remove(os.path.join(path, old))


def read_meta(path: str) -> dict:
    """The state's train_state.json. A missing directory raises
    FileNotFoundError; a directory without the JSON raises ValueError,
    naming an orbax checkpoint where it sees one."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no train state at {path!r}")
    meta_path = os.path.join(path, STATE_JSON)
    if not os.path.exists(meta_path):
        held = set(os.listdir(path))
        if held & set(_ORBAX_MARKERS):
            raise ValueError(
                f"{path!r} holds an orbax checkpoint (the JAX package's train-state format), "
                f"which this package does not read: it resumes only from its own "
                f"{STATE_JSON} + safetensors state")
        raise ValueError(f"{path!r} holds no {STATE_JSON}: not a train state of this "
                         f"package ({FORMAT})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{meta_path}: format {meta.get('format')!r}, expected {FORMAT!r}")
    return meta


@torch.no_grad()
def restore_train_state(path: str, params, opt_state, ema: Optional[Any] = None,
                        flags: Optional[Dict[str, Any]] = None) -> int:
    """Restore the state saved under `path` into params, opt_state and ema
    (the templates a fresh run builds, in place: each tensor copied into
    the template's, on its device; with a tp layout, this rank's part of
    the saved whole tensor) and return the saved step. flags given:
    they must equal the saved ones. Raises ValueError on other flags, on
    another optimizer, on keys or shapes that differ from the templates'
    (see read_meta for a missing or foreign directory)."""
    meta = read_meta(path)
    if flags is not None and meta["flags"] != flags:
        diff = {k: (meta["flags"].get(k), flags.get(k))
                for k in sorted(set(meta["flags"]) | set(flags))
                if meta["flags"].get(k) != flags.get(k)}
        raise ValueError("the state was saved under other flags: " + ", ".join(
            f"{k}={saved!r} (now {now!r})" for k, (saved, now) in diff.items()))
    if meta["opt_state"] != type(opt_state).__name__ or meta["ema"] != (ema is not None):
        raise ValueError(f"the state holds {meta['opt_state']} (EMA: {meta['ema']}), the run "
                         f"{type(opt_state).__name__} (EMA: {ema is not None})")
    saved, _ = load_safetensors(os.path.join(path, meta["file"]), "cpu")
    want = _tensors(params, opt_state, ema)
    if set(saved) != set(want):
        missing, extra = sorted(set(want) - set(saved)), sorted(set(saved) - set(want))
        raise ValueError(f"the state's tensors differ from the run's: missing {missing[:3]}, "
                         f"unexpected {extra[:3]} ({len(missing)} and {len(extra)})")
    layout = opt_state.layout
    parts = {} if layout is None else _splits(params, opt_state, ema)
    for k, t in want.items():
        got = saved.pop(k)
        if parts.get(k) is not None and (tuple(got.shape)
                                         == parts[k].whole_shape(t.shape, layout.tp.size)):
            got = local_part(got, parts[k], layout.tp)
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(f"{k}: saved {got.dtype} {tuple(got.shape)}, the run's "
                             f"{t.dtype} {tuple(t.shape)}"
                             + ("" if layout is None else f" (a part at tp={layout.tp.size})"))
        t.copy_(got)
    opt_state.count = int(meta["opt_count"])
    return int(meta["step"])
