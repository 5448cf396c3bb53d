"""Reader and writer of the reference's npy dump-tree weight format (port
of sdtpu/io/npy_tree.py).

Schema (the reference's src/model/load.rs:17-28 and python/save.py):
- every tensor is a 1-D float32 .npy whose first D entries are the dims
  and the rest the row-major values; the reader must know D per call site
- scalars are stored as [1.0, value] (python/save.py:6-8)
- linear weights are stored pre-transposed to [in, out] (save.py:19)
- conv weights keep torch's OIHW layout; stride/padding/dilation/groups/
  kernel_size/n_channels_* are stored as sibling tensors (save.py:52-68)
- the VAE encoder downsampler is a "padded conv": a conv/ subdir plus
  channels/kernel_size/stride/padding meta (save.py:70-94)

Directory names per model follow the reference's {clip,unet,autoencoder}/
load.rs, as sdtpu's do. The in-memory layout is sdtpu's (linear [in, out]
as stored, conv transposed to HWIO at load), the spec tables the port's own
(sdtpu_torch/models/unet.py).

The reader returns a tree of numpy arrays on the host
(`weights.from_numpy_tree` puts it on a device); each file is read once by
np.load, with no copy through a buffer. sdtpu first reads the whole tree
with its native bulk reader when that is built; the port reads file by
file. The writer takes numpy or torch leaves (any device, any floating
type) and writes float32, so each package reads the other's trees.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from sdtpu_torch.config import SD_V1_4, StableDiffusionConfig
from sdtpu_torch.models.unet import build_input_specs, build_output_specs
from sdtpu_torch.weights import to_numpy


# ----------------------------------------------------------- primitives

def _read(path: str, rank: int) -> np.ndarray:
    v = np.load(path)
    dims = v[:rank].astype(np.int64)
    return v[rank:].reshape(tuple(dims)).astype(np.float32, copy=False)


def load_tensor(dirpath: str, name: str, rank: int) -> np.ndarray:
    return _read(os.path.join(dirpath, f"{name}.npy"), rank)


def try_load_tensor(dirpath: str, name: str, rank: int) -> Optional[np.ndarray]:
    p = os.path.join(dirpath, f"{name}.npy")
    return _read(p, rank) if os.path.exists(p) else None


def load_scalar(dirpath: str, name: str) -> float:
    return float(np.load(os.path.join(dirpath, f"{name}.npy"))[1])


def load_linear(d: str) -> Dict[str, np.ndarray]:
    p = {"w": load_tensor(d, "weight", 2)}  # already [in, out] (save.py:19)
    b = try_load_tensor(d, "bias", 1)
    if b is not None:
        p["b"] = b
    return p


def load_conv2d(d: str) -> Dict[str, np.ndarray]:
    w = load_tensor(d, "weight", 4)  # OIHW
    p = {"w": np.transpose(w, (2, 3, 1, 0))}  # -> HWIO
    b = try_load_tensor(d, "bias", 1)
    if b is not None:
        p["b"] = b
    return p


def load_norm(d: str, n_channel: Optional[int] = None) -> Dict[str, np.ndarray]:
    g = try_load_tensor(d, "weight", 1)
    b = try_load_tensor(d, "bias", 1)
    if g is None or b is None:
        # affine params are optional in the dump (groupnorm/load.rs:21-28)
        # but only when the channel count is recoverable
        if n_channel is None:
            n_channel = int(load_scalar(d, "n_channel"))
        g = np.ones(n_channel, np.float32) if g is None else g
        b = np.zeros(n_channel, np.float32) if b is None else b
    return {"g": g, "b": b}


# ----------------------------------------------------------- CLIP

def _load_clip(path: str) -> dict:
    n_layer = int(load_scalar(path, "n_layer"))
    blocks = []
    for i in range(n_layer):
        bp = os.path.join(path, "blocks", str(i))
        blocks.append(
            {
                "attn": {
                    "query": load_linear(os.path.join(bp, "attn", "query")),
                    "key": load_linear(os.path.join(bp, "attn", "key")),
                    "value": load_linear(os.path.join(bp, "attn", "value")),
                    "out": load_linear(os.path.join(bp, "attn", "out")),
                },
                "attn_ln": load_norm(os.path.join(bp, "attn_ln")),
                "mlp": {
                    "fc1": load_linear(os.path.join(bp, "mlp", "fc1")),
                    "fc2": load_linear(os.path.join(bp, "mlp", "fc2")),
                },
                "mlp_ln": load_norm(os.path.join(bp, "mlp_ln")),
            }
        )
    return {
        "token_embedding": {"w": load_tensor(os.path.join(path, "token_embedding"), "weight", 2)},
        "position_embedding": load_tensor(os.path.join(path, "position_embedding"), "weight", 2),
        "blocks": blocks,
        "layer_norm": load_norm(os.path.join(path, "layer_norm")),
    }


# ----------------------------------------------------------- UNet

def _load_res_block(d: str) -> dict:
    p = {
        "norm_in": load_norm(os.path.join(d, "norm_in")),
        "conv_in": load_conv2d(os.path.join(d, "conv_in")),
        "lin_embed": load_linear(os.path.join(d, "lin_embed")),
        "norm_out": load_norm(os.path.join(d, "norm_out")),
        "conv_out": load_conv2d(os.path.join(d, "conv_out")),
    }
    if os.path.isdir(os.path.join(d, "skip_connection")):
        p["skip_connection"] = load_conv2d(os.path.join(d, "skip_connection"))
    return p


def _load_mha(d: str) -> dict:
    return {
        "query": load_linear(os.path.join(d, "query")),
        "key": load_linear(os.path.join(d, "key")),
        "value": load_linear(os.path.join(d, "value")),
        "out": load_linear(os.path.join(d, "out")),
    }


def _load_spatial_transformer(d: str) -> dict:
    t = os.path.join(d, "transformer")
    return {
        "norm": load_norm(os.path.join(d, "norm")),
        "proj_in": load_conv2d(os.path.join(d, "proj_in")),
        "transformer": {
            "norm1": load_norm(os.path.join(t, "norm1")),
            "attn1": _load_mha(os.path.join(t, "attn1")),
            "norm2": load_norm(os.path.join(t, "norm2")),
            "attn2": _load_mha(os.path.join(t, "attn2")),
            "norm3": load_norm(os.path.join(t, "norm3")),
            "mlp": {
                "geglu": {"proj": load_linear(os.path.join(t, "mlp", "geglu", "proj"))},
                "lin": load_linear(os.path.join(t, "mlp", "lin")),
            },
        },
        "proj_out": load_conv2d(os.path.join(d, "proj_out")),
    }


def _load_unet_block(d: str, spec) -> dict:
    """Dispatch on BlockSpec kind, mirroring unet/load.rs:213-279."""
    if spec.kind in ("conv", "down"):
        return load_conv2d(d)
    p = {}
    if spec.transformer or spec.upsample:
        p["res"] = _load_res_block(os.path.join(d, "res"))
    else:
        p = _load_res_block(d)
    if spec.transformer:
        p["transformer"] = _load_spatial_transformer(os.path.join(d, "transformer"))
    if spec.upsample:
        p["upsample"] = {"conv": load_conv2d(os.path.join(d, "upsample", "conv"))}
    return p


def _load_unet(path: str, cfg: StableDiffusionConfig) -> dict:
    ib = os.path.join(path, "input_blocks")
    ob = os.path.join(path, "output_blocks")
    mid = os.path.join(path, "middle_block")
    in_specs = build_input_specs(cfg.unet)
    out_specs, _ = build_output_specs(cfg.unet)
    return {
        "lin1_time_embed": load_linear(os.path.join(path, "lin1_time_embed")),
        "lin2_time_embed": load_linear(os.path.join(path, "lin2_time_embed")),
        "input_blocks": {
            s.name: _load_unet_block(os.path.join(ib, s.name), s) for s in in_specs
        },
        "middle_block": {
            "res1": _load_res_block(os.path.join(mid, "res1")),
            "transformer": _load_spatial_transformer(os.path.join(mid, "transformer")),
            "res2": _load_res_block(os.path.join(mid, "res2")),
        },
        "output_blocks": {
            s.name: _load_unet_block(os.path.join(ob, s.name), s) for s in out_specs
        },
        "norm_out": load_norm(os.path.join(path, "norm_out")),
        "conv_out": load_conv2d(os.path.join(path, "conv_out")),
    }


# ----------------------------------------------------------- VAE

def _load_resnet(d: str) -> dict:
    p = {
        "norm1": load_norm(os.path.join(d, "norm1")),
        "conv1": load_conv2d(os.path.join(d, "conv1")),
        "norm2": load_norm(os.path.join(d, "norm2")),
        "conv2": load_conv2d(os.path.join(d, "conv2")),
    }
    if os.path.isdir(os.path.join(d, "nin_shortcut")):
        p["nin_shortcut"] = load_conv2d(os.path.join(d, "nin_shortcut"))
    return p


def _load_mid(d: str) -> dict:
    a = os.path.join(d, "attn")
    return {
        "block_1": _load_resnet(os.path.join(d, "block_1")),
        "attn": {
            "norm": load_norm(os.path.join(a, "norm")),
            "q": load_conv2d(os.path.join(a, "q")),
            "k": load_conv2d(os.path.join(a, "k")),
            "v": load_conv2d(os.path.join(a, "v")),
            "proj_out": load_conv2d(os.path.join(a, "proj_out")),
        },
        "block_2": _load_resnet(os.path.join(d, "block_2")),
    }


def _load_autoencoder(path: str) -> dict:
    enc = os.path.join(path, "encoder")
    dec = os.path.join(path, "decoder")

    enc_blocks = []
    for i in range(int(load_scalar(enc, "n_block"))):
        bd = os.path.join(enc, "blocks", str(i))
        blk = {
            "res1": _load_resnet(os.path.join(bd, "res1")),
            "res2": _load_resnet(os.path.join(bd, "res2")),
        }
        ds = os.path.join(bd, "downsampler")
        if os.path.isdir(ds):
            blk["downsampler"] = {"conv": load_conv2d(os.path.join(ds, "conv"))}
        enc_blocks.append(blk)

    dec_blocks = []
    for i in range(int(load_scalar(dec, "n_block"))):
        bd = os.path.join(dec, "blocks", str(i))
        blk = {
            "res1": _load_resnet(os.path.join(bd, "res1")),
            "res2": _load_resnet(os.path.join(bd, "res2")),
            "res3": _load_resnet(os.path.join(bd, "res3")),
        }
        us = os.path.join(bd, "upsampler")
        if os.path.isdir(us):
            blk["upsampler"] = load_conv2d(us)
        dec_blocks.append(blk)

    return {
        "encoder": {
            "conv_in": load_conv2d(os.path.join(enc, "conv_in")),
            "blocks": enc_blocks,
            "mid": _load_mid(os.path.join(enc, "mid")),
            "norm_out": load_norm(os.path.join(enc, "norm_out")),
            "conv_out": load_conv2d(os.path.join(enc, "conv_out")),
        },
        "decoder": {
            "conv_in": load_conv2d(os.path.join(dec, "conv_in")),
            "mid": _load_mid(os.path.join(dec, "mid")),
            "blocks": dec_blocks,
            "norm_out": load_norm(os.path.join(dec, "norm_out")),
            "conv_out": load_conv2d(os.path.join(dec, "conv_out")),
        },
        "quant_conv": load_conv2d(os.path.join(path, "quant_conv")),
        "post_quant_conv": load_conv2d(os.path.join(path, "post_quant_conv")),
    }


# ----------------------------------------------------------- top level

def load_stable_diffusion_dump(path: str, cfg: StableDiffusionConfig = SD_V1_4) -> dict:
    """Load the full dump tree (reference: stablediffusion/load.rs:16-33)
    as numpy arrays on the host."""
    return {
        "n_steps": int(load_scalar(path, "n_steps")),
        "alphas_cumprod": load_tensor(path, "alphas_cumprod", 1),
        "autoencoder": _load_autoencoder(os.path.join(path, "autoencoder")),
        "unet": _load_unet(os.path.join(path, "unet"), cfg),
        "clip": _load_clip(os.path.join(path, "clip")),
    }


# =============================================================== writer

def _f32(leaf) -> np.ndarray:
    return to_numpy(leaf).astype(np.float32, copy=False)


def _save_tensor(d: str, name: str, arr: np.ndarray) -> None:
    os.makedirs(d, exist_ok=True)
    a = _f32(arr)
    np.save(os.path.join(d, f"{name}.npy"),
            np.concatenate([np.asarray(a.shape, np.float32), a.reshape(-1)]))


def _save_scalar(d: str, name: str, v: float) -> None:
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, f"{name}.npy"), np.asarray([1.0, float(v)], np.float32))


def _save_linear(d: str, p) -> None:
    _save_tensor(d, "weight", p["w"])
    if "b" in p:
        _save_tensor(d, "bias", p["b"])


def _save_conv2d(d: str, p, stride=1, padding=(1, 1)) -> None:
    w = np.transpose(_f32(p["w"]), (3, 2, 0, 1))  # HWIO -> OIHW
    _save_tensor(d, "weight", w)
    if "b" in p:
        _save_tensor(d, "bias", p["b"])
    kh, kw = w.shape[2], w.shape[3]
    _save_tensor(d, "stride", np.asarray([stride, stride]))
    _save_tensor(d, "padding", np.asarray(list(padding)))
    _save_tensor(d, "dilation", np.asarray([1, 1]))
    _save_scalar(d, "n_group", 1)
    _save_tensor(d, "kernel_size", np.asarray([kh, kw]))
    _save_scalar(d, "n_channels_in", w.shape[1])
    _save_scalar(d, "n_channels_out", w.shape[0])


def _save_norm(d: str, p, n_group=32, eps=1e-5, group=True) -> None:
    _save_tensor(d, "weight", p["g"])
    _save_tensor(d, "bias", p["b"])
    _save_scalar(d, "eps", eps)
    if group:
        _save_scalar(d, "n_group", n_group)
        _save_scalar(d, "n_channel", p["g"].shape[0])


def _save_mha(d: str, p, n_head: int) -> None:
    _save_scalar(d, "n_head", n_head)
    for k in ("query", "key", "value", "out"):
        _save_linear(os.path.join(d, k), p[k])


def _save_res_block(d: str, p, gn, eps) -> None:
    _save_norm(os.path.join(d, "norm_in"), p["norm_in"], gn, eps)
    _save_conv2d(os.path.join(d, "conv_in"), p["conv_in"])
    _save_linear(os.path.join(d, "lin_embed"), p["lin_embed"])
    _save_norm(os.path.join(d, "norm_out"), p["norm_out"], gn, eps)
    _save_conv2d(os.path.join(d, "conv_out"), p["conv_out"])
    if "skip_connection" in p:
        _save_conv2d(os.path.join(d, "skip_connection"), p["skip_connection"], padding=(0, 0))


def _save_spatial_transformer(d: str, p, n_head, gn, eps) -> None:
    t = os.path.join(d, "transformer")
    _save_norm(os.path.join(d, "norm"), p["norm"], gn, eps)
    _save_conv2d(os.path.join(d, "proj_in"), p["proj_in"], padding=(0, 0))
    tp = p["transformer"]
    for n in ("norm1", "norm2", "norm3"):
        _save_norm(os.path.join(t, n), tp[n], group=False, eps=eps)
    _save_mha(os.path.join(t, "attn1"), tp["attn1"], n_head)
    _save_mha(os.path.join(t, "attn2"), tp["attn2"], n_head)
    _save_linear(os.path.join(t, "mlp", "geglu", "proj"), tp["mlp"]["geglu"]["proj"])
    _save_linear(os.path.join(t, "mlp", "lin"), tp["mlp"]["lin"])
    _save_conv2d(os.path.join(d, "proj_out"), p["proj_out"], padding=(0, 0))


def _save_resnet(d: str, p, gn, eps) -> None:
    _save_norm(os.path.join(d, "norm1"), p["norm1"], gn, eps)
    _save_conv2d(os.path.join(d, "conv1"), p["conv1"])
    _save_norm(os.path.join(d, "norm2"), p["norm2"], gn, eps)
    _save_conv2d(os.path.join(d, "conv2"), p["conv2"])
    if "nin_shortcut" in p:
        _save_conv2d(os.path.join(d, "nin_shortcut"), p["nin_shortcut"], padding=(0, 0))


def _save_mid(d: str, p, gn, eps) -> None:
    _save_resnet(os.path.join(d, "block_1"), p["block_1"], gn, eps)
    a = os.path.join(d, "attn")
    _save_norm(os.path.join(a, "norm"), p["attn"]["norm"], gn, eps)
    for k in ("q", "k", "v", "proj_out"):
        _save_conv2d(os.path.join(a, k), p["attn"][k], padding=(0, 0))
    _save_resnet(os.path.join(d, "block_2"), p["block_2"], gn, eps)


def save_stable_diffusion_dump(params, path: str, cfg: StableDiffusionConfig = SD_V1_4) -> None:
    """Emit a dump tree the reference Rust loaders can read."""
    os.makedirs(path, exist_ok=True)
    _save_scalar(path, "n_steps", params.get("n_steps", cfg.n_train_steps))
    _save_tensor(path, "alphas_cumprod", params["alphas_cumprod"])

    # clip
    cp = os.path.join(path, "clip")
    clip = params["clip"]
    _save_tensor(os.path.join(cp, "token_embedding"), "weight", clip["token_embedding"]["w"])
    _save_tensor(os.path.join(cp, "position_embedding"), "weight", clip["position_embedding"])
    _save_scalar(cp, "n_layer", len(clip["blocks"]))
    for i, bp in enumerate(clip["blocks"]):
        bd = os.path.join(cp, "blocks", str(i))
        _save_mha(os.path.join(bd, "attn"), bp["attn"], cfg.clip.n_head)
        _save_norm(os.path.join(bd, "attn_ln"), bp["attn_ln"], group=False, eps=cfg.clip.layer_norm_eps)
        _save_linear(os.path.join(bd, "mlp", "fc1"), bp["mlp"]["fc1"])
        _save_linear(os.path.join(bd, "mlp", "fc2"), bp["mlp"]["fc2"])
        _save_norm(os.path.join(bd, "mlp_ln"), bp["mlp_ln"], group=False, eps=cfg.clip.layer_norm_eps)
    _save_norm(os.path.join(cp, "layer_norm"), clip["layer_norm"], group=False,
               eps=cfg.clip.layer_norm_eps)

    # unet
    up = os.path.join(path, "unet")
    unet = params["unet"]
    gn, eps = cfg.unet.groupnorm_groups, cfg.unet.groupnorm_eps
    _save_linear(os.path.join(up, "lin1_time_embed"), unet["lin1_time_embed"])
    _save_linear(os.path.join(up, "lin2_time_embed"), unet["lin2_time_embed"])

    def save_block(d, p, spec):
        if spec.kind == "conv":
            _save_conv2d(d, p)
            return
        if spec.kind == "down":
            _save_conv2d(d, p, stride=2)
            return
        res = p["res"] if (spec.transformer or spec.upsample) else p
        res_dir = os.path.join(d, "res") if (spec.transformer or spec.upsample) else d
        _save_res_block(res_dir, res, gn, eps)
        if spec.transformer:
            _save_spatial_transformer(os.path.join(d, "transformer"), p["transformer"],
                                      spec.n_head, gn, eps)
        if spec.upsample:
            _save_conv2d(os.path.join(d, "upsample", "conv"), p["upsample"]["conv"])

    for s in build_input_specs(cfg.unet):
        save_block(os.path.join(up, "input_blocks", s.name), unet["input_blocks"][s.name], s)
    mb = os.path.join(up, "middle_block")
    mid_heads = cfg.unet.heads_for(build_input_specs(cfg.unet)[-1].c_out)
    _save_res_block(os.path.join(mb, "res1"), unet["middle_block"]["res1"], gn, eps)
    _save_spatial_transformer(os.path.join(mb, "transformer"), unet["middle_block"]["transformer"],
                              mid_heads, gn, eps)
    _save_res_block(os.path.join(mb, "res2"), unet["middle_block"]["res2"], gn, eps)
    out_specs, _ = build_output_specs(cfg.unet)
    for s in out_specs:
        save_block(os.path.join(up, "output_blocks", s.name), unet["output_blocks"][s.name], s)
    _save_norm(os.path.join(up, "norm_out"), unet["norm_out"], gn, eps)
    _save_conv2d(os.path.join(up, "conv_out"), unet["conv_out"])

    # autoencoder
    ap = os.path.join(path, "autoencoder")
    vae = params["autoencoder"]
    gn, eps = cfg.vae.groupnorm_groups, cfg.vae.groupnorm_eps
    enc, dec = vae["encoder"], vae["decoder"]
    e = os.path.join(ap, "encoder")
    _save_conv2d(os.path.join(e, "conv_in"), enc["conv_in"])
    _save_scalar(e, "n_block", len(enc["blocks"]))
    for i, blk in enumerate(enc["blocks"]):
        bd = os.path.join(e, "blocks", str(i))
        _save_resnet(os.path.join(bd, "res1"), blk["res1"], gn, eps)
        _save_resnet(os.path.join(bd, "res2"), blk["res2"], gn, eps)
        if "downsampler" in blk:
            ds = os.path.join(bd, "downsampler")
            _save_conv2d(os.path.join(ds, "conv"), blk["downsampler"]["conv"],
                         stride=2, padding=(0, 0))
            w = blk["downsampler"]["conv"]["w"]
            _save_tensor(ds, "channels", np.asarray([w.shape[2], w.shape[3]]))
            _save_scalar(ds, "kernel_size", w.shape[0])
            _save_scalar(ds, "stride", 2)
            _save_tensor(ds, "padding", np.asarray([0, 1, 0, 1]))
    _save_mid(os.path.join(e, "mid"), enc["mid"], gn, eps)
    _save_norm(os.path.join(e, "norm_out"), enc["norm_out"], gn, eps)
    _save_conv2d(os.path.join(e, "conv_out"), enc["conv_out"])

    d = os.path.join(ap, "decoder")
    _save_conv2d(os.path.join(d, "conv_in"), dec["conv_in"])
    _save_mid(os.path.join(d, "mid"), dec["mid"], gn, eps)
    _save_scalar(d, "n_block", len(dec["blocks"]))
    for i, blk in enumerate(dec["blocks"]):
        bd = os.path.join(d, "blocks", str(i))
        _save_resnet(os.path.join(bd, "res1"), blk["res1"], gn, eps)
        _save_resnet(os.path.join(bd, "res2"), blk["res2"], gn, eps)
        _save_resnet(os.path.join(bd, "res3"), blk["res3"], gn, eps)
        if "upsampler" in blk:
            _save_conv2d(os.path.join(bd, "upsampler"), blk["upsampler"])
    _save_norm(os.path.join(d, "norm_out"), dec["norm_out"], gn, eps)
    _save_conv2d(os.path.join(d, "conv_out"), dec["conv_out"])

    _save_conv2d(os.path.join(ap, "quant_conv"), vae["quant_conv"], padding=(0, 0))
    _save_conv2d(os.path.join(ap, "post_quant_conv"), vae["post_quant_conv"], padding=(0, 0))
