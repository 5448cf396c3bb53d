"""A CompVis/LDM torch checkpoint (`sd-v1-4.ckpt`) -> the param tree (port
of sdtpu/io/ckpt.py).

One state_dict key mapping in place of the reference's offline toolchain
(python/dump.py's walk to an .npy tree, then the Rust `convert` binary).
The text tower is CLIP v1 (HF CLIPTextModel keys) or SD v2's OpenCLIP
(cond_stage_model.model.*, its fused in_proj split into q/k/v), told apart
by the keys. Returns numpy arrays on the host (`weights.from_numpy_tree`
puts them on a device).

Layout conversions applied here:
- torch Linear weight [out, in] -> sdtpu [in, out]   (cf. python/save.py:19)
- torch Conv2d weight OIHW      -> sdtpu HWIO
- GroupNorm/LayerNorm weight/bias -> g/b
"""

from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.config import SD_V1_4, StableDiffusionConfig
from sdtpu_torch.diffusion.schedule import scaled_linear_alphas_cumprod
from sdtpu_torch.models.unet import build_input_specs, build_output_specs
from sdtpu_torch.weights import to_numpy


def _t(x) -> np.ndarray:
    return to_numpy(x).astype(np.float32, copy=False)


def _lin(sd, key, bias=True):
    p = {"w": _t(sd[f"{key}.weight"]).T}
    if bias and f"{key}.bias" in sd:
        p["b"] = _t(sd[f"{key}.bias"])
    return p


def _conv(sd, key):
    """A convolution's OIHW weight as HWIO. A 2-D [out, in] weight, the
    linear proj_in/proj_out of SD v2.x (use_linear_in_transformer), is the
    1x1 kernel [1, 1, in, out]: the same tree as the 4-D form."""
    w = _t(sd[f"{key}.weight"])
    if w.ndim == 2:
        w = w[:, :, None, None]
    p = {"w": np.transpose(w, (2, 3, 1, 0))}
    if f"{key}.bias" in sd:
        p["b"] = _t(sd[f"{key}.bias"])
    return p


def _norm(sd, key):
    return {"g": _t(sd[f"{key}.weight"]), "b": _t(sd[f"{key}.bias"])}


# ----------------------------------------------------------- CLIP (v1)

def _convert_clip_v1(sd):
    base = "cond_stage_model.transformer.text_model"
    n_layer = 0
    while f"{base}.encoder.layers.{n_layer}.layer_norm1.weight" in sd:
        n_layer += 1
    blocks = []
    for i in range(n_layer):
        lb = f"{base}.encoder.layers.{i}"
        blocks.append(
            {
                "attn": {
                    "query": _lin(sd, f"{lb}.self_attn.q_proj"),
                    "key": _lin(sd, f"{lb}.self_attn.k_proj"),
                    "value": _lin(sd, f"{lb}.self_attn.v_proj"),
                    "out": _lin(sd, f"{lb}.self_attn.out_proj"),
                },
                "attn_ln": _norm(sd, f"{lb}.layer_norm1"),
                "mlp": {
                    "fc1": _lin(sd, f"{lb}.mlp.fc1"),
                    "fc2": _lin(sd, f"{lb}.mlp.fc2"),
                },
                "mlp_ln": _norm(sd, f"{lb}.layer_norm2"),
            }
        )
    return {
        "token_embedding": {"w": _t(sd[f"{base}.embeddings.token_embedding.weight"])},
        "position_embedding": _t(sd[f"{base}.embeddings.position_embedding.weight"]),
        "blocks": blocks,
        "layer_norm": _norm(sd, f"{base}.final_layer_norm"),
    }


# ----------------------------------------------------------- UNet

def _res_block(sd, key):
    p = {
        "norm_in": _norm(sd, f"{key}.in_layers.0"),
        "conv_in": _conv(sd, f"{key}.in_layers.2"),
        "lin_embed": _lin(sd, f"{key}.emb_layers.1"),
        "norm_out": _norm(sd, f"{key}.out_layers.0"),
        "conv_out": _conv(sd, f"{key}.out_layers.3"),
    }
    if f"{key}.skip_connection.weight" in sd:
        p["skip_connection"] = _conv(sd, f"{key}.skip_connection")
    return p


def _spatial_transformer(sd, key):
    tb = f"{key}.transformer_blocks.0"
    return {
        "norm": _norm(sd, f"{key}.norm"),
        "proj_in": _conv(sd, f"{key}.proj_in"),
        "transformer": {
            "norm1": _norm(sd, f"{tb}.norm1"),
            "attn1": {
                "query": _lin(sd, f"{tb}.attn1.to_q", bias=False),
                "key": _lin(sd, f"{tb}.attn1.to_k", bias=False),
                "value": _lin(sd, f"{tb}.attn1.to_v", bias=False),
                "out": _lin(sd, f"{tb}.attn1.to_out.0"),
            },
            "norm2": _norm(sd, f"{tb}.norm2"),
            "attn2": {
                "query": _lin(sd, f"{tb}.attn2.to_q", bias=False),
                "key": _lin(sd, f"{tb}.attn2.to_k", bias=False),
                "value": _lin(sd, f"{tb}.attn2.to_v", bias=False),
                "out": _lin(sd, f"{tb}.attn2.to_out.0"),
            },
            "norm3": _norm(sd, f"{tb}.norm3"),
            "mlp": {
                "geglu": {"proj": _lin(sd, f"{tb}.ff.net.0.proj")},
                "lin": _lin(sd, f"{tb}.ff.net.2"),
            },
        },
        "proj_out": _conv(sd, f"{key}.proj_out"),
    }


def _convert_unet(sd, cfg: StableDiffusionConfig):
    base = "model.diffusion_model"
    in_specs = build_input_specs(cfg.unet)
    out_specs, _ = build_output_specs(cfg.unet)

    input_blocks = {}
    for idx, spec in enumerate(in_specs):
        kb = f"{base}.input_blocks.{idx}"
        if spec.kind == "conv":
            input_blocks[spec.name] = _conv(sd, f"{kb}.0")
        elif spec.kind == "down":
            input_blocks[spec.name] = _conv(sd, f"{kb}.0.op")
        else:
            p = {}
            res = _res_block(sd, f"{kb}.0")
            if spec.transformer:
                p["res"] = res
                p["transformer"] = _spatial_transformer(sd, f"{kb}.1")
            else:
                p = res
            input_blocks[spec.name] = p

    middle = {
        "res1": _res_block(sd, f"{base}.middle_block.0"),
        "transformer": _spatial_transformer(sd, f"{base}.middle_block.1"),
        "res2": _res_block(sd, f"{base}.middle_block.2"),
    }

    output_blocks = {}
    for idx, spec in enumerate(out_specs):
        kb = f"{base}.output_blocks.{idx}"
        res = _res_block(sd, f"{kb}.0")
        if not spec.transformer and not spec.upsample:
            output_blocks[spec.name] = res
            continue
        p = {"res": res}
        if spec.transformer:
            p["transformer"] = _spatial_transformer(sd, f"{kb}.1")
        if spec.upsample:
            up_idx = 2 if spec.transformer else 1
            p["upsample"] = {"conv": _conv(sd, f"{kb}.{up_idx}.conv")}
        output_blocks[spec.name] = p

    return {
        "lin1_time_embed": _lin(sd, f"{base}.time_embed.0"),
        "lin2_time_embed": _lin(sd, f"{base}.time_embed.2"),
        "input_blocks": input_blocks,
        "middle_block": middle,
        "output_blocks": output_blocks,
        "norm_out": _norm(sd, f"{base}.out.0"),
        "conv_out": _conv(sd, f"{base}.out.2"),
    }


# ----------------------------------------------------------- VAE

def _vae_resnet(sd, key):
    p = {
        "norm1": _norm(sd, f"{key}.norm1"),
        "conv1": _conv(sd, f"{key}.conv1"),
        "norm2": _norm(sd, f"{key}.norm2"),
        "conv2": _conv(sd, f"{key}.conv2"),
    }
    if f"{key}.nin_shortcut.weight" in sd:
        p["nin_shortcut"] = _conv(sd, f"{key}.nin_shortcut")
    return p


def _vae_mid(sd, key):
    a = f"{key}.attn_1"
    return {
        "block_1": _vae_resnet(sd, f"{key}.block_1"),
        "attn": {
            "norm": _norm(sd, f"{a}.norm"),
            "q": _conv(sd, f"{a}.q"),
            "k": _conv(sd, f"{a}.k"),
            "v": _conv(sd, f"{a}.v"),
            "proj_out": _conv(sd, f"{a}.proj_out"),
        },
        "block_2": _vae_resnet(sd, f"{key}.block_2"),
    }


def _convert_vae(sd, cfg: StableDiffusionConfig):
    base = "first_stage_model"
    n_enc = len(cfg.vae.encoder_channels)
    n_dec = len(cfg.vae.decoder_channels)

    enc_blocks = []
    for i in range(n_enc):
        kb = f"{base}.encoder.down.{i}"
        blk = {
            "res1": _vae_resnet(sd, f"{kb}.block.0"),
            "res2": _vae_resnet(sd, f"{kb}.block.1"),
        }
        if f"{kb}.downsample.conv.weight" in sd:
            blk["downsampler"] = {"conv": _conv(sd, f"{kb}.downsample.conv")}
        enc_blocks.append(blk)

    # ldm registers decoder up-blocks so that up.{N-1} runs FIRST (lowest
    # resolution); our blocks list is in application order.
    dec_blocks = []
    for j in range(n_dec):
        kb = f"{base}.decoder.up.{n_dec - 1 - j}"
        blk = {
            "res1": _vae_resnet(sd, f"{kb}.block.0"),
            "res2": _vae_resnet(sd, f"{kb}.block.1"),
            "res3": _vae_resnet(sd, f"{kb}.block.2"),
        }
        if f"{kb}.upsample.conv.weight" in sd:
            blk["upsampler"] = _conv(sd, f"{kb}.upsample.conv")
        dec_blocks.append(blk)

    return {
        "encoder": {
            "conv_in": _conv(sd, f"{base}.encoder.conv_in"),
            "blocks": enc_blocks,
            "mid": _vae_mid(sd, f"{base}.encoder.mid"),
            "norm_out": _norm(sd, f"{base}.encoder.norm_out"),
            "conv_out": _conv(sd, f"{base}.encoder.conv_out"),
        },
        "decoder": {
            "conv_in": _conv(sd, f"{base}.decoder.conv_in"),
            "mid": _vae_mid(sd, f"{base}.decoder.mid"),
            "blocks": dec_blocks,
            "norm_out": _norm(sd, f"{base}.decoder.norm_out"),
            "conv_out": _conv(sd, f"{base}.decoder.conv_out"),
        },
        "quant_conv": _conv(sd, f"{base}.quant_conv"),
        "post_quant_conv": _conv(sd, f"{base}.post_quant_conv"),
    }


# ----------------------------------------------------------- CLIP (v2 / OpenCLIP)

def _convert_clip_v2(sd, n_layer: int):
    """SD v2.x text tower: OpenCLIP ViT-H transformer under
    cond_stage_model.model.*; fused in_proj split into q/k/v; the
    'penultimate' configuration takes the first n_layer (=23 of 24)
    resblocks then ln_final."""
    base = "cond_stage_model.model"
    blocks = []
    for i in range(n_layer):
        rb = f"{base}.transformer.resblocks.{i}"
        in_w = _t(sd[f"{rb}.attn.in_proj_weight"])  # [3D, D]
        in_b = _t(sd[f"{rb}.attn.in_proj_bias"])
        d = in_w.shape[1]
        qw, kw, vw = in_w[:d], in_w[d:2 * d], in_w[2 * d:]
        qb, kb, vb = in_b[:d], in_b[d:2 * d], in_b[2 * d:]
        blocks.append(
            {
                "attn": {
                    "query": {"w": qw.T, "b": qb},
                    "key": {"w": kw.T, "b": kb},
                    "value": {"w": vw.T, "b": vb},
                    "out": _lin(sd, f"{rb}.attn.out_proj"),
                },
                "attn_ln": _norm(sd, f"{rb}.ln_1"),
                "mlp": {
                    "fc1": _lin(sd, f"{rb}.mlp.c_fc"),
                    "fc2": _lin(sd, f"{rb}.mlp.c_proj"),
                },
                "mlp_ln": _norm(sd, f"{rb}.ln_2"),
            }
        )
    return {
        "token_embedding": {"w": _t(sd[f"{base}.token_embedding.weight"])},
        "position_embedding": _t(sd[f"{base}.positional_embedding"]),
        "blocks": blocks,
        "layer_norm": _norm(sd, f"{base}.ln_final"),
    }


# ----------------------------------------------------------- top level

def convert_state_dict(sd, cfg: StableDiffusionConfig = SD_V1_4) -> dict:
    """LDM state_dict (torch tensors or numpy arrays) -> the param tree of
    numpy arrays. Detects the v1 (HF CLIP) vs v2 (OpenCLIP) text tower."""
    if "alphas_cumprod" in sd:
        alphas = _t(sd["alphas_cumprod"])
    else:
        alphas = scaled_linear_alphas_cumprod(cfg.n_train_steps).numpy()
    if any(k.startswith("cond_stage_model.model.") for k in sd):
        clip = _convert_clip_v2(sd, cfg.clip.n_layer)
    else:
        clip = _convert_clip_v1(sd)
    return {
        "n_steps": cfg.n_train_steps,
        "alphas_cumprod": alphas,
        "clip": clip,
        "unet": _convert_unet(sd, cfg),
        "autoencoder": _convert_vae(sd, cfg),
    }


def load_torch_ckpt(path: str, cfg: StableDiffusionConfig = SD_V1_4) -> dict:
    """Read a CompVis .ckpt with torch (on the host) and convert."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # Old pickled checkpoints need full unpickling, which executes
        # arbitrary code from the file: only after a warning.
        import warnings

        warnings.warn(
            f"{path} is not loadable with weights_only=True; falling back "
            "to full unpickling — only convert checkpoints you trust.",
            stacklevel=2,
        )
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return convert_state_dict(sd, cfg)
