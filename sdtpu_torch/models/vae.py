"""KL autoencoder f=8 (port of sdtpu/models/vae.py).

The decoder keeps sdtpu's dispatch: ResnetBlocks on large aligned maps run
as two fused GroupNorm+SiLU+conv3x3 kernels (K6), the large upsamplers as
the fused subpixel conv (K7), and each fused kernel emits the per-channel
statistics of its output, which the next GroupNorm (a K6 prologue, or the
final K8) consumes instead of reading the map again. The mid block's
attention goes through qkv_attention's dispatch: at 1024px (128x128 maps,
16384 tokens of d=512) to the flash kernel (K1), at 512px to the plain
branch. The gates' bounds are sdtpu's TPU measurements. The encoder
(encode_image, for the fine-tuning latent cache) takes the same fused
ResnetBlock gate.

Inside a tensor-parallel group (parallel/tp.py) the tree holds this rank's
shards: the >= 256-channel convolutions run on an out-channel slice, then
all-gathered (parallel/layers.py; K6's and K7's statistics gathered with
the map, and a residual taken on the rank's channels), and every gate is decided on the whole
layer's channels. The mid attention's one head of 512 cannot be split by
heads: its four 1x1 weights are gathered and the sublayer runs whole on
every rank, once per decode or encode.
"""

from __future__ import annotations

import torch

from sdtpu_torch.config import AutoencoderConfig
from sdtpu_torch.ops import dispatch, group_norm, qkv_attention
from sdtpu_torch.ops.conv import use_fused_upsample
from sdtpu_torch.ops.fused_conv import (conv3x3_fused, gn_scale_bias, phase_weight_stack,
                                        stats_scale_bias, upsample2x_conv_fused)
from sdtpu_torch.ops.groupnorm import group_norm_silu_op
from sdtpu_torch.parallel import layers as tpl

# sdtpu's gate for the fused ResnetBlock: maps of at least this many rows
FUSED_CONV_MIN_ROWS = 1 << 12


# ---------------------------------------------------------------- init

def _init_resnet(init, n_in, n_out):
    p = {
        "norm1": init.norm(n_in),
        "conv1": init.conv2d(n_in, n_out, 3),
        "norm2": init.norm(n_out),
        "conv2": init.conv2d(n_out, n_out, 3),
    }
    if n_in != n_out:
        p["nin_shortcut"] = init.conv2d(n_in, n_out, 1)
    return p


def _init_mid(init, ch):
    return {
        "block_1": _init_resnet(init, ch, ch),
        "attn": {"norm": init.norm(ch),
                 **{k: init.conv2d(ch, ch, 1) for k in ("q", "k", "v", "proj_out")}},
        "block_2": _init_resnet(init, ch, ch),
    }


def init_autoencoder(init, cfg: AutoencoderConfig):
    """init: a sdtpu_torch.weights.Init."""
    enc_blocks = []
    for i, (cin, cout) in enumerate(cfg.encoder_channels):
        blk = {"res1": _init_resnet(init, cin, cout),
               "res2": _init_resnet(init, cout, cout)}
        if i != len(cfg.encoder_channels) - 1:
            blk["downsampler"] = {"conv": init.conv2d(cout, cout, 3)}
        enc_blocks.append(blk)
    c0 = cfg.encoder_channels[0][1]
    c_final = cfg.encoder_channels[-1][1]
    z = 2 * cfg.latent_channels if cfg.double_z else cfg.latent_channels
    encoder = {
        "conv_in": init.conv2d(cfg.in_channels, c0, 3),
        "blocks": enc_blocks,
        "mid": _init_mid(init, c_final),
        "norm_out": init.norm(c_final),
        "conv_out": init.conv2d(c_final, z, 3),
    }

    dec_blocks = []
    for i, (cin, cout) in enumerate(cfg.decoder_channels):
        blk = {"res1": _init_resnet(init, cin, cout),
               "res2": _init_resnet(init, cout, cout),
               "res3": _init_resnet(init, cout, cout)}
        if i != len(cfg.decoder_channels) - 1:
            blk["upsampler"] = init.conv2d(cout, cout, 3)
        dec_blocks.append(blk)
    d0 = cfg.decoder_channels[0][0]
    d_final = cfg.decoder_channels[-1][1]
    decoder = {
        "conv_in": init.conv2d(cfg.latent_channels, d0, 3),
        "mid": _init_mid(init, d0),
        "blocks": dec_blocks,
        "norm_out": init.norm(d_final),
        "conv_out": init.conv2d(d_final, cfg.in_channels, 3),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": init.conv2d(z, z, 1),
        "post_quant_conv": init.conv2d(cfg.latent_channels, cfg.latent_channels, 1),
    }


# ---------------------------------------------------------------- apply

def _use_fused_resnet(x, cout: int) -> bool:
    """sdtpu's gate for the fused ResnetBlock (sdtpu/models/vae.py:122-138),
    closed inside dispatch.training() (K3 and K6 are forward-only)."""
    _, h, w, c = x.shape
    return (not dispatch.in_training() and c % 128 == 0 and cout % 128 == 0 and h % 8 == 0
            and h * w >= FUSED_CONV_MIN_ROWS)


def _resnet_apply(p, x, cfg, in_stats=None, emit_stats=False):
    """ResnetBlock (sdtpu/models/vae.py:141-175). in_stats: optional
    [B, 2, C] per-channel (sum, sum^2) of x from the previous fused kernel,
    which saves the GroupNorm's statistics pass. With emit_stats, returns
    (out, stats of out), stats None on the unfused branch."""
    g, eps = cfg.groupnorm_groups, cfg.groupnorm_eps
    if _use_fused_resnet(x, p["conv1"]["b"].shape[-1]):  # the whole layer's channels
        rows = x.shape[1] * x.shape[2]
        if in_stats is not None:
            s1, o1 = stats_scale_bias(in_stats, rows, p["norm1"]["g"], p["norm1"]["b"],
                                      g, eps)
        else:
            s1, o1 = gn_scale_bias(x, p["norm1"]["g"], p["norm1"]["b"], g, eps)
        h1, st = tpl.conv3x3(conv3x3_fused, x, p["conv1"], s1, o1, emit_stats=True)
        s2, o2 = stats_scale_bias(st, rows, p["norm2"]["g"], p["norm2"]["b"], g, eps)
        # the residual on conv2's output channels as this rank holds them
        # (nin_shortcut has the same C_out, so it is sharded alike)
        if "nin_shortcut" in p:
            res = tpl.conv2d(tpl.local(p["nin_shortcut"]), x, padding=0)
        else:
            res = tpl.local_channels(p["conv2"], x)
        return tpl.conv3x3(conv3x3_fused, h1, p["conv2"], s2, o2, residual=res,
                           emit_stats=emit_stats)
    h = group_norm_silu_op(x, p["norm1"]["g"], p["norm1"]["b"], g, eps)
    h = tpl.conv2d(p["conv1"], h, padding=1)
    h = group_norm_silu_op(h, p["norm2"]["g"], p["norm2"]["b"], g, eps)
    h = tpl.conv2d(p["conv2"], h, padding=1)
    if "nin_shortcut" in p:
        x = tpl.conv2d(p["nin_shortcut"], x, padding=0)
    y = x + h
    return (y, None) if emit_stats else y


def _attn_apply(p, x, cfg):
    """Single-head self-attention over h*w tokens with 1x1-conv q/k/v
    (K1 from 16384 tokens on, through qkv_attention's dispatch)."""
    b, h, w, c = x.shape
    tp = tpl.out_shard(p["q"])
    if tp is not None:  # one head: the weights gathered, the sublayer whole
        p = tpl.gather_attention(p, tp)
    hn = group_norm(x, p["norm"]["g"], p["norm"]["b"], cfg.groupnorm_groups,
                    cfg.groupnorm_eps)
    q = tpl.conv2d(p["q"], hn, padding=0).reshape(b, h * w, c)
    k = tpl.conv2d(p["k"], hn, padding=0).reshape(b, h * w, c)
    v = tpl.conv2d(p["v"], hn, padding=0).reshape(b, h * w, c)
    o = qkv_attention(q, k, v, None, n_head=1).reshape(b, h, w, c)
    return x + tpl.conv2d(p["proj_out"], o, padding=0)


def _mid_apply(p, x, cfg, emit_stats=False):
    x = _resnet_apply(p["block_1"], x, cfg)
    x = _attn_apply(p["attn"], x, cfg)
    return _resnet_apply(p["block_2"], x, cfg, emit_stats=emit_stats)


def encoder_apply(params, x, cfg: AutoencoderConfig):
    """x: [B, H, W, 3] -> latent moments [B, H/8, W/8, 2·latent]
    (sdtpu/models/vae.py:196-209). The ResnetBlocks take the fused gate
    (K3, then K6 twice, at 64² maps and up), each computing its own
    GroupNorm statistics as sdtpu's encoder does; the mid attention at 64²
    stays plain, by use_flash."""
    p = params["encoder"]
    x = tpl.conv2d(p["conv_in"], x, padding=1)
    for blk in p["blocks"]:
        x = _resnet_apply(blk["res1"], x, cfg)
        x = _resnet_apply(blk["res2"], x, cfg)
        if "downsampler" in blk:
            # the asymmetric (0, 1, 0, 1) pad, stride 2
            x = tpl.conv2d(blk["downsampler"]["conv"], x, stride=2, padding=((0, 1), (0, 1)))
    x = _mid_apply(p["mid"], x, cfg)
    x = group_norm_silu_op(x, p["norm_out"]["g"], p["norm_out"]["b"], cfg.groupnorm_groups,
                           cfg.groupnorm_eps)
    return tpl.conv2d(p["conv_out"], x, padding=1)


def encode_image(params, x, cfg: AutoencoderConfig):
    """The encode path: encoder -> quant_conv -> the first `latent_channels`
    channels (the means; no sampling), sdtpu/models/vae.py:212-217."""
    moments = encoder_apply(params, x, cfg)
    latent = tpl.conv2d(params["quant_conv"], moments, padding=0)
    return latent[..., : cfg.latent_channels]


def upsample_phase_stacks(params):
    """Per decoder block, the [4, 4C, Co] phase-weight stack of its
    upsampler in the weight's dtype (fused_conv.phase_weight_stack), or None
    where the block has none: the operand of K7's Hopper route, folded once
    where the pipeline prepares its parameters instead of once a call."""
    with torch.no_grad():
        return [phase_weight_stack(blk["upsampler"]["w"], blk["upsampler"]["w"].dtype)
                if "upsampler" in blk else None for blk in params["decoder"]["blocks"]]


def decode_latent(params, z, cfg: AutoencoderConfig, phases=None):
    """z: [B, h, w, latent] -> image [B, 8h, 8w, 3] in about [-1, 1].

    On the fused path every block emits the per-channel (sum, sum^2) of its
    f32 output and the next block's GroupNorm consumes them
    (sdtpu/models/vae.py:220-252). phases: optional upsample_phase_stacks
    of params, which the fused upsamplers (K7) then read instead of folding
    their weights a call."""
    z = tpl.conv2d(params["post_quant_conv"], z, padding=0)
    p = params["decoder"]
    x = tpl.conv2d(p["conv_in"], z, padding=1)
    x, st = _mid_apply(p["mid"], x, cfg, emit_stats=True)
    for i, blk in enumerate(p["blocks"]):
        for name in ("res1", "res2", "res3"):
            x, st = _resnet_apply(blk[name], x, cfg, in_stats=st, emit_stats=True)
        if "upsampler" in blk:
            up = blk["upsampler"]
            _, hh, ww, cc = x.shape
            if use_fused_upsample(hh, ww, cc, up["b"].shape[-1]):  # the whole layer's
                x, st = tpl.upsample(upsample2x_conv_fused, x, up, emit_stats=True,
                                     phases=None if phases is None else phases[i])
            else:
                x, st = tpl.upsample2x_conv(up, x), None
    x = group_norm_silu_op(x, p["norm_out"]["g"], p["norm_out"]["b"],
                           cfg.groupnorm_groups, cfg.groupnorm_eps, in_stats=st)
    return tpl.conv2d(p["conv_out"], x, padding=1)
