"""SD v1 UNet epsilon-predictor (port of sdtpu/models/unet.py).

The block structure is derived from UNetConfig exactly as in sdtpu (the
spec tables below are copies of sdtpu's pure-Python ones, which live in a
module that imports jax); block names match the reference dump tree.

Kernel dispatch keeps sdtpu's sites and gate conditions: the port calls a
kernel wrapper exactly where sdtpu calls a Pallas kernel. The wrapper then
runs the kernel on a CUDA tensor and its plain version on a CPU tensor.
The gates' bounds come from sdtpu's TPU measurements and have not been
measured again on the H100. At 128x128 latents (1024px) the ResBlocks take
sdtpu's fused branch: two K6 convolutions, the up path's skip concat folded
into the first (K6's second input), the timestep-embedding add folded into
the statistics and the second prologue, and the output statistics handed to
the SpatialTransformer's entry GroupNorm. The fused cross-attention (K10)
keeps sdtpu's switch: off unless SDTPU_FUSED_XATTN is set to another value
than "0", "false" or "". Inside ops/dispatch.py:training() every fused gate is closed (the
kernels are forward-only) and the UNet trains through plain PyTorch and the
differentiable flash attention; unet_apply's `remat` is sdtpu's block-level
rematerialisation (torch.utils.checkpoint, with selective policies).

Inside a tensor-parallel group (parallel/tp.py) the tree holds this rank's
shards (parallel/sharding.py) and each sublayer runs on them
(parallel/layers.py): the attention on n_head / tp local heads (Wq, Wk, Wv
column shards, Wo a row shard, then an all-reduce; the fused K2 and K10 add
x and bo on tp rank 0 only), the GEGLU MLP on [value_r | gate_r] and a row
shard of mlp.lin (K5 likewise), the >= 256-channel convolutions on an
out-channel slice, then all-gathered (K4, K6, K7 too). Every dispatch gate
is decided on the whole layer's shapes, so a tp run takes the single run's
routes. Where a level's heads do not divide over the ranks (SD v2.1's five
heads of 64 at tp = 2), its attention weights are gathered and the sublayer
runs whole on every rank.
"""

from __future__ import annotations

import contextlib
import functools
import os
import weakref
from dataclasses import dataclass
from typing import List, Tuple

import torch

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.ops import (
    dispatch,
    geglu,
    group_norm,
    layer_norm,
    linear,
    qkv_attention,
    silu,
    timestep_embedding,
)
from sdtpu_torch.ops import attention, flash_attention
from sdtpu_torch.ops.fused_cross_attention import fused_cross_attention_kv
from sdtpu_torch.ops.fused_conv import (conv1x1_fused, conv3x3_fused, gn_scale_bias,
                                        stats_scale_bias)
from sdtpu_torch.ops.fused_groupnorm import channel_partials
from sdtpu_torch.ops.fused_mlp import fused_geglu_mlp
from sdtpu_torch.ops.fused_transformer import fused_self_attention
from sdtpu_torch.ops.groupnorm import group_norm_silu_op
from sdtpu_torch.parallel import layers as tpl
from sdtpu_torch.parallel import tp as tpc


# ------------------------------------------------------------ structure
# BlockSpec, build_input_specs and build_output_specs: copies of sdtpu's
# (sdtpu/models/unet.py:44-114); tests/test_torch_models.py holds them equal.

@dataclass(frozen=True)
class BlockSpec:
    name: str
    kind: str  # conv | res | down
    c_in: int
    c_out: int
    transformer: bool = False
    upsample: bool = False
    n_head: int = 8


def build_input_specs(cfg: UNetConfig) -> List[BlockSpec]:
    specs: List[BlockSpec] = [
        BlockSpec("conv", "conv", cfg.in_channels, cfg.model_channels)
    ]
    rt = r = d = 0
    ch = cfg.model_channels
    for level, mult in enumerate(cfg.channel_mult):
        out = mult * cfg.model_channels
        attn = level in cfg.attention_levels
        for _ in range(cfg.n_res_blocks):
            if attn:
                rt += 1
                specs.append(BlockSpec(f"rt{rt}", "res", ch, out, transformer=True,
                                       n_head=cfg.heads_for(out)))
            else:
                r += 1
                specs.append(BlockSpec(f"r{r}", "res", ch, out))
            ch = out
        if level != len(cfg.channel_mult) - 1:
            d += 1
            specs.append(BlockSpec(f"d{d}", "down", ch, ch))
    return specs


def build_output_specs(cfg: UNetConfig) -> Tuple[List[BlockSpec], List[int]]:
    """Output block specs plus the skip-channel list they consume."""
    skip: List[int] = [s.c_out for s in build_input_specs(cfg)]
    specs: List[BlockSpec] = []
    rt = r = rtu = ru = 0
    ch = skip[-1]
    for level in reversed(range(len(cfg.channel_mult))):
        mult = cfg.channel_mult[level]
        out = mult * cfg.model_channels
        attn = level in cfg.attention_levels
        for i in range(cfg.n_res_blocks + 1):
            ich = skip.pop()
            up = level != 0 and i == cfg.n_res_blocks
            if attn and up:
                rtu += 1
                name = f"rtu{rtu}"
            elif attn:
                rt += 1
                name = f"rt{rt}"
            elif up:
                ru += 1
                name = f"ru{ru}"
            else:
                r += 1
                name = f"r{r}"
            specs.append(BlockSpec(name, "res", ch + ich, out, transformer=attn,
                                   upsample=up, n_head=cfg.heads_for(out)))
            ch = out
    # the reference names the single plain res+upsample block "ru", not "ru1"
    if ru == 1:
        specs = [BlockSpec("ru", s.kind, s.c_in, s.c_out, s.transformer, s.upsample,
                           s.n_head) if s.name == "ru1" else s for s in specs]
    return specs, [s.c_in for s in specs]


# ------------------------------------------------------------ init

def _init_res_block(init, c_in, c_embed, c_out):
    p = {
        "norm_in": init.norm(c_in),
        "conv_in": init.conv2d(c_in, c_out, 3),
        "lin_embed": init.linear(c_embed, c_out),
        "norm_out": init.norm(c_out),
        "conv_out": init.conv2d(c_out, c_out, 3),
    }
    if c_in != c_out:
        p["skip_connection"] = init.conv2d(c_in, c_out, 1)
    return p


def _init_cross_attn(init, n_state, n_ctx_state):
    return {
        "query": init.linear(n_state, n_state, bias=False),
        "key": init.linear(n_ctx_state, n_state, bias=False),
        "value": init.linear(n_ctx_state, n_state, bias=False),
        "out": init.linear(n_state, n_state),
    }


def _init_transformer(init, ch, ctx_dim):
    return {
        "norm": init.norm(ch),
        "proj_in": init.conv2d(ch, ch, 1),
        "transformer": {
            "norm1": init.norm(ch),
            "attn1": _init_cross_attn(init, ch, ch),
            "norm2": init.norm(ch),
            "attn2": _init_cross_attn(init, ch, ctx_dim),
            "norm3": init.norm(ch),
            "mlp": {
                "geglu": {"proj": init.linear(ch, 8 * ch)},
                "lin": init.linear(4 * ch, ch),
            },
        },
        "proj_out": init.conv2d(ch, ch, 1),
    }


def _init_block(init, spec: BlockSpec, cfg: UNetConfig):
    if spec.kind in ("conv", "down"):
        return init.conv2d(spec.c_in, spec.c_out, 3)
    res = _init_res_block(init, spec.c_in, cfg.time_embed_dim, spec.c_out)
    if not (spec.transformer or spec.upsample):
        return res  # bare ResBlock params live at the block root (r1, r2)
    p = {"res": res}
    if spec.transformer:
        p["transformer"] = _init_transformer(init, spec.c_out, cfg.context_dim)
    if spec.upsample:
        p["upsample"] = {"conv": init.conv2d(spec.c_out, spec.c_out, 3)}
    return p


def init_unet(init, cfg: UNetConfig):
    """init: a sdtpu_torch.weights.Init."""
    in_specs = build_input_specs(cfg)
    out_specs, _ = build_output_specs(cfg)
    mid_ch = in_specs[-1].c_out
    return {
        "lin1_time_embed": init.linear(cfg.model_channels, cfg.time_embed_dim),
        "lin2_time_embed": init.linear(cfg.time_embed_dim, cfg.time_embed_dim),
        "input_blocks": {s.name: _init_block(init, s, cfg) for s in in_specs},
        "middle_block": {
            "res1": _init_res_block(init, mid_ch, cfg.time_embed_dim, mid_ch),
            "transformer": _init_transformer(init, mid_ch, cfg.context_dim),
            "res2": _init_res_block(init, mid_ch, cfg.time_embed_dim, mid_ch),
        },
        "output_blocks": {s.name: _init_block(init, s, cfg) for s in out_specs},
        "norm_out": init.norm(cfg.model_channels),
        "conv_out": init.conv2d(cfg.model_channels, cfg.out_channels, 3),
    }


# ------------------------------------------------------------ apply

# sdtpu's gate for the fused ResBlock: maps of at least this many rows
# (128x128 latents, 1024px images)
FUSED_RES_MIN_ROWS = 1 << 14


def _use_fused_resblock(x, c_extra: int = 0) -> bool:
    """sdtpu's gate for the fused ResBlock (sdtpu/models/unet.py:212-229);
    c_extra: the channels of the up path's skip. Closed inside
    dispatch.training(): K3 and K6 are forward-only."""
    _, h, w, c = x.shape
    return (not dispatch.in_training() and (c + c_extra) % 8 == 0 and c % 8 == 0
            and h % 8 == 0 and h * w >= FUSED_RES_MIN_ROWS)


def _res_block_fused(p, x, e, cfg: UNetConfig, emit_stats, skip):
    """sdtpu's fused ResBlock branch (sdtpu/models/unet.py:263-306). The
    skip concat is never built: K6 reads it as its second input, the
    GroupNorm statistics come from both parts' channel partials, and the
    1x1 skip_connection is two channel products. The embedding add between
    the convs is never built either: its statistics are a per-channel shift
    of the first conv's (sum' = sum + N·e, sumsq' = sumsq + 2e·sum + N·e²)
    and the second prologue absorbs it (scale·(x + e) + bias)."""
    g, eps = cfg.groupnorm_groups, cfg.groupnorm_eps
    rows = x.shape[1] * x.shape[2]
    c1 = x.shape[-1]
    if skip is None:
        s1, o1 = gn_scale_bias(x, p["norm_in"]["g"], p["norm_in"]["b"], g, eps)
        h1, st = tpl.conv3x3(conv3x3_fused, x, p["conv_in"], s1, o1, emit_stats=True)
    else:
        sums = torch.cat([channel_partials(x), channel_partials(skip)], dim=-1)
        s1, o1 = stats_scale_bias(sums, rows, p["norm_in"]["g"], p["norm_in"]["b"], g, eps)
        h1, st = tpl.conv3x3(conv3x3_fused, x, p["conv_in"], s1[:, :c1], o1[:, :c1],
                             emit_stats=True, x2=skip, prologue_scale2=s1[:, c1:],
                             prologue_bias2=o1[:, c1:])
    ef = e.float()  # [B, c_out]
    st = torch.stack([st[:, 0] + rows * ef,
                      st[:, 1] + 2.0 * ef * st[:, 0] + rows * ef * ef], dim=1)
    s2, o2 = stats_scale_bias(st, rows, p["norm_out"]["g"], p["norm_out"]["b"], g, eps)
    o2 = o2 + s2 * ef
    # the residual on conv_out's output channels as this rank holds them
    # (skip_connection has the same C_out, so it is sharded alike)
    if "skip_connection" not in p:
        res = tpl.local_channels(p["conv_out"], x)
    else:
        sk = tpl.local(p["skip_connection"])
        if skip is None:
            res = tpl.conv2d(sk, x, padding=0)
        else:
            wsk = sk["w"][0, 0]  # [c1 + c2, co]
            res = (torch.matmul(x, wsk[:c1].to(x.dtype))
                   + torch.matmul(skip, wsk[c1:].to(x.dtype)) + sk["b"].to(x.dtype))
    return tpl.conv3x3(conv3x3_fused, h1, p["conv_out"], s2, o2, residual=res,
                       emit_stats=emit_stats)


def _res_block_apply(p, x, emb, cfg: UNetConfig, emit_stats=False, skip=None):
    """ResBlock (sdtpu/models/unet.py:232-317). skip: the up path's skip
    tensor, logically concatenated on the channel axis. emit_stats: also
    return the per-channel (sum, sum^2) [B, 2, C] of the output (None on
    the unfused branch) for the next GroupNorm."""
    e = linear(p["lin_embed"], silu(emb))
    if _use_fused_resblock(x, 0 if skip is None else skip.shape[-1]):
        return _res_block_fused(p, x, e, cfg, emit_stats, skip)
    if skip is not None:
        x = torch.cat([x, skip], dim=-1)
    h = group_norm_silu_op(x, p["norm_in"]["g"], p["norm_in"]["b"],
                           cfg.groupnorm_groups, cfg.groupnorm_eps)
    h = tpl.conv2d(p["conv_in"], h, padding=1)
    h = h + e[:, None, None, :]
    h = group_norm_silu_op(h, p["norm_out"]["g"], p["norm_out"]["b"],
                           cfg.groupnorm_groups, cfg.groupnorm_eps)
    h = tpl.conv2d(p["conv_out"], h, padding=1)
    if "skip_connection" in p:
        x = tpl.conv2d(p["skip_connection"], x, padding=0)
    y = x + h
    return (y, None) if emit_stats else y


def _mha_apply(p, x, context, n_head, key_valid=None):
    """q from x, k/v from context (or x), no mask; key_valid masks padded
    context tokens. Inside a tp group, this rank's heads, then the
    row-parallel out projection (parallel/layers.py)."""
    p, heads, tp = tpl.attention_weights(p, x.shape[-1], n_head)
    x = tpc.copy_to_tp(x, tp)
    xa = x if context is None else tpc.copy_to_tp(context, tp)
    q = linear(p["query"], x)
    k = linear(p["key"], xa)
    v = linear(p["value"], xa)
    o = qkv_attention(q, k, v, None, heads, key_valid=key_valid)
    return tpl.row_linear(p["out"], o, tp)


def _use_fused_attn(s: int, c: int, n_head: int) -> bool:
    """sdtpu's gate for the fused self-attention (K2) and, below 2048
    tokens, the fused MLP (K5): sdtpu/models/unet.py:331-350. The kernel
    keeps no whole row on chip here, but the bounds stay sdtpu's until the
    H100 measures its own. Closed inside dispatch.training()."""
    return (not dispatch.in_training() and 256 <= s <= 16384 and s % 128 == 0
            and s * c <= 16384 * 320 and (c // n_head) % 8 == 0)


def xattn_enabled() -> bool:
    """SDTPU_FUSED_XATTN, read at each call: set to another value than "0",
    "false" or "" (see _use_fused_xattn)."""
    return os.environ.get("SDTPU_FUSED_XATTN", "0") not in ("0", "false", "")


def _use_fused_xattn(s: int, c: int, n_head: int) -> bool:
    """sdtpu's gate for the fused cross-attention (K10,
    sdtpu/models/unet.py:353-368): off unless SDTPU_FUSED_XATTN is set to
    another value than "0", "false" or "" (sdtpu measured the TPU kernel
    slower than XLA's composite on v5e and keeps it off; the H100 default
    stays the same), then 256 <= S <= 4096, S % 128 == 0 and d_head % 8 == 0.
    Closed inside dispatch.training()."""
    if not xattn_enabled():
        return False
    return (not dispatch.in_training() and 256 <= s <= 4096 and s % 128 == 0
            and (c // n_head) % 8 == 0)


def _use_fused_proj(rows: int, c: int) -> bool:
    """sdtpu's gate for the GN+proj_in / proj_out+residual 1x1 fusion (K4,
    fed by K3): sdtpu/models/unet.py:371-381. Closed inside
    dispatch.training()."""
    return not dispatch.in_training() and c % 8 == 0 and rows % 8 == 0 and rows >= 4096


def fuse_qkv(params):
    """The UNet tree with each SpatialTransformer's self-attention weights
    also side by side, attn1["qkv"]["w"] = [Wq | Wk | Wv] ([C, 3C]), the
    operand of K2's first product, so that no UNet call concatenates them.
    Returns a new tree whose other leaves are the given ones."""
    if isinstance(params, dict):
        out = {k: fuse_qkv(v) for k, v in params.items()}
        a1 = out.get("attn1")
        if isinstance(a1, dict) and "query" in a1:
            ws = [a1[k]["w"] for k in ("query", "key", "value")]
            out["attn1"] = {**a1, "qkv": {"w": torch.cat(ws, dim=1)}}
        return out
    return params


# (id(wq), id(wk), id(wv)) -> (weak references to them, their versions,
# [Wq | Wk | Wv]): K2's operand for a tree without the fused leaf (sdtpu's
# tree handed to unet_apply as it is), made once per weights and not on
# each call, so that K2's float32 route finds its K-major copy
# (ops/fused_mlp.py:kmajor, keyed by this tensor) and a graph's capture
# makes none; each entry goes with the first of its weights to go
_QKV: dict = {}


def self_attention_qkv(a1):
    """K2's [Wq | Wk | Wv] of an attn1 subtree: its fused leaf (fuse_qkv),
    or else the concatenation of its three weights, kept while they live
    and are not changed in place (made anew, and not kept, where autograd
    records the weights)."""
    if "qkv" in a1:
        return a1["qkv"]["w"]
    ws = tuple(a1[k]["w"] for k in ("query", "key", "value"))
    if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
        return torch.cat(ws, dim=1)
    key = tuple(map(id, ws))
    versions = tuple(w._version for w in ws)
    hit = _QKV.get(key)
    if hit is not None and all(r() is w for r, w in zip(hit[0], ws)) and hit[1] == versions:
        return hit[2]
    fused = torch.cat(ws, dim=1)

    def drop(_ref, key=key):
        _QKV.pop(key, None)

    _QKV[key] = (tuple(weakref.ref(w, drop) for w in ws), versions, fused)
    return fused


def unfuse_qkv(params):
    """The UNet tree without the attn1["qkv"] leaves fuse_qkv adds: sdtpu's
    tree, the one training differentiates and saves (no training forward
    reads the fused leaf). Returns a new tree whose leaves are the given
    ones."""
    if isinstance(params, dict):
        return {k: unfuse_qkv(v) for k, v in params.items()
                if not (k == "qkv" and "query" in params)}
    return params


def _transformer_apply(p, x, context, cfg: UNetConfig, n_head, ctx_valid=None,
                       in_stats=None):
    """SpatialTransformer and its TransformerBlock
    (sdtpu/models/unet.py:384-463). in_stats: optional [B, 2, C] (sum,
    sum^2) of x from the fused ResBlock before it, which the entry
    GroupNorm takes instead of reading the map again."""
    b, h, w, c = x.shape
    x_in = x
    fused_proj = _use_fused_proj(h * w, c)
    if fused_proj:
        if in_stats is not None:
            s, o = stats_scale_bias(in_stats, h * w, p["norm"]["g"], p["norm"]["b"],
                                    cfg.groupnorm_groups, cfg.groupnorm_eps)
        else:
            s, o = gn_scale_bias(x, p["norm"]["g"], p["norm"]["b"],
                                 cfg.groupnorm_groups, cfg.groupnorm_eps)
        x = tpl.conv1x1(conv1x1_fused, x.reshape(b, h * w, c), p["proj_in"], s, o)
    else:
        x = group_norm(x, p["norm"]["g"], p["norm"]["b"], cfg.groupnorm_groups,
                       cfg.groupnorm_eps)
        x = tpl.conv2d(p["proj_in"], x, padding=0).reshape(b, h * w, c)

    t = p["transformer"]
    fused_attn = _use_fused_attn(h * w, c, n_head)
    if fused_attn:
        # this rank's heads inside a tp group (its [q_r | k_r | v_r]), the
        # residual and the bias on tp rank 0 only, then the ranks' sum
        a1, heads, tp = tpl.attention_weights(t["attn1"], c, n_head)
        wqkv = self_attention_qkv(a1)
        x = tpc.reduce_from_tp(fused_self_attention(
            x, t["norm1"]["g"], t["norm1"]["b"], wqkv, a1["out"]["w"], a1["out"]["b"], heads,
            cfg.ln_eps, residual=tp is None or tp.rank == 0), tp)
    else:
        x = x + _mha_apply(t["attn1"], layer_norm(x, t["norm1"]["g"], t["norm1"]["b"],
                                                  cfg.ln_eps), None, n_head)
    if _use_fused_xattn(h * w, c, n_head):
        # sdtpu/models/unet.py:424-435: K and V projected once per
        # transformer outside the kernel, handed over transposed [B, C, Sk]
        # (views: the kernel reads them through their strides); inside a tp
        # group this rank's heads, as K2's
        a2, heads, tp = tpl.attention_weights(t["attn2"], c, n_head)
        ctx = context.to(x.dtype)
        kt = torch.matmul(ctx, a2["key"]["w"].to(x.dtype)).transpose(1, 2)
        vt = torch.matmul(ctx, a2["value"]["w"].to(x.dtype)).transpose(1, 2)
        x = tpc.reduce_from_tp(fused_cross_attention_kv(
            x, kt, vt, t["norm2"]["g"], t["norm2"]["b"], a2["query"]["w"], a2["out"]["w"],
            a2["out"]["b"], key_valid=ctx_valid, n_head=heads, eps=cfg.ln_eps,
            residual=tp is None or tp.rank == 0), tp)
    else:
        x = x + _mha_apply(t["attn2"], layer_norm(x, t["norm2"]["g"], t["norm2"]["b"],
                                                  cfg.ln_eps), context, n_head,
                           key_valid=ctx_valid)
    # inside a tp group: [value_r | gate_r] and this rank's rows of mlp.lin
    mlp = t["mlp"]
    proj = mlp["geglu"]["proj"]
    tp = tpl.out_shard(proj)
    if fused_attn and h * w < 2048:
        x = tpc.reduce_from_tp(fused_geglu_mlp(
            x, t["norm3"]["g"], t["norm3"]["b"], proj["w"],
            tpl.local(proj, 2)["b"], mlp["lin"]["w"], mlp["lin"]["b"],
            cfg.ln_eps, residual=tp is None or tp.rank == 0), tp)
    else:
        hn = layer_norm(x, t["norm3"]["g"], t["norm3"]["b"], cfg.ln_eps)
        val, gate = tpl.column_linear(proj, hn, tp, blocks=2).chunk(2, dim=-1)
        x = x + tpl.row_linear(mlp["lin"], geglu(val, gate), tp)

    if fused_proj:
        out = tpl.conv1x1(conv1x1_fused, x, p["proj_out"],
                          residual=tpl.local_channels(p["proj_out"], x_in.reshape(b, h * w, c)))
        return out.reshape(b, h, w, c)
    return x_in + tpl.conv2d(p["proj_out"], x.reshape(b, h, w, c), padding=0)


def _block_apply(p, spec: BlockSpec, x, emb, context, cfg, ctx_valid, skip=None):
    if spec.kind == "conv":
        return tpl.conv2d(p, x, padding=1)
    if spec.kind == "down":
        return tpl.conv2d(p, x, stride=2, padding=1)
    res_p = p["res"] if (spec.transformer or spec.upsample) else p
    if spec.transformer:
        # the ResBlock's output statistics feed the transformer's entry
        # GroupNorm (fused branch only; st is None otherwise)
        x, st = _res_block_apply(res_p, x, emb, cfg, emit_stats=True, skip=skip)
        x = _transformer_apply(p["transformer"], x, context, cfg, spec.n_head, ctx_valid,
                               in_stats=st)
    else:
        x = _res_block_apply(res_p, x, emb, cfg, skip=skip)
    if spec.upsample:
        x = tpl.upsample2x_conv(p["upsample"]["conv"], x)
    return x


def _mid_apply(m, h, emb, context, cfg, ctx_valid):
    h = _res_block_apply(m["res1"], h, emb, cfg)
    h = _transformer_apply(m["transformer"], h, context, cfg,
                           cfg.heads_for(h.shape[-1]), ctx_valid)
    return _res_block_apply(m["res2"], h, emb, cfg)


REMAT_POLICIES = ("full", "dots", "heavy")


def _remat_policy(remat):
    """Map the `remat` argument to (checkpoint the blocks?, the ops whose
    outputs a selective checkpoint saves; None: recompute everything), as
    sdtpu's _remat_policy (sdtpu/models/unet.py:491-518):

    - False/None: no rematerialisation;
    - True or "full": each block recomputed in the backward pass;
    - "dots": save the products over weights (aten.mm/addmm: every linear;
      sdtpu's checkpoint_dots_with_no_batch_dims, so not the batched
      attention products) and the attention outputs (the differentiable
      flash op and the plain branch's attn_out tag: sdtpu's "attn_out"
      name); recompute convolutions and the elementwise chains;
    - "heavy": also save the convolutions' outputs (sdtpu's "conv_out")."""
    if not remat:
        return False, None
    if remat is True or remat == "full":
        return True, None
    dots = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            flash_attention.FLASH_DIFF_OP, attention.ATTN_OUT_OP]
    if remat == "dots":
        return True, dots
    if remat == "heavy":
        return True, dots + [torch.ops.aten.convolution.default]
    raise ValueError(f"remat must be bool or one of {REMAT_POLICIES}, got {remat!r}")


def _checkpointed(fn, save):
    """fn under torch.utils.checkpoint (non-reentrant), with a selective
    policy that saves the outputs of the ops in `save` when given. The
    recompute runs in the backward pass, outside the caller's
    dispatch.training(), so it enters it again when the forward ran inside
    it: the recomputed block must take the same kernels."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    training = dispatch.in_training()
    tp = tpc.current()  # the tp group, entered again alike

    def run(*args):
        with dispatch.training() if training else contextlib.nullcontext(), tpc.use(tp):
            return fn(*args)

    kw = {}
    if save is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, save)
    # the UNet draws no random numbers: no RNG state to stash and restore
    return lambda *args: checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                                    **kw)


def unet_apply(params, x, t, context, cfg: UNetConfig, ctx_valid=None, remat=False):
    """x: [B, h, w, in_ch] NHWC latent; t: int timestep, or [B] timesteps;
    context: [B, S, context_dim]; ctx_valid: optional [B, S] bool of real
    context tokens. Returns the epsilon prediction [B, h, w, out_ch].

    remat: rematerialise each block in the backward pass, at sdtpu's block
    granularity (each input and output block, the middle block as one);
    see _remat_policy. Inference never sets it."""
    use_ckpt, save = _remat_policy(remat)
    block, mid = ((_checkpointed(_block_apply, save), _checkpointed(_mid_apply, save))
                  if use_ckpt else (_block_apply, _mid_apply))
    t_emb = timestep_embedding(t, cfg.model_channels, cfg.max_period,
                               dtype=x.dtype, device=x.device)
    emb = linear(params["lin2_time_embed"],
                 silu(linear(params["lin1_time_embed"], t_emb)))

    skips = []
    h = x
    for spec in build_input_specs(cfg):
        h = block(params["input_blocks"][spec.name], spec, h, emb, context, cfg, ctx_valid)
        skips.append(h)

    h = mid(params["middle_block"], h, emb, context, cfg, ctx_valid)

    out_specs, _ = build_output_specs(cfg)
    for spec in out_specs:
        h = block(params["output_blocks"][spec.name], spec, h, emb, context, cfg, ctx_valid,
                  skips.pop())

    h = group_norm(h, params["norm_out"]["g"], params["norm_out"]["b"],
                   cfg.groupnorm_groups, cfg.groupnorm_eps)
    return tpl.conv2d(params["conv_out"], silu(h), padding=1)
