"""The models' layers on tensor-parallel shards (Megatron-LM's column and
row parallel layers, and the fused kernels' calls on a rank's slice).

Each function takes the weights as the rank holds them (sharding.py's
local tree) and the activations whole, and returns the whole result, the
same as the layer without tp. Outside a tp group (tp.current() is None) or
on whole weights each is the plain layer, so the models call them on every
path. This module is the one place that tells a shard from a whole leaf:
biases and norms stay whole under sdtpu's specs, so a weight whose last
dim is under its bias's is an out-channel (column) shard (out_shard), and
an attention whose query maps C to fewer columns runs on local heads
(attention_weights).

- column_linear / row_linear: x·W_r (+ b_r) on this rank's columns, and
  the all-reduced Σ_r x_r·W_r + b after a row shard (the bias once);
- attention_weights: the heads a rank computes, n_head / tp of them on its
  column shards, or, where a head would straddle two ranks (n_head % tp ≠
  0: SD v2.1's 5-head level, the VAE's one head of 512), the weights
  gathered and the sublayer computed whole;
- conv2d and upsample2x_conv (ops/conv.py's) on this rank's output
  channels, then all-gathered;
- conv3x3 (K6), conv1x1 (K4) and upsample (K7): the kernel's wrapper,
  which the model passes in (its own module-level name), on this rank's
  output channels (the weight's slice and the bias's; the residual is
  given on those channels: local_channels, or a product on local()
  weights), its output map and statistics all-gathered on the channel axis.

The kernels are forward-only, so the fused calls take no copy_to_tp; the
plain layers do (they train).
"""

from __future__ import annotations

from typing import Optional

import torch

from sdtpu_torch.ops import conv
from sdtpu_torch.parallel.tp import (TP, copy_to_tp, current, gather_from_tp, reduce_from_tp,
                                     scatter_to_tp)


def out_shard(p) -> Optional[TP]:
    """The tp group where the weight of p ({w, b}: a conv, or a biased
    linear) is an out-channel shard (its last dim under its whole bias's),
    else None."""
    tp = current()
    b = p.get("b")
    if tp is None or b is None or p["w"].shape[-1] == b.shape[-1]:
        return None
    return tp


def local(p, blocks: int = 1):
    """{w, b} of p on this rank's output channels: where p is an
    out-channel shard, the bias's slice (in `blocks` blocks, as the
    weight's) beside the weight's, else p itself."""
    tp = out_shard(p)
    if tp is None:
        return p
    return {**p, "b": scatter_to_tp(p["b"], tp, 0, blocks)}


def local_channels(p, x):
    """x on the output channels of p as this rank holds them: x's slice
    where p is an out-channel shard, else x (an identity residual)."""
    return scatter_to_tp(x, out_shard(p))


def column_linear(p, x, tp, blocks: int = 1):
    """x (replicated) · this rank's columns of w (+ its slice of b, in
    `blocks` blocks as the weight's)."""
    return conv.linear(local(p, blocks), copy_to_tp(x, tp))


def row_linear(p, x, tp):
    """Σ over the tp ranks of x_r · w_r (this rank's rows), then + b once."""
    y = reduce_from_tp(torch.matmul(x, p["w"].to(x.dtype)), tp)
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    return y


def attention_weights(a, c: int, n_head: int):
    """(weights, heads, tp) of an attention sublayer whose query maps C to
    C: tp None with the given weights where they are whole (or no tp group
    is entered); this rank's n_head / tp heads on its shards; or, where the
    heads do not divide over the ranks, the weights gathered (each column
    shard, the fused qkv's thirds, the row-sharded out) and tp None."""
    tp = current()
    if tp is None or a["query"]["w"].shape[-1] == c:
        return a, n_head, None
    if n_head % tp.size == 0:
        return a, n_head // tp.size, tp
    return gather_attention(a, tp), n_head, None


def gather_attention(a, tp):
    """The whole weights of an attention sublayer from this rank's shards:
    the linear `out` row-sharded (on `in`), every other weight (linears
    [in, out], the fused qkv by thirds, the VAE's 1x1 convs [1, 1, in,
    out]) column-sharded; biases and norms are whole already."""
    whole = {}
    for name, p in a.items():
        if not isinstance(p, dict) or "w" not in p:
            whole[name] = p
            continue
        w = p["w"]
        if name == "out":
            w = gather_from_tp(w, tp, w.ndim - 2)
        else:
            w = gather_from_tp(w, tp, -1, 3 if name == "qkv" else 1)
        whole[name] = {**p, "w": w}
    return whole


def conv2d(p, x, stride: int = 1, padding: conv.PadT = 0):
    """ops/conv.py's conv2d; on an out-channel shard, this rank's channels,
    then all-gathered."""
    tp = out_shard(p)
    if tp is None:
        return conv.conv2d(p, x, stride, padding)
    return gather_from_tp(conv.conv2d(local(p), copy_to_tp(x, tp), stride, padding), tp)


def upsample2x_conv(p, x):
    """ops/conv.py's upsample2x_conv; on an out-channel shard, this rank's
    channels, then all-gathered, with K7's gate decided on the whole
    layer's output channels."""
    tp = out_shard(p)
    if tp is None:
        return conv.upsample2x_conv(p, x)
    _, h, w, c = x.shape
    fused = conv.use_fused_upsample(h, w, c, p["b"].shape[-1])
    return gather_from_tp(conv.upsample2x_conv(local(p), copy_to_tp(x, tp), fused), tp)


def _gathered(out, tp, emit_stats: bool):
    if tp is None:
        return out
    if emit_stats:
        y, st = out
        return gather_from_tp(y, tp), None if st is None else gather_from_tp(st, tp)
    return gather_from_tp(out, tp)


def conv3x3(fn, x, p, prologue_scale=None, prologue_bias=None, residual=None,
            emit_stats: bool = False, **kw):
    """K6, fn (ops/fused_conv.conv3x3_fused), with the conv's {w, b} and
    the residual on its output channels as this rank holds them: on an
    out-channel shard, this rank's channels, the map and its statistics
    gathered."""
    tp, lp = out_shard(p), local(p)
    out = fn(x, lp["w"], lp["b"], prologue_scale, prologue_bias, residual=residual,
             emit_stats=emit_stats, **kw)
    return _gathered(out, tp, emit_stats)


def conv1x1(fn, x, p, prologue_scale=None, prologue_bias=None, residual=None):
    """K4, fn (ops/fused_conv.conv1x1_fused), with a 1x1 conv's {w [1, 1,
    C, Co], b} on x [B, rows, C] and the residual on its output channels as
    this rank holds them: on an out-channel shard, this rank's channels,
    the output gathered. The weight is handed over as the tensor it is (the
    float32 route keeps one K-major copy per weight tensor, which a view
    made a call would miss)."""
    tp, lp = out_shard(p), local(p)
    out = fn(x, lp["w"], lp["b"], prologue_scale, prologue_bias, residual=residual)
    return _gathered(out, tp, False)


def upsample(fn, x, p, emit_stats: bool = False, phases=None):
    """K7, fn (ops/fused_conv.upsample2x_conv_fused), with the upsampler's
    {w, b}; phases: the phase stack folded from the weight as this rank
    holds it. On an out-channel shard, this rank's channels, the map and
    its statistics gathered."""
    tp, lp = out_shard(p), local(p)
    out = fn(x, lp["w"], lp["b"], emit_stats=emit_stats, phases=phases)
    return _gathered(out, tp, emit_stats)
