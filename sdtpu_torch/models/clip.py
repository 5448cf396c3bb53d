"""CLIP text encoder (port of sdtpu/models/clip.py).

Token + learned position embeddings, n_layer pre-LN residual blocks
(causal self-attention, MLP with QuickGELU or exact GELU), final LayerNorm.
Returns the hidden states [B, S, n_state]; skip_last_layers drops the last
blocks (SD v2's penultimate layer).

Inside a tensor-parallel group (parallel/tp.py) the tree holds this rank's
shards: the attention runs on n_head / tp local heads (query, key, value
column shards with their biases' slices, out a row shard, all-reduced, its
bias added once) and the MLP on a column shard of fc1 and a row shard of
fc2 (parallel/layers.py). CLIP runs no kernel.
"""

from __future__ import annotations

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.ops import causal_mask, gelu, layer_norm, qkv_attention, quick_gelu
from sdtpu_torch.parallel import layers as tpl


def init_clip(init, cfg: CLIPConfig):
    """init: a sdtpu_torch.weights.Init."""
    blocks = []
    for _ in range(cfg.n_layer):
        blocks.append({
            "attn": {name: init.linear(cfg.n_state, cfg.n_state)
                     for name in ("query", "key", "value", "out")},
            "attn_ln": init.norm(cfg.n_state),
            "mlp": {"fc1": init.linear(cfg.n_state, 4 * cfg.n_state),
                    "fc2": init.linear(4 * cfg.n_state, cfg.n_state)},
            "mlp_ln": init.norm(cfg.n_state),
        })
    return {
        "token_embedding": init.embedding(cfg.n_vocab, cfg.n_state),
        "position_embedding": init.normal((cfg.n_ctx, cfg.n_state), 0.01),
        "blocks": blocks,
        "layer_norm": init.norm(cfg.n_state),
    }


def _block_apply(p, x, mask, cfg: CLIPConfig):
    act = quick_gelu if cfg.quick_gelu else gelu
    h = layer_norm(x, p["attn_ln"]["g"], p["attn_ln"]["b"], cfg.layer_norm_eps)
    a, heads, tp = tpl.attention_weights(p["attn"], x.shape[-1], cfg.n_head)
    q, k, v = (tpl.column_linear(a[n], h, tp) for n in ("query", "key", "value"))
    x = x + tpl.row_linear(a["out"], qkv_attention(q, k, v, mask, heads), tp)
    h = layer_norm(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"], cfg.layer_norm_eps)
    mlp = p["mlp"]
    tp = tpl.out_shard(mlp["fc1"])
    return x + tpl.row_linear(mlp["fc2"], act(tpl.column_linear(mlp["fc1"], h, tp)), tp)


def clip_apply(params, tokens, cfg: CLIPConfig):
    """tokens: [B, S] int (S <= n_ctx) -> [B, S, n_state]. Right-padded
    positions never reach valid ones, thanks to the causal mask."""
    s = tokens.shape[1]
    pos = params["position_embedding"]
    mask = causal_mask(s, device=pos.device)
    x = params["token_embedding"]["w"][tokens] + pos[None, :s]
    n_blocks = len(params["blocks"]) - cfg.skip_last_layers
    for p in params["blocks"][:n_blocks]:
        x = _block_apply(p, x, mask, cfg)
    ln = params["layer_norm"]
    return layer_norm(x, ln["g"], ln["b"], cfg.layer_norm_eps)
