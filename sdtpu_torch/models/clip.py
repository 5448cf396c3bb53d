"""CLIP text encoder (port of sdtpu/models/clip.py).

Token + learned position embeddings, n_layer pre-LN residual blocks
(causal self-attention, MLP with QuickGELU or exact GELU), final LayerNorm.
Returns the hidden states [B, S, n_state]; skip_last_layers drops the last
blocks (SD v2's penultimate layer).
"""

from __future__ import annotations

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.ops import causal_mask, gelu, layer_norm, linear, qkv_attention, quick_gelu


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
    a = p["attn"]
    q, k, v = linear(a["query"], h), linear(a["key"], h), linear(a["value"], h)
    x = x + linear(a["out"], qkv_attention(q, k, v, mask, cfg.n_head))
    h = layer_norm(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"], cfg.layer_norm_eps)
    return x + linear(p["mlp"]["fc2"], act(linear(p["mlp"]["fc1"], h)))


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
