"""Multi-head attention with the reference's exact scaling (port of
sdtpu/ops/attention.py, plain branch).

Both q and k are scaled by d_head^-0.25 before q @ k^T; an optional
additive mask and a boolean key_valid row are applied; the softmax
statistics are f32. sdtpu's flash branch (kernel K1) is off the ported
path and not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def causal_mask(seq_len: int, dtype=torch.float32, device=None):
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(
        torch.full((seq_len, seq_len), NEG_INF, dtype=dtype, device=device),
        diagonal=1)


def qkv_attention(q, k, v, mask=None, n_head: int = 1,
                  key_valid: Optional[torch.Tensor] = None):
    """q: [B, Sq, D], k/v: [B, Sk, D]; mask: additive [Sq, Sk] or None;
    key_valid: optional bool [B, Sk] marking real keys. Returns [B, Sq, D].

    The scores are computed and kept in f32, as sdtpu's einsum with
    preferred_element_type=f32 keeps them; the weights are cast to v's
    dtype for the value product.
    """
    b, sq, d = q.shape
    sk = k.shape[1]
    d_head = d // n_head
    scale = (d / n_head) ** -0.25

    q = (q * scale).reshape(b, sq, n_head, d_head).transpose(1, 2)
    k = (k * scale).reshape(b, sk, n_head, d_head).transpose(1, 2)
    v = v.reshape(b, sk, n_head, d_head).transpose(1, 2)

    qk = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B, h, Sq, Sk]
    if mask is not None:
        qk = qk + mask[:sq, :sk]
    if key_valid is not None:
        qk = qk.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    w = torch.exp(qk - qk.amax(dim=-1, keepdim=True))
    w = (w / w.sum(dim=-1, keepdim=True)).to(v.dtype)
    o = torch.matmul(w, v)
    return o.transpose(1, 2).reshape(b, sq, d)
