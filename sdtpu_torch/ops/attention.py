"""Multi-head attention with the reference's exact scaling (port of
sdtpu/ops/attention.py).

Both q and k are scaled by d_head^-0.25 before q @ k^T; an optional
additive mask and a boolean key_valid row are applied; the softmax
statistics are f32. qkv_attention keeps sdtpu's dispatch: mask-free
attention over long sequences goes to the flash kernel (K1,
sdtpu_torch/ops/flash_attention.py), the rest to qkv_attention_plain, which
never dispatches and is what the kernels' plain versions call. Inside
dispatch.training() it follows sdtpu's branch under
force_xla(allow_differentiable=True): mask-free long attention goes to the
differentiable flash attention (K1 forward, K9 backward), everything else,
key-padded attention included, to the plain branch, whose output passes
through attn_out, the tag a selective checkpoint saves (sdtpu's
checkpoint_name(..., "attn_out")).
"""

from __future__ import annotations

from typing import Optional

import torch

from sdtpu_torch.ops import dispatch
from sdtpu_torch.ops.flash_attention import (MAX_BWD_HEAD_DIM, MAX_HEAD_DIM,
                                             flash_qkv_attention, flash_qkv_attention_diff,
                                             query_chunks)

NEG_INF = float("-inf")
# sdtpu's shortest query and key sequences for the flash kernel
FLASH_MIN_SEQ = 2048


def causal_mask(seq_len: int, dtype=torch.float32, device=None):
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(
        torch.full((seq_len, seq_len), NEG_INF, dtype=dtype, device=device),
        diagonal=1)


def use_flash(sq: int, sk: int, d_head: int, masked: bool, key_valid: bool) -> bool:
    """sdtpu's dispatch to the flash kernel (sdtpu/ops/attention.py:67-89):
    mask-free, sq and sk >= 2048, d_head <= 160 unless sq >= 8192, and its
    block divisibility; plus what csrc/flash_attention.cu takes (d_head <=
    512, a multiple of 8), so no other shape reaches the kernel. Inside
    dispatch.training() only the differentiable form is open: no key
    padding (sdtpu's use_pallas() is False under force_xla), and the head
    dims K9 takes (d_head <= 160). The bounds are sdtpu's TPU measurements,
    not yet measured again on the H100."""
    training = dispatch.in_training()
    return (not masked and sq >= FLASH_MIN_SEQ and sk >= FLASH_MIN_SEQ
            and (d_head <= 160 or sq >= 8192)
            and sq % min(512, sq) == 0
            and (key_valid or sk % min(1024, sk) == 0)
            and d_head <= (MAX_BWD_HEAD_DIM if training else MAX_HEAD_DIM)
            and d_head % 8 == 0 and not (training and key_valid))


@torch.library.custom_op("sdtpu_torch::attn_out", mutates_args=(), schema="(Tensor x) -> Tensor")
def attn_out(x):
    """A copy of an attention output that a selective checkpoint can name
    (models/unet.py's "dots" and "heavy" policies save it); its gradient
    passes through."""
    return x.clone()


@attn_out.register_fake
def _(x):
    return torch.empty_like(x)


attn_out.register_autograd(lambda ctx, g: g, setup_context=lambda ctx, inputs, output: None)
ATTN_OUT_OP = torch.ops.sdtpu_torch.attn_out.default


def qkv_attention_plain(q, k, v, mask=None, n_head: int = 1,
                        key_valid: Optional[torch.Tensor] = None):
    """sdtpu's plain branch: q: [B, Sq, D], k/v: [B, Sk, D]; mask: additive
    [Sq, Sk] or None; key_valid: optional bool [B, Sk] marking real keys.
    Returns [B, Sq, D].

    The scores are computed and kept in f32, as sdtpu's einsum with
    preferred_element_type=f32 keeps them; the weights are cast to v's
    dtype for the value product. Long query sequences go in query_chunks
    (ops/flash_attention.py), which bound the f32 scores.
    """
    b, sq, d = q.shape
    sk = k.shape[1]
    d_head = d // n_head
    scale = (d / n_head) ** -0.25

    q = (q * scale).reshape(b, sq, n_head, d_head).transpose(1, 2)
    kt = (k * scale).reshape(b, sk, n_head, d_head).transpose(1, 2).float().transpose(-1, -2)
    v = v.reshape(b, sk, n_head, d_head).transpose(1, 2)

    def attend(i, j):
        qk = torch.matmul(q[:, :, i:j].float(), kt)  # [B, h, j - i, Sk]
        if mask is not None:
            qk = qk + mask[i:j, :sk]
        if key_valid is not None:
            qk = qk.masked_fill(~key_valid[:, None, None, :], NEG_INF)
        w = torch.exp(qk - qk.amax(dim=-1, keepdim=True))
        return torch.matmul((w / w.sum(dim=-1, keepdim=True)).to(v.dtype), v)

    chunks = query_chunks(b, n_head, sq, sk)
    if len(chunks) == 1:
        out = attend(0, sq)
    else:
        out = torch.empty((b, n_head, sq, d_head), dtype=v.dtype, device=v.device)
        for i, j in chunks:
            out[:, :, i:j] = attend(i, j)
    return out.transpose(1, 2).reshape(b, sq, d)


def qkv_attention(q, k, v, mask=None, n_head: int = 1,
                  key_valid: Optional[torch.Tensor] = None):
    """Attention over flattened-head inputs, as qkv_attention_plain, with
    sdtpu's dispatch to the flash kernel (use_flash): the differentiable
    form inside dispatch.training(), the forward-only one elsewhere."""
    flash = use_flash(q.shape[1], k.shape[1], q.shape[2] // n_head, mask is not None,
                      key_valid is not None)
    if not dispatch.in_training():
        if flash:
            return flash_qkv_attention(q, k, v, n_head, key_valid=key_valid)
        return qkv_attention_plain(q, k, v, mask, n_head, key_valid)
    if flash:
        return flash_qkv_attention_diff(q, k, v, n_head)
    return attn_out(qkv_attention_plain(q, k, v, mask, n_head, key_valid))
