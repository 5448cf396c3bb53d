"""K1: blockwise (flash) attention, forward (port of
sdtpu/ops/flash_attention.py:flash_attention_heads and flash_qkv_attention).

softmax(q kᵀ · d^-1/2 + key_bias) v per (batch·head), f32 statistics, the
output in the input dtype; the same as the reference's dual d^-1/4 scaling
of q and k. It replaces the Pallas `_fullk_kernel`, `_fullk_bias_kernel`,
`_flash_kernel` and `_flash_ot_kernel` (sdtpu/ops/flash_attention.py:320,
:332, :390, :408) with one hand-written CUDA kernel,
csrc/flash_attention.cu: an online softmax over key tiles that never holds
the [Sq, Sk] score matrix in HBM. On the 1024px main path it runs the VAE
decoder's mid-block attention (one head, S = 16384, d = 512), which is
compute-bound (4·S²·d flops); see the kernel's source for how d = 512 fits.

The kernel reads q, k, v and writes o through (batch, head, row) strides, so
flash_qkv_attention hands it the heads inside [B, S, C] rows with no split
or merge transpose. The backward (K9) and a torch.autograd.Function come
with training; sdtpu's VMEM block pickers have no counterpart.
"""

from __future__ import annotations

import torch

from sdtpu_torch import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 512  # what csrc/flash_attention.cu takes
# f32 score elements a plain attention (here and ops/attention.py) holds at
# a time (2 GB)
SCORE_BUDGET = 1 << 29


def query_chunks(b: int, h: int, sq: int, sk: int):
    """Query ranges [i, j) over which a plain attention's f32 scores
    [B, H, j - i, Sk] stay within SCORE_BUDGET elements. Each query row is
    independent, so the chunks change no number."""
    step = max(1, SCORE_BUDGET // max(1, b * h * sk))
    return [(i, min(i + step, sq)) for i in range(0, sq, step)]


def _attend_plain(q, k, v, key_bias, out):
    """Plain attention over [B, H, S, d] views (any strides), written into
    out, in query_chunks. The weights are rounded to v's dtype before the
    value product and the sum divides afterwards, as the Pallas kernel
    does."""
    b, h, sq, d = q.shape
    scale = float(d) ** -0.5
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    for i, j in query_chunks(b, h, sq, k.shape[2]):
        s = torch.matmul(q[:, :, i:j].float(), kt) * scale
        if bias is not None:
            s = s + bias
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        out[:, :, i:j] = (torch.matmul(p.to(v.dtype).float(), vf) / l).to(out.dtype)
    return out


def _heads4(x, n_head):
    """[BH, S, d] -> the [BH / n_head, n_head, S, d] view."""
    bh, s, d = x.shape
    return x.reshape(bh // n_head, n_head, s, d)


def flash_attention_heads_plain(q, k, v, key_bias=None, n_head: int = 1):
    """The plain version of flash_attention_heads, in PyTorch ops."""
    out = torch.empty_like(q)
    _attend_plain(_heads4(q, n_head), _heads4(k, n_head), _heads4(v, n_head),
                  key_bias, _heads4(out, n_head))
    return out


def _attend(q, k, v, key_bias, out):
    """Attention over [B, H, S, d] views into out; the plain version for
    CPU tensors, K1 for CUDA tensors."""
    if kernels.on_cpu(q, k, v, key_bias, out):
        return _attend_plain(q, k, v, key_bias, out)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bad = []
    if d % 8 or d > MAX_HEAD_DIM:
        bad.append(f"d={d} (the kernel takes d <= {MAX_HEAD_DIM}, a multiple of 8)")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype:
            bad.append(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            bad.append(f"{name} strides {t.stride()}")
        if t.data_ptr() % 16:
            bad.append(f"{name} is not 16-byte aligned")
    if bad:
        raise ValueError("flash attention: " + ", ".join(bad))
    if key_bias is not None:
        key_bias = key_bias.float().reshape(b, sk).contiguous()
    with torch.cuda.device(q.device):
        rc = kernels.lib().sdk_flash_attention(
            kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            kernels.ptr(key_bias), b * h, h, sq, sk, d, float(d) ** -0.5,
            kernels.stream(q))
    kernels.check(rc, "sdk_flash_attention")
    kernels.count(flash_attention_heads, b=b, h=h, sq=sq, sk=sk, d=d,
                  bias=key_bias is not None)
    return out


def flash_attention_heads(q, k, v, key_bias=None, n_head: int = 1):
    """q: [BH, Sq, D], k/v: [BH, Sk, D], heads flattened into the batch.
    key_bias: optional additive f32 [BH // n_head, Sk] row (0 / -1e30)
    applied to every head of its batch element. Returns [BH, Sq, D] in q's
    dtype. CPU tensors take the plain version; CUDA tensors the kernel."""
    out = torch.empty_like(q)
    _attend(_heads4(q, n_head), _heads4(k, n_head), _heads4(v, n_head), key_bias,
            _heads4(out, n_head))
    return out


flash_attention_heads.launches = 0
flash_attention_heads.shapes = {}


def flash_qkv_attention(q, k, v, n_head: int, key_valid=None):
    """Drop-in for qkv_attention without a mask: q [B, Sq, C], k/v
    [B, Sk, C] with the heads side by side in C -> [B, Sq, C]. key_valid:
    optional bool [B, Sk] marking real keys."""
    b, sq, c = q.shape
    sk = k.shape[1]
    dh = c // n_head

    def heads(x, s):
        return x.view(b, s, n_head, dh).transpose(1, 2)

    key_bias = None
    if key_valid is not None:
        key_bias = torch.where(key_valid, 0.0, NEG_INF).to(torch.float32)
    out = torch.empty_like(q)
    _attend(heads(q.contiguous(), sq), heads(k.contiguous(), sk), heads(v.contiguous(), sk),
            key_bias, heads(out, sq))
    return out
