"""K10: the fused cross-attention sublayer x + Wo·attn(LN(x)Wq, K, V) + bo
over a short key set, the text context (port of
sdtpu/ops/fused_cross_attention.py: fused_cross_attention_kv and
fused_cross_attention).

It replaces the Pallas kernels `_kernel_kv` (called at :154) and `_kernel`
(:223) with three launches of hand-written kernels:

1. the shared GEMM (csrc/gemm.cu) with a LayerNorm prologue computes
   LN(x)·Wq into a [B, S, C] buffer; Wq is used as it is, [C, C];
2. csrc/cross_attention.cu: one block per (query tile, head, batch) stages
   that head's K and V, at most 128 keys, in shared memory once and serves
   every query row of its tile; one max, exp and sum over all the keys (no
   online rescale: there is one key tile), the key-padding bias applied
   from the bool key mask itself;
   the output is written with its heads merged, [B, S, C];
3. the shared GEMM computes o·Wo + bo + x, bias and residual in the f32
   epilogue.

fused_cross_attention_kv takes K and V already projected and transposed,
kt/vt [B, C, Sk] (sdtpu's layout: the UNet projects them once per
transformer, outside the kernel); the kernel reads them through their
strides, so a transposed view costs no copy. fused_cross_attention projects
the context itself, as the TPU body does, with the shared GEMM.

What bounds it on the H100 at SD's shapes: the two C x C projections, 4·S·C²
flops against 4·S·C bytes of x and out (bf16), compute-bound at the tensor
cores' rate; the attention core adds 4·S·Sk·C flops, Sk = 77.
"""

from __future__ import annotations

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops.attention import qkv_attention_plain
from sdtpu_torch.ops.conv import linear
from sdtpu_torch.ops.groupnorm import layer_norm

MAX_HEAD_DIM = 160  # shared-memory bound of csrc/cross_attention.cu
MAX_KEYS = 128      # one key tile; the text context has 77


def fused_cross_attention_kv_plain(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid=None,
                                   n_head: int = 8, eps: float = 1e-5):
    """The unfused composition: LN, Wq, attention over the keys marked
    valid, Wo + bo, plus x. kt/vt: [B, C, Sk]."""
    q = linear({"w": wq}, layer_norm(x, ln_g, ln_b, eps))
    k, v = kt.transpose(1, 2).to(x.dtype), vt.transpose(1, 2).to(x.dtype)
    o = qkv_attention_plain(q, k, v, None, n_head, key_valid=key_valid)
    return x + linear({"w": wo, "b": bo}, o)


def fused_cross_attention_plain(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid=None,
                                n_head: int = 8, eps: float = 1e-5):
    """The unfused composition with K and V projected from the context."""
    ctx = context.to(x.dtype)
    return fused_cross_attention_kv_plain(
        x, linear({"w": wk}, ctx).transpose(1, 2), linear({"w": wv}, ctx).transpose(1, 2),
        ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps)


def _check_shapes(name, x, kshape, n_head):
    """kshape: the [B, C, Sk] shape of the transposed keys."""
    b, s, c = x.shape
    d_head = c // n_head
    if d_head * n_head != c or d_head > MAX_HEAD_DIM or d_head % 8:
        raise ValueError(f"{name}: C={c} with {n_head} heads: the kernel takes "
                         f"d_head = C / n_head <= {MAX_HEAD_DIM}, a multiple of 8")
    if kshape[0] != b or kshape[1] != c or not 0 < kshape[2] <= MAX_KEYS:
        raise ValueError(f"{name}: keys {tuple(kshape)} do not fit x {tuple(x.shape)} "
                         f"(the kernel takes [B, C, Sk], Sk <= {MAX_KEYS})")


def _launch(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps):
    """The three launches on x's device; kt/vt [B, C, Sk] in x's dtype, any
    strides."""
    b, s, c = x.shape
    sk = kt.shape[2]
    dt = x.dtype
    m = b * s
    q = torch.empty((b, s, c), dtype=dt, device=x.device)
    attn = torch.empty((b, s, c), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    if key_valid is not None:
        if tuple(key_valid.shape) != (b, sk):
            raise ValueError(f"key_valid {tuple(key_valid.shape)} does not fit [{b}, {sk}]")
        # read by the kernel as bytes, the bias applied there: no launch
        # for a bool mask that is already contiguous (the UNet's ctx_valid)
        key_valid = key_valid.to(torch.bool).contiguous()
    with torch.cuda.device(x.device):
        kernels.gemm(x, wq.to(dt).contiguous(), q, M=m, N=c, K=c, lda=c, ldw=c, ldo=c,
                     pa=ln_g.float().contiguous(), pb=ln_b.float().contiguous(),
                     prologue=kernels.PRO_LAYERNORM, eps=eps)
        rc = kernels.lib().sdk_cross_attention(
            kernels.dtype_code(x), q.data_ptr(), kt.data_ptr(), vt.data_ptr(),
            kt.stride(0), kt.stride(1), kt.stride(2), vt.stride(0), vt.stride(1), vt.stride(2),
            kernels.ptr(key_valid), attn.data_ptr(), b, s, c, sk, n_head,
            float(c // n_head) ** -0.5, kernels.stream(x))
        kernels.check(rc, "sdk_cross_attention")
        kernels.gemm(attn, wo.to(dt).contiguous(), out, M=m, N=c, K=c, lda=c, ldw=c, ldo=c,
                     bias=bo.float().contiguous(), res=x, ldr=c)
    return out


def fused_cross_attention_kv(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid=None,
                             n_head: int = 8, eps: float = 1e-5):
    """x: [B, S, C] -> x + out_proj(attn(LN(x) Wq, K, V)). kt/vt: [B, C, Sk],
    the context's keys and values projected and transposed (sdtpu's
    layout; a transposed view is read as it is); key_valid: optional bool
    [B, Sk] of real keys (padded keys get a -1e30 score bias); wq, wo:
    [C, C]; bo: [C]. Scores use d_head^-1/2. CPU tensors take the plain
    version; CUDA tensors the kernels."""
    if kernels.on_cpu(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid):
        return fused_cross_attention_kv_plain(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid,
                                              n_head, eps)
    kernels.refuse_autograd("fused_cross_attention_kv (K10)", x, kt, vt, ln_g, ln_b, wq, wo,
                            bo)
    _check_shapes("fused_cross_attention_kv", x, kt.shape, n_head)
    if vt.shape != kt.shape:
        raise ValueError(f"kt {tuple(kt.shape)} and vt {tuple(vt.shape)} differ")
    x = x.contiguous()
    out = _launch(x, kt.to(x.dtype), vt.to(x.dtype), ln_g, ln_b, wq, wo, bo, key_valid,
                  n_head, eps)
    b, s, c = x.shape
    kernels.count(fused_cross_attention_kv, b=b, s=s, c=c, sk=kt.shape[2], heads=n_head)
    return out


def fused_cross_attention(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid=None,
                          n_head: int = 8, eps: float = 1e-5):
    """x: [B, S, C]; context: [B, Sk, Dc] -> x + out_proj(attn), K and V
    projected from the context here (wk, wv: [Dc, C]) with the shared GEMM.
    Otherwise as fused_cross_attention_kv."""
    if kernels.on_cpu(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid):
        return fused_cross_attention_plain(x, context, ln_g, ln_b, wq, wk, wv, wo, bo,
                                           key_valid, n_head, eps)
    kernels.refuse_autograd("fused_cross_attention (K10)", x, context, ln_g, ln_b, wq, wk, wv,
                            wo, bo)
    b, s, c = x.shape
    _, sk, dc = context.shape
    _check_shapes("fused_cross_attention", x, (context.shape[0], wk.shape[1], sk), n_head)
    x = x.contiguous()
    dt = x.dtype
    ctx = context.to(dt).contiguous()
    # [B, Sk, 2C]: the keys and the values of every head side by side
    kv = torch.empty((b, sk, 2 * c), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        for i, w in enumerate((wk, wv)):
            kernels.gemm(ctx, w.to(dt).contiguous(), kv[..., i * c:], M=b * sk, N=c, K=dc,
                         lda=dc, ldw=c, ldo=2 * c)
    kt, vt = kv[..., :c].transpose(1, 2), kv[..., c:].transpose(1, 2)
    out = _launch(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps)
    kernels.count(fused_cross_attention, b=b, s=s, c=c, sk=sk, heads=n_head)
    return out


fused_cross_attention_kv.launches = 0
fused_cross_attention_kv.shapes = {}
fused_cross_attention.launches = 0
fused_cross_attention.shapes = {}
