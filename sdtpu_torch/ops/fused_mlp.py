"""K5: the fused GEGLU-MLP sublayer x + W_lin·(val·gelu_erf(gate)) + b_lin
with [val | gate] = LN(x)·W_proj + b_proj (port of
sdtpu/ops/fused_mlp.py:fused_geglu_mlp).

It replaces the Pallas `_kernel` (sdtpu/ops/fused_mlp.py:47, called at :87)
with two launches of the shared GEMM (csrc/gemm.cu):

1. LayerNorm prologue, LN(x)·W_proj with each output tile accumulating its
   val columns and its gate columns (4C apart) side by side, and the GEGLU
   epilogue val·gelu_erf(gate) on the f32 accumulators: the [B, S, 8C]
   projection never reaches HBM, only its [B, S, 4C] product;
2. a·W_lin + b_lin + x, bias and residual in the f32 epilogue.

What bounds it on the H100: 2·S·C·(8C + 4C) flops against a few S·C
bytes — compute-bound; the design removes the 8C-wide intermediate.
"""

from __future__ import annotations

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops.activations import geglu
from sdtpu_torch.ops.conv import linear
from sdtpu_torch.ops.groupnorm import layer_norm


def fused_geglu_mlp_plain(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin,
                          eps: float = 1e-5):
    """The unfused composition sdtpu's oracle tests hold the kernel to."""
    hn = layer_norm(x, ln_g, ln_b, eps)
    val, gate = linear({"w": w_proj, "b": b_proj}, hn).chunk(2, dim=-1)
    return x + linear({"w": w_lin, "b": b_lin}, geglu(val, gate))


def fused_geglu_mlp(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin,
                    eps: float = 1e-5):
    """x: [B, S, C]; w_proj: [C, 8C] (val | gate), b_proj: [8C];
    w_lin: [4C, C], b_lin: [C]. CPU tensors take the plain version; CUDA
    tensors the kernels."""
    if kernels.on_cpu(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin):
        return fused_geglu_mlp_plain(x, ln_g, ln_b, w_proj, b_proj, w_lin,
                                     b_lin, eps)
    kernels.refuse_autograd("fused_geglu_mlp (K5)", x, ln_g, ln_b, w_proj, b_proj, w_lin,
                            b_lin)
    b, s, c = x.shape
    c8 = w_proj.shape[1]
    if c8 != 8 * c or tuple(w_lin.shape) != (4 * c, c):
        raise ValueError(f"w_proj {tuple(w_proj.shape)} / w_lin "
                         f"{tuple(w_lin.shape)} do not fit C={c}")
    dt = x.dtype
    x = x.contiguous()
    m, c4 = b * s, 4 * c
    h = torch.empty((b, s, c4), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernels.gemm(x, w_proj.to(dt).contiguous(), h, M=m, N=c4, K=c, lda=c,
                     ldw=c8, ldo=c4, bias=b_proj.float().contiguous(),
                     pa=ln_g.float().contiguous(), pb=ln_b.float().contiguous(),
                     prologue=kernels.PRO_LAYERNORM, geglu_off=c4, eps=eps)
        kernels.gemm(h, w_lin.to(dt).contiguous(), out, M=m, N=c, K=c4, lda=c4,
                     ldw=c, ldo=c, bias=b_lin.float().contiguous(), res=x, ldr=c)
    kernels.count(fused_geglu_mlp, b=b, s=s, c=c)
    return out


fused_geglu_mlp.launches = 0
fused_geglu_mlp.shapes = {}
