"""K10: the fused cross-attention sublayer x + Wo·attn(LN(x)Wq, K, V) + bo
over a short key set, the text context (port of
sdtpu/ops/fused_cross_attention.py: fused_cross_attention_kv and
fused_cross_attention).

It replaces the Pallas kernels `_kernel_kv` (called at :154) and `_kernel`
(:223). Three routes, chosen by dtype and plan (route_plan):

- bf16 at the head widths the Hopper core has an instance for (padded to
  48, 64, 80 or 160) takes K2's bf16 route without K and V in the first
  product, four launches: the row-statistics pre-pass, LN(x)·Wq on
  csrc/gemm_sm90.cu (the LayerNorm prologue in registers, N = C) into a
  [B, S, C] buffer, the core on csrc/attention_sm90.cu (K1's instances with
  the key bias: key_valid as an f32 row of 0 / -1e30 a batch element, added
  in the log2 domain before the row maximum; Sk = 77 is two 64-key tiles,
  the second masked past Sk), which reads q through the buffer's (batch,
  head, row) strides and K and V through those of kt/vt's untransposed
  [B, Sk, C] projections (no copy), and o·Wo + bo + x on csrc/gemm_sm90.cu.
  γ, β, the weights and bo are read in x's dtype: no cast a call.
- float32 (the default dtype of `serve`) at the head widths the TF32 core
  has an instance for (40, 64, 80, 160; tf32_plan) takes K2's float32
  route without K and V in the first product, five launches: the f32 row
  statistics, LN(x)·Wq on csrc/gemm_tf32_sm90.cu (the LayerNorm prologue,
  q rounded to TF32 as it is stored; Wq's K-major copy, fused_mlp.kmajor),
  K's rounded copy and V's K-major copy in one pre-pass
  (flash_attention.tf32_copies: the UNet's kt and vt, transposed views of
  ctx·Wk and ctx·Wv, read as [B, Sk, C] rows; V's 77 keys padded to 80, in
  the fragments' order, rounded), the core on csrc/attention_tf32_sm90.cu
  (K1's float32 instances: the key bias as K1 adds it, keys past Sk masked
  in the last tile, o rounded as it is stored), and o·Wo + bo + x on
  csrc/gemm_tf32_sm90.cu (route "tf32").
- the shapes without a plan take the WMMA kernels (route "wmma", also for
  timing): the shared WMMA GEMM (csrc/gemm.cu) with a LayerNorm prologue
  for LN(x)·Wq, csrc/cross_attention.cu (one block per (query tile, head,
  batch) stages that head's K and V, at most 128 keys, in shared memory
  once; one max, exp and sum over all the keys, the key-padding bias from
  the bool mask itself; the heads merged), and the shared GEMM for o·Wo +
  bo + x.

Each launch is counted under its route. fused_cross_attention_kv takes K
and V already projected and transposed, kt/vt [B, C, Sk] (sdtpu's layout:
the UNet projects them once per transformer, outside the kernel);
fused_cross_attention projects the context itself, as the TPU body does,
on csrc/gemm_sm90.cu in bf16 and on csrc/gemm_tf32_sm90.cu in float32.

What bounds it on the H100 at SD's shapes: the two C x C projections, 4·S·C²
flops against 4·S·C bytes of x and out (bf16), compute-bound at the tensor
cores' rate; the attention core adds 4·S·Sk·C flops, Sk = 77.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops import fused_mlp
from sdtpu_torch.ops.attention import qkv_attention_plain
from sdtpu_torch.ops.conv import linear
from sdtpu_torch.ops.flash_attention import (NEG_INF, CorePlan, Tf32CorePlan, attend_tf32,
                                             core_sm90_plan, tf32_copies, tf32_core_plan)
from sdtpu_torch.ops.fused_transformer import local_dims
from sdtpu_torch.ops.groupnorm import layer_norm

MAX_HEAD_DIM = 160  # shared-memory bound of csrc/cross_attention.cu
MAX_KEYS = 128      # one key tile; the text context has 77


class Sm90Plan(NamedTuple):
    """K10's bf16 route: the Q product (LayerNorm prologue, N = C, no bias),
    the core (with the key bias when the keys are masked), and the Wo
    product (bias and residual)."""
    q: fused_mlp.Sm90Plan
    core: CorePlan
    out: fused_mlp.Sm90Plan


def sm90_plan(b: int, s: int, c: int, n_head: int, sk: int, bias: bool,
              ci: int | None = None) -> Sm90Plan | None:
    """The bf16 route's plans for x [b, s, c] with n_head heads over an
    inner width ci (C, or a tensor-parallel rank's C / tp) and sk keys,
    bias: whether the keys are masked (key_valid given), or None where the
    Hopper kernels have no tile for it (the WMMA route takes it): a head
    width without a core instance, a LayerNorm wider than the GEMM's
    prologue takes, or more keys than the kernel's MAX_KEYS."""
    ci = c if ci is None else ci
    d = ci // n_head
    core = core_sm90_plan(d, bias) if d * n_head == ci else None
    if (core is None or c % 8 or ci % 8 or c > fused_mlp.SM90_LN_MAX_K
            or not 0 < sk <= MAX_KEYS):
        return None
    m = b * s
    return Sm90Plan(fused_mlp.sm90_plan(m, ci, c, False, ln=True), core,
                    fused_mlp.sm90_plan(m, c, ci, False))


class Tf32Plan(NamedTuple):
    """K10's float32 route: the Q product (LayerNorm prologue, N = Ci, q
    rounded), the TF32 core (with the key bias when the keys are masked),
    and the Wo product (bias and residual)."""
    q: fused_mlp.Tf32Plan
    core: Tf32CorePlan
    out: fused_mlp.Tf32Plan


def tf32_plan(b: int, s: int, c: int, n_head: int, sk: int,
              ci: int | None = None) -> Tf32Plan | None:
    """The float32 route's plans for x [b, s, c] with n_head heads over an
    inner width ci (C, or a tensor-parallel rank's C / tp) and sk keys, or
    None where the TF32 kernels have no plan for it (the WMMA route takes
    it): a head width without a core instance, a LayerNorm wider than the
    GEMM's prologue takes, or more keys than MAX_KEYS. The core's plan is
    the same with and without the key bias."""
    ci = c if ci is None else ci
    d = ci // n_head
    core = tf32_core_plan(d) if d * n_head == ci else None
    if (core is None or c % 8 or ci % 8 or c > fused_mlp.TF32_LN_MAX_K
            or not 0 < sk <= MAX_KEYS):
        return None
    m = b * s
    return Tf32Plan(fused_mlp.tf32_plan(m, ci, c, False, ln=True), core,
                    fused_mlp.tf32_plan(m, c, ci, False))


def route_plan(dtype, b: int, s: int, c: int, n_head: int, sk: int,
               bias: bool, ci: int | None = None) -> Sm90Plan | Tf32Plan | None:
    """K10's route: the Hopper kernels' plans (sm90_plan) for bf16, the TF32
    kernels' (tf32_plan) for float32, else None: the shapes without a plan
    take the WMMA kernels."""
    if dtype == torch.bfloat16:
        return sm90_plan(b, s, c, n_head, sk, bias, ci)
    return tf32_plan(b, s, c, n_head, sk, ci) if dtype == torch.float32 else None


def fused_cross_attention_kv_plain(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid=None,
                                   n_head: int = 8, eps: float = 1e-5, residual: bool = True):
    """The unfused composition: LN, Wq, attention over the keys marked
    valid, Wo + bo, plus x (without residual: the product with Wo alone, a
    tensor-parallel rank's partial sum). kt/vt: [B, Ci, Sk]."""
    q = linear({"w": wq}, layer_norm(x, ln_g, ln_b, eps))
    k, v = kt.transpose(1, 2).to(x.dtype), vt.transpose(1, 2).to(x.dtype)
    o = qkv_attention_plain(q, k, v, None, n_head, key_valid=key_valid)
    if not residual:
        return linear({"w": wo}, o)
    return x + linear({"w": wo, "b": bo}, o)


def fused_cross_attention_plain(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid=None,
                                n_head: int = 8, eps: float = 1e-5):
    """The unfused composition with K and V projected from the context."""
    ctx = context.to(x.dtype)
    return fused_cross_attention_kv_plain(
        x, linear({"w": wk}, ctx).transpose(1, 2), linear({"w": wv}, ctx).transpose(1, 2),
        ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps)


def _check_shapes(name, x, kshape, n_head, ci=None):
    """kshape: the [B, Ci, Sk] shape of the transposed keys; ci: the
    inner width (C, or a tensor-parallel rank's C / tp)."""
    b, s, c = x.shape
    ci = c if ci is None else ci
    d_head = ci // n_head
    if d_head * n_head != ci or d_head > MAX_HEAD_DIM or d_head % 8:
        raise ValueError(f"{name}: Ci={ci} with {n_head} heads: the kernel takes "
                         f"d_head = Ci / n_head <= {MAX_HEAD_DIM}, a multiple of 8")
    if kshape[0] != b or kshape[1] != ci or not 0 < kshape[2] <= MAX_KEYS:
        raise ValueError(f"{name}: keys {tuple(kshape)} do not fit x {tuple(x.shape)} "
                         f"(the kernel takes [B, C, Sk], Sk <= {MAX_KEYS})")


def _launch_wmma(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, residual):
    """The WMMA route's three launches on x's device (csrc/gemm.cu,
    csrc/cross_attention.cu, csrc/gemm.cu); kt/vt [B, Ci, Sk] in x's dtype,
    any strides. The shared GEMM takes f32 LayerNorm parameters and biases."""
    b, s, c = x.shape
    ci = wq.shape[1]
    sk = kt.shape[2]
    dt = x.dtype
    m = b * s
    q = torch.empty((b, s, ci), dtype=dt, device=x.device)
    attn = torch.empty((b, s, ci), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    if key_valid is not None:
        # read by the kernel as bytes, the bias applied there: no launch
        # for a bool mask that is already contiguous (the UNet's ctx_valid)
        key_valid = key_valid.to(torch.bool).contiguous()
    kernels.gemm(x, wq.to(dt).contiguous(), q, M=m, N=ci, K=c, lda=c, ldw=ci, ldo=ci,
                 pa=ln_g.float().contiguous(), pb=ln_b.float().contiguous(),
                 prologue=kernels.PRO_LAYERNORM, eps=eps)
    rc = kernels.lib().sdk_cross_attention(
        kernels.dtype_code(x), q.data_ptr(), kt.data_ptr(), vt.data_ptr(),
        kt.stride(0), kt.stride(1), kt.stride(2), vt.stride(0), vt.stride(1), vt.stride(2),
        kernels.ptr(key_valid), attn.data_ptr(), b, s, ci, sk, n_head,
        float(ci // n_head) ** -0.5, kernels.stream(x))
    kernels.check(rc, "sdk_cross_attention")
    bias, res = (bo.float().contiguous(), x) if residual else (None, None)
    kernels.gemm(attn, wo.to(dt).contiguous(), out, M=m, N=c, K=ci, lda=ci, ldw=c, ldo=c,
                 bias=bias, res=res, ldr=c if residual else 0)
    return out


def _rows(t):
    """t [B, Sk, C] as the core reads it (unit column stride, the batch and
    row strides multiples of 8 elements, 16-byte aligned): t itself where
    it already is (the UNet's kt.transpose(1, 2)), else a copy."""
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        return t.contiguous()
    return t


def _launch_sm90(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, plan: Sm90Plan,
                 residual):
    """The bf16 route's four launches on x's device: row statistics, LN(x)·Wq
    (csrc/gemm_sm90.cu), the core with the key bias (csrc/attention_sm90.cu),
    o·Wo + bo + x (csrc/gemm_sm90.cu). γ, β, the weights and bo are read in
    x's dtype (.to and .contiguous return the tensors themselves when they
    already are: no copy a call)."""
    b, s, c = x.shape
    ci = wq.shape[1]
    sk = kt.shape[2]
    d = ci // n_head
    dt = x.dtype
    m = b * s
    ln_g, ln_b, wq, wo, bo = (t.to(dt).contiguous() for t in (ln_g, ln_b, wq, wo, bo))
    k, v = _rows(kt.transpose(1, 2)), _rows(vt.transpose(1, 2))
    bias = None
    if key_valid is not None:
        bias = torch.where(key_valid.to(torch.bool), 0.0, NEG_INF).to(torch.float32)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    q = torch.empty((b, s, ci), dtype=dt, device=x.device)
    attn = torch.empty((b, s, ci), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    lib, st = kernels.lib(), kernels.stream(x)
    p1, p2 = plan.q, plan.out
    kernels.check(lib.sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, eps, st),
                  "sdk_row_stats")
    kernels.check(lib.sdk_gemm_sm90(
        x.data_ptr(), c, wq.data_ptr(), ci, None, ln_g.data_ptr(), ln_b.data_ptr(),
        stats.data_ptr(), None, 0, q.data_ptr(), ci, m, ci, c, 0, p1.bn, p1.stages, p1.smem,
        st), "sdk_gemm_sm90 (LayerNorm, Q)")
    kernels.check(lib.sdk_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr(), s * ci, d, ci,
        k.stride(0), d, k.stride(1), v.stride(0), d, v.stride(1), s * ci, d, ci,
        kernels.ptr(bias), sk, None, b * n_head, n_head, s, sk, d, float(d) ** -0.5,
        *plan.core, st), "sdk_attention_sm90")
    bo_p, res = (bo.data_ptr(), x.data_ptr()) if residual else (None, None)
    kernels.check(lib.sdk_gemm_sm90(
        attn.data_ptr(), ci, wo.data_ptr(), c, bo_p, None, None, None, res, c,
        out.data_ptr(), c, m, c, ci, 0, p2.bn, p2.stages, p2.smem, st), "sdk_gemm_sm90 (Wo)")
    return out


def _heads_of(t, n_head):
    """[B, S, C] rows (unit column stride) -> the [B, n_head, S, C / n_head]
    view of their heads, through t's own strides."""
    b, s, c = t.shape
    return t.as_strided((b, n_head, s, c // n_head), (t.stride(0), c // n_head, t.stride(1), 1))


def _launch_tf32(x, k, v, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, plan: Tf32Plan,
                 residual):
    """The float32 route's five launches on x's device: row statistics,
    LN(x)·Wq (csrc/gemm_tf32_sm90.cu, q rounded), k's rounded copy and V's
    K-major copy (tf32_copies), the core with the key bias
    (csrc/attention_tf32_sm90.cu), o·Wo + bo + x (csrc/gemm_tf32_sm90.cu).
    k/v: [B, Sk, Ci] rows. The weights' K-major copies are
    fused_mlp.kmajor's (made once per weight tensor)."""
    b, s, c = x.shape
    ci = wq.shape[1]
    m = b * s
    ln_g, ln_b, bo = (t.float().contiguous() for t in (ln_g, ln_b, bo))
    # kmajor keys its copies by the weight tensor itself: handed the model's
    # own (f32) tensors, not per-call copies
    w1, w2 = fused_mlp.kmajor(wq.float()), fused_mlp.kmajor(wo.float())
    bias = None
    if key_valid is not None:
        bias = torch.where(key_valid.to(torch.bool), 0.0, NEG_INF).to(torch.float32)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    q = torch.empty((b, s, ci), dtype=torch.float32, device=x.device)
    attn = torch.empty((b, s, ci), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fused_mlp.row_stats_f32(x, stats, m, c, eps)
    fused_mlp.gemm_tf32(x, c, w1, c, q, ci, m, ci, c, plan.q, gamma=ln_g, beta=ln_b,
                        stats=stats, round_out=True)
    _, kr, vt = tf32_copies(None, _heads_of(k, n_head), _heads_of(v, n_head))
    attend_tf32(_heads_of(q, n_head), kr, vt, bias, _heads_of(attn, n_head), None, plan.core,
                round_o=True)
    fused_mlp.gemm_tf32(attn, ci, w2, ci, out, c, m, c, ci, plan.out,
                        bias=bo if residual else None, res=x if residual else None,
                        ldr=c if residual else 0)
    return out


def _launch(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, route, residual=True):
    """The sublayer on x's device by route ("auto": by dtype and plan;
    "wmma": the WMMA kernels whatever the dtype). Returns (out, route
    taken)."""
    b, s, c = x.shape
    sk = kt.shape[2]
    if key_valid is not None and tuple(key_valid.shape) != (b, sk):
        raise ValueError(f"key_valid {tuple(key_valid.shape)} does not fit [{b}, {sk}]")
    if tuple(wq.shape) != (c, kt.shape[1]) or tuple(wo.shape) != (kt.shape[1], c):
        raise ValueError(f"wq {tuple(wq.shape)} / wo {tuple(wo.shape)} do not fit C={c} and "
                         f"keys {tuple(kt.shape)}")
    plan = None
    if route == "auto":
        plan = route_plan(x.dtype, b, s, c, n_head, sk, key_valid is not None, wq.shape[1])
    with torch.cuda.device(x.device):
        if plan is None:
            return _launch_wmma(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head,
                                eps, residual), "wmma"
        if isinstance(plan, Tf32Plan):
            return _launch_tf32(x, _rows(kt.transpose(1, 2)), _rows(vt.transpose(1, 2)), ln_g,
                                ln_b, wq, wo, bo, key_valid, n_head, eps, plan,
                                residual), "tf32"
        return _launch_sm90(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps,
                            plan, residual), "sm90"


def fused_cross_attention_kv(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid=None,
                             n_head: int = 8, eps: float = 1e-5, residual: bool = True):
    """x: [B, S, C] -> x + out_proj(attn(LN(x) Wq, K, V)). kt/vt: [B, Ci, Sk],
    the context's keys and values projected and transposed (sdtpu's
    layout; a transposed view is read as it is); key_valid: optional bool
    [B, Sk] of real keys (padded keys get a -1e30 score bias); wq: [C, Ci],
    wo: [Ci, C]; bo: [C]. Ci is C, or a tensor-parallel rank's C / tp (its
    n_head local heads); residual=False leaves x and bo out of the epilogue
    (every tp rank but one: the ranks' outputs are then summed). Scores use
    d_head^-1/2. CPU tensors take the plain version; CUDA tensors the
    kernels (see the module's routes)."""
    return _cross_attention_kv(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps,
                               "auto", residual)


def _cross_attention_kv(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, route,
                        residual: bool = True):
    """fused_cross_attention_kv on the given route: "auto" (by dtype and
    plan) or "wmma" (the WMMA kernels whatever the dtype, for timing the two
    routes against each other)."""
    if kernels.on_cpu(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid):
        return fused_cross_attention_kv_plain(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid,
                                              n_head, eps, residual)
    kernels.refuse_autograd("fused_cross_attention_kv (K10)", x, kt, vt, ln_g, ln_b, wq, wo,
                            bo)
    ci = wq.shape[1]
    _check_shapes("fused_cross_attention_kv", x, kt.shape, n_head, ci)
    if vt.shape != kt.shape:
        raise ValueError(f"kt {tuple(kt.shape)} and vt {tuple(vt.shape)} differ")
    x = x.contiguous()
    out, taken = _launch(x, kt.to(x.dtype), vt.to(x.dtype), ln_g, ln_b, wq, wo, bo, key_valid,
                         n_head, eps, route, residual)
    b, s, c = x.shape
    kernels.count(fused_cross_attention_kv, b=b, s=s, c=c, **local_dims(ci, c, residual),
                  sk=kt.shape[2], heads=n_head, route=taken)
    return out


def fused_cross_attention(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid=None,
                          n_head: int = 8, eps: float = 1e-5):
    """x: [B, S, C]; context: [B, Sk, Dc] -> x + out_proj(attn), K and V
    projected from the context here (wk, wv: [Dc, C]; on the products of
    the sublayer's route: csrc/gemm_sm90.cu in bf16, csrc/gemm_tf32_sm90.cu
    in float32 on the weights' K-major copies, the shared GEMM otherwise).
    Otherwise as fused_cross_attention_kv."""
    return _cross_attention(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid, n_head,
                            eps, "auto")


def _cross_attention(x, context, ln_g, ln_b, wq, wk, wv, wo, bo, key_valid, n_head, eps,
                     route):
    """fused_cross_attention on the given route (see _cross_attention_kv)."""
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
    # [B, Sk, 2C]: the keys and the values of every head side by side, on the
    # products of the sublayer's route
    kv = torch.empty((b, sk, 2 * c), dtype=dt, device=x.device)
    tf32 = route == "auto" and isinstance(
        route_plan(dt, b, s, c, n_head, sk, key_valid is not None), Tf32Plan)
    with torch.cuda.device(x.device):
        for i, w in enumerate((wk, wv)):
            out = kv[..., i * c:]
            if tf32:
                fused_mlp.gemm_tf32(ctx, dc, fused_mlp.kmajor(w.float()), dc, out, 2 * c,
                                    b * sk, c, dc, fused_mlp.tf32_plan(b * sk, c, dc, False))
            elif dt == torch.bfloat16 and route == "auto":
                p = fused_mlp.sm90_plan(b * sk, c, dc, False)
                w = w.to(dt).contiguous()
                kernels.check(kernels.lib().sdk_gemm_sm90(
                    ctx.data_ptr(), dc, w.data_ptr(), c, None, None, None, None, None, 0,
                    out.data_ptr(), 2 * c, b * sk, c, dc, 0, p.bn, p.stages, p.smem,
                    kernels.stream(x)), "sdk_gemm_sm90 (K/V)")
            else:
                kernels.gemm(ctx, w.to(dt).contiguous(), out, M=b * sk, N=c, K=dc, lda=dc,
                             ldw=c, ldo=2 * c)
    kt, vt = kv[..., :c].transpose(1, 2), kv[..., c:].transpose(1, 2)
    out, taken = _launch(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, eps, route)
    kernels.count(fused_cross_attention, b=b, s=s, c=c, sk=sk, heads=n_head, route=taken)
    return out


fused_cross_attention_kv.launches = 0
fused_cross_attention_kv.shapes = {}
fused_cross_attention.launches = 0
fused_cross_attention.shapes = {}
