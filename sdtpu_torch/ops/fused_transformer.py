"""K2: the fused self-attention sublayer x + Wo·attn(LN(x)Wq, LN(x)Wk,
LN(x)Wv) + bo (port of sdtpu/ops/fused_transformer.py:fused_self_attention).

It replaces the Pallas `_kernel` (sdtpu/ops/fused_transformer.py:42, called
at :145) with three launches of hand-written kernels (four on the bf16
route, whose LayerNorm takes its row statistics from a pre-pass):

1. a GEMM with a LayerNorm prologue computes LN(x)·[Wq | Wk | Wv] into one
   [B, S, 3C] buffer — LN(x) itself never reaches HBM; the concatenated
   weight is built once per model (sdtpu_torch.models.unet.fuse_qkv), not
   on each call;
2. the attention core reads q, k, v per head straight from that buffer and
   writes the heads merged as [B, S, C] — no split/merge transposes, no
   [S, S] score matrix in HBM;
3. a GEMM computes o·Wo + bo + x, bias and residual in the f32 epilogue.

Routes, chosen by dtype and plan: bf16 at the head widths the Hopper core
has an instance for (padded to 48, 64, 80 or 160; sm90_plan) takes
csrc/gemm_sm90.cu for both products (K5's TMA-ring wgmma GEMM, its
LayerNorm prologue and its bias and residual epilogue) and
csrc/attention_sm90.cu for the core (wgmma, the online softmax in
registers). float32 at d = 40, 64, 80 or 160 with S a multiple of 8
(tf32_plan) takes the TF32 kernels: csrc/gemm_tf32_sm90.cu for both
products (K5's float32 GEMM, which reads the weights' K-major copies,
fused_mlp.kmajor), whose QKV epilogue writes q | k as [B, S, 2C] and V
transposed per head, [B, H, d, S] with each group of 8 keys in the order
the core's P fragments hold them, and csrc/attention_tf32_sm90.cu for the
core (P·V reads that V K-major, as TF32 wgmma must): route "tf32". Other
widths, in either dtype, take the WMMA kernels,
csrc/gemm.cu and csrc/attention.cu (route "wmma", also for timing). Each
launch is counted under its route.

What bounds it on the H100: the attention core, 4·S²·C flops per image,
compute-bound at every UNet level; the projections, 8·S·C² flops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops import fused_mlp
from sdtpu_torch.ops.attention import qkv_attention_plain
from sdtpu_torch.ops.conv import linear
# the Hopper cores' plans, shared with K1's routes (bf16 and float32)
from sdtpu_torch.ops.flash_attention import (CorePlan, Tf32CorePlan, core_sm90_plan,
                                             tf32_core_plan)
from sdtpu_torch.ops.groupnorm import layer_norm

MAX_HEAD_DIM = 160  # shared-memory bound of csrc/attention.cu

class Sm90Plan(NamedTuple):
    """K2's bf16 route: the QKV product (LayerNorm prologue, N = 3C, no
    bias), the core, and the Wo product (bias and residual)."""
    qkv: fused_mlp.Sm90Plan
    core: CorePlan
    out: fused_mlp.Sm90Plan


def sm90_plan(b: int, s: int, c: int, n_head: int, ci: int | None = None) -> Sm90Plan | None:
    """The bf16 route's plans for x [b, s, c] with n_head heads over an
    inner width ci (C, or a tensor-parallel rank's C / tp), or None where
    the Hopper kernels have no tile for it (the WMMA route takes it): a
    head width without a core instance, or a LayerNorm wider than the
    GEMM's prologue takes."""
    ci = c if ci is None else ci
    d = ci // n_head
    core = core_sm90_plan(d) if d * n_head == ci else None
    if core is None or c % 8 or ci % 8 or c > fused_mlp.SM90_LN_MAX_K:
        return None
    m = b * s
    return Sm90Plan(fused_mlp.sm90_plan(m, 3 * ci, c, False, ln=True), core,
                    fused_mlp.sm90_plan(m, c, ci, False))


class Tf32Plan(NamedTuple):
    """K2's float32 route: the QKV product (LayerNorm prologue, N = 3C, q | k
    to [B, S, 2C] and V transposed), the core, and the Wo product (bias and
    residual)."""
    qkv: fused_mlp.Tf32Plan
    core: Tf32CorePlan
    out: fused_mlp.Tf32Plan


def tf32_plan(b: int, s: int, c: int, n_head: int, ci: int | None = None) -> Tf32Plan | None:
    """The float32 route's plans for x [b, s, c] with n_head heads over an
    inner width ci (C, or a tensor-parallel rank's C / tp), or None where
    the TF32 kernels have no plan (the WMMA route takes it): a head
    width without a core instance, S not a multiple of 8 (V's transposed
    copy keeps groups of 8 keys), or a LayerNorm wider than the GEMM's
    prologue takes."""
    ci = c if ci is None else ci
    d = ci // n_head
    core = tf32_core_plan(d) if d * n_head == ci else None
    if core is None or s % 8 or c % 8 or ci % 8 or c > fused_mlp.TF32_LN_MAX_K:
        return None
    m = b * s
    return Tf32Plan(fused_mlp.tf32_plan(m, 3 * ci, c, False, ln=True), core,
                    fused_mlp.tf32_plan(m, c, ci, False))


def fused_self_attention_plain(x, ln_g, ln_b, wqkv, wo, bo,
                               n_head: int, eps: float = 1e-5, residual: bool = True):
    """The unfused composition sdtpu's oracle tests hold the kernel to
    (without residual: o·Wo alone, a tensor-parallel rank's partial sum)."""
    xn = layer_norm(x, ln_g, ln_b, eps)
    q, k, v = linear({"w": wqkv}, xn).chunk(3, dim=-1)
    o = qkv_attention_plain(q, k, v, None, n_head)
    if not residual:
        return linear({"w": wo}, o)
    return x + linear({"w": wo, "b": bo}, o)


def attention_core_sm90(qkv, out, n_head: int, plan: CorePlan) -> None:
    """softmax(q kᵀ · d^-1/2) v of every head of the [B, S, 3C] buffer
    (q | k | v) into out [B, S, C] (heads merged), on csrc/attention_sm90.cu.
    The core reads each head through (batch, head, row) strides."""
    b, s, c3 = qkv.shape
    c = c3 // 3  # the inner width
    d = c // n_head
    rc = kernels.lib().sdk_attention_sm90(
        qkv.data_ptr(), qkv[..., c:].data_ptr(), qkv[..., 2 * c:].data_ptr(), out.data_ptr(),
        s * c3, d, c3, s * c3, d, c3, s * c3, d, c3, s * c, d, c, None, 0, None,
        b * n_head, n_head, s, s, d, float(d) ** -0.5, *plan, kernels.stream(qkv))
    kernels.check(rc, "sdk_attention_sm90")


def _attend_sm90(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, plan: Sm90Plan, out, residual):
    """The bf16 route. γ, β, the weights and bo are read in x's dtype
    (.to and .contiguous return the tensors themselves when they already
    are: no copy a call)."""
    b, s, c = x.shape
    ci = wqkv.shape[1] // 3
    dt = x.dtype
    m = b * s
    ln_g, ln_b, wqkv, wo, bo = (t.to(dt).contiguous() for t in (ln_g, ln_b, wqkv, wo, bo))
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, s, 3 * ci), dtype=dt, device=x.device)
    attn = torch.empty((b, s, ci), dtype=dt, device=x.device)
    lib, st = kernels.lib(), kernels.stream(x)
    p1, p2 = plan.qkv, plan.out
    kernels.check(lib.sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, eps, st),
                  "sdk_row_stats")
    kernels.check(lib.sdk_gemm_sm90(
        x.data_ptr(), c, wqkv.data_ptr(), 3 * ci, None, ln_g.data_ptr(), ln_b.data_ptr(),
        stats.data_ptr(), None, 0, qkv.data_ptr(), 3 * ci, m, 3 * ci, c, 0,
        p1.bn, p1.stages, p1.smem, st), "sdk_gemm_sm90 (LayerNorm, QKV)")
    attention_core_sm90(qkv, attn, n_head, plan.core)
    bias, res = (bo.data_ptr(), x.data_ptr()) if residual else (None, None)
    kernels.check(lib.sdk_gemm_sm90(
        attn.data_ptr(), ci, wo.data_ptr(), c, bias, None, None, None, res, c,
        out.data_ptr(), c, m, c, ci, 0, p2.bn, p2.stages, p2.smem, st), "sdk_gemm_sm90 (Wo)")


def attention_core_tf32(qk, vt, out, n_head: int, plan: Tf32CorePlan) -> None:
    """softmax(q kᵀ · d^-1/2) v of every head, q | k from the [B, S, 2C]
    buffer and v from vt [B, H, d, S] (keys in the order
    csrc/gemm_tf32_sm90.cu writes), into out [B, S, C] (heads merged), on
    csrc/attention_tf32_sm90.cu."""
    b, s, c2 = qk.shape
    c = c2 // 2
    d = c // n_head
    rc = kernels.lib().sdk_flash_attention_tf32(
        qk.data_ptr(), qk[..., c:].data_ptr(), vt.data_ptr(), out.data_ptr(),
        s * c2, d, c2, s * c2, d, c2, n_head * d * s, d * s, s, s * c, d, c,
        None, 0, None, b * n_head, n_head, s, s, d, float(d) ** -0.5, 1, *plan,
        kernels.stream(qk))
    kernels.check(rc, "sdk_flash_attention_tf32")


def _attend_tf32(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, plan: Tf32Plan, out, residual):
    """The float32 route: the f32 row statistics, the QKV product (q | k
    and V transposed, rounded to TF32), the core, the Wo product."""
    b, s, c = x.shape
    ci = wqkv.shape[1] // 3
    d = ci // n_head
    m = b * s
    ln_g, ln_b, bo = (t.float().contiguous() for t in (ln_g, ln_b, bo))
    # kmajor keys its copies by the weight tensor itself: handed the model's
    # own (f32) tensors, not per-call copies
    wqkv, wo = wqkv.float(), wo.float()
    w1, w2 = fused_mlp.kmajor(wqkv), fused_mlp.kmajor(wo)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    qk = torch.empty((b, s, 2 * ci), dtype=torch.float32, device=x.device)
    vt = torch.empty((b, n_head, d, s), dtype=torch.float32, device=x.device)
    attn = torch.empty((b, s, ci), dtype=torch.float32, device=x.device)
    fused_mlp.row_stats_f32(x, stats, m, c, eps)
    fused_mlp.gemm_tf32(x, c, w1, c, qk, 2 * ci, m, 3 * ci, c, plan.qkv, gamma=ln_g,
                        beta=ln_b, stats=stats, round_out=True, vt=vt, vt_col=2 * ci, vt_s=s,
                        vt_d=d, vt_h=n_head)
    attention_core_tf32(qk, vt, attn, n_head, plan.core)
    fused_mlp.gemm_tf32(attn, ci, w2, ci, out, c, m, c, ci, plan.out,
                        bias=bo if residual else None, res=x if residual else None,
                        ldr=c if residual else 0)


def _attend_wmma(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, out, residual):
    """The f32 route (and the bf16 widths without a Hopper instance): the
    WMMA GEMM (csrc/gemm.cu), which takes f32 LayerNorm parameters and
    biases, and csrc/attention.cu."""
    b, s, c = x.shape
    ci = wqkv.shape[1] // 3
    dt = x.dtype
    m = b * s
    qkv = torch.empty((b, s, 3 * ci), dtype=dt, device=x.device)
    attn = torch.empty((b, s, ci), dtype=dt, device=x.device)
    kernels.gemm(x, wqkv.to(dt).contiguous(), qkv, M=m, N=3 * ci, K=c, lda=c, ldw=3 * ci,
                 ldo=3 * ci, pa=ln_g.float().contiguous(), pb=ln_b.float().contiguous(),
                 prologue=kernels.PRO_LAYERNORM, eps=eps)
    rc = kernels.lib().sdk_attention(
        kernels.dtype_code(x), qkv.data_ptr(), attn.data_ptr(), b, s, ci,
        n_head, float(ci // n_head) ** -0.5, kernels.stream(x))
    kernels.check(rc, "sdk_attention")
    bias, res = (bo.float().contiguous(), x) if residual else (None, None)
    kernels.gemm(attn, wo.to(dt).contiguous(), out, M=m, N=c, K=ci, lda=ci,
                 ldw=c, ldo=c, bias=bias, res=res, ldr=c if residual else 0)


def fused_self_attention(x, ln_g, ln_b, wqkv, wo, bo,
                         n_head: int, eps: float = 1e-5, residual: bool = True):
    """x: [B, S, C] -> x + out_proj(attn(LN(x))). wqkv: [C, 3Ci], sdtpu's
    wq | wk | wv side by side (no q/k/v bias; see
    sdtpu_torch.models.unet.fuse_qkv), over n_head heads of Ci / n_head; wo:
    [Ci, C]; bo: [C]. Ci is C, or a tensor-parallel rank's C / tp (its
    local heads, [q_r | k_r | v_r]); residual=False leaves x and bo out of
    the epilogue (every tp rank but one: the ranks' outputs are then summed).
    Scores use d_head^-1/2, the same as the reference's dual d_head^-1/4.
    CPU tensors take the plain version; CUDA tensors the kernels (see the
    module's routes)."""
    return _self_attention(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, "auto", residual)


def _self_attention(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, route: str,
                    residual: bool = True):
    """fused_self_attention on the given route: "auto" (by dtype and plan),
    "wmma" (csrc/gemm.cu and csrc/attention.cu whatever the dtype), or, in
    float32, "tf32" (the TF32 kernels; raises where they have no plan): for
    timing the routes against each other."""
    if kernels.on_cpu(x, ln_g, ln_b, wqkv, wo, bo):
        return fused_self_attention_plain(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, residual)
    kernels.refuse_autograd("fused_self_attention (K2)", x, ln_g, ln_b, wqkv, wo, bo)
    b, s, c = x.shape
    ci = wqkv.shape[1] // 3
    d_head = ci // n_head
    if d_head * n_head != ci or d_head > MAX_HEAD_DIM or d_head % 8:
        raise ValueError(f"Ci={ci} with {n_head} heads: the kernel takes "
                         f"d_head = Ci / n_head <= {MAX_HEAD_DIM}, a multiple of 8")
    if tuple(wqkv.shape) != (c, 3 * ci) or tuple(wo.shape) != (ci, c):
        raise ValueError(f"wqkv {tuple(wqkv.shape)} / wo {tuple(wo.shape)} do not fit C={c}")
    plan = route_plan(x.dtype, b, s, c, n_head, ci, route)
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if plan is None:
            _attend_wmma(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, out, residual)
            taken = "wmma"
        elif isinstance(plan, Tf32Plan):
            _attend_tf32(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, plan, out, residual)
            taken = "tf32"
        else:
            _attend_sm90(x, ln_g, ln_b, wqkv, wo, bo, n_head, eps, plan, out, residual)
            taken = "sm90"
    kernels.count(fused_self_attention, b=b, s=s, c=c, **local_dims(ci, c, residual),
                  heads=n_head, route=taken)
    return out


def route_plan(dtype, b: int, s: int, c: int, n_head: int, ci: int | None = None,
               route: str = "auto"):
    """The plan a launch takes: "auto" takes sm90_plan's for bf16 and
    tf32_plan's for float32, None (the WMMA route) where that has none;
    "wmma" is None; "tf32" takes tf32_plan's, float32 only, and raises where
    it has none."""
    if route == "tf32":
        if dtype != torch.float32:
            raise ValueError(f"route {route!r} takes float32, got {dtype}")
        plan = tf32_plan(b, s, c, n_head, ci)
        if plan is None:
            raise ValueError(f"route {route!r} has no plan for S={s} C={c} Ci={ci} "
                             f"heads={n_head}")
        return plan
    if route == "wmma":
        return None
    if route != "auto":
        raise ValueError(f"unknown route {route!r}")
    if dtype == torch.bfloat16:
        return sm90_plan(b, s, c, n_head, ci)
    return tf32_plan(b, s, c, n_head, ci) if dtype == torch.float32 else None


def vt_order(v: torch.Tensor, n_head: int) -> torch.Tensor:
    """v [B, S, C] as the float32 route's QKV product writes it for the
    core: [B, H, d, S], each group of 8 keys in the order 0, 2, 4, 6, 1, 3,
    5, 7 (S a multiple of 8). The plain form of that epilogue's layout, for
    the tests."""
    b, s, c = v.shape
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    order = (torch.arange(s).view(-1, 8)[:, perm]).reshape(-1)
    return v.view(b, s, n_head, c // n_head).permute(0, 2, 3, 1)[..., order].contiguous()


def local_dims(ci: int, c: int, residual: bool) -> dict:
    """The shape-key entries of a tensor-parallel launch: the inner width
    where it is not C, and residual=False where the epilogue adds none
    (empty for a whole launch, whose keys stay as they were)."""
    return {**({"ci": ci} if ci != c else {}), **({} if residual else {"residual": False})}


fused_self_attention.launches = 0
fused_self_attention.shapes = {}
