"""K5: the fused GEGLU-MLP sublayer x + W_lin·(val·gelu_erf(gate)) + b_lin
with [val | gate] = LN(x)·W_proj + b_proj (port of
sdtpu/ops/fused_mlp.py:fused_geglu_mlp).

It replaces the Pallas `_kernel` (sdtpu/ops/fused_mlp.py:43, called at :87)
with two GEMM launches, the [B, S, 8C] projection never in HBM, only its
[B, S, 4C] product:

1. LN(x)·W_proj with each output tile accumulating its val columns and its
   gate columns (4C apart) side by side, and the GEGLU epilogue
   val·gelu_erf(gate) on the f32 accumulators;
2. a·W_lin + b_lin + x, bias and residual in the f32 epilogue.

The route is chosen by dtype. bf16 takes the Hopper GEMM
(csrc/gemm_sm90.cu: wgmma fed by a TMA ring, the LayerNorm prologue and the
epilogues in registers) after a row-statistics pre-pass; its tile plan
(sm90_plan) is made here and checked by the kernel. float32 takes the TF32
Hopper GEMM (csrc/gemm_tf32_sm90.cu, its plan tf32_plan) after an f32
row-statistics pre-pass (route "tf32"). TF32 wgmma reads B only K-major
and the [K, N] weights are N-major, so the kernel reads a K-major TF32 copy
of each weight, made once per weight tensor and kept while the weight
lives (kmajor). Route "wmma" (csrc/gemm.cu, the WMMA kernel) stays for
timing. Each float32 launch is counted under its route.

What bounds it on the H100: 2·S·C·(8C + 4C) flops against a few S·C
bytes — compute-bound; the design removes the 8C-wide intermediate.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops.activations import geglu
from sdtpu_torch.ops.conv import linear, upsample_phase_weights
from sdtpu_torch.ops.groupnorm import layer_norm

# csrc/gemm_sm90.cu: 128-row tiles (two consumer warpgroups of 64 rows), 64
# deep in K (four wgmma K steps of 16), W in TMA boxes of 64 columns
SM90_BM, SM90_BK, SM90_BOX, SM90_WGMMA_K = 128, 64, 64, 16
MAX_STAGES = 4
SM90_LN_MAX_K = 2048  # the LayerNorm's γ and β staged in shared memory


class Sm90Plan(NamedTuple):
    """One launch of csrc/gemm_sm90.cu: bn output columns a tile (64 or
    128), the W boxes a tile loads (bn / 64, twice that with GEGLU), the
    ring's stages and the dynamic shared memory it takes."""
    bn: int
    w_boxes: int
    stages: int
    smem: int
    grid: tuple


def sm90_plan(m: int, n: int, k: int, geglu: bool, ln: bool | None = None) -> Sm90Plan:
    """The tile plan of one bf16 product [m, k]·[k, n(·2 with GEGLU)] with
    the LayerNorm prologue when ln (by default: the GEGLU product carries
    it). GEGLU tiles are 128 columns wide; other products take 64 where
    128-column tiles would not give half the card's SMs a tile (measured on
    the H100: at M=2048 N=640 K=2560, 128 columns take 0.026 ms and 64
    0.042; at M=512 N=1280, 0.043 and 0.038). Raises on a shape the kernel
    does not take."""
    ln = geglu if ln is None else ln
    if m <= 0 or n <= 0 or k <= 0 or n % 8 or k % 8:
        raise ValueError(f"sdk_gemm_sm90 takes positive n and k that are multiples of 8, "
                         f"got m={m} n={n} k={k}")
    if ln and k > SM90_LN_MAX_K:
        raise ValueError(f"sdk_gemm_sm90's LayerNorm prologue takes k <= {SM90_LN_MAX_K}, "
                         f"got k={k}")
    tiles_m = -(-m // SM90_BM)
    bn = 128 if geglu or tiles_m * -(-n // 128) >= kernels.SM_COUNT // 2 else 64
    w_boxes = bn // SM90_BOX * (2 if geglu else 1)
    stage = SM90_BM * SM90_BK * 2 + w_boxes * SM90_BK * SM90_BOX * 2
    # 1024 bytes to align the ring to the 128-byte swizzle's repeat; a full
    # and an empty mbarrier (8 bytes each) a stage
    stages = min(MAX_STAGES, (kernels.SMEM_LIMIT - 1024) // (stage + 16))
    return Sm90Plan(bn, w_boxes, stages, 1024 + stages * (stage + 16), (-(-n // bn), tiles_m))


# csrc/gemm_tf32_sm90.cu: 32-deep K steps (128-byte boxes of f32), 128-row
# activation tiles, Wᵀ in boxes of 64 rows
TF32_BK, TF32_BM = 32, 128
TF32_MAX_STAGES = 6
TF32_LN_MAX_K = 2048  # the LayerNorm's γ and β staged in shared memory (f32)


class Tf32Plan(NamedTuple):
    """One launch of csrc/gemm_tf32_sm90.cu: bn output columns a tile, the
    ring's stages and the dynamic shared memory it takes."""
    bn: int
    stages: int
    smem: int
    grid: tuple


def tf32_plan(m: int, n: int, k: int, geglu: bool, ln: bool | None = None) -> Tf32Plan:
    """The tile plan of one float32 product [m, k]·[k, n(·2 with GEGLU)]
    with TF32 products, with the LayerNorm prologue when ln (by default:
    the GEGLU product carries it): tiles of 128 rows by 128 columns with
    GEGLU or where 64-column tiles would give more CTAs than the card has
    SMs twice over, else 64 (sm90_plan's rule). The stages fill the shared
    memory beside the LayerNorm's staged γ and β (16 KB), at most
    TF32_MAX_STAGES. Raises on a shape the kernel does not take."""
    ln = geglu if ln is None else ln
    if m <= 0 or n <= 0 or k <= 0 or n % 8 or k % 4:
        raise ValueError(f"sdk_gemm_tf32 takes positive n (a multiple of 8) and k (of 4), "
                         f"got m={m} n={n} k={k}")
    if ln and k > TF32_LN_MAX_K:
        raise ValueError(f"sdk_gemm_tf32's LayerNorm prologue takes k <= {TF32_LN_MAX_K}, "
                         f"got k={k}")
    tiles_m = -(-m // TF32_BM)
    bn = 128 if geglu or tiles_m * -(-n // 128) >= kernels.SM_COUNT // 2 else 64
    stage = TF32_BM * TF32_BK * 4 + bn // 64 * (2 if geglu else 1) * 64 * TF32_BK * 4
    static = 2 * TF32_LN_MAX_K * 4 if ln else 8  # the kernel's γ and β
    stages = min(TF32_MAX_STAGES, (kernels.SMEM_LIMIT - static - 1024) // (stage + 16))
    return Tf32Plan(bn, stages, 1024 + stages * (stage + 16), (-(-n // bn), tiles_m))


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: cvt.rna.tf32.f32), as f32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


# (id(w), layout) -> (a weak reference to w, w's version, its K-major TF32
# copy): one cache for the process, since a weight is shared by every
# pipeline, graph and thread that reads it; each entry goes with its weight
# (the weak reference's callback)
_KMAJOR: dict = {}

# kmajor's layouts: what the copy is of
KMAJOR_LAYOUTS = ("matrix", "stack", "upsample")


def _kmajor_of(w: torch.Tensor, layout: str) -> torch.Tensor:
    n = w.shape[-1]
    if layout == "matrix":
        return w.reshape(-1, n).t()
    if layout == "stack":
        return w.transpose(-1, -2)
    if layout == "upsample":
        return upsample_phase_weights(w).reshape(4, -1, n).transpose(-1, -2)
    raise ValueError(f"kmajor has the layouts {KMAJOR_LAYOUTS}, not {layout!r}")


def kmajor(w: torch.Tensor, layout: str = "matrix") -> torch.Tensor:
    """The K-major TF32 copy of an f32 weight that a float32 route reads as
    its B operand, rounded to TF32, by layout:

    - "matrix": w [K, N] -> Wᵀ [N, K]; an HWIO conv weight [kh, kw, C, N] is
      the [kh·kw·C, N] matrix it is (K tap-major, then the input channels in
      order: K6's x, then x2), -> [N, kh·kw·C];
    - "stack": K7's phase stack [4, 4C, N] (fused_conv.phase_weight_stack)
      -> [4, N, 4C];
    - "upsample": a 3x3 HWIO weight [3, 3, C, N] folded into that stack
      first, -> [4, N, 4C] (K7 handed the weight without its stack).

    Made at a weight's first float32 launch (a graph's eager warm-up,
    before its capture), kept while the weight lives and for as long as it
    is not changed in place: a new weight (LoRA's merge, a new
    tensor-parallel shard, a reloaded model) gets its own copy, and a
    dropped weight's copy goes with it. A copy needed during a CUDA graph's
    capture and not made before raises."""
    key = (id(w), layout)
    hit = _KMAJOR.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("kmajor: a weight's K-major copy is made outside a graph capture "
                           "(the warm-up's eager call makes it)")
    wt = round_tf32(_kmajor_of(w.detach(), layout).contiguous())
    _KMAJOR[key] = (weakref.ref(w, lambda _ref, key=key: _KMAJOR.pop(key, None)),
                    w._version, wt)
    return wt


def kmajor_bytes() -> int:
    """The bytes the live K-major copies take."""
    return sum(e[2].numel() * e[2].element_size() for e in _KMAJOR.values())


def gemm_tf32(a, lda: int, w, ldw: int, out, ldo: int, m: int, n: int, k: int,
              plan: Tf32Plan, *, bias=None, gamma=None, beta=None, stats=None, res=None,
              ldr: int = 0, geglu_off: int = 0, round_out: bool = False, vt=None,
              vt_col: int = 0, vt_s: int = 0, vt_d: int = 0, vt_h: int = 0) -> None:
    """One launch of csrc/gemm_tf32_sm90.cu on the current stream (f32
    tensors; w is Wᵀ [rows][ldw], kmajor's copy). See sdk_gemm_tf32 for the
    arguments."""
    ptr = kernels.ptr
    rc = kernels.lib().sdk_gemm_tf32(
        a.data_ptr(), lda, w.data_ptr(), ldw, ptr(bias), ptr(gamma), ptr(beta), ptr(stats),
        ptr(res), ldr, out.data_ptr(), ldo, m, n, k, geglu_off, int(round_out), ptr(vt),
        vt_col, vt_s, vt_d, vt_h, plan.bn, plan.stages, plan.smem, kernels.stream(a))
    kernels.check(rc, "sdk_gemm_tf32")


def row_stats_f32(x, stats, m: int, k: int, eps: float) -> None:
    """(μ, rstd) of the m rows of x [m, k] f32 into stats [m, 2]
    (csrc/gemm_tf32_sm90.cu's pre-pass)."""
    kernels.check(kernels.lib().sdk_row_stats_f32(x.data_ptr(), k, stats.data_ptr(), m, k, eps,
                                                  kernels.stream(x)), "sdk_row_stats_f32")


def fused_geglu_mlp_plain(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin,
                          eps: float = 1e-5, residual: bool = True):
    """The unfused composition sdtpu's oracle tests hold the kernel to
    (without residual: the product with W_lin alone, a tensor-parallel
    rank's partial sum)."""
    hn = layer_norm(x, ln_g, ln_b, eps)
    val, gate = linear({"w": w_proj, "b": b_proj}, hn).chunk(2, dim=-1)
    if not residual:
        return linear({"w": w_lin}, geglu(val, gate))
    return x + linear({"w": w_lin, "b": b_lin}, geglu(val, gate))


def _check_shapes(x, w_proj, w_lin):
    c = x.shape[-1]
    h = w_lin.shape[0]
    if w_proj.shape[1] != 2 * h or tuple(w_lin.shape) != (h, c) or w_proj.shape[0] != c:
        raise ValueError(f"w_proj {tuple(w_proj.shape)} / w_lin "
                         f"{tuple(w_lin.shape)} do not fit C={c}")


def _mlp_sm90(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps=1e-5, residual=True):
    """The bf16 route: csrc/gemm_sm90.cu. The parameters are read in x's
    dtype; .to and .contiguous return the tensors themselves when they
    already are (no launch)."""
    b, s, c = x.shape
    dt = x.dtype
    m, c4 = b * s, w_lin.shape[0]  # 4C, or a tensor-parallel rank's 4C / tp
    x = x.contiguous()
    ln_g, ln_b, w_proj, b_proj, w_lin, b_lin = (
        t.to(dt).contiguous() for t in (ln_g, ln_b, w_proj, b_proj, w_lin, b_lin))
    p1, p2 = sm90_plan(m, c4, c, True), sm90_plan(m, c, c4, False)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    h = torch.empty((b, s, c4), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    lib = kernels.lib()
    with torch.cuda.device(x.device):
        st = kernels.stream(x)
        kernels.check(lib.sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, eps, st),
                      "sdk_row_stats")
        kernels.check(lib.sdk_gemm_sm90(
            x.data_ptr(), c, w_proj.data_ptr(), 2 * c4, b_proj.data_ptr(), ln_g.data_ptr(),
            ln_b.data_ptr(), stats.data_ptr(), None, 0, h.data_ptr(), c4, m, c4, c, c4,
            p1.bn, p1.stages, p1.smem, st), "sdk_gemm_sm90 (GEGLU)")
        bias, res = (b_lin.data_ptr(), x.data_ptr()) if residual else (None, None)
        kernels.check(lib.sdk_gemm_sm90(
            h.data_ptr(), c4, w_lin.data_ptr(), c, bias, None, None, None,
            res, c, out.data_ptr(), c, m, c, c4, 0, p2.bn, p2.stages, p2.smem, st),
            "sdk_gemm_sm90")
    return out


def _mlp_tf32(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps=1e-5, residual=True):
    """The float32 route: csrc/gemm_tf32_sm90.cu after the f32 row
    statistics, on the weights' K-major copies (kmajor). h is rounded to
    TF32 as it is stored (the second product's operand)."""
    b, s, c = x.shape
    m, c4 = b * s, w_lin.shape[0]
    x = x.contiguous()
    ln_g, ln_b, b_proj, b_lin = (t.float().contiguous() for t in (ln_g, ln_b, b_proj, b_lin))
    # kmajor keys its copies by the weight tensor itself: handed the model's
    # own (f32) tensors, not per-call copies
    w_proj, w_lin = w_proj.float(), w_lin.float()
    p1, p2 = tf32_plan(m, c4, c, True), tf32_plan(m, c, c4, False)
    w1, w2 = kmajor(w_proj), kmajor(w_lin)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    h = torch.empty((b, s, c4), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    row_stats_f32(x, stats, m, c, eps)
    gemm_tf32(x, c, w1, c, h, c4, m, c4, c, p1, bias=b_proj, gamma=ln_g, beta=ln_b,
              stats=stats, geglu_off=c4, round_out=True)
    gemm_tf32(h, c4, w2, c4, out, c, m, c, c4, p2, bias=b_lin if residual else None,
              res=x if residual else None, ldr=c if residual else 0)
    return out


def _mlp_wmma(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps=1e-5, residual=True):
    """The f32 route: two launches of the WMMA GEMM (csrc/gemm.cu), which
    takes f32 biases and LayerNorm parameters (no copies for an f32 model).
    It takes bf16 as well, for timing against the bf16 route."""
    b, s, c = x.shape
    dt = x.dtype
    x = x.contiguous()
    m, c4 = b * s, w_lin.shape[0]
    h = torch.empty((b, s, c4), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernels.gemm(x, w_proj.to(dt).contiguous(), h, M=m, N=c4, K=c, lda=c,
                     ldw=2 * c4, ldo=c4, bias=b_proj.float().contiguous(),
                     pa=ln_g.float().contiguous(), pb=ln_b.float().contiguous(),
                     prologue=kernels.PRO_LAYERNORM, geglu_off=c4, eps=eps)
        bias, res = (b_lin.float().contiguous(), x) if residual else (None, None)
        kernels.gemm(h, w_lin.to(dt).contiguous(), out, M=m, N=c, K=c4, lda=c4,
                     ldw=c, ldo=c, bias=bias, res=res, ldr=c if residual else 0)
    return out


def route_of(dtype, c: int, h: int, route: str = "auto") -> str:
    """The route a launch takes: "auto" is "sm90" for bf16 and "tf32" for
    float32 (every width K5 takes, C and H multiples of 8, has a TF32 plan
    at C <= TF32_LN_MAX_K; wider LayerNorms take "wmma"); "sm90", "tf32" and
    "wmma" are taken as given (sm90 for bf16 only, tf32 for float32 only)."""
    if route == "auto":
        if dtype == torch.bfloat16:
            return "sm90"
        return "tf32" if dtype == torch.float32 and c <= TF32_LN_MAX_K else "wmma"
    if route == "sm90" and dtype != torch.bfloat16 or \
            route == "tf32" and dtype != torch.float32:
        raise ValueError(f"route {route!r} does not take {dtype}")
    if route not in ("sm90", "wmma", "tf32"):
        raise ValueError(f"unknown route {route!r}")
    return route


def fused_geglu_mlp(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin,
                    eps: float = 1e-5, residual: bool = True):
    """x: [B, S, C]; w_proj: [C, 2H] (val | gate), b_proj: [2H];
    w_lin: [H, C], b_lin: [C]. H is 4C, or a tensor-parallel rank's 4C / tp
    ([val_r | gate_r]); residual=False leaves x and b_lin out of the
    epilogue (every tp rank but one: the ranks' outputs are then summed).
    CPU tensors take the plain version; CUDA tensors the kernels (bf16:
    csrc/gemm_sm90.cu, float32: csrc/gemm_tf32_sm90.cu; route_of)."""
    return _fused_geglu_mlp(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps, residual)


def _fused_geglu_mlp(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps=1e-5, residual=True,
                     route: str = "auto"):
    """fused_geglu_mlp on the given route (route_of): "auto", or "wmma" or
    "tf32" for timing the float32 routes against each other.
    bf16 launches are counted under their shape; every other launch under
    its shape and its route."""
    if kernels.on_cpu(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin):
        return fused_geglu_mlp_plain(x, ln_g, ln_b, w_proj, b_proj, w_lin,
                                     b_lin, eps, residual)
    kernels.refuse_autograd("fused_geglu_mlp (K5)", x, ln_g, ln_b, w_proj, b_proj, w_lin,
                            b_lin)
    _check_shapes(x, w_proj, w_lin)
    b, s, c = x.shape
    h = w_lin.shape[0]
    route = route_of(x.dtype, c, h, route)
    with torch.cuda.device(x.device):
        if route == "sm90":
            out = _mlp_sm90(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps, residual)
        elif route == "wmma":
            out = _mlp_wmma(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps, residual)
        else:
            out = _mlp_tf32(x, ln_g, ln_b, w_proj, b_proj, w_lin, b_lin, eps, residual)
    kernels.count(fused_geglu_mlp, b=b, s=s, c=c, **({"h": h} if h != 4 * c else {}),
                  **({} if residual else {"residual": False}),
                  **({} if route == "sm90" else {"route": route}))
    return out


fused_geglu_mlp.launches = 0
fused_geglu_mlp.shapes = {}
