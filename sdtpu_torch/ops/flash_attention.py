"""K1 and K9: blockwise (flash) attention, forward and backward (port of
sdtpu/ops/flash_attention.py: flash_attention_heads, flash_qkv_attention,
flash_attention_bwd_heads and the flash_qkv_attention_diff VJP).

K1, softmax(q kᵀ · d^-1/2 + key_bias) v per (batch·head), f32 statistics,
the output in the input dtype; the same as the reference's dual d^-1/4
scaling of q and k. It replaces the Pallas `_fullk_kernel`,
`_fullk_bias_kernel`, `_flash_kernel` and `_flash_ot_kernel`
(sdtpu/ops/flash_attention.py:320, :332, :390, :408) with an online
softmax over key tiles that never holds the [Sq, Sk] score matrix in HBM,
compute-bound (4·Sq·Sk·d flops). For training it also writes each row's
log-sum-exp. Five routes, chosen by fwd_route, each launch counted under
its own: bf16 at the head widths the Hopper core has an instance for
(padded to 48, 64, 80 or 160: training's d = 40) takes
csrc/attention_sm90.cu, K2's wgmma core with the key bias and the
log-sum-exp ("sm90"); bf16 at d = 512 (the VAE decoder's mid-block
attention on the 1024px and 768px main paths: one head, S = 16384 and
9216) takes csrc/attention_wide_sm90.cu, whose two warpgroups split O by
columns and S by keys ("wide"). float32 (the default dtype of `sample`
and `finetune`) at d = 40, 64, 80 and 160 takes csrc/attention_tf32_sm90.cu,
K2's TF32 wgmma core with the key bias and the log-sum-exp ("tf32");
float32 at d = 512 takes csrc/attention_wide_tf32_sm90.cu, whose two
warpgroups split d and add their partial scores through shared memory
("wide_tf32"). Both float32 kernels read their inputs from one pre-pass
launch (tf32_copies): q and k rounded to TF32 (a descriptor read would
truncate them), and V as a K-major copy (TF32 reads B only K-major: each
head's [d][Sk rounded up to 8], keys in the register fragments' order,
rounded). The other widths take csrc/flash_attention.cu (WMMA, "wmma").

K9, the gradients (dq, dk, dv) of mask-free attention, replaces the Pallas
`_fullk_bwd_kernel` (sdtpu/ops/flash_attention.py:531, called at :613) with
a Δ pre-pass, a dK/dV kernel over key tiles and a dQ kernel over query
tiles, the probabilities rebuilt from K1's row statistics and never held in
HBM. It is compute-bound (5 products of 2·Sq·Sk·d flops). In training it
runs the five SpatialTransformers at the 64² latent level of SD v1.4 at
512px (S = 4096, d = 40). Three routes, chosen by bwd_route: bf16 at the
head widths csrc/flash_attention_bwd_sm90.cu has an instance for (padded to
48, 64, 80 or 160: wgmma products, the softmax gradient in registers, a
cp.async ring; its tile plan is bwd_sm90_plan) takes that kernel; float32
(the default compute dtype of `finetune`) at d = 40, 64, 80 and 160 takes
csrc/flash_attention_bwd_tf32_sm90.cu (TF32 wgmma; TF32 reads B only
K-major, so a pre-pass writes K-major copies of q, dO and k with each group
of 8 positions in the register fragments' order, and folds Δ into its pass;
bwd_tf32_plan); the other widths take csrc/flash_attention_bwd.cu (WMMA).
Each launch is counted under its route.

flash_qkv_attention_diff is the differentiable attention training runs: a
custom op (sdtpu_torch::flash_attention_diff) whose forward is K1 and whose
backward is K9 on CUDA tensors, and the plain versions of both on CPU
tensors. Unlike sdtpu's VJP it has no fallback: a shape K9 does not take
raises. The kernels read and write their tensors through (batch, head, row)
strides, so the heads of [B, S, C] rows need no split or merge transpose.
sdtpu's VMEM block pickers have no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sdtpu_torch import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 512  # what csrc/flash_attention.cu takes
MAX_BWD_HEAD_DIM = 160  # what csrc/flash_attention_bwd.cu takes
LOG2E = 1.0 / math.log(2.0)
# f32 score elements a plain attention (here and ops/attention.py) holds at
# a time (2 GB)
SCORE_BUDGET = 1 << 29


def query_chunks(b: int, h: int, sq: int, sk: int):
    """Query ranges [i, j) over which a plain attention's f32 scores
    [B, H, j - i, Sk] stay within SCORE_BUDGET elements. Each query row is
    independent, so the chunks change no number."""
    step = max(1, SCORE_BUDGET // max(1, b * h * sk))
    return [(i, min(i + step, sq)) for i in range(0, sq, step)]


def _acc(t):
    """The plain versions' accumulation type: f32, or f64 for f64 inputs."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _attend_plain(q, k, v, key_bias, out, lse=None):
    """Plain attention over [B, H, S, d] views (any strides), written into
    out, in query_chunks. The weights are rounded to v's dtype before the
    value product and the sum divides afterwards, as the Pallas kernel
    does. lse: an optional [B, H, Sq] view that takes each row's
    log-sum-exp in the log2 domain, as K1 writes it."""
    b, h, sq, d = q.shape
    acc = _acc(q)
    scale = float(d) ** -0.5
    kt = k.to(acc).transpose(-1, -2)
    vf = v.to(acc)
    bias = None if key_bias is None else key_bias.to(acc)[:, None, None, :]
    for i, j in query_chunks(b, h, sq, k.shape[2]):
        s = torch.matmul(q[:, :, i:j].to(acc), kt).mul_(scale)
        if bias is not None:
            s.add_(bias)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()  # in place: the scores are not needed again
        l = p.sum(dim=-1, keepdim=True)
        out[:, :, i:j] = (torch.matmul(p.to(v.dtype).to(acc), vf) / l).to(out.dtype)
        if lse is not None:
            lse[:, :, i:j] = ((m + torch.log(l)) * LOG2E)[..., 0]
    return out


def _heads4(x, n_head):
    """[BH, S, d] -> the [BH / n_head, n_head, S, d] view."""
    bh, s, d = x.shape
    return x.reshape(bh // n_head, n_head, s, d)


def _split_heads(x, n_head):
    """[B, S, C] -> the [B, n_head, S, C / n_head] view of its heads."""
    b, s, c = x.shape
    return x.view(b, s, n_head, c // n_head).transpose(1, 2)


def _check_layout(d, max_d, group, bad):
    """Shared checks of the kernels' 16-byte tile loads; appends to bad."""
    if d % 8 or d > max_d:
        bad.append(f"d={d} (the kernel takes d <= {max_d}, a multiple of 8)")
    dtype = group[0][1].dtype
    for tname, t in group:
        if t.dtype != dtype:
            bad.append(f"{tname} is {t.dtype}, {group[0][0]} is {dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            bad.append(f"{tname} strides {t.stride()}")
        if t.data_ptr() % 16:
            bad.append(f"{tname} is not 16-byte aligned")


def flash_attention_heads_plain(q, k, v, key_bias=None, n_head: int = 1,
                                return_lse: bool = False):
    """The plain version of flash_attention_heads, in PyTorch ops."""
    out = torch.empty_like(q)
    lse = None
    if return_lse:
        lse = torch.empty((q.shape[0], q.shape[1]), dtype=torch.float32, device=q.device)
    bh, sq, _ = q.shape
    _attend_plain(_heads4(q, n_head), _heads4(k, n_head), _heads4(v, n_head), key_bias,
                  _heads4(out, n_head), None if lse is None else lse.view(bh // n_head, n_head, sq))
    return (out, lse) if return_lse else out


# csrc/attention_sm90.cu: 128 query rows a CTA (two consumer warpgroups of
# 64), head widths padded to these (instances), key tiles of 64 rows; its
# ring runs stages − 2 tiles ahead (tile j's V is read in step j + 1), so it
# takes at least 3
SM90_ATTN_ROWS = 128
SM90_ATTN_DPADS = (48, 64, 80, 160)
SM90_ATTN_TILE = 64
SM90_ATTN_STAGES = 4


class CorePlan(NamedTuple):
    """One launch of csrc/attention_sm90.cu (K2's core, and K1's bf16
    route): the padded head width, the key tiles' rows, the ring's stages
    and the dynamic shared memory."""
    dpad: int
    tile: int
    stages: int
    smem: int


def core_sm90_plan(d: int, bias: bool = False) -> CorePlan | None:
    """The Hopper core's plan for head width d, or None where it has no
    instance: Q (128 rows) resident, and `stages` K and V tiles in the ring,
    with a key bias also the tile's 64 f32 bias values a stage."""
    if d <= 0 or d % 8:
        return None
    dpad = -(-d // 16) * 16
    if dpad not in SM90_ATTN_DPADS:
        return None
    resident = SM90_ATTN_ROWS * dpad * 2
    stage = 2 * SM90_ATTN_TILE * dpad * 2 + (SM90_ATTN_TILE * 4 if bias else 0)
    stages = min(SM90_ATTN_STAGES, (kernels.SMEM_LIMIT - resident) // stage)
    return CorePlan(dpad, SM90_ATTN_TILE, stages, resident + stages * stage)


# csrc/attention_wide_sm90.cu: 64 query rows a CTA (two consumer
# warpgroups, each 256 columns of O and 32 keys of S), head widths padded to
# 512, key tiles of 64 rows, one K and one V buffer, TMA boxes of 64 columns
WIDE_DPAD = 512
WIDE_ROWS = 64
WIDE_TILE = 64
WIDE_WARPGROUPS = 2


class WidePlan(NamedTuple):
    """One launch of csrc/attention_wide_sm90.cu (K1's bf16 route at d =
    512): the padded head width, the key tiles' rows and the dynamic shared
    memory."""
    dpad: int
    tile: int
    smem: int


def wide_sm90_plan(d: int) -> WidePlan | None:
    """The wide kernel's plan for head width d (those that pad to 512), or
    None: Q, one K and one V tile of 64 rows at 512 columns, P (64 x 64
    bf16), the tile's 64 f32 key-bias values, a 64-row f32 statistic a
    warpgroup, three mbarriers and 1024 bytes to align the swizzled boxes."""
    if d <= 0 or d % 8 or -(-d // 16) * 16 != WIDE_DPAD:
        return None
    smem = (1024 + 3 * WIDE_ROWS * WIDE_DPAD * 2 + WIDE_ROWS * WIDE_TILE * 2 + WIDE_TILE * 4
            + WIDE_WARPGROUPS * WIDE_ROWS * 4 + 3 * 8)
    return WidePlan(WIDE_DPAD, WIDE_TILE, smem)


# csrc/attention_tf32_sm90.cu (K2's core, and K1's and K10's float32
# route): the head widths it has an instance for, its 128 query rows a CTA,
# and at most this many stages of key tiles
TF32_CORE_WIDTHS = (40, 64, 80, 160)
TF32_CORE_ROWS, TF32_CORE_MAX_STAGES = 128, 4


class Tf32CorePlan(NamedTuple):
    """One launch of csrc/attention_tf32_sm90.cu: key tiles of `tile` rows,
    the ring's stages, the dynamic shared memory."""
    tile: int
    stages: int
    smem: int


# the key tile of each head width's instance (chosen by device time on the
# H100, where both were built: at d = 40, S = 4096, B = 2, tiles of 32 with
# two CTAs an SM 0.3736 ms, of 64 0.4021; at d = 64, S = 9216, 64 1.9136
# ms, 32 1.9533; PERF.md)
TF32_CORE_TILE = {40: 32, 64: 64, 80: 64, 160: 32}


def tf32_core_plan(d: int) -> Tf32CorePlan | None:
    """The float32 core's plan at head width d, or None where it has no
    instance: Q's 128 rows resident beside `stages` stages of a K tile and a
    Vᵀ tile of f32, TF32_CORE_TILE[d] keys a tile (64 at d = 64 and 80; 32
    at d = 160, where three stages of 64 would not fit, and at d = 40, where
    two CTAs then share an SM). A key bias takes no shared memory (each
    thread reads its keys' values with the tile's scores), so the plan is
    the same with and without one."""
    if d not in TF32_CORE_WIDTHS:
        return None
    tile = TF32_CORE_TILE[d]
    q = TF32_CORE_ROWS * d * 4
    stage = 2 * tile * d * 4
    stages = min(TF32_CORE_MAX_STAGES, (kernels.SMEM_LIMIT - q) // stage)
    return Tf32CorePlan(tile, stages, q + stages * stage) if stages >= 3 else None


# csrc/attention_wide_tf32_sm90.cu: 64 query rows a CTA (two warpgroups,
# each owning half of d in Q, K and O), Q resident, key tiles of 8 in two
# stages (a K and a Vᵀ tile each), and each warpgroup's 64 x 8 partial
# scores to exchange
WIDE_TF32_TILE, WIDE_TF32_STAGES = 8, 2


class WideTf32Plan(NamedTuple):
    """One launch of csrc/attention_wide_tf32_sm90.cu (K1's float32 route
    at d = 512): the padded head width, the key tiles' rows and the dynamic
    shared memory."""
    dpad: int
    tile: int
    smem: int


def wide_tf32_plan(d: int) -> WideTf32Plan | None:
    """The float32 wide kernel's plan for head width d (those that pad to
    512), or None: Q (64 rows of 512 f32, 128 KB), two stages of a K and a
    Vᵀ tile of 8 keys (16 KB each) and the two warpgroups' partial scores
    (4 KB)."""
    if d <= 0 or d % 8 or -(-d // 16) * 16 != WIDE_DPAD:
        return None
    t = WIDE_TF32_TILE
    smem = (WIDE_ROWS * WIDE_DPAD * 4 + WIDE_TF32_STAGES * 2 * t * WIDE_DPAD * 4
            + WIDE_WARPGROUPS * 128 * (t // 2) * 4)
    return WideTf32Plan(WIDE_DPAD, t, smem)


def fwd_route(dtype, d: int, bias: bool
              ) -> CorePlan | WidePlan | Tf32CorePlan | WideTf32Plan | None:
    """K1's route: for bf16 the Hopper core's plan (csrc/attention_sm90.cu)
    at the head widths it has an instance for (d = 40, 64, 80, 160 and the
    others that pad to 48, 64, 80 or 160), the wide kernel's
    (csrc/attention_wide_sm90.cu) at d = 512 (and the widths that pad to
    it); for float32 the TF32 core's (csrc/attention_tf32_sm90.cu) at d =
    40, 64, 80 and 160, the TF32 wide kernel's
    (csrc/attention_wide_tf32_sm90.cu) at the widths that pad to 512; else
    None: the other widths take csrc/flash_attention.cu."""
    if dtype == torch.bfloat16:
        return core_sm90_plan(d, bias) or wide_sm90_plan(d)
    if dtype == torch.float32:
        return tf32_core_plan(d) or wide_tf32_plan(d)
    return None


# the route a plan's launches are counted under
ROUTE_NAMES = {CorePlan: "sm90", WidePlan: "wide", Tf32CorePlan: "tf32",
               WideTf32Plan: "wide_tf32", type(None): "wmma"}


def fwd_plan(dtype, d: int, bias: bool, route: str = "auto"
             ) -> CorePlan | WidePlan | Tf32CorePlan | WideTf32Plan | None:
    """The plan a K1 launch takes on route "auto" (fwd_route) or "wmma"
    (None: the WMMA kernel whatever the dtype, for timing the kernels
    against each other). Raises on any other route."""
    if route == "auto":
        return fwd_route(dtype, d, bias)
    if route == "wmma":
        return None
    raise ValueError(f"flash attention: no route {route!r}")


def tf32_copies(q, k, v):
    """The float32 cores' inputs, in one pre-pass launch
    (sdk_attention_prep_tf32), from [B, H, S, d] views (f32 on the card,
    strides multiples of 4 floats; q or k None to skip it): q and k rounded
    to TF32 into contiguous [B, H, S, d] copies, and v's K-major copy [B·H,
    d, Sk rounded up to 8] that P·V reads as its B operand, each group of 8
    keys in the order 0, 2, 4, 6, 1, 3, 5, 7, rounded, zeros past Sk.
    Returns (q's, k's, v's); allocated here, so that under a graph's capture
    they come from the graph's pool."""
    b, h, sk, d = v.shape
    sq = sk if q is None else q.shape[2]

    def rows(t, n):
        if t is None:
            return None, (None, 0, 0, 0)
        return (torch.empty((b, h, n, d), dtype=torch.float32, device=v.device),
                (t.data_ptr(), *t.stride()[:3]))

    qr, qa = rows(q, sq)
    kr, ka = rows(k, sk)
    vt = torch.empty((b * h, d, -(-sk // 8) * 8), dtype=torch.float32, device=v.device)
    kernels.check(kernels.lib().sdk_attention_prep_tf32(
        *qa, *ka, v.data_ptr(), *v.stride()[:3], kernels.ptr(qr), kernels.ptr(kr),
        vt.data_ptr(), b * h, h, sq, sk, d, kernels.stream(v)), "sdk_attention_prep_tf32")
    return qr, kr, vt


def attend_tf32(q, k, vt, key_bias, out, lse, plan: Tf32CorePlan | WideTf32Plan,
                round_o: bool = False) -> None:
    """One launch of a float32 core over [B, H, S, d] views of q, k and out
    (their own strides), v read from vt (tf32_copies' [B·H, d, Sk8]), q and k
    rounded to TF32 (tf32_copies' copies, or a product's rounded output): the TF32
    core (csrc/attention_tf32_sm90.cu, K1's and K10's) or, on a
    WideTf32Plan, the wide kernel. key_bias: None or an f32 [B, Sk] row;
    lse: None or [B·H, Sq] f32; round_o: o rounded to TF32 as it is stored
    (K10's, which feeds Wo's TF32 product)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sk8 = vt.shape[-1]
    args = (q.data_ptr(), k.data_ptr(), vt.data_ptr(), out.data_ptr(), *q.stride()[:3],
            *k.stride()[:3], h * d * sk8, d * sk8, sk8, *out.stride()[:3],
            kernels.ptr(key_bias), sk, kernels.ptr(lse), b * h, h, sq, sk, d, float(d) ** -0.5)
    if isinstance(plan, WideTf32Plan):
        name = "sdk_attention_wide_tf32"
        rc = kernels.lib().sdk_attention_wide_tf32(*args, *plan, kernels.stream(q))
    else:
        name = "sdk_flash_attention_tf32"
        rc = kernels.lib().sdk_flash_attention_tf32(*args, int(round_o), *plan,
                                                    kernels.stream(q))
    kernels.check(rc, name)


def _attend(q, k, v, key_bias, out, lse=None, route: str = "auto"):
    """Attention over [B, H, S, d] views into out; the plain version for
    CPU tensors, K1 for CUDA tensors. lse: optional [B·H, Sq] f32 that takes
    the rows' log2-domain log-sum-exp. route "wmma" takes the WMMA kernel
    (csrc/flash_attention.cu) whatever the dtype, for timing the kernels
    against each other; "auto" chooses by fwd_route."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    plan = fwd_plan(q.dtype, d, key_bias is not None, route)
    if kernels.on_cpu(q, k, v, key_bias, out, lse):
        return _attend_plain(q, k, v, key_bias, out,
                             None if lse is None else lse.view(b, h, sq))
    bad = []
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d or out.shape != q.shape:
        bad.append(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                   f"{tuple(out.shape)} do not fit")
    _check_layout(d, MAX_HEAD_DIM,
                  [("q", q), ("k", k), ("v", v), ("out", out)], bad)
    if lse is not None and (lse.dtype != torch.float32 or not lse.is_contiguous()
                            or lse.shape != (b * h, sq)):
        bad.append(f"lse {lse.dtype} {tuple(lse.shape)}, not contiguous f32 [{b * h}, {sq}]")
    if bad:
        raise ValueError("flash attention: " + ", ".join(bad))
    if key_bias is not None:
        key_bias = key_bias.float().reshape(b, sk).contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        if plan is None:
            name = "sdk_flash_attention"
            rc = kernels.lib().sdk_flash_attention(
                kernels.dtype_code(q), *ptrs, kernels.ptr(key_bias), kernels.ptr(lse), b * h,
                h, sq, sk, d, float(d) ** -0.5, kernels.stream(q))
        elif isinstance(plan, (Tf32CorePlan, WideTf32Plan)):
            # its two launches check their own return codes
            name, rc = "attend_tf32", 0
            attend_tf32(*tf32_copies(q, k, v), key_bias, out, lse, plan)
        elif isinstance(plan, WidePlan):
            name = "sdk_attention_wide_sm90"
            rc = kernels.lib().sdk_attention_wide_sm90(
                *ptrs, kernels.ptr(key_bias), sk, kernels.ptr(lse), b * h, h, sq, sk, d,
                float(d) ** -0.5, *plan, 0, kernels.stream(q))
        else:
            name = "sdk_attention_sm90"
            rc = kernels.lib().sdk_attention_sm90(
                *ptrs, kernels.ptr(key_bias), sk, kernels.ptr(lse), b * h, h, sq, sk, d,
                float(d) ** -0.5, *plan, kernels.stream(q))
    kernels.check(rc, name)
    kernels.count(flash_attention_heads, b=b, h=h, sq=sq, sk=sk, d=d,
                  bias=key_bias is not None, lse=lse is not None,
                  route=ROUTE_NAMES[type(plan)])
    return out


def flash_attention_heads(q, k, v, key_bias=None, n_head: int = 1, return_lse: bool = False):
    """q: [BH, Sq, D], k/v: [BH, Sk, D], heads flattened into the batch.
    key_bias: optional additive f32 [BH // n_head, Sk] row (0 / -1e30)
    applied to every head of its batch element. Returns [BH, Sq, D] in q's
    dtype, and with return_lse also the rows' log2-domain log-sum-exp
    [BH, Sq] f32 (what K9 takes). CPU tensors take the plain version; CUDA
    tensors the kernel (see fwd_route), which is forward-only: it raises on
    an input that requires grad (flash_qkv_attention_diff is the
    differentiable form)."""
    return _heads(q, k, v, key_bias, n_head, return_lse, "auto")


def _heads(q, k, v, key_bias, n_head, return_lse, route):
    """flash_attention_heads on the given route (see _attend)."""
    if not kernels.on_cpu(q, k, v, key_bias):
        kernels.refuse_autograd("flash_attention_heads (K1)", q, k, v, key_bias)
    out = torch.empty_like(q)
    lse = None
    if return_lse:
        lse = torch.empty((q.shape[0], q.shape[1]), dtype=torch.float32, device=q.device)
    _attend(_heads4(q, n_head), _heads4(k, n_head), _heads4(v, n_head), key_bias,
            _heads4(out, n_head), lse, route)
    return (out, lse) if return_lse else out


flash_attention_heads.launches = 0
flash_attention_heads.shapes = {}


def flash_qkv_attention(q, k, v, n_head: int, key_valid=None):
    """Drop-in for qkv_attention without a mask: q [B, Sq, C], k/v
    [B, Sk, C] with the heads side by side in C -> [B, Sq, C]. key_valid:
    optional bool [B, Sk] marking real keys. Forward-only on CUDA tensors,
    as flash_attention_heads."""
    if not kernels.on_cpu(q, k, v, key_valid):
        kernels.refuse_autograd("flash_qkv_attention (K1)", q, k, v)
    key_bias = None
    if key_valid is not None:
        key_bias = torch.where(key_valid, 0.0, NEG_INF).to(torch.float32)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _attend(_split_heads(q, n_head), _split_heads(k, n_head), _split_heads(v, n_head),
            key_bias, _split_heads(out, n_head))
    return out


# ------------------------------------------------------------ backward (K9)

def _attend_bwd_plain(q, k, v, do, dq, dk, dv):
    """(dq, dk, dv) of mask-free attention over [B, H, S, d] views (any
    strides), written into dq, dk, dv, in query_chunks. The softmax is
    recomputed from the scores and rowsum(dP ∘ P) taken in the accumulation
    type, as sdtpu's _fullk_bwd_kernel does; P and dS are rounded to the
    input dtype before their products."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    acc, dt = _acc(q), q.dtype
    scale = float(d) ** -0.5
    kf, vf = k.to(acc), v.to(acc)
    dkf = torch.zeros((b, h, sk, d), dtype=acc, device=q.device)
    dvf = torch.zeros_like(dkf)
    for i, j in query_chunks(b, h, sq, sk):
        qf, dof = q[:, :, i:j].to(acc), do[:, :, i:j].to(acc)
        # in place where a temporary is not needed again: the CPU tests run
        # this at S = 4096
        pn = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
        pn = pn.sub_(pn.amax(dim=-1, keepdim=True)).exp_()
        pn = pn.div_(pn.sum(dim=-1, keepdim=True))
        dvf += torch.matmul(pn.to(dt).to(acc).transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        rowd = torch.matmul(dp.unsqueeze(-2), pn.unsqueeze(-1)).squeeze(-1)  # rowsum(dP ∘ P)
        ds = dp.sub_(rowd).mul_(pn).mul_(scale).to(dt).to(acc)
        dkf += torch.matmul(ds.transpose(-1, -2), qf)
        dq[:, :, i:j] = torch.matmul(ds, kf).to(dq.dtype)
    dk.copy_(dkf)
    dv.copy_(dvf)


def flash_attention_bwd_heads_plain(q, k, v, do):
    """The plain version of flash_attention_bwd_heads: (dq, dk, dv) of
    mask-free softmax(q kᵀ · d^-1/2) v over [BH, S, d], in f32 (f64 for f64
    inputs), returned in the input dtype."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _attend_bwd_plain(*(_heads4(t, 1) for t in (q, k, v, do, dq, dk, dv)))
    return dq, dk, dv


# csrc/flash_attention_bwd_sm90.cu: 128 resident rows a CTA (two consumer
# warpgroups of 64), head widths padded to these (instances), the walked
# tiles 64 rows (32 at 160, for the registers of dK and dV)
SM90_BWD_ROWS = 128
SM90_BWD_DPADS = (48, 64, 80, 160)
SM90_BWD_STAGES = 3


class BwdPlan(NamedTuple):
    """One launch of csrc/flash_attention_bwd_sm90.cu: the padded head
    width, the walked tiles' rows, the ring's stages and the dynamic shared
    memory of the dK/dV and dQ kernels."""
    dpad: int
    tile: int
    stages: int
    smem_dkdv: int
    smem_dq: int


def bwd_sm90_plan(d: int) -> BwdPlan | None:
    """The Hopper kernel's plan for head width d, or None where it has no
    instance (that width takes the WMMA kernel). Raises on a d no K9 kernel
    takes."""
    if d <= 0 or d % 8 or d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"d={d} (K9 takes d <= {MAX_BWD_HEAD_DIM}, a multiple of 8)")
    dpad = -(-d // 16) * 16
    if dpad not in SM90_BWD_DPADS:
        return None
    tile = 32 if dpad > 128 else 64
    resident = 2 * SM90_BWD_ROWS * dpad * 2
    # dK/dV stage: Q and dO tiles plus the tile's lse2 and Δ (f32); dQ
    # stage: K and V tiles
    dkdv_stage, dq_stage = 2 * tile * dpad * 2 + 2 * tile * 4, 2 * tile * dpad * 2
    stages = SM90_BWD_STAGES
    while resident + stages * dkdv_stage > kernels.SMEM_LIMIT:
        stages -= 1
    return BwdPlan(dpad, tile, stages, resident + stages * dkdv_stage,
                   resident + stages * dq_stage)


# csrc/flash_attention_bwd_tf32_sm90.cu, per head width (no padding: the
# widths are multiples of TF32's K step): (the dK/dV kernel's query tiles,
# its keys a CTA, the dQ kernel's key tiles, its queries a CTA). f32 tiles
# are twice bf16's: the walked tiles are sized so that the ring keeps at
# least two stages beside the resident rows, and at d = 160 both kernels hold
# 64 rows (the dK/dV kernel's two warpgroups split dK from dV).
TF32_BWD_TILES = {40: (64, 128, 64, 128), 64: (32, 128, 64, 128), 80: (32, 128, 64, 128),
                  160: (16, 64, 32, 64)}
TF32_BWD_STAGES = 3


class BwdTf32Plan(NamedTuple):
    """One launch of csrc/flash_attention_bwd_tf32_sm90.cu: the dK/dV
    kernel's query tiles, ring stages and dynamic shared memory, then the dQ
    kernel's key tiles, stages and shared memory."""
    tile_kv: int
    stages_kv: int
    smem_kv: int
    tile_q: int
    stages_q: int
    smem_q: int


def bwd_tf32_plan(d: int) -> BwdTf32Plan | None:
    """The float32 route's plan for head width d, or None where it has no
    instance (d not 40, 64, 80 or 160: the WMMA kernel takes it). The dK/dV
    kernel holds K and V of its keys resident and rings the query tiles'
    q, dO, their K-major copies, lse2 and Δ; the dQ kernel holds q and dO of
    its queries and rings the key tiles' k, v and k's K-major copy; each ring
    as deep as the shared memory holds, at most TF32_BWD_STAGES. Raises on a
    d no K9 kernel takes."""
    if d <= 0 or d % 8 or d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"d={d} (K9 takes d <= {MAX_BWD_HEAD_DIM}, a multiple of 8)")
    if d not in TF32_BWD_TILES:
        return None
    tile_kv, rows_kv, tile_q, rows_q = TF32_BWD_TILES[d]

    def ring(resident, stage):
        stages = min(TF32_BWD_STAGES, (kernels.SMEM_LIMIT - resident) // stage)
        return stages, resident + stages * stage

    stages_kv, smem_kv = ring(2 * rows_kv * d * 4, 4 * tile_kv * d * 4 + 2 * tile_kv * 4)
    stages_q, smem_q = ring(2 * rows_q * d * 4, 3 * tile_q * d * 4)
    return BwdTf32Plan(tile_kv, stages_kv, smem_kv, tile_q, stages_q, smem_q)


def bwd_route(dtype, d: int, route="auto") -> BwdPlan | BwdTf32Plan | None:
    """The plan a K9 launch takes (None: the WMMA kernel,
    csrc/flash_attention_bwd.cu): on route "auto" bf16's bwd_sm90_plan or
    float32's bwd_tf32_plan; "wmma" None whatever the dtype; "tf32" the
    float32 plan, raising where there is none (for timing the kernels
    against each other). Raises on a d no K9 kernel takes."""
    bf16, f32 = bwd_sm90_plan(d), bwd_tf32_plan(d)
    if route == "wmma":
        return None
    if route == "tf32":
        if dtype != torch.float32 or f32 is None:
            raise ValueError(f"K9: no TF32 plan for {dtype} at d={d}")
        return f32
    if route != "auto":
        raise ValueError(f"K9: unknown route {route!r}")
    return bf16 if dtype == torch.bfloat16 else f32 if dtype == torch.float32 else None


# the route a K9 plan's launches are counted under
BWD_ROUTE_NAMES = {BwdPlan: "sm90", BwdTf32Plan: "tf32", type(None): "wmma"}


def _attend_bwd(q, k, v, o, do, lse, dq, dk, dv, route: str = "auto"):
    """Gradients over [B, H, S, d] views into dq, dk, dv: the plain version
    for CPU tensors, K9 for CUDA tensors (o: the forward's output, lse: its
    [B·H, Sq] row statistics from K1). q, o, do and dq must share their
    strides, and k, v, dk and dv theirs. route (bwd_route): "auto" by dtype
    and plan, "wmma" the WMMA kernel whatever the dtype, "tf32" the float32
    route (for timing the kernels against each other)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if kernels.on_cpu(q, k, v, o, do, lse, dq, dk, dv):
        return _attend_bwd_plain(q, k, v, do, dq, dk, dv)
    bad = []
    group = [("q", q), ("o", o), ("do", do), ("dq", dq), ("k", k), ("v", v), ("dk", dk),
             ("dv", dv)]
    _check_layout(d, MAX_BWD_HEAD_DIM, group, bad)
    for side in (group[:4], group[4:]):
        for tname, t in side[1:]:
            if t.stride() != side[0][1].stride():
                bad.append(f"{tname} strides {t.stride()} differ from {side[0][0]}'s "
                           f"{side[0][1].stride()}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.shape != (b * h, sq):
        bad.append(f"lse {lse.dtype} {tuple(lse.shape)}, not contiguous f32 [{b * h}, {sq}]")
    if bad:
        raise ValueError("flash attention backward: " + ", ".join(bad))
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    plan = bwd_route(q.dtype, d, route)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    dims = (*q.stride()[:3], *k.stride()[:3], b * h, h, sq, sk, d, float(d) ** -0.5)
    with torch.cuda.device(q.device):
        if plan is None:
            name = "sdk_flash_attention_bwd"
            rc = kernels.lib().sdk_flash_attention_bwd(kernels.dtype_code(q), *ptrs, *dims,
                                                       kernels.stream(q))
        elif isinstance(plan, BwdTf32Plan):
            # the pre-pass's K-major copies of q, dO and k, each head's
            # sequence rounded up to 8 positions
            name = "sdk_flash_attention_bwd_tf32"
            qt, dot = (torch.empty((b * h, d, -(-sq // 8) * 8), dtype=torch.float32,
                                   device=q.device) for _ in range(2))
            kt = torch.empty((b * h, d, -(-sk // 8) * 8), dtype=torch.float32, device=q.device)
            rc = kernels.lib().sdk_flash_attention_bwd_tf32(
                *ptrs, qt.data_ptr(), dot.data_ptr(), kt.data_ptr(), *dims, *plan,
                kernels.stream(q))
        else:
            name = "sdk_flash_attention_bwd_sm90"
            rc = kernels.lib().sdk_flash_attention_bwd_sm90(*ptrs, *dims, *plan,
                                                            kernels.stream(q))
    kernels.check(rc, name)
    kernels.count(flash_attention_bwd_heads, b=b, h=h, sq=sq, sk=sk, d=d,
                  route=BWD_ROUTE_NAMES[type(plan)])


def flash_attention_bwd_heads(q, k, v, do, o=None, lse=None, n_head: int = 1):
    """Gradients (dq, dk, dv) of mask-free attention with the reference
    d^-1/2 scaling; q/k/v/do: [BH, S, d], heads flattened into the batch
    (n_head of them per batch element: it changes no number, only the
    (batch, heads) under which the launch is counted). Returns them in the
    input dtype. CPU tensors take the plain version, which recomputes the
    softmax. CUDA tensors take the kernel, which needs the forward's output
    o and row statistics lse (flash_attention_heads(..., return_lse=True))
    and raises on a shape it does not take."""
    return _bwd_heads(q, k, v, do, o, lse, n_head, "auto")


def _bwd_heads(q, k, v, do, o, lse, n_head, route):
    """flash_attention_bwd_heads on the given route (see _attend_bwd)."""
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if kernels.on_cpu(q, k, v, do, o, lse):
        _attend_bwd_plain(*(_heads4(t, 1) for t in (q, k, v, do, dq, dk, dv)))
        return dq, dk, dv
    kernels.refuse_autograd("flash_attention_bwd_heads (K9)", q, k, v, do, o)
    if o is None or lse is None:
        raise ValueError("flash attention backward: the kernel takes the forward's o and lse")
    _attend_bwd(*(_heads4(t, n_head) for t in (q, k, v, o.contiguous(), do)), lse,
                *(_heads4(t, n_head) for t in (dq, dk, dv)), route=route)
    return dq, dk, dv


flash_attention_bwd_heads.launches = 0
flash_attention_bwd_heads.shapes = {}


# ------------------------------------------------ the differentiable attention

@torch.library.custom_op("sdtpu_torch::flash_attention_diff", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, int n_head) -> (Tensor, Tensor)")
def _flash_diff(q, k, v, n_head):
    """(o, lse) of mask-free attention over [B, S, C] rows: K1 on CUDA
    tensors, the plain version on CPU tensors."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0] * n_head, q.shape[1]), dtype=torch.float32, device=q.device)
    _attend(_split_heads(q, n_head), _split_heads(k, n_head), _split_heads(v, n_head), None,
            _split_heads(out, n_head), lse)
    return out, lse


@_flash_diff.register_fake
def _(q, k, v, n_head):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0] * n_head, q.shape[1]), dtype=torch.float32))


def _flash_diff_setup(ctx, inputs, output):
    q, k, v, n_head = inputs
    o, lse = output
    ctx.n_head = n_head
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)


def _flash_diff_backward(ctx, do, _):
    q, k, v, o, lse = ctx.saved_tensors
    n = ctx.n_head
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _attend_bwd(*(_split_heads(t, n) for t in (q, k, v, o, do)), lse,
                *(_split_heads(t, n) for t in (dq, dk, dv)))
    return dq, dk, dv, None


_flash_diff.register_autograd(_flash_diff_backward, setup_context=_flash_diff_setup)

# the op a selective checkpoint sees (models/unet.py's remat policies)
FLASH_DIFF_OP = torch.ops.sdtpu_torch.flash_attention_diff.default


def flash_qkv_attention_diff(q, k, v, n_head: int):
    """Differentiable mask-free attention over [B, S, C] rows with the heads
    side by side in C -> [B, Sq, C]. The gradient is taken with respect to
    the unscaled q and k: the reference's dual d^-1/4 scaling folds into
    d^-1/2 inside both kernels. K1 forward and K9 backward on CUDA tensors,
    the plain versions on CPU tensors."""
    return _flash_diff(q, k, v, n_head)[0]
