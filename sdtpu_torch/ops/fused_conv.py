"""Convolutions with a GroupNorm-affine prologue and fused epilogues (port
of sdtpu/ops/fused_conv.py): K4 conv1x1_fused, K6 conv3x3_fused, K7
upsample2x_conv_fused, and their glue gn_scale_bias / stats_scale_bias.

K4, K6 and K7 in f32 run on the shared WMMA GEMM of csrc/gemm.cu, K6 and
K7 as an implicit GEMM over the NHWC map. In bf16 all three run the Hopper
kernel csrc/conv_sm90.cu: an implicit GEMM whose A boxes are TMA loads of a
tensor map over the map (zeros outside it), multiplied by wgmma; their tile
plans are sm90_plan, conv1x1_sm90_plan and upsample_sm90_plan. The design
applies the GroupNorm affine
(+SiLU) to the A tile on its way to the tensor cores (in shared memory on
the WMMA kernel, in registers on the Hopper one), and the bias, residual
and optional per-channel output statistics to the f32 accumulator, so
neither the normalised map nor the pre-residual output reaches HBM, and
the next GroupNorm's statistics cost no read of the map.

- K4 replaces the Pallas `_mm_kernel` (sdtpu/ops/fused_conv.py:406, called
  at :473). At the UNet's proj_in/proj_out (4096 rows x 320 x 320 per
  image) the product is small: one read and one write of the map. Routes:
  bf16 takes csrc/conv_sm90.cu at one tap where conv1x1_sm90_plan has a
  tile (C a multiple of 64, Co of 8: every main-path shape, any row count,
  the last tile's rows past the end neither stored nor counted), with any
  prologue (proj_in's GroupNorm affine without SiLU too); f32 and the other
  shapes the WMMA kernel; each launch is counted under its route.
- K6 replaces `_kernel` / `_conv_part` (sdtpu/ops/fused_conv.py:96/44,
  called at :232): the VAE decoder's ResnetBlock convs, 64x64x512 up to
  1024x1024x128, and the UNet's fused ResBlock at 128x128 latents, 2·9·C·Co
  flops per pixel — compute-bound. No halo tensor: the WMMA kernel's A
  vectors compute their own shifted source pixel, the Hopper kernel's TMA
  boxes are read at the shifted coordinates, zero outside. Its second input
  x2 (the UNet up path's skip) is a second source (pointer, or tensor map)
  for the channels past x's, so the channel concat never reaches HBM and
  the concat's weight is used as it is. Routes: bf16 takes csrc/conv_sm90.cu
  where sm90_plan has a tile for the shape (C and C2 multiples of 64, W a
  multiple or a divisor of 128 or a multiple of 32: every main-path shape,
  SD v2.1's 96- and 192-pixel-wide maps in boxes of 32 x 4 and 64 x 2
  pixels) and the prologue, if
  any, ends in SiLU (as every main-path one does); f32 and the other shapes
  the WMMA kernel; each launch is counted under its route.
- K7 replaces `_up_kernel` (sdtpu/ops/fused_conv.py:276, called at :372):
  conv3x3(nearest2x(x)) as four output phases of 2x2 taps at the input's
  resolution (2.25x fewer flops than the 3x3 over the upsampled map), each
  phase writing its interleaved pixels straight into the output, 2·16·C·Co
  flops per input pixel (compute-bound). Routes: bf16 takes
  csrc/conv_sm90.cu at four taps with the phase in the grid where
  upsample_sm90_plan has a tile (C a multiple of 64, W as K6's: every
  main-path shape); f32 and the other shapes the
  WMMA kernel; each launch is counted under its route. Both read the
  [4, 4C, Co] stack of the phases' folded taps (phase_weight_stack), which
  the pipeline folds once (models/vae.py:upsample_phase_stacks).

sdtpu's options that are TPU layout choices (block_h, block_r, kpack) have
no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops.conv import UPSAMPLE_PHASE_PADS, conv2d, upsample_phase_weights
from sdtpu_torch.ops.fused_groupnorm import channel_partials


def _prologue(scale, bias, silu: bool, b: int, c: int):
    """(prologue code, f32 scale [B, C], f32 bias [B, C]) for the GEMM."""
    if scale is None:
        return kernels.PRO_NONE, None, None
    code = kernels.PRO_AFFINE_SILU if silu else kernels.PRO_AFFINE
    return (code, scale.float().reshape(b, c).contiguous(),
            bias.float().reshape(b, c).contiguous())


def conv1x1_fused_plain(x, w, conv_bias, prologue_scale=None, prologue_bias=None,
                        residual=None, silu: bool = False, emit_stats: bool = False):
    """The plain version of conv1x1_fused: the same math in PyTorch ops."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    co = w.shape[-1]
    xr = x.reshape(b, -1, c)
    if prologue_scale is not None:
        xf = (xr.float() * prologue_scale.float()[:, None, :]
              + prologue_bias.float()[:, None, :])
        if silu:
            xf = xf * torch.sigmoid(xf)
        xr = xf.to(x.dtype)
    acc = torch.matmul(xr, w.to(x.dtype)).float() + conv_bias.float()
    if residual is not None:
        acc = acc + residual.reshape(b, -1, co).float()
    y = acc.to(x.dtype).reshape(shape[:-1] + (co,))
    if emit_stats:
        return y, torch.stack([acc.sum(dim=1), (acc * acc).sum(dim=1)], dim=1)
    return y


def conv1x1_fused(x, w, conv_bias, prologue_scale=None, prologue_bias=None,
                  residual=None, silu: bool = False, emit_stats: bool = False):
    """Pointwise conv (= channel matmul) y = act(x·scale + bias)·W + b
    [+ residual], optionally with the per-channel (sum, sum^2) of the f32 y.

    x: [B, ..., C]; w: [C, Co]; conv_bias: [Co]; prologue scale/bias:
    [B, C] (GroupNorm folded to an affine, see gn_scale_bias); residual:
    x's leading shape with Co channels. Returns y, or (y, stats [B, 2, Co]).
    CPU tensors take the plain version; CUDA tensors the kernel (bf16:
    csrc/conv_sm90.cu at one tap where conv1x1_sm90_plan has a tile for the
    shape; f32 and other shapes: csrc/gemm.cu).
    """
    return _conv1x1(x, w, conv_bias, prologue_scale, prologue_bias, residual, silu,
                    emit_stats, "auto")


# K4's ring: its K is 5 to 10 blocks deep, and a ring of 4 stages of the
# 320-channel tile leaves the L1 too little room for the residual's reads
# (measured on the H100: PERF.md)
SM90_CONV1X1_MAX_STAGES = 3


def conv1x1_sm90_plan(b: int, rows: int, c: int, co: int, prologue: bool,
                      bn: int | None = None, stages: int | None = None) -> ConvPlan | None:
    """The plan of K4's Hopper route, csrc/conv_sm90.cu at one tap, for x
    [b, rows, c] to co channels, or None where it has no tile (the WMMA
    kernel takes it): c must be a multiple of 64 (a K block never straddles
    a 64-channel box) and co of 8. The rows are read as a map one pixel
    wide (h = rows, w = 1: tiles of 128 rows, the last one ragged, TMA's
    zeros past the end and no store there). Tiles are the widest of 320 and
    256 channels that co divides into while the grid has a CTA for at least
    half the SMs (a tile that spans Co runs the prologue once an A element;
    the tiles are short, so a partial last wave costs less than running it
    again for each column tile), else 128; at most
    SM90_CONV1X1_MAX_STAGES stages. bn and stages, when given, override
    the choice (for timing one plan against another)."""
    if rows <= 0:
        return None
    tiles = -(-rows // SM90_CONV_BM)
    if bn is None:
        bn = next((n for n in SM90_CONV_WIDE
                   if co % n == 0 and b * tiles * (co // n) >= kernels.SM_COUNT // 2), 128)
    plan = sm90_plan(b, rows, 1, c, 0, co, prologue, bn, stages)
    if plan is not None and stages is None and plan.stages > SM90_CONV1X1_MAX_STAGES:
        plan = sm90_plan(b, rows, 1, c, 0, co, prologue, bn, SM90_CONV1X1_MAX_STAGES)
    return plan


def _conv1x1(x, w, conv_bias, prologue_scale, prologue_bias, residual, silu, emit_stats,
             route):
    """conv1x1_fused on the given route: "auto" (by dtype and plan), "wmma"
    (csrc/gemm.cu whatever the dtype), or a ConvPlan for csrc/conv_sm90.cu
    at one tap (bf16): the last two for timing kernels and plans against
    each other."""
    if kernels.on_cpu(x, w, conv_bias, prologue_scale, prologue_bias, residual):
        return conv1x1_fused_plain(x, w, conv_bias, prologue_scale,
                                   prologue_bias, residual, silu, emit_stats)
    kernels.refuse_autograd("conv1x1_fused (K4)", x, w, conv_bias, prologue_scale,
                            prologue_bias, residual)
    shape = x.shape
    b, c = shape[0], shape[-1]
    co = w.shape[-1]
    rows = x.numel() // (b * c)
    if tuple(w.shape) != (c, co) or conv_bias.numel() != co:
        raise ValueError(f"weight {tuple(w.shape)} and bias {tuple(conv_bias.shape)} do not "
                         f"fit {c} input channels")
    dt = x.dtype
    plan = route if isinstance(route, ConvPlan) else None
    if dt == torch.bfloat16 and route == "auto":
        plan = conv1x1_sm90_plan(b, rows, c, co, prologue_scale is not None)
    x = x.contiguous()
    w = w.to(dt).contiguous()
    res = None if residual is None else residual.to(dt).reshape(b, rows, co).contiguous()
    # the tables as f32 [B, C] (the tensors themselves when they already are)
    prologue, ps, pb = _prologue(prologue_scale, prologue_bias, silu, b, c)
    out = torch.empty((b, rows, co), dtype=dt, device=x.device)
    stats = None
    with torch.cuda.device(x.device):
        if plan is not None:
            # the weight and bias are read in x's dtype (.to and .contiguous
            # return the tensors themselves when they already are)
            cb = conv_bias.to(dt).contiguous()
            if emit_stats:
                stats = torch.empty((b, plan.grid[1], 2, co), dtype=torch.float32,
                                    device=x.device)
            rc = kernels.lib().sdk_conv1x1_sm90(
                x.data_ptr(), w.data_ptr(), cb.data_ptr(), kernels.ptr(ps), kernels.ptr(pb), c,
                int(silu), kernels.ptr(res), out.data_ptr(), kernels.ptr(stats), b, rows, c,
                co, plan.bn, plan.stages, plan.smem, kernels.stream(x))
            kernels.check(rc, "sdk_conv1x1_sm90")
        else:
            if emit_stats:
                stats = torch.empty((b, kernels.gemm_row_tiles(rows), 2, co),
                                    dtype=torch.float32, device=x.device)
            kernels.gemm(x, w, out, M=rows, N=co, K=c, batch=b, lda=c, a_bs=rows * c,
                         ldw=co, ldo=co, o_bs=rows * co, bias=conv_bias.float().contiguous(),
                         res=res, ldr=co, r_bs=rows * co, pa=ps, pb=pb, prologue=prologue,
                         stats=stats)
    kernels.count(conv1x1_fused, b=b, rows=rows, c=c, co=co, prologue=prologue,
                  residual=res is not None, stats=emit_stats,
                  route="wmma" if plan is None else "sm90")
    y = out.reshape(shape[:-1] + (co,))
    if emit_stats:
        return y, stats.sum(dim=1)
    return y


conv1x1_fused.launches = 0
conv1x1_fused.shapes = {}


def _stats(acc):
    """Per-channel (sum, sum^2) [B, 2, C] of an f32 map [B, ..., C]."""
    a = acc.reshape(acc.shape[0], -1, acc.shape[-1])
    return torch.stack([a.sum(dim=1), (a * a).sum(dim=1)], dim=1)


def _prologue_plain(x, scale, bias, silu: bool):
    if scale is None:
        return x
    xf = x.float() * scale.float()[:, None, None, :] + bias.float()[:, None, None, :]
    if silu:
        xf = xf * torch.sigmoid(xf)
    return xf.to(x.dtype)


def conv3x3_fused_plain(x, w, conv_bias, prologue_scale=None, prologue_bias=None,
                        residual=None, silu: bool = True, emit_stats: bool = False,
                        x2=None, prologue_scale2=None, prologue_bias2=None):
    """The plain version of conv3x3_fused: the same math in PyTorch ops,
    over the materialised concat when x2 is given."""
    xin = _prologue_plain(x, prologue_scale, prologue_bias, silu)
    if x2 is not None:
        xin = torch.cat([xin, _prologue_plain(x2, prologue_scale2, prologue_bias2, silu)],
                        dim=-1)
    acc = conv2d({"w": w}, xin, padding=1).float() + conv_bias.float()
    if residual is not None:
        acc = acc + residual.float()
    y = acc.to(x.dtype)
    return (y, _stats(acc)) if emit_stats else y


# csrc/conv_sm90.cu: 128-pixel tiles (two consumer warpgroups of 64), 64
# deep in K (one tap, 64 channels of x or of x2), the weight in TMA boxes of
# 64 output channels
SM90_CONV_BM, SM90_CONV_BK, SM90_CONV_BOX = 128, 64, 64
SM90_CONV_MAX_STAGES = 4
SM90_CONV_WIDE = (320, 256)  # the tiles wider than 128 channels, widest first
# the narrowest box at a width that is no divisor of 128 (SD v2.1's 96² maps);
# a narrower one (W = 24, an odd W) leaves the shape to the WMMA kernel
SM90_CONV_MIN_BW = 32


class ConvPlan(NamedTuple):
    """One launch of csrc/conv_sm90.cu: bn output channels a tile (128, 256
    or 320), the A box of bw pixels of a row by bh rows (bw·bh = 128), the
    ring's stages, the dynamic shared memory, and the grid (channel tiles,
    pixel tiles an image, images)."""
    bn: int
    bw: int
    bh: int
    stages: int
    smem: int
    grid: tuple


def sm90_plan(b: int, h: int, w: int, c1: int, c2: int, co: int, prologue: bool,
              bn: int | None = None, stages: int | None = None) -> ConvPlan | None:
    """The Hopper kernel's plan for a 3x3 conv of [b, h, w, c1 (+ c2)] to co
    channels, or None where it has no tile for the shape (the WMMA kernel
    takes it): c1 and c2 must be multiples of 64, so that a 64-deep K block
    never straddles a tap or the x/x2 boundary, and co a multiple of 8. The
    A box is bw = gcd(w, 128) pixels by 128 / bw rows, which covers the
    128-pixel tile exactly and w / bw of which cover a row: min(w, 128)
    where w is a multiple or a divisor of 128, 32 x 4 at SD v2.1's 96² and
    64 x 2 at its 192² (768px); at another w a box narrower than
    SM90_CONV_MIN_BW has no plan. Tiles are the widest of
    320 and 256 channels that co divides into while the grid still has a CTA
    for every SM, else 128; bn and stages, when given, override the choice
    (for timing one plan against another)."""
    if (b <= 0 or h <= 0 or w <= 0 or c1 <= 0 or c1 % SM90_CONV_BK or c2 < 0
            or c2 % SM90_CONV_BK or co <= 0 or co % 8):
        return None
    bw = math.gcd(w, SM90_CONV_BM)
    if bw < SM90_CONV_MIN_BW and SM90_CONV_BM % w:
        return None
    bh = SM90_CONV_BM // bw
    tiles = -(-h // bh) * (w // bw)
    if bn is None:
        bn = next((n for n in SM90_CONV_WIDE
                   if co % n == 0 and b * tiles * (co // n) >= kernels.SM_COUNT), 128)
    if bn not in (128, *SM90_CONV_WIDE):
        raise ValueError(f"csrc/conv_sm90.cu has tiles of 128, 256 or 320 channels, not {bn}")
    stage = (SM90_CONV_BM + bn) * SM90_CONV_BK * 2  # the A box and bn / 64 weight boxes
    # 1024 bytes to align the ring to the 128-byte swizzle's repeat; a full
    # and an empty mbarrier (8 bytes each) a stage; an f32 (scale, shift)
    # pair per input channel with a prologue
    table = 8 * (c1 + c2) if prologue else 0
    most = min(SM90_CONV_MAX_STAGES, (kernels.SMEM_LIMIT - 1024 - table) // (stage + 16))
    stages = most if stages is None else stages
    if not 2 <= stages <= most:
        return None
    return ConvPlan(bn, bw, bh, stages, 1024 + stages * (stage + 16) + table,
                    (-(-co // bn), tiles, b))


def conv3x3_fused(x, w, conv_bias, prologue_scale=None, prologue_bias=None,
                  residual=None, silu: bool = True, emit_stats: bool = False,
                  x2=None, prologue_scale2=None, prologue_bias2=None):
    """y = conv3x3(act(x·scale + bias)) + conv_bias [+ residual], zero
    padding 1 applied after the prologue; act is SiLU when silu, and the
    prologue (GroupNorm folded to an affine, see gn_scale_bias) is optional.

    x: [B, H, W, C] NHWC; w: [3, 3, C, Co] HWIO; conv_bias: [Co]; prologue
    scale/bias: [B, C]; residual: [B, H, W, Co]. x2: optional second input
    [B, H, W, C2]; the conv then runs over the implicit channel concat
    [x, x2] with w [3, 3, C + C2, Co], and prologue_scale2/bias2 [B, C2] are
    the x2 slice of the folded GroupNorm. Returns y, or (y, stats [B, 2, Co]
    = per-channel (sum, sum^2) of the f32 y). CPU tensors take the plain
    version; CUDA tensors the kernel (bf16: csrc/conv_sm90.cu where its plan
    has a tile for the shape; f32 and other shapes: csrc/gemm.cu)."""
    return _conv3x3(x, w, conv_bias, prologue_scale, prologue_bias, residual, silu,
                    emit_stats, x2, prologue_scale2, prologue_bias2, "auto")


def _tables(scale, shift):
    """(scale, shift, row pitch) of a pair of [B, C] f32 prologue tables:
    views with a unit column stride and one row pitch (the UNet's
    s1[:, :c1], o1[:, :c1]) are read as they are."""
    scale, shift = scale.float(), shift.float()
    if scale.stride() != shift.stride() or scale.stride(-1) != 1:
        scale, shift = scale.contiguous(), shift.contiguous()
    return scale, shift, scale.stride(0)


def _conv3x3(x, w, conv_bias, prologue_scale, prologue_bias, residual, silu, emit_stats,
             x2, prologue_scale2, prologue_bias2, route: str):
    """conv3x3_fused on the given route: "auto" (by dtype and plan), "wmma"
    (csrc/gemm.cu whatever the dtype), or a ConvPlan for csrc/conv_sm90.cu
    (bf16): the last two for timing kernels and plans against each other."""
    if x2 is not None and (prologue_scale is None) != (prologue_scale2 is None):
        raise ValueError("with x2, a prologue applies to both inputs or to neither")
    if kernels.on_cpu(x, w, conv_bias, prologue_scale, prologue_bias, residual, x2,
                      prologue_scale2, prologue_bias2):
        return conv3x3_fused_plain(x, w, conv_bias, prologue_scale, prologue_bias,
                                   residual, silu, emit_stats, x2, prologue_scale2,
                                   prologue_bias2)
    kernels.refuse_autograd("conv3x3_fused (K6)", x, w, conv_bias, prologue_scale,
                            prologue_bias, residual, x2, prologue_scale2, prologue_bias2)
    b, h, wd, c = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    co = w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, c + c2):
        raise ValueError(f"weight {tuple(w.shape)} does not fit {c} + {c2} input channels")
    if x2 is not None and tuple(x2.shape[:3]) != (b, h, wd):
        raise ValueError(f"x2 {tuple(x2.shape)} does not fit x {tuple(x.shape)}")
    dt = x.dtype
    plan = route if isinstance(route, ConvPlan) else None
    if dt == torch.bfloat16 and route == "auto" and (prologue_scale is None or silu):
        plan = sm90_plan(b, h, wd, c, c2, co, prologue_scale is not None)
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    res = None if residual is None else residual.to(dt).contiguous()
    out = torch.empty((b, h, wd, co), dtype=dt, device=x.device)
    stats = None
    with torch.cuda.device(x.device):
        if plan is not None:
            # weights, bias and the prologue's tables are read as they are
            # (.to and .contiguous return the tensors themselves when they
            # already are): no copy a call
            tabs, lds = [None] * 4, [0, 0]
            if prologue_scale is not None:
                tabs[0], tabs[1], lds[0] = _tables(prologue_scale, prologue_bias)
                if x2 is not None:
                    tabs[2], tabs[3], lds[1] = _tables(prologue_scale2, prologue_bias2)
            if emit_stats:
                stats = torch.empty((b, plan.grid[1], 2, co), dtype=torch.float32,
                                    device=x.device)
            rc = kernels.lib().sdk_conv3x3_sm90(
                x.data_ptr(), kernels.ptr(x2), w.to(dt).contiguous().data_ptr(),
                conv_bias.to(dt).contiguous().data_ptr(), kernels.ptr(tabs[0]),
                kernels.ptr(tabs[1]), lds[0], kernels.ptr(tabs[2]), kernels.ptr(tabs[3]),
                lds[1], int(silu), kernels.ptr(res), out.data_ptr(), kernels.ptr(stats),
                b, h, wd, c, c2, co, plan.bn, plan.bw, plan.stages, plan.smem,
                kernels.stream(x))
            kernels.check(rc, "sdk_conv3x3_sm90")
            prologue = kernels.PRO_NONE if prologue_scale is None else (
                kernels.PRO_AFFINE_SILU if silu else kernels.PRO_AFFINE)
        else:
            pscale, pbias = prologue_scale, prologue_bias
            if x2 is not None and pscale is not None:
                pscale = torch.cat([pscale.float(), prologue_scale2.float()], dim=-1)
                pbias = torch.cat([pbias.float(), prologue_bias2.float()], dim=-1)
            prologue, ps, pb = _prologue(pscale, pbias, silu, b, c + c2)
            if emit_stats:
                stats = torch.empty((b, kernels.gemm_row_tiles(h * wd), 2, co),
                                    dtype=torch.float32, device=x.device)
            kernels.conv(x, w.to(dt).contiguous(), out, C=c, H=h, W=wd, N=co, batch=b,
                         kw=3, nphase=1, up=1, bias=conv_bias.float().contiguous(),
                         res=res, pa=ps, pb=pb, prologue=prologue, stats=stats, x2=x2, C2=c2)
    kernels.count(conv3x3_fused, b=b, h=h, w=wd, c=c, c2=c2, co=co, prologue=prologue,
                  residual=res is not None, stats=emit_stats,
                  route="wmma" if plan is None else "sm90")
    conv3x3_fused.launches_x2 += x2 is not None
    return (out, stats.sum(dim=1)) if emit_stats else out


conv3x3_fused.launches = 0
conv3x3_fused.shapes = {}
conv3x3_fused.launches_x2 = 0  # the launches among them with a second input


def upsample2x_conv_fused_plain(x, w, conv_bias, emit_stats: bool = False, phases=None):
    """The plain version of upsample2x_conv_fused: four phase convolutions
    with the same folded weights, interleaved. phases is taken for the
    kernel's signature and not read: the folded weights come from w."""
    b, h, wd, _ = x.shape
    co = w.shape[-1]
    wph = upsample_phase_weights(w).to(x.dtype)
    ph = [conv2d({"w": wph[2 * py + px]}, x, padding=UPSAMPLE_PHASE_PADS[(py, px)]).float()
          for py in (0, 1) for px in (0, 1)]
    acc = torch.stack(ph).reshape(2, 2, b, h, wd, co).permute(2, 3, 0, 4, 1, 5)
    acc = acc.reshape(b, 2 * h, 2 * wd, co) + conv_bias.float()
    y = acc.to(x.dtype)
    return (y, _stats(acc)) if emit_stats else y


def upsample_sm90_plan(b: int, h: int, w: int, c: int, co: int, bn: int | None = None,
                       stages: int | None = None) -> ConvPlan | None:
    """The plan of K7's Hopper route, csrc/conv_sm90.cu at four taps, for x
    [b, h, w, c] to co channels, or None where it has no tile (the WMMA
    kernel takes it): sm90_plan's tile of a map with four output phases an
    image, no prologue. Each CTA computes one phase of one 128-pixel tile
    of x, so the grid is (co / bn, tiles, 4·b), and the tile's width
    follows sm90_plan's rule over that grid; c must be a multiple of 64 (the
    box is sm90_plan's, gcd(w, 128) pixels wide). bn and stages, when given, override
    the choice (for timing one plan against another)."""
    return sm90_plan(4 * b, h, w, c, 0, co, False, bn, stages)


def phase_weight_stack(w, dtype):
    """HWIO [3, 3, C, Co] -> the [4, 4·C, Co] stack in dtype that K7's
    kernels read: phase p = 2·py + px's taps (dy, dx) in rows (2·dy + dx)·C
    .., upsample_phase_weights' f32 sums rounded to dtype once."""
    c, co = w.shape[2], w.shape[3]
    return upsample_phase_weights(w).to(dtype).reshape(4, 4 * c, co)


def upsample2x_conv_fused(x, w, conv_bias, emit_stats: bool = False, phases=None):
    """conv3x3(nearest_upsample_2x(x)) + conv_bias without the upsampled
    map: x [B, H, W, C]; w [3, 3, C, Co]; returns [B, 2H, 2W, Co], or (y,
    stats [B, 2, Co]). phases: optional phase_weight_stack(w, x.dtype),
    made once by the caller (the pipeline's VAE), which the kernel then
    reads instead of folding w a call. CPU tensors take the plain
    version; CUDA tensors the kernel (bf16: csrc/conv_sm90.cu at four taps
    where upsample_sm90_plan has a tile for the shape; f32 and other
    shapes: csrc/gemm.cu)."""
    return _upsample2x(x, w, conv_bias, emit_stats, "auto", phases)


def _upsample2x(x, w, conv_bias, emit_stats, route, phases=None):
    """upsample2x_conv_fused on the given route: "auto" (by dtype and plan),
    "wmma" (csrc/gemm.cu whatever the dtype), or a ConvPlan for
    csrc/conv_sm90.cu at four taps (bf16): the last two for timing kernels
    and plans against each other."""
    if kernels.on_cpu(x, w, conv_bias, phases):
        return upsample2x_conv_fused_plain(x, w, conv_bias, emit_stats)
    kernels.refuse_autograd("upsample2x_conv_fused (K7)", x, w, conv_bias)
    b, h, wd, c = x.shape
    co = w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"weight {tuple(w.shape)} does not fit {c} input channels")
    dt = x.dtype
    if phases is None:
        phases = phase_weight_stack(w, dt)
    elif phases.shape != (4, 4 * c, co) or phases.dtype != dt:
        raise ValueError(f"phases {phases.dtype} {tuple(phases.shape)}: expected {dt} "
                         f"[4, {4 * c}, {co}] (phase_weight_stack)")
    wph = phases.contiguous()
    plan = route if isinstance(route, ConvPlan) else None
    if dt == torch.bfloat16 and route == "auto":
        plan = upsample_sm90_plan(b, h, wd, c, co)
    x = x.contiguous()
    out = torch.empty((b, 2 * h, 2 * wd, co), dtype=dt, device=x.device)
    stats = None
    with torch.cuda.device(x.device):
        if plan is not None:
            # the bias is read in x's dtype (.to and .contiguous return the
            # tensor itself when it already is)
            cb = conv_bias.to(dt).contiguous()
            if emit_stats:
                stats = torch.empty((b, 4 * plan.grid[1], 2, co), dtype=torch.float32,
                                    device=x.device)
            rc = kernels.lib().sdk_upsample_conv_sm90(
                x.data_ptr(), wph.data_ptr(), cb.data_ptr(), out.data_ptr(),
                kernels.ptr(stats), b, h, wd, c, co, plan.bn, plan.bw, plan.stages, plan.smem,
                kernels.stream(x))
            kernels.check(rc, "sdk_upsample_conv_sm90")
        else:
            if emit_stats:
                stats = torch.empty((b, 4 * kernels.gemm_row_tiles(h * wd), 2, co),
                                    dtype=torch.float32, device=x.device)
            kernels.conv(x, wph, out, C=c, H=h, W=wd, N=co, batch=b, kw=2, nphase=4,
                         up=2, bias=conv_bias.float().contiguous(), stats=stats)
    kernels.count(upsample2x_conv_fused, b=b, h=h, w=wd, c=c, co=co, stats=emit_stats,
                  route="wmma" if plan is None else "sm90")
    return (out, stats.sum(dim=1)) if emit_stats else out


upsample2x_conv_fused.launches = 0
upsample2x_conv_fused.shapes = {}


def gn_scale_bias(x, gamma, beta, n_group: int, eps: float):
    """Per-(batch, channel) GroupNorm affine from one statistics pass over
    x (K3): returns (scale, bias), each [B, C] f32, with
    group_norm(x) == x * scale + bias."""
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    return stats_scale_bias(channel_partials(x), rows, gamma, beta, n_group, eps)


def stats_scale_bias(sums, rows: int, gamma, beta, n_group: int, eps: float):
    """Fold per-channel (sum, sum^2) [B, 2, C] into the GroupNorm scale and
    bias: one-pass variance E[x^2] - E[x]^2, eps inside the rsqrt."""
    b, _, c = sums.shape
    cpg = c // n_group
    g = sums.reshape(b, 2, n_group, cpg).sum(dim=-1)  # [B, 2, G]
    n = rows * cpg
    mean = g[:, 0] / n
    var = g[:, 1] / n - mean * mean
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(cpg, dim=1)
    mean_c = mean.repeat_interleave(cpg, dim=1)
    scale = inv_c * gamma.float()[None]
    bias = beta.float()[None] - mean_c * scale
    return scale, bias
