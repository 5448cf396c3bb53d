"""The tile plans of the port's Hopper kernels, checked on the CPU.

The bf16 routes of K5 (csrc/gemm_sm90.cu), K9
(csrc/flash_attention_bwd_sm90.cu), K6, K4 and K7 (csrc/conv_sm90.cu), K2
and K10 (csrc/gemm_sm90.cu and csrc/attention_sm90.cu) and K1
(csrc/attention_sm90.cu) take their tile shape, ring stages and
shared-memory bytes from Python (fused_mlp.sm90_plan,
flash_attention.bwd_sm90_plan, fused_conv.sm90_plan, conv1x1_sm90_plan
and upsample_sm90_plan, fused_transformer.sm90_plan,
fused_cross_attention.route_plan, flash_attention.fwd_route and
wide_sm90_plan); K3's csrc/channel_stats_sm90.cu takes its channel block and
cluster from fused_groupnorm.stats_plan; the kernels
check them and run only on the
card. Here, at every main-path shape: the bytes fit the H100's 227 KB a
block, wgmma's constraints hold (64-row groups, N a multiple of 8, K steps
of 16), the GEGLU tiles pair each val column with its gate column 4C to
the right and cover every output column once, and the padded head width is
a multiple of 16 with zeros beyond d. For K6 also TMA's: boxes of at most
256 a dimension, 128 inner bytes for the 128-byte swizzle, boxes that
cover each 128-pixel tile exactly and tiles that cover the map once, and K
blocks that never straddle a tap or the x/x2 boundary; for K4 the same
with tiles of 128 rows inside one image, and for K7 with the four output
phases in the grid. K1's and K10's routes by dtype and shape; K1's wide
kernel's shared memory against its source, and K3's clusters.
"""

import re
from pathlib import Path

import pytest

import numpy as np
import torch

from sdtpu_torch.config import SD_V1_4
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_cross_attention as tfx
from sdtpu_torch.ops import fused_groupnorm as tfg
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.ops import fused_transformer as tft

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block can take (H100)
WGMMA_M, WGMMA_K = 64, 16

# (B, S, C) of K5's launches on the main paths (chip_smoke.py's phase-2
# cases): the 512px UNet at batch 2 and the serve phase's batch 8, the
# 1024px UNet's 32² level
K5_SHAPES = [(2, 1024, 640), (2, 256, 1280), (2, 1024, 1280), (8, 1024, 640), (8, 256, 1280)]
# head widths and sequence lengths K9 runs at in training (512px: S = 4096;
# 1024px: S = 16384) and the 16² level's 160; SD v2.1's 64 at 768px (96²)
K9_SHAPES = [(d, s) for d in (40, 80, 160) for s in (4096, 16384)] + [(64, 9216)]


@pytest.mark.parametrize("product", ["geglu", "residual"])
@pytest.mark.parametrize("b,s,c", K5_SHAPES)
def test_k5_plan(b, s, c, product):
    m = b * s
    geglu = product == "geglu"
    n, k = (4 * c, c) if geglu else (c, 4 * c)
    plan = tfm.sm90_plan(m, n, k, geglu)
    assert plan.smem <= SMEM_LIMIT
    assert plan.stages >= 2
    # two consumer warpgroups of 64 rows; n64 wgmma boxes; K steps of 16
    assert tfm.SM90_BM % WGMMA_M == 0 and tfm.SM90_BM // WGMMA_M == 2
    assert plan.bn % tfm.SM90_BOX == 0 and tfm.SM90_BOX % 8 == 0 and tfm.SM90_BOX <= 256
    assert tfm.SM90_BK % WGMMA_K == 0 and k % 8 == 0
    assert plan.w_boxes == plan.bn // tfm.SM90_BOX * (2 if geglu else 1)
    stage = tfm.SM90_BM * tfm.SM90_BK * 2 + plan.w_boxes * tfm.SM90_BK * tfm.SM90_BOX * 2
    assert plan.smem == 1024 + plan.stages * (stage + 16)
    assert plan.grid[1] * tfm.SM90_BM >= m > (plan.grid[1] - 1) * tfm.SM90_BM
    # the output columns each tile stores, and for GEGLU the W columns it
    # loads: val boxes at n0.., gate boxes 4C to their right
    covered = []
    for i in range(plan.grid[0]):
        n0 = i * plan.bn
        vals = [n0 + bx * tfm.SM90_BOX + j for bx in range(plan.bn // tfm.SM90_BOX)
                for j in range(tfm.SM90_BOX)]
        stored = [v for v in vals if v < n]
        covered += stored
        if geglu:
            gates = [n0 + 4 * c + bx * tfm.SM90_BOX + j for bx in range(plan.bn // tfm.SM90_BOX)
                     for j in range(tfm.SM90_BOX)]
            assert all(gt - v == 4 * c for v, gt in zip(vals, gates))
            assert all(4 * c <= gt < 8 * c for v, gt in zip(vals, gates) if v < n)
    assert sorted(covered) == list(range(n))


def test_k5_plan_raises_on_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 60, 64, False)  # N not a multiple of 8
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 64, 20, False)  # K not a multiple of 8
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 4 * 2056, 2056, True)  # γ and β past shared memory's room


def test_k5_ragged_rows_take_one_more_tile():
    plan = tfm.sm90_plan(2 * 1000 + 8, 4 * 640, 640, True)
    assert plan.grid[1] == -(-2008 // tfm.SM90_BM)


@pytest.mark.parametrize("d,s", K9_SHAPES)
def test_k9_plan(d, s):
    plan = tfa.bwd_sm90_plan(d)
    assert plan is not None
    assert plan.dpad % WGMMA_K == 0 and d <= plan.dpad < d + 16
    assert plan.dpad % 8 == 0 and plan.dpad <= 256  # N of dV, dK, dQ += P·X
    assert tfa.SM90_BWD_ROWS % WGMMA_M == 0 and tfa.SM90_BWD_ROWS // WGMMA_M == 2
    # the walked tile is N of S = Q·K^T and K (in steps of 16) of P^T·dO
    assert plan.tile % WGMMA_K == 0 and plan.tile in (32, 64)
    assert 2 <= plan.stages <= tfa.SM90_BWD_STAGES
    resident = 2 * tfa.SM90_BWD_ROWS * plan.dpad * 2
    assert plan.smem_dkdv == resident + plan.stages * (2 * plan.tile * plan.dpad * 2
                                                       + 2 * plan.tile * 4)
    assert plan.smem_dq == resident + plan.stages * 2 * plan.tile * plan.dpad * 2
    assert max(plan.smem_dkdv, plan.smem_dq) <= SMEM_LIMIT
    # every CTA walks the whole other sequence: tiles of `tile` rows
    assert -(-s // plan.tile) * plan.tile >= s


@pytest.mark.parametrize("d,want", [(8, None), (40, 48), (64, 64), (96, None), (160, 160)])
def test_k9_plan_picks_an_instance_or_the_wmma_kernel(d, want):
    plan = tfa.bwd_sm90_plan(d)
    assert (plan is None) if want is None else plan.dpad == want


@pytest.mark.parametrize("d", [0, 12, 168])
def test_k9_plan_raises_on_widths_no_kernel_takes(d):
    with pytest.raises(ValueError):
        tfa.bwd_sm90_plan(d)


# ------------------------------------------------------------ K6


def _decoder_convs(lat):
    """(hw, c_in, c_out) of each K6 launch of SD v1.4's VAE decoder on a
    lat x lat latent: two mid ResnetBlocks, then three a level (the first
    changes the width), each as conv1 and conv2."""
    chans = SD_V1_4.vae.decoder_channels
    mid = chans[0][0]
    blocks = [(lat, mid, mid)] * 2
    for level, (ci, co) in enumerate(chans):
        blocks += [(lat << level, ci, co)] + [(lat << level, co, co)] * 2
    return [conv for hw, ci, co in blocks for conv in ((hw, ci, co), (hw, co, co))]


def _encoder_resnets(size):
    """(map size, input channels, output channels) of SD's VAE encoder's
    ResnetBlocks (v1.4's and v2.1's are one) on a size x size image."""
    return ((size, 128, 128), (size // 2, 128, 256), (size // 2, 256, 256),
            (size // 4, 256, 512), (size // 4, 512, 512), (size // 8, 512, 512))


# (B, H, W, C1, C2, Co) of K6's launches on the main paths (chip_smoke.py's
# phase-2 cases): the UNet's fused ResBlocks at 128² (1024px, with the
# skip as x2), the decoder at 512px and 1024px and the serve phase's batch
# of 4, the encoder at B=4 (the fine-tuning cache) and B=1 (img2img); SD
# v2.1 at 768px: the decoder on a 96² latent, the encoder at B=2 (its
# fine-tuning cache) and B=1
K6_SHAPES = sorted(
    {(2, 128, 128, 640, 320, 320), (2, 128, 128, 320, 320, 320), (2, 128, 128, 320, 0, 320)}
    | {(b, hw, hw, ci, 0, co) for b, lat in ((1, 64), (1, 128), (4, 64), (1, 96))
       for hw, ci, co in _decoder_convs(lat)}
    | {(b, hw, hw, c, 0, co) for b, size in ((4, 512), (1, 512), (2, 768), (1, 768))
       for hw, ci, co in _encoder_resnets(size) for c in (ci, co)})
TMA_BOX_MAX = 256


@pytest.mark.parametrize("b,h,w,c1,c2,co", K6_SHAPES)
def test_k6_plan(b, h, w, c1, c2, co):
    plan = tfc.sm90_plan(b, h, w, c1, c2, co, True)
    assert plan is not None  # every main-path shape takes the Hopper kernel
    ct = c1 + c2
    assert 2 <= plan.stages <= tfc.SM90_CONV_MAX_STAGES
    stage = tfc.SM90_CONV_BM * tfc.SM90_CONV_BK * 2 + (
        plan.bn // tfc.SM90_CONV_BOX * tfc.SM90_CONV_BK * tfc.SM90_CONV_BOX * 2)
    assert plan.smem == 1024 + plan.stages * (stage + 16) + 8 * ct <= SMEM_LIMIT
    # wgmma: two consumer warpgroups of 64 pixels, n64 boxes, K steps of 16
    assert tfc.SM90_CONV_BM // WGMMA_M == 2 and tfc.SM90_CONV_BM % WGMMA_M == 0
    assert plan.bn in (128, 256, 320) and plan.bn % tfc.SM90_CONV_BOX == 0
    assert tfc.SM90_CONV_BOX % 8 == 0
    assert tfc.SM90_CONV_BK % WGMMA_K == 0
    # TMA: the A box (64 channels, bw, bh, 1) and the W box (64, 64); 64
    # bf16 channels are the 128 bytes the swizzle takes
    assert all(0 < d <= TMA_BOX_MAX for d in (tfc.SM90_CONV_BK, plan.bw, plan.bh,
                                               tfc.SM90_CONV_BOX))
    assert tfc.SM90_CONV_BK * 2 == 128
    assert plan.bw * plan.bh == tfc.SM90_CONV_BM and w % plan.bw == 0
    # the boxes cover each 128-pixel tile exactly, and the tiles the map once
    tiles_w = w // plan.bw
    assert plan.grid == (-(-co // plan.bn), -(-h // plan.bh) * tiles_w, b)
    r = np.arange(tfc.SM90_CONV_BM)
    tile = np.arange(plan.grid[1])[:, None]
    pi, pj = tile // tiles_w * plan.bh + r // plan.bw, tile % tiles_w * plan.bw + r % plan.bw
    if h % plan.bh == 0 and plan.bw == min(w, tfc.SM90_CONV_BM):
        # W a multiple or a divisor of 128: a tile is 128 consecutive pixels
        assert (pi * w + pj == tile * tfc.SM90_CONV_BM + r).all()
    inside = pi < h
    counts = np.bincount((pi * w + pj)[inside], minlength=h * w)
    assert (counts == 1).all() and counts.size == h * w
    # the statistics' row tiles are the WMMA kernel's: ceil(H·W / 128)
    assert plan.grid[1] == -(-h * w // tfc.SM90_CONV_BM)
    # a 64-deep K block lies in one tap, and in x or in x2
    for kb in range(9 * ct // tfc.SM90_CONV_BK):
        c0 = kb * tfc.SM90_CONV_BK % ct
        assert c0 + tfc.SM90_CONV_BK <= ct
        assert c0 + tfc.SM90_CONV_BK <= c1 or c0 >= c1


@pytest.mark.parametrize("b,h,w,c1,c2,co", [
    (1, 8, 8, 40, 0, 64),     # C not a multiple of 64
    (1, 8, 8, 64, 8, 64),     # C2 not a multiple of 64
    (1, 8, 8, 64, 0, 12),     # Co not a multiple of 8
    (1, 8, 24, 64, 0, 64),    # W no divisor of 128 and its box 8 pixels wide
    (1, 8, 33, 64, 0, 64),    # an odd W (a box of 1 pixel)
])
def test_k6_plan_leaves_other_shapes_to_the_wmma_kernel(b, h, w, c1, c2, co):
    assert tfc.sm90_plan(b, h, w, c1, c2, co, True) is None


@pytest.mark.parametrize("w,box", [(64, (64, 2)), (256, (128, 1)), (96, (32, 4)),
                                   (192, (64, 2)), (768, (128, 1)), (16, (16, 8))])
def test_k6_plan_box_is_gcd_of_w_and_128(w, box):
    """The A box is gcd(W, 128) pixels by 128 / that rows: min(W, 128) where
    W is a multiple or a divisor of 128, and for SD v2.1's 96² and 192² maps
    (768px) 32 x 4 and 64 x 2; K7's the same."""
    plan = tfc.sm90_plan(1, 8, w, 64, 0, 64, True)
    assert (plan.bw, plan.bh) == box and plan.grid[1] == -(-8 // box[1]) * (w // box[0])
    assert (tfc.upsample_sm90_plan(1, 8, w, 64, 64).bw,) == box[:1]


def test_k6_plan_overrides():
    plan = tfc.sm90_plan(1, 64, 64, 512, 0, 512, True, bn=256, stages=2)
    assert (plan.bn, plan.stages) == (256, 2)
    with pytest.raises(ValueError):
        tfc.sm90_plan(1, 64, 64, 512, 0, 512, True, bn=192)
    # the UNet's 320-channel convs take one tile of 320 (three stages fit)
    plan = tfc.sm90_plan(2, 128, 128, 640, 320, 320, True)
    assert (plan.bn, plan.stages, plan.grid) == (320, 3, (1, 128, 2))


# ------------------------------------------------------------ K2

# (B, S, C) of K2's launches on the main paths: every UNet level at 512px
# and 1024px at batch 2, the serve phase's batch of 4 (B=8); 8 heads
K2_SHAPES = [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280), (2, 16384, 320), (2, 4096, 640),
             (2, 1024, 1280), (8, 4096, 320), (8, 1024, 640), (8, 256, 1280)]


@pytest.mark.parametrize("b,s,c", K2_SHAPES)
def test_k2_plan(b, s, c):
    _check_k2_plan(b, s, c, 8)


@pytest.mark.parametrize("b,s,c,heads", [(2, 9216, 320, 5), (2, 2304, 640, 10)])
def test_k2_plan_sd_v2_1(b, s, c, heads):
    """SD v2.1 at 768px: 5 heads of 64 at the 96² level, 10 at 48²; the
    fused QKV product's N = 3C (960, 1920) is no multiple of 256."""
    _check_k2_plan(b, s, c, heads)
    assert tft.sm90_plan(b, s, c, heads).core.dpad == 64


def _check_k2_plan(b, s, c, heads):
    plan = tft.sm90_plan(b, s, c, heads)
    assert plan is not None
    d, core = c // heads, plan.core
    # the core: d padded to a multiple of 16 (wgmma's K steps of Q·Kᵀ), the
    # zero-filled columns past d within one 16-byte chunk of the next head's
    # start never read (d is a multiple of 8)
    assert d % 8 == 0 and core.dpad % WGMMA_K == 0 and d <= core.dpad < d + 16
    assert core.dpad in tfa.SM90_ATTN_DPADS and core.dpad <= 256  # N of O += P·V
    assert tfa.SM90_ATTN_ROWS // WGMMA_M == 2
    assert core.tile % WGMMA_K == 0 and core.tile % 8 == 0 and core.tile <= 256
    assert core.smem == (tfa.SM90_ATTN_ROWS * core.dpad * 2
                         + core.stages * 2 * core.tile * core.dpad * 2) <= SMEM_LIMIT
    assert 3 <= core.stages <= tfa.SM90_ATTN_STAGES  # the ring runs stages − 2 tiles ahead
    # the projections on csrc/gemm_sm90.cu: LN(x)·Wqkv [C, 3C] and o·Wo
    m = b * s
    for p, n in ((plan.qkv, 3 * c), (plan.out, c)):
        assert p.smem <= SMEM_LIMIT and p.stages >= 2
        assert p.w_boxes == p.bn // tfm.SM90_BOX
        assert p.grid == (-(-n // p.bn), -(-m // tfm.SM90_BM))
    assert c <= tfm.SM90_LN_MAX_K


@pytest.mark.parametrize("b,s,c,heads", [
    (2, 256, 768, 8),    # d = 96: no core instance
    (2, 256, 2560, 16),  # d = 160, but C past the LayerNorm prologue's 2048
    (2, 256, 320, 7),    # the heads do not divide C
])
def test_k2_plan_leaves_other_shapes_to_the_wmma_kernels(b, s, c, heads):
    assert tft.sm90_plan(b, s, c, heads) is None


# ------------------------------------------------------------ K1

# (d, the padded width the core runs it at, or None: the wide kernel,
# csrc/attention_wide_sm90.cu) for the head widths K1 runs at: training's 40
# (and 80, 160 at other levels and 1024px), SD v2's 64, the VAE's mid-block
# 512, and 504, which pads to it
K1_WIDTHS = [(40, 48), (64, 64), (80, 80), (160, 160), (512, None), (504, None)]
CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("d,dpad", K1_WIDTHS)
def test_k1_route(d, dpad, bias):
    """bf16 takes the Hopper core at its instances and the wide kernel at
    the widths that pad to 512; f32 keeps csrc/flash_attention.cu. The
    core's plan fits the shared memory with the bias's 64 floats a stage,
    and keeps the ring stages − 2 tiles ahead."""
    assert tfa.fwd_route(torch.float32, d, bias) is None
    plan = tfa.fwd_route(torch.bfloat16, d, bias)
    if dpad is None:
        assert isinstance(plan, tfa.WidePlan) and plan == tfa.wide_sm90_plan(d)
        return
    assert plan.dpad == dpad and plan.dpad % WGMMA_K == 0 and d <= plan.dpad < d + 16
    assert plan.tile == tfa.SM90_ATTN_TILE and plan.tile % WGMMA_K == 0
    stage = 2 * plan.tile * plan.dpad * 2 + (plan.tile * 4 if bias else 0)
    assert plan.smem == tfa.SM90_ATTN_ROWS * plan.dpad * 2 + plan.stages * stage <= SMEM_LIMIT
    assert 3 <= plan.stages <= tfa.SM90_ATTN_STAGES
    # the bias stage offsets stay 16-byte aligned (float2 reads)
    ring = plan.stages * 2 * plan.tile * plan.dpad * 2
    assert (tfa.SM90_ATTN_ROWS * plan.dpad * 2 + ring) % 16 == 0


def test_k1_wide_plan():
    """The wide kernel at d = 512: its shared memory is what the source
    reserves (the static_assert beside W_SMEM) and fits the 227 KB; the
    TMA boxes (64 columns = 128 bytes, the 128-byte swizzle's row) start on
    1024-byte boundaries, the pattern's repeat; two warpgroups of 256
    columns cover O (m64n256, 128 registers a thread) and 32 keys each
    cover S (m64n32), both multiples of 8 and at most 256; the key tile is
    whole K steps of 16."""
    plan = tfa.wide_sm90_plan(512)
    src = (CSRC / "attention_wide_sm90.cu").read_text()
    assert plan.smem == int(re.search(r"static_assert\(W_SMEM == (\d+)", src).group(1))
    assert plan.smem <= SMEM_LIMIT
    rows, dpad, tile = tfa.WIDE_ROWS, plan.dpad, plan.tile
    assert rows == WGMMA_M and tile % WGMMA_K == 0 and dpad % 64 == 0
    box = rows * 64 * 2  # one 64-column box of a 64-row tile
    offsets = [0, rows * dpad * 2, 2 * rows * dpad * 2, 3 * rows * dpad * 2]  # Q, K, V, P
    assert all(o % 1024 == 0 for o in offsets) and box % 1024 == 0
    bias, stat = offsets[3] + rows * tile * 2, offsets[3] + rows * tile * 2 + tile * 4
    assert bias % 16 == 0 and stat % 16 == 0 and (stat + tfa.WIDE_WARPGROUPS * rows * 4) % 8 == 0
    cols, keys = dpad // tfa.WIDE_WARPGROUPS, tile // tfa.WIDE_WARPGROUPS
    assert cols % 8 == 0 and cols <= 256 and cols // 2 == 128
    assert keys % 8 == 0 and keys <= 256 and (keys * 128) % 1024 == 0  # a slice's first row


@pytest.mark.parametrize("d", [160, 256, 496, 520, 12])
def test_k1_wide_plan_takes_only_widths_that_pad_to_512(d):
    assert tfa.wide_sm90_plan(d) is None


# ------------------------------------------------------------ K3

# (B, rows, C) of K3's launches on the main paths (chip_smoke.py's cases):
# the UNet's ResBlock inputs and transformers' entry norms at 512px and
# 1024px (B=2; the serve phase's B=8), the VAE decoder's mid blocks (B=1;
# the serve phase's B=4), the VAE encoder's blocks in the latent cache (B=4)
# and in img2img (B=1)
K3_SHAPES = [(2, 4096, 320), (8, 4096, 320), (2, 4096, 640), (2, 16384, 320),
             (2, 16384, 640), (1, 4096, 512), (1, 16384, 512), (4, 4096, 512),
             (4, 16384, 512), (4, 262144, 128), (4, 65536, 128), (4, 65536, 256),
             (4, 16384, 256), (1, 262144, 128), (1, 65536, 128), (1, 65536, 256),
             (1, 16384, 256)] + [  # SD v2.1 at 768px: the UNet's 96², the decoder,
    (2, 9216, 320), (1, 9216, 512), (1, 36864, 512)] + [  # the encoder at B=2 and 1
    (b, hw * hw, ci) for b in (2, 1) for hw, ci, _ in _encoder_resnets(768)]
K3_THREADS = 256


@pytest.mark.parametrize("b,rows,c", K3_SHAPES)
def test_k3_plan(b, rows, c):
    """Every main-path shape takes the cluster kernel: channel blocks of 64
    channels (128-byte row pieces), or 32 where clusters of 16 would not
    cover the 132 SMs; clusters of a power of two CTAs, at most 16 (above
    8 the non-portable size, which the launch allows), no more than rows,
    and just large enough that each CTA reads one batch of 16-byte loads
    (64 KB in bf16) unless 16 is reached. A warp's row pieces are whole
    32-byte sectors."""
    plan = tfg.stats_plan(b, rows, c)
    assert plan is not None and plan.cb in tfg.STATS_CBS and c % 8 == 0
    wide = [cb for cb in tfg.STATS_CBS if b * -(-c // cb) * tfg.STATS_MAX_CLUSTER >= 132]
    assert plan.cb == (wide[0] if wide else min(tfg.STATS_CBS))
    cl = plan.cluster
    assert 1 <= cl <= min(tfg.STATS_MAX_CLUSTER, rows) and cl & (cl - 1) == 0
    per_cta = rows * plan.cb * 2 / cl  # bytes a CTA reads (bf16)
    assert per_cta <= tfg.STATS_CTA_BYTES or cl == tfg.STATS_MAX_CLUSTER
    assert cl == 1 or per_cta * 2 > tfg.STATS_CTA_BYTES  # half the cluster would not do
    assert tfg.STATS_CTA_BYTES == K3_THREADS * 16 * 16
    assert K3_THREADS % (plan.cb // 8) == 0 and 32 % (plan.cb // 8) == 0
    assert (plan.cb // 8) * 16 % 32 == 0  # a row piece is whole 32-byte sectors
    assert b * -(-c // plan.cb) * cl >= 64 and plan.cb >= 32  # whole 64-byte row pieces


def test_k3_plan_f32_reads_twice_the_bytes():
    """f32 maps read 32 bytes a vector of 8 channels: the same map takes
    clusters twice as large (up to 16)."""
    assert tfg.stats_plan(2, 4096, 320, 4).cluster == 2 * tfg.stats_plan(2, 4096, 320, 2).cluster


@pytest.mark.parametrize("c", [20, 36, 100, 1284])
def test_k3_plan_leaves_other_widths_to_the_partials_kernel(c):
    """C not a multiple of 8 takes the partials kernel (csrc/channel_stats.cu)
    by the plan: the cluster kernel reads 8 channels a vector."""
    assert tfg.stats_plan(2, 4096, c) is None
    assert tfg.stats_plan(2, 4096, c + 8 - c % 8) is not None


@pytest.mark.parametrize("b,rows,c", [(1, 1, 8), (1, 3, 8), (2, 7, 40), (2, 90, 96)])
def test_k3_plan_small_maps(b, rows, c):
    """A map with few rows still gets a plan the kernel takes: a cluster no
    larger than its rows (the entry refuses more), a channel block that
    covers C in whole blocks, the last one ragged."""
    plan = tfg.stats_plan(b, rows, c)
    assert plan.cluster <= rows and plan.cb in tfg.STATS_CBS
    assert -(-c // plan.cb) * plan.cb >= c


# ------------------------------------------------------------ K4

# (B, rows, C = Co) of K4's launches on the main paths: proj_in and proj_out
# at 64² (512px, batch 2; the serve phase's batch 8) and at 128² and 64²
# (1024px)
K4_SHAPES = [(2, 4096, 320), (2, 16384, 320), (2, 4096, 640), (8, 4096, 320),
             (2, 9216, 320)]  # the last, SD v2.1's 96² at 768px


@pytest.mark.parametrize("prologue", [True, False], ids=["proj_in", "proj_out"])
@pytest.mark.parametrize("b,rows,c", K4_SHAPES)
def test_k4_plan(b, rows, c, prologue):
    plan = tfc.conv1x1_sm90_plan(b, rows, c, c, prologue)
    assert plan is not None  # every main-path shape takes the Hopper kernel
    assert 2 <= plan.stages <= tfc.SM90_CONV1X1_MAX_STAGES
    stage = tfc.SM90_CONV_BM * tfc.SM90_CONV_BK * 2 + (
        plan.bn // tfc.SM90_CONV_BOX * tfc.SM90_CONV_BK * tfc.SM90_CONV_BOX * 2)
    assert plan.smem == 1024 + plan.stages * (stage + 16) + (8 * c if prologue else 0)
    assert plan.smem <= SMEM_LIMIT
    # wgmma: two consumer warpgroups of 64 rows, n64 boxes, K steps of 16
    assert plan.bn in (128, 256, 320) and plan.bn % tfc.SM90_CONV_BOX == 0
    assert tfc.SM90_CONV_BK % WGMMA_K == 0 and tfc.SM90_CONV_BM // WGMMA_M == 2
    # TMA: the A box (64 channels, 128 rows, 1 image) of a 3-D map, the W box
    # (64, 64); 64 bf16 channels are the 128 bytes the swizzle takes
    assert (plan.bw, plan.bh) == (1, tfc.SM90_CONV_BM) and plan.bh <= TMA_BOX_MAX
    assert tfc.SM90_CONV_BK * 2 == 128 and (c * 2) % 16 == 0
    # the tiles: 128 rows of one image each, covering every row once; the
    # column tiles cover Co
    assert plan.grid == (-(-c // plan.bn), -(-rows // tfc.SM90_CONV_BM), b)
    r = np.arange(plan.grid[1])[:, None] * tfc.SM90_CONV_BM + np.arange(tfc.SM90_CONV_BM)
    counts = np.bincount(r[r < rows], minlength=rows)
    assert (counts == 1).all() and counts.size == rows
    assert plan.grid[0] * plan.bn >= c > (plan.grid[0] - 1) * plan.bn
    # a 64-deep K block lies in one 64-channel box of x
    assert c % tfc.SM90_CONV_BK == 0
    for kb in range(c // tfc.SM90_CONV_BK):
        assert (kb + 1) * tfc.SM90_CONV_BK <= c
    # the wide tile where the grid still has a CTA for half the SMs
    wide = c % 320 == 0 and b * plan.grid[1] * (c // 320) >= 132 // 2
    assert plan.bn == (320 if wide else 128)


def test_k4_ragged_rows_take_the_hopper_route():
    """A row count that is not a multiple of 128: the last tile's rows past
    the end are zero-filled by TMA and neither stored nor counted, so the
    Hopper kernel takes it (one more tile); a C that is not a multiple of 64
    takes the WMMA kernel."""
    plan = tfc.conv1x1_sm90_plan(1, 333, 64, 72, True)
    assert plan is not None and plan.grid == (1, 3, 1) and plan.bn == 128
    assert tfc.conv1x1_sm90_plan(2, 4096 + 8, 320, 320, False).grid[1] == 33
    assert tfc.conv1x1_sm90_plan(2, 81, 96, 72, True) is None
    assert tfc.conv1x1_sm90_plan(2, 81, 64, 12, True) is None  # Co not a multiple of 8
    assert tfc.conv1x1_sm90_plan(2, 0, 64, 64, True) is None


def test_k4_plan_overrides():
    plan = tfc.conv1x1_sm90_plan(2, 4096, 320, 320, True, bn=320, stages=2)
    assert (plan.bn, plan.stages, plan.grid) == (320, 2, (1, 32, 2))
    assert tfc.conv1x1_sm90_plan(2, 4096, 320, 320, False, bn=128, stages=4).stages == 4


# ------------------------------------------------------------ K7

# (B, H = W, C, Co) of K7's launches on the main paths (chip_smoke.py's
# phase-2 cases): the decoder's upsamplers at 512px (128², 256²) and 1024px
# (also 256² x 512 and 512²), and the serve phase's batch of 4
K7_SHAPES = [(1, 128, 512, 512), (1, 256, 256, 256), (1, 256, 512, 512), (1, 512, 256, 256),
             (4, 128, 512, 512), (4, 256, 256, 256),
             (1, 192, 512, 512), (1, 384, 256, 256)]  # SD v2.1 at 768px


@pytest.mark.parametrize("b,hw,c,co", K7_SHAPES)
def test_k7_plan(b, hw, c, co):
    plan = tfc.upsample_sm90_plan(b, hw, hw, c, co)
    assert plan is not None  # every main-path shape takes the Hopper kernel
    # no prologue: no (scale, shift) table
    stage = tfc.SM90_CONV_BM * tfc.SM90_CONV_BK * 2 + (
        plan.bn // tfc.SM90_CONV_BOX * tfc.SM90_CONV_BK * tfc.SM90_CONV_BOX * 2)
    assert plan.smem == 1024 + plan.stages * (stage + 16) <= SMEM_LIMIT
    assert 2 <= plan.stages <= tfc.SM90_CONV_MAX_STAGES
    assert plan.bn in (128, 256) and co % plan.bn == 0
    # the box (64 channels, bw, bh, 1) covers the 128-pixel tile exactly
    assert plan.bw * plan.bh == tfc.SM90_CONV_BM and hw % plan.bw == 0
    assert all(0 < d <= TMA_BOX_MAX for d in (plan.bw, plan.bh))
    tiles = -(-hw // plan.bh) * (hw // plan.bw)
    # a CTA per (channel tile, pixel tile, image and phase)
    assert plan.grid == (co // plan.bn, tiles, 4 * b)
    # the wide tile where the grid still has a CTA for every SM
    assert plan.bn == (256 if co % 256 == 0 and 4 * b * tiles * (co // 256) >= 132 else 128)
    # K: 4 taps of C / 64 blocks, a block inside one tap
    assert c % tfc.SM90_CONV_BK == 0 and 4 * c // tfc.SM90_CONV_BK >= 16


@pytest.mark.parametrize("b,h,w,c,co", [
    (1, 8, 8, 40, 64),    # C not a multiple of 64
    (1, 8, 8, 64, 12),    # Co not a multiple of 8
    (1, 8, 24, 64, 64),   # W no divisor of 128 and its box 8 pixels wide
    (1, 8, 33, 64, 64),   # an odd W (a box of 1 pixel)
])
def test_k7_plan_leaves_other_shapes_to_the_wmma_kernel(b, h, w, c, co):
    assert tfc.upsample_sm90_plan(b, h, w, c, co) is None


def test_k7_phase_stacks_are_folded_once_for_the_decoder(monkeypatch):
    """upsample_phase_stacks gives each decoder block with an upsampler its
    [4, 4C, Co] stack in the weight's dtype (None elsewhere), and
    decode_latent hands block i's stack to its fused upsampler."""
    from sdtpu_torch.config import AutoencoderConfig
    from sdtpu_torch.models import vae
    from sdtpu_torch.ops import conv as tconv
    from sdtpu_torch.weights import Init

    cfg = AutoencoderConfig(encoder_channels=((128, 128), (128, 128)),
                            decoder_channels=((128, 128), (128, 128)), groupnorm_groups=32)
    params = vae.init_autoencoder(Init(torch.Generator().manual_seed(0), "cpu",
                                       torch.bfloat16), cfg)
    stacks = vae.upsample_phase_stacks(params)
    blocks = params["decoder"]["blocks"]
    assert [s is None for s in stacks] == ["upsampler" not in b for b in blocks]
    for blk, st in zip(blocks, stacks):
        if st is not None:
            assert st.dtype == torch.bfloat16 and st.shape == (4, 4 * 128, 128)
            assert torch.equal(st, tfc.phase_weight_stack(blk["upsampler"]["w"], torch.bfloat16))
    seen = []

    def spy(x, w, b, emit_stats=False, phases=None):
        seen.append(phases)
        return tfc.upsample2x_conv_fused_plain(x, w, b, emit_stats)

    monkeypatch.setattr(tconv, "FUSED_UP_MIN_ROWS", 1)
    monkeypatch.setattr(vae, "upsample2x_conv_fused", spy)
    vae.decode_latent(params, torch.zeros(1, 8, 8, 4, dtype=torch.bfloat16), cfg, stacks)
    assert seen == [s for s in stacks if s is not None]


# ------------------------------------------------------------ K10

# (B, S, C) of K10's launches in the serve phase (UNet batch 2: a lone
# request; 4; 8: its batch of 4), 8 heads, the 77 context tokens
K10_SHAPES = [(b, s, c) for b in (2, 4, 8) for s, c in ((4096, 320), (1024, 640), (256, 1280))]


@pytest.mark.parametrize("b,s,c", K10_SHAPES)
def test_k10_plan(b, s, c):
    """The Q product (LayerNorm prologue, N = C), the core with the key bias
    at d padded to 48, 80 or 160 (77 keys: two 64-key tiles), the Wo
    product; f32 keeps the WMMA kernels."""
    _check_k10_plan(b, s, c, 8)


def test_k10_plan_sd_v2_1():
    """SD v2.1 at 768px with the gate open: the 48² level, 10 heads of 64."""
    _check_k10_plan(2, 2304, 640, 10)


def _check_k10_plan(b, s, c, heads):
    plan = tfx.route_plan(torch.bfloat16, b, s, c, heads, 77, True)
    assert plan is not None
    d, core = c // heads, plan.core
    assert core.dpad == {40: 48, 64: 64, 80: 80, 160: 160}[d]
    assert core.tile == tfa.SM90_ATTN_TILE and -(-77 // core.tile) == 2
    stage = 2 * core.tile * core.dpad * 2 + core.tile * 4  # K, V and the bias row
    assert core.smem == tfa.SM90_ATTN_ROWS * core.dpad * 2 + core.stages * stage <= SMEM_LIMIT
    assert 3 <= core.stages <= tfa.SM90_ATTN_STAGES
    m = b * s
    for p in (plan.q, plan.out):  # both products are [m, C]·[C, C]
        assert p == tfm.sm90_plan(m, c, c, False)
        assert p.smem <= SMEM_LIMIT and p.grid == (-(-c // p.bn), -(-m // tfm.SM90_BM))
    assert c <= tfm.SM90_LN_MAX_K
    assert tfx.route_plan(torch.float32, b, s, c, heads, 77, True) is None
    # without a key mask the core's instance without the bias
    assert tfx.route_plan(torch.bfloat16, b, s, c, heads, 77, False).core == tfa.core_sm90_plan(d)


@pytest.mark.parametrize("b,s,c,heads,sk", [
    (2, 256, 768, 8, 77),    # d = 96: no core instance
    (2, 256, 2560, 16, 77),  # d = 160, but C past the LayerNorm prologue's 2048
    (2, 256, 320, 8, 129),   # more keys than the kernel takes
    (2, 256, 320, 7, 77),    # the heads do not divide C
])
def test_k10_plan_leaves_other_shapes_to_the_wmma_route(b, s, c, heads, sk):
    assert tfx.route_plan(torch.bfloat16, b, s, c, heads, sk, True) is None

