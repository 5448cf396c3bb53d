"""K6's and K7's float32 routes (csrc/conv_tf32_sm90.cu): their plans at
every main-path shape and their refusals, the route each launch takes by
dtype and shape, and the weights' K-major TF32 copies (K6's tap-major,
x-then-x2 order, K7's [4, Co, 4C] stack, one copy a weight and a
tensor-parallel rank's shard), here on the CPU; and, marked `cuda`, the
"tf32" route against the plain version in full f32 on the card at every
main-path shape and at ragged ones, and a CUDA-graph capture after the
eager warm-up. No jax here: the algorithm is held against sdtpu in
tests/test_torch_tf32_walk.py.
"""

import gc

import numpy as np
import pytest
import torch

from sdtpu_torch import kernels
from sdtpu_torch.config import SD_V1_4
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.parallel import layers as tpl
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.sharding import local_part, split_of

torch.set_num_threads(1)

TOL = 5e-3  # chip_smoke.py's float32 tolerance (atol and rtol): TF32 products


def decoder_convs(lat: int) -> list:
    """(hw, c_in, c_out, residual, stats) of each K6 launch of SD's VAE
    decoder on a lat x lat latent (chip_smoke.py's decoder_convs): the two
    mid ResnetBlocks, then three a level, each as conv1 and conv2."""
    chans = SD_V1_4.vae.decoder_channels
    blocks = [(lat, chans[0][0], chans[0][0])] * 2
    for level, (ci, co) in enumerate(chans):
        blocks += [(lat << level, ci, co)] + [(lat << level, co, co)] * 2
    convs = []
    for i, (hw, ci, co) in enumerate(blocks):
        convs += [(hw, ci, co, False, True), (hw, co, co, True, i != 0)]
    return convs


# (b, hw, c1, c2, co) of K6's main-path launches in float32: the VAE decoder
# at 512, 768 and 1024 px (64², 96² and 128² latents), the encoder's
# ResnetBlocks at 512² (the fine-tuning latent cache, chunks of 4), the
# 1024px UNet's fused ResBlocks at 128² latents (batch 2: conv_in over x, or
# over x and the skip as x2; conv_out), and a tensor-parallel rank's half
# of the decoder's >= 256-channel convs
K6_MAIN = sorted({(1, hw, ci, 0, co) for lat in (64, 96, 128)
                  for hw, ci, co, _, _ in decoder_convs(lat)}
                 | {(4, hw, ci, 0, co) for hw, ci, co in (
                     (512, 128, 128), (256, 128, 256), (256, 256, 256), (128, 256, 512),
                     (128, 512, 512), (64, 512, 512))}
                 | {(2, 128, 320, 0, 320), (2, 128, 640, 320, 320), (2, 128, 320, 320, 320)}
                 | {(1, hw, ci, 0, co // 2) for hw, ci, co, _, _ in decoder_convs(64)
                    if co >= 256})
# (b, hw, c, co) of K7's fused upsamplers: two at 512px, three at 1024px,
# SD v2.1's two at 768px, the serve phase's batch of 4 and a tp rank's half
K7_MAIN = [(1, 128, 512, 512), (1, 256, 256, 256), (1, 256, 512, 512), (1, 512, 256, 256),
           (1, 192, 512, 512), (1, 384, 256, 256), (4, 128, 512, 512), (4, 256, 256, 256),
           (1, 128, 512, 256), (1, 256, 256, 128)]


# ------------------------------------------------------------ plans

def _k6_id(case):
    b, hw, c1, c2, co = case
    return f"B{b}_{hw}x{hw}_{c1}{f'+{c2}' if c2 else ''}-{co}"


@pytest.mark.parametrize("case", K6_MAIN, ids=[_k6_id(c) for c in K6_MAIN])
def test_k6_tf32_plan_at_main_path_shapes(case):
    """Every main-path K6 launch has a TF32 plan: the A box gcd(W, 128)
    pixels wide (32 x 4 on the 96-wide map, 64 x 2 on the 192-wide one), the
    grid covering every pixel and channel, at least two stages within the
    shared memory beside the prologue's table, and tiles as sm90_plan's."""
    b, hw, c1, c2, co = case
    plan = tfc.tf32_conv_plan(b, hw, hw, c1, c2, co, True)
    assert isinstance(plan, tfc.Tf32ConvPlan)
    assert plan.bw == {96: 32, 192: 64}.get(hw, min(hw, 128)) and plan.bw * plan.bh == 128
    assert plan.grid == (-(-co // plan.bn), -(-hw // plan.bh) * (hw // plan.bw), b)
    assert 2 <= plan.stages <= tfc.TF32_CONV_MAX_STAGES
    stage = (128 + plan.bn) * 32 * 4
    assert plan.smem == 1024 + plan.stages * (stage + 16) + 8 * (c1 + c2)
    assert plan.smem <= kernels.SMEM_LIMIT
    bf16 = tfc.sm90_plan(b, hw, hw, c1, c2, co, True)
    assert (plan.bn, plan.bw, plan.grid) == (bf16.bn, bf16.bw, bf16.grid)


@pytest.mark.parametrize("case", K7_MAIN, ids=["B{}_{}x{}_{}-{}".format(b, hw, hw, c, co)
                                               for b, hw, c, co in K7_MAIN])
def test_k7_tf32_plan_at_main_path_shapes(case):
    """Every fused upsampler has a TF32 plan at four taps: a CTA one phase
    of one 128-pixel tile of x (grid (co / bn, tiles, 4·b)), no prologue."""
    b, hw, c, co = case
    plan = tfc.upsample_tf32_plan(b, hw, hw, c, co)
    assert isinstance(plan, tfc.Tf32ConvPlan)
    assert plan.grid == (-(-co // plan.bn), -(-hw // plan.bh) * (hw // plan.bw), 4 * b)
    assert plan.smem == 1024 + plan.stages * ((128 + plan.bn) * 128 + 16)
    assert 2 <= plan.stages and plan.smem <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("b,h,w,c1,c2,co,prologue,kw", [
    (1, 64, 64, 48, 0, 64, True, {}),         # C1 not a multiple of 32
    (1, 64, 64, 64, 16, 64, True, {}),        # C2 not a multiple of 32
    (1, 64, 64, 64, 0, 12, True, {}),         # Co not a multiple of 8
    (1, 8, 24, 64, 0, 64, True, {}),          # a box of 8 pixels: narrower than 32
    (1, 16, 80, 64, 0, 64, False, {}),        # a box of 16 pixels (W = 80)
    (1, 64, 64, 64, 0, 64, True, {"stages": 5}),      # past TF32_CONV_MAX_STAGES
    (1, 64, 64, 640, 0, 320, True, {"bn": 320, "stages": 4}),  # 4 stages of 56 KB and a table
    (1, 64, 64, 16384, 0, 320, True, {"bn": 320}),    # the table leaves room for one stage
    (0, 64, 64, 64, 0, 64, True, {}),         # no image
])
def test_tf32_conv_plan_refuses(b, h, w, c1, c2, co, prologue, kw):
    assert tfc.tf32_conv_plan(b, h, w, c1, c2, co, prologue, **kw) is None


def test_tf32_conv_plan_takes_what_bf16_refuses():
    """Channels that are multiples of 32 and not of 64 have a TF32 plan and
    no bf16 one; a tile width the kernel has no instance of raises."""
    assert tfc.tf32_conv_plan(1, 16, 16, 96, 32, 64, True) is not None
    assert tfc.sm90_plan(1, 16, 16, 96, 32, 64, True) is None
    assert tfc.upsample_tf32_plan(1, 16, 16, 32, 64) is not None
    with pytest.raises(ValueError):
        tfc.tf32_conv_plan(1, 64, 64, 64, 0, 192, True, bn=192)


@pytest.mark.parametrize("bn,stages", [(128, 4), (256, 4), (320, 4)])
def test_tf32_conv_plan_ring_depth(bn, stages):
    """Without a prologue the ring is TF32_CONV_MAX_STAGES deep at each tile
    width (stages of 32, 48 and 56 KB); the UNet's 960-channel table leaves
    3 at 320."""
    assert tfc.tf32_conv_plan(2, 128, 128, 320, 0, 640, False, bn=bn).stages == stages
    assert tfc.tf32_conv_plan(2, 128, 128, 640, 320, 320, True, bn=320).stages == 3


# ------------------------------------------------------------ routes

@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, tfc.ConvPlan),
                                        (torch.float32, tfc.Tf32ConvPlan)])
def test_k6_route_by_dtype(dtype, kind):
    """K6's plan by dtype: bf16 the Hopper kernel's, float32 the TF32 one's,
    each where the prologue, if any, ends in SiLU; the affine alone, route
    "wmma", other dtypes and shapes without a plan take the WMMA kernel."""
    assert isinstance(tfc.conv3x3_plan(dtype, 2, 128, 128, 640, 320, 320, True), kind)
    assert isinstance(tfc.conv3x3_plan(dtype, 1, 64, 64, 512, 0, 512, False), kind)
    assert tfc.conv3x3_plan(dtype, 1, 64, 64, 512, 0, 512, True, silu=False) is None
    assert tfc.conv3x3_plan(dtype, 1, 64, 64, 512, 0, 512, True, route="wmma") is None
    assert tfc.conv3x3_plan(dtype, 1, 8, 24, 512, 0, 512, True) is None
    assert tfc.conv3x3_plan(torch.float16, 1, 64, 64, 512, 0, 512, True) is None


def test_k6_forced_routes():
    """"tf32" forces the float32 plan and raises where there is none (a
    bf16 launch, a shape without one, the affine prologue alone); a given
    plan must fit the dtype; an unknown route raises."""
    plan = tfc.conv3x3_plan(torch.float32, 1, 64, 64, 512, 0, 512, True, route="tf32")
    assert plan == tfc.tf32_conv_plan(1, 64, 64, 512, 0, 512, True)
    assert tfc.conv3x3_plan(torch.float32, 1, 64, 64, 512, 0, 512, True, route=plan) is plan
    # channels of 32: float32's plan, and the WMMA kernel in bf16
    assert tfc.conv3x3_plan(torch.float32, 1, 16, 16, 96, 0, 64, True) is not None
    assert tfc.conv3x3_plan(torch.bfloat16, 1, 16, 16, 96, 0, 64, True) is None
    for dtype, kw in ((torch.bfloat16, {}), (torch.float32, {"silu": False})):
        with pytest.raises(ValueError):
            tfc.conv3x3_plan(dtype, 1, 64, 64, 512, 0, 512, True, route="tf32", **kw)
    with pytest.raises(ValueError):
        tfc.conv3x3_plan(torch.float32, 1, 8, 24, 512, 0, 512, True, route="tf32")
    with pytest.raises(ValueError):
        tfc.conv3x3_plan(torch.bfloat16, 1, 64, 64, 512, 0, 512, True, route=plan)
    with pytest.raises(ValueError):
        tfc.conv3x3_plan(torch.float32, 1, 64, 64, 512, 0, 512, True,
                         route=tfc.sm90_plan(1, 64, 64, 512, 0, 512, True))
    with pytest.raises(ValueError):
        tfc.conv3x3_plan(torch.float32, 1, 64, 64, 512, 0, 512, True, route="tf32swap")


def test_k7_route_by_dtype():
    assert isinstance(tfc.upsample_plan(torch.bfloat16, 1, 128, 128, 512, 512), tfc.ConvPlan)
    plan = tfc.upsample_plan(torch.float32, 1, 128, 128, 512, 512)
    assert isinstance(plan, tfc.Tf32ConvPlan)
    assert tfc.upsample_plan(torch.float32, 1, 128, 128, 512, 512, route="tf32") == plan
    assert tfc.upsample_plan(torch.float32, 1, 128, 128, 512, 512, route="wmma") is None
    assert tfc.upsample_plan(torch.float32, 1, 128, 128, 48, 512) is None
    with pytest.raises(ValueError):
        tfc.upsample_plan(torch.bfloat16, 1, 128, 128, 512, 512, route="tf32")
    with pytest.raises(ValueError):
        tfc.upsample_plan(torch.float32, 1, 128, 128, 48, 512, route="tf32")


# ------------------------------------------------------------ K-major copies

def test_k6_kmajor_copy_is_tap_major_x_then_x2():
    """K6's copy of the HWIO weight over [x, x2]: row n is output channel
    n's taps (ky, kx) in order, each x's C1 channels then x2's C2, rounded
    to TF32: the K order the kernel walks."""
    r = np.random.default_rng(1)
    c1, c2, co = 64, 32, 40
    w = torch.from_numpy(r.standard_normal((3, 3, c1 + c2, co)).astype(np.float32))
    wt = tfm.kmajor(w)
    assert wt.shape == (co, 9 * (c1 + c2)) and wt.is_contiguous()
    for ky, kx, c, n in ((0, 0, 0, 0), (1, 2, c1 + 5, 7), (2, 1, c1 - 1, 39), (2, 2, c1 + 31, 3)):
        k = (3 * ky + kx) * (c1 + c2) + c
        assert wt[n, k] == tfm.round_tf32(w[ky, kx, c, n].reshape(1))[0]
    assert torch.equal(wt, tfm.round_tf32(w.reshape(-1, co).t()))


def test_k7_kmajor_copy_is_the_stack_per_phase():
    """K7's copy: [4, Co, 4C], phase p's row n holding its taps (dy, dx) in
    K columns (2·dy + dx)·C + c, rounded to TF32; the same values from the
    weight folded in place of a given stack."""
    r = np.random.default_rng(2)
    c, co = 32, 24
    w = torch.from_numpy(r.standard_normal((3, 3, c, co)).astype(np.float32))
    stack = tfc.phase_weight_stack(w, torch.float32)
    wt = tfm.kmajor(stack, "stack")
    assert wt.shape == (4, co, 4 * c) and wt.is_contiguous()
    assert torch.equal(wt, tfm.round_tf32(stack.transpose(1, 2)))
    assert torch.equal(tfm.kmajor(w, "upsample"), wt)
    # phase (py, px) = (1, 0), tap (dy, dx) = (0, 0): the 3x3 rows 0 + 1 of
    # column 0; tap (1, 1): row 2, columns 1 + 2
    assert wt[2, 5, 3] == tfm.round_tf32((w[0, 0, 3, 5] + w[1, 0, 3, 5]).reshape(1))[0]
    assert wt[2, 5, 3 * c + 3] == tfm.round_tf32((w[2, 1, 3, 5] + w[2, 2, 3, 5]).reshape(1))[0]
    with pytest.raises(ValueError):
        tfm.kmajor(w, "hwio")


@pytest.mark.parametrize("layout", ["matrix", "upsample"])
def test_conv_kmajor_copy_made_once_refreshed_and_dropped(layout):
    gc.collect()
    n0 = len(tfm._KMAJOR)
    w = torch.randn(3, 3, 32, 16)
    wt = tfm.kmajor(w, layout)
    assert tfm.kmajor(w, layout) is wt
    assert len(tfm._KMAJOR) == n0 + 1
    w.mul_(2.0)
    wt2 = tfm.kmajor(w, layout)
    assert wt2 is not wt and torch.equal(wt2, tfm.round_tf32(tfm._kmajor_of(w, layout)
                                                             .contiguous()))
    del w, wt, wt2
    gc.collect()
    assert len(tfm._KMAJOR) == n0


@pytest.mark.parametrize("path,shape,layout", [
    ("autoencoder/decoder/blocks/0/res1/conv1/w", (3, 3, 64, 256), "matrix"),
    ("unet/output_blocks/0/0/conv_in/w", (3, 3, 96, 320), "matrix"),
    ("autoencoder/decoder/blocks/0/upsampler/w", (3, 3, 32, 256), "upsample"),
])
def test_tp_shard_gets_one_copy(path, shape, layout):
    """A tensor-parallel rank's shard of a conv weight (sharding.local_part,
    what shard_params stores) is a tensor of its own, which the tp layer
    hands the kernel as it is: one K-major copy per shard, made once, equal
    to the whole weight's copy on the rank's output channels."""
    r = np.random.default_rng(3)
    whole = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    split = split_of(path, shape, 2)
    assert split is not None and split.dim == 3
    co = shape[-1]
    for rank in (0, 1):
        tp = tpc.TP(rank, 2, None)
        shard = local_part(whole, split, tp)
        assert shard.shape[-1] == co // 2 and shard.data_ptr() != whole.data_ptr()
        p = {"w": shard, "b": torch.zeros(co)}
        with tpc.use(tp):
            assert tpl.local(p)["w"] is shard  # the shard itself, no view a call
        wt = tfm.kmajor(shard, layout)
        assert tfm.kmajor(tpl.local(p)["w"], layout) is wt
        cols = slice(rank * co // 2, (rank + 1) * co // 2)
        want = tfm.kmajor(whole, layout)
        assert torch.equal(wt, want[cols] if layout == "matrix" else want[:, cols])


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    """The card, with cuDNN's and cuBLAS's TF32 off for the full-f32 plain
    version (restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _rnd(gen, dev, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


def _routes(fn):
    out = {}
    for key, n in fn.shapes.items():
        route = key.rsplit("route=", 1)[-1].split()[0]
        out[route] = out.get(route, 0) + n
    return out


def _within(got, want):
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


def _k6_args(dev, b, h, w, c1, c2, co, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _rnd(g, dev, b, h, w, c1)
    x2 = _rnd(g, dev, b, h, w, c2) if c2 else None
    # a GroupNorm folded to (scale, shift), the shift far enough from 0 that
    # silu(shift) would show at the border
    s = 1.0 + _rnd(g, dev, b, c1 + c2, scale=0.1)
    o = 0.5 + _rnd(g, dev, b, c1 + c2, scale=0.2)
    wt = _rnd(g, dev, 3, 3, c1 + c2, co, scale=(9 * (c1 + c2)) ** -0.5)
    cb, res = _rnd(g, dev, co, scale=0.1), _rnd(g, dev, b, h, w, co)
    kw = {"residual": res, "emit_stats": True}
    if c2:
        kw.update(x2=x2, prologue_scale2=s[:, c1:], prologue_bias2=o[:, c1:])
    return (x, wt, cb, s[:, :c1], o[:, :c1]), kw


# ragged shapes: a map shorter than its boxes (12 rows of 16-pixel boxes 8
# tall), the 96-wide map's 32 x 4 boxes, 7 rows of 128, 33 rows of 64 x 2
# boxes, channels of 32 and 96, Co not a multiple of 64 (72, 40)
K6_RAGGED = [(1, 12, 16, 32, 32, 72), (2, 20, 96, 64, 0, 40), (1, 7, 128, 96, 32, 320),
             (2, 33, 64, 32, 0, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_MAIN + [(b, h, w, c1, c2, co)
                                            for b, h, w, c1, c2, co in K6_RAGGED],
                         ids=[_k6_id(c) for c in K6_MAIN] + [
                             f"ragged_{b}x{h}x{w}_{c1}+{c2}-{co}"
                             for b, h, w, c1, c2, co in K6_RAGGED])
def test_k6_tf32_matches_plain_on_card(card, case):
    """K6's float32 launches on route "tf32" against the plain version in
    full f32: y within TOL, its statistics within the f32 sums' order of
    those of y itself, counted under the route, the same bits on a second
    call; and the convolution without the border mask fails TOL."""
    if len(case) == 5:
        b, hw, c1, c2, co = case
        h = w = hw
    else:
        b, h, w, c1, c2, co = case
    args, kw = _k6_args(card, b, h, w, c1, c2, co, 60 + c1 + c2 + co + h)
    before = _routes(tfc.conv3x3_fused).get("tf32", 0)
    got, st = tfc.conv3x3_fused(*args, **kw)
    assert _routes(tfc.conv3x3_fused)["tf32"] == before + 1
    want, _ = tfc.conv3x3_fused_plain(*args, **kw)
    assert _within(got, want), float((got - want).abs().max())
    sums = torch.stack([got.sum(dim=(1, 2)), (got * got).sum(dim=(1, 2))], dim=1)
    torch.testing.assert_close(st, sums, rtol=1e-4, atol=1e-5 * float(sums.abs().max()))
    again, _ = tfc.conv3x3_fused(*args, **kw)
    assert torch.equal(again, got)
    # the prologue applied to the zero-padded map: silu(shift) at the border
    x, wt, cb, s, o = args
    from sdtpu_torch.ops.conv import conv2d

    pad = torch.nn.functional.pad
    xin = tfc._prologue_plain(pad(x, (0, 0, 1, 1, 1, 1)), s, o, True)
    if c2:
        xin = torch.cat([xin, tfc._prologue_plain(pad(kw["x2"], (0, 0, 1, 1, 1, 1)),
                                                  kw["prologue_scale2"],
                                                  kw["prologue_bias2"], True)], dim=-1)
    leak = conv2d({"w": wt}, xin, padding=0) + cb + kw["residual"]
    assert not _within(leak, want)


@pytest.mark.cuda
def test_k6_tf32_without_prologue_on_card(card):
    """The instance without a prologue (TMA's zeros pad it), with x2."""
    args, kw = _k6_args(card, 2, 64, 64, 64, 32, 128, 7)
    kw = {k: v for k, v in kw.items() if not k.startswith("prologue")}
    got, _ = tfc.conv3x3_fused(*args[:3], **kw)
    want, _ = tfc.conv3x3_fused_plain(*args[:3], **kw)
    assert _within(got, want) and _routes(tfc.conv3x3_fused)["tf32"] >= 1


K7_CARD = [(b, hw, hw, c, co) for b, hw, c, co in K7_MAIN] + [(2, 8, 8, 32, 40),
                                                                (1, 12, 96, 64, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K7_CARD, ids=["B{}_{}x{}_{}-{}".format(*c) for c in K7_CARD])
def test_k7_tf32_matches_plain_on_card(card, case):
    """K7's float32 route at four taps against the plain version in full
    f32, from a given phase stack and from the weight alone; the phases
    interleaved with py and px swapped fail TOL."""
    b, h, w, c, co = case
    g = torch.Generator(device=card).manual_seed(80 + c + co + h)
    x = _rnd(g, card, b, h, w, c)
    wt = _rnd(g, card, 3, 3, c, co, scale=(9 * c) ** -0.5)
    cb = _rnd(g, card, co, scale=0.1)
    plan = tfc.upsample_tf32_plan(b, h, w, c, co)
    phases = tfc.phase_weight_stack(wt, torch.float32)
    got, st = tfc._upsample2x(x, wt, cb, True, plan, phases)
    want = tfc.upsample2x_conv_fused_plain(x, wt, cb)
    assert _within(got, want), float((got - want).abs().max())
    sums = torch.stack([got.sum(dim=(1, 2)), (got * got).sum(dim=(1, 2))], dim=1)
    torch.testing.assert_close(st, sums, rtol=1e-4, atol=1e-5 * float(sums.abs().max()))
    assert torch.equal(tfc._upsample2x(x, wt, cb, False, plan), got)
    swapped = want.reshape(b, h, 2, w, 2, co).transpose(2, 4).reshape(want.shape)
    assert not _within(swapped, want)
    before = _routes(tfc.upsample2x_conv_fused).get("tf32", 0)
    tfc.upsample2x_conv_fused(x, wt, cb, phases=phases)
    assert _routes(tfc.upsample2x_conv_fused)["tf32"] == before + 1


@pytest.mark.cuda
def test_tf32_conv_capture_on_card(card):
    """Both float32 routes capture into a CUDA graph after an eager warm-up
    (the K-major copies made by it: none is made during the capture), and
    the replay gives the eager bits."""
    args, kw = _k6_args(card, 2, 128, 128, 640, 320, 320, 9)
    g = torch.Generator(device=card).manual_seed(10)
    x7 = _rnd(g, card, 1, 128, 128, 512)
    w7 = _rnd(g, card, 3, 3, 512, 256, scale=(9 * 512) ** -0.5)
    b7 = _rnd(g, card, 256, scale=0.1)
    phases = tfc.phase_weight_stack(w7, torch.float32)
    e6, _ = tfc.conv3x3_fused(*args, **kw)
    e7, _ = tfc.upsample2x_conv_fused(x7, w7, b7, emit_stats=True, phases=phases)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            g6, _ = tfc.conv3x3_fused(*args, **kw)
            g7, _ = tfc.upsample2x_conv_fused(x7, w7, b7, emit_stats=True, phases=phases)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g6, e6) and torch.equal(g7, e7)
