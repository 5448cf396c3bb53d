"""K4's and K9's float32 routes: K4 on csrc/conv_tf32_sm90.cu at one tap
(the UNet's proj_in and proj_out), K9 on csrc/flash_attention_bwd_tf32_sm90.cu
(the fine-tuning step's attention backward). Here on the CPU: K4's plans at
every main-path shape and their refusals, the route each launch takes by
dtype, the forced routes, the weight's K-major TF32 copy (made once per
weight tensor, a 1x1 conv's [1, 1, C, Co] weight handed over as it is,
refreshed after an in-place change, one per tensor-parallel shard), and
K9's plan per head width. Marked `cuda`, K4's "tf32" route against the
plain version in full f32 on the card at every main-path shape and at
ragged ones, and a CUDA-graph capture after the eager warm-up (K9's card
tests are in tests/test_torch_train_attention.py). No jax here: the
algorithms are held against sdtpu in tests/test_torch_tf32_walk.py.
"""

import gc

import numpy as np
import pytest
import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.parallel import layers as tpl
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.sharding import local_part, split_of

torch.set_num_threads(1)

TOL = 5e-3  # chip_smoke.py's float32 tolerance (atol and rtol): TF32 products

# (b, rows, c, co) of K4's float32 launches: proj_in and proj_out of the
# SpatialTransformers at 4096 rows and more, the UNet at batch 2 (batched
# CFG) and 1 (the two-pass mode): 512px 4096 x 320, 1024px 16384 x 320 and
# 4096 x 640, SD v2.1's 768px 9216 x 320, the serve phase's batch of 4
# (UNet batch 8), and a tp = 2 rank's half of the output channels
K4_MAIN = [(2, 4096, 320, 320), (1, 4096, 320, 320), (2, 16384, 320, 320),
           (2, 4096, 640, 640), (1, 16384, 320, 320), (2, 9216, 320, 320),
           (8, 4096, 320, 320), (2, 4096, 320, 160)]


def _id(case):
    b, rows, c, co = case
    return f"B{b}_{rows}x{c}-{co}"


# ------------------------------------------------------------ K4's plans

@pytest.mark.parametrize("prologue", [True, False], ids=["proj_in", "proj_out"])
@pytest.mark.parametrize("case", K4_MAIN, ids=[_id(c) for c in K4_MAIN])
def test_k4_tf32_plan_at_main_path_shapes(case, prologue):
    """Every main-path K4 launch has a TF32 plan at one tap: the rows as a
    map one pixel wide (boxes of 128 rows), the grid covering every row and
    channel, the bf16 plan's tile, and the ring as deep as the shared
    memory holds beside the prologue's table, at most
    TF32_CONV_MAX_STAGES (deeper than bf16's cap of 3 where 4 fit)."""
    b, rows, c, co = case
    plan = tfc.conv1x1_tf32_plan(b, rows, c, co, prologue)
    assert isinstance(plan, tfc.Tf32ConvPlan)
    assert (plan.bw, plan.bh) == (1, tfc.SM90_CONV_BM)
    assert plan.grid == (-(-co // plan.bn), -(-rows // 128), b)
    stage, table = (128 + plan.bn) * 32 * 4 + 16, 8 * c if prologue else 0
    assert plan.stages == min(tfc.TF32_CONV_MAX_STAGES,
                              (kernels.SMEM_LIMIT - 1024 - table) // stage) >= 2
    assert plan.smem == 1024 + plan.stages * stage + table <= kernels.SMEM_LIMIT
    bf16 = tfc.conv1x1_sm90_plan(b, rows, c, co, prologue)
    assert (plan.bn, plan.grid) == (bf16.bn, bf16.grid)
    assert bf16.stages <= tfc.SM90_CONV1X1_MAX_STAGES <= plan.stages


@pytest.mark.parametrize("b,rows,c,co,prologue,kw", [
    (2, 4096, 48, 320, True, {}),          # C not a multiple of 32
    (2, 4096, 320, 12, True, {}),          # Co not a multiple of 8
    (2, 0, 320, 320, True, {}),            # no rows
    (0, 4096, 320, 320, True, {}),         # no image
    (2, 4096, 320, 320, False, {"stages": 5}),         # past TF32_CONV_MAX_STAGES
    (2, 4096, 16384, 320, True, {"bn": 320}),          # the table leaves room for one stage
])
def test_conv1x1_tf32_plan_refuses(b, rows, c, co, prologue, kw):
    assert tfc.conv1x1_tf32_plan(b, rows, c, co, prologue, **kw) is None


def test_conv1x1_tf32_plan_tiles_and_ring():
    """The tile follows the bf16 rule: 320 wide where Co divides into it
    and the grid fills half the SMs (1024px), else 128 (512px: 64 CTAs
    of 320 would not); a tile width the kernel has no instance of raises;
    channels of 32 (not 64) have a TF32 plan and no bf16 one; the ring is
    4 deep where it fits (3 beside the table at the 320-channel tile; the
    bf16 ring is capped at SM90_CONV1X1_MAX_STAGES), or as given."""
    assert tfc.conv1x1_tf32_plan(2, 16384, 320, 320, True).bn == 320
    assert tfc.conv1x1_tf32_plan(2, 4096, 320, 320, True).bn == 128
    with pytest.raises(ValueError):
        tfc.conv1x1_tf32_plan(2, 4096, 320, 320, True, bn=192)
    assert tfc.conv1x1_tf32_plan(1, 200, 96, 72, True) is not None
    assert tfc.conv1x1_sm90_plan(1, 200, 96, 72, True) is None
    assert tfc.conv1x1_tf32_plan(2, 4096, 320, 320, False).stages == 4
    assert tfc.conv1x1_tf32_plan(2, 16384, 320, 320, True).stages == 3
    assert tfc.conv1x1_sm90_plan(2, 4096, 320, 320, False).stages == 3
    assert tfc.conv1x1_tf32_plan(2, 4096, 320, 320, False, stages=2).stages == 2


# ------------------------------------------------------------ K4's routes

@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, tfc.ConvPlan),
                                        (torch.float32, tfc.Tf32ConvPlan)])
@pytest.mark.parametrize("prologue", [True, False], ids=["proj_in", "proj_out"])
def test_k4_route_by_dtype(dtype, kind, prologue):
    """K4's plan by dtype, with or without the prologue (the affine alone
    too, unlike K6): bf16 the Hopper kernel's, float32 the TF32 one's;
    route "wmma", other dtypes and shapes without a plan take the WMMA
    kernel."""
    assert isinstance(tfc.conv1x1_plan(dtype, 2, 4096, 320, 320, prologue), kind)
    assert tfc.conv1x1_plan(dtype, 2, 4096, 320, 320, prologue, route="wmma") is None
    assert tfc.conv1x1_plan(dtype, 2, 4096, 48, 320, prologue) is None
    assert tfc.conv1x1_plan(torch.float16, 2, 4096, 320, 320, prologue) is None


def test_k4_forced_routes():
    """"tf32" forces the float32 plan and raises where there is none (a
    bf16 launch, a shape without one); a given plan must fit the dtype; an
    unknown route raises."""
    plan = tfc.conv1x1_plan(torch.float32, 2, 4096, 320, 320, True, route="tf32")
    assert plan == tfc.conv1x1_tf32_plan(2, 4096, 320, 320, True)
    assert tfc.conv1x1_plan(torch.float32, 2, 4096, 320, 320, True, route=plan) is plan
    with pytest.raises(ValueError):
        tfc.conv1x1_plan(torch.bfloat16, 2, 4096, 320, 320, True, route="tf32")
    with pytest.raises(ValueError):
        tfc.conv1x1_plan(torch.float32, 2, 4096, 48, 320, True, route="tf32")
    with pytest.raises(ValueError):
        tfc.conv1x1_plan(torch.bfloat16, 2, 4096, 320, 320, True, route=plan)
    with pytest.raises(ValueError):
        tfc.conv1x1_plan(torch.float32, 2, 4096, 320, 320, True,
                         route=tfc.conv1x1_sm90_plan(2, 4096, 320, 320, True))
    with pytest.raises(ValueError):
        tfc.conv1x1_plan(torch.float32, 2, 4096, 320, 320, True, route="tf32swap")


def test_k4_takes_a_1x1_conv_weight_on_the_cpu():
    """A 1x1 conv's [1, 1, C, Co] weight gives what its [C, Co] matrix
    does (the plain version on CPU tensors)."""
    r = np.random.default_rng(4)
    x, w, cb = (torch.from_numpy(a.astype(np.float32)) for a in (
        r.standard_normal((2, 40, 32)), r.standard_normal((32, 24)), r.standard_normal(24)))
    s, o = torch.ones(2, 32), torch.zeros(2, 32)
    assert torch.equal(tfc.conv1x1_fused(x, w[None, None], cb, s, o),
                       tfc.conv1x1_fused(x, w, cb, s, o))


def test_tp_conv1x1_hands_over_the_weight_tensor():
    """tpl.conv1x1 hands K4 the 1x1 conv's weight as the tensor it is (its
    K-major copy is kept per tensor), on one rank and on a tp shard."""
    seen = []

    def spy(x, w, b, *a, **k):
        seen.append(w)
        return x

    p = {"w": torch.zeros(1, 1, 32, 32), "b": torch.zeros(32)}
    tpl.conv1x1(spy, torch.zeros(1, 8, 32), p)
    assert seen[-1] is p["w"]
    shard = {"w": torch.zeros(1, 1, 32, 16), "b": torch.zeros(16)}
    with tpc.use(tpc.TP(0, 2, None)):
        assert tpl.local(shard)["w"] is shard["w"]


# ------------------------------------------------------------ K4's weight copy

def test_k4_kmajor_copy_is_the_transposed_matrix():
    """K4's copy of the [C, Co] weight, or of the 1x1 conv's [1, 1, C, Co]
    one (the matrix it holds): Wᵀ [Co, C], rounded to TF32, the K order
    the kernel walks."""
    r = np.random.default_rng(5)
    w = torch.from_numpy(r.standard_normal((1, 1, 96, 40)).astype(np.float32))
    wt = tfm.kmajor(w)
    assert wt.shape == (40, 96) and wt.is_contiguous()
    assert torch.equal(wt, tfm.round_tf32(w[0, 0].t()))
    assert torch.equal(tfm.kmajor(w[0, 0].clone()), wt)
    assert wt[7, 33] == tfm.round_tf32(w[0, 0, 33, 7].reshape(1))[0]


def test_k4_kmajor_copy_made_once_refreshed_and_dropped():
    gc.collect()
    n0 = len(tfm._KMAJOR)
    w = torch.randn(1, 1, 64, 32)
    wt = tfm.kmajor(w)
    assert tfm.kmajor(w) is wt
    assert len(tfm._KMAJOR) == n0 + 1
    w.mul_(2.0)
    wt2 = tfm.kmajor(w)
    assert wt2 is not wt and torch.equal(wt2, tfm.round_tf32(w[0, 0].t()))
    del w, wt, wt2
    gc.collect()
    assert len(tfm._KMAJOR) == n0


@pytest.mark.parametrize("path", ["unet/input_blocks/1/1/proj_in/w",
                                  "unet/output_blocks/3/1/proj_out/w"])
def test_tp_proj_shard_gets_one_copy(path):
    """A tp = 2 rank's shard of proj_in / proj_out (half the output
    channels, a tensor of its own) gets one K-major copy, made once, equal
    to the whole weight's copy on the rank's channels."""
    r = np.random.default_rng(6)
    shape = (1, 1, 320, 320)
    whole = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    split = split_of(path, shape, 2)
    assert split is not None and split.dim == 3
    for rank in (0, 1):
        tp = tpc.TP(rank, 2, None)
        shard = local_part(whole, split, tp)
        assert shard.shape[-1] == 160 and shard.data_ptr() != whole.data_ptr()
        p = {"w": shard, "b": torch.zeros(320)}
        with tpc.use(tp):
            assert tpl.local(p)["w"] is shard
        wt = tfm.kmajor(shard)
        assert tfm.kmajor(shard) is wt
        assert torch.equal(wt, tfm.kmajor(whole)[rank * 160:(rank + 1) * 160])


# ------------------------------------------------------------ K9's plan

@pytest.mark.parametrize("d,tiles,stages", [(40, (64, 64), (3, 3)), (64, (32, 64), (3, 3)),
                                            (80, (32, 64), (3, 2)), (160, (16, 32), (3, 2))])
def test_k9_tf32_plan_per_width(d, tiles, stages):
    """K9's float32 plan at each head width it has an instance for: the
    dK/dV kernel's query tiles and the dQ kernel's key tiles, rings of at
    least two stages within the shared memory beside the resident rows
    (128 of them, 64 at d = 160), f32 tiles of d columns (no padding)."""
    plan = tfa.bwd_tf32_plan(d)
    assert (plan.tile_kv, plan.tile_q) == tiles
    assert (plan.stages_kv, plan.stages_q) == stages
    _, rows_kv, _, rows_q = tfa.TF32_BWD_TILES[d]
    assert rows_kv == rows_q == (64 if d == 160 else 128)
    assert plan.smem_kv == 2 * rows_kv * d * 4 + plan.stages_kv * (
        4 * plan.tile_kv * d * 4 + 2 * plan.tile_kv * 4)
    assert plan.smem_q == 2 * rows_q * d * 4 + plan.stages_q * 3 * plan.tile_q * d * 4
    assert max(plan.smem_kv, plan.smem_q) <= kernels.SMEM_LIMIT


def test_k9_route_by_dtype_and_width():
    """K9's plan by dtype: bf16 the Hopper kernel's, float32 the TF32 one's
    at d = 40, 64, 80 and 160, the WMMA kernel elsewhere and on route
    "wmma"; "tf32" raises where there is none; a d no K9 kernel takes
    raises."""
    assert isinstance(tfa.bwd_route(torch.bfloat16, 40), tfa.BwdPlan)
    assert isinstance(tfa.bwd_route(torch.float32, 40), tfa.BwdTf32Plan)
    assert tfa.bwd_route(torch.float32, 40, "tf32") == tfa.bwd_tf32_plan(40)
    for d in (24, 48, 120):
        assert tfa.bwd_tf32_plan(d) is None and tfa.bwd_route(torch.float32, d) is None
        with pytest.raises(ValueError):
            tfa.bwd_route(torch.float32, d, "tf32")
    assert tfa.bwd_route(torch.float32, 64, "wmma") is None
    assert tfa.bwd_route(torch.float16, 64) is None
    with pytest.raises(ValueError):
        tfa.bwd_route(torch.bfloat16, 64, "tf32")
    with pytest.raises(ValueError):
        tfa.bwd_route(torch.float32, 64, "tf32swap")
    for d in (0, 12, 168):
        with pytest.raises(ValueError):
            tfa.bwd_tf32_plan(d)
    assert tfa.BWD_ROUTE_NAMES[tfa.BwdTf32Plan] == "tf32"


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    """The card, with cuBLAS's TF32 off for the full-f32 plain version
    (restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _tf32_launches():
    return sum(n for key, n in tfc.conv1x1_fused.shapes.items() if key.endswith("route=tf32"))


def _within(got, want):
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


# ragged: 200 rows (the last tile 72 rows), channels of 96, Co of 72 and 40
K4_RAGGED = [(1, 200, 96, 72), (2, 333, 64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["proj_in", "proj_out", "silu_stats"])
@pytest.mark.parametrize("case", K4_MAIN + K4_RAGGED,
                         ids=[_id(c) for c in K4_MAIN] + [f"ragged_{_id(c)}" for c in K4_RAGGED])
def test_k4_tf32_matches_plain_on_card(card, case, form):
    """K4's float32 launches on route "tf32" against the plain version in
    full f32: proj_in (the affine alone), proj_out (the residual) and the
    affine with SiLU, the residual and the statistics; within TOL, counted
    under the route, the same bits on a second call; the affine's shift
    dropped fails TOL."""
    b, rows, c, co = case
    g = torch.Generator(device=card).manual_seed(90 + rows + c + co)
    x = torch.randn((b, rows, c), generator=g, device=card)
    w = torch.randn((1, 1, c, co), generator=g, device=card) * c ** -0.5
    cb = torch.randn(co, generator=g, device=card) * 0.1
    s = 1.0 + 0.1 * torch.randn((b, c), generator=g, device=card)
    o = 0.5 + 0.2 * torch.randn((b, c), generator=g, device=card)
    res = torch.randn((b, rows, co), generator=g, device=card)
    args = {"proj_in": (x, w, cb, s, o), "proj_out": (x, w, cb),
            "silu_stats": (x, w, cb, s, o)}[form]
    kw = {"proj_in": {}, "proj_out": {"residual": res},
          "silu_stats": {"residual": res, "silu": True, "emit_stats": True}}[form]
    before = _tf32_launches()
    got = tfc.conv1x1_fused(*args, **kw)
    assert _tf32_launches() == before + 1
    want = tfc.conv1x1_fused_plain(*args, **kw)
    if kw.get("emit_stats"):
        (got, st), (want, _) = got, want
        sums = torch.stack([got.sum(1), (got * got).sum(1)], dim=1)
        torch.testing.assert_close(st, sums, rtol=1e-4, atol=1e-5 * float(sums.abs().max()))
    assert _within(got, want), float((got - want).abs().max())
    again = tfc.conv1x1_fused(*args, **kw)
    assert torch.equal(again[0] if kw.get("emit_stats") else again, got)
    if len(args) > 3:
        no_shift = tfc.conv1x1_fused_plain(x, w, cb, s, torch.zeros_like(o), **kw)
        assert not _within(no_shift[0] if kw.get("emit_stats") else no_shift, want)


@pytest.mark.cuda
def test_k4_tf32_capture_on_card(card):
    """K4's float32 route captures into a CUDA graph after an eager warm-up
    (the weight's K-major copy made by it: none is made during the
    capture), and the replay gives the eager bits."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn((2, 4096, 320), generator=g, device=card)
    w = torch.randn((1, 1, 320, 320), generator=g, device=card) * 320 ** -0.5
    cb = torch.randn(320, generator=g, device=card) * 0.1
    s, o = torch.ones(2, 320, device=card), torch.zeros(2, 320, device=card)
    eager = tfc.conv1x1_fused(x, w, cb, s, o)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            out = tfc.conv1x1_fused(x, w, cb, s, o)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
