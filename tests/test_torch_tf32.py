"""K2's and K5's float32 routes (csrc/gemm_tf32_sm90.cu,
csrc/attention_tf32_sm90.cu): their plans, the route each launch takes by
dtype and width, the weights' K-major TF32 copies and the TF32 rounding,
here on the CPU; and, marked `cuda`, the float32 routes against the plain
versions on the card at every main-path shape (SD v1.4 at 512px
and 1024px, SD v2.1's d = 64) and at ragged ones. No jax here: the algorithm
is held against sdtpu in tests/test_torch_tf32_walk.py.
"""

import gc

import numpy as np
import pytest
import torch

from sdtpu_torch import kernels
from sdtpu_torch.lora import apply_lora
from sdtpu_torch.models import unet as unet_model
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.ops import fused_transformer as tft

torch.set_num_threads(1)

# (B, S, C) of K5's launches on the main paths: 512px and 1024px at UNet batch
# 2, the two-pass mode's batch 1, the serve phase's batch 8 (S < 2048 only)
K5_MAIN = [(2, 1024, 640), (2, 256, 1280), (2, 1024, 1280), (1, 1024, 640), (1, 256, 1280),
           (8, 1024, 640), (8, 256, 1280)]
# (B, S, C, heads) of K2's: 512px, 1024px (its 16384-token level apart: the
# plain version's scores would take 17 GB in f32), batch 1 and 8, and SD
# v2.1 at 768px (d = 64: 5 heads at 96², 10 at 48²)
K2_MAIN = [(2, 4096, 320, 8), (2, 1024, 640, 8), (2, 256, 1280, 8), (2, 4096, 640, 8),
           (2, 1024, 1280, 8), (1, 4096, 320, 8), (8, 1024, 640, 8), (8, 256, 1280, 8),
           (2, 9216, 320, 5), (2, 2304, 640, 10)]


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("b,s,c", K5_MAIN)
def test_k5_tf32_plans_at_main_path_shapes(b, s, c):
    """Both products of K5 have a plan: 128-row tiles, the GEGLU product on
    128-column tiles (val and gate), the stages within the shared memory
    beside the LayerNorm's staged γ and β, and the grid covering every row
    and column."""
    m = b * s
    p1 = tfm.tf32_plan(m, 4 * c, c, True)
    p2 = tfm.tf32_plan(m, c, 4 * c, False)
    for p, n, ln in ((p1, 4 * c, True), (p2, c, False)):
        assert p.grid == (-(-n // p.bn), -(-m // 128))
        assert 2 <= p.stages <= tfm.TF32_MAX_STAGES
        static = 2 * tfm.TF32_LN_MAX_K * 4 if ln else 8
        assert p.smem + static <= kernels.SMEM_LIMIT
    assert p1.bn == 128


def test_tf32_plan_tiles_at_main_path_shapes():
    """The tile counts at K5's 512px shapes, batch 2: the GEGLU
    product 20 x 16 CTAs of 128 x 128 (and 4 stages of 48 KB), the second
    product 5 x 16 (6 stages of 32 KB); at 256 tokens and C = 1280, 64-column
    tiles where 128 would not fill half the card."""
    p1 = tfm.tf32_plan(2048, 2560, 640, True)
    assert (p1.bn, p1.grid, p1.stages) == (128, (20, 16), 4)
    p2 = tfm.tf32_plan(2048, 640, 2560, False)
    assert (p2.bn, p2.grid, p2.stages) == (128, (5, 16), 6)
    p3 = tfm.tf32_plan(512, 1280, 5120, False)
    assert (p3.bn, p3.grid) == (64, (20, 4))


@pytest.mark.parametrize("m,n,k,geglu,ln", [
    (100, 36, 64, False, False),     # n not a multiple of 8
    (100, 64, 66, False, False),     # k not a multiple of 4
    (100, 64, 2560, True, True),     # a LayerNorm over more than 2048 columns
    (0, 64, 64, False, False),       # no rows
])
def test_tf32_plan_refuses(m, n, k, geglu, ln):
    with pytest.raises(ValueError):
        tfm.tf32_plan(m, n, k, geglu, ln)


@pytest.mark.parametrize("d,tile,stages,smem", [
    (40, 32, 4, 61440), (64, 64, 4, 163840), (80, 64, 4, 204800), (160, 32, 3, 204800)])
def test_k2_tf32_core_plan(d, tile, stages, smem):
    """The float32 core at the UNet's head widths and SD v2.1's: 64-key
    tiles where three stages of f32 K and Vᵀ tiles fit beside Q (d = 64,
    80), else 32 (d = 160), and 32 at d = 40, where two CTAs share an SM."""
    plan = tft.tf32_core_plan(d)
    assert plan == (tile, stages, smem)
    assert plan.smem <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("d", [8, 24, 48, 96, 128, 512])
def test_k2_tf32_core_has_no_other_width(d):
    assert tft.tf32_core_plan(d) is None


@pytest.mark.parametrize("d", tfa.TF32_CORE_WIDTHS)
def test_k2_tf32_core_tiles(d):
    """One instance a head width, the plan's tile TF32_CORE_TILE[d]; at d =
    40 two CTAs share an SM (each takes at most half the shared memory)."""
    plan = tft.tf32_core_plan(d)
    assert plan.tile == tfa.TF32_CORE_TILE[d] and plan.smem <= kernels.SMEM_LIMIT
    assert (2 * plan.smem <= kernels.SMEM_LIMIT) == (d == 40)


@pytest.mark.parametrize("b,s,c,heads", K2_MAIN + [(2, 16384, 320, 8)])
def test_k2_tf32_plan_at_main_path_shapes(b, s, c, heads):
    plan = tft.tf32_plan(b, s, c, heads)
    assert plan is not None
    assert plan.qkv.grid[1] == plan.out.grid[1] == -(-b * s // 128)
    assert plan.core == tft.tf32_core_plan(c // heads)
    # a tensor-parallel rank's half of the heads
    assert tft.tf32_plan(b, s, c, heads // 2 if heads % 2 == 0 else heads, c // 2
                         if heads % 2 == 0 else c) is not None


@pytest.mark.parametrize("b,s,c,heads", [
    (2, 200, 120, 5),    # d = 24: no core instance
    (2, 77, 320, 8),     # S not a multiple of 8 (V's transposed groups of 8 keys)
    (1, 256, 2560, 16),  # a LayerNorm wider than 2048
    (1, 256, 320, 3),    # heads that do not divide C
])
def test_k2_tf32_plan_refuses(b, s, c, heads):
    assert tft.tf32_plan(b, s, c, heads) is None


# ------------------------------------------------------------ routes

def test_k5_route_by_dtype_and_width():
    """bf16 takes the Hopper route, float32 "tf32" below the LayerNorm's
    limit and the WMMA kernel above it; a forced route must fit the dtype."""
    assert tfm.route_of(torch.bfloat16, 640, 2560) == "sm90"
    assert tfm.route_of(torch.float32, 640, 2560) == "tf32"
    assert tfm.route_of(torch.float32, 4096, 16384) == "wmma"
    for r in ("wmma", "tf32"):
        assert tfm.route_of(torch.float32, 640, 2560, r) == r
    assert tfm.route_of(torch.bfloat16, 640, 2560, "wmma") == "wmma"
    for dtype, r in ((torch.bfloat16, "tf32"), (torch.float32, "sm90"),
                     (torch.float32, "cublas"), (torch.float32, "tf32swap")):
        with pytest.raises(ValueError):
            tfm.route_of(dtype, 640, 2560, r)


def test_k2_route_by_dtype_and_width():
    """K2's plan by dtype: bf16 the Hopper plan, float32 the TF32 plan at d
    = 40/64/80/160 and S % 8 == 0 and None (the WMMA route) elsewhere; the
    forced TF32 route raises where it has no plan or the dtype is not
    float32."""
    assert isinstance(tft.route_plan(torch.bfloat16, 2, 4096, 320, 8), tft.Sm90Plan)
    plan = tft.route_plan(torch.float32, 2, 4096, 320, 8)
    assert isinstance(plan, tft.Tf32Plan)
    assert tft.route_plan(torch.float32, 2, 4096, 320, 8, route="tf32") == plan
    assert tft.route_plan(torch.float32, 2, 200, 120, 5) is None      # d = 24
    assert tft.route_plan(torch.float32, 2, 4096, 320, 8, route="wmma") is None
    with pytest.raises(ValueError):
        tft.route_plan(torch.float32, 2, 200, 120, 5, route="tf32")
    with pytest.raises(ValueError):
        tft.route_plan(torch.bfloat16, 2, 4096, 320, 8, route="tf32")
    for r in ("sm80", "tf32swap"):
        with pytest.raises(ValueError):
            tft.route_plan(torch.float32, 2, 4096, 320, 8, route=r)


# ------------------------------------------------------------ TF32 rounding

def _rna_reference(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 of finite f32 values: the magnitude rounded to 10
    mantissa bits, ties away from zero."""
    mag = np.abs(a).astype(np.float64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = 2.0 ** (e - 10)
    r = np.floor(mag / ulp + 0.5) * ulp
    return (np.sign(a) * np.where(mag > 0, r, 0.0)).astype(np.float32)


def test_round_tf32_is_round_to_nearest_away():
    r = np.random.default_rng(0)
    a = np.concatenate([r.standard_normal(4096).astype(np.float32),
                        (r.standard_normal(512) * 1e-20).astype(np.float32),
                        np.float32([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 0.0])])
    got = tfm.round_tf32(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(a))
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    assert got[-4] == np.float32(1 + 2 ** -10)  # a tie away from zero
    assert got[-2] == np.float32(-(1 + 2 ** -10))


# ------------------------------------------------------------ K-major copies

def test_kmajor_copy_is_built_once_and_refreshed():
    """The float32 route's copy of a weight: Wᵀ rounded to TF32, contiguous; the
    same tensor while the weight is unchanged; made anew after the weight is
    changed in place; gone with the weight."""
    gc.collect()
    n0 = len(tfm._KMAJOR)
    w = torch.randn(64, 96)
    wt = tfm.kmajor(w)
    assert wt.shape == (96, 64) and wt.is_contiguous()
    assert torch.equal(wt, tfm.round_tf32(w.t()))
    assert tfm.kmajor(w) is wt
    assert tfm.kmajor_bytes() >= 96 * 64 * 4
    w.mul_(2.0)
    wt2 = tfm.kmajor(w)
    assert wt2 is not wt and torch.equal(wt2, tfm.round_tf32(w.t()))
    del w, wt, wt2
    gc.collect()
    assert len(tfm._KMAJOR) == n0


def test_kmajor_copy_follows_a_lora_merge():
    """lora.apply_lora gives the adapted weights as new tensors: each gets
    its own K-major copy, of the merged values, and the base weight's copy
    stays the base's."""
    r = np.random.default_rng(3)
    base = {"ff": {"proj": {"w": torch.from_numpy(r.standard_normal((32, 64)).astype(np.float32)),
                            "b": torch.zeros(64)}}}
    lora = {"ff": {"proj": {"a": r.standard_normal((32, 4)).astype(np.float32),
                            "b": r.standard_normal((4, 64)).astype(np.float32)}}}
    w0 = base["ff"]["proj"]["w"]
    c0 = tfm.kmajor(w0)
    merged = apply_lora(base, lora, 0.5)["ff"]["proj"]["w"]
    c1 = tfm.kmajor(merged)
    assert merged is not w0 and c1 is not c0
    assert torch.equal(c1, tfm.round_tf32(merged.t()))
    assert not torch.equal(c1, c0)
    assert tfm.kmajor(w0) is c0


def _attn1(seed, c=16):
    r = np.random.default_rng(seed)
    return {k: {"w": torch.from_numpy(r.standard_normal((c, c)).astype(np.float32))}
            for k in ("query", "key", "value")}


def test_self_attention_qkv_takes_the_fused_leaf():
    """A tree with fuse_qkv's leaf hands K2 that leaf itself."""
    a1 = unet_model.fuse_qkv({"attn1": _attn1(4)})["attn1"]
    assert unet_model.self_attention_qkv(a1) is a1["qkv"]["w"]


def test_self_attention_qkv_is_made_once_per_weights():
    """An unfused tree's [Wq | Wk | Wv] is made at the first call and the
    same tensor after (so K2's float32 route keeps one K-major copy of it);
    made anew after a weight changes in place; gone with the weights."""
    gc.collect()
    n0 = len(unet_model._QKV)
    a1 = _attn1(5)
    w = unet_model.self_attention_qkv(a1)
    assert torch.equal(w, torch.cat([a1[k]["w"] for k in ("query", "key", "value")], dim=1))
    assert unet_model.self_attention_qkv(a1) is w
    assert tfm.kmajor(unet_model.self_attention_qkv(a1)) is tfm.kmajor(w)
    a1["key"]["w"].mul_(2.0)
    w2 = unet_model.self_attention_qkv(a1)
    assert w2 is not w and torch.equal(w2[:, 16:32], a1["key"]["w"])
    del a1, w, w2
    gc.collect()
    assert len(unet_model._QKV) == n0


def test_self_attention_qkv_is_not_kept_under_autograd():
    """Weights that autograd records get a new concatenation each call (a
    kept one would hold a graph), and none is kept."""
    a1 = _attn1(6)
    for p in a1.values():
        p["w"].requires_grad_(True)
    n0 = len(unet_model._QKV)
    w = unet_model.self_attention_qkv(a1)
    assert w.requires_grad and unet_model.self_attention_qkv(a1) is not w
    assert len(unet_model._QKV) == n0
    with torch.no_grad():
        assert unet_model.self_attention_qkv(a1) is unet_model.self_attention_qkv(a1)


@pytest.mark.parametrize("fused", [False, True])
def test_unet_apply_hands_k2_one_operand_across_calls(monkeypatch, fused):
    """Two UNet calls on the same tree, fused (the pipeline's) or sdtpu's
    unfused one, hand K2 the same [Wq | Wk | Wv] tensor each time, and the
    outputs agree between the two trees."""
    import dataclasses

    from sdtpu_torch.config import SD_TINY, UNetConfig
    from sdtpu_torch.weights import init_params

    cfg = dataclasses.replace(SD_TINY, unet=UNetConfig(
        model_channels=32, channel_mult=(1, 2), attention_levels=(0,), n_head=4,
        context_dim=32, time_embed_dim=64, groupnorm_groups=4))
    unet = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["unet"]
    seen = []
    real = unet_model.fused_self_attention

    def spy(x, ln_g, ln_b, wqkv, *a, **k):
        seen.append(wqkv)
        return real(x, ln_g, ln_b, wqkv, *a, **k)

    monkeypatch.setattr(unet_model, "fused_self_attention", spy)
    g = torch.Generator().manual_seed(1)
    x, ctx = torch.randn((1, 16, 16, 4), generator=g), torch.randn((1, 7, 32), generator=g)
    t = torch.tensor([481.0])
    tree = unet_model.fuse_qkv(unet) if fused else unet
    with torch.no_grad():
        y1 = unet_model.unet_apply(tree, x, t, ctx, cfg.unet)
        n = len(seen)
        y2 = unet_model.unet_apply(tree, x, t, ctx, cfg.unet)
        y3 = unet_model.unet_apply(unet if fused else unet_model.fuse_qkv(unet), x, t, ctx,
                                   cfg.unet)
    assert n > 0 and len(seen) == 3 * n
    assert all(a is b for a, b in zip(seen[:n], seen[n:2 * n]))
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y3, y1, rtol=1e-5, atol=1e-5)


def test_vt_order_groups_of_eight():
    """The core's V layout: [B, H, d, S], each group of 8 keys in the order
    0, 2, 4, 6, 1, 3, 5, 7."""
    v = torch.arange(2 * 16 * 6, dtype=torch.float32).view(2, 16, 6)
    vt = tft.vt_order(v, 2)
    assert vt.shape == (2, 2, 3, 16)
    keys = vt[1, 1, 2] - v[1, 0, 5]
    assert keys.tolist() == [6.0 * k for k in (0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11,
                                               13, 15)]


# ------------------------------------------------------------ on the card

def _card(arrays, dev):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]


def _mlp_args(b, s, c, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, c)), 1.0 + 0.1 * r.standard_normal(c),
            0.1 * r.standard_normal(c), r.standard_normal((c, 8 * c)) * c ** -0.5,
            0.1 * r.standard_normal(8 * c), r.standard_normal((4 * c, c)) * (4 * c) ** -0.5,
            0.1 * r.standard_normal(c))


def _attn_args(b, s, c, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, c)), 1.0 + 0.1 * r.standard_normal(c),
            0.1 * r.standard_normal(c), r.standard_normal((c, 3 * c)) * c ** -0.5,
            r.standard_normal((c, c)) * c ** -0.5, 0.1 * r.standard_normal(c))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _routes(fn):
    out = {}
    for key, n in fn.shapes.items():
        route = key.rsplit("route=", 1)[-1] if "route=" in key else None
        out[route] = out.get(route, 0) + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", K5_MAIN + [(1, 1000, 640), (3, 333, 1280), (2, 100, 48)])
def test_k5_tf32_matches_plain_on_card(b, s, c):
    """K5's float32 route against the plain version in full f32 (TF32
    off): within chip_smoke.py's float32 tolerance (5e-3), counted under its
    route, the same bits on a second call; and the residual-free partial sum
    (a tensor-parallel rank's)."""
    dev = _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _card(_mlp_args(b, s, c, 50), dev)
    before = _routes(tfm.fused_geglu_mlp).get("tf32", 0)
    got = tfm.fused_geglu_mlp(*args)
    assert _routes(tfm.fused_geglu_mlp)["tf32"] == before + 1
    want = tfm.fused_geglu_mlp_plain(*args)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
    assert torch.equal(tfm.fused_geglu_mlp(*args), got)
    part = tfm.fused_geglu_mlp(*args, residual=False)
    torch.testing.assert_close(part, tfm.fused_geglu_mlp_plain(*args, residual=False),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,heads", K2_MAIN + [(1, 200, 320, 8), (2, 136, 640, 8),
                                                   (1, 96, 1280, 8)])
def test_k2_tf32_matches_plain_on_card(b, s, c, heads):
    """K2's float32 route (the QKV product with V written transposed, the
    TF32 core, the Wo product) against the plain version in full f32: the sublayer within 5e-3, the attention term within 2^-8 of
    its largest |reference| + 2^-10 of |out| (chip_smoke.py's FLASH_TOL),
    which the sublayer over every other key fails; counted under its route;
    the same bits on a second call. Ragged: S = 200 and 136 (the last query
    and key tiles), 96 (one key tile at d = 160)."""
    dev = _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _card(_attn_args(b, s, c, 51), dev)
    before = _routes(tft.fused_self_attention).get("tf32", 0)
    got = tft.fused_self_attention(*args, heads)
    assert _routes(tft.fused_self_attention)["tf32"] == before + 1
    want = tft.fused_self_attention_plain(*args, heads)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
    term = want - args[0]
    a = 2 ** -8 * float(term.abs().max())
    assert ((got - want).abs() <= a + 2 ** -10 * want.abs()).all()
    x, g, bb, wqkv, wo, bo = args
    xn = torch.nn.functional.layer_norm(x, (c,), g, bb, 1e-5)
    q, k, v = (xn @ wqkv).chunk(3, dim=-1)
    from sdtpu_torch.ops.attention import qkv_attention_plain
    half = x + qkv_attention_plain(q, k[:, ::2], v[:, ::2], None, heads) @ wo + bo
    assert not ((half - want).abs() <= a + 2 ** -10 * want.abs()).all()
    assert torch.equal(tft.fused_self_attention(*args, heads), got)


@pytest.mark.cuda
def test_tf32_routes_default_and_capture_on_card():
    """A float32 launch of each wrapper takes route "tf32" by default, and
    both capture into a CUDA graph (no host sync, no allocation at launch:
    the K-major copies made by the eager warm-up) whose replay gives the
    eager bits."""
    dev = _need_card()
    a5 = _card(_mlp_args(2, 256, 1280, 52), dev)
    a2 = _card(_attn_args(2, 1024, 640, 53), dev)
    before5 = _routes(tfm.fused_geglu_mlp).get("tf32", 0)
    before2 = _routes(tft.fused_self_attention).get("tf32", 0)
    e5, e2 = tfm.fused_geglu_mlp(*a5), tft.fused_self_attention(*a2, 8)
    assert _routes(tfm.fused_geglu_mlp)["tf32"] == before5 + 1
    assert _routes(tft.fused_self_attention)["tf32"] == before2 + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        tfm.fused_geglu_mlp(*a5), tft.fused_self_attention(*a2, 8)  # warm-up
        with torch.cuda.graph(graph, stream=side):
            g5, g2 = tfm.fused_geglu_mlp(*a5), tft.fused_self_attention(*a2, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g5, e5) and torch.equal(g2, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", tfa.TF32_CORE_WIDTHS)
def test_k2_tf32_core_on_card_at_each_width(d):
    """The float32 core alone, at each head width's instance, against the
    plain attention on the same
    TF32-rounded q, k, v: within 2^-8 of the largest |reference| + 2^-10
    of |out| (chip_smoke.py's FLASH_TOL); S = 200, the last key and query
    tiles ragged."""
    dev = _need_card()
    from sdtpu_torch.ops.attention import qkv_attention_plain

    b, s, heads = 2, 200, 2
    r = np.random.default_rng(54 + d)
    q, k, v = (tfm.round_tf32(t) for t in _card([r.standard_normal((b, s, d * heads))
                                                 for _ in range(3)], dev))
    want = qkv_attention_plain(q, k, v, None, heads)
    a = 2 ** -8 * float(want.abs().max())
    qk, vt = torch.cat([q, k], dim=-1), tft.vt_order(v, heads)
    out = torch.empty_like(q)
    tft.attention_core_tf32(qk, vt, out, heads, tft.tf32_core_plan(d))
    assert ((out - want).abs() <= a + 2 ** -10 * want.abs()).all()
