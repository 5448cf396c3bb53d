"""K1's and K10's float32 routes (csrc/attention_tf32_sm90.cu with the key
bias, the lse, and q and k rounded by the pre-pass's copies;
csrc/attention_wide_tf32_sm90.cu at d = 512; the V pre-pass's K-major
copy): their plans, the route each launch takes by dtype and width, and
the forced routes, here on the CPU; and, marked `cuda`, the float32 routes
against the plain versions on the card at the main paths' shapes and at
ragged ones, and an f32 K1 -> K9 pass repeated bit for bit. No jax here:
the walks are held against sdtpu in tests/test_torch_tf32_walk.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_cross_attention as tfx
from sdtpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(1)

# (B, S, C, heads) of K10's launches with the gate open: SD v1.4's UNet at
# 512px (batch 2, the two-pass mode's 1, the serve phase's 4 and 8), SD
# v2.1's 48² level (10 heads of 64) and its 96², 24² levels (5 and 20)
K10_MAIN = [(b, s, c, 8) for b in (1, 2, 4, 8) for s, c in ((4096, 320), (1024, 640),
                                                             (256, 1280))] + [
    (2, 2304, 640, 10), (2, 9216, 320, 5), (2, 576, 1280, 20)]


# ------------------------------------------------------------ K1's plans

@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("d,tile,stages", [(40, 32, 4), (64, 64, 4), (80, 64, 4), (160, 32, 3)])
def test_k1_tf32_plan_per_width(d, tile, stages, bias):
    """float32 at d = 40, 64, 80 and 160 takes the TF32 core with K2's tile
    per width, with and without the key bias (read with the scores, no
    shared memory): Q's 128 rows and the ring's K and Vᵀ tiles within the
    shared memory, at least three stages (the ring runs stages − 2 tiles
    ahead)."""
    plan = tfa.fwd_route(torch.float32, d, bias)
    assert isinstance(plan, tfa.Tf32CorePlan) and plan == tfa.tf32_core_plan(d)
    assert (plan.tile, plan.stages) == (tile, stages)
    assert plan.smem == 128 * d * 4 + stages * 2 * tile * d * 4 <= kernels.SMEM_LIMIT
    assert tfa.ROUTE_NAMES[type(plan)] == "tf32"


@pytest.mark.parametrize("d", [512, 504])
def test_k1_wide_tf32_plan(d):
    """float32 at the widths that pad to 512 takes the TF32 wide kernel: Q
    (64 rows of 512 f32), two stages of an 8-key K and Vᵀ tile and the two
    warpgroups' partial scores, what the source's static_assert holds."""
    plan = tfa.fwd_route(torch.float32, d, False)
    assert isinstance(plan, tfa.WideTf32Plan) and plan == tfa.wide_tf32_plan(d)
    assert (plan.dpad, plan.tile) == (512, 8)
    assert plan.smem == 64 * 512 * 4 + 2 * 2 * 8 * 512 * 4 + 2 * 128 * 4 * 4 == 200704
    assert plan.smem <= kernels.SMEM_LIMIT
    assert tfa.ROUTE_NAMES[type(plan)] == "wide_tf32"
    src = Path(kernels.__file__).parent / "csrc" / "attention_wide_tf32_sm90.cu"
    assert f"X_SMEM == {plan.smem}" in src.read_text()


@pytest.mark.parametrize("d", [8, 24, 32, 48, 56, 96, 128, 144, 256, 496])
def test_k1_tf32_refuses_widths_without_an_instance(d):
    """A float32 width with no TF32 instance goes to the WMMA kernel
    ("wmma"), counted there; bf16 keeps its own plans."""
    assert tfa.fwd_route(torch.float32, d, False) is None
    assert tfa.fwd_route(torch.float32, d, True) is None
    assert tfa.ROUTE_NAMES[type(None)] == "wmma"


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
def test_k1_route_by_dtype(d):
    """The route each dtype takes: bf16 the Hopper kernels (sm90, wide),
    float32 the TF32 ones (tf32, wide_tf32), other dtypes the WMMA kernel."""
    names = {dt: tfa.ROUTE_NAMES[type(tfa.fwd_route(dt, d, False))]
             for dt in (torch.bfloat16, torch.float32, torch.float16)}
    wide = d == 512
    assert names == {torch.bfloat16: "wide" if wide else "sm90",
                     torch.float32: "wide_tf32" if wide else "tf32", torch.float16: "wmma"}


def test_k1_forced_routes():
    """A launch's route (fwd_plan): "auto" by dtype and width, "wmma" the
    WMMA kernel whatever the dtype; any other name raises, before any
    launch (_attend resolves it first, on the CPU too, whose tensors then
    take the plain version)."""
    assert tfa.fwd_plan(torch.float32, 40, False) == tfa.tf32_core_plan(40)
    assert tfa.fwd_plan(torch.float32, 512, False) == tfa.wide_tf32_plan(512)
    assert tfa.fwd_plan(torch.bfloat16, 40, False) == tfa.core_sm90_plan(40)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert tfa.fwd_plan(dtype, 40, True, "wmma") is None
        for route in ("tf32", "wide", "sm90", tfa.tf32_core_plan(40)):
            with pytest.raises(ValueError):
                tfa.fwd_plan(dtype, 40, False, route)
    q = torch.zeros(1, 1, 8, 40)
    out = torch.empty_like(q)
    tfa._attend(q, q, q, None, out, None, "wmma")  # the plain version on the CPU
    with pytest.raises(ValueError):
        tfa._attend(q, q, q, None, out, None, "tf32")


def test_v_copy_order_matches_the_fragments():
    """The pre-pass's key order (position p of a group of 8 holds key
    (p % 4)·2 + p / 4) is K2's QKV epilogue's: its plain form,
    fused_transformer.vt_order, and the inverse of chip_smoke.py's KEY_POS."""
    from sdtpu_torch.ops import fused_transformer as tft

    s = 16
    v = torch.arange(s, dtype=torch.float32).view(1, s, 1).expand(1, s, 8).contiguous()
    order = tft.vt_order(v, 1)[0, 0, 0]
    assert order.tolist() == [0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15]
    assert [(p % 4) * 2 + p // 4 for p in range(8)] == order[:8].int().tolist()


# ------------------------------------------------------------ K10's plans

@pytest.mark.parametrize("b,s,c,heads", K10_MAIN)
def test_k10_tf32_plan_at_main_path_shapes(b, s, c, heads):
    """float32 takes K10's TF32 route at every UNet shape: the Q product
    (LayerNorm prologue) and the Wo product on csrc/gemm_tf32_sm90.cu at [m,
    C]·[C, C], the core on K1's float32 instance, with and without the key
    bias (the same plan)."""
    plan = tfx.route_plan(torch.float32, b, s, c, heads, 77, True)
    assert isinstance(plan, tfx.Tf32Plan)
    assert plan == tfx.route_plan(torch.float32, b, s, c, heads, 77, False)
    m, d = b * s, c // heads
    assert plan.q == tfm.tf32_plan(m, c, c, False, ln=True)
    assert plan.out == tfm.tf32_plan(m, c, c, False)
    assert plan.core == tfa.tf32_core_plan(d) and -(-77 // plan.core.tile) in (2, 3)
    for p in (plan.q, plan.out):
        assert p.smem <= kernels.SMEM_LIMIT and p.grid == (-(-c // p.bn), -(-m // tfm.TF32_BM))


@pytest.mark.parametrize("b,s,c", [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280),
                                   (1, 4096, 320)])
def test_k10_tf32_plan_tp2(b, s, c):
    """A tensor-parallel rank's half: 4 of the 8 heads over Ci = C / 2, the
    products [m, C]·[C, Ci] and [m, Ci]·[Ci, C]."""
    ci = c // 2
    plan = tfx.route_plan(torch.float32, b, s, c, 4, 77, True, ci)
    assert isinstance(plan, tfx.Tf32Plan) and plan.core == tfa.tf32_core_plan(ci // 4)
    assert plan.q == tfm.tf32_plan(b * s, ci, c, False, ln=True)
    assert plan.out == tfm.tf32_plan(b * s, c, ci, False)


@pytest.mark.parametrize("b,s,c,heads,sk", [
    (2, 256, 768, 8, 77),    # d = 96: no core instance
    (2, 256, 2560, 16, 77),  # d = 160, but C past the LayerNorm prologue's 2048
    (2, 256, 320, 8, 129),   # more keys than the kernel takes
    (2, 256, 320, 7, 77),    # the heads do not divide C
])
def test_k10_tf32_plan_leaves_other_shapes_to_the_wmma_route(b, s, c, heads, sk):
    assert tfx.route_plan(torch.float32, b, s, c, heads, sk, True) is None


def test_k10_route_by_dtype():
    assert isinstance(tfx.route_plan(torch.bfloat16, 2, 4096, 320, 8, 77, True), tfx.Sm90Plan)
    assert isinstance(tfx.route_plan(torch.float32, 2, 4096, 320, 8, 77, True), tfx.Tf32Plan)
    assert tfx.route_plan(torch.float16, 2, 4096, 320, 8, 77, True) is None


def test_k10_heads_of_reads_rows_through_their_strides():
    """_heads_of: [B, S, C] rows (the UNet's transposed kt/vt read back as
    rows) -> [B, H, S, d] through the rows' own strides, no copy."""
    kv = torch.arange(2 * 5 * 16, dtype=torch.float32).view(2, 5, 16)
    k = kv[..., :8]  # the left half of each row, as fused_cross_attention's kv buffer
    h = tfx._heads_of(k, 2)
    assert h.shape == (2, 2, 5, 4) and h.data_ptr() == k.data_ptr()
    torch.testing.assert_close(h, k.reshape(2, 5, 2, 4).transpose(1, 2))


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _key_bias(b, sk, seed):
    n = np.random.default_rng(seed).integers(1, sk + 1, size=b)
    return np.where(np.arange(sk)[None] < n[:, None], 0.0, -1e30).astype(np.float32)


F32 = (2 ** -8, 2 ** -10)  # chip_smoke.py's FLASH_TOL for float32 (TF32 products)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n_head,sq,sk,d,bias", [
    (32, 8, 300, 333, 40, False),   # training's heads; ragged query and key tiles
    (16, 8, 256, 2100, 40, True),   # past 2048 keys, Sk not a multiple of 8
    (4, 2, 200, 200, 40, True),     # the ragged key counts of the CPU walks
    (4, 2, 300, 384, 64, True),
    (10, 5, 256, 512, 64, False),   # SD v2.1's heads
    (4, 2, 200, 130, 80, True),
    (2, 2, 129, 257, 160, True),
    (2, 1, 200, 200, 512, False),   # the wide kernel: a ragged query tile
    (2, 2, 129, 300, 512, True),    # the bias at d = 512
    (2, 1, 100, 130, 504, False),   # a width that pads to 512
])
def test_k1_tf32_matches_plain_on_card(bh, n_head, sq, sk, d, bias):
    """K1's float32 routes against the plain version, with the rows'
    log-sum-exp: the output within 2^-8 of its largest |reference| + 2^-10
    relative, the lse within 2^-9, as chip_smoke.py holds them; counted
    under "tf32" (d <= 160) or "wide_tf32" (d = 512); the same bits on a
    second call. The tolerances reject an all-zero output, one over every
    other key, one that ignores the bias, and an lse in natural log."""
    dev = _card()
    r = np.random.default_rng(70 + d + sk)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, s, d)).astype(np.float32)).to(dev)
               for s in (sq, sk, sk))
    kb = torch.from_numpy(_key_bias(bh // n_head, sk, 11)).to(dev) if bias else None
    route = "wide_tf32" if d > 160 else "tf32"
    before = dict(tfa.flash_attention_heads.shapes)
    got, lse = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    new = {key: n - before.get(key, 0) for key, n in tfa.flash_attention_heads.shapes.items()
           if n != before.get(key, 0)}
    assert list(new.values()) == [1] and next(iter(new)).endswith(f"route={route}")
    want, want_lse = tfa.flash_attention_heads_plain(q, k, v, kb, n_head, return_lse=True)
    frac, rtol = F32
    atol = frac * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2 ** -9)
    wrong = [torch.zeros_like(want), tfa.flash_attention_heads_plain(
        q, k[:, ::2], v[:, ::2], None if kb is None else kb[:, ::2], n_head)]
    if bias:
        wrong.append(tfa.flash_attention_heads_plain(q, k, v, None, n_head))
    for w in wrong:
        assert not torch.allclose(w, want, rtol=rtol, atol=atol)
    assert not torch.allclose(lse * np.log(2.0), want_lse, rtol=0, atol=2 ** -9)
    again, lse2 = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    assert torch.equal(again, got) and torch.equal(lse2, lse)


@pytest.mark.cuda
def test_k1_tf32_heads_inside_rows_on_card():
    """Heads side by side in [B, S, C] rows (flash_qkv_attention, the
    training forward's layout) at d = 40 and at d = 512: the cores and the
    V pre-pass read them through their strides."""
    from sdtpu_torch.ops import attention as tattn

    dev = _card()
    r = np.random.default_rng(71)
    for c, heads in ((320, 8), (1024, 2)):
        q, k, v = (torch.from_numpy(r.standard_normal((2, 150, c)).astype(np.float32)).to(dev)
                   for _ in range(3))
        got = tfa.flash_qkv_attention(q, k, v, heads)
        want = tattn.qkv_attention_plain(q, k, v, None, heads)
        atol = F32[0] * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=F32[1], atol=atol)


@pytest.mark.cuda
def test_k1_k9_tf32_pass_repeats_bit_for_bit_on_card():
    """An f32 K1 -> K9 pass (training's heads, ragged): K1 on "tf32", K9 on
    its TF32 route from K1's o and lse, every gradient within 2^-8 of its
    largest |reference| + 2^-10 relative of the plain backward (P rebuilt
    from the lse sums to 1 over K9's own TF32 scores: q and k rounded alike
    in both kernels), and the same bits on a second pass."""
    dev = _card()
    r = np.random.default_rng(72)
    q, k, v, do = (torch.from_numpy(r.standard_normal((16, 300, 40)).astype(np.float32))
                   .to(dev) for _ in range(4))

    def run():
        o, lse = tfa.flash_attention_heads(q, k, v, n_head=8, return_lse=True)
        return (o, lse, *tfa.flash_attention_bwd_heads(q, k, v, do, o, lse, n_head=8))

    before = (dict(tfa.flash_attention_heads.shapes), dict(tfa.flash_attention_bwd_heads.shapes))
    first = run()
    for fn, was in zip((tfa.flash_attention_heads, tfa.flash_attention_bwd_heads), before):
        new = [key for key, n in fn.shapes.items() if n != was.get(key, 0)]
        assert len(new) == 1 and new[0].endswith("route=tf32")
    want = tfa.flash_attention_bwd_heads_plain(q, k, v, do)
    for g, w in zip(first[2:], want):
        torch.testing.assert_close(g, w, rtol=F32[1], atol=F32[0] * float(w.abs().max()))
    second = run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _k10_args(dev, b, s, c, ci, seed, sk=77, view=True):
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return torch.from_numpy((r.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    ctx = n(b, sk, 768)
    kt, vt = (torch.matmul(ctx, n(768, ci, scale=768 ** -0.5)).transpose(1, 2)
              for _ in range(2))
    if not view:
        kt, vt = kt.contiguous(), vt.contiguous()
    valid = torch.arange(sk, device=dev)[None] < torch.tensor(
        ([2, 9] * b)[:b], device=dev)[:, None].clamp(max=sk)
    return (n(b, s, c), kt, vt, n(c, scale=0.1) + 1.0, n(c, scale=0.1),
            n(c, ci, scale=c ** -0.5), n(ci, c, scale=ci ** -0.5), n(c, scale=0.1)), valid


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,heads,ci,residual,sk,view", [
    (2, 4096, 320, 8, 320, True, 77, True), (2, 1024, 640, 8, 640, True, 77, True),
    (2, 256, 1280, 8, 1280, True, 77, True), (1, 4096, 320, 8, 320, True, 77, True),
    (8, 256, 1280, 8, 1280, True, 77, True), (2, 2304, 640, 10, 640, True, 77, True),
    (2, 9216, 320, 5, 320, True, 77, True), (2, 576, 1280, 20, 1280, True, 77, True),  # v2.1
    (2, 4096, 320, 4, 160, True, 77, True), (2, 4096, 320, 4, 160, False, 77, True),  # tp2
    (2, 200, 320, 8, 320, True, 77, True),     # a ragged query tile
    (1, 200, 320, 8, 320, True, 128, False),   # the most keys, kt and vt contiguous
    (3, 333, 640, 8, 640, True, 5, True),      # one ragged key tile
    (1, 1024, 640, 8, 640, True, 9, True),     # the two-pass mode's unpadded prompt
])
def test_k10_tf32_matches_plain_on_card(b, s, c, heads, ci, residual, sk, view):
    """K10's float32 route ("tf32") against the plain composition: the term
    out − x within 2^-8 of its largest |reference| + 2^-10 relative of
    |out| (chip_smoke.py's _check_k10), which the term over unmasked keys
    fails where the mask hides a key; the same bits on a second call."""
    dev = _card()
    args, valid = _k10_args(dev, b, s, c, ci, 80 + s + sk, sk, view)
    kw = {"key_valid": valid, "n_head": heads, "residual": residual}
    before = dict(tfx.fused_cross_attention_kv.shapes)
    got = tfx.fused_cross_attention_kv(*args, **kw)
    new = [key for key, n in tfx.fused_cross_attention_kv.shapes.items()
           if n != before.get(key, 0)]
    assert len(new) == 1 and new[0].endswith("route=tf32")
    want = tfx.fused_cross_attention_kv_plain(*args, **kw)
    x = args[0] if residual else 0.0
    atol = F32[0] * float((want - x).abs().max())
    torch.testing.assert_close(got, want, rtol=F32[1], atol=atol)
    if not bool(valid.all()):
        unmasked = tfx.fused_cross_attention_kv_plain(*args, **{**kw, "key_valid": None})
        assert not torch.allclose(unmasked, got, rtol=F32[1], atol=atol)
    assert torch.equal(tfx.fused_cross_attention_kv(*args, **kw), got)


@pytest.mark.cuda
def test_k10_tf32_projecting_the_context_on_card():
    """fused_cross_attention in float32: K and V projected on
    csrc/gemm_tf32_sm90.cu (the weights' K-major copies), then the route's
    pre-pass and core, counted under "tf32"."""
    dev = _card()
    r = np.random.default_rng(81)

    def n(*shape, scale=1.0):
        return torch.from_numpy((r.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    b, s, c = 2, 1024, 640
    x, ctx = n(b, s, c), n(b, 77, 768)
    valid = torch.arange(77, device=dev)[None] < torch.tensor([2, 9], device=dev)[:, None]
    args = (x, ctx, n(c, scale=0.1) + 1.0, n(c, scale=0.1), n(c, c, scale=c ** -0.5),
            n(768, c, scale=768 ** -0.5), n(768, c, scale=768 ** -0.5),
            n(c, c, scale=c ** -0.5), n(c, scale=0.1))
    before = dict(tfx.fused_cross_attention.shapes)
    got = tfx.fused_cross_attention(*args, key_valid=valid, n_head=8)
    new = [key for key, k in tfx.fused_cross_attention.shapes.items() if k != before.get(key, 0)]
    assert len(new) == 1 and new[0].endswith("route=tf32")
    want = tfx.fused_cross_attention_plain(*args, key_valid=valid, n_head=8)
    atol = F32[0] * float((want - x).abs().max())
    torch.testing.assert_close(got, want, rtol=F32[1], atol=atol)
