"""K10, the fused cross-attention sublayer, and the UNet's gate to it.

- Both plain versions equal sdtpu's Pallas kernels run in interpret mode on
  tests/test_fused_cross_attention.py's cases (77 keys, an aligned 32,
  d_head 16 and 40), with and without a key-padding mask (f32, 2e-5).
- The UNet with SDTPU_FUSED_XATTN=1, at a tiny config whose transformer
  level has S = 256 (the gate opens there), reaches K10's entry point and
  equals sdtpu's unet_apply with the gate off (f32, 1e-4).
- On the card (marker `cuda`): the kernel against its plain version at SD
  v1.4's shapes, f32 and bf16, with and without key_valid; the plain
  version without the mask falls outside the tolerance of the masked
  kernel's result, so the bias is applied. The bf16 Hopper route
  (csrc/gemm_sm90.cu and csrc/attention_sm90.cu) and the WMMA route in
  bf16, each counted under its route, at the serve shapes and at ragged
  ones, and a repeat of the Hopper route that is bit-equal.

Inputs come from numpy seeds.
"""

import jax
import numpy as np
import pytest
import torch

from sdtpu.models import rng
from sdtpu.models import unet as junet
from sdtpu.config import UNetConfig
from sdtpu.ops import fused_cross_attention as jfx
from sdtpu_torch.models import unet as tunet
from sdtpu_torch.ops import fused_cross_attention as tfx
from sdtpu_torch.weights import from_numpy_tree

torch.set_num_threads(1)


def _inputs(b, s, c, sk, dc, seed):
    r = np.random.default_rng(seed)
    n = lambda *shape, scale=1.0: (r.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    return dict(x=n(b, s, c), ctx=n(b, sk, dc), g=1.0 + n(c, scale=0.1), bb=n(c, scale=0.1),
                wq=n(c, c, scale=c ** -0.5), wk=n(dc, c, scale=dc ** -0.5),
                wv=n(dc, c, scale=dc ** -0.5), wo=n(c, c, scale=c ** -0.5), bo=n(c, scale=0.1))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


CASES = [  # tests/test_fused_cross_attention.py's: (b, s, c, sk, dc, n_head, block_q)
    (2, 256, 64, 77, 48, 4, 128),
    (1, 128, 80, 32, 96, 2, 128),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_sdtpu_kernel(case, masked):
    """fused_cross_attention_plain against sdtpu's fused_cross_attention
    (K/V projected in the kernel body) in interpret mode."""
    b, s, c, sk, dc, n_head, block_q = case
    a = _inputs(b, s, c, sk, dc, seed=sk + c)
    valid = np.broadcast_to(np.arange(sk)[None] < (11 if masked else sk), (b, sk)).copy()
    args = [a[k] for k in ("x", "ctx", "g", "bb", "wq", "wk", "wv", "wo", "bo")]
    want = jfx.fused_cross_attention(*args, key_valid=valid if masked else None,
                                     n_head=n_head, block_q=block_q, interpret=True)
    got = tfx.fused_cross_attention(*_t(*args), key_valid=torch.from_numpy(valid)
                                    if masked else None, n_head=n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_kv_plain_equals_sdtpu_kernel(case):
    """fused_cross_attention_kv_plain against sdtpu's fused_cross_attention_kv
    in interpret mode, kt/vt projected and transposed as sdtpu's UNet does,
    the last 5 keys padded."""
    b, s, c, sk, dc, n_head, block_q = case
    a = _inputs(b, s, c, sk, dc, seed=2 * sk + c)
    valid = np.broadcast_to(np.arange(sk)[None] < sk - 5, (b, sk)).copy()
    kt = np.einsum("bsd,dc->bcs", a["ctx"], a["wk"])
    vt = np.einsum("bsd,dc->bcs", a["ctx"], a["wv"])
    args = [a["x"], kt, vt] + [a[k] for k in ("g", "bb", "wq", "wo", "bo")]
    want = jfx.fused_cross_attention_kv(*args, key_valid=valid, n_head=n_head,
                                        block_q=block_q, interpret=True)
    got = tfx.fused_cross_attention_kv(*_t(*args), key_valid=torch.from_numpy(valid),
                                       n_head=n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_mask_is_variable_length():
    """Padded keys get no weight: the masked result equals attention over
    the valid prefix alone."""
    a = _inputs(2, 64, 32, 77, 24, seed=5)
    valid = torch.arange(77)[None].expand(2, 77) < 9
    args = _t(*[a[k] for k in ("x", "ctx", "g", "bb", "wq", "wk", "wv", "wo", "bo")])
    got = tfx.fused_cross_attention(*args, key_valid=valid, n_head=4)
    args[1] = args[1][:, :9]
    want = tfx.fused_cross_attention(*args, n_head=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _kv_args(b=1, s=16, c=16, sk=5):
    a = _inputs(b, s, c, sk, c, seed=3)
    kt = torch.from_numpy(np.einsum("bsd,dc->bcs", a["ctx"], a["wk"]))
    return [torch.from_numpy(a["x"]), kt, kt] + _t(*[a[k] for k in ("g", "bb", "wq", "wo",
                                                                    "bo")])


@pytest.mark.parametrize("fn", [tfx.fused_cross_attention_kv, tfx.fused_cross_attention],
                         ids=lambda f: f.__name__)
def test_wrappers_route_cpu_to_plain_and_refuse_other_devices(fn):
    a = _inputs(1, 16, 16, 5, 16, seed=4)
    if fn is tfx.fused_cross_attention:
        args = _t(*[a[k] for k in ("x", "ctx", "g", "bb", "wq", "wk", "wv", "wo", "bo")])
    else:
        args = _kv_args()
    before = fn.launches, dict(fn.shapes)
    assert fn(*args, n_head=2).shape == (1, 16, 16)
    assert (fn.launches, fn.shapes) == before  # the plain version counts nothing
    with pytest.raises(ValueError):
        fn(*[t.to("meta") for t in args], n_head=2)


# ------------------------------------------------------------ the UNet's gate

XATTN_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2), attention_levels=(0,),
                        n_head=4, context_dim=32, time_embed_dim=64, groupnorm_groups=4)


@pytest.mark.parametrize("value,opens", [(None, False), ("0", False), ("false", False),
                                         ("", False), ("1", True), ("true", True)])
def test_gate_reads_sdtpus_switch(monkeypatch, value, opens):
    if value is None:
        monkeypatch.delenv("SDTPU_FUSED_XATTN", raising=False)
    else:
        monkeypatch.setenv("SDTPU_FUSED_XATTN", value)
    assert tunet._use_fused_xattn(4096, 320, 8) is opens
    # sdtpu's bounds: 256 <= S <= 4096, S % 128 == 0, d_head % 8 == 0
    for s, c, heads in ((128, 320, 8), (8192, 320, 8), (320, 320, 8), (1024, 96, 8)):
        assert not tunet._use_fused_xattn(s, c, heads)
    from sdtpu_torch.ops import dispatch

    with dispatch.training():
        assert not tunet._use_fused_xattn(4096, 320, 8)


def test_unet_with_k10_equals_sdtpu(monkeypatch):
    """SDTPU_FUSED_XATTN=1 on the port, off on sdtpu: the 5 transformers at
    16x16 (S = 256, d_head 8) take K10's entry point (its plain version on
    the CPU); the 8x8 middle one stays below the gate."""
    monkeypatch.delenv("SDTPU_FUSED_XATTN", raising=False)
    params = jax.tree_util.tree_map(np.asarray, junet.init_unet(rng.HostKey(11), XATTN_UNET))
    r = np.random.default_rng(12)
    x = r.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    valid = np.arange(77)[None] < np.array([[2], [9]])
    want = jax.jit(junet.unet_apply, static_argnums=(4,))(params, x, 481, ctx, XATTN_UNET,
                                                          ctx_valid=valid)

    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape)
        return tfx.fused_cross_attention_kv(*a, **k)

    monkeypatch.setenv("SDTPU_FUSED_XATTN", "1")
    monkeypatch.setattr(tunet, "fused_cross_attention_kv", counted)
    got = tunet.unet_apply(tunet.fuse_qkv(from_numpy_tree(params, device="cpu")),
                           torch.from_numpy(x), 481, torch.from_numpy(ctx), XATTN_UNET,
                           torch.from_numpy(valid))
    assert calls == [(2, 256, 32)] * 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ on the card

# SD v1.4's cross-attention sublayers at 512px (CFG batch 2): (S, C), 8 heads
SD_SHAPES = [(4096, 320), (1024, 640), (256, 1280)]
CARD_TOL = {"float32": 5e-3, "bfloat16": 6e-2}  # TF32 products; bf16 ulps
# the attention term alone (out - x): this fraction of its largest |ref|,
# plus this rtol of |out| (the output's own rounding), as chip_smoke holds it
TERM_TOL = {"float32": (2.0 ** -8, 2.0 ** -10), "bfloat16": (2.0 ** -6, 2.0 ** -7)}


def _term_within(got, want, x, frac, rtol):
    term = want.float() - x.float()
    return bool(((got.float() - want.float()).abs()
                 <= frac * term.abs().max() + rtol * want.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,c", SD_SHAPES)
def test_kernel_matches_plain_on_card(s, c, dtype, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    a = _inputs(2, s, c, 77, 768, seed=s + c)
    x, ctx, g, bb, wq, wk, wv, wo, bo = (torch.from_numpy(a[k]).to(dev, dt) for k in (
        "x", "ctx", "g", "bb", "wq", "wk", "wv", "wo", "bo"))
    kt, vt = (torch.matmul(ctx, w).transpose(1, 2) for w in (wk, wv))
    valid = (torch.arange(77, device=dev)[None] < torch.tensor([[2], [9]], device=dev)
             if masked else None)
    fn = tfx.fused_cross_attention_kv
    before = fn.launches
    got = fn(x, kt, vt, g, bb, wq, wo, bo, key_valid=valid, n_head=8)
    want = tfx.fused_cross_attention_kv_plain(x, kt, vt, g, bb, wq, wo, bo, valid, 8)
    assert fn.launches == before + 1
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    frac, rtol = TERM_TOL[dtype]
    assert _term_within(got, want, x, frac, rtol)
    # a term 3 % small falls outside the term's tolerance
    assert not _term_within(x.float() + 0.97 * (want.float() - x.float()), want, x, frac, rtol)
    if masked:
        unmasked = tfx.fused_cross_attention_kv_plain(x, kt, vt, g, bb, wq, wo, bo, None, 8)
        assert not torch.allclose(got.float(), unmasked.float(), rtol=tol, atol=tol)
    # the entry that projects the context itself: the same result
    got2 = tfx.fused_cross_attention(x, ctx, g, bb, wq, wk, wv, wo, bo, key_valid=valid,
                                     n_head=8)
    torch.testing.assert_close(got2.float(), want.float(), rtol=tol, atol=tol)


def _routes(fn):
    """{route: launches} of a wrapper, from its per-shape counts."""
    out = {}
    for key, n in fn.shapes.items():
        route = key.rsplit("route=", 1)[-1]
        out[route] = out.get(route, 0) + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,s,c,sk,view", [
    (2, 4096, 320, 77, True),   # the serve shapes: d = 40, 80, 160
    (4, 1024, 640, 77, True),
    (8, 256, 1280, 77, True),
    (1, 200, 320, 128, False),  # a ragged query tile, one full key tile; kt contiguous
    (3, 333, 640, 5, True),     # a single ragged key tile
    # the two-pass mode's UNet calls (batch 1): the empty prompt's 2 keys and
    # a prompt's own 9, unpadded
    (1, 4096, 320, 2, True),
    (1, 1024, 640, 9, True),
    (1, 256, 1280, 2, True),
])
def test_k10_sm90_matches_plain_on_card(b, s, c, sk, view, masked):
    """K10's bf16 route against the plain version: the sublayer within a few
    bf16 ulps (6e-2), the attention term within 2^-6 of its largest
    |reference| + 2^-7 of |out| (what chip_smoke.py holds it to), which a
    term 3 % small and, where the mask hides a key, the unmasked result
    fail; the same bits on a second call; the WMMA route in bf16 within the
    same tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    a = _inputs(b, s, c, sk, 768, seed=7 * b + c + sk)
    x, ctx, g, bb, wq, wk, wv, wo, bo = (torch.from_numpy(a[k]).to(dev, dt) for k in (
        "x", "ctx", "g", "bb", "wq", "wk", "wv", "wo", "bo"))
    kt, vt = (torch.matmul(ctx, w).transpose(1, 2) for w in (wk, wv))
    if not view:
        kt, vt = kt.contiguous(), vt.contiguous()
    valid = None
    if masked:
        n = torch.tensor([2, 9, 40, sk][:b] + [sk] * max(0, b - 4), device=dev)
        valid = torch.arange(sk, device=dev)[None] < n[:, None].clamp(max=sk)
    args = (x, kt, vt, g, bb, wq, wo, bo)
    assert tfx.route_plan(dt, b, s, c, 8, sk, masked) is not None
    fn = tfx.fused_cross_attention_kv
    before = _routes(fn)
    got = fn(*args, key_valid=valid, n_head=8)
    want = tfx.fused_cross_attention_kv_plain(*args, valid, 8)
    old = tfx._cross_attention_kv(*args, valid, 8, 1e-5, "wmma")
    after = _routes(fn)
    assert after.get("sm90", 0) == before.get("sm90", 0) + 1
    assert after.get("wmma", 0) == before.get("wmma", 0) + 1
    frac, rtol = TERM_TOL["bfloat16"]
    for out in (got, old):
        torch.testing.assert_close(out.float(), want.float(), rtol=6e-2, atol=6e-2)
        assert _term_within(out, want, x, frac, rtol)
    assert not _term_within(x.float() + 0.97 * (want.float() - x.float()), want, x, frac, rtol)
    if masked and not bool(valid.all()):  # a mask over 2 keys at b = 1 hides none
        unmasked = tfx.fused_cross_attention_kv_plain(*args, None, 8)
        assert not _term_within(unmasked, got, x, frac, rtol)
    assert torch.equal(fn(*args, key_valid=valid, n_head=8), got)

