"""K9 and the differentiable attention of the port, against sdtpu.

- flash_attention_bwd_heads_plain (what K9's wrapper runs on CPU tensors)
  against sdtpu's Pallas backward in interpret mode and against jax.vjp of
  sdtpu's XLA twin, on the cases of tests/test_flash_attention.py;
- flash_qkv_attention_diff's gradients against jax.value_and_grad of
  sdtpu's flash_qkv_attention_diff (Pallas forward and backward, interpret
  mode), and torch.autograd.gradcheck of the op in float64;
- dispatch.training(): every forward-only gate closed, and qkv_attention
  on its differentiable branch;
- on the card (tests marked `cuda`): K9 against its plain version on its
  bf16 and float32 routes, their bit-equal repeats, the differentiable op's
  gradients against the CPU's, and each forward-only wrapper raising on an
  input that requires grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import flash_attention as jfa
from sdtpu_torch.ops import attention as tattn
from sdtpu_torch.ops import dispatch
from sdtpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _heads(x, b, s, h):
    """[B, S, C] numpy -> [B·h, S, C / h]."""
    c = x.shape[-1]
    return x.reshape(b, s, h, c // h).transpose(0, 2, 1, 3).reshape(b * h, s, c // h)


# sdtpu's own tolerances for its backward kernel (test_fullk_bwd_kernel_grads)
BWD_TOL = {"float32": dict(rtol=3e-4, atol=3e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("s,c,h,dtype", [
    (1024, 80, 2, "float32"),   # several query blocks in sdtpu's kernel
    (512, 64, 1, "bfloat16"),
    (256, 80, 2, "float32"),    # d_head = 40, the SD shape
])
def test_bwd_plain_matches_sdtpu(s, c, h, dtype):
    r = np.random.default_rng(s + c)
    q, k, v, g = (_heads(r.standard_normal((1, s, c)).astype(np.float32), 1, s, h)
                  for _ in range(4))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    tq, tk, tv, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, g))
    got = tfa.flash_attention_bwd_heads(tq, tk, tv, tg)
    assert all(x.dtype == tq.dtype and x.shape == tq.shape for x in got)
    kernel = jfa.flash_attention_bwd_heads(jq, jk, jv, jg, interpret=True)
    # the XLA twin over [1, S, C]: heads back side by side
    merge = [jnp.asarray(a.reshape(1, h, s, c // h).transpose(0, 2, 1, 3).reshape(1, s, c),
                         jdt) for a in (q, k, v, g)]
    _, vjp = jax.vjp(lambda a, b_, c_: jfa._xla_attention_twin(a, b_, c_, h), *merge[:3])
    twin = [_heads(np.asarray(x, np.float32), 1, s, h) for x in vjp(merge[3])]
    for a, b_, t in zip(got, kernel, twin):
        np.testing.assert_allclose(_np(a), _np(b_), **BWD_TOL[dtype])
        np.testing.assert_allclose(_np(a), t, **BWD_TOL[dtype])


def test_diff_grads_match_sdtpu_custom_vjp():
    """The port's differentiable attention against sdtpu's custom VJP (Pallas
    forward and backward in interpret mode), tests/test_flash_attention.py's
    case: the same loss and gradients within its 2e-4."""
    b, s, c, h = 1, 256, 64, 2
    r = np.random.default_rng(7)
    q, k, v, g = (r.standard_normal((b, s, c)).astype(np.float32) for _ in range(4))

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_qkv_attention_diff(q_, k_, v_, h, True) * jnp.asarray(g))

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tl = (tfa.flash_qkv_attention_diff(tq, tk, tv, h) * torch.from_numpy(g)).sum()
    tgrads = torch.autograd.grad(tl, (tq, tk, tv))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-4, atol=2e-4)
    for a, b_ in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(a), _np(b_), rtol=2e-4, atol=2e-4)


def test_diff_gradcheck_float64():
    """The op's backward (the plain K9) is the true gradient of its forward
    (the plain K1), by finite differences in float64."""
    r = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 12, 8))).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b_, c_: tfa.flash_qkv_attention_diff(a, b_, c_, 2),
                                    (q, k, v))


def test_forward_lse_is_the_rows_log2_sum_exp():
    """K1's optional row statistics (what K9 takes): log2 of the sum of
    exp(q kᵀ · d^-1/2) per row, in its plain version."""
    r = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(r.standard_normal((4, 50, 16)).astype(np.float32))
               for _ in range(3))
    out, lse = tfa.flash_attention_heads(q, k, v, n_head=2, return_lse=True)
    want = torch.logsumexp(torch.matmul(q, k.transpose(1, 2)) * 16 ** -0.5, -1) * tfa.LOG2E
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(out, tfa.flash_attention_heads(q, k, v, n_head=2))


# ------------------------------------------------------------ the gates

def test_training_closes_every_forward_only_gate():
    """Each gate is open at a shape outside dispatch.training() and closed
    inside it; the differentiable flash path stays open for mask-free
    attention only."""
    from sdtpu_torch.models import unet, vae
    from sdtpu_torch.ops import conv, groupnorm

    gates = {
        "unet fused ResBlock": lambda: unet._use_fused_resblock(torch.zeros(1, 128, 128, 320)),
        "unet K2/K5": lambda: unet._use_fused_attn(4096, 320, 8),
        "unet K3+K4": lambda: unet._use_fused_proj(4096, 320),
        "vae fused ResnetBlock": lambda: vae._use_fused_resnet(torch.zeros(1, 64, 64, 512), 512),
        "K7 upsample": lambda: conv.use_fused_upsample(128, 128, 512, 512),
        "K8 GroupNorm+SiLU": lambda: groupnorm.use_fused_gn_silu(16384, 128, False),
        "K1 with key padding": lambda: tattn.use_flash(4096, 4096, 40, False, True),
    }
    assert all(g() for g in gates.values())
    with dispatch.training():
        assert dispatch.in_training()
        still_open = [name for name, g in gates.items() if g()]
        assert not still_open, still_open
        assert tattn.use_flash(4096, 4096, 40, False, False)   # K1 + K9
        assert not tattn.use_flash(16384, 16384, 512, False, False)  # K9 takes d <= 160
    assert not dispatch.in_training()
    assert tattn.use_flash(16384, 16384, 512, False, False)


def test_qkv_attention_takes_the_differentiable_branch_in_training(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "flash_qkv_attention",
                        lambda *a, **kw: calls.append("forward-only") or a[0])
    monkeypatch.setattr(tattn, "flash_qkv_attention_diff",
                        lambda *a, **kw: calls.append("diff") or a[0])
    x = torch.zeros(1, 2048, 16)
    valid = torch.ones(1, 2048, dtype=torch.bool)
    with dispatch.training():
        tattn.qkv_attention(x, x, x, None, 2)
        tattn.qkv_attention(x, x, x, None, 2, key_valid=valid)  # plain under training
    tattn.qkv_attention(x, x, x, None, 2)
    assert calls == ["diff", "forward-only"]


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# K9's tolerance on the card, K1's: scaled to the largest |reference| of
# each gradient (they are sums over many keys or queries, far from 1). f32,
# TF32 products and Δ from the TF32 forward's o, 2^-8 of it + 2^-10
# relative; bf16, Δ from the bf16 o (rounded to 2^-8) and P, dS rounded at
# other points than the plain version's, 2^-6 of it + 2^-7 relative.
K9_TOL = {"float32": (2.0 ** -8, 2.0 ** -10), "bfloat16": (2.0 ** -6, 2.0 ** -7)}


def _k9_routes():
    out = {}
    for key, n in tfa.flash_attention_bwd_heads.shapes.items():
        route = key.rsplit("route=", 1)[-1]
        out[route] = out.get(route, 0) + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (16, 300, 333, 40),   # ragged tiles, training's head
    (4, 200, 264, 64),    # SD v2.1's head
    (4, 200, 130, 80),
    (2, 129, 257, 160),   # the widest head K9 takes
])
def test_k9_matches_plain_on_card(dtype, bh, sq, sk, d):
    """K9 against its plain version on the card, counted under its
    dtype's route (bf16 the Hopper kernel, float32 the TF32 one); a zeroed
    dK and the gradients over every other key fail the tolerance."""
    dev, dt = _card(), getattr(torch, dtype)
    r = np.random.default_rng(10)
    q, do = (torch.from_numpy(r.standard_normal((bh, sq, d)).astype(np.float32)).to(dev, dt)
             for _ in range(2))
    k, v = (torch.from_numpy(r.standard_normal((bh, sk, d)).astype(np.float32)).to(dev, dt)
            for _ in range(2))
    o, lse = tfa.flash_attention_heads(q, k, v, return_lse=True)
    before, route = tfa.flash_attention_bwd_heads.launches, "tf32" if dtype == "float32" else "sm90"
    routed = _k9_routes().get(route, 0)
    got = tfa.flash_attention_bwd_heads(q, k, v, do, o, lse)
    assert tfa.flash_attention_bwd_heads.launches == before + 1
    assert _k9_routes()[route] == routed + 1
    want = tfa.flash_attention_bwd_heads_plain(q, k, v, do)
    half = tfa.flash_attention_bwd_heads_plain(q, k[:, ::2], v[:, ::2], do)
    frac, rtol = K9_TOL[dtype]
    for i, (a, b_) in enumerate(zip(got, want)):
        atol = frac * float(b_.float().abs().max())
        torch.testing.assert_close(a.float(), b_.float(), rtol=rtol, atol=atol)
        if i == 0:  # dq over every other key
            assert not torch.allclose(half[0].float(), b_.float(), rtol=rtol, atol=atol)
        if i == 1:
            assert not torch.allclose(torch.zeros_like(b_).float(), b_.float(), rtol=rtol,
                                      atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_k9_f32_repeats_bit_equal_on_card(d):
    """K9's float32 route (csrc/flash_attention_bwd_tf32_sm90.cu, no
    atomics) gives the same bits on two runs, at ragged lengths (S not a
    multiple of the tiles or of 8)."""
    dev = _card()
    assert tfa.bwd_tf32_plan(d) is not None
    r = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(r.standard_normal((8, 333, d)).astype(np.float32))
                   .to(dev) for _ in range(4))
    o, lse = tfa.flash_attention_heads(q, k, v, return_lse=True)
    first = tfa.flash_attention_bwd_heads(q, k, v, do, o, lse)
    second = tfa.flash_attention_bwd_heads(q, k, v, do, o, lse)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_k9_bf16_repeats_bit_equal_on_card(d):
    """K9's bf16 route (csrc/flash_attention_bwd_sm90.cu, no atomics) gives
    the same bits on two runs, at ragged lengths (S not a multiple of 64)."""
    dev = _card()
    assert tfa.bwd_sm90_plan(d) is not None
    r = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(r.standard_normal((8, 333, d)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    o, lse = tfa.flash_attention_heads(q, k, v, return_lse=True)
    first = tfa.flash_attention_bwd_heads(q, k, v, do, o, lse)
    second = tfa.flash_attention_bwd_heads(q, k, v, do, o, lse)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
def test_diff_attention_grads_card_vs_cpu():
    """The differentiable op on the card (K1, K9) against the CPU (plain),
    f32, [B, S, C] rows with 8 heads of 40."""
    dev = _card()
    r = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(r.standard_normal((2, 256, 320)).astype(np.float32))
                  for _ in range(4))

    def grads(device):
        xs = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = tfa.flash_qkv_attention_diff(*xs, 8)
        return [out] + list(torch.autograd.grad((out * g.to(device)).sum(), xs))

    for a, b_ in zip(grads(dev), grads("cpu")):
        atol = 2.0 ** -8 * float(b_.detach().abs().max())
        torch.testing.assert_close(a.detach().cpu(), b_.detach(), rtol=2.0 ** -10, atol=atol)


@pytest.mark.cuda
def test_forward_only_wrappers_raise_under_autograd():
    from sdtpu_torch.ops import fused_conv, fused_groupnorm, fused_mlp, fused_transformer

    dev = _card()
    x = torch.randn(1, 16, 16, 128, device=dev, requires_grad=True)
    s = torch.randn(1, 256, 64, device=dev, requires_grad=True)
    w1, b = torch.randn(128, 128, device=dev), torch.zeros(128, device=dev)
    calls = {
        "channel_partials": lambda: fused_groupnorm.channel_partials(x),
        "group_norm_silu": lambda: fused_groupnorm.group_norm_silu(x, b, b, 32),
        "conv1x1_fused": lambda: fused_conv.conv1x1_fused(x, w1, b),
        "conv3x3_fused": lambda: fused_conv.conv3x3_fused(
            x, torch.randn(3, 3, 128, 128, device=dev), b),
        "upsample2x_conv_fused": lambda: fused_conv.upsample2x_conv_fused(
            x, torch.randn(3, 3, 128, 128, device=dev), b),
        "fused_self_attention": lambda: fused_transformer.fused_self_attention(
            s, torch.ones(64, device=dev), torch.zeros(64, device=dev),
            torch.randn(64, 192, device=dev), torch.randn(64, 64, device=dev),
            torch.zeros(64, device=dev), 8),
        "fused_geglu_mlp": lambda: fused_mlp.fused_geglu_mlp(
            s, torch.ones(64, device=dev), torch.zeros(64, device=dev),
            torch.randn(64, 512, device=dev), torch.zeros(512, device=dev),
            torch.randn(256, 64, device=dev), torch.zeros(64, device=dev)),
        "flash_attention_heads": lambda: tfa.flash_attention_heads(s, s, s),
        "flash_qkv_attention": lambda: tfa.flash_qkv_attention(s, s, s, 8),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()  # without autograd the kernel launches
