"""K1, the flash attention forward of the port, against sdtpu.

The plain version (what the wrapper runs on CPU tensors) is held against
sdtpu's Pallas kernel in interpret mode on the cases of
tests/test_flash_attention.py; the dispatch gate of qkv_attention against
sdtpu's conditions; the CUDA kernel against the plain version on the card
(tests marked `cuda`, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import attention as jattn
from sdtpu.ops import flash_attention as jfa
from sdtpu_torch.ops import attention as tattn
from sdtpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# f32: the same sums in another order (test_flash_attention.py's 2e-5)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: both round the unnormalised weights to bf16 and the output once;
# 1-2 bf16 ulps at |x| ~ 4 (test_flash_attention.py:test_flash_bf16)
BF16_TOL = dict(rtol=0, atol=7e-2)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="float32"):
    jt = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return jt, torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _key_bias(bh_outer, sk, seed):
    """0 / -1e30 rows with a different number of real keys per row."""
    n = np.random.default_rng(seed).integers(sk // 4, sk, size=bh_outer)
    return np.where(np.arange(sk)[None] < n[:, None], 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("bh,n_head,sq,sk,d,bias,dtype", [
    (4, 2, 256, 256, 40, False, "float32"),    # online, transposed body (d <= 64)
    (2, 2, 256, 384, 40, True, "float32"),     # full-K with the key bias
    (1, 1, 256, 256, 512, False, "float32"),   # online body, the VAE mid's d
    (2, 1, 128, 200, 512, True, "float32"),    # full-K + bias, ragged keys
    (2, 2, 256, 256, 40, False, "bfloat16"),
    (1, 1, 128, 256, 512, True, "bfloat16"),
])
def test_flash_attention_heads_plain_matches_sdtpu(bh, n_head, sq, sk, d, bias, dtype):
    r = np.random.default_rng(sq + sk + d)
    arrays = [r.standard_normal((bh, s, d)) for s in (sq, sk, sk)]
    (q, tq), (k, tk), (v, tv) = (_pair(a, dtype) for a in arrays)
    kb = _key_bias(bh // n_head, sk, 1) if bias else None
    want = jfa.flash_attention_heads(q, k, v, key_bias=None if kb is None else jnp.asarray(kb),
                                     n_head=n_head, interpret=True)
    got = tfa.flash_attention_heads(tq, tk, tv, None if kb is None else torch.from_numpy(kb),
                                    n_head=n_head)
    assert got.dtype == tq.dtype and got.shape == (bh, sq, d)
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "float32"
                                                       else BF16_TOL))


def test_flash_online_multiblock_matches_sdtpu():
    """sdtpu's pipelined multi-k-block online path (single_k=False) against
    the port's plain version."""
    r = np.random.default_rng(3)
    (q, tq), (k, tk), (v, tv) = (_pair(r.standard_normal((1, 512, 80))) for _ in range(3))
    want = jfa.flash_attention_heads(q, k, v, block_q=256, block_k=128, single_k=False,
                                     interpret=True)
    np.testing.assert_allclose(_np(tfa.flash_attention_heads(tq, tk, tv)), _np(want),
                               **F32_TOL)


@pytest.mark.parametrize("b,s,n_state,n_head,valid", [
    (2, 256, 320, 8, False),   # test_flash_attention.py: UNet 16x16 level
    (1, 512, 512, 1, False),   # the VAE's single head
    (2, 256, 320, 8, True),    # key padding
])
def test_flash_qkv_attention_matches_sdtpu(b, s, n_state, n_head, valid):
    r = np.random.default_rng(4)
    (q, tq), (k, tk), (v, tv) = (_pair(r.standard_normal((b, s, n_state))) for _ in range(3))
    kv = None
    if valid:
        kv = np.arange(s)[None] < np.array([[s // 3], [s - 5]])
    want = jfa.flash_qkv_attention(q, k, v, n_head, key_valid=None if kv is None
                                   else jnp.asarray(kv), interpret=True)
    got = tfa.flash_qkv_attention(tq, tk, tv, n_head, key_valid=None if kv is None
                                  else torch.from_numpy(kv))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # and the same as the port's plain attention (dual d^-1/4 scaling)
    plain = tattn.qkv_attention_plain(tq, tk, tv, None, n_head,
                                      None if kv is None else torch.from_numpy(kv))
    np.testing.assert_allclose(_np(got), _np(plain), rtol=1e-4, atol=1e-4)


def test_plain_versions_in_query_chunks_equal_whole(monkeypatch):
    """The plain attentions split the queries to bound their f32 scores;
    each row is independent, so the chunked result is the whole one up to
    the matmul's blocking (a few f32 ulps)."""
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 100, 64)).astype(np.float32))
               for _ in range(3))
    mask = torch.triu(torch.full((100, 100), float("-inf")), diagonal=1)
    whole = tattn.qkv_attention_plain(q, k, v, mask, 4)
    flash = tfa.flash_attention_heads(q, k, v)
    monkeypatch.setattr(tfa, "SCORE_BUDGET", 4 * 100 * 7)
    assert len(tfa.query_chunks(2, 4, 100, 100)) == 34   # 3 queries a chunk
    assert len(tfa.query_chunks(2, 1, 100, 100)) == 8    # 14 queries a chunk
    torch.testing.assert_close(tattn.qkv_attention_plain(q, k, v, mask, 4), whole,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tfa.flash_attention_heads(q, k, v), flash, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the dispatch

def _sdtpu_takes_flash(monkeypatch, sq, sk, d_head, n_head, masked, valid):
    """Whether sdtpu's qkv_attention, with its Pallas dispatch on, reaches a
    flash kernel for these shapes (traced abstractly: nothing is computed)."""
    import sdtpu.ops.dispatch as dispatch

    hits = []

    def stub(q, *a, **kw):
        hits.append(1)
        return q

    monkeypatch.setattr(dispatch, "use_pallas", lambda: True)
    monkeypatch.setattr(dispatch, "use_pallas_differentiable", lambda: True)
    monkeypatch.setattr(jfa, "flash_qkv_attention", stub)
    monkeypatch.setattr(jfa, "flash_qkv_attention_diff", stub)
    d = d_head * n_head
    spec = jax.ShapeDtypeStruct
    args = [spec((1, sq, d), jnp.float32), spec((1, sk, d), jnp.float32),
            spec((1, sk, d), jnp.float32)]
    mask = spec((sq, sk), jnp.float32) if masked else None
    kv = spec((1, sk), jnp.bool_) if valid else None
    jax.eval_shape(lambda q, k, v, m, kv_: jattn.qkv_attention(q, k, v, m, n_head,
                                                               key_valid=kv_),
                   *args, mask, kv)
    return bool(hits)


@pytest.mark.parametrize("masked,valid", [(False, False), (True, False), (False, True)])
def test_use_flash_matches_sdtpu_dispatch(monkeypatch, masked, valid):
    for sq in (1024, 2048, 2560, 4096, 8192, 16384):
        for sk in (77, 2048, 3000, 16384):
            for d_head, n_head in ((40, 8), (160, 8), (320, 1), (512, 1)):
                want = _sdtpu_takes_flash(monkeypatch, sq, sk, d_head, n_head, masked, valid)
                got = tattn.use_flash(sq, sk, d_head, masked, valid)
                assert got == want, (sq, sk, d_head, n_head, masked, valid)


def test_use_flash_keeps_unsupported_heads_plain():
    """Head dims the kernel does not take stay plain where sdtpu would go
    to its flash kernel: above 512, or not a multiple of 8."""
    assert tattn.use_flash(8192, 8192, 512, False, False)
    assert not tattn.use_flash(8192, 8192, 640, False, False)
    assert not tattn.use_flash(2048, 2048, 36, False, False)


def test_vae_mid_attention_takes_k1_only_at_1024px():
    """The VAE mid block's single head of d=512: S=4096 (512px) stays
    plain, S=16384 (1024px) goes to K1."""
    assert not tattn.use_flash(4096, 4096, 512, False, False)
    assert tattn.use_flash(16384, 16384, 512, False, False)


def test_qkv_attention_dispatches_to_flash(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "flash_qkv_attention",
                        lambda *a, **kw: calls.append(kw) or a[0])
    x = torch.zeros(1, 2048, 16)
    assert tattn.qkv_attention(x, x, x, None, 2) is x
    assert calls == [{"key_valid": None}]
    tattn.qkv_attention(x, x, x, torch.zeros(2048, 2048), 2)  # masked: plain
    assert len(calls) == 1


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,n_head,sq,sk,d,bias", [
    (16, 8, 300, 333, 40, False),   # training's narrow heads, ragged tiles
    (4, 2, 200, 130, 80, True),
    (2, 2, 129, 257, 160, False),
    (1, 1, 100, 300, 512, True),    # the VAE mid's head, ragged
])
def test_flash_attention_matches_plain_on_card(dtype, bh, n_head, sq, sk, d, bias):
    """K1 against its plain version on the card. Its outputs are averages
    over many keys, well below 1, so the tolerance scales with the largest
    |reference|: f32 (TF32 products) 2^-8 of it + 2^-10 relative, bf16 (a
    few ulps) 2^-6 of it + 2^-7 relative. An all-zero output, or one over
    every other key, fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    r = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, s, d)).astype(np.float32)).to(dev, dt)
               for s in (sq, sk, sk))
    kb = torch.from_numpy(_key_bias(bh // n_head, sk, 7)).to(dev) if bias else None
    before = tfa.flash_attention_heads.launches
    got = tfa.flash_attention_heads(q, k, v, kb, n_head)
    want = tfa.flash_attention_heads_plain(q, k, v, kb, n_head)
    assert tfa.flash_attention_heads.launches == before + 1
    frac, rtol = (2 ** -8, 2 ** -10) if dtype == "float32" else (2 ** -6, 2 ** -7)
    atol = frac * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    # the tolerance has the power to reject a wrong result
    half = tfa.flash_attention_heads_plain(q, k[:, ::2], v[:, ::2],
                                           None if kb is None else kb[:, ::2], n_head)
    for wrong in (torch.zeros_like(want), half):
        assert not torch.allclose(wrong.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n_head,sq,sk,d,bias", [
    (32, 8, 300, 333, 40, False),   # training's heads; ragged query and key tiles
    (16, 8, 256, 2100, 40, True),   # a key-valid K1 past 2048 keys, Sk not a multiple of 64
    (4, 2, 200, 130, 80, True),
    (8, 8, 192, 256, 64, False),
    (2, 2, 129, 257, 160, True),
    (2, 2, 128, 64, 160, False),    # one key tile
])
def test_k1_sm90_matches_plain_on_card(bh, n_head, sq, sk, d, bias):
    """K1's bf16 route (the Hopper core, csrc/attention_sm90.cu) against the
    plain version, with the rows' log-sum-exp: the output within 2^-6 of
    its largest |reference| + 2^-7 relative (a few bf16 ulps of an average
    over the keys), the log2-domain log-sum-exp within 2^-9 (sums in
    another order), as chip_smoke.py holds them; the same bits on a second
    call. The tolerances reject an all-zero output, one over every other
    key, one that ignores the bias, and a log-sum-exp in natural log."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = np.random.default_rng(16 + d)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, s, d)).astype(np.float32)).to(dev, dt)
               for s in (sq, sk, sk))
    kb = torch.from_numpy(_key_bias(bh // n_head, sk, 8)).to(dev) if bias else None
    assert tfa.fwd_route(dt, d, bias) is not None
    before = dict(tfa.flash_attention_heads.shapes)
    got, lse = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    want, want_lse = tfa.flash_attention_heads_plain(q, k, v, kb, n_head, return_lse=True)
    new = {key: n - before.get(key, 0) for key, n in tfa.flash_attention_heads.shapes.items()
           if n != before.get(key, 0)}
    assert list(new.values()) == [1] and next(iter(new)).endswith("route=sm90")
    frac, rtol = 2 ** -6, 2 ** -7
    atol = frac * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2 ** -9)
    wrong = [torch.zeros_like(want), tfa.flash_attention_heads_plain(
        q, k[:, ::2], v[:, ::2], None if kb is None else kb[:, ::2], n_head)]
    if bias:
        wrong.append(tfa.flash_attention_heads_plain(q, k, v, None, n_head))
    for w in wrong:
        assert not torch.allclose(w.float(), want.float(), rtol=rtol, atol=atol)
    assert not torch.allclose(lse * np.log(2.0), want_lse, rtol=0, atol=2 ** -9)
    again, lse2 = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    assert torch.equal(again, got) and torch.equal(lse2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n_head,sq,sk,d,bias", [
    (2, 1, 200, 200, 512, False),   # four query tiles, the last ragged; a key tile of 8
    (2, 2, 129, 300, 512, True),    # a ragged query tile; the bias
    (1, 1, 64, 64, 512, False),     # one tile each
    (2, 1, 100, 130, 504, False),   # a width that pads to 512
])
def test_k1_wide_matches_plain_on_card(bh, n_head, sq, sk, d, bias):
    """K1's bf16 route at d = 512 (csrc/attention_wide_sm90.cu) against the
    plain version, with the rows' log-sum-exp: the output within 2^-6 of
    its largest |reference| + 2^-7 relative, the log-sum-exp within 2^-9,
    as chip_smoke.py holds them; the same bits on a second call. The
    tolerances reject an all-zero output, one over every other key and,
    with the bias, one that ignores it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = np.random.default_rng(50 + d + sk)
    q, k, v = (torch.from_numpy(r.standard_normal((bh, s, d)).astype(np.float32)).to(dev, dt)
               for s in (sq, sk, sk))
    kb = torch.from_numpy(_key_bias(bh // n_head, sk, 9)).to(dev) if bias else None
    assert isinstance(tfa.fwd_route(dt, d, bias), tfa.WidePlan)
    before = dict(tfa.flash_attention_heads.shapes)
    got, lse = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    new = {key: n - before.get(key, 0) for key, n in tfa.flash_attention_heads.shapes.items()
           if n != before.get(key, 0)}
    assert list(new.values()) == [1] and next(iter(new)).endswith("route=wide")
    want, want_lse = tfa.flash_attention_heads_plain(q, k, v, kb, n_head, return_lse=True)
    frac, rtol = 2 ** -6, 2 ** -7
    atol = frac * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2 ** -9)
    wrong = [torch.zeros_like(want), tfa.flash_attention_heads_plain(
        q, k[:, ::2], v[:, ::2], None if kb is None else kb[:, ::2], n_head)]
    if bias:
        wrong.append(tfa.flash_attention_heads_plain(q, k, v, None, n_head))
    for w in wrong:
        assert not torch.allclose(w.float(), want.float(), rtol=rtol, atol=atol)
    again, lse2 = tfa.flash_attention_heads(q, k, v, kb, n_head, return_lse=True)
    assert torch.equal(again, got) and torch.equal(lse2, lse)


@pytest.mark.cuda
def test_k1_wide_heads_inside_rows_on_card():
    """Two heads of 512 side by side in [B, S, 1024] rows
    (flash_qkv_attention): the tensor maps take a head stride below the row
    stride."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = np.random.default_rng(61)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 150, 1024)).astype(np.float32)).to(dev, dt)
               for _ in range(3))
    got = tfa.flash_qkv_attention(q, k, v, 2)
    want = tattn.qkv_attention_plain(q, k, v, None, 2)
    atol = 2 ** -6 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=atol)
