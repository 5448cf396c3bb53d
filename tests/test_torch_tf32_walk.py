"""K2's and K5's float32 routes (csrc/gemm_tf32_sm90.cu,
csrc/attention_tf32_sm90.cu) emulated in torch on the CPU, step for step
where they round, and held against sdtpu's Pallas kernels in interpret mode
at float32 (the tolerance chip_smoke.py holds the kernels to on the card).

The kernels run only on the card. What they compute apart from the order of
their sums is written out here:

- K5: the LayerNorm in f32 from the row statistics (x·rstd − μ·rstd, then
  ·γ + β), rounded to TF32 (round to nearest, ties away: the kernels'
  cvt.rna), the weights rounded to TF32 (their K-major copies are made
  rounded), f32 sums, the GEGLU epilogue, h rounded to TF32 as it is stored,
  the second product, bias and residual in f32. A walk with the val and gate
  halves swapped must fail.
- K2: the QKV product on the rounded LayerNorm, q, k and v rounded as they
  are stored, v written as [B, H, d, S] with each group of 8 keys in the
  order 0, 2, 4, 6, 1, 3, 5, 7; the core's walk over key tiles of the
  plan's width (64 at d = 64 and 80, 32 at 40 and 160): S = q·kᵀ, the online softmax in the log2 domain, P rounded to
  TF32 and its row sums taken over the rounded values, P·V with a thread's
  fragment columns t and t + 4 read as keys 2t and 2t + 1 against the
  stored V's positions t and t + 4, o / l rounded as it is stored, then
  o·Wo + bo + x. A walk whose V keeps its keys in their natural order
  (the epilogue's permutation dropped) must fail.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import fused_mlp as jfm
from sdtpu.ops import fused_transformer as jft
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.ops import fused_transformer as tft

torch.set_num_threads(1)

TOL = 5e-3  # chip_smoke.py's float32 tolerance (atol and rtol): TF32 products
LOG2E = 1.4426950408889634


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


rna = tfm.round_tf32


def _ln_rounded(x, g, b, eps=1e-5):
    """The kernels' LayerNorm prologue: (μ, rstd) from the two-pass row
    statistics, x·rstd + (−μ·rstd), then ·γ + β, rounded to TF32."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    return rna((x * rstd + (-mean * rstd)) * g + b)


def k5_tf32_walk(x, g, b, wp, bp, wl, bl, swap_halves=False):
    c4 = wl.shape[0]
    a = _ln_rounded(x, g, b) @ rna(wp) + bp
    val, gate = a[..., :c4], a[..., c4:]
    if swap_halves:
        val, gate = gate, val
    h = rna(val * 0.5 * gate * (1.0 + torch.erf(gate / math.sqrt(2.0))))
    return h @ rna(wl) + bl + x


# positions 0..7 of a group of 8 in the stored V hold these keys
KEY_OF_POS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def k2_core_tf32_walk(q, k, vt, d, tile):
    """The float32 core's walk over q, k [B, H, S, d] and vt [B, H, d, S]
    (stored as csrc/gemm_tf32_sm90.cu stores it): the keys in tiles of
    `tile`, P's fragment column p of each group of 8 = key KEY_OF_POS[p],
    multiplied with the stored V's position p; returns o / l rounded."""
    b, h, s, _ = q.shape
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, d))
    frag = (torch.arange(tile).view(-1, 8) // 8 * 8 + KEY_OF_POS).reshape(-1)
    for j0 in range(0, s, tile):
        n = min(tile, s - j0)
        sc = q @ k[:, :, j0:j0 + n].transpose(-1, -2)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = rna(torch.exp2(sc * scale_log2 - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        # P's columns in the fragments' order against the stored V's rows
        vs = vt[:, :, :, j0:j0 + n].transpose(-1, -2)  # [.., position, d]
        o = o * alpha + p[..., frag[:n]] @ vs
        m = m_new
    return rna(o / l)


def k2_tf32_walk(x, g, b, wqkv, wo, bo, n_head, permuted=True):
    bsz, s, c = x.shape
    d = c // n_head
    qkv = rna(_ln_rounded(x, g, b) @ rna(wqkv))
    q, k, v = qkv.chunk(3, dim=-1)
    heads = lambda t: t.view(bsz, s, n_head, d).transpose(1, 2)  # noqa: E731
    vt = tft.vt_order(v, n_head) if permuted else heads(v).transpose(-1, -2).contiguous()
    tile = tft.tf32_core_plan(d).tile
    o = k2_core_tf32_walk(heads(q), heads(k), vt, d, tile)
    return x + o.transpose(1, 2).reshape(bsz, s, c) @ rna(wo) + bo


@pytest.mark.parametrize("b,s,c", [(2, 200, 128), (1, 136, 256)])
def test_k5_tf32_walk_matches_sdtpu(b, s, c):
    r = np.random.default_rng(70 + c)
    args = [r.standard_normal((b, s, c)), 1 + 0.1 * r.standard_normal(c),
            0.1 * r.standard_normal(c), r.standard_normal((c, 8 * c)) * c ** -0.5,
            0.1 * r.standard_normal(8 * c), r.standard_normal((4 * c, c)) * (4 * c) ** -0.5,
            0.1 * r.standard_normal(c)]
    args = [np.asarray(a, np.float32) for a in args]
    want = _np(jfm.fused_geglu_mlp(*map(jnp.asarray, args), block_rows=s, interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(_np(k5_tf32_walk(*targs)), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(tfm.fused_geglu_mlp_plain(*targs)), want, rtol=2e-4,
                               atol=2e-4)
    wrong = _np(k5_tf32_walk(*targs, swap_halves=True))
    assert not np.all(np.abs(wrong - want) <= TOL + TOL * np.abs(want))


@pytest.mark.parametrize("c,n_head", [(80, 2), (128, 2), (160, 2), (320, 2)],
                         ids=["d40", "d64", "d80", "d160"])
def test_k2_tf32_walk_matches_sdtpu(c, n_head):
    """S = 200: four key tiles of 64 (seven of 32 at d = 160), the last one
    ragged, and two query tiles of 128 rows, the second ragged."""
    r = np.random.default_rng(90 + c)
    b, s = 2, 200
    x = r.standard_normal((b, s, c)).astype(np.float32)
    g, bt = (1 + 0.1 * r.standard_normal(c)).astype(np.float32), (
        0.1 * r.standard_normal(c)).astype(np.float32)
    wq, wk, wv, wo = ((c ** -0.5 * r.standard_normal((c, c))).astype(np.float32)
                      for _ in range(4))
    bo = (0.1 * r.standard_normal(c)).astype(np.float32)
    want = _np(jft.fused_self_attention(*map(jnp.asarray, (x, g, bt, wq, wk, wv, wo, bo)),
                                        n_head, block_q=40, interpret=True))
    targs = [torch.from_numpy(a) for a in (x, g, bt, np.concatenate([wq, wk, wv], 1), wo, bo)]
    got = _np(k2_tf32_walk(*targs, n_head))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the attention term within chip_smoke.py's FLASH_TOL for float32
    a = 2.0 ** -8 * float(np.abs(want - x).max())
    assert np.all(np.abs(got - want) <= a + 2.0 ** -10 * np.abs(want))
    wrong = _np(k2_tf32_walk(*targs, n_head, permuted=False))
    assert not np.all(np.abs(wrong - want) <= a + 2.0 ** -10 * np.abs(want))
