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
- K6 (csrc/conv_tf32_sm90.cu): for each 128-pixel tile (the plan's box) and
  each 32-deep K block (one tap, 32 channels of x or of x2), the A box read
  at (c0, j0 + dx − 1, i0 + dy − 1, b) with zeros outside the map (TMA's
  fill), the prologue (the affine, then SiLU), then the border mask, then A
  rounded to TF32, times the block's 32 columns of the weight's K-major
  copy (tap-major, x's channels then x2's, rounded to TF32), f32 sums, the
  bias and residual, and the statistics summed from per-tile partials. A
  walk with the mask applied to the loaded values before the prologue
  (where TMA's zeros already are: silu(shift) reaches the border), and one
  whose copy holds x2's K columns before x's in each tap, must fail. (A
  mask between the affine and SiLU would be harmless: silu(0) = 0.)
- K7 (the same kernel at four taps): each CTA one output phase (py, px) of
  one tile of x, tap (dy, dx) read at (i + py + dy − 1, j + px + dx − 1)
  with TMA's zeros as the padding, A rounded to TF32, times phase p's rows
  of the stack's
  K-major copy [4, Co, 4C], stored at (2i + py, 2j + px). A walk that
  stores the phases with py and px swapped must fail.

- K4 (the same kernel at one tap): x read as [B][rows][C] in tiles of 128
  rows (zeros past the last, which are neither stored nor counted), each
  32-deep K block's A through the prologue (the GroupNorm affine, SiLU or
  not) and rounded to TF32, times the K-major copy [Co, C], then the bias,
  the residual and the per-tile statistics. A walk with the affine's shift
  dropped must fail.
- K9 (csrc/flash_attention_bwd_tf32_sm90.cu): q, k, v and dO rounded to
  TF32 (the row tiles, in shared memory), the pre-pass's K-major copies of
  q, dO and k (rounded, each group of 8 positions holding rows 0, 2, 4,
  6, 1, 3, 5, 7 of the group, zeros past the sequence), Δ = rowsum(dO ∘ o)
  in f32; the dK/dV walk over query tiles and the dQ walk over key tiles
  of the plan's widths, P = exp2(s·d^-1/2·log2(e) − lse2) and dS = P ∘ (dP
  − Δ)·d^-1/2 rounded to TF32 as fragments whose position p of a group is
  column KEY_OF_POS[p], multiplied with the copies' positions. Walks whose
  copies keep natural order (the pre-pass's permutation dropped), and one
  whose dS leaves out Δ, must fail.
- K1 (csrc/attention_tf32_sm90.cu at d <= 160): the pre-pass rounds q and k
  to TF32 and writes V's K-major copy (positions in the fragments' order,
  rounded, zeros past Sk up to a multiple of 8); the core walks key tiles of
  the plan's width, keys past Sk masked, the key bias added in the log2
  domain before the maximum, P rounded to TF32 with l summed over the
  rounded values, lse = m + log2(l), o / l stored unrounded. At d = 512
  (csrc/attention_wide_tf32_sm90.cu) tiles of 8 keys, S the sum of the two
  warpgroups' partial products over their halves of d. Walks whose copy
  keeps V's natural key order, and (at d = 512) whose warpgroups each take
  their own half's scores unsummed, must fail.
- K10 (the same core over 77 keys): q = LN(x)·Wq rounded as it is stored,
  k rounded by the pre-pass, V's copy, the key-padding bias, o rounded as
  it is stored, o·Wo + bo + x. A walk whose copy keeps V's natural key
  order must fail.

SiLU is exact here; the kernel's (h + h·tanh(h), h = v / 2, with MUFU's
tanh) differs by about 2^-11 relative, below TF32's rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.ops import flash_attention as jfa
from sdtpu.ops import fused_conv as jfc
from sdtpu.ops import fused_cross_attention as jfx
from sdtpu.ops import fused_mlp as jfm
from sdtpu.ops import fused_transformer as jft
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_cross_attention as tfx
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


# ------------------------------------------------------------ K6, K7


def k6_tf32_walk(x, w, cb, scale=None, shift=None, residual=None, x2=None, scale2=None,
                 shift2=None, mask="after", swap_x2=False):
    """csrc/conv_tf32_sm90.cu's walk: returns (y, per-channel (Σ, Σ²) of y
    summed from the per-tile partials). mask: "after" the prologue (the
    kernel's) or "before" it; swap_x2: a K-major copy whose taps hold x2's
    channels before x's."""
    b, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    ct, co = c1 + c2, w.shape[-1]
    plan = tfc.tf32_conv_plan(b, h, wd, c1, c2, co, scale is not None)
    bm, bk = tfc.SM90_CONV_BM, tfc.TF32_CONV_BK
    tiles_w = wd // plan.bw
    if swap_x2:
        w = torch.cat([w[:, :, c1:], w[:, :, :c1]], dim=2)
    wt = tfm.kmajor(w)  # [Co, 9·ct]
    out = torch.zeros(b, h, wd, co)
    parts = torch.zeros(b, plan.grid[1], 2, co)
    r = torch.arange(bm)
    for bi in range(b):
        for tile in range(plan.grid[1]):
            i0, j0 = tile // tiles_w * plan.bh, tile % tiles_w * plan.bw
            pi, pj = i0 + r // plan.bw, j0 + r % plan.bw
            acc = torch.zeros(bm, co)
            for kb in range(9 * ct // bk):
                tap, c0 = divmod(kb * bk, ct)
                dy, dx = divmod(tap, 3)
                part2 = c0 >= c1
                src, cc = (x2, c0 - c1) if part2 else (x, c0)
                si, sj = pi + dy - 1, pj + dx - 1
                inside = (si >= 0) & (si < h) & (sj >= 0) & (sj < wd)
                a = torch.zeros(bm, bk)  # TMA's zeros outside the map
                a[inside] = src[bi, si[inside], sj[inside], cc:cc + bk]
                if scale is not None:
                    sc, sh = (scale2, shift2) if part2 else (scale, shift)
                    if mask == "before":
                        a[~inside] = 0.0
                    a = a * sc[bi, cc:cc + bk] + sh[bi, cc:cc + bk]
                    a = a * torch.sigmoid(a)
                    if mask == "after":
                        a[~inside] = 0.0
                acc += rna(a) @ wt[:, kb * bk:(kb + 1) * bk].t()
            v = acc + cb
            keep = pi < h  # rows of a box taller than what is left of the map
            if residual is not None:
                v[keep] += residual[bi, pi[keep], pj[keep]]
            out[bi, pi[keep], pj[keep]] = v[keep]
            parts[bi, tile] = torch.stack([v[keep].sum(0), (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


def k7_tf32_walk(x, w, cb, swap=False):
    """csrc/conv_tf32_sm90.cu's walk at four taps: returns (y, per-channel
    (Σ, Σ²) of y from the per-tile partials of every phase). swap: phase
    (py, px) stored at (2i + px, 2j + py)."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    plan = tfc.upsample_tf32_plan(b, h, wd, c, co)
    bm, bk = tfc.SM90_CONV_BM, tfc.TF32_CONV_BK
    tiles_w = wd // plan.bw
    wt = tfm.kmajor(tfc.phase_weight_stack(w, torch.float32), "stack")  # [4, Co, 4C]
    out = torch.zeros(b, 2 * h, 2 * wd, co)
    parts = torch.zeros(b, 4 * plan.grid[1], 2, co)
    r = torch.arange(bm)
    for z in range(plan.grid[2]):  # blockIdx.z = 4·b + 2·py + px
        bi, phase = divmod(z, 4)
        py, px = divmod(phase, 2)
        for tile in range(plan.grid[1]):
            i0, j0 = tile // tiles_w * plan.bh, tile % tiles_w * plan.bw
            pi, pj = i0 + r // plan.bw, j0 + r % plan.bw
            acc = torch.zeros(bm, co)
            for kb in range(4 * c // bk):
                tap, c0 = divmod(kb * bk, c)
                dy, dx = divmod(tap, 2)
                si, sj = pi + py + dy - 1, pj + px + dx - 1
                inside = (si >= 0) & (si < h) & (sj >= 0) & (sj < wd)
                a = torch.zeros(bm, bk)
                a[inside] = x[bi, si[inside], sj[inside], c0:c0 + bk]
                acc += rna(a) @ wt[phase, :, kb * bk:(kb + 1) * bk].t()
            v = acc + cb
            keep = pi < h
            oy, ox = (px, py) if swap else (py, px)
            out[bi, 2 * pi[keep] + oy, 2 * pj[keep] + ox] = v[keep]
            parts[bi, phase * plan.grid[1] + tile] = torch.stack([v[keep].sum(0),
                                                                  (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


def _close(got, want) -> bool:
    return bool(np.all(np.abs(_np(got) - _np(want)) <= TOL + TOL * np.abs(_np(want))))


def _check_stats(y, st):
    """The emitted statistics are the sums of the walk's own f32 output."""
    yr = y.reshape(y.shape[0], -1, y.shape[-1])
    want = torch.stack([yr.sum(1), (yr * yr).sum(1)], dim=1)
    np.testing.assert_allclose(_np(st), _np(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("residual", [True, False], ids=["res", "no_res"])
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("c2", [0, 32], ids=["x", "x_x2"])
@pytest.mark.parametrize("w_map", [16, 8])
def test_k6_tf32_walk_matches_sdtpu(w_map, c2, prologue, residual):
    """At H = 8 and 32 channels: W = 16 takes boxes of 16 pixels by 8 rows,
    W = 8 one box of 8 by 16 rows (its last 8 rows past the map, dropped);
    one or two 32-deep K blocks a tap. Held against sdtpu's conv3x3_fused
    in interpret mode at float32 (its statistics too)."""
    r = np.random.default_rng(110 + w_map + c2 + 2 * prologue + residual)
    b, h, c1, co = 2, 8, 32, 40

    def f(*shape, scale=1.0, loc=0.0):
        return (loc + scale * r.standard_normal(shape)).astype(np.float32)

    x, w = f(b, h, w_map, c1), f(3, 3, c1 + c2, co, scale=(9 * (c1 + c2)) ** -0.5)
    cb, res = f(co, scale=0.1), f(b, h, w_map, co)
    # a GroupNorm folded to (scale, shift); the shift far enough from 0 that
    # silu(shift) would show at the border
    s, o = f(b, c1 + c2, scale=0.1, loc=1.0), f(b, c1 + c2, scale=0.2, loc=0.5)
    x2 = f(b, h, w_map, c2) if c2 else None
    t = torch.from_numpy
    args = [t(x), t(w), t(cb)] + ([t(s[:, :c1]), t(o[:, :c1])] if prologue else [None, None])
    jargs = [jnp.asarray(x), jnp.asarray(w), jnp.asarray(cb)] + (
        [jnp.asarray(s[:, :c1]), jnp.asarray(o[:, :c1])] if prologue else [None, None])
    walk_kw = dict(residual=t(res) if residual else None)
    jkw = dict(residual=jnp.asarray(res) if residual else None, emit_stats=True,
               interpret=True)
    if c2:
        walk_kw.update(x2=t(x2))
        jkw.update(x2=jnp.asarray(x2))
        if prologue:
            walk_kw.update(scale2=t(s[:, c1:]), shift2=t(o[:, c1:]))
            jkw.update(prologue_scale2=jnp.asarray(s[:, c1:]),
                       prologue_bias2=jnp.asarray(o[:, c1:]))
    got, got_st = k6_tf32_walk(*args, **walk_kw)
    want, want_st = jfc.conv3x3_fused(*jargs, **jkw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    _check_stats(got, got_st)
    np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=TOL,
                               atol=TOL * float(np.abs(_np(want_st)).max()))
    if prologue:
        leak, _ = k6_tf32_walk(*args, **walk_kw, mask="before")
        assert not _close(leak, want)
    if c2:
        swapped, _ = k6_tf32_walk(*args, **walk_kw, swap_x2=True)
        assert not _close(swapped, want)


@pytest.mark.parametrize("hw,c,co", [((8, 8), 32, 40), ((8, 16), 64, 32), ((16, 16), 32, 64)],
                         ids=["8x8", "8x16", "16x16"])
def test_k7_tf32_walk_matches_sdtpu(hw, c, co):
    """K7's phases at four taps (one box of 8 pixels by 16 rows, or 16 by
    8), against sdtpu's upsample2x_conv_fused in interpret mode at float32;
    the phases stored with py and px swapped fail."""
    r = np.random.default_rng(130 + c + co + hw[1])
    h, wd = hw
    x = r.standard_normal((2, h, wd, c)).astype(np.float32)
    w = (r.standard_normal((3, 3, c, co)) * (9 * c) ** -0.5).astype(np.float32)
    cb = (0.1 * r.standard_normal(co)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, w, cb)]
    got, got_st = k7_tf32_walk(*t)
    want, want_st = jfc.upsample2x_conv_fused(*map(jnp.asarray, (x, w, cb)), emit_stats=True,
                                              interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    _check_stats(got, got_st)
    np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=TOL,
                               atol=TOL * float(np.abs(_np(want_st)).max()))
    bad, _ = k7_tf32_walk(*t, swap=True)
    assert not _close(bad, want)


# ------------------------------------------------------------ K4, K9


def k4_tf32_walk(x, w, cb, scale=None, shift=None, residual=None, silu=False):
    """csrc/conv_tf32_sm90.cu's walk at one tap: returns (y, per-channel
    (Σ, Σ²) of y summed from the per-tile partials)."""
    b, rows, c = x.shape
    co = w.shape[-1]
    plan = tfc.conv1x1_tf32_plan(b, rows, c, co, scale is not None)
    bm, bk = tfc.SM90_CONV_BM, tfc.TF32_CONV_BK
    wt = tfm.kmajor(w)  # [Co, C]
    out = torch.zeros(b, rows, co)
    parts = torch.zeros(b, plan.grid[1], 2, co)
    for bi in range(b):
        for tile in range(plan.grid[1]):
            r = tile * bm + torch.arange(bm)
            keep = r < rows  # TMA's zeros past the last row, not stored
            acc = torch.zeros(bm, co)
            for kb in range(c // bk):
                cols = slice(kb * bk, (kb + 1) * bk)
                a = torch.zeros(bm, bk)
                a[keep] = x[bi, r[keep], cols]
                if scale is not None:
                    a = a * scale[bi, cols] + shift[bi, cols]
                    if silu:
                        a = a * torch.sigmoid(a)
                acc += rna(a) @ wt[:, cols].t()
            v = acc + cb
            if residual is not None:
                v[keep] += residual[bi, r[keep]]
            out[bi, r[keep]] = v[keep]
            parts[bi, tile] = torch.stack([v[keep].sum(0), (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


@pytest.mark.parametrize("form", ["proj_in", "proj_out", "silu_res"])
def test_k4_tf32_walk_matches_sdtpu(form):
    """K4 at one tap over 200 rows (two tiles of 128, the second ragged)
    and 64 channels (two 32-deep K blocks): proj_in (the GroupNorm affine
    alone), proj_out (the residual, no prologue), and the affine with SiLU
    and the residual; against sdtpu's conv1x1_fused in interpret mode at
    float32, its statistics too. The affine's shift dropped fails."""
    r = np.random.default_rng({"proj_in": 150, "proj_out": 151, "silu_res": 152}[form])
    b, rows, c, co = 2, 200, 64, 40

    def f(*shape, scale=1.0, loc=0.0):
        return (loc + scale * r.standard_normal(shape)).astype(np.float32)

    x, w, cb, res = f(b, rows, c), f(c, co, scale=c ** -0.5), f(co, scale=0.1), f(b, rows, co)
    s, o = f(b, c, scale=0.1, loc=1.0), f(b, c, scale=0.2, loc=0.5)
    prologue, residual, silu = form != "proj_out", form != "proj_in", form == "silu_res"
    t = torch.from_numpy
    pro = (t(s), t(o)) if prologue else (None, None)
    got, got_st = k4_tf32_walk(t(x), t(w), t(cb), *pro, t(res) if residual else None, silu)
    want, want_st = jfc.conv1x1_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cb),
        *((jnp.asarray(s), jnp.asarray(o)) if prologue else (None, None)),
        residual=jnp.asarray(res) if residual else None, silu=silu, emit_stats=True,
        interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    _check_stats(got, got_st)
    np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=TOL,
                               atol=TOL * float(np.abs(_np(want_st)).max()))
    if prologue:
        no_shift, _ = k4_tf32_walk(t(x), t(w), t(cb), t(s), torch.zeros_like(t(o)),
                                   t(res) if residual else None, silu)
        assert not _close(no_shift, want)


def _frag(n):
    """Positions 0 .. n (n a multiple of 8) -> the columns the fragments
    hold there: position p of a group of 8 is its column KEY_OF_POS[p] (k =
    t is column 2t, k = t + 4 column 2t + 1), as in K2's core."""
    return (torch.arange(n).view(-1, 8) // 8 * 8 + KEY_OF_POS).reshape(-1)


def _pad_rows(x, n):
    return torch.cat([x, x.new_zeros(x.shape[0], n - x.shape[1], *x.shape[2:])], dim=1)


def k9_tf32_walk(q, k, v, do, permuted=True, delta=True):
    """csrc/flash_attention_bwd_tf32_sm90.cu's walk over [BH, S, d] f32:
    returns (dq, dk, dv). o and lse2 are the forward's (K1's), here in f32;
    permuted: the pre-pass's copies in the fragments' order (the kernel's)
    or in natural order; delta: dS with Δ (the kernel's) or without."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    plan = tfa.bwd_tf32_plan(d)
    scale = d ** -0.5
    sl2 = scale * LOG2E
    s = (q @ k.transpose(1, 2)) * scale
    lse2 = torch.logsumexp(s, dim=-1) * LOG2E
    o = torch.softmax(s, dim=-1) @ v
    dl = (do * o).sum(-1) if delta else torch.zeros(bh, sq)

    def copy(x, n):
        """The pre-pass's copy as rows by position: position p holds row
        _frag(n)[p] (natural order: row p), rounded, zeros past S."""
        xp = _pad_rows(x, n)
        return rna(xp[:, _frag(n)] if permuted else xp)

    tq, tk = plan.tile_kv, plan.tile_q
    nq, nk = -(-sq // tq) * tq, -(-sk // tk) * tk  # whole tiles (zeros past S)
    qt, dot = _pad_rows(copy(q, -(-sq // 8) * 8), nq), _pad_rows(copy(do, -(-sq // 8) * 8), nq)
    kt = _pad_rows(copy(k, -(-sk // 8) * 8), nk)
    qr, dor = _pad_rows(rna(q), nq), _pad_rows(rna(do), nq)
    kr, vr = _pad_rows(rna(k), nk), _pad_rows(rna(v), nk)
    lse_p, dl_p = _pad_rows(lse2, nq), _pad_rows(dl, nq)
    # dK/dV: keys against each query tile (S^T, dP^T), the fragments' column
    # for position p of the tile's copy tiles being query fcol[p]
    dk, dv = torch.zeros(bh, nk, d), torch.zeros(bh, nk, d)
    fq, fk = _frag(tq), _frag(tk)
    for j0 in range(0, nq, tq):
        js = slice(j0, j0 + tq)
        st = kr @ qr[:, js].transpose(1, 2)  # [BH, keys, queries]
        p = torch.exp2(st * sl2 - lse_p[:, None, js])
        dpt = vr @ dor[:, js].transpose(1, 2)
        ds = p * (dpt - dl_p[:, None, js]) * scale
        dv += rna(p)[:, :, fq] @ dot[:, js]
        dk += rna(ds)[:, :, fq] @ qt[:, js]
    # dQ: queries against each key tile
    dq = torch.zeros(bh, sq, d)
    for j0 in range(0, nk, tk):
        js = slice(j0, j0 + tk)
        sc = qr[:, :sq] @ kr[:, js].transpose(1, 2)
        p = torch.exp2(sc * sl2 - lse2[:, :, None])
        dp = dor[:, :sq] @ vr[:, js].transpose(1, 2)
        ds = rna(p * (dp - dl[:, :, None]) * scale)
        dq += ds[:, :, fk] @ kt[:, js]
    return dq, dk[:, :sk], dv[:, :sk]


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_k9_tf32_walk_matches_sdtpu(d):
    """K9's float32 walk at each head width it has an instance for, Sq =
    256 (whole query tiles; sdtpu's blocks take multiples of 128) and Sk =
    196 (key tiles ragged, the copies padded to 200), against sdtpu's
    flash_attention_bwd_heads in interpret mode at float32 within
    chip_smoke.py's FLASH_TOL (2^-8 of each gradient's largest |reference|
    + 2^-10 relative). The copies in natural order, and dS without Δ, fail
    it."""
    r = np.random.default_rng(170 + d)
    bh, sq, sk = 2, 256, 196
    q, do = (r.standard_normal((bh, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (r.standard_normal((bh, sk, d)).astype(np.float32) for _ in range(2))
    want = [_np(g) for g in jfa.flash_attention_bwd_heads(
        *map(jnp.asarray, (q, k, v, do)), interpret=True)]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]

    def close(grads):
        return [bool(np.all(np.abs(_np(g) - w) <= 2.0 ** -8 * np.abs(w).max()
                            + 2.0 ** -10 * np.abs(w))) for g, w in zip(grads, want)]

    got = k9_tf32_walk(*t)
    assert close(got) == [True] * 3, [float(np.abs(_np(g) - w).max()) for g, w in zip(got, want)]
    # natural order: dQ off (k's copy) and dK, dV off (q's and dO's)
    assert close(k9_tf32_walk(*t, permuted=False)) == [False] * 3
    assert close(k9_tf32_walk(*t, delta=False))[:2] == [False, False]


# ------------------------------------------------------------ K1, K10


def tf32_v_copy(v, permuted=True):
    """The pre-pass's K-major copy of v [B, H, S, d], as rows by position
    [B, H, S8, d] (S8 = S rounded up to 8): position p holds key _frag(S8)[p]
    (permuted=False: key p), rounded, zeros past S."""
    b, h, s, d = v.shape
    s8 = -(-s // 8) * 8
    vp = torch.cat([v, v.new_zeros(b, h, s8 - s, d)], dim=2)
    return rna(vp[:, :, _frag(s8)] if permuted else vp)


def k1_tf32_core_walk(q, k, vs, tile, key_bias=None, round_o=False):
    """csrc/attention_tf32_sm90.cu's walk over q, k [B, H, S, d] (rounded
    already: the pre-pass's copies) and vs (tf32_v_copy's rows by position):
    key tiles of `tile`, keys past Sk masked, the key bias [B, Sk] added in
    the log2 domain before the maximum, P rounded to TF32 (l over the
    rounded values), P's fragment column p of each group of 8 = key
    KEY_OF_POS[p] against the copy's position p. Returns (o / l, rounded
    when round_o, lse [B, H, Sq] in the log2 domain)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sl2 = d ** -0.5 * LOG2E
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for j0 in range(0, sk, tile):
        n = min(tile, sk - j0)
        n8 = -(-n // 8) * 8  # the copy's positions of this tile (zeros past Sk)
        sc = q @ k[:, :, j0:j0 + n].transpose(-1, -2)
        if key_bias is None:
            t = sc * sl2
        else:
            t = sc * sl2 + key_bias[:, None, None, j0:j0 + n] * LOG2E
        t = torch.cat([t, t.new_full((b, h, sq, n8 - n), -math.inf)], dim=-1)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = rna(torch.exp2(t - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p[..., _frag(n8)] @ vs[:, :, j0:j0 + n8]
        m = m_new
    o = o / l
    return (rna(o) if round_o else o), (m + torch.log2(l))[..., 0]


def k1_tf32_wide_walk(q, k, vs, key_bias=None, summed=True):
    """csrc/attention_wide_tf32_sm90.cu's walk over rounded q, k [B, H, S,
    512] and vs: tiles of 8 keys, each warpgroup's partial scores over its
    half of d, S = S_0 + S_1 in both, the softmax and P as in the core, each
    warpgroup's 256 columns of O. summed=False (a planted fault): each
    warpgroup's softmax on its own half's scores alone. Returns (o, lse)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    half = d // 2
    sl2 = d ** -0.5 * LOG2E
    m = [torch.full((b, h, sq, 1), -math.inf) for _ in range(2)]
    l = [torch.zeros((b, h, sq, 1)) for _ in range(2)]
    o = [torch.zeros((b, h, sq, half)) for _ in range(2)]
    for j0 in range(0, sk, 8):
        n = min(8, sk - j0)
        part = [q[..., w * half:(w + 1) * half]
                @ k[:, :, j0:j0 + n, w * half:(w + 1) * half].transpose(-1, -2)
                for w in range(2)]
        for w in range(2):
            sc = part[0] + part[1] if summed else part[w]
            t = sc * sl2
            if key_bias is not None:
                t = t + key_bias[:, None, None, j0:j0 + n] * LOG2E
            t = torch.cat([t, t.new_full((b, h, sq, 8 - n), -math.inf)], dim=-1)
            m_new = torch.maximum(m[w], t.amax(-1, keepdim=True))
            alpha = torch.exp2(m[w] - m_new)
            p = rna(torch.exp2(t - m_new))
            l[w] = l[w] * alpha + p.sum(-1, keepdim=True)
            o[w] = o[w] * alpha + p[..., _frag(8)] @ vs[:, :, j0:j0 + 8, w * half:(w + 1) * half]
            m[w] = m_new
    return torch.cat([o[w] / l[w] for w in range(2)], dim=-1), (m[0] + torch.log2(l[0]))[..., 0]


def _flash_close(got, want):
    """chip_smoke.py's FLASH_TOL for float32: 2^-8 of the largest
    |reference| + 2^-10 relative."""
    return bool(np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want).max()
                       + 2.0 ** -10 * np.abs(want)))


@pytest.mark.parametrize("d", [40, 64, 160])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_k1_tf32_walk_matches_sdtpu(d, bias):
    """K1's float32 walk at d = 40 and 160 (key tiles of 32) and 64 (of 64),
    two batch elements of two heads, Sq = 200 (a ragged query tile), Sk =
    200 with the bias (the last key tile ragged, sdtpu pads its keys to 256)
    and 256 without it, against sdtpu's flash_attention_heads in interpret
    mode at float32 within chip_smoke.py's FLASH_TOL, the lse within its
    LSE_TOL (2^-9) of the plain version's. With the bias the padding keys'
    scores are 30 times the real ones'. V's copy in natural key order fails."""
    r = np.random.default_rng(180 + d + bias)
    bh, n_head, sq = 4, 2, 200
    sk = 200 if bias else 256
    q, k, v = (r.standard_normal((bh, n, d)).astype(np.float32) for n in (sq, sk, sk))
    kb = None
    if bias:
        kb = np.where(np.arange(sk)[None] < np.array([[70], [150]]), 0.0, -1e30).astype(
            np.float32)
        k[np.repeat(kb < 0, n_head, axis=0)] *= 30.0
    want = _np(jfa.flash_attention_heads(*map(jnp.asarray, (q, k, v)),
                                         key_bias=None if kb is None else jnp.asarray(kb),
                                         n_head=n_head, interpret=True))
    t = [torch.from_numpy(a).view(bh // n_head, n_head, -1, d) for a in (q, k, v)]
    tkb = None if kb is None else torch.from_numpy(kb)
    tile = tfa.tf32_core_plan(d).tile

    def walk(permuted=True):
        o, lse = k1_tf32_core_walk(rna(t[0]), rna(t[1]), tf32_v_copy(t[2], permuted), tile, tkb)
        return _np(o.reshape(bh, sq, d)), lse.reshape(bh, sq)

    got, lse = walk()
    assert _flash_close(got, want), float(np.abs(got - want).max())
    _, plain_lse = tfa.flash_attention_heads_plain(
        *(x.reshape(bh, -1, d) for x in t), tkb, n_head, return_lse=True)
    np.testing.assert_allclose(_np(lse), _np(plain_lse), rtol=0, atol=2.0 ** -9)
    assert not _flash_close(walk(permuted=False)[0], want)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_k1_tf32_wide_walk_matches_sdtpu(bias):
    """K1's float32 walk at d = 512 (the two warpgroups' halves of d), two
    heads of 200 rows, against sdtpu in interpret mode at float32 within
    FLASH_TOL; the halves' scores unsummed, and V's copy in natural key
    order, fail it."""
    r = np.random.default_rng(190 + bias)
    bh, s, d = 2, 200, 512
    q, k, v = (r.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3))
    kb = None
    if bias:
        kb = np.where(np.arange(s)[None] < np.array([[70], [150]]), 0.0, -1e30).astype(
            np.float32)
        k[kb < 0] *= 30.0
    want = _np(jfa.flash_attention_heads(*map(jnp.asarray, (q, k, v)),
                                         key_bias=None if kb is None else jnp.asarray(kb),
                                         interpret=True))
    t = [torch.from_numpy(a).view(bh, 1, s, d) for a in (q, k, v)]
    tkb = None if kb is None else torch.from_numpy(kb)
    assert tfa.wide_tf32_plan(d).tile == 8

    def walk(permuted=True, summed=True):
        o, lse = k1_tf32_wide_walk(rna(t[0]), rna(t[1]), tf32_v_copy(t[2], permuted), tkb,
                                   summed)
        return _np(o.reshape(bh, s, d)), lse.reshape(bh, s)

    got, lse = walk()
    assert _flash_close(got, want), float(np.abs(got - want).max())
    _, plain_lse = tfa.flash_attention_heads_plain(
        *(x.reshape(bh, s, d) for x in t), tkb, return_lse=True)
    np.testing.assert_allclose(_np(lse), _np(plain_lse), rtol=0, atol=2.0 ** -9)
    assert not _flash_close(walk(summed=False)[0], want)
    assert not _flash_close(walk(permuted=False)[0], want)


def k10_tf32_walk(x, kt, vt, g, b, wq, wo, bo, key_valid, n_head, permuted=True):
    """K10's float32 route: q = LN(x)·Wq rounded as stored, k rounded and
    V's copy by the pre-pass, the core with the key-padding bias and o
    rounded as stored, then o·Wo + bo + x."""
    bsz, s, c = x.shape
    d = c // n_head

    def heads(t):
        return t.reshape(bsz, -1, n_head, d).transpose(1, 2)

    q = rna(_ln_rounded(x, g, b) @ rna(wq))
    kb = None if key_valid is None else torch.where(key_valid, 0.0, tfa.NEG_INF).float()
    o, _ = k1_tf32_core_walk(heads(q), rna(heads(kt.transpose(1, 2))),
                             tf32_v_copy(heads(vt.transpose(1, 2)), permuted),
                             tfa.tf32_core_plan(d).tile, kb, round_o=True)
    return x + o.transpose(1, 2).reshape(bsz, s, c) @ rna(wo) + bo


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("c,n_head", [(80, 2), (128, 2)], ids=["d40", "d64"])
def test_k10_tf32_walk_matches_sdtpu(c, n_head, masked):
    """B = 2, S = 200 (a ragged query tile), 77 keys (three tiles of 32 at d =
    40, two of 64 at d = 64, the last ragged; V's copy padded to 80);
    masked: the prompts' 2 and 9 real keys, the padding keys' scores 30
    times larger. Against sdtpu's fused_cross_attention_kv in interpret
    mode at float32 within TOL, the attention term within FLASH_TOL; V's
    copy in natural key order fails it."""
    r = np.random.default_rng(200 + c + masked)
    b, s, sk = 2, 200, 77
    x = r.standard_normal((b, s, c)).astype(np.float32)
    kt, vt = (r.standard_normal((b, c, sk)).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    beta = (0.1 * r.standard_normal(c)).astype(np.float32)
    wq, wo = ((c ** -0.5 * r.standard_normal((c, c))).astype(np.float32) for _ in range(2))
    bo = (0.1 * r.standard_normal(c)).astype(np.float32)
    valid = None
    if masked:
        valid = np.arange(sk)[None] < np.array([[2], [9]])
        kt = np.where(valid[:, None, :], kt, 30.0 * kt).astype(np.float32)
    args = (x, kt, vt, g, beta, wq, wo, bo)
    want = _np(jfx.fused_cross_attention_kv(
        *map(jnp.asarray, args), key_valid=None if valid is None else jnp.asarray(valid),
        n_head=n_head, interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    tvalid = None if valid is None else torch.from_numpy(valid)
    assert isinstance(tfx.route_plan(torch.float32, b, s, c, n_head, sk, masked), tfx.Tf32Plan)
    got = _np(k10_tf32_walk(*targs, tvalid, n_head))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    a = 2.0 ** -8 * float(np.abs(want - x).max())
    assert np.all(np.abs(got - want) <= a + 2.0 ** -10 * np.abs(want))
    wrong = _np(k10_tf32_walk(*targs, tvalid, n_head, permuted=False))
    assert not np.all(np.abs(wrong - want) <= a + 2.0 ** -10 * np.abs(want))
