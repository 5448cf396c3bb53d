"""The tile walks of K6's, K2's, K1's, K4's, K7's, K10's and K3's Hopper
kernels, emulated in torch on the CPU and held against sdtpu's Pallas
kernels in interpret mode.

The kernels (csrc/conv_sm90.cu, csrc/attention_sm90.cu,
csrc/attention_wide_sm90.cu, csrc/channel_stats_sm90.cu) run only on the
card. What they compute apart from the products' rounding is how they walk
their tiles, and that walk is written out here, step for step, in f32:

- K6: for each 128-pixel tile (a box of bw = gcd(W, 128) pixels by 128 / bw
  rows, from fused_conv.sm90_plan) and each 64-deep K block (one tap, 64
  channels of x or of x2), the A box read at (c0, j0 + dx − 1, i0 + dy − 1,
  b) with zeros outside the map (TMA's fill), the prologue, then the border
  mask, the product with the weight's [9·C, Co] rows, the epilogue, and the
  per-tile statistics partials. Without the mask, the zeros of the fill go through
  the prologue and silu(shift) leaks into the border: that walk must fail
  the tolerance.
- K2's core: the key tiles of 64 rows, d zero-padded to the core's dpad,
  the online softmax (running maximum in the log2 domain, the scale folded
  into exp2, O rescaled each tile, divided by l once), and P rounded to bf16
  before P·V as the kernel rounds it.
- K1 on the same core: the key bias added in the log2 domain before the
  row maximum (fma(s, scale·log2(e), bias·log2(e))), Sk not a multiple of
  64, and each row's log-sum-exp m + log2(l). Walks that add the bias after
  the maximum, or drop it, must fail: the padding keys carry large scores,
  so a maximum taken over them underflows every real key's weight.
- K1 at d = 512 (csrc/attention_wide_sm90.cu): key tiles of 64, each
  warpgroup's 32-key slice of S over the full depth, the two slices' row
  maxima exchanged so that both warpgroups rescale by the same factor, P
  rounded to bf16 and written into its slice's columns, each warpgroup's
  256-column slice of O += P·V, its own row sums, added once at the end
  and divided once. Walks without the exchange (each slice's own running
  maximum), or with the two P slices swapped, must fail.
- K4 (csrc/conv_sm90.cu at one tap): 128-row tiles inside one image (the
  rows past the last one zero-filled and neither stored nor counted),
  64-deep K blocks, the prologue with or without SiLU rounded to x's dtype
  before the product, bias and residual in f32, and the per-tile statistics
  partials summed. A walk without the prologue must fail.
- K7 (csrc/conv_sm90.cu at four taps): each CTA one output phase (py, px)
  of one 128-pixel tile of x, tap (dy, dx)'s box read at (c0, j0 + px + dx
  − 1, i0 + py + dy − 1, b) with zeros outside the map (TMA's fill is the
  zero padding: no prologue, no mask), the product with phase p's rows of
  the [4, 4C, Co] stack, the bias, the stores at (2i + py, 2j + px), and
  the per-tile statistics of every phase summed. Walks that interleave the
  phases with py and px swapped, or read the taps without the −1, must
  fail.
- K10 on K2's bf16 route without K and V in the first product: LN(x)·Wq,
  the core's walk over 77 keys (two key tiles, the second masked past Sk)
  with the key bias of the masked prompts, then o·Wo + bo + x. A walk that
  drops the key bias must fail the masked case.

- K3 (csrc/channel_stats_sm90.cu): 8-channel vectors, each CTA of a
  cluster a chunk of rows, its row lanes' sums, summed over the lanes of a
  warp, over the warps, then over the cluster's ranks in rank order, at
  ragged row counts and a ragged last channel block. Walks that drop one
  rank's partial, or read batch b + 1's rows for b, must fail.

Tolerances: the walks in f32 against sdtpu's f32 kernels and the plain
versions, 2e-4 (sums in another order, as tests/test_torch_resblock.py);
K2's walk with P rounded to bf16, 2^-8 of the attention term's largest
|value| (one bf16 rounding of each weight, 2^-9 relative, averaged over
the keys), which a walk over every other key fails.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import sdtpu.ops.flash_attention as jfa
import sdtpu.ops.fused_conv as jfc
import sdtpu.ops.fused_cross_attention as jfx
import sdtpu.ops.fused_groupnorm as jfg
import sdtpu.ops.fused_transformer as jft
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_cross_attention as tfx
from sdtpu_torch.ops import fused_groupnorm as tfg
from sdtpu_torch.ops.groupnorm import layer_norm

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
LOG2E = 1.0 / math.log(2.0)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ K6


def k6_walk(x, w, cb, scale=None, shift=None, residual=None, silu=True, x2=None,
            scale2=None, shift2=None, mask=True):
    """csrc/conv_sm90.cu's walk in f32: returns (y, per-channel (Σ, Σ²) of
    the f32 y summed from the per-tile partials)."""
    b, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    ct, co = c1 + c2, w.shape[-1]
    plan = tfc.sm90_plan(b, h, wd, c1, c2, co, scale is not None)
    bm, bk = tfc.SM90_CONV_BM, tfc.SM90_CONV_BK
    tiles_w = wd // plan.bw
    wmat = w.reshape(9 * ct, co).float()
    out = torch.zeros(b, h, wd, co)
    parts = torch.zeros(b, plan.grid[1], 2, co)
    r = torch.arange(bm)
    for bi in range(b):
        for tile in range(plan.grid[1]):
            i0, j0 = tile // tiles_w * plan.bh, tile % tiles_w * plan.bw
            pi, pj = i0 + r // plan.bw, j0 + r % plan.bw  # the tile's pixels
            acc = torch.zeros(bm, co)
            for kb in range(9 * ct // bk):
                tap, c0 = divmod(kb * bk, ct)
                dy, dx = divmod(tap, 3)
                part2 = c0 >= c1
                src, cc = (x2, c0 - c1) if part2 else (x, c0)
                # the box at (cc, j0 + dx − 1, i0 + dy − 1, bi): row r of it is
                # pixel (pi + dy − 1, pj + dx − 1), zero outside the map
                si, sj = pi + dy - 1, pj + dx - 1
                inside = (si >= 0) & (si < h) & (sj >= 0) & (sj < wd)
                a = torch.zeros(bm, bk)
                a[inside] = src[bi, si[inside], sj[inside], cc:cc + bk].float()
                if scale is not None:
                    sc, sh = (scale2, shift2) if part2 else (scale, shift)
                    a = a * sc[bi, cc:cc + bk].float() + sh[bi, cc:cc + bk].float()
                    if silu:
                        a = a * torch.sigmoid(a)
                    if mask:
                        a[~inside] = 0.0
                acc += a @ wmat[kb * bk:(kb + 1) * bk]
            v = acc + cb.float()
            keep = pi < h  # rows of a box taller than what is left of the map
            if residual is not None:
                v[keep] += residual[bi, pi[keep], pj[keep]].float()
            out[bi, pi[keep], pj[keep]] = v[keep]
            parts[bi, tile] = torch.stack([v[keep].sum(0), (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


def _k6_case(w_map, c2, prologue, seed):
    r = np.random.default_rng(seed)
    b, h, c1, co = 2, 4, 64, 16
    f = lambda *s, scale=1.0: (scale * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    x, x2 = f(b, h, w_map, c1), (f(b, h, w_map, c2) if c2 else None)
    w, cb, res = f(3, 3, c1 + c2, co, scale=0.05), f(co, scale=0.1), f(b, h, w_map, co)
    pro = None
    if prologue:
        # a GroupNorm folded to (scale, shift) as gn_scale_bias gives it; the
        # shift far enough from 0 that silu(shift) would show at the border
        pro = (1.0 + f(b, c1 + c2, scale=0.1), 0.5 + f(b, c1 + c2, scale=0.2))
    return x, x2, w, cb, res, pro


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("c2", [0, 64], ids=["x", "x_x2"])
@pytest.mark.parametrize("w_map", [16, 256, 96])
def test_k6_walk_matches_sdtpu_and_plain(w_map, c2, prologue):
    """At H = 4: W = 16 takes one box of 16 pixels by 8 rows (its last 4 rows
    past the map, dropped), W = 256 two boxes of 128 pixels a row, W = 96
    (SD v2.1's 96² latent's width) three boxes of 32 pixels by 4 rows."""
    x, x2, w, cb, res, pro = _k6_case(w_map, c2, prologue, 50 + w_map + c2)
    c1 = x.shape[-1]
    t = torch.from_numpy
    kw = dict(residual=t(res), emit_stats=True)
    jkw = dict(residual=jnp.asarray(res), emit_stats=True, interpret=True)
    args, jargs = [t(x), t(w), t(cb)], [jnp.asarray(x), jnp.asarray(w), jnp.asarray(cb)]
    if pro:
        s, o = pro
        args += [t(s[:, :c1]), t(o[:, :c1])]
        jargs += [jnp.asarray(s[:, :c1]), jnp.asarray(o[:, :c1])]
        if c2:
            kw.update(prologue_scale2=t(s[:, c1:]), prologue_bias2=t(o[:, c1:]))
            jkw.update(prologue_scale2=jnp.asarray(s[:, c1:]),
                       prologue_bias2=jnp.asarray(o[:, c1:]))
    if c2:
        kw["x2"], jkw["x2"] = t(x2), jnp.asarray(x2)
    walk_kw = dict(residual=kw["residual"], x2=kw.get("x2"),
                   scale2=kw.get("prologue_scale2"), shift2=kw.get("prologue_bias2"))
    got, got_st = k6_walk(*args, **walk_kw)
    want, want_st = jfc.conv3x3_fused(*jargs, **jkw)
    plain, plain_st = tfc.conv3x3_fused_plain(*args, **kw)
    for ref, ref_st in ((want, want_st), (plain, plain_st)):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
        # f32 sums over up to 1024 rows of magnitude ~3, in another order
        np.testing.assert_allclose(_np(got_st), _np(ref_st), rtol=1e-4, atol=1e-2)
    if pro:
        # the same walk without the border mask: silu(shift) of TMA's zeros
        # reaches the border pixels
        leak, _ = k6_walk(*args, **walk_kw, mask=False)
        assert not np.allclose(_np(leak), _np(want), **TOL)
        assert float((leak - plain).abs().max()) > 50 * TOL["atol"]


# ------------------------------------------------------------ K2


def k2_core_walk(q, k, v, round_p: bool, key_bias=None, bias: str = "before max"):
    """csrc/attention_sm90.cu's walk over q, k, v [B, H, S, d] in f32, with
    K1's optional key bias [B, Sk] added "before max" (as the kernel does),
    "after max" or "dropped" (planted faults): returns (o [B, H, Sq, d],
    the rows' log2-domain log-sum-exp [B, H, Sq])."""
    b, nh, sq, d = q.shape
    sk = k.shape[2]
    plan = tfa.core_sm90_plan(d, key_bias is not None)
    dp, bt = plan.dpad, plan.tile
    nk = -(-sk // bt)
    rows = -(-sq // tfa.SM90_ATTN_ROWS) * tfa.SM90_ATTN_ROWS
    # the copy's zero fill: columns d..dpad, rows past Sq or Sk (and the
    # bias past Sk)
    qp = F.pad(q, (0, dp - d, 0, rows - sq))
    kp, vp = (F.pad(t, (0, dp - d, 0, nk * bt - sk)) for t in (k, v))
    kbp = None if key_bias is None else F.pad(key_bias, (0, nk * bt - sk))[:, None, None, :]
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full((b, nh, rows, 1), -math.inf)
    l = torch.zeros(b, nh, rows, 1)
    o = torch.zeros(b, nh, rows, dp)
    for j in range(nk):
        kt, vt = kp[:, :, j * bt:(j + 1) * bt], vp[:, :, j * bt:(j + 1) * bt]
        s = qp @ kt.transpose(-1, -2)
        s[..., sk - j * bt:] = -math.inf  # keys past Sk (the last tile only)
        s2 = s * scale_log2  # the log2 domain (one fma with the bias in the kernel)
        if kbp is not None and bias != "dropped":
            kb2 = kbp[..., j * bt:(j + 1) * bt] * LOG2E
            if bias == "before max":
                s2 = s2 + kb2
        m_new = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        if kbp is not None and bias == "after max":
            s2 = s2 + kb2
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s2 - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if round_p:
            p = p.to(torch.bfloat16).float()
        o = o * alpha + p @ vt
        m = m_new
    lse = (m + torch.log2(l))[..., 0]
    return (o / l)[:, :, :sq, :d], lse[:, :, :sq]


def k2_walk(x, ln_g, ln_b, wqkv, wo, bo, n_head, round_p=False, every_other_key=False):
    """K2's sublayer around the core's walk: LN(x)·Wqkv, the walk per head,
    o·Wo + bo + x, in f32."""
    b, s, c = x.shape
    q, k, v = (t.reshape(b, s, n_head, c // n_head).transpose(1, 2)
               for t in (layer_norm(x, ln_g, ln_b) @ wqkv).chunk(3, dim=-1))
    if every_other_key:
        k, v = k[:, :, ::2], v[:, :, ::2]
    o = k2_core_walk(q, k, v, round_p)[0].transpose(1, 2).reshape(b, s, c)
    return x + o @ wo + bo


@pytest.mark.parametrize("c,n_head", [(80, 2), (160, 2)], ids=["d40", "d80"])
def test_k2_walk_matches_sdtpu(c, n_head):
    """S = 200: four key tiles, the last one 8 keys long, and two query
    tiles of 128 rows, the second ragged."""
    r = np.random.default_rng(60 + c)
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
    np.testing.assert_allclose(_np(k2_walk(*targs, n_head)), want, **TOL)
    # P rounded to bf16 as the kernel rounds it: within 2^-8 of the
    # attention term's largest |value|; every other key falls outside
    atol = 2.0 ** -8 * float(np.abs(want - x).max())
    rounded = _np(k2_walk(*targs, n_head, round_p=True))
    np.testing.assert_allclose(rounded, want, rtol=0, atol=atol)
    half = _np(k2_walk(*targs, n_head, round_p=True, every_other_key=True))
    assert np.abs(half - want).max() > 4 * atol


# ------------------------------------------------------------ K1


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_k1_walk_matches_sdtpu_and_plain(d, bias):
    """Two batch elements of two heads, Sq = 200 (a ragged query tile), Sk
    = 200 with the bias (four key tiles, the last one 8 keys long; sdtpu
    pads its keys to 256) and 256 without it. The padding keys past each
    row's count carry scores 30 times larger than the real ones."""
    r = np.random.default_rng(80 + d + bias)
    bh, n_head, sq = 4, 2, 200
    sk = 200 if bias else 256
    q, k, v = (r.standard_normal((bh, n, d)).astype(np.float32) for n in (sq, sk, sk))
    kb = None
    if bias:
        n_valid = np.array([70, 150])
        kb = np.where(np.arange(sk)[None] < n_valid[:, None], 0.0, -1e30).astype(np.float32)
        pad = np.repeat(kb < 0, n_head, axis=0)
        k[pad] *= 30.0
    want = _np(jfa.flash_attention_heads(*map(jnp.asarray, (q, k, v)),
                                         key_bias=None if kb is None else jnp.asarray(kb),
                                         n_head=n_head, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tkb = None if kb is None else torch.from_numpy(kb)
    plain, plain_lse = tfa.flash_attention_heads_plain(*t, tkb, n_head, return_lse=True)
    q4, k4, v4 = (x.view(bh // n_head, n_head, *x.shape[1:]) for x in t)

    def walk(**kw):
        o, lse = k2_core_walk(q4, k4, v4, False, tkb, **kw)
        return o.reshape(bh, sq, d), lse.reshape(bh, sq)

    got, lse = walk()
    for ref in (want, _np(plain)):
        np.testing.assert_allclose(_np(got), ref, **TOL)
    np.testing.assert_allclose(_np(lse), _np(plain_lse), **TOL)
    if bias:
        for fault in ("after max", "dropped"):
            bad, _ = walk(bias=fault)
            assert not np.allclose(_np(bad), want, **TOL, equal_nan=False), fault


def k1_wide_walk(q, k, v, key_bias=None, round_p=False, exchange=True, swap=False):
    """csrc/attention_wide_sm90.cu's walk over q, k, v [BH, S, d] (one head
    a batch element) in f32, with the optional key bias [BH, Sk] added in
    the log2 domain before the maximum. exchange=False (a planted fault):
    each warpgroup's running maximum over its own key slices alone;
    swap=True: the two P slices written into each other's columns. Returns
    (o [BH, Sq, d], the rows' log2-domain log-sum-exp [BH, Sq])."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    plan = tfa.wide_sm90_plan(d)
    dp, bt, nw = plan.dpad, plan.tile, tfa.WIDE_WARPGROUPS
    keys, cols = bt // nw, dp // nw
    nk = -(-sk // bt)
    rows = -(-sq // tfa.WIDE_ROWS) * tfa.WIDE_ROWS
    # TMA's zeros: columns d..dpad, rows past Sq or Sk
    qp = F.pad(q, (0, dp - d, 0, rows - sq))
    kp, vp = (F.pad(t, (0, dp - d, 0, nk * bt - sk)) for t in (k, v))
    kbp = None if key_bias is None else F.pad(key_bias, (0, nk * bt - sk))[:, None, :]
    scale_log2 = d ** -0.5 * LOG2E
    # each warpgroup's running maximum, its row sums over its keys, and its
    # column slice of O
    m = [torch.full((bh, rows, 1), -math.inf) for _ in range(nw)]
    l = [torch.zeros(bh, rows, 1) for _ in range(nw)]
    o = [torch.zeros(bh, rows, cols) for _ in range(nw)]
    for j in range(nk):
        s = []
        for w in range(nw):
            k0 = j * bt + w * keys
            sw = qp @ kp[:, k0:k0 + keys].transpose(-1, -2) * scale_log2
            if kbp is not None:
                sw = sw + kbp[..., k0:k0 + keys] * LOG2E
            sw[..., max(0, sk - k0):] = -math.inf  # keys past Sk
            s.append(sw)
        part = [sw.amax(dim=-1, keepdim=True) for sw in s]  # each slice's row maxima
        p, alpha = [], []
        for w in range(nw):
            tile = torch.maximum(part[0], part[1]) if exchange else part[w]
            m_new = torch.maximum(m[w], tile)
            alpha.append(torch.exp2(m[w] - m_new))
            m[w] = m_new
            pw = torch.exp2(s[w] - m_new)
            l[w] = l[w] * alpha[w] + pw.sum(dim=-1, keepdim=True)
            p.append(pw.to(torch.bfloat16).float() if round_p else pw)
        pt = torch.cat(p[::-1] if swap else p, dim=-1)  # P's 64 columns
        for w in range(nw):
            o[w] = o[w] * alpha[w] + pt @ vp[:, j * bt:(j + 1) * bt, w * cols:(w + 1) * cols]
    lt = l[0] + l[1]
    out = torch.cat(o, dim=-1) / lt
    return out[:, :sq, :d], (m[0] + torch.log2(lt))[:, :sq, 0]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_k1_wide_walk_matches_sdtpu_and_plain(bias):
    """d = 512, BH = 2, S = 200: three full key tiles and one of 8 keys
    (the second warpgroup's slice of it all past Sk), four query tiles, the
    last ragged. With the bias the padding keys past each row's count carry
    scores 30 times larger than the real ones. The walk in f32 within 2e-4
    of sdtpu and of the plain version; with P rounded to bf16 within 2^-8
    of the largest |value| (the kernel's rounding), which the walks without
    the max exchange or with the P slices swapped fall far outside."""
    r = np.random.default_rng(90 + bias)
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
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tkb = None if kb is None else torch.from_numpy(kb)
    plain, plain_lse = tfa.flash_attention_heads_plain(*t, tkb, return_lse=True)
    got, lse = k1_wide_walk(*t, tkb)
    for ref in (want, _np(plain)):
        np.testing.assert_allclose(_np(got), ref, **TOL)
    np.testing.assert_allclose(_np(lse), _np(plain_lse), **TOL)
    atol = 2.0 ** -8 * float(np.abs(want).max())
    rounded = _np(k1_wide_walk(*t, tkb, round_p=True)[0])
    np.testing.assert_allclose(rounded, want, rtol=0, atol=atol)
    for fault in ({"exchange": False}, {"swap": True}):
        bad = _np(k1_wide_walk(*t, tkb, round_p=True, **fault)[0])
        assert np.abs(bad - want).max() > 4 * atol, fault


# ------------------------------------------------------------ K3


def k3_walk(x, plan, drop_rank=None, next_batch=False):
    """csrc/channel_stats_sm90.cu's decomposition of x [B, rows, C] in f32:
    for each (batch, channel block of plan.cb channels) the cluster's ranks
    take chunks of ceil(rows / cluster) rows; in a rank, row lane r of the
    CTA's 256 / (cb / 8) sums rows r, r + lanes, ...; the lanes of a warp
    (32 / (cb / 8) of them) are summed, then the warps, then the ranks in
    rank order. Planted faults: drop_rank, that rank's partial left out;
    next_batch, batch b + 1's rows read for b (zeros past the last).
    Returns [B, 2, C]."""
    b, rows, c = x.shape
    cb, cluster = plan
    lanes = 256 // (cb // 8)
    per_warp = 32 // (cb // 8)
    chunk = -(-rows // cluster)
    cpad = -(-c // cb) * cb  # the last block's channels past C read nothing
    xp = F.pad(x, (0, cpad - c))
    if next_batch:
        xp = torch.cat([xp[1:], torch.zeros_like(xp[:1])])
    out = torch.zeros(b, 2, cpad)
    for bb in range(b):
        for c0 in range(0, cpad, cb):
            total = torch.zeros(2, cb)
            for rank in range(cluster):
                rr = xp[bb, rank * chunk:min(rows, (rank + 1) * chunk), c0:c0 + cb]
                lane = torch.zeros(lanes, 2, cb)
                for i in range(rr.shape[0]):
                    lane[i % lanes] += torch.stack([rr[i], rr[i] * rr[i]])
                warps = lane.reshape(lanes // per_warp, per_warp, 2, cb).sum(dim=1)
                part = warps.sum(dim=0)
                if rank != drop_rank:
                    total = total + part
            out[bb, :, c0:c0 + cb] = total
    return out[..., :c]


@pytest.mark.parametrize("shape,plan", [
    ((2, 63, 96), None),                        # the plan's own: 16 channels, 16 ranks
    ((2, 1000, 320), tfg.StatsPlan(32, 8)),     # the 64² x 320 level's plan, fewer rows
    ((1, 130, 40), tfg.StatsPlan(64, 16)),      # a ragged channel block, 16 ranks
    ((3, 77, 128), tfg.StatsPlan(16, 4)),
])
def test_k3_walk_matches_sdtpu_and_plain(shape, plan):
    """The walk at ragged row counts within 1e-4 of sdtpu's channel_partials
    (interpret mode) and of the plain version; the walks that drop the last
    rank that holds rows, or read the next batch element's rows, fail it."""
    r = np.random.default_rng(100 + shape[-1])
    x = r.standard_normal(shape).astype(np.float32)
    plan = plan or tfg.stats_plan(*shape)
    want = _np(jfg.channel_partials(jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    got = _np(k3_walk(xt, plan))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, _np(tfg.channel_partials_plain(xt)), **tol)
    last = (shape[1] - 1) // -(-shape[1] // plan.cluster)
    for fault in ({"drop_rank": last}, {"next_batch": True}):
        bad = _np(k3_walk(xt, plan, **fault))
        assert not np.allclose(bad, want, **tol), fault


# ------------------------------------------------------------ K4


def k4_walk(x, w, cb, scale=None, shift=None, residual=None, silu=False, prologue=True):
    """csrc/conv_sm90.cu's walk at one tap, in f32 from x's values: returns
    (y, per-channel (Σ, Σ²) of the f32 y summed from the per-tile
    partials). prologue=False skips the prologue (a planted fault)."""
    b, rows, c = x.shape
    co = w.shape[-1]
    plan = tfc.conv1x1_sm90_plan(b, rows, c, co, scale is not None)
    bm, bk = tfc.SM90_CONV_BM, tfc.SM90_CONV_BK
    assert (plan.bw, plan.bh) == (1, bm) and plan.grid[1] == -(-rows // bm)
    out = torch.zeros(b, rows, co)
    parts = torch.zeros(b, plan.grid[1], 2, co)
    for bi in range(b):
        for tile in range(plan.grid[1]):
            r = tile * bm + torch.arange(bm)  # the tile's rows, inside image bi
            keep = r < rows
            for n0 in range(0, co, plan.bn):
                cols = slice(n0, min(n0 + plan.bn, co))  # a ragged last tile of columns
                acc = torch.zeros(bm, cols.stop - n0)
                for kb in range(c // bk):
                    ch = slice(kb * bk, (kb + 1) * bk)
                    a = torch.zeros(bm, bk)  # the TMA box: zeros past the last row
                    a[keep] = x[bi, r[keep], ch].float()
                    if scale is not None and prologue:
                        a = a * scale[bi, ch].float() + shift[bi, ch].float()
                        if silu:
                            a = a * torch.sigmoid(a)
                        a = a.to(x.dtype).float()  # rounded before the product
                    acc += a @ w[ch, cols].float()
                v = acc + cb[cols].float()
                if residual is not None:
                    v[keep] += residual[bi, r[keep], cols].float()
                out[bi, r[keep], cols] = v[keep]
                parts[bi, tile, :, cols] = torch.stack([v[keep].sum(0), (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


@pytest.mark.parametrize("residual", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("prologue", ["none", "affine", "silu"])
def test_k4_walk_matches_sdtpu_and_plain(prologue, residual):
    """B = 2, 300 rows (three tiles, the last 44 rows long), C = 128 (two K
    blocks), Co = 72 (one tile, its columns past 72 dropped)."""
    r = np.random.default_rng(90 + len(prologue) + residual)
    b, rows, c, co = 2, 300, 128, 72
    def f(*shape, scale=1.0, loc=0.0):
        return (loc + scale * r.standard_normal(shape)).astype(np.float32)

    x, w, cb = f(b, rows, c), f(c, co, scale=c ** -0.5), f(co, scale=0.1)
    res = f(b, rows, co) if residual else None
    pro = (f(b, c, scale=0.2, loc=1.0), f(b, c, scale=0.2, loc=0.5)) if prologue != "none" else ()
    silu = prologue == "silu"
    t = torch.from_numpy
    kw = dict(residual=None if res is None else t(res), silu=silu, emit_stats=True)
    walk_kw = dict(residual=kw["residual"], silu=silu)
    got, got_st = k4_walk(t(x), t(w), t(cb), *map(t, pro), **walk_kw)
    want, want_st = jfc.conv1x1_fused(*map(jnp.asarray, (x, w, cb, *pro)),
                                      residual=None if res is None else jnp.asarray(res),
                                      silu=silu, emit_stats=True, interpret=True)
    plain, plain_st = tfc.conv1x1_fused_plain(t(x), t(w), t(cb), *map(t, pro), **kw)
    for ref, ref_st in ((want, want_st), (plain, plain_st)):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
        # f32 sums over 300 rows of magnitude ~2, in another order
        np.testing.assert_allclose(_np(got_st), _np(ref_st), rtol=1e-4, atol=1e-2)
    if pro:
        skipped, _ = k4_walk(t(x), t(w), t(cb), *map(t, pro), **walk_kw, prologue=False)
        assert not np.allclose(_np(skipped), _np(want), **TOL)
        assert float((skipped - plain).abs().max()) > 50 * TOL["atol"]


def test_k4_walk_rounds_its_prologue_to_bf16():
    """In bf16 the walk's prologue output is rounded to bf16 before the
    product, as the kernel and the plain version round it: against the
    plain version within a few bf16 ulps (6e-2, the card's tolerance)."""
    r = np.random.default_rng(95)
    b, rows, c = 1, 200, 64
    def bf(*shape, scale=1.0):
        return torch.from_numpy(scale * r.standard_normal(shape)).to(torch.bfloat16)

    x, w, cb = bf(b, rows, c), bf(c, c, scale=c ** -0.5), bf(c, scale=0.1)
    s, o = (torch.from_numpy(1.0 + 0.2 * r.standard_normal((b, c))).float(),
            torch.from_numpy(0.5 + 0.2 * r.standard_normal((b, c))).float())
    got, _ = k4_walk(x, w, cb, s, o, silu=True)
    want = tfc.conv1x1_fused_plain(x, w, cb, s, o, silu=True)
    torch.testing.assert_close(got.to(torch.bfloat16).float(), want.float(), rtol=3e-2,
                               atol=6e-2)


# ------------------------------------------------------------ K7


def k7_walk(x, w, cb, swap=False, origin=-1):
    """csrc/conv_sm90.cu's walk at four taps, in f32: returns (y, per-channel
    (Σ, Σ²) of the f32 y summed from the per-tile partials of every phase).
    Planted faults: swap stores phase (py, px) at (2i + px, 2j + py);
    origin=0 reads tap (dy, dx) at (i + py + dy, j + px + dx)."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    plan = tfc.upsample_sm90_plan(b, h, wd, c, co)
    bm, bk = tfc.SM90_CONV_BM, tfc.SM90_CONV_BK
    tiles_w = wd // plan.bw
    assert plan.grid == (-(-co // plan.bn), -(-h // plan.bh) * tiles_w, 4 * b)
    wstack = tfc.phase_weight_stack(w, torch.float32)  # [4, 4C, Co]
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
                si, sj = pi + py + dy + origin, pj + px + dx + origin
                inside = (si >= 0) & (si < h) & (sj >= 0) & (sj < wd)
                a = torch.zeros(bm, bk)  # TMA's zeros outside the map
                a[inside] = x[bi, si[inside], sj[inside], c0:c0 + bk].float()
                acc += a @ wstack[phase, kb * bk:(kb + 1) * bk]
            v = acc + cb.float()
            keep = pi < h
            oy, ox = (px, py) if swap else (py, px)
            out[bi, 2 * pi[keep] + oy, 2 * pj[keep] + ox] = v[keep]
            parts[bi, phase * plan.grid[1] + tile] = torch.stack([v[keep].sum(0),
                                                                  (v[keep] ** 2).sum(0)])
    return out, parts.sum(dim=1)


@pytest.mark.parametrize("hw,c,co,stats", [
    ((8, 8), 64, 64, True),      # one box of 8 pixels by 16 rows, its last 8 past the map
    ((16, 16), 128, 128, False),  # boxes of 16 pixels by 8 rows
    ((16, 16), 64, 128, True),
    ((2, 256), 64, 64, True),     # two boxes of 128 pixels a row
    ((4, 192), 64, 64, True),     # three boxes of 64 pixels by 2 rows (SD v2.1's 192² width)
], ids=["8x8", "16x16", "16x16_co128", "2x256", "4x192"])
def test_k7_walk_matches_sdtpu_and_plain(hw, c, co, stats):
    r = np.random.default_rng(100 + c + co + hw[1])
    h, wd = hw
    x = r.standard_normal((2, h, wd, c)).astype(np.float32)
    w = (r.standard_normal((3, 3, c, co)) * (9 * c) ** -0.5).astype(np.float32)
    cb = (0.1 * r.standard_normal(co)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, w, cb)]
    got, got_st = k7_walk(*t)
    want = jfc.upsample2x_conv_fused(*map(jnp.asarray, (x, w, cb)), emit_stats=stats,
                                     interpret=True)
    plain = tfc.upsample2x_conv_fused_plain(*t, emit_stats=stats)
    for ref in (want, plain):
        if stats:
            ref, ref_st = ref
            # f32 sums over up to 1024 outputs of magnitude ~1, in another order
            np.testing.assert_allclose(_np(got_st), _np(ref_st), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    want = _np(want[0] if stats else want)
    for fault in (dict(swap=True), dict(origin=0)):
        bad, _ = k7_walk(*t, **fault)
        assert not np.allclose(_np(bad), want, **TOL), fault
        assert float(np.abs(_np(bad) - want).max()) > 50 * TOL["atol"], fault


def test_k7_plan_offsets_are_the_phase_paddings():
    """The kernel's tap origin (py − 1, px − 1) is minus the top and left
    zero padding of the phase's 2x2 convolution (ops/conv.py), and its
    bottom and right padding is py, px: the taps reach one pixel past x at
    most."""
    for (py, px), ((top, bottom), (left, right)) in tfc.UPSAMPLE_PHASE_PADS.items():
        assert (py - 1, px - 1) == (-top, -left) and (py, px) == (bottom, right)


# ------------------------------------------------------------ K10


def k10_walk(x, kt, vt, ln_g, ln_b, wq, wo, bo, key_valid, n_head, bias="before max"):
    """K10's bf16 route in f32: LN(x)·Wq, the core's walk per head over kt/vt's
    keys with the key bias of key_valid (0 / -1e30), o·Wo + bo + x."""
    b, s, c = x.shape
    d = c // n_head

    def heads(t):
        return t.reshape(b, -1, n_head, d).transpose(1, 2)

    kb = None if key_valid is None else torch.where(key_valid, 0.0, tfa.NEG_INF).float()
    o, _ = k2_core_walk(heads(layer_norm(x, ln_g, ln_b) @ wq), heads(kt.transpose(1, 2)),
                        heads(vt.transpose(1, 2)), False, kb, bias=bias)
    return x + o.transpose(1, 2).reshape(b, s, c) @ wo + bo


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("c,n_head", [(80, 2), (160, 2)], ids=["d40", "d80"])
def test_k10_walk_matches_sdtpu(c, n_head, masked):
    """B = 2, S = 256 (two query tiles), 77 keys (two key tiles, the second
    13 keys long); masked: the prompts' 2 and 9 real keys, the padding keys'
    scores 30 times larger than the real ones."""
    r = np.random.default_rng(110 + c + masked)
    b, s, sk = 2, 256, 77
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
    assert tfx.sm90_plan(b, s, c, n_head, sk, masked) is not None
    got = _np(k10_walk(*targs, tvalid, n_head))
    np.testing.assert_allclose(got, want, **TOL)
    plain = _np(tfx.fused_cross_attention_kv_plain(*targs, tvalid, n_head))
    np.testing.assert_allclose(got, plain, **TOL)
    if masked:
        dropped = _np(k10_walk(*targs, tvalid, n_head, bias="dropped"))
        assert not np.allclose(dropped, want, **TOL)
        assert float(np.abs(dropped - want).max()) > 50 * TOL["atol"]

