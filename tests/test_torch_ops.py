"""sdtpu_torch ops and kernels' plain versions against sdtpu.

Inputs are drawn with numpy from a seed and go through the sdtpu function
(on the CPU; Pallas kernels in interpret mode) and through its port. The
plain versions run here because the tensors lie on the CPU; the CUDA
kernels are held against them on the card (tests marked `cuda`, and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.ops as J
from sdtpu.ops import conv as jconv
from sdtpu.ops import fused_conv as jfc
from sdtpu.ops import fused_groupnorm as jfg
from sdtpu.ops import fused_mlp as jfm
from sdtpu.ops import fused_transformer as jft
from sdtpu.ops import groupnorm as jgn
from sdtpu_torch import kernels
from sdtpu_torch import ops as T
from sdtpu_torch.ops import conv as tconv
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_groupnorm as tfg
from sdtpu_torch.ops import fused_mlp as tfm
from sdtpu_torch.ops import fused_transformer as tft
from sdtpu_torch.ops import groupnorm as tgn

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-5)  # f32, sums in another order


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="float32"):
    """The same numpy array as a jax and a torch array of one dtype."""
    jt = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tt = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return jt, tt


def _pairs(*arrays, dtype="float32"):
    js, ts = zip(*(_pair(a, dtype) for a in arrays))
    return list(js), list(ts)


# ------------------------------------------------------------ plain ops

@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 8), 4), ((1, 3, 5, 32), 8)])
def test_group_norm_and_silu(shape, groups):
    r = _rng(1)
    (x, g, b), (xt, gt, bt) = _pairs(r.standard_normal(shape) * 3 + 1,
                                     r.standard_normal(shape[-1]),
                                     r.standard_normal(shape[-1]))
    np.testing.assert_allclose(_np(tgn.group_norm(xt, gt, bt, groups, 1e-5)),
                               _np(jgn.group_norm(x, g, b, groups, 1e-5)), **F32_TOL)
    np.testing.assert_allclose(_np(tgn.group_norm_silu_op(xt, gt, bt, groups, 1e-6)),
                               _np(jgn.group_norm_silu_op(x, g, b, groups, 1e-6)),
                               **F32_TOL)


def test_layer_norm():
    r = _rng(2)
    (x, g, b), (xt, gt, bt) = _pairs(r.standard_normal((3, 5, 16)),
                                     r.standard_normal(16), r.standard_normal(16))
    np.testing.assert_allclose(_np(tgn.layer_norm(xt, gt, bt, 1e-5)),
                               _np(jgn.layer_norm(x, g, b, 1e-5)), **F32_TOL)


@pytest.mark.parametrize("name", ["silu", "quick_gelu", "gelu"])
def test_activations(name):
    (x,), (xt,) = _pairs(_rng(3).standard_normal((4, 33)) * 4)
    np.testing.assert_allclose(_np(getattr(T, name)(xt)), _np(getattr(J, name)(x)),
                               rtol=1e-6, atol=1e-6)


def test_geglu():
    (x, g), (xt, gt) = _pairs(*_rng(4).standard_normal((2, 5, 16)))
    np.testing.assert_allclose(_np(T.geglu(xt, gt)), _np(J.geglu(x, g)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [0, 999, 481])
def test_timestep_embedding(t):
    # cos/sin of t * freqs (args up to ~1e3): one ulp of the argument moves
    # the result by ~1e-4 (the attainable agreement, as in test_ops.py)
    np.testing.assert_allclose(_np(T.timestep_embedding(t, 320)),
                               _np(J.timestep_embedding(t, 320)), atol=5e-4)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(5)
    (x, w, b), (xt, wt, bt) = _pairs(r.standard_normal((2, 3, 16)),
                                     r.standard_normal((16, 24)), r.standard_normal(24))
    pj, pt = {"w": w}, {"w": wt}
    if bias:
        pj["b"], pt["b"] = b, bt
    np.testing.assert_allclose(_np(T.linear(pt, xt)), _np(J.linear(pj, x)), **F32_TOL)


def test_embedding():
    r = _rng(6)
    w = r.standard_normal((50, 8)).astype(np.float32)
    ids = np.array([[0, 7, 49, 7]])
    got = T.embedding({"w": torch.from_numpy(w)}, torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), np.asarray(J.embedding({"w": jnp.asarray(w)},
                                                                   jnp.asarray(ids))))


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 1), (1, 1, 0), (3, 2, 1), (3, 2, ((0, 1), (0, 1))),
])
def test_conv2d(k, stride, padding):
    r = _rng(7)
    (x, w, b), (xt, wt, bt) = _pairs(r.standard_normal((2, 8, 8, 6)),
                                     r.standard_normal((k, k, 6, 5)) * 0.3,
                                     r.standard_normal(5))
    got = T.conv2d({"w": wt, "b": bt}, xt, stride=stride, padding=padding)
    want = J.conv2d({"w": w, "b": b}, x, stride=stride, padding=padding)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_nearest_upsample_2x():
    (x,), (xt,) = _pairs(_rng(8).standard_normal((1, 3, 5, 2)))
    np.testing.assert_array_equal(_np(tconv.nearest_upsample_2x(xt)),
                                  _np(jconv.nearest_upsample_2x(x)))


def test_upsample2x_conv_matches_sdtpu_and_naive():
    r = _rng(9)
    (x, w, b), (xt, wt, bt) = _pairs(r.standard_normal((2, 5, 6, 4)),
                                     r.standard_normal((3, 3, 4, 3)) * 0.3,
                                     r.standard_normal(3))
    got = tconv.upsample2x_conv({"w": wt, "b": bt}, xt)
    np.testing.assert_allclose(_np(got), _np(jconv.upsample2x_conv({"w": w, "b": b}, x)),
                               **F32_TOL)
    naive = T.conv2d({"w": wt, "b": bt}, tconv.nearest_upsample_2x(xt), padding=1)
    np.testing.assert_allclose(_np(got), _np(naive), **F32_TOL)


@pytest.mark.parametrize("n_head,sq,sk,d", [(1, 7, 7, 16), (4, 10, 6, 32), (8, 16, 77, 64)])
def test_qkv_attention(n_head, sq, sk, d):
    r = _rng(10)
    (q, k, v), (qt, kt, vt) = _pairs(r.standard_normal((2, sq, d)),
                                     r.standard_normal((2, sk, d)),
                                     r.standard_normal((2, sk, d)))
    np.testing.assert_allclose(_np(T.qkv_attention(qt, kt, vt, None, n_head)),
                               _np(J.qkv_attention(q, k, v, None, n_head)), **F32_TOL)


def test_qkv_attention_causal_mask():
    (q,), (qt,) = _pairs(_rng(11).standard_normal((1, 9, 32)))
    got = T.qkv_attention(qt, qt, qt, T.causal_mask(9), 4)
    want = J.qkv_attention(q, q, q, J.causal_mask(9), 4)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_qkv_attention_key_valid():
    r = _rng(12)
    (q, k, v), (qt, kt, vt) = _pairs(r.standard_normal((2, 12, 64)),
                                     r.standard_normal((2, 77, 64)),
                                     r.standard_normal((2, 77, 64)))
    valid = np.zeros((2, 77), bool)
    valid[0, :9], valid[1, :30] = True, True
    got = T.qkv_attention(qt, kt, vt, None, 8, key_valid=torch.from_numpy(valid))
    want = J.qkv_attention(q, k, v, None, 8, key_valid=jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# ------------------------------------------------- kernels: plain versions
# Each against sdtpu's Pallas function in interpret mode, on the cases of
# sdtpu's own oracle tests (test_fused_*.py).

@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 16, 128), (2, 7, 9, 40)])
def test_channel_partials_plain(shape):
    (x,), (xt,) = _pairs(_rng(13).standard_normal(shape))
    got = tfg.channel_partials(xt)
    want = jfg.channel_partials(x, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_gn_scale_bias_and_stats_fold():
    r = _rng(14)
    (x, g, b), (xt, gt, bt) = _pairs(r.standard_normal((2, 8, 8, 128)),
                                     r.standard_normal(128), r.standard_normal(128))
    s_t, o_t = tfc.gn_scale_bias(xt, gt, bt, 32, 1e-6)
    s_j, o_j = jfc.gn_scale_bias(x, g, b, 32, 1e-6, interpret=True)
    np.testing.assert_allclose(_np(s_t), _np(s_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(o_t), _np(o_j), rtol=1e-4, atol=1e-5)
    # the fold reproduces group_norm
    np.testing.assert_allclose(_np(xt * s_t[:, None, None] + o_t[:, None, None]),
                               _np(tgn.group_norm(xt, gt, bt, 32, 1e-6)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("silu,residual,emit_stats", [
    (False, True, True),    # test_fused_conv.py:test_conv1x1_fused_matches
    (True, False, False),   # GN+SiLU prologue alone
])
def test_conv1x1_fused_plain(silu, residual, emit_stats):
    r = _rng(15)
    (x, g, b, w, cb, res), (xt, gt, bt, wt, cbt, rest) = _pairs(
        r.standard_normal((2, 8, 8, 128)), r.standard_normal(128),
        r.standard_normal(128), r.standard_normal((128, 64)) * 0.1,
        r.standard_normal(64), r.standard_normal((2, 8, 8, 64)))
    s, o = jfc.gn_scale_bias(x, g, b, 32, 1e-6, interpret=True)
    st, ot = tfc.gn_scale_bias(xt, gt, bt, 32, 1e-6)
    want = jfc.conv1x1_fused(x, w, cb, s, o, residual=res if residual else None,
                             silu=silu, emit_stats=emit_stats, block_r=32,
                             interpret=True)
    got = tfc.conv1x1_fused(xt, wt, cbt, st, ot, residual=rest if residual else None,
                            silu=silu, emit_stats=emit_stats)
    if emit_stats:
        (want, want_st), (got, got_st) = want, got
        np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def _attn_args(b, s, c, seed):
    """sdtpu's arguments: x, ln_g, ln_b, wq, wk, wv, wo, bo."""
    r = _rng(seed)
    scale = c ** -0.5
    return (r.standard_normal((b, s, c)), 1.0 + 0.1 * r.standard_normal(c),
            0.1 * r.standard_normal(c), *(scale * r.standard_normal((c, c)) for _ in range(4)),
            0.1 * r.standard_normal(c))


def _qkv(args):
    """sdtpu's (x, ln_g, ln_b, wq, wk, wv, wo, bo) as the port's, with
    wq | wk | wv side by side."""
    x, g, b, wq, wk, wv, wo, bo = args
    return (x, g, b, np.concatenate([wq, wk, wv], axis=1), wo, bo)


@pytest.mark.parametrize("b,s,c,n_head,block_q,dtype", [
    (2, 256, 64, 4, 128, "float32"),   # test_fused_transformer.py cases
    (1, 128, 80, 2, 128, "float32"),   # dh=40, the SD v1 64x64-level head dim
    (2, 64, 160, 2, 32, "float32"),
    (2, 128, 64, 4, 0, "bfloat16"),
])
def test_fused_self_attention_plain(b, s, c, n_head, block_q, dtype):
    args = _attn_args(b, s, c, 16)
    js, _ = _pairs(*args, dtype=dtype)
    _, ts = _pairs(*_qkv(args), dtype=dtype)
    want = jft.fused_self_attention(*js, n_head, block_q=block_q, interpret=True)
    got = tft.fused_self_attention(*ts, n_head)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0.05, atol=0.05)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _mlp_args(b, s, c, seed):
    r = _rng(seed)
    return (r.standard_normal((b, s, c)), 1.0 + 0.1 * r.standard_normal(c),
            0.1 * r.standard_normal(c), c ** -0.5 * r.standard_normal((c, 8 * c)),
            0.1 * r.standard_normal(8 * c), (4 * c) ** -0.5 * r.standard_normal((4 * c, c)),
            0.1 * r.standard_normal(c))


@pytest.mark.parametrize("b,s,c,block_rows,dtype", [
    (2, 256, 32, 128, "float32"),   # test_fused_mlp.py cases
    (1, 64, 64, 128, "float32"),
    (2, 128, 32, 512, "bfloat16"),
])
def test_fused_geglu_mlp_plain(b, s, c, block_rows, dtype):
    js, ts = _pairs(*_mlp_args(b, s, c, 17), dtype=dtype)
    want = jfm.fused_geglu_mlp(*js, block_rows=block_rows, interpret=True)
    got = tfm.fused_geglu_mlp(*ts)
    tol = F32_TOL if dtype == "float32" else dict(rtol=0.05, atol=0.05)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _conv3_args(shape, cout, seed):
    """x, w, conv_bias, GroupNorm gamma/beta, residual for a 3x3 conv."""
    r = _rng(seed)
    c = shape[-1]
    return (r.standard_normal(shape), 0.1 * r.standard_normal((3, 3, c, cout)),
            r.standard_normal(cout), r.standard_normal(c), r.standard_normal(c),
            r.standard_normal(shape[:-1] + (cout,)))


@pytest.mark.parametrize("shape,cout,fused,block_h", [
    ((1, 8, 8, 128), 128, False, 0),   # test_fused_conv.py:test_plain_conv_matches
    ((1, 16, 8, 128), 256, True, 8),   # GN+SiLU prologue, residual, stats; halo rows
])
def test_conv3x3_fused_plain(shape, cout, fused, block_h):
    (x, w, cb, g, b, res), (xt, wt, cbt, gt, bt, rest) = _pairs(*_conv3_args(shape, cout, 23))
    if fused:
        s, o = jfc.gn_scale_bias(x, g, b, 32, 1e-6, interpret=True)
        st, ot = tfc.gn_scale_bias(xt, gt, bt, 32, 1e-6)
        want, want_st = jfc.conv3x3_fused(x, w, cb, s, o, residual=res, emit_stats=True,
                                          block_h=block_h, interpret=True)
        got, got_st = tfc.conv3x3_fused(xt, wt, cbt, st, ot, residual=rest, emit_stats=True)
        # f32 sums of 128 outputs of magnitude ~10, in another order
        np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=1e-4, atol=1e-2)
    else:
        want = jfc.conv3x3_fused(x, w, cb, block_h=block_h, interpret=True)
        got = tfc.conv3x3_fused(xt, wt, cbt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,cout,emit_stats", [
    ((1, 8, 8, 128), 128, False),      # test_fused_conv.py:test_upsample2x_conv_fused
    ((1, 16, 8, 128), 256, True),
])
def test_upsample2x_conv_fused_plain(shape, cout, emit_stats):
    (x, w, cb), (xt, wt, cbt) = _pairs(*_conv3_args(shape, cout, 24)[:3])
    want = jfc.upsample2x_conv_fused(x, w, cb, emit_stats=emit_stats, block_h=8,
                                     interpret=True)
    got = tfc.upsample2x_conv_fused(xt, wt, cbt, emit_stats=emit_stats)
    if emit_stats:
        (want, want_st), (got, got_st) = want, got
        np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    # and the plain branch of upsample2x_conv computes the same map
    np.testing.assert_allclose(_np(tconv.upsample2x_conv({"w": wt, "b": cbt}, xt)),
                               _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,groups,silu,dtype", [
    ((2, 8, 8, 64), 32, True, "float32"),   # test_fused_groupnorm.py cases
    ((2, 7, 9, 40), 8, True, "float32"),
    ((2, 8, 8, 64), 32, False, "bfloat16"),
])
def test_group_norm_silu_plain(shape, groups, silu, dtype):
    r = _rng(25)
    (x, g, b), (xt, gt, bt) = _pairs(r.standard_normal(shape), r.standard_normal(shape[-1]),
                                     r.standard_normal(shape[-1]), dtype=dtype)
    want = jfg.group_norm_silu(x, g, b, groups, 1e-5, silu=silu, interpret=True)
    got = tfg.group_norm_silu(xt, gt, bt, groups, 1e-5, silu=silu)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=3e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # precomputed statistics give the same result
    with_sums = tfg.group_norm_silu(xt, gt, bt, groups, 1e-5, silu=silu,
                                    sums=tfg.channel_partials(xt))
    np.testing.assert_array_equal(_np(with_sums), _np(got))


def test_group_norm_silu_op_takes_in_stats():
    """With in_stats the op goes the fused way (one-pass variance); it
    matches sdtpu's two-pass GroupNorm+SiLU within f32 rounding."""
    r = _rng(26)
    (x, g, b), (xt, gt, bt) = _pairs(r.standard_normal((1, 8, 8, 128)) * 2 + 0.5,
                                     r.standard_normal(128), r.standard_normal(128))
    got = tgn.group_norm_silu_op(xt, gt, bt, 32, 1e-6, in_stats=tfg.channel_partials(xt))
    np.testing.assert_allclose(_np(got), _np(jgn.group_norm_silu_op(x, g, b, 32, 1e-6)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,c,co,want", [
    (128, 128, 512, 512, True), (64, 64, 512, 512, False),   # sdtpu's K7 gate
    (256, 256, 256, 256, True), (128, 128, 320, 320, False),
])
def test_use_fused_upsample_matches_sdtpu_bounds(h, w, c, co, want):
    assert tconv.use_fused_upsample(h, w, c, co) is want


# ------------------------------------------------------------ wrappers

WRAPPERS = [
    (tfg.channel_partials, lambda: (torch.zeros(1, 4, 4, 8),)),
    (tfc.conv1x1_fused, lambda: (torch.zeros(1, 16, 8), torch.zeros(8, 4), torch.zeros(4))),
    (tft.fused_self_attention,
     lambda: (*_pairs(*_qkv(_attn_args(1, 16, 16, 18)))[1], 2)),
    (tfm.fused_geglu_mlp, lambda: _pairs(*_mlp_args(1, 8, 8, 19))[1]),
    (tfc.conv3x3_fused, lambda: (torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8),
                                 torch.zeros(8))),
    (tfc.upsample2x_conv_fused, lambda: (torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8),
                                         torch.zeros(8))),
    (tfg.group_norm_silu, lambda: (torch.zeros(1, 4, 4, 8), torch.ones(8), torch.zeros(8), 4)),
    (tfa.flash_attention_heads, lambda: (torch.zeros(2, 16, 8), torch.zeros(2, 24, 8),
                                         torch.zeros(2, 24, 8), torch.zeros(1, 24), 2)),
]


@pytest.mark.parametrize("fn,make", WRAPPERS, ids=lambda v: getattr(v, "__name__", ""))
def test_wrapper_routes_cpu_tensors_to_plain_and_counts_nothing(fn, make):
    before = fn.launches, dict(fn.shapes)
    fn(*make())
    assert (fn.launches, fn.shapes) == before


def test_count_records_each_launch_under_its_shape():
    def wrapper():
        pass

    wrapper.launches, wrapper.shapes = 0, {}
    for s in (4096, 1024, 4096):
        kernels.count(wrapper, b=2, s=s, stats=False)
    assert wrapper.launches == 3
    assert wrapper.shapes == {"b=2 s=4096 stats=False": 2, "b=2 s=1024 stats=False": 1}


@pytest.mark.parametrize("fn,make", WRAPPERS, ids=lambda v: getattr(v, "__name__", ""))
def test_wrapper_rejects_other_devices(fn, make):
    args = [a.to("meta") if torch.is_tensor(a) else a for a in make()]
    with pytest.raises(ValueError):
        fn(*args)


def test_kernel_library_name_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == [
        "attention.cu", "attention_sm90.cu", "attention_tf32_sm90.cu", "attention_wide_sm90.cu",
        "attention_wide_tf32_sm90.cu", "channel_stats.cu", "channel_stats_sm90.cu", "conv_sm90.cu", "conv_tf32_sm90.cu",
        "cross_attention.cu", "flash_attention.cu", "flash_attention_bwd.cu",
        "flash_attention_bwd_sm90.cu", "flash_attention_bwd_tf32_sm90.cu", "gemm.cu",
        "gemm_sm90.cu", "gemm_tf32_sm90.cu", "groupnorm.cu"]


# ------------------------------------------------------------ on the card

def _card_cases(dev, dt):
    """name -> (kernel, plain, args, kwargs) at small, ragged shapes: rows,
    sequence lengths and channels that are not multiples of the tiles."""
    def card(*arrays):
        return [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt) for a in arrays]

    r = _rng(20)
    x, g, b, w, cb, res = card(r.standard_normal((2, 9, 10, 96)), r.standard_normal(96),
                               r.standard_normal(96), r.standard_normal((96, 72)) * 0.1,
                               r.standard_normal(72), r.standard_normal((2, 9, 10, 72)))
    s, o = tfc.gn_scale_bias(x, g, b, 32, 1e-6)
    x3, w3, cb3, g3, b3, res3 = card(*_conv3_args((2, 9, 10, 40), 72, 27))
    s3, o3 = tfc.gn_scale_bias(x3, g3, b3, 8, 1e-6)
    return {
        "channel_partials": (tfg.channel_partials, tfg.channel_partials_plain, (x,), {}),
        "conv1x1_fused": (tfc.conv1x1_fused, tfc.conv1x1_fused_plain, (x, w, cb, s, o),
                          dict(residual=res, silu=True, emit_stats=True)),
        "fused_self_attention": (tft.fused_self_attention, tft.fused_self_attention_plain,
                                 (*card(*_qkv(_attn_args(2, 200, 120, 21))), 3), {}),
        "fused_geglu_mlp": (tfm.fused_geglu_mlp, tfm.fused_geglu_mlp_plain,
                            card(*_mlp_args(2, 100, 48, 22)), {}),
        "conv3x3_fused": (tfc.conv3x3_fused, tfc.conv3x3_fused_plain, (x3, w3, cb3, s3, o3),
                          dict(residual=res3, emit_stats=True)),
        "upsample2x_conv_fused": (tfc.upsample2x_conv_fused, tfc.upsample2x_conv_fused_plain,
                                  (x3, w3, cb3), dict(emit_stats=True)),
        "group_norm_silu": (tfg.group_norm_silu, tfg.group_norm_silu_plain, (x, g, b, 32, 1e-6),
                            {}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["channel_partials", "conv1x1_fused",
                                  "fused_self_attention", "fused_geglu_mlp",
                                  "conv3x3_fused", "upsample2x_conv_fused",
                                  "group_norm_silu"])
def test_kernel_matches_plain_on_card(name, dtype):
    """Each kernel against its plain version on the card. Tolerances: f32,
    the kernels' TF32 products (5e-3); bf16, a few bf16 ulps (6e-2).
    channel_partials reads the same values and sums in f32 (1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    fn, plain, args, kw = _card_cases(torch.device("cuda"), getattr(torch, dtype))[name]
    before, shapes = fn.launches, dict(fn.shapes)
    got, want = fn(*args, **kw), plain(*args, **kw)
    assert fn.launches == before + 1
    assert sum(fn.shapes.values()) == sum(shapes.values()) + 1
    if kw.get("emit_stats"):
        (got, stats), (want, _) = got, want
        # the stats are sums over the f32 accumulator, before the output's
        # rounding to its dtype: held to the sums of the returned output,
        # within that rounding (2^-7 of the sum of magnitudes covers bf16)
        yf = got.float().reshape(2, -1, 72)
        for i, v in enumerate((yf, yf * yf)):
            assert ((stats[:, i] - v.sum(1)).abs() <= 2 ** -7 * v.abs().sum(1) + 1e-3).all()
    tol = 1e-3 if name == "channel_partials" else (5e-3 if dtype == "float32" else 6e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [
    (1, 333, 64),    # M = 333: the last 128-row tile ragged; one K step
    (3, 77, 320),    # M = 231; K = 320 and 1280, 5 and 20 K steps
    (1, 1000, 640),  # M = 1000 at a UNet width; the residual product on 64-column tiles
])
def test_k5_ragged_rows_match_plain_on_card(b, s, c):
    """K5's bf16 route (csrc/gemm_sm90.cu) at row counts that are not a
    multiple of its 128-row tile, against the plain version: within a few
    bf16 ulps (6e-2), and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)
            for a in _mlp_args(b, s, c, 24)]
    got, want = tfm.fused_geglu_mlp(*args), tfm.fused_geglu_mlp_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2, atol=6e-2)
    assert torch.equal(tfm.fused_geglu_mlp(*args), got)


def _routes(fn):
    """{route: launches} of a wrapper, from its per-shape counts."""
    out = {}
    for key, n in fn.shapes.items():
        route = key.rsplit("route=", 1)[-1]
        out[route] = out.get(route, 0) + n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c2,cout,prologue,residual,bn", [
    ((2, 9, 16, 64), 64, 72, True, True, 128),     # W = 16: boxes of 8 rows, the last ragged
    ((1, 4, 256, 128), 0, 256, True, False, 256),  # W = 256: two tiles a row
    ((2, 8, 64, 128), 64, 320, False, True, 256),  # no prologue: TMA's zeros pad; ragged Co
    ((2, 8, 128, 64), 64, 320, True, True, 320),   # the UNet's 320-channel tile
    ((1, 5, 128, 64), 128, 128, True, True, 128),  # H = 5 rows of one tile each
    ((2, 6, 96, 64), 64, 72, True, True, 128),     # W = 96: boxes of 32 x 4, the last ragged
    ((1, 4, 192, 128), 0, 256, True, False, 256),  # W = 192: three boxes of 64 x 2 a row
])
def test_k6_sm90_matches_plain_on_card(shape, c2, cout, prologue, residual, bn):
    """K6's bf16 route (csrc/conv_sm90.cu), on tiles of bn channels, against
    the plain version at maps whose tiles are ragged or span several rows,
    with and without x2, the prologue and the residual: within a few bf16
    ulps (6e-2); the emitted statistics against the sums of the returned
    output, within its rounding (2^-7 of the sum of magnitudes); the same
    bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = _rng(40)
    b, h, w, c1 = shape

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    x = card(r.standard_normal(shape))
    x2 = card(r.standard_normal((b, h, w, c2))) if c2 else None
    wt = card(r.standard_normal((3, 3, c1 + c2, cout)) * (9 * (c1 + c2)) ** -0.5)
    cb = card(0.1 * r.standard_normal(cout))
    kw = {"emit_stats": True}
    if residual:
        kw["residual"] = card(r.standard_normal((b, h, w, cout)))
    args = (x, wt, cb)
    if prologue:
        s = torch.from_numpy(1.0 + 0.1 * r.standard_normal((b, c1 + c2))).float().to(dev)
        o = torch.from_numpy(0.1 * r.standard_normal((b, c1 + c2))).float().to(dev)
        args += (s[:, :c1], o[:, :c1])
        if c2:
            kw.update(prologue_scale2=s[:, c1:], prologue_bias2=o[:, c1:])
    if c2:
        kw["x2"] = x2
    assert tfc.sm90_plan(b, h, w, c1, c2, cout, prologue) is not None
    plan = tfc.sm90_plan(b, h, w, c1, c2, cout, prologue, bn=bn)
    kw5 = (kw.get("residual"), True, True, kw.get("x2"), kw.get("prologue_scale2"),
           kw.get("prologue_bias2"))
    pro = args[3:] if prologue else (None, None)
    before = _routes(tfc.conv3x3_fused).get("sm90", 0)
    got, st = tfc._conv3x3(*args[:3], *pro, *kw5, plan)
    want, _ = tfc.conv3x3_fused_plain(*args, **kw)
    assert _routes(tfc.conv3x3_fused)["sm90"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2, atol=6e-2)
    yf = got.float().reshape(b, -1, cout)
    for i, v in enumerate((yf, yf * yf)):
        assert ((st[:, i] - v.sum(1)).abs() <= 2 ** -7 * v.abs().sum(1) + 1e-3).all()
    again, st2 = tfc._conv3x3(*args[:3], *pro, *kw5, plan)
    assert torch.equal(again, got) and torch.equal(st2, st)
    if tfc.sm90_plan(b, h, w, c1, c2, cout, prologue).bn == bn:
        assert torch.equal(tfc.conv3x3_fused(*args, **kw)[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [
    (2, 200, 320),   # d = 40, the last key tile and query tile ragged
    (1, 333, 640),   # d = 80
    (2, 77, 1280),   # d = 160, one key tile
    (1, 256, 512),   # d = 64
])
def test_k2_sm90_matches_plain_on_card(b, s, c):
    """K2's bf16 route (both products on csrc/gemm_sm90.cu, the core on
    csrc/attention_sm90.cu), 8 heads, against the plain version: the
    sublayer within a few bf16 ulps (6e-2), the attention term x + ... − x
    within 2^-6 of its largest |reference| + 2^-7 of |out| (what
    chip_smoke.py holds it to); the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)
            for a in _qkv(_attn_args(b, s, c, 41))]
    assert tft.sm90_plan(b, s, c, 8) is not None
    before = _routes(tft.fused_self_attention).get("sm90", 0)
    got, want = tft.fused_self_attention(*args, 8), tft.fused_self_attention_plain(*args, 8)
    assert _routes(tft.fused_self_attention)["sm90"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2, atol=6e-2)
    x = args[0].float()
    term = want.float() - x
    err = (got.float() - want.float()).abs()
    assert (err <= 2 ** -6 * term.abs().max() + 2 ** -7 * want.float().abs()).all()
    assert torch.equal(tft.fused_self_attention(*args, 8), got)


K4_SHAPES = [
    (2, 4096, 320, 320),   # proj_in / proj_out at 64² (512px)
    (2, 16384, 320, 320),  # at 128² (1024px)
    (2, 4096, 640, 640),   # at 64² (1024px)
    (8, 4096, 320, 320),   # the serve phase's batch of 4
    (1, 333, 64, 72),      # a ragged row count and a ragged last tile of columns
]


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", ["none", "affine", "silu"])
@pytest.mark.parametrize("residual", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("emit_stats", [False, True], ids=["no_stats", "stats"])
@pytest.mark.parametrize("b,rows,c,co", K4_SHAPES)
def test_k4_sm90_matches_plain_on_card(b, rows, c, co, prologue, residual, emit_stats):
    """K4's bf16 route (csrc/conv_sm90.cu at one tap) against the plain
    version at the main paths' shapes and a ragged one, with every
    prologue, residual and statistics combination: within a few bf16 ulps
    (6e-2); the emitted statistics against the sums of the returned output,
    within its rounding (2^-7 of the sum of magnitudes); the same bits on a
    second call. The tolerance rejects the product without its prologue
    and without its residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = _rng(70 + c)

    def card(a, dtype=dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    x = card(r.standard_normal((b, rows, c)))
    w, cb = card(r.standard_normal((c, co)) * c ** -0.5), card(0.1 * r.standard_normal(co))
    args = [x, w, cb]
    if prologue != "none":
        args += [card(1.0 + 0.2 * r.standard_normal((b, c)), torch.float32),
                 card(0.5 + 0.2 * r.standard_normal((b, c)), torch.float32)]
    kw = dict(silu=prologue == "silu", emit_stats=emit_stats)
    if residual:
        kw["residual"] = card(r.standard_normal((b, rows, co)))
    assert tfc.conv1x1_sm90_plan(b, rows, c, co, prologue != "none") is not None
    before = _routes(tfc.conv1x1_fused).get("sm90", 0)
    got, want = tfc.conv1x1_fused(*args, **kw), tfc.conv1x1_fused_plain(*args, **kw)
    assert _routes(tfc.conv1x1_fused)["sm90"] == before + 1
    again = tfc.conv1x1_fused(*args, **kw)
    if emit_stats:
        (got, st), (want, _), (again, st2) = got, want, again
        assert torch.equal(st2, st)
        yf = got.float()
        for i, v in enumerate((yf, yf * yf)):
            assert ((st[:, i] - v.sum(1)).abs() <= 2 ** -7 * v.abs().sum(1) + 1e-3).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2, atol=6e-2)
    assert torch.equal(again, got)
    faults = []
    if prologue != "none":
        faults.append(tfc.conv1x1_fused_plain(x, w, cb, residual=kw.get("residual")))
    if residual:
        faults.append(tfc.conv1x1_fused_plain(*args, silu=kw["silu"]))
    for f in faults:
        assert not torch.allclose(f.float(), want.float(), rtol=6e-2, atol=6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,bn,stats", [
    ((2, 9, 16, 64), 72, 128, True),    # W = 16: boxes of 8 rows, the last ragged; ragged Co
    ((1, 4, 256, 128), 256, 256, True),  # W = 256: two tiles a row
    ((2, 8, 128, 64), 320, 320, False),  # the 320-channel tile
    ((1, 16, 16, 256), 256, 256, True),  # the upsamplers' widths on a small map
    ((1, 128, 128, 512), 512, None, True),  # the 512px decode's first upsampler, its plan
    ((1, 6, 96, 64), 72, 128, True),     # W = 96: boxes of 32 x 4, the last ragged
    ((1, 192, 192, 512), 512, None, True),  # SD v2.1's 768px decode's first fused upsampler
])
def test_k7_sm90_matches_plain_on_card(shape, cout, bn, stats):
    """K7's bf16 route (csrc/conv_sm90.cu at four taps), on tiles of bn
    channels (None: the plan's), against the plain version: within a few
    bf16 ulps (6e-2); the emitted statistics against the sums of the
    returned output, within its rounding (2^-7 of the sum of magnitudes);
    the same bits on a second call; the tolerance rejects the phases
    interleaved with py and px swapped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    r = _rng(50 + cout)
    b, h, w, c = shape

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    x = card(r.standard_normal(shape))
    wt = card(r.standard_normal((3, 3, c, cout)) * (9 * c) ** -0.5)
    cb = card(0.1 * r.standard_normal(cout))
    plan = tfc.upsample_sm90_plan(b, h, w, c, cout, bn=bn)
    assert plan is not None
    before = _routes(tfc.upsample2x_conv_fused).get("sm90", 0)
    got = tfc._upsample2x(x, wt, cb, stats, plan)
    want = tfc.upsample2x_conv_fused_plain(x, wt, cb, emit_stats=stats)
    assert _routes(tfc.upsample2x_conv_fused)["sm90"] == before + 1
    again = tfc._upsample2x(x, wt, cb, stats, plan)
    if stats:
        (got, st), (want, _), (again, st2) = got, want, again
        assert torch.equal(st2, st)
        yf = got.float().reshape(b, -1, cout)
        for i, v in enumerate((yf, yf * yf)):
            assert ((st[:, i] - v.sum(1)).abs() <= 2 ** -7 * v.abs().sum(1) + 1e-3).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2, atol=6e-2)
    assert torch.equal(again, got)
    swapped = want.reshape(b, h, 2, w, 2, cout).transpose(2, 4).reshape(want.shape)
    assert not torch.allclose(swapped.float(), want.float(), rtol=6e-2, atol=6e-2)
    if bn is None:
        auto = tfc.upsample2x_conv_fused(x, wt, cb, emit_stats=stats)
        assert torch.equal(auto[0] if stats else auto, got)



# (rows, C) of K3's main-path channel widths, at a ragged row count; the
# two large ones split their rows over a cluster of 8 (bf16) or 16 (f32)
K3_CARD = [(90, 128), (77, 256), (130, 320), (63, 512), (150, 640), (99, 1280),
           (4099, 320), (16389, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", K3_CARD)
def test_k3_matches_plain_on_card(rows, c, dtype):
    """K3 (csrc/channel_stats_sm90.cu) against its plain version at each
    main-path C and a ragged row count, at B = 2: one launch on the cluster
    route, sums within 1e-3 (f32 sums in another order), the same bits on a
    second call, and the partials route's result within the same tolerance.
    The sums without the last rank's rows, or of the other batch element,
    fall outside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    x = torch.from_numpy(_rng(30 + c).standard_normal((2, rows, c)).astype(np.float32)).to(dev, dt)
    before = dict(tfg.channel_partials.shapes)
    got = tfg.channel_partials(x)
    new = {k: n - before.get(k, 0) for k, n in tfg.channel_partials.shapes.items()
           if n != before.get(k, 0)}
    assert new == {f"b=2 rows={rows} c={c} route=sm90": 1}
    want = tfg.channel_partials_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(tfg.channel_partials(x), got)
    torch.testing.assert_close(tfg._channel_partials(x, "partials"), want, rtol=1e-3, atol=1e-3)
    plan = tfg.stats_plan(2, rows, c, x.element_size())
    chunk = -(-rows // plan.cluster)
    last = (rows - 1) // chunk
    wrong = [tfg.channel_partials_plain(x[:, :last * chunk]), want.flip(0)]
    for w in wrong:
        assert not torch.allclose(w, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_k3_takes_the_partials_kernel_where_c_is_not_a_multiple_of_8():
    """C = 20 has no plan: the partials kernel and its sum, counted under its
    route, within 1e-3 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.from_numpy(_rng(31).standard_normal((2, 90, 20)).astype(np.float32)).cuda()
    before = dict(tfg.channel_partials.shapes)
    got = tfg.channel_partials(x)
    assert tfg.channel_partials.shapes["b=2 rows=90 c=20 route=partials"] == before.get(
        "b=2 rows=90 c=20 route=partials", 0) + 1
    torch.testing.assert_close(got, tfg.channel_partials_plain(x), rtol=1e-3, atol=1e-3)


# the launch shapes the two-pass mode (pad_context=False) adds at 512px: its
# UNet runs at batch 1, where every other path runs batch 2 or more
TWOPASS_B1 = [("fused_self_attention", (4096, 320)), ("fused_self_attention", (1024, 640)),
              ("fused_self_attention", (256, 1280)), ("fused_geglu_mlp", (1024, 640)),
              ("fused_geglu_mlp", (256, 1280)), ("channel_partials", (4096, 320)),
              ("conv1x1_fused", (4096, 320))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", TWOPASS_B1, ids=lambda v: str(v))
def test_unet_batch1_kernels_match_plain_on_card(name, shape):
    """K2, K5, K3 and K4 (proj_in with its prologue, proj_out with its
    residual) at the UNet's batch-1 shapes, bf16: one launch each on the
    Hopper route, against the plain version within what the batch-2 card
    tests hold them to (K3's sums 1e-3; the others 6e-2, K2's attention
    term also 2^-6 of its largest |reference| + 2^-7 of |out|); the same
    bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), torch.bfloat16
    s, c = shape

    def card(*arrays):
        return [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt) for a in arrays]

    if name == "fused_self_attention":
        fn, plain = tft.fused_self_attention, tft.fused_self_attention_plain
        calls = [(card(*_qkv(_attn_args(1, s, c, 50))) + [8], {})]
    elif name == "fused_geglu_mlp":
        fn, plain = tfm.fused_geglu_mlp, tfm.fused_geglu_mlp_plain
        calls = [(card(*_mlp_args(1, s, c, 51)), {})]
    elif name == "channel_partials":
        fn, plain = tfg.channel_partials, tfg.channel_partials_plain
        calls = [(card(_rng(52).standard_normal((1, 64, 64, c))), {})]
    else:
        fn, plain = tfc.conv1x1_fused, tfc.conv1x1_fused_plain
        r = _rng(53)
        x, w, cb, res = card(r.standard_normal((1, s, c)), c ** -0.5 * r.standard_normal((c, c)),
                             0.1 * r.standard_normal(c), r.standard_normal((1, s, c)))
        ps, pb = (torch.from_numpy(v).float().to(dev) for v in (
            1.0 + 0.1 * r.standard_normal((1, c)), 0.1 * r.standard_normal((1, c))))
        calls = [((x, w, cb, ps, pb), {}), ((x, w, cb), {"residual": res})]
    for args, kw in calls:
        before, routes = fn.launches, _routes(fn).get("sm90", 0)
        got, want = fn(*args, **kw), plain(*args, **kw)
        assert fn.launches == before + 1
        if name != "fused_geglu_mlp":  # K5 has one route, and its keys name none
            assert _routes(fn).get("sm90", 0) == routes + 1
        tol = 1e-3 if name == "channel_partials" else 6e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if name == "fused_self_attention":
            x = args[0].float()
            err = (got.float() - want.float()).abs()
            assert (err <= 2 ** -6 * (want.float() - x).abs().max()
                    + 2 ** -7 * want.float().abs()).all()
        assert torch.equal(fn(*args, **kw), got)
