"""K6's second input, the UNet's fused ResBlock and the 1024px slice of the
port, against sdtpu.

- conv3x3_fused with x2 (the implicit skip concat): the plain version
  against sdtpu's Pallas kernel in interpret mode, on the cases of
  tests/test_fused_conv.py:264-303 (prologue split per part, stats, border);
- the fused ResBlock with and without a skip, gates lowered, against
  sdtpu's fused branch (interpret mode, test_fused_conv.py:310-343) and its
  XLA branch;
- a SpatialTransformer fed the ResBlock's statistics;
- the slice end to end: a tiny pipeline with the fused ResBlock and the
  flash attention gates lowered, against sdtpu on the same weights and
  injected latent;
- on the card (marked `cuda`): K6 with x2 against its plain version.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.ops.dispatch as dispatch
import sdtpu.ops.fused_conv as jfc
import sdtpu.ops.fused_groupnorm as jfg
from sdtpu.config import UNetConfig
from sdtpu.models import rng
from sdtpu.models import unet as junet
from sdtpu_torch.models import unet as tunet
from sdtpu_torch.ops import attention as tattn
from sdtpu_torch.ops import fused_conv as tfc
from sdtpu_torch.ops import fused_groupnorm as tfg
from sdtpu_torch.weights import from_numpy_tree

torch.set_num_threads(1)

# f32, sdtpu's own bound for its fused branch against XLA (2e-4)
TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(r, shape, scale=1.0):
    return (scale * r.standard_normal(shape)).astype(np.float32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ K6 with x2

@pytest.mark.parametrize("shape,c2,cout,prologue", [
    ((2, 16, 16, 128), 64, 96, False),   # test_dual_input_conv_matches_concat
    ((1, 24, 16, 128), 128, 128, True),  # test_dual_input_gn_prologue_and_stats
])
def test_conv3x3_fused_x2_plain_matches_sdtpu(shape, c2, cout, prologue):
    r = np.random.default_rng(30)
    c1 = shape[-1]
    x, skip = _rand(r, shape), _rand(r, shape[:-1] + (c2,))
    w, cb = _rand(r, (3, 3, c1 + c2, cout), 0.1), _rand(r, (cout,))
    g, b = _rand(r, (c1 + c2,)), _rand(r, (c1 + c2,))
    if not prologue:
        want = jfc.conv3x3_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(cb), silu=False,
                                 block_h=8, interpret=True, x2=jnp.asarray(skip))
        got = tfc.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(cb),
                                silu=False, x2=torch.from_numpy(skip))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
        return
    rows = shape[1] * shape[2]
    sums = jnp.concatenate([jfg.channel_partials(jnp.asarray(x), interpret=True),
                            jfg.channel_partials(jnp.asarray(skip), interpret=True)], axis=-1)
    s, o = jfc.stats_scale_bias(sums, rows, jnp.asarray(g), jnp.asarray(b), 32, 1e-5)
    want, want_st = jfc.conv3x3_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cb), s[:, :c1], o[:, :c1],
        emit_stats=True, block_h=8, interpret=True, x2=jnp.asarray(skip),
        prologue_scale2=s[:, c1:], prologue_bias2=o[:, c1:])
    tx, tskip = torch.from_numpy(x), torch.from_numpy(skip)
    tsums = torch.cat([tfg.channel_partials(tx), tfg.channel_partials(tskip)], dim=-1)
    ts, to = tfc.stats_scale_bias(tsums, rows, torch.from_numpy(g), torch.from_numpy(b),
                                  32, 1e-5)
    got, got_st = tfc.conv3x3_fused(tx, torch.from_numpy(w), torch.from_numpy(cb),
                                    ts[:, :c1], to[:, :c1], emit_stats=True, x2=tskip,
                                    prologue_scale2=ts[:, c1:], prologue_bias2=to[:, c1:])
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    # f32 sums over 384 rows of magnitude ~10, in another order
    np.testing.assert_allclose(_np(got_st), _np(want_st), rtol=1e-4, atol=1e-2)


def test_conv3x3_fused_x2_border_skips_the_prologue():
    """silu(bias) of the zero padding must not leak into the border of
    either part: the x2 conv equals the conv of the explicit concat of the
    two prologue outputs, zero-padded after the prologue."""
    r = np.random.default_rng(31)
    x, skip = torch.from_numpy(_rand(r, (1, 8, 8, 16))), torch.from_numpy(_rand(r, (1, 8, 8, 8)))
    w, cb = torch.from_numpy(_rand(r, (3, 3, 24, 8), 0.1)), torch.zeros(8)
    s1, o1 = torch.ones(1, 16), torch.full((1, 16), 3.0)   # silu(3) != 0 at the border
    s2, o2 = torch.ones(1, 8), torch.full((1, 8), -2.0)
    got = tfc.conv3x3_fused(x, w, cb, s1, o1, x2=skip, prologue_scale2=s2, prologue_bias2=o2)
    act = torch.nn.functional.silu
    cat = torch.cat([act(x + 3.0), act(skip - 2.0)], dim=-1).permute(0, 3, 1, 2)
    want = torch.nn.functional.conv2d(cat, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_conv3x3_fused_x2_prologue_on_both_or_neither():
    x = torch.zeros(1, 8, 8, 8)
    with pytest.raises(ValueError):
        tfc.conv3x3_fused(x, torch.zeros(3, 3, 16, 8), torch.zeros(8), torch.ones(1, 8),
                          torch.zeros(1, 8), x2=x)


# ------------------------------------------------------------ the fused ResBlock

def _sdtpu_fused(monkeypatch):
    """Open sdtpu's fused ResBlock branch on the CPU, its kernels in
    interpret mode (as tests/test_fused_conv.py:test_unet_resblock_skip_fold)."""
    monkeypatch.setenv("SDTPU_FUSED_CONV_MIN_ROWS", "1")
    monkeypatch.setenv("SDTPU_FUSED_UNET_MIN_ROWS", "1")
    monkeypatch.setattr(dispatch, "use_pallas", lambda: True)
    monkeypatch.setattr(jfc, "conv3x3_fused", functools.partial(jfc.conv3x3_fused,
                                                                interpret=True))
    monkeypatch.setattr(jfc, "gn_scale_bias", functools.partial(jfc.gn_scale_bias,
                                                                interpret=True))
    monkeypatch.setattr(jfg, "channel_partials", functools.partial(jfg.channel_partials,
                                                                   interpret=True))


def _spy_conv3x3(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("x2") is not None)
        return tfc.conv3x3_fused(*a, **kw)

    monkeypatch.setattr(tunet, "conv3x3_fused", spy)
    return calls


@pytest.mark.parametrize("c1,c2,cout", [
    (32, 16, 24),   # up path: skip concat, 1x1 skip_connection as two products
    (32, 0, 32),    # down path, no skip_connection
    (32, 0, 24),    # down path with a 1x1 skip_connection
])
def test_fused_resblock_matches_sdtpu(monkeypatch, c1, c2, cout):
    cfg = UNetConfig(groupnorm_groups=8, time_embed_dim=64)
    p = _host(junet._init_res_block(jax.random.PRNGKey(5), c1 + c2, cfg.time_embed_dim,
                                    cout, jnp.float32))
    r = np.random.default_rng(32)
    x = _rand(r, (2, 8, 8, c1))
    skip = _rand(r, (2, 8, 8, c2)) if c2 else None
    emb = _rand(r, (2, cfg.time_embed_dim))
    jskip = None if skip is None else jnp.asarray(skip)
    want_xla = junet._res_block_apply(p, jnp.asarray(x), jnp.asarray(emb), cfg, skip=jskip)

    monkeypatch.setattr(tunet, "FUSED_RES_MIN_ROWS", 1)
    calls = _spy_conv3x3(monkeypatch)
    tskip = None if skip is None else torch.from_numpy(skip)
    got, st = tunet._res_block_apply(from_numpy_tree(p, device="cpu"), torch.from_numpy(x),
                                     torch.from_numpy(emb), cfg, emit_stats=True, skip=tskip)
    assert calls == [c2 > 0, False]  # conv_in (with x2 on the up path), conv_out
    np.testing.assert_allclose(_np(got), _np(want_xla), **TOL)
    # the emitted statistics are those of the output
    np.testing.assert_allclose(_np(st), _np(tfg.channel_partials_plain(got)),
                               rtol=1e-4, atol=1e-2)

    _sdtpu_fused(monkeypatch)
    want_fused, want_st = junet._res_block_apply(p, jnp.asarray(x), jnp.asarray(emb), cfg,
                                                 emit_stats=True, skip=jskip)
    np.testing.assert_allclose(_np(got), _np(want_fused), **TOL)
    np.testing.assert_allclose(_np(st), _np(want_st), rtol=1e-4, atol=1e-2)


def test_fused_resblock_gate_matches_sdtpu(monkeypatch):
    monkeypatch.setattr(dispatch, "use_pallas", lambda: True)
    for shape, c_extra in (((2, 128, 128, 320), 320), ((2, 128, 128, 640), 320),
                           ((2, 64, 64, 640), 320), ((2, 128, 128, 4), 0),
                           ((1, 256, 64, 320), 0), ((2, 128, 120, 320), 4)):
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert (tunet._use_fused_resblock(torch.empty(shape, device="meta"), c_extra)
                == junet._use_fused_resblock(x, c_extra)), (shape, c_extra)


@pytest.mark.parametrize("hw", [64, 16])   # fused GroupNorm+proj_in (K3/K4) and not
def test_spatial_transformer_takes_in_stats(hw):
    """The entry GroupNorm from the ResBlock's statistics equals the one from
    a pass over the map (sdtpu ignores in_stats off its fused path)."""
    cfg = UNetConfig(model_channels=32, channel_mult=(1,), attention_levels=(0,), n_head=2,
                     context_dim=24, time_embed_dim=64, groupnorm_groups=8)
    params = _host(junet._init_transformer(rng.HostKey(4), 32, cfg.context_dim, np.float32))
    r = np.random.default_rng(33)
    x = _rand(r, (2, hw, hw, 32)) * 2 + 0.5
    ctx = _rand(r, (2, 11, cfg.context_dim))
    want = jax.jit(junet._transformer_apply, static_argnums=(3, 4))(params, x, ctx, cfg, 2)
    tx = torch.from_numpy(x)
    in_stats = tfg.channel_partials(tx)
    got = tunet._transformer_apply(from_numpy_tree(params, device="cpu"), tx,
                                   torch.from_numpy(ctx), cfg, 2, in_stats=in_stats)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the slice

def test_tiny_pipeline_with_1024px_gates_matches_sdtpu(monkeypatch):
    """The golden tiny checkpoint at 16x16 (8x8 latents: its VAE scales by
    2) with the fused
    ResBlock gate and the flash attention gate lowered, so the fused ResBlock
    (K6 with and without x2, the embedding and skip folds) and K1's plain
    version (the VAE mid attention and the key-masked cross-attention) run;
    against sdtpu's unfused pipeline on the same weights and injected latent.
    Tolerance: 1 gray level, the golden pins' own."""
    from sdtpu.pipeline import StableDiffusion as JSD
    from sdtpu.tokenizer import SimpleTokenizer as JTok
    from sdtpu_torch.ops import flash_attention as tfa
    from sdtpu_torch.pipeline import StableDiffusion as TSD
    from sdtpu_torch.tokenizer import SimpleTokenizer as TTok
    from test_golden import GOLDEN_CONFIG, PROMPT, load_fixture

    cfg = dataclasses.replace(GOLDEN_CONFIG, image_size=16)
    params, _ = load_fixture()
    params["n_steps"] = 1000
    lat = np.random.default_rng(34).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = JSD(params, cfg).generate(JTok(use_native=False), PROMPT, 7.5, 3,
                                     initial_latent=jnp.asarray(lat))

    monkeypatch.setattr(tunet, "FUSED_RES_MIN_ROWS", 1)
    monkeypatch.setattr(tattn, "FLASH_MIN_SEQ", 1)
    calls = _spy_conv3x3(monkeypatch)
    flash = []
    monkeypatch.setattr(tattn, "flash_qkv_attention",
                        lambda *a, **kw: flash.append(kw["key_valid"] is not None)
                        or tfa.flash_qkv_attention(*a, **kw))
    sd = TSD(from_numpy_tree(params, device="cpu"), cfg)
    got = sd.generate(TTok(), PROMPT, 7.5, 3, initial_latent=torch.from_numpy(lat))
    assert got.shape == (1, 16, 16, 3) and got.dtype == np.uint8
    # per UNet call: the 2 input and 3 output ResBlocks at 8x8, two K6
    # each, the output ones' conv_in with x2
    per_call = [False] * 4 + [True, False] * 3
    assert len(calls) >= 10 and calls == per_call * (len(calls) // 10)
    assert True in flash and False in flash  # cross-attention and the VAE mid
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1, diff.max()


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c1,c2,cout", [(80, 40, 72), (64, 64, 64)])
def test_conv3x3_fused_x2_matches_plain_on_card(dtype, c1, c2, cout):
    """K6 with its second input against the plain version on the card, at
    a ragged map (9x10). Tolerances as for K6: TF32 (5e-3), bf16 (6e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    r = np.random.default_rng(35)

    def card(*arrays):
        return [torch.from_numpy(a).to(dev, dt) for a in arrays]

    x, skip, w, cb, res = card(_rand(r, (2, 9, 10, c1)), _rand(r, (2, 9, 10, c2)),
                               _rand(r, (3, 3, c1 + c2, cout), 0.1), _rand(r, (cout,)),
                               _rand(r, (2, 9, 10, cout)))
    sums = torch.cat([tfg.channel_partials(x), tfg.channel_partials(skip)], dim=-1)
    s, o = tfc.stats_scale_bias(sums, 90, torch.ones(c1 + c2, device=dev),
                                torch.zeros(c1 + c2, device=dev), 8, 1e-5)
    kw = dict(residual=res, emit_stats=True, x2=skip, prologue_scale2=s[:, c1:],
              prologue_bias2=o[:, c1:])
    before = (tfc.conv3x3_fused.launches, tfc.conv3x3_fused.launches_x2)
    got, st = tfc.conv3x3_fused(x, w, cb, s[:, :c1], o[:, :c1], **kw)
    want, _ = tfc.conv3x3_fused_plain(x, w, cb, s[:, :c1], o[:, :c1], **kw)
    assert (tfc.conv3x3_fused.launches, tfc.conv3x3_fused.launches_x2) == (before[0] + 1,
                                                                         before[1] + 1)
    yf = got.float().reshape(2, -1, cout)
    for i, v in enumerate((yf, yf * yf)):
        assert ((st[:, i] - v.sum(1)).abs() <= 2 ** -7 * v.abs().sum(1) + 1e-3).all()
    tol = 5e-3 if dtype == "float32" else 6e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
