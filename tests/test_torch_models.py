"""sdtpu_torch models against sdtpu on tiny configs: the spec tables, the
parameter tree of init_params, CLIP, the SpatialTransformer on both sides
of the kernel gates, the UNet and the VAE decoder.

sdtpu builds its weights with numpy (rng.HostKey); the same numpy tree
goes to the port through from_numpy_tree. sdtpu runs its unfused branches
on the CPU; the port runs its kernels' plain versions where its gates
fire, so the SpatialTransformer cases also hold those gated paths to
sdtpu's unfused math.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sdtpu.config import PRESETS, SD_TINY, AutoencoderConfig, CLIPConfig, UNetConfig
from sdtpu.models import clip as jclip
from sdtpu.models import rng
from sdtpu.models import unet as junet
from sdtpu.models import vae as jvae
from sdtpu_torch.models import clip as tclip
from sdtpu_torch.models import unet as tunet
from sdtpu_torch.models import vae as tvae
from sdtpu_torch.weights import from_numpy_tree, init_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # f32, many sums in another order


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("preset", ["sd-v1-4", "sd-v2-1", "sd-tiny"])
def test_spec_tables_equal_sdtpu(preset):
    cfg = PRESETS[preset].unet
    as_tuples = lambda specs: [dataclasses.astuple(s) for s in specs]  # noqa: E731
    assert as_tuples(tunet.build_input_specs(cfg)) == as_tuples(junet.build_input_specs(cfg))
    t_out, t_skip = tunet.build_output_specs(cfg)
    j_out, j_skip = junet.build_output_specs(cfg)
    assert as_tuples(t_out) == as_tuples(j_out) and t_skip == j_skip


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape) if hasattr(tree, "shape") else tree}


def test_init_params_tree_matches_sdtpu():
    """Same names and shapes as sdtpu's init; fan-in uniform bounds; unit
    norms; the alphas_cumprod table identical."""
    from sdtpu.diffusion import scaled_linear_alphas_cumprod

    got = init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu")
    want = {
        "clip": jclip.init_clip(rng.HostKey(0), SD_TINY.clip),
        "unet": junet.init_unet(rng.HostKey(1), SD_TINY.unet),
        "autoencoder": jvae.init_autoencoder(rng.HostKey(2), SD_TINY.vae),
        "alphas_cumprod": scaled_linear_alphas_cumprod(1000),
        "n_steps": 1000,
    }
    assert _shapes(got) == _shapes(want)
    w = got["unet"]["input_blocks"]["rt1"]["res"]["conv_in"]["w"]  # fan-in 16*9
    assert float(w.abs().max()) <= 144 ** -0.5 and float(w.std()) > 0.5 * 144 ** -0.5 / 3 ** 0.5
    assert torch.equal(got["unet"]["norm_out"]["g"], torch.ones(16))
    np.testing.assert_array_equal(got["alphas_cumprod"].numpy(), want["alphas_cumprod"])


@pytest.mark.parametrize("quick_gelu,skip", [(True, 0), (False, 1)])
def test_clip_matches_sdtpu(quick_gelu, skip):
    cfg = CLIPConfig(n_vocab=100, n_state=32, n_head=4, n_ctx=16, n_layer=3,
                     quick_gelu=quick_gelu, skip_last_layers=skip)
    params = _host(jclip.init_clip(rng.HostKey(3), cfg))
    tokens = np.array([[49 % 100, 5, 17, 99, 0, 0], [1, 2, 3, 4, 5, 6]])
    want = jax.jit(jclip.clip_apply, static_argnums=(2,))(params, tokens, cfg)
    got = tclip.clip_apply(from_numpy_tree(params, device="cpu"), torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


XFORMER_CFG = UNetConfig(model_channels=32, channel_mult=(1,), attention_levels=(0,),
                         n_head=2, context_dim=24, time_embed_dim=64,
                         groupnorm_groups=8)


@pytest.mark.parametrize("hw,gated", [
    (64, "K3+K4 proj, K2 attn"),   # S=4096: fused projections and attention
    (16, "K2 attn, K5 mlp"),       # S=256 < 2048: fused attention and MLP
    (8, "none"),                   # S=64: everything unfused
])
def test_spatial_transformer_matches_sdtpu(hw, gated):
    cfg, c = XFORMER_CFG, 32
    params = _host(junet._init_transformer(rng.HostKey(4), c, cfg.context_dim, np.float32))
    r = np.random.default_rng(5)
    x = r.standard_normal((2, hw, hw, c)).astype(np.float32)
    ctx = r.standard_normal((2, 11, cfg.context_dim)).astype(np.float32)
    valid = np.ones((2, 11), bool)
    valid[0, 6:] = False
    want = jax.jit(junet._transformer_apply, static_argnums=(3, 4))(params, x, ctx, cfg, 2,
                                                                     valid)
    args = (torch.from_numpy(x), torch.from_numpy(ctx), cfg, 2, torch.from_numpy(valid))
    got = tunet._transformer_apply(from_numpy_tree(params, device="cpu"), *args)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # with q/k/v concatenated once, as StableDiffusion holds the tree
    fused = tunet.fuse_qkv(from_numpy_tree(params, device="cpu"))
    assert fused["transformer"]["attn1"]["qkv"]["w"].shape == (c, 3 * c)
    np.testing.assert_allclose(_np(tunet._transformer_apply(fused, *args)), _np(got),
                               rtol=1e-6, atol=1e-6)


TINY_UNET = UNetConfig(model_channels=16, channel_mult=(1, 2), attention_levels=(0,),
                       n_head=4, context_dim=32, time_embed_dim=64, groupnorm_groups=4)


def test_unet_matches_sdtpu():
    params = _host(junet.init_unet(rng.HostKey(6), TINY_UNET))
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    valid = np.arange(77)[None] < np.array([[5], [12]])
    want = jax.jit(junet.unet_apply, static_argnums=(4,))(params, x, 481, ctx, TINY_UNET,
                                                          ctx_valid=valid)
    got = tunet.unet_apply(from_numpy_tree(params, device="cpu"), torch.from_numpy(x), 481,
                           torch.from_numpy(ctx), TINY_UNET, torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


TINY_VAE = AutoencoderConfig(encoder_channels=((8, 8), (8, 16)),
                             decoder_channels=((16, 16), (16, 8)), groupnorm_groups=4)


def test_vae_decode_matches_sdtpu():
    params = _host(jvae.init_autoencoder(rng.HostKey(8), TINY_VAE))
    z = np.random.default_rng(9).standard_normal((1, 6, 5, 4)).astype(np.float32)
    want = jax.jit(jvae.decode_latent, static_argnums=(2,))(params, z, TINY_VAE)
    got = tvae.decode_latent(from_numpy_tree(params, device="cpu"), torch.from_numpy(z), TINY_VAE)
    assert got.shape == (1, 12, 10, 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


WIDE_VAE = AutoencoderConfig(encoder_channels=((128, 128), (128, 128)),
                             decoder_channels=((128, 128), (128, 128)),
                             groupnorm_groups=32, groupnorm_eps=1e-6)


def test_vae_decode_fused_path_matches_sdtpu(monkeypatch):
    """The port's fused decode (K6 ResnetBlocks, the K7 upsampler, the K8
    output norm, every block's statistics threaded to the next GroupNorm),
    gates opened for an 8x8 latent, against sdtpu's unfused decode: f32,
    one-pass against two-pass GroupNorm variance (sdtpu's own bound for
    its fused decode, test_fused_conv.py:test_decode_stats_threading)."""
    from sdtpu_torch.ops import conv as tconv
    from sdtpu_torch.ops import fused_groupnorm as tfg

    params = _host(jvae.init_autoencoder(rng.HostKey(10), WIDE_VAE))
    z = 0.5 * np.random.default_rng(11).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = jax.jit(jvae.decode_latent, static_argnums=(2,))(params, z, WIDE_VAE)

    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    monkeypatch.setattr(tvae, "FUSED_CONV_MIN_ROWS", 1)
    monkeypatch.setattr(tconv, "FUSED_UP_MIN_ROWS", 1)
    for name in ("conv3x3_fused", "upsample2x_conv_fused"):
        spy(tvae, name)
    spy(tfg, "group_norm_silu")
    got = tvae.decode_latent(from_numpy_tree(params, device="cpu"), torch.from_numpy(z), WIDE_VAE)
    # 2 mid + 6 level ResnetBlocks, two convs each; one upsampler; norm_out
    assert calls == {"conv3x3_fused": 16, "upsample2x_conv_fused": 1, "group_norm_silu": 1}
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
