"""The port's fine-tuning path around the training step, against sdtpu, on
the CPU: the PNG codec, the VAE encoder, the latent cache, the batch order,
the native model format in both directions, and run_finetune end to end
at SD_TINY, writing a model sdtpu reads. sdtpu's tp, which the port does
not carry yet, raises.
"""

import os

import numpy as np
import pytest
import torch

from sdtpu import config as jconfig
from sdtpu.dataset import LatentBatches as JLatentBatches
from sdtpu.dataset import build_latent_cache as jbuild_latent_cache
from sdtpu.io import native as jnative
from sdtpu.pipeline import StableDiffusion as JStableDiffusion
from sdtpu.tokenizer import SimpleTokenizer as JTokenizer
from sdtpu.utils import image as jimage
from sdtpu_torch import config as tconfig
from sdtpu_torch import dataset as tdataset
from sdtpu_torch.finetune import run_finetune
from sdtpu_torch.io import native as tnative
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.tokenizer import SimpleTokenizer
from sdtpu_torch.utils import image as timage
from sdtpu_torch.weights import from_numpy_tree
from test_golden import FIXTURE_DIR, GOLDEN_CONFIG, load_fixture

torch.set_num_threads(1)

PORT_GOLDEN = tconfig.config_from_dict(jconfig.config_to_dict(GOLDEN_CONFIG))


@pytest.fixture(scope="module")
def golden_params():
    params, _ = load_fixture()
    params["n_steps"] = 1000
    return params


def _write_dataset(folder, n=3, size=40):
    """n random PNGs of size x (size - 4), captions for all but the last."""
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 256, (size, size - 4, 3), np.uint8)
        timage.save_png(img, str(folder / f"img{i}.png"))
        if i < n - 1:
            (folder / f"img{i}.txt").write_text(f"a photo number {i}")
    return str(folder)


def test_png_codec_equals_sdtpu():
    r = np.random.default_rng(1)
    for shape in ((1, 1, 3), (7, 5, 3), (32, 40, 3)):
        img = r.integers(0, 256, shape, np.uint8)
        data = timage.encode_png_rgb8(img)
        assert data == jimage.encode_png_rgb8(img)
        np.testing.assert_array_equal(jimage.decode_png_rgb8(data), img)
        np.testing.assert_array_equal(timage.decode_png_rgb8(data), img)
    for name in sorted(os.listdir(FIXTURE_DIR)):  # sdtpu's committed goldens
        if name.endswith(".png"):
            with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
                data = f.read()
            np.testing.assert_array_equal(timage.decode_png_rgb8(data),
                                          jimage.decode_png_rgb8(data))
    with pytest.raises(ValueError):
        timage.encode_png_rgb8(np.zeros((2, 2), np.uint8))


def test_encode_image_equals_sdtpu(golden_params):
    """StableDiffusion.encode_image on the tiny golden autoencoder: f32,
    the same convolutions in another order (measured max |diff| 6.3e-7 on
    latents up to 0.76)."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JStableDiffusion(golden_params, GOLDEN_CONFIG).encode_image(x))
    sd = StableDiffusion(from_numpy_tree(golden_params, device="cpu"), PORT_GOLDEN)
    got = sd.encode_image(x)
    assert got.shape == (2, 16, 16, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_encoder_fused_branch_equals_unfused(monkeypatch):
    """SD v1.4's encoder at full width on a 16x16 image: with the fused
    ResnetBlock gate opened (K3 + K6's plain versions on the CPU, the
    one-pass GroupNorm variance) against the unfused branch."""
    from sdtpu_torch.models import vae
    from sdtpu_torch.weights import Init

    cfg = tconfig.SD_V1_4.vae
    params = vae.init_autoencoder(Init(torch.Generator().manual_seed(3), "cpu"), cfg)
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.no_grad():
        unfused = vae.encode_image(params, x, cfg)
        monkeypatch.setattr(vae, "FUSED_CONV_MIN_ROWS", 1)
        assert vae._use_fused_resnet(torch.zeros(1, 8, 8, 128), 256)  # the 16² and 8² levels
        fused = vae.encode_image(params, x, cfg)
    assert fused.shape == (1, 2, 2, 4)
    torch.testing.assert_close(fused, unfused, rtol=1e-4, atol=1e-4)


def test_build_latent_cache_equals_sdtpu(tmp_path, golden_params):
    """The same folder of 3 PNGs through sdtpu's and the port's cache
    builders: the same keys and lengths, and values in f32 (measured max
    |diff|: latents 1.2e-7, CLIP contexts 1.3e-6 on values up to 2.7); each
    package reads the other's file."""
    data_dir = _write_dataset(tmp_path)
    want = jbuild_latent_cache(JStableDiffusion(golden_params, GOLDEN_CONFIG),
                               JTokenizer(use_native=False), data_dir,
                               str(tmp_path / "jcache.npz"), batch=2)
    sd = StableDiffusion(from_numpy_tree(golden_params, device="cpu"), PORT_GOLDEN)
    got = tdataset.build_latent_cache(sd, SimpleTokenizer(), data_dir,
                                      str(tmp_path / "tcache.npz"), batch=2)
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        np.testing.assert_array_equal(g["n_valid"], w["n_valid"])
        assert g["image_size"] == w["image_size"] and g["config_name"] == w["config_name"]
        np.testing.assert_allclose(g["latents"], w["latents"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["contexts"], w["contexts"], rtol=1e-5, atol=1e-5)
    lat, ctx, nv = tdataset.load_latent_cache(want)
    assert lat.shape == (3, 16, 16, 4) and ctx.shape == (3, 77, 32) and nv.dtype == np.int32


def test_latent_batches_order_equals_sdtpu():
    """The same seed gives sdtpu's index sequence, epochs wrapping; staged
    batches carry the [B, S] key mask."""
    r = np.random.default_rng(5)
    lat = r.standard_normal((5, 4, 4, 4)).astype(np.float32)
    ctx = r.standard_normal((5, 7, 8)).astype(np.float32)
    nv = np.asarray([3, 5, 7, 2, 6], np.int32)

    def take(cls, n, **kw):
        it = cls(lat, ctx, nv, batch_size=3, seed=42, **kw)
        try:
            return [next(it) for _ in range(n)]
        finally:
            it.close()

    for got, want in zip(take(tdataset.LatentBatches, 4, device=False),
                         take(JLatentBatches, 4, device=False)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    (tl, tc, tv), = take(tdataset.LatentBatches, 1, device="cpu")
    (nl, _, nn), = take(tdataset.LatentBatches, 1, device=False)
    assert tv.shape == (3, 7) and tv.dtype == torch.bool
    np.testing.assert_array_equal(tl.numpy(), nl)
    np.testing.assert_array_equal(tv.sum(1).numpy(), nn)


def _leaves_equal(got, want):
    g, w = tnative.flatten_tree(got), jnative.flatten_tree(want)
    assert set(g) == set(w)
    for k in w:
        a = g[k]
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(w[k], a.dtype), err_msg=k)


def test_native_format_round_trips_both_ways(tmp_path, golden_params):
    """The port's writer -> sdtpu's reader, and sdtpu's writer -> the port's
    reader: every leaf equal, n_steps an int, the configuration equal."""
    tparams = from_numpy_tree(golden_params, device="cpu")
    tnative.save_native(tparams, str(tmp_path / "t.safetensors"), PORT_GOLDEN)
    got, cfg = jnative.load_native(str(tmp_path / "t.safetensors"))
    assert cfg == GOLDEN_CONFIG and got["n_steps"] == 1000
    _leaves_equal(tparams, got)

    jnative.save_native(golden_params, str(tmp_path / "j.safetensors"), GOLDEN_CONFIG)
    back, tcfg = tnative.load_native(str(tmp_path / "j.safetensors"), device="cpu")
    assert tcfg == PORT_GOLDEN and back["n_steps"] == 1000
    _leaves_equal(back, golden_params)

    # bf16 leaves keep their type through the port's own reader
    half = {"w": torch.randn(3, 5).to(torch.bfloat16), "i": torch.arange(4, dtype=torch.int32)}
    tnative.save_native(half, str(tmp_path / "h.safetensors"), tconfig.SD_TINY)
    again, _ = tnative.load_native(str(tmp_path / "h.safetensors"), device="cpu")
    assert again["w"].dtype == torch.bfloat16 and torch.equal(again["w"], half["w"])
    assert torch.equal(again["i"], half["i"])


@pytest.fixture(scope="module")
def tiny_sd():
    from sdtpu_torch.weights import init_params

    params = init_params(tconfig.SD_TINY, torch.Generator().manual_seed(0), device="cpu")
    return StableDiffusion(params, tconfig.SD_TINY)


def test_run_finetune_writes_a_model_sdtpu_reads(tmp_path, tiny_sd):
    (tmp_path / "data").mkdir()
    data_dir = _write_dataset(tmp_path / "data")
    logs = []
    r = run_finetune(tiny_sd, SimpleTokenizer(), data_dir, str(tmp_path / "tuned"), steps=2,
                     batch_size=2, lr=1e-3, log_every=1, log=logs.append)
    assert set(r) == {"steps", "final_loss", "losses", "out_path", "lora_path", "steps_per_sec",
                      "graphs"}
    assert r["lora_path"] is None and r["graphs"] is None  # the CPU runs its steps eagerly
    assert [i for i, _ in r["losses"]] == [0, 1] and np.isfinite(r["final_loss"])
    assert r["out_path"] == str(tmp_path / "tuned.safetensors")
    assert any(line.startswith("dataset: 3 examples") for line in logs)
    params, cfg = jnative.load_native(r["out_path"])
    assert cfg == jconfig.SD_TINY
    unet = jnative.flatten_tree(params["unet"])
    assert not any("qkv" in k for k in unet)
    base = tnative.flatten_tree(tiny_sd.params["unet"])
    assert set(unet) == {k for k in base if not k.endswith("attn1/qkv/w")}
    assert all(not np.array_equal(unet[k], base[k].numpy()) for k in unet)  # all trained
    clip = jnative.flatten_tree(params["clip"])
    for k, v in tnative.flatten_tree(tiny_sd.params["clip"]).items():
        np.testing.assert_array_equal(clip[k], v.numpy())
    # the cache beside the images is reused by the next run, with EMA and
    # two micro-batches a step
    cache = os.path.join(data_dir, "sdtpu_cache_sd-tiny.npz")
    mtime = os.path.getmtime(cache)
    r2 = run_finetune(tiny_sd, SimpleTokenizer(), data_dir, str(tmp_path / "ema"), steps=1,
                      batch_size=2, accum=2, ema_decay=0.5, log=lambda s: None)
    assert os.path.getmtime(cache) == mtime and np.isfinite(r2["final_loss"])


@pytest.mark.parametrize("option", [{"tp": 2}])
def test_unported_options_raise(option, tmp_path, tiny_sd):
    """tp > 1 needs a torch.distributed world (parallel/; on one, see
    tests/test_torch_parallel_train.py): outside one it raises, before any
    cache is built."""
    with pytest.raises(ValueError, match="initialised torch.distributed world"):
        run_finetune(tiny_sd, SimpleTokenizer(), str(tmp_path), str(tmp_path / "m"),
                     steps=1, batch_size=2, log=lambda s: None, **option)


@pytest.mark.parametrize("option,error", [
    ({"accum_bf16": True}, "has no effect without --accum"),
    ({"batch_size": 3, "accum": 2}, "not divisible"),
])
def test_bad_accumulation_raises_as_sdtpu(option, error, tmp_path, tiny_sd):
    """sdtpu's ValueErrors (sdtpu/finetune.py:217-224), before any cache
    is built."""
    kw = {"batch_size": 2, **option}
    with pytest.raises(ValueError, match=error):
        run_finetune(tiny_sd, SimpleTokenizer(), str(tmp_path), str(tmp_path / "m"), steps=1,
                     log=lambda s: None, **kw)
    assert os.listdir(tmp_path) == []
