"""Textual inversion at inference, the port against sdtpu on the CPU.

On the committed golden checkpoint (tests/test_golden.py), with the same
new embedding rows drawn by numpy from a seed: the spliced prompt ids,
ti_context and generate_with_ti (sdtpu's latent injected), each with the
padded contexts and in the two-pass mode; a TI file written by either
package read by the other; and `sample --concept` equal to
generate_with_ti.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import textual_inversion as jti
from sdtpu.pipeline import StableDiffusion as JStableDiffusion
from sdtpu.tokenizer import SimpleTokenizer
from sdtpu_torch import textual_inversion as tti
from sdtpu_torch.config import config_from_dict
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.weights import from_numpy_tree
from test_golden import GOLDEN_CONFIG, load_fixture

torch.set_num_threads(1)

PROMPT = "a photo of <sks> on a mossy stone"


def _port_config():
    import dataclasses

    return config_from_dict(dataclasses.asdict(GOLDEN_CONFIG))


@pytest.fixture(scope="module")
def models():
    params, _ = load_fixture()
    params["n_steps"] = 1000
    tparams = from_numpy_tree(params, device="cpu")
    emb = np.random.default_rng(0).standard_normal((2, 32)).astype(np.float32) * 0.02
    return params, tparams, emb, SimpleTokenizer()


def _pair(models, pad_context):
    params, tparams, _, _ = models
    return (StableDiffusion(tparams, _port_config(), pad_context=pad_context),
            JStableDiffusion(params, GOLDEN_CONFIG, pad_context=pad_context))


@pytest.mark.parametrize("prompt", [PROMPT, "<sks>", "<sks> and <sks>", "no placeholder"])
def test_splice_prompt_ids_as_sdtpu(models, prompt):
    tok = models[3]
    for n_vectors in (1, 3):
        assert (tti.splice_prompt_ids(tok, prompt, "<sks>", 49408, n_vectors)
                == jti.splice_prompt_ids(tok, prompt, "<sks>", 49408, n_vectors))


@pytest.mark.parametrize("pad_context", [True, False], ids=["padded", "twopass"])
def test_ti_context_as_sdtpu(models, pad_context):
    """The context over the extended table: the same mask and length (77
    padded, the prompt's own in two-pass mode) and values within f32 sums
    in another order."""
    sd, jsd = _pair(models, pad_context)
    emb, tok = models[2], models[3]
    ctx, valid = tti.ti_context(sd, tok, PROMPT, torch.from_numpy(emb))
    jctx, jvalid = jti.ti_context(jsd, tok, PROMPT, jnp.asarray(emb))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert ctx.shape == jctx.shape and ctx.shape[1] == (77 if pad_context else 12)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_context", [True, False], ids=["padded", "twopass"])
def test_generate_with_ti_as_sdtpu(models, pad_context):
    """4 DDIM steps at CFG 7.5, f32: sdtpu's latent (its key's draw)
    injected; within 1 gray level (the goldens' tolerance)."""
    sd, jsd = _pair(models, pad_context)
    emb, tok = models[2], models[3]
    key = jax.random.PRNGKey(7)
    want = jti.generate_with_ti(jsd, tok, PROMPT, jnp.asarray(emb), 7.5, 4, key=key,
                                negative_prompt="blurry")
    hw = GOLDEN_CONFIG.latent_size
    lat = np.array(jax.random.normal(key, (1, hw, hw, 4), jnp.float32))
    got = tti.generate_with_ti(sd, tok, PROMPT, emb, 7.5, 4, initial_latent=lat,
                               negative_prompt="blurry")
    assert got.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


@pytest.mark.parametrize("writer", ["port", "sdtpu"])
def test_ti_files_between_packages(models, writer, tmp_path):
    emb = models[2]
    path = str(tmp_path / "c.ti.safetensors")
    (tti.save_ti if writer == "port" else jti.save_ti)(emb, path, "<cat-toy>", "golden-tiny")
    got, placeholder, meta = tti.load_ti(path)
    want, jplaceholder, jmeta = jti.load_ti(path)
    np.testing.assert_array_equal(got.numpy(), emb)
    np.testing.assert_array_equal(np.asarray(want), emb)
    assert placeholder == jplaceholder == "<cat-toy>"
    assert meta["format"] == jmeta["format"] == "sdtpu-ti"
    assert meta["config"] == jmeta["config"] == "golden-tiny"


def test_load_ti_refuses_other_files(models, tmp_path):
    from sdtpu_torch.lora import save_lora

    path = str(tmp_path / "a.lora.safetensors")
    save_lora({"x": {"a": torch.zeros(2, 1), "b": torch.zeros(1, 2)}}, path, 1, 1.0)
    with pytest.raises(ValueError, match="not an sdtpu textual-inversion file"):
        tti.load_ti(path)


def test_sample_concept_as_generate_with_ti(models, tmp_path, capsys):
    """`sample --concept` (seed 0 on the CPU) writes generate_with_ti's
    image with the same generator."""
    from sdtpu_torch.cli import sample_main
    from sdtpu_torch.io.native import save_native
    from sdtpu_torch.utils.image import encode_png_rgb8

    sd, _ = _pair(models, True)
    emb, tok = models[2], models[3]
    native, concept = str(tmp_path / "m.safetensors"), str(tmp_path / "c.safetensors")
    save_native(models[1], native, sd.config)
    tti.save_ti(emb, concept, "<sks>")
    sample_main(["sample", "native", native, "7.5", "3", PROMPT, str(tmp_path / "img"), "cpu",
                 "--seed", "0", "--concept", concept])
    assert "Warning" not in capsys.readouterr().out
    want = tti.generate_with_ti(sd, tok, PROMPT, emb, 7.5, 3,
                                generator=torch.Generator("cpu").manual_seed(0))
    with open(tmp_path / "img0.png", "rb") as f:
        assert f.read() == encode_png_rgb8(want[0])
