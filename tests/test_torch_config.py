"""The port's own configurations and tokenizer against sdtpu's: every preset
equal field by field, and the same prompt ids."""

import dataclasses

import pytest

from sdtpu import config as jconfig
from sdtpu.tokenizer import SimpleTokenizer as JTokenizer
from sdtpu_torch import config as tconfig
from sdtpu_torch.tokenizer import SimpleTokenizer as TTokenizer
from test_golden import PROMPT


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_equals_sdtpu(name):
    got, want = tconfig.PRESETS[name], jconfig.PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.latent_size, got.vae_factor) == (want.latent_size, want.vae_factor)
    assert got.unet.heads_for(640) == want.unet.heads_for(640)
    assert got is getattr(tconfig, name.upper().replace("-", "_"))


@pytest.mark.parametrize("cls", ["CLIPConfig", "UNetConfig", "AutoencoderConfig",
                                 "StableDiffusionConfig"])
def test_dataclass_fields_and_defaults_equal_sdtpu(cls):
    got, want = getattr(tconfig, cls), getattr(jconfig, cls)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_dicts_equal_sdtpu(name):
    """config_to_dict / config_from_dict (the model file's embedded
    configuration) give sdtpu's dict and round-trip, and each side reads
    the other's."""
    d = tconfig.config_to_dict(tconfig.PRESETS[name])
    assert d == jconfig.config_to_dict(jconfig.PRESETS[name])
    assert tconfig.config_from_dict(d) == tconfig.PRESETS[name]
    assert jconfig.config_from_dict(d) == jconfig.PRESETS[name]
    with pytest.raises(TypeError):
        tconfig.config_from_dict({**d, "unknown": 1})


def test_1024px_is_the_same_object_with_another_size():
    cfg = dataclasses.replace(tconfig.SD_V1_4, image_size=1024)
    assert cfg.latent_size == 128 and cfg.unet == tconfig.SD_V1_4.unet


@pytest.fixture(scope="module")
def tokenizers():
    return TTokenizer(), JTokenizer(use_native=False)


@pytest.mark.parametrize("prompt", [
    PROMPT,                                   # the golden prompt
    "",
    "A photograph of an astronaut riding a horse, 4k, highly detailed!!",
    "Ein Café am Fluß — naïve façade, 東京の夜, ¿qué?",   # non-ASCII
    "  MiXeD   case\twhitespace\n and it's 12345 <|endoftext|> ",
])
def test_encode_prompt_equals_sdtpu(tokenizers, prompt):
    t, j = tokenizers
    ids = t.encode_prompt(prompt)
    assert ids == j.encode_prompt(prompt)
    assert ids[0] == 49406 and t.n_vocab == 49408
    assert t.decode(ids[1:-1]).strip() == j.decode(ids[1:-1]).strip()


def test_cwd_vocab_file_is_read_first(tmp_path, monkeypatch):
    """A bpe_simple_vocab_16e6.txt in the working directory takes the place
    of the bundled copy, as in sdtpu."""
    merges = ["#version: 0.2", "a b", "ab c</w>"]
    (tmp_path / "bpe_simple_vocab_16e6.txt").write_text("\n".join(merges) + "\n")
    monkeypatch.chdir(tmp_path)
    tok = TTokenizer()
    assert tok.n_vocab == 512 + 2 + 2
    assert tok.encode("abc") == [tok.encoder["abc</w>"]]
