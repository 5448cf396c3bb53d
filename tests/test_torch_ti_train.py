"""Textual-inversion training: the port's init_ti_embeddings,
make_ti_train_step, prepare_ti_data and finetune.run_textual_inversion
against sdtpu's, on the CPU, on the committed golden checkpoint
(tests/test_golden.py).

- The initial rows: an init token's row copied; random rows at the
  table's population std (jnp.std's, correction=0).
- Two train steps (plain Adam at 5e-3, f32) from the same rows, with
  sdtpu's t and noise injected, against sdtpu's jitted step: the losses
  and the rows; the gradients reach the new rows only, and the model's
  weights stay bit-unchanged.
- prepare_ti_data on a folder of PNGs: the same tokens and validity
  masks, the latents within the encoder's f32 tolerance; a caption without
  the placeholder is refused.
- run_textual_inversion draws sdtpu's batch order
  (np.random.default_rng(seed).choice) and refuses a latent cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdtpu import textual_inversion as jti
from sdtpu.pipeline import StableDiffusion as JStableDiffusion
from sdtpu.tokenizer import SimpleTokenizer as JTokenizer
from sdtpu_torch import finetune as tfinetune
from sdtpu_torch import textual_inversion as tti
from sdtpu_torch import training as ttrain
from sdtpu_torch.config import config_from_dict
from sdtpu_torch.io.native import flatten_tree
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.tokenizer import SimpleTokenizer
from sdtpu_torch.utils.image import save_png
from sdtpu_torch.weights import from_numpy_tree
from test_golden import GOLDEN_CONFIG, load_fixture

torch.set_num_threads(1)

PORT_GOLDEN = config_from_dict(dataclasses.asdict(GOLDEN_CONFIG))
# f32 on both sides: CLIP, the UNet and their backward in another summation
# order; Adam's normalised step carries the gradients' relative difference
# into the rows (measured max |diff| 7.5e-9 after two steps at lr 5e-3)
TI_STEP_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def models():
    params, _ = load_fixture()
    params["n_steps"] = 1000
    return params, from_numpy_tree(params, device="cpu")


def _write_folder(folder, captions):
    r = np.random.default_rng(0)
    for i, caption in enumerate(captions):
        save_png(r.integers(0, 256, (40, 36, 3), np.uint8), str(folder / f"img{i}.png"))
        if caption is not None:
            (folder / f"img{i}.txt").write_text(caption)
    return str(folder)


def test_init_ti_embeddings(models):
    params, tparams = models
    tok = SimpleTokenizer()
    (init_id,) = tok.encode("person")
    got = tti.init_ti_embeddings(torch.Generator(), tparams["clip"], 3, init_id)
    want = np.asarray(jti.init_ti_embeddings(jax.random.PRNGKey(0), params["clip"], 3, init_id))
    assert got.shape == (3, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    table = params["clip"]["token_embedding"]["w"]
    rows = tti.init_ti_embeddings(torch.Generator().manual_seed(5), tparams["clip"], 2)
    draws = torch.randn((2, 32), generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(rows.numpy(), (draws * float(np.std(table))).numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(np.std(table)), float(jnp.std(table)), rtol=1e-5)


def test_ti_train_steps_match_sdtpu(models):
    params, tparams = models
    jc, tc = GOLDEN_CONFIG, PORT_GOLDEN
    tok = SimpleTokenizer()
    ids = [tti.splice_prompt_ids(tok, p, "<sks>", jc.clip.n_vocab, 2)
           for p in ("a photo of <sks>", "<sks> on a mossy stone")]
    tokens = np.zeros((2, jc.clip.n_ctx), np.int32)
    for row, i in zip(tokens, ids):
        row[:len(i)] = i
    valid = np.arange(jc.clip.n_ctx)[None] < np.asarray([len(i) for i in ids])[:, None]
    r = np.random.default_rng(1)
    latents = r.standard_normal((2, jc.latent_size, jc.latent_size, 4)).astype(np.float32)
    rows = (0.02 * r.standard_normal((2, 32))).astype(np.float32)

    jopt = optax.adam(5e-3)
    jstep = jax.jit(jti.make_ti_train_step(jc, jopt))
    jrows = jnp.asarray(rows)
    jstate = jopt.init(jrows)
    topt = ttrain.AdamW(5e-3)
    trows = ttrain.master_params(torch.from_numpy(rows))
    tstate = topt.init(trows)
    tstep = tti.make_ti_train_step(tc, topt)
    before = {k: v.clone() for k, v in flatten_tree(tparams).items() if torch.is_tensor(v)}
    jbatch = (jnp.asarray(latents), jnp.asarray(tokens), jnp.asarray(valid))
    tbatch = (torch.from_numpy(latents), torch.from_numpy(tokens).long(),
              torch.from_numpy(valid))
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        kt, kn = jax.random.split(key)  # the step's own draws
        t = np.array(jax.random.randint(kt, (2,), 0, jc.n_train_steps))
        noise = np.array(jax.random.normal(kn, latents.shape, jnp.float32))
        jrows, jstate, jloss = jstep(jrows, jstate, params, jbatch, key)
        trows, tstate, tloss = tstep(trows, tstate, tparams, tbatch,
                                     t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(trows.detach().numpy(), np.asarray(jrows), **TI_STEP_TOL)
    assert not np.allclose(trows.detach().numpy(), rows, atol=1e-4)  # the rows moved
    after = flatten_tree(tparams)
    assert all(torch.equal(after[k], v) and after[k].grad is None for k, v in before.items())


@pytest.mark.parametrize("batch", [2, 4])
def test_prepare_ti_data_equals_sdtpu(models, tmp_path, batch):
    """Three images (the last without a caption: "a photo of <sks>") in
    chunks of `batch`, the last chunk padded by sdtpu and not by the port
    (its own graph key): the tokens and masks equal,
    the latents within the encoder's f32 tolerance (measured max |diff|
    1.5e-7 on latents up to 0.15)."""
    params, tparams = models
    data = _write_folder(tmp_path, ["<sks> by the sea", "a photo of <sks> at dusk", None])
    want = jti.prepare_ti_data(JStableDiffusion(params, GOLDEN_CONFIG), JTokenizer(), data,
                               n_vectors=2, batch=batch)
    got = tti.prepare_ti_data(StableDiffusion(tparams, PORT_GOLDEN), SimpleTokenizer(), data,
                              n_vectors=2, batch=batch)
    assert got[0].shape == want[0].shape == (3, 16, 16, 4) and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == np.int32 and got[2].dtype == bool
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_prepare_ti_data_refuses_a_caption_without_the_placeholder(models, tmp_path):
    _, tparams = models
    data = _write_folder(tmp_path, ["<sks> by the sea", "a plain caption"])
    with pytest.raises(ValueError, match="does not contain the placeholder"):
        tti.prepare_ti_data(StableDiffusion(tparams, PORT_GOLDEN), SimpleTokenizer(), data)


class _StubSD:
    def __init__(self, device=None):
        self.config = PORT_GOLDEN
        self.params = {"clip": None}
        self.device = device


@pytest.mark.parametrize("n", [3, 6], ids=["with_replacement", "without"])
def test_run_textual_inversion_batch_order_as_sdtpu(n, monkeypatch, tmp_path):
    """Both loops over stubbed data (example i's latents hold i) and steps
    that record their batches: the same examples at every step."""
    import sdtpu.finetune as jfinetune

    latents = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones((1, 2, 2, 4),
                                                                            np.float32)
    data = (latents, np.zeros((n, 77), np.int32), np.ones((n, 77), bool))
    seen = {"sdtpu": [], "port": []}

    def make_step(side):
        def make(*a, **k):
            def step(new_emb, opt_state, params, batch, *rest):
                seen[side].append(np.asarray(batch[0])[:, 0, 0, 0].astype(int).tolist())
                return new_emb, opt_state, 0.0
            return step
        return make

    monkeypatch.setattr(jti, "prepare_ti_data", lambda *a, **k: data)
    monkeypatch.setattr(jti, "init_ti_embeddings", lambda *a, **k: jnp.zeros((1, 32)))
    monkeypatch.setattr(jti, "make_ti_train_step", make_step("sdtpu"))
    monkeypatch.setattr(jti, "save_ti", lambda *a, **k: None)
    monkeypatch.setattr(jfinetune.jax, "jit", lambda f, **k: f)
    jfinetune.run_textual_inversion(_StubSD(), None, str(tmp_path), str(tmp_path / "c"),
                                    steps=5, batch_size=4, seed=3, log=lambda s: None)

    monkeypatch.setattr(tfinetune, "prepare_ti_data", lambda *a, **k: data)
    monkeypatch.setattr(tfinetune, "init_ti_embeddings", lambda *a, **k: torch.zeros((1, 32)))
    monkeypatch.setattr(tfinetune, "make_ti_train_step", make_step("port"))
    monkeypatch.setattr(tfinetune, "save_ti", lambda *a, **k: None)
    tfinetune.run_textual_inversion(_StubSD(torch.device("cpu")), None, str(tmp_path),
                                    str(tmp_path / "c"), steps=5, batch_size=4, seed=3,
                                    log=lambda s: None, init_token=None)
    assert len(seen["port"]) == 5 and seen["port"] == seen["sdtpu"]


def test_run_textual_inversion_refusals(models, tmp_path):
    _, tparams = models
    sd = StableDiffusion(tparams, PORT_GOLDEN)
    with pytest.raises(ValueError, match="not a latent cache"):
        tfinetune.run_textual_inversion(sd, SimpleTokenizer(), str(tmp_path / "c.npz"),
                                        str(tmp_path / "out"))
    data = _write_folder(tmp_path, ["<sks> by the sea"])
    with pytest.raises(ValueError, match="single BPE token"):
        tfinetune.run_textual_inversion(sd, SimpleTokenizer(), data, str(tmp_path / "out"),
                                        init_token="a mossy stone", steps=1)
