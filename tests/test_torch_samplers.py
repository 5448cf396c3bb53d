"""The port's samplers, img2img and inpainting against sdtpu's, on the CPU.

- The schedule tables equal sdtpu's: bit for bit where no transcendental is
  taken (the uniform sigma ladder, and every table at the goldens' 4
  steps); elsewhere within 4e-6 relative, since XLA's f32 log and pow are
  not correctly rounded and the port's are.
- Each step function equals sdtpu's on the same inputs (f32, 1e-6).
- The goldens euler_karras, dpmpp_karras, img2img_ddim and inpaint_ddim of
  tests/test_golden.py come within 1 gray level in f32, from the committed
  tiny checkpoint, with sdtpu's PRNGKey(7) draws computed with jax and
  injected (img2img's q-sample noise; inpainting's initial latent and
  per-step re-imposition noise).
- Every sampler end to end (ddim, dpmpp on both ladders, euler, euler_a
  on both, heun) equals sdtpu's sample_latent with the same key's draws;
  so does inpainting under euler_a, which draws twice a step.
- A v-prediction model (the golden weights, SD_TINY's shapes, under
  prediction_type "v": SD v2.1-768's objective) equals sdtpu's through
  every sampler in both guidance modes, and through img2img (on the
  uniform grid and the Karras ladder) and inpainting; the same model with
  its v -> epsilon conversion skipped does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.diffusion import dpm_solver as jdpm
from sdtpu.diffusion import karras as jkar
from sdtpu.diffusion import scaled_linear_alphas_cumprod
from sdtpu.pipeline import StableDiffusion as JStableDiffusion
from sdtpu.tokenizer import SimpleTokenizer
from sdtpu_torch.diffusion import dpm_solver as tdpm
from sdtpu_torch import pipeline
from sdtpu_torch.diffusion import karras as tkar
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.weights import from_numpy_tree
from test_golden import GOLDEN_CONFIG, PROMPT, _inpaint_inputs, load_fixture
from test_torch_pipeline import _golden

torch.set_num_threads(1)

AC = np.asarray(scaled_linear_alphas_cumprod(1000))
TABLES = {
    "karras_arrays": (lambda n: jkar.karras_arrays(AC, 1000, n),
                      lambda n: tkar.karras_arrays(AC, 1000, n)),
    "karras_sigma_arrays": (lambda n: jkar.karras_sigma_arrays(AC, n),
                            lambda n: tkar.karras_sigma_arrays(AC, n)),
    "dpmpp_arrays": (lambda n: jdpm.dpmpp_arrays(AC, 1000, n),
                     lambda n: tdpm.dpmpp_arrays(AC, 1000, n)),
    "dpmpp_karras_arrays": (lambda n: jdpm.dpmpp_karras_arrays(AC, n),
                            lambda n: tdpm.dpmpp_karras_arrays(AC, n)),
}


@pytest.mark.parametrize("n_steps", [4, 20, 50])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_tables_equal_sdtpus(name, n_steps):
    want, got = (f(n_steps) for f in TABLES[name])
    assert got._fields == want._fields
    exact = name == "karras_arrays" or n_steps == 4
    for field, w, g in zip(want._fields, want, got):
        w = np.asarray(w)
        assert g.dtype == w.dtype, field
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, rtol=4e-6, atol=0, err_msg=field)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_step_functions_equal_sdtpus():
    x, e1, e2, noise = (_rand(2, 4, 4, 4, seed=i) for i in range(4))
    ks = jkar.karras_sigma_arrays(AC, 6)
    for i in range(6):  # the last step lands on sigma 0
        sg, sn = ks.sigma[i], ks.sigma_next[i]
        pairs = [
            (jkar.model_input(x, sg), tkar.model_input(_t(x), _t(sg))),
            (jkar.euler_step(x, e1, sg, sn), tkar.euler_step(_t(x), _t(e1), _t(sg), _t(sn))),
            (jkar.euler_ancestral_step(x, e1, noise, sg, sn),
             tkar.euler_ancestral_step(_t(x), _t(e1), _t(noise), _t(sg), _t(sn))),
            (jkar.heun_step(x, e1, e2, sg, sn),
             tkar.heun_step(_t(x), _t(e1), _t(e2), _t(sg), _t(sn))),
            (jkar.ancestral_sigmas(sg, sn)[1], tkar.ancestral_sigmas(_t(sg), _t(sn))[1]),
            (jkar.vp_alpha(sg), tkar.vp_alpha(_t(sg))),
        ]
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    arrs = jdpm.dpmpp_karras_arrays(AC, 5)
    js, ts = jdpm.dpmpp_init(jnp.asarray(x)), tdpm.dpmpp_init(_t(x))
    for i in range(5):
        eps = _rand(2, 4, 4, 4, seed=10 + i)
        step = [a[i] for a in arrs[:6]]
        js = jdpm.dpmpp_2m_step(js, jnp.asarray(eps), step)
        ts = tdpm.dpmpp_2m_step(ts, _t(eps), [_t(a) for a in step])
        for w, g in zip(js, ts):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def weights():
    """The golden checkpoint for sdtpu (numpy) and for the port (torch),
    and the golden latent."""
    params, lat = load_fixture()
    params["n_steps"] = 1000
    return params, from_numpy_tree(params, device="cpu"), lat


@pytest.fixture(scope="module")
def fixture(weights):
    params, tparams, lat = weights
    return (StableDiffusion(tparams, GOLDEN_CONFIG), JStableDiffusion(params, GOLDEN_CONFIG),
            lat, SimpleTokenizer())


@pytest.fixture(scope="module")
def pipelines(weights):
    """(prediction type, pad_context) -> (the port's pipeline, sdtpu's) on
    the golden weights, as the epsilon model of the goldens and as a
    v-prediction model (GOLDEN_CONFIG with prediction_type "v")."""
    params, tparams, _ = weights
    out = {}
    for kind in ("epsilon", "v"):
        cfg = dataclasses.replace(GOLDEN_CONFIG, prediction_type=kind)
        for pad in (True, False):
            out[kind, pad] = (StableDiffusion(tparams, cfg, pad_context=pad),
                              JStableDiffusion(params, cfg, pad_context=pad))
    return out


def _feed(draws):
    """draw_noise that returns sdtpu's draws in order, checking each shape."""
    it = iter(draws)

    def draw(shape):
        d = np.asarray(next(it))
        assert d.shape == tuple(shape)
        return torch.tensor(d)
    return draw


def _loop_draws(key, shapes):
    """sdtpu's in-loop draws: k, ks = split(k); normal(ks, shape), per shape."""
    out = []
    for shape in shapes:
        key, ks = jax.random.split(key)
        out.append(jax.random.normal(ks, shape, jnp.float32))
    return out


def _contexts(sd, tok):
    ctx, valid = sd.context(tok, PROMPT)
    unctx, unvalid = sd.context(tok, "")
    return dict(context=ctx, unconditional_context=unctx, ctx_valid=valid,
                uncond_valid=unvalid)


def _assert_golden(img, name):
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8
    diff = np.abs(img[0].astype(int) - _golden(name))
    assert diff.max() <= 1, f"{name}: max {diff.max()} gray levels"


@pytest.mark.parametrize("name,sampler", [("euler_karras", "euler"),
                                          ("dpmpp_karras", "dpmpp")])
def test_golden_karras(fixture, name, sampler):
    sd, _, lat, tok = fixture
    latent = sd.sample_latent(unconditional_guidance_scale=7.5, n_steps=4,
                              initial_latent=torch.from_numpy(lat), sampler=sampler,
                              karras_sigmas=True, **_contexts(sd, tok))
    _assert_golden(sd.latent_to_image(latent), name)


def test_golden_img2img_ddim(fixture):
    sd, _, lat, tok = fixture
    img, _ = _inpaint_inputs()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), lat.shape, jnp.float32))
    got = sd.img2img(tok, PROMPT, img, strength=0.6, guidance_scale=7.5, n_steps=4,
                     draw_noise=_feed([noise]))
    _assert_golden(got, "img2img_ddim")


def test_img2img_euler_a_seeded(fixture):
    """A seeded img2img under euler_a draws its q-sample and every ancestral
    step from the request's generator: the same seed gives the same image,
    another seed another image."""
    sd, _, _, tok = fixture
    img, _ = _inpaint_inputs()

    def run(seed):
        return sd.img2img(tok, PROMPT, img, strength=0.6, n_steps=4, sampler="euler_a",
                          generator=torch.Generator().manual_seed(seed))
    a = run(5)
    torch.manual_seed(123)  # the global generator must not reach the result
    np.testing.assert_array_equal(run(5), a)
    assert np.abs(run(6).astype(int) - a.astype(int)).max() > 0


def test_golden_inpaint_ddim(fixture):
    sd, _, lat, tok = fixture
    img, mask = _inpaint_inputs()
    key, noise_key = jax.random.split(jax.random.PRNGKey(7))
    lat0 = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    draws = _loop_draws(noise_key, [lat.shape] * 4)
    got = sd.inpaint(tok, PROMPT, img, mask, 7.5, 4, initial_latent=torch.tensor(lat0),
                     draw_noise=_feed(draws))
    _assert_golden(got, "inpaint_ddim")


def _latents(pipes, sampler, karras, lat, tok, n_steps=3):
    """(the port's final latent, sdtpu's) of n_steps from the latent lat,
    CFG 7.5, sdtpu's PRNGKey(7) draws injected into the port (euler_a's
    per-step noise)."""
    sd, jsd = pipes
    jkw = _contexts(jsd, tok)
    want = jsd.sample_latent(jkw["context"], jkw["unconditional_context"], 7.5, n_steps,
                             key=jax.random.PRNGKey(7), initial_latent=lat,
                             ctx_valid=jkw["ctx_valid"], uncond_valid=jkw["uncond_valid"],
                             sampler=sampler, karras_sigmas=karras)
    draws = []
    if sampler == "euler_a":
        _, noise_key = jax.random.split(jax.random.PRNGKey(7))
        draws = _loop_draws(noise_key, [lat.shape] * (n_steps + 1))
    got = sd.sample_latent(unconditional_guidance_scale=7.5, n_steps=n_steps,
                           initial_latent=torch.from_numpy(lat), sampler=sampler,
                           karras_sigmas=karras, draw_noise=_feed(draws),
                           **_contexts(sd, tok))
    return got.numpy(), np.asarray(want)


SAMPLER_CASES = [("ddim", False), ("dpmpp", False), ("dpmpp", True), ("euler", False),
                 ("euler_a", False), ("euler_a", True), ("heun", False)]
# id suffix -> (prediction type, pad_context): the epsilon model with batched
# guidance, the v model batched and in the two-pass mode
MODES = {"": ("epsilon", True), "-v": ("v", True), "-v-twopass": ("v", False)}


@pytest.mark.parametrize("sampler,karras,mode", [
    pytest.param(sampler, karras, mode, id=f"{sampler}-{karras}{suffix}")
    for suffix, mode in MODES.items() for sampler, karras in SAMPLER_CASES])
def test_sampler_equals_sdtpus(pipelines, fixture, sampler, karras, mode):
    """The final latent of 3 steps (f32; the UNet's f32 sums in another order
    between the two frameworks, hence 1e-4)."""
    _, _, lat, tok = fixture
    got, want = _latents(pipelines[mode], sampler, karras, lat, tok)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sampler,karras", [("ddim", False), ("dpmpp", True), ("euler", False)])
def test_v_without_its_conversion_fails(pipelines, fixture, sampler, karras, monkeypatch):
    """The planted fault: the v model's output taken as epsilon (to_eps
    skipped) falls outside the 1e-4 that the sampler test holds."""
    _, _, lat, tok = fixture
    monkeypatch.setattr(pipeline, "to_eps", lambda model_out, x, abar, kind: model_out)
    got, want = _latents(pipelines["v", True], sampler, karras, lat, tok)
    assert not np.allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - want).max() > 1e-2


@pytest.mark.parametrize("mode,sampler,karras,pad", [
    ("img2img", "ddim", False, True), ("img2img", "dpmpp", True, True),
    ("img2img", "heun", True, True), ("img2img", "ddim", False, False),
    ("inpaint", "ddim", False, True), ("inpaint", "euler_a", True, True),
    ("inpaint", "ddim", False, False)])
def test_img2img_inpaint_v_equal_sdtpus(pipelines, fixture, mode, sampler, karras, pad):
    """img2img (strength 0.6: from the uniform grid's or the Karras
    ladder's skip position) and inpainting of the v model, 4 steps, f32, in
    both guidance modes: the final latent within sdtpu's by 1e-4, with its
    PRNGKey(7) draws injected (img2img's q-sample noise; inpainting's
    initial latent, then each step's ancestral and re-imposition noise).
    sdtpu's img2img hands its sampler no key, so its euler_a draws are
    unseeded: img2img runs the noise-free samplers here."""
    sd, jsd = pipelines["v", pad]
    _, _, lat, tok = fixture
    img, mask = _inpaint_inputs()
    key = jax.random.PRNGKey(7)
    # both pipelines hand back the final latent instead of decoding it
    sd.latent_to_image = lambda latent: latent.numpy()
    jsd.latent_to_image = np.asarray
    try:
        if mode == "img2img":
            want = jsd.img2img(tok, PROMPT, img, 0.6, 7.5, 4, key=key, sampler=sampler,
                               karras_sigmas=karras)
            noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
            got = sd.img2img(tok, PROMPT, img, 0.6, 7.5, 4, sampler=sampler,
                             karras_sigmas=karras, draw_noise=_feed([noise]))
        else:
            want = jsd.inpaint(tok, PROMPT, img, mask, 7.5, 4, key=key, sampler=sampler,
                               karras_sigmas=karras)
            key, noise_key = jax.random.split(key)
            lat0 = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
            per_step = 2 if sampler == "euler_a" else 1
            got = sd.inpaint(tok, PROMPT, img, mask, 7.5, 4, initial_latent=torch.tensor(lat0),
                             sampler=sampler, karras_sigmas=karras,
                             draw_noise=_feed(_loop_draws(noise_key, [lat.shape] * 4 * per_step)))
    finally:
        del sd.latent_to_image, jsd.latent_to_image
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_inpaint_euler_a_draw_order(fixture):
    """Inpainting under euler_a draws the ancestral noise, then the
    re-imposition's, each step: the same images as sdtpu's."""
    sd, jsd, lat, tok = fixture
    img, mask = _inpaint_inputs()
    want = jsd.inpaint(tok, PROMPT, img, mask, 7.5, 3, key=jax.random.PRNGKey(7),
                       sampler="euler_a")
    key, noise_key = jax.random.split(jax.random.PRNGKey(7))
    lat0 = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    draws = _loop_draws(noise_key, [lat.shape] * 8)  # 4 steps, 2 a step
    got = sd.inpaint(tok, PROMPT, img, mask, 7.5, 3, initial_latent=torch.tensor(lat0),
                     sampler="euler_a", draw_noise=_feed(draws))
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_per_item_guidance_and_batched_uncond(fixture):
    """A [B] guidance tensor and a [B, S, D] unconditional context (sdtpu's
    serving batches): each item equals its own batch-1 run."""
    sd, _, lat, tok = fixture
    kw = _contexts(sd, tok)
    neg, neg_valid = sd.context(tok, "blurry")
    lat2 = torch.from_numpy(np.concatenate([lat, _rand(*lat.shape[1:])[None]]))
    both = sd.sample_latent(kw["context"].repeat(2, 1, 1),
                            torch.cat([kw["unconditional_context"], neg]),
                            torch.tensor([7.5, 3.0]), 2, initial_latent=lat2,
                            ctx_valid=kw["ctx_valid"].repeat(2, 1),
                            uncond_valid=torch.cat([kw["uncond_valid"], neg_valid]),
                            sampler="dpmpp")
    for i, (un, unv, g) in enumerate(((kw["unconditional_context"], kw["uncond_valid"], 7.5),
                                      (neg, neg_valid, 3.0))):
        one = sd.sample_latent(kw["context"], un, g, 2, initial_latent=lat2[i:i + 1],
                               ctx_valid=kw["ctx_valid"], uncond_valid=unv, sampler="dpmpp")
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_refusals(fixture):
    sd, _, lat, tok = fixture
    kw = _contexts(sd, tok)
    with pytest.raises(ValueError, match="sampler"):
        sd.sample_latent(unconditional_guidance_scale=7.5, n_steps=2, sampler="plms", **kw)
    with pytest.raises(ValueError, match="karras"):
        sd.sample_latent(unconditional_guidance_scale=7.5, n_steps=2, sampler="ddim",
                         karras_sigmas=True, **kw)
    img, _ = _inpaint_inputs()
    with pytest.raises(ValueError, match="strength"):
        sd.img2img(tok, PROMPT, img, strength=0.0)
