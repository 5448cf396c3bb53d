"""The sdtpu_torch slice end to end, on the CPU.

- The golden `ddim` (batched CFG) and `ddim_twopass` (pad_context=False)
  cases of tests/test_golden.py, built from the committed tiny checkpoint
  and injected latent, must reproduce the committed PNGs within 1 gray level
  in f32 (the pins' own tolerance); the port's bf16 generate comes within
  BF16_PIN_TOL (and a mean BF16_PIN_MEAN_TOL) of sdtpu's bf16 pin
  `ddim_bf16`.
- img2img and inpainting in the two-pass mode against sdtpu's, with its
  draws injected.
- The DDIM pieces against sdtpu's.
- The package and chip_smoke.py import no jax, nothing of sdtpu and no
  msgpack, and chip_smoke.py refuses to run without a CUDA device.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdtpu.diffusion import ddim as jddim
from sdtpu.tokenizer import SimpleTokenizer
from sdtpu.utils.image import decode_png_rgb8
from sdtpu_torch.diffusion import ddim as tddim
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.weights import from_numpy_tree
from test_golden import FIXTURE_DIR, GOLDEN_CONFIG, PROMPT, load_fixture

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden(name):
    with open(os.path.join(FIXTURE_DIR, f"{name}.png"), "rb") as f:
        return decode_png_rgb8(f.read()).astype(int)


def _sd(**kw):
    params, lat = load_fixture()
    params = from_numpy_tree(params, device="cpu")
    params["n_steps"] = 1000
    return StableDiffusion(params, GOLDEN_CONFIG, **kw), torch.from_numpy(lat)


# golden -> the StableDiffusion arguments of its case in tests/test_golden.py
F32_GOLDENS = {"ddim": {}, "ddim_twopass": {"pad_context": False}}


@pytest.mark.parametrize("name", sorted(F32_GOLDENS))
def test_golden_f32(name):
    sd, lat = _sd(**F32_GOLDENS[name])
    tok = SimpleTokenizer()
    ctx, valid = sd.context(tok, PROMPT)
    unctx, unvalid = sd.context(tok, "")
    latent = sd.sample_latent(ctx, unctx, 7.5, 4, initial_latent=lat,
                              ctx_valid=valid, uncond_valid=unvalid)
    got = sd.latent_to_image(latent)
    assert got.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got[0].astype(int) - _golden(name))
    assert diff.max() <= 1, f"{name}: max {diff.max()} gray levels"


def test_generate_bf16_near_golden():
    """generate() in bf16 on the golden checkpoint. bf16 rounding moves
    this random-weight image by up to 5 gray levels from the f32 pin, for
    sdtpu's own bf16 pin and for the port alike (measured); 8 is the bound."""
    sd, lat = _sd(compute_dtype=torch.bfloat16)
    img = sd.generate(SimpleTokenizer(), PROMPT, 7.5, 4, initial_latent=lat)
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8
    assert np.abs(img[0].astype(int) - _golden("ddim")).max() <= 8
    assert set(sd.timings) == {"encode_prompt", "denoise", "decode"}
    assert sd.params["unet"]["conv_out"]["w"].dtype == torch.bfloat16
    assert sd.params["alphas_cumprod"].dtype == torch.float32


# sdtpu's own bf16 output is pinned at tol 3 against itself
# (tests/test_golden.py). The port's bf16 generate rounds at other places
# (PyTorch's CPU bf16 kernels, not XLA's): both lie within 5 gray levels of
# the f32 pin, and 7 apart at most (mean 1.04 over the 3072 values, 78
# above 3; measured). The bounds: one level over the measured maximum, as
# test_generate_bf16_near_golden keeps, and the mean; a real regression
# moves this random-weight image by tens of levels.
BF16_PIN_TOL, BF16_PIN_MEAN_TOL = 8, 1.5


def test_generate_bf16_near_sdtpus_bf16_pin():
    sd, lat = _sd(compute_dtype=torch.bfloat16)
    img = sd.generate(SimpleTokenizer(), PROMPT, 7.5, 4, initial_latent=lat)
    diff = np.abs(img[0].astype(int) - _golden("ddim_bf16"))
    assert diff.max() <= BF16_PIN_TOL, f"max {diff.max()} gray levels"
    assert diff.mean() <= BF16_PIN_MEAN_TOL, f"mean {diff.mean():.3f} gray levels"


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_twopass_img2img_inpaint_as_sdtpu(mode):
    """img2img (strength 0.6) and inpainting in the two-pass mode, f32, 4
    DDIM steps: sdtpu's PRNGKey(7) draws injected (the q-sample noise;
    inpainting's initial latent and per-step re-imposition noise); within
    1 gray level of sdtpu's images."""
    import jax
    import jax.numpy as jnp

    from sdtpu.pipeline import StableDiffusion as JStableDiffusion
    from test_golden import _inpaint_inputs
    from test_torch_samplers import _feed, _loop_draws

    params, lat = load_fixture()
    params["n_steps"] = 1000
    jsd = JStableDiffusion(params, GOLDEN_CONFIG, pad_context=False)
    sd, _ = _sd(pad_context=False)
    tok = SimpleTokenizer()
    img, mask = _inpaint_inputs()
    key = jax.random.PRNGKey(7)
    if mode == "img2img":
        want = jsd.img2img(tok, PROMPT, img, 0.6, 7.5, 4, key=key)
        noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
        got = sd.img2img(tok, PROMPT, img, 0.6, 7.5, 4, draw_noise=_feed([noise]))
    else:
        want = jsd.inpaint(tok, PROMPT, img, mask, 7.5, 4, key=key)
        key, noise_key = jax.random.split(key)
        lat0 = np.array(jax.random.normal(key, lat.shape, jnp.float32))
        got = sd.inpaint(tok, PROMPT, img, mask, 7.5, 4, initial_latent=torch.tensor(lat0),
                         draw_noise=_feed(_loop_draws(noise_key, [lat.shape] * 4)))
    assert got.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_twopass_runs_two_unet_calls_on_unpadded_contexts(monkeypatch):
    """pad_context=False: contexts of the prompts' own lengths (2 tokens for
    the empty prompt), two UNet calls a step at batch 1, uncond then cond,
    with no key mask; the padded mode's one call at batch 2 over 77 keys."""
    from sdtpu_torch import pipeline

    calls = []
    real = pipeline.unet_apply

    def spy(params, x, t, context, cfg, ctx_valid=None):
        calls.append((x.shape[0], context.shape[1], ctx_valid is None))
        return real(params, x, t, context, cfg, ctx_valid=ctx_valid)

    monkeypatch.setattr(pipeline, "unet_apply", spy)
    tok = SimpleTokenizer()
    n = len(tok.encode_prompt(PROMPT))
    for pad, want in ((False, [(1, 2, True), (1, n, True)] * 2), (True, [(2, 77, False)] * 2)):
        sd, lat = _sd(pad_context=pad)
        calls.clear()
        sd.generate(tok, PROMPT, 7.5, 2, initial_latent=lat)
        assert calls == want, (pad, calls)


def test_generate_draws_latent_from_generator():
    sd, _ = _sd()
    tok = SimpleTokenizer()
    a = sd.generate(tok, PROMPT, 7.5, 2, generator=torch.Generator().manual_seed(3))
    b = sd.generate(tok, PROMPT, 7.5, 2, generator=torch.Generator().manual_seed(3))
    c = sd.generate(tok, PROMPT, 7.5, 2, n_images=2,
                    generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    assert c.shape == (2, 32, 32, 3)
    assert np.abs(a[0].astype(int) - c[0].astype(int)).max() > 0
    assert np.abs(c[0].astype(int) - c[1].astype(int)).max() > 0


@pytest.mark.parametrize("n_steps", [4, 20, 50])
def test_ddim_schedule_and_alphas(n_steps):
    from sdtpu.diffusion import scaled_linear_alphas_cumprod
    from sdtpu_torch.diffusion import scaled_linear_alphas_cumprod as t_alphas

    a = scaled_linear_alphas_cumprod(1000)
    assert tddim.ddim_schedule(1000, n_steps) == jddim.ddim_schedule(1000, n_steps)
    ts, step = tddim.ddim_schedule(1000, n_steps)
    ja_t, ja_p = jddim.ddim_alphas(a, ts, step)
    ta_t, ta_p = tddim.ddim_alphas(t_alphas(1000), ts, step)
    np.testing.assert_array_equal(ta_t.numpy(), np.asarray(ja_t))
    np.testing.assert_array_equal(ta_p.numpy(), np.asarray(ja_p))
    assert float(ta_p[-1]) == 1.0  # the last step's prev_alpha


def test_ddim_step():
    r = np.random.default_rng(0)
    lat, eps = r.standard_normal((2, 1, 4, 4, 4)).astype(np.float32)
    at, ap = np.float32(0.3), np.float32(0.7)
    want = jddim.ddim_step(lat, eps, at, ap)
    got = tddim.ddim_step(torch.from_numpy(lat), torch.from_numpy(eps),
                          torch.tensor(at), torch.tensor(ap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "sdtpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_imports_nothing_of_sdtpu(path):
    """No module of the port (its -m entry points sample.py and convert.py
    among them), and not chip_smoke.py, imports the JAX package (`import
    sdtpu`, `from sdtpu[...] import`), not even a module of it that imports
    no jax; nor jax, nor msgpack (io/mpk.py carries its own codec)."""
    import ast

    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [n for n in names if n.split(".")[0] in ("sdtpu", "jax", "msgpack")]
    assert not bad, bad
    if path == "chip_smoke.py":
        ours = {n.split(".")[0] for n in names} - set(sys.stdlib_module_names)
        assert ours == {"torch", "sdtpu_torch"}, ours


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sdtpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(sdtpu_torch.__path__, 'sdtpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "bad = sorted(m for m in sys.modules if m == 'sdtpu' or m.startswith('sdtpu.'))\n"
        "assert not bad, bad\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'msgpack')\n"
        "assert not bad, bad\n"
        "for m in ('pipeline', 'cli', 'sample', 'convert', 'finetune', 'io.mpk',\n"
        "          'io.checkpoint', 'lora', 'textual_inversion', 'training'):\n"
        "    assert 'sdtpu_torch.' + m in sys.modules, m\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    """No CUDA device here: the script must exit nonzero and print no result.
    'alone': a directory holding chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
