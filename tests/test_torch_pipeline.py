"""The sdtpu_torch slice end to end, on the CPU.

- The golden `ddim` case of tests/test_golden.py (batched CFG), built from
  the committed tiny checkpoint and injected latent, must reproduce the
  committed PNG within 1 gray level in f32 (the pin's own tolerance).
- The DDIM pieces against sdtpu's.
- The package and chip_smoke.py import no jax and nothing of sdtpu, and
  chip_smoke.py refuses to run without a CUDA device.
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


@pytest.mark.parametrize("name", ["ddim"])
def test_golden_f32(name):
    sd, lat = _sd()
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


def test_v_prediction_is_refused():
    import dataclasses

    params, _ = load_fixture()
    cfg = dataclasses.replace(GOLDEN_CONFIG, prediction_type="v")
    with pytest.raises(NotImplementedError):
        StableDiffusion(from_numpy_tree(params, device="cpu"), cfg)


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
    """No module of the port, and not chip_smoke.py, imports the JAX package
    (`import sdtpu`, `from sdtpu[...] import`), not even a module of it that
    imports no jax."""
    import ast

    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [n for n in names if n == "sdtpu" or n.startswith("sdtpu.")]
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
        "assert 'sdtpu_torch.pipeline' in sys.modules\n")
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
