"""The port's command lines (python -m sdtpu_torch.sample / .convert) on the
CPU at sd-tiny, and its profiling phases against sdtpu's.

- sample's usage errors are sdtpu's (tests/test_cli.py's cases), and so is
  convert's usage line.
- `sample` of a v-prediction model's native file comes within 1 gray level
  of sdtpu's sample on the same file.
- `sample ... cpu --seed 0` from a native file, a dump tree, a Burn mpk and
  a CompVis ckpt of the same weights writes the same PNG bytes, those of
  the port's generate with torch.Generator("cpu").manual_seed(0).
- convert's five directions give back every leaf bit-equal.
- serve.main loads each format, with the file's weights.
- The device argument: tpu and mps exit 1; cuda (the default) exits 1
  without a card and writes no image. On the card (`cuda` marker) the
  default runs there, from each format, and writes the PNG bytes of the
  port's generate on the card with the same seed.
- Running both entry points as `python -m` brings in no jax, no sdtpu and
  no msgpack.
- profiling.phase and PhaseRegistry.report give sdtpu's keys and JSON
  shape; trace() writes a Chrome trace.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sdtpu.cli import sample_main as j_sample_main
from sdtpu.utils import profiling as jprofiling
from sdtpu_torch import cli
from sdtpu_torch.config import SD_TINY
from sdtpu_torch.io.mpk import load_mpk
from sdtpu_torch.io.native import load_native, save_native
from sdtpu_torch.io.npy_tree import load_stable_diffusion_dump
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.tokenizer import SimpleTokenizer
from sdtpu_torch.utils import profiling
from sdtpu_torch.weights import init_params
from test_torch_io import _numpy, assert_leaves_equal, ldm_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT, STEPS = "a mossy stone", 2
SAMPLE = ["sample", "dump", "model", "7.5", "20", "p", "out"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """sd-tiny weights (seed 0) as a native file, a dump tree, an mpk and
    a ckpt, and the params they hold."""
    d = tmp_path_factory.mktemp("model")
    params = init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu")
    native = str(d / "m.safetensors")
    save_native(params, native, SD_TINY)
    cli.convert_main(["convert", "--to-dump", native, str(d / "dump")])
    cli.convert_main(["convert", "--to-mpk", native, str(d / "m")])
    torch.save({"state_dict": ldm_state_dict(_numpy(params), SD_TINY)}, str(d / "m.ckpt"))
    return {"native": native, "dump": str(d / "dump"), "burn": str(d / "m.mpk"),
            "ckpt": str(d / "m.ckpt"), "params": params, "dir": d}


# ------------------------------------------------------------------ usage

USAGE_CASES = (
    [(SAMPLE + [flag], f"{flag} requires a value")
     for flag in ("--sampler", "--seed", "--batch", "--preset", "--negative", "--init-image",
                  "--strength", "--mask", "--lora", "--concept")]
    + [(["sample", "--sampler", "plms"] + SAMPLE[1:], "--sampler must be"),
       (["sample", "--karras"] + SAMPLE[1:], "--karras needs --sampler"),
       (["sample", "--concept", "c.safetensors", "--init-image", "missing.png"] + SAMPLE[1:],
        "--concept is not supported with --init-image"),
       (["sample", "dump", "model"], "Usage:"),
       (["sample", "dump", "model", "abc", "20", "p", "out"],
        "Invalid unconditional guidance scale"),
       (["sample", "dump", "model", "7.5", "x", "p", "out"],
        "Invalid number of diffusion steps")])


@pytest.mark.parametrize("argv,message", USAGE_CASES,
                         ids=[f"{i}:{m[:24]}" for i, (_, m) in enumerate(USAGE_CASES)])
def test_sample_usage_errors_as_sdtpu(argv, message, capsys):
    """Each argv exits 1 with sdtpu's message, before any model load, in
    both packages."""
    for main in (j_sample_main, cli.sample_main):
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        assert e.value.code == 1
        assert message in capsys.readouterr().err


def test_convert_usage(capsys):
    with pytest.raises(SystemExit) as e:
        cli.convert_main(["convert"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    for form in ("<dump_path> <model_name>", "--ckpt <sd.ckpt>", "--mpk <model.mpk>",
                 "--to-dump <native>", "--to-mpk <native>"):
        assert form in err


@pytest.mark.parametrize("device", ["tpu", "mps"])
def test_device_argument_names_no_port_device(model, device, tmp_path, capsys):
    out = str(tmp_path / "img")
    with pytest.raises(SystemExit) as e:
        cli.sample_main(["sample", "native", model["native"], "7.5", "2", PROMPT, out, device])
    assert e.value.code == 1
    assert "unsupported device" in capsys.readouterr().err
    assert not os.path.exists(out + "0.png")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_a_card_exits(model, device, tmp_path, capsys):
    """The default device is the card: without one the CLI exits 1 with its
    message, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "img")
    argv = ["sample", "native", model["native"], "7.5", "2", PROMPT, out]
    with pytest.raises(SystemExit) as e:
        cli.sample_main(argv + ([device] if device else []))
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out + "0.png")


# ------------------------------------------------------------------ sample

@pytest.fixture(scope="module")
def generated(model):
    """The port's generate on the weights, seed 0 on the CPU, as PNG bytes."""
    from sdtpu_torch.utils.image import encode_png_rgb8

    sd = StableDiffusion(model["params"], SD_TINY)
    img = sd.generate(SimpleTokenizer(), PROMPT, 7.5, STEPS,
                      generator=torch.Generator("cpu").manual_seed(0))
    return encode_png_rgb8(img[0])


@pytest.mark.parametrize("model_type", ["native", "dump", "burn", "ckpt"])
def test_sample_each_format_as_generate(model, generated, model_type, tmp_path, capsys):
    out = str(tmp_path / model_type)
    cli.sample_main(["sample", model_type, model[model_type], "7.5", str(STEPS), PROMPT, out,
                     "cpu", "--seed", "0", "--preset", "sd-tiny"])
    assert "Saved" in capsys.readouterr().out
    with open(out + "0.png", "rb") as f:
        assert f.read() == generated


@pytest.mark.parametrize("mode", ["lora", "img2img", "inpaint"])
def test_sample_lora_and_image_inputs_as_the_pipeline(model, mode, tmp_path, capsys):
    """--lora, --init-image and --init-image with --mask (seed 0 on the
    CPU) write the images of the pipeline's own calls: generate on the
    adapter-merged weights, img2img and inpaint on the decoded PNGs."""
    from sdtpu_torch.dataset import center_crop_resize, load_image_u8
    from sdtpu_torch.lora import apply_lora, save_lora
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.utils.image import encode_png_rgb8, save_png

    g = torch.Generator().manual_seed(5)
    out, tok = str(tmp_path / "img"), SimpleTokenizer()
    argv = ["sample", "native", model["native"], "7.5", str(STEPS), PROMPT, out, "cpu",
            "--seed", "0"]
    sd = StableDiffusion(model["params"], SD_TINY)
    gen = torch.Generator("cpu").manual_seed(0)
    if mode == "lora":
        w = model["params"]["unet"]["input_blocks"]["rt1"]["transformer"]["transformer"]
        w = w["attn1"]["query"]["w"]
        lora = {"input_blocks": {"rt1": {"transformer": {"transformer": {"attn1": {"query": {
            "a": torch.randn((w.shape[0], 2), generator=g),
            "b": torch.randn((2, w.shape[1]), generator=g)}}}}}}}
        save_lora(lora, str(tmp_path / "a.safetensors"), rank=2, alpha=4.0)
        cli.sample_main(argv + ["--lora", str(tmp_path / "a.safetensors")])
        merged = {**sd.params, "unet": apply_lora(unfuse_qkv(sd.params["unet"]), lora, 2.0)}
        want = StableDiffusion(merged, SD_TINY).generate(tok, PROMPT, 7.5, STEPS, generator=gen)
        assert not torch.equal(torch.from_numpy(want), torch.from_numpy(
            sd.generate(tok, PROMPT, 7.5, STEPS, generator=torch.Generator().manual_seed(0))))
    else:
        png = str(tmp_path / "init.png")
        save_png(torch.randint(0, 256, (40, 48, 3), generator=g, dtype=torch.uint8).numpy(), png)
        x = center_crop_resize(load_image_u8(png), 32).astype("float32")[None] / 127.5 - 1.0
        if mode == "img2img":
            cli.sample_main(argv + ["--init-image", png, "--strength", "0.6"])
            want = sd.img2img(tok, PROMPT, x, 0.6, 7.5, STEPS, generator=gen)
        else:
            mask_png = str(tmp_path / "mask.png")
            m = torch.zeros((32, 32, 3), dtype=torch.uint8)
            m[8:24, 8:24] = 255
            save_png(m.numpy(), mask_png)
            cli.sample_main(argv + ["--init-image", png, "--mask", mask_png])
            mask = (center_crop_resize(load_image_u8(mask_png), 32).mean(axis=-1)
                    > 127.5).astype("float32")[None]
            want = sd.inpaint(tok, PROMPT, x, mask, 7.5, STEPS, generator=gen)
    assert "Saved" in capsys.readouterr().out
    with open(out + "0.png", "rb") as f:
        assert f.read() == encode_png_rgb8(want[0])


@pytest.mark.parametrize("sampler", [["--sampler", "dpmpp", "--karras"], []],
                         ids=["dpmpp-karras", "ddim"])
def test_sample_v_model_as_sdtpus_sample(sampler, tmp_path, capsys, monkeypatch):
    """`sample native <file> 7.5 4 <prompt> <out> cpu --seed 0` of a
    v-prediction model (SD_TINY with prediction_type "v", SD v2.1-768's
    objective; the native file carries the configuration) within 1 gray
    level of sdtpu's sample on the same file, the port given sdtpu's
    PRNGKey(0) latent (its own seed draws from a torch.Generator)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from sdtpu.utils.image import decode_png_rgb8

    cfg = dataclasses.replace(SD_TINY, prediction_type="v", name="sd-tiny-v")
    native = str(tmp_path / "v.safetensors")
    save_native(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), native, cfg)
    shape = (1, cfg.latent_size, cfg.latent_size, 4)
    latent = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))

    def draw_from(self, generator):
        def draw(s):
            assert tuple(s) == shape
            return torch.from_numpy(latent)
        return draw

    monkeypatch.setattr(StableDiffusion, "_draw_from", draw_from)
    images = {}
    for label, main in (("port", cli.sample_main), ("sdtpu", j_sample_main)):
        out = str(tmp_path / label)
        main(["sample", "native", native, "7.5", "4", PROMPT, out, "cpu", "--seed", "0",
              *sampler])
        with open(out + "0.png", "rb") as f:
            images[label] = decode_png_rgb8(f.read()).astype(int)
    assert "Saved" in capsys.readouterr().out
    assert images["port"].shape == (32, 32, 3)
    assert np.abs(images["port"] - images["sdtpu"]).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["native", "dump", "burn", "ckpt"])
def test_sample_on_card_each_format_as_generate(model, model_type, tmp_path):
    """`python -m sdtpu_torch.sample ... --seed 0` with the device argument
    omitted runs on the card and writes the PNG bytes of the port's
    generate there with torch.Generator(card).manual_seed(0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdtpu_torch.utils.image import encode_png_rgb8
    from sdtpu_torch.weights import from_numpy_tree

    out = str(tmp_path / model_type)
    subprocess.run([sys.executable, "-m", "sdtpu_torch.sample", model_type, model[model_type],
                    "7.5", str(STEPS), PROMPT, out, "--seed", "0", "--preset", "sd-tiny"],
                   cwd=REPO, check=True, timeout=300)
    dev = torch.device("cuda", 0)
    sd = StableDiffusion(from_numpy_tree(_numpy(model["params"]), device=dev), SD_TINY)
    img = sd.generate(SimpleTokenizer(), PROMPT, 7.5, STEPS,
                      generator=torch.Generator(dev).manual_seed(0))
    with open(out + "0.png", "rb") as f:
        assert f.read() == encode_png_rgb8(img[0])


def test_sample_profile_report(model, tmp_path, capsys, monkeypatch):
    """SDTPU_PROFILE=1: one JSON line with sdtpu's report keys, the load and
    sampling phases, and the kernels' launches (none on the CPU)."""
    monkeypatch.setenv("SDTPU_PROFILE", "1")
    profiling.REGISTRY.reset()
    cli.sample_main(["sample", "native", model["native"], "7.5", str(STEPS), PROMPT,
                     str(tmp_path / "p"), "cpu", "--seed", "1", "--batch", "2"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report["phases"]) == {"load_tokenizer", "load_model", "encode_prompt",
                                     "denoise", "decode", "save_png"}
    assert report["batch"] == 2 and report["device"] == "cpu" and report["kernels"] == {}
    assert report["sampling_s"] > 0
    assert os.path.exists(str(tmp_path / "p1.png"))


# ------------------------------------------------------------------ convert

def _convert_back(model, direction, tmp):
    """Run one convert direction from the module's files and read its
    output back as a tree."""
    out = str(tmp / "out")
    if direction == "to-dump":
        cli.convert_main(["convert", "--to-dump", model["native"], out])
        return load_stable_diffusion_dump(out, SD_TINY)
    if direction == "to-mpk":
        cli.convert_main(["convert", "--to-mpk", model["native"], out])
        return load_mpk(out + ".mpk")
    argv = {"dump": [model["dump"]], "mpk": ["--mpk", model["burn"]],
            "ckpt": ["--ckpt", model["ckpt"]]}[direction]
    cli.convert_main(["convert", "--preset", "sd-tiny"] + argv + [out])
    params, cfg = load_native(out + ".safetensors", "cpu")
    assert cfg == SD_TINY
    return params


@pytest.mark.parametrize("direction", ["to-dump", "dump", "to-mpk", "mpk", "ckpt"])
def test_convert_round_trips_every_leaf(model, direction, tmp_path):
    assert_leaves_equal(_convert_back(model, direction, tmp_path), _numpy(model["params"]))


@pytest.mark.parametrize("model_type", ["native", "dump", "burn", "ckpt"])
def test_serve_main_loads_each_format(model, model_type, monkeypatch):
    """serve.main loads every model type through cli.load_model: the
    pipeline it hands make_server holds the file's weights at the preset's
    config, in the dtype --bf16 asks for."""
    from sdtpu_torch import serve
    from sdtpu_torch.models.unet import unfuse_qkv

    captured = {}

    class _Started(Exception):
        pass

    def fake_make_server(sd, tok, port, default_steps=20, loras=None, **kw):
        captured.update(sd=sd, port=port, steps=default_steps)
        raise _Started()

    monkeypatch.setattr(serve, "make_server", fake_make_server)
    monkeypatch.setattr(cli, "_select_device", lambda name: torch.device("cpu"))
    with pytest.raises(_Started):
        serve.main(["serve", model_type, model[model_type], "--preset", "sd-tiny",
                    "--port", "9", "--steps", "3"])
    sd = captured["sd"]
    assert (captured["port"], captured["steps"]) == (9, 3)
    assert sd.config == SD_TINY and sd.compute_dtype == torch.float32 and sd.pad_context
    assert_leaves_equal(_numpy({**sd.params, "unet": unfuse_qkv(sd.params["unet"])}),
                        _numpy(model["params"]))


# ------------------------------------------------------------------ imports

def test_entry_points_import_no_jax_sdtpu_or_msgpack(model, tmp_path):
    """`python -m sdtpu_torch.convert` to each format and back, then
    `python -m sdtpu_torch.sample` from the mpk, run in one process (runpy,
    as -m runs them): no jax, sdtpu or msgpack module comes in."""
    code = (
        "import runpy, sys\n"
        "def run(mod, *argv):\n"
        "    sys.argv = [mod, *argv]\n"
        "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
        f"native, t = {model['native']!r}, {str(tmp_path)!r}\n"
        "run('sdtpu_torch.convert', '--to-dump', native, t + '/d')\n"
        "run('sdtpu_torch.convert', '--preset', 'sd-tiny', t + '/d', t + '/n')\n"
        "run('sdtpu_torch.convert', '--to-mpk', native, t + '/m')\n"
        "run('sdtpu_torch.convert', '--preset', 'sd-tiny', '--mpk', t + '/m.mpk', t + '/n2')\n"
        f"run('sdtpu_torch.sample', 'burn', t + '/m.mpk', '7.5', '1', {PROMPT!r}, t + '/img',\n"
        "    'cpu', '--preset', 'sd-tiny', '--seed', '0')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sdtpu',\n"
        "                                                             'msgpack'))\n"
        "assert not bad, bad\n"
        "assert 'sdtpu_torch.io.mpk' in sys.modules and 'sdtpu_torch.cli' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    assert os.path.exists(str(tmp_path / "img0.png"))


# ------------------------------------------------------------------ profiling

def test_profiling_report_as_sdtpu():
    """The same phases through both packages' registries: the same keys,
    counts and JSON shape."""
    reports = []
    for prof in (jprofiling, profiling):
        reg = prof.PhaseRegistry()
        prof.REGISTRY.reset()
        for name in ("load_model", "denoise", "denoise"):
            with prof.phase(name):
                pass
            reg.add(name, 0.5)
        assert prof.REGISTRY.counts == {"load_model": 1, "denoise": 2}
        reports.append(json.loads(reg.report({"device": "cpu"})))
        prof.REGISTRY.reset()
    assert reports[0] == reports[1]
    assert reports[1] == {"phases": {"load_model": 0.5, "denoise": 1.0},
                          "counts": {"load_model": 1, "denoise": 2}, "total_s": 1.5,
                          "device": "cpu"}


def test_profiling_enabled_and_trace(tmp_path, monkeypatch):
    for value, on in (("0", False), ("", False), ("false", False), ("1", True)):
        monkeypatch.setenv("SDTPU_PROFILE", value)
        assert profiling.enabled() == jprofiling.enabled() == on
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
