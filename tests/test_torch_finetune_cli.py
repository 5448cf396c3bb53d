"""The port's `finetune` command line (python -m sdtpu_torch.finetune,
cli.finetune_main) against sdtpu's, on the CPU.

- With the model load and the run functions stubbed in both packages, the
  same argv forwards the same arguments (--fast as defaults that explicit
  flags override wherever they stand, --ti to run_textual_inversion) and
  gives the same usage errors and exit codes.
- --device: tpu exits 1; cuda (the default) exits 1 without a card.
- End to end at sd-tiny on the CPU: a full fine-tune with EMA and a saved
  state, a LoRA run with bf16 gradient accumulation and a textual
  inversion, each writing files that sdtpu's readers load; the
  SDTPU_PROFILE=1 report.
"""

import json
import os

import numpy as np
import pytest
import torch

from sdtpu_torch import cli
from sdtpu_torch.config import SD_TINY
from sdtpu_torch.io.native import save_native
from sdtpu_torch.utils.image import save_png
from sdtpu_torch.weights import init_params

torch.set_num_threads(1)

POSITIONAL = ["native", "m.safetensors", "data", "out"]
FORWARDED = [
    [],
    ["--fast"],
    ["--batch", "4", "--fast", "--opt", "adamw"],
    ["--fast", "--remat", "--steps", "7"],
    ["--remat-policy", "dots", "--accum", "2", "--accum-bf16", "--bf16"],
    ["--lora-rank", "4", "--lora-alpha", "8", "--ema", "0.99", "--flip", "--seed", "3",
     "--tp", "2"],
    ["--save-every", "5", "--state-dir", "S", "--resume", "--lr", "2e-5", "--preset",
     "sd-tiny", "--opt", "adafactor"],
    ["--ti", "<sks>", "--ti-vectors", "2", "--ti-init", "person", "--ti-lr", "0.01", "--bf16",
     "--batch", "2", "--remat-policy", "full", "--fast"],
    ["--ti", "<cat>", "--steps", "3"],
]


def _dtype_name(dt):
    import jax.numpy as jnp

    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return jnp.dtype(dt).name


def _capture_sdtpu(monkeypatch):
    import sdtpu.cli as jcli
    import sdtpu.finetune as jfinetune
    import sdtpu.tokenizer as jtokenizer

    calls = []

    def fake(name):
        def run(sd, tok, data, out, **kw):
            calls.append((name, data, out, kw))
            return {"final_loss": 0.0, "steps_per_sec": 0.0, "out_path": out}
        return run

    monkeypatch.setattr(jcli, "_select_device", lambda d: calls.append(("device", d)))
    monkeypatch.setattr(jcli, "load_model", lambda *a, **k: calls.append(("load", a, k)))
    monkeypatch.setattr(jtokenizer, "SimpleTokenizer", lambda: None)
    monkeypatch.setattr(jfinetune, "run_finetune", fake("run_finetune"))
    monkeypatch.setattr(jfinetune, "run_textual_inversion", fake("run_textual_inversion"))
    return calls


def _capture_port(monkeypatch):
    import sdtpu_torch.finetune as tfinetune
    import sdtpu_torch.tokenizer as ttokenizer

    calls = []

    def fake(name):
        def run(sd, tok, data, out, **kw):
            calls.append((name, data, out, kw))
            return {"final_loss": 0.0, "steps_per_sec": 0.0, "out_path": out, "losses": []}
        return run

    def select(d):
        calls.append(("device", d))
        return torch.device("cpu")

    monkeypatch.setattr(cli, "_select_device", select)
    monkeypatch.setattr(cli, "load_model", lambda *a, **k: calls.append(
        ("load", a, {n: v for n, v in k.items() if n != "device"})))
    monkeypatch.setattr(ttokenizer, "SimpleTokenizer", lambda: None)
    monkeypatch.setattr(tfinetune, "run_finetune", fake("run_finetune"))
    monkeypatch.setattr(tfinetune, "run_textual_inversion", fake("run_textual_inversion"))
    return calls


def _normalised(calls):
    out = []
    for call in calls:
        if call[0] in ("run_finetune", "run_textual_inversion"):
            name, data, out_model, kw = call
            kw = {k: _dtype_name(v) if k == "compute_dtype" else v for k, v in kw.items()}
            call = (name, data, out_model, kw)
        out.append(call)
    return out


@pytest.mark.parametrize("flags", FORWARDED, ids=lambda f: " ".join(f) or "defaults")
def test_forwards_the_arguments_of_sdtpu(flags, monkeypatch):
    from sdtpu.cli import finetune_main as jfinetune_main

    # the positional arguments between two flags, near the middle
    cut = next((i for i in range(len(flags) // 2, len(flags)) if flags[i].startswith("--")),
               len(flags))
    argv = ["finetune", *flags[:cut], *POSITIONAL, *flags[cut:]]
    want = _capture_sdtpu(monkeypatch)
    jfinetune_main(list(argv))
    got = _capture_port(monkeypatch)
    cli.finetune_main(list(argv))
    assert _normalised(got) == _normalised(want)
    assert got[-1][0] == ("run_textual_inversion" if "--ti" in flags else "run_finetune")


USAGE = [
    (["finetune", "native", "m"], "Usage:"),
    (["finetune", *POSITIONAL, "extra"], "Usage:"),
    (["finetune", "--opt", "lion", *POSITIONAL], "--opt must be"),
    (["finetune", "--remat-policy", "some", *POSITIONAL], "--remat-policy must be"),
] + [(["finetune", *POSITIONAL, flag], f"{flag} requires a value")
     for flag in ("--steps", "--batch", "--accum", "--lr", "--ema", "--remat-policy", "--opt",
                  "--save-every", "--state-dir", "--preset", "--seed", "--tp", "--device",
                  "--lora-rank", "--lora-alpha", "--ti", "--ti-vectors", "--ti-init",
                  "--ti-lr")]


@pytest.mark.parametrize("argv,message", USAGE, ids=lambda a: " ".join(a)
                         if isinstance(a, list) else None)
def test_usage_errors_as_sdtpu(argv, message, monkeypatch, capsys):
    from sdtpu.cli import finetune_main as jfinetune_main

    _capture_sdtpu(monkeypatch)
    with pytest.raises(SystemExit) as e:
        jfinetune_main(list(argv))
    want = capsys.readouterr().err
    _capture_port(monkeypatch)
    with pytest.raises(SystemExit) as e2:
        cli.finetune_main(list(argv))
    got = capsys.readouterr().err
    assert e.value.code == e2.value.code == 1
    assert message in got and got == want


@pytest.mark.parametrize("device", ["tpu", "cuda"])
def test_device_flag(device, capsys, monkeypatch):
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(cli, "load_model", lambda *a, **k: pytest.fail("loaded a model"))
    with pytest.raises(SystemExit) as e:
        cli.finetune_main(["finetune", *POSITIONAL, "--device", device])
    assert e.value.code == 1 and "Error:" in capsys.readouterr().err


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("finetune_cli")
    model = str(d / "tiny.safetensors")
    save_native(init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu"), model,
                SD_TINY)
    data = d / "data"
    data.mkdir()
    r = np.random.default_rng(0)
    for i in range(3):
        save_png(r.integers(0, 256, (40, 36, 3), np.uint8), str(data / f"img{i}.png"))
        (data / f"img{i}.txt").write_text(f"a photo of <sks> number {i}")
    return model, str(data)


def _run(tiny, out, *flags, capsys, monkeypatch):
    monkeypatch.setenv("SDTPU_PROFILE", "1")
    cli.finetune_main(["finetune", "native", tiny[0], tiny[1], out, "--device", "cpu",
                       "--preset", "sd-tiny", *flags])
    lines = capsys.readouterr().out.splitlines()
    return json.loads(lines[-1]), lines


def test_full_finetune_end_to_end(tiny, tmp_path, capsys, monkeypatch):
    from sdtpu.io.native import flatten_tree as jflatten
    from sdtpu.io.native import load_native as jload_native

    report, lines = _run(tiny, str(tmp_path / "full"), "--fast", "--steps", "2", "--ema",
                         "0.9", "--save-every", "2", "--state-dir", str(tmp_path / "S"),
                         capsys=capsys, monkeypatch=monkeypatch)
    assert report["device"] == "cpu" and report["batch"] == 8 and report["kernels"] == {}
    assert {"load_tokenizer", "load_model", "latent_cache", "save_train_state",
            "save_model"} <= set(report["phases"]) and report["train_s"] > 0
    assert len(report["losses"]) == 2 and report["peak_memory_gib"] is None
    assert any(line.startswith("Done: final loss") for line in lines)
    params, cfg = jload_native(str(tmp_path / "full.safetensors"))
    assert cfg.name == "sd-tiny" and not any("qkv" in k for k in jflatten(params["unet"]))
    assert sorted(os.listdir(tmp_path / "S")) == ["state-00000002.safetensors",
                                                  "train_state.json"]


def test_lora_finetune_end_to_end(tiny, tmp_path, capsys, monkeypatch):
    from sdtpu.io.native import flatten_tree as jflatten
    from sdtpu.io.native import load_native as jload_native
    from sdtpu.lora import load_lora as jload_lora

    report, _ = _run(tiny, str(tmp_path / "lo"), "--bf16", "--lora-rank", "4", "--accum", "2",
                     "--accum-bf16", "--batch", "4", "--steps", "2", capsys=capsys,
                     monkeypatch=monkeypatch)
    assert len(report["losses"]) == 2 and all(np.isfinite(v) for _, v in report["losses"])
    lora, scale, meta = jload_lora(str(tmp_path / "lo.lora.safetensors"))
    assert scale == 1.0 and meta["rank"] == "4"
    merged, _ = jload_native(str(tmp_path / "lo.safetensors"))
    base, _ = jload_native(tiny[0])
    m, b, ad = jflatten(merged["unet"]), jflatten(base["unet"]), jflatten(lora)
    adapted = {k[:-2] + "/w" for k in ad if k.endswith("/a")}
    for k, v in m.items():
        if k in adapted:
            a, bb = ad[k[:-2] + "/a"], ad[k[:-2] + "/b"]
            np.testing.assert_allclose(v, b[k] + a @ bb * scale, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(v, b[k])


def test_textual_inversion_end_to_end(tiny, tmp_path, capsys, monkeypatch):
    from sdtpu.io.native import load_native as jload_native
    from sdtpu.textual_inversion import load_ti as jload_ti
    from sdtpu_torch.tokenizer import SimpleTokenizer

    report, _ = _run(tiny, str(tmp_path / "ti"), "--bf16", "--ti", "<sks>", "--ti-init",
                     "person", "--ti-vectors", "2", "--batch", "4", "--steps", "3",
                     capsys=capsys, monkeypatch=monkeypatch)
    assert [i for i, _ in report["losses"]] == [0, 2]
    emb, placeholder, meta = jload_ti(str(tmp_path / "ti.ti.safetensors"))
    assert placeholder == "<sks>" and emb.shape == (2, 32) and meta["config"] == "sd-tiny"
    params, _ = jload_native(tiny[0])
    (init_id,) = SimpleTokenizer().encode("person")
    row = params["clip"]["token_embedding"]["w"][init_id]
    assert all(not np.array_equal(r, row) for r in emb)  # both rows moved off the init token's
