"""Train-state save and resume (sdtpu_torch/io/checkpoint.py and
run_finetune's state_dir / save_every / resume), on the CPU.

- save_train_state then restore_train_state gives back every tensor
  bit-equal, the step and the optimizer's count, for AdamW and Adafactor,
  with and without the EMA, into templates a fresh run builds; a LoRA
  adapter's tree (string list indices) too.
- A save that breaks off (in the tensor file or before the JSON is
  replaced) leaves the previous state readable.
- Refusals: a missing directory (FileNotFoundError), an orbax state
  written by sdtpu's save_train_state and an empty directory (both name
  what they hold), other flags, another optimizer.
- run_finetune at SD_TINY: a resume runs steps − step0 steps from the
  saved step and raises sdtpu's RuntimeError, naming the flags, under
  other flags.
"""

import json
import os

import numpy as np
import pytest
import torch

from sdtpu_torch import training as ttrain
from sdtpu_torch.io import checkpoint
from sdtpu_torch.io.native import flatten_tree

torch.set_num_threads(1)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"blocks": [{"w": torch.randn((160, 256), generator=g)},
                       {"w": torch.randn((3, 3, 8, 16), generator=g),
                        "b": torch.randn((16,), generator=g)}],
            "out": {"w": torch.randn((256, 130), generator=g)}}


def _state(kind, seed, ema):
    """A tree, its optimizer state after two updates, the EMA."""
    params = ttrain.master_params(_tree(seed))
    opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=0, total_steps=4, kind=kind)
    state = opt.init(params)
    g = torch.Generator().manual_seed(seed + 100)
    e = ttrain.tree_map(lambda p: p.detach().clone(), params) if ema else None
    for _ in range(2):
        opt.update(params, [torch.randn(p.shape, generator=g)
                            for p in ttrain.tree_leaves(params)], state)
        if e is not None:
            ttrain.ema_update(e, params, 0.9)
    return params, opt, state, e


def _equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def _state_tensors(state):
    return [t for f in ("mu", "nu", "v_row", "v_col", "v")
            for t in getattr(state, f, []) if t is not None]


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_save_then_restore_is_bit_equal(kind, ema, tmp_path):
    params, opt, state, e = _state(kind, 0, ema)
    flags = {"opt_kind": kind, "ema": ema}
    checkpoint.save_train_state(str(tmp_path), params, state, 7, ema=e, flags=flags)
    assert sorted(os.listdir(tmp_path)) == ["state-00000007.safetensors", "train_state.json"]
    fresh, _, fresh_state, fresh_e = _state(kind, 1, ema)  # other numbers, same shapes
    fresh_state.count = 0
    step = checkpoint.restore_train_state(str(tmp_path), fresh, fresh_state, ema=fresh_e,
                                          flags=flags)
    assert step == 7 and fresh_state.count == state.count == 2
    assert _equal(fresh, params) and (not ema or _equal(fresh_e, e))
    got, want = _state_tensors(fresh_state), _state_tensors(state)
    assert len(got) == len(want) > 0 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(p.requires_grad for p in ttrain.tree_leaves(fresh))


def test_lora_adapter_state_round_trips(tmp_path):
    from sdtpu_torch.lora import init_lora

    base = {"input_blocks": [{"attn1": {"query": {"w": torch.randn(8, 8)}}},
                             {"attn2": {"out": {"w": torch.randn(8, 4)}}}]}
    lora = ttrain.master_params(init_lora(torch.Generator().manual_seed(0), base, 2))
    opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=0, total_steps=2)
    state = opt.init(lora)
    opt.update(lora, [torch.ones_like(p) for p in ttrain.tree_leaves(lora)], state)
    checkpoint.save_train_state(str(tmp_path), lora, state, 1)
    fresh = ttrain.master_params(init_lora(torch.Generator().manual_seed(1), base, 2))
    fresh_state = opt.init(fresh)
    assert checkpoint.restore_train_state(str(tmp_path), fresh, fresh_state) == 1
    assert list(fresh["input_blocks"]) == ["0", "1"] and _equal(fresh, lora)


@pytest.mark.parametrize("where", ["tensors", "json"])
def test_an_interrupted_save_leaves_the_previous_state(where, tmp_path, monkeypatch):
    params, opt, state, _ = _state("adafactor", 0, False)
    checkpoint.save_train_state(str(tmp_path), params, state, 1)
    saved = ttrain.tree_map(lambda p: p.detach().clone(), params)
    opt.update(params, [torch.ones_like(p) for p in ttrain.tree_leaves(params)], state)

    if where == "tensors":
        def broken(tensors, path, metadata):
            with open(path, "wb") as f:
                f.write(b"\0" * 100)
            raise OSError("disk full")
        monkeypatch.setattr(checkpoint, "save_safetensors", broken)
    else:
        real_replace = os.replace

        def broken(src, dst):
            if dst.endswith(checkpoint.STATE_JSON):
                raise OSError("power cut")
            real_replace(src, dst)
        monkeypatch.setattr(checkpoint.os, "replace", broken)
    with pytest.raises(OSError):
        checkpoint.save_train_state(str(tmp_path), params, state, 2)
    monkeypatch.undo()
    fresh, _, fresh_state, _ = _state("adafactor", 1, False)
    assert checkpoint.restore_train_state(str(tmp_path), fresh, fresh_state) == 1
    assert _equal(fresh, saved) and fresh_state.count == 2
    checkpoint.save_train_state(str(tmp_path), params, state, 2)  # the next save tidies up
    assert sorted(os.listdir(tmp_path)) == ["state-00000002.safetensors", "train_state.json"]


def test_refusals(tmp_path):
    params, _, state, _ = _state("adamw", 0, False)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "none"), params, state)
    with pytest.raises(ValueError, match="holds no train_state.json"):
        checkpoint.restore_train_state(str(tmp_path), params, state)
    checkpoint.save_train_state(str(tmp_path / "s"), params, state, 3,
                                flags={"opt_kind": "adamw", "accum": 2})
    with pytest.raises(ValueError, match=r"accum=2 \(now 1\)"):
        checkpoint.restore_train_state(str(tmp_path / "s"), params, state,
                                       flags={"opt_kind": "adamw", "accum": 1})
    other, _, other_state, e = _state("adafactor", 0, True)
    with pytest.raises(ValueError, match="AdamWState"):
        checkpoint.restore_train_state(str(tmp_path / "s"), other, other_state)
    with pytest.raises(ValueError, match="EMA"):
        checkpoint.restore_train_state(str(tmp_path / "s"), params, state, ema=e)
    meta = json.load(open(tmp_path / "s" / "train_state.json"))
    assert meta["step"] == 3 and meta["format"] == checkpoint.FORMAT


def test_an_orbax_state_is_refused(tmp_path):
    """sdtpu's save_train_state writes orbax; the port names the format."""
    import jax.numpy as jnp
    import optax

    from sdtpu.io.checkpoint import save_train_state as jsave

    tree = {"w": jnp.ones((4, 4))}
    jsave(str(tmp_path / "orbax"), tree, optax.adam(1e-3).init(tree), 5)
    params, _, state, _ = _state("adamw", 0, False)
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore_train_state(str(tmp_path / "orbax"), params, state)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from sdtpu_torch.config import SD_TINY
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils.image import save_png
    from sdtpu_torch.weights import init_params

    data = tmp_path_factory.mktemp("data")
    r = np.random.default_rng(0)
    for i in range(3):
        save_png(r.integers(0, 256, (32, 32, 3), np.uint8), str(data / f"img{i}.png"))
    sd = StableDiffusion(init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu"),
                         SD_TINY)
    return sd, SimpleTokenizer(), str(data)


def test_run_finetune_resumes_at_the_saved_step(tiny, tmp_path):
    from sdtpu_torch.finetune import run_finetune

    sd, tok, data = tiny
    kw = dict(batch_size=2, lr=1e-3, opt_kind="adafactor", ema_decay=0.5, log_every=1,
              state_dir=str(tmp_path / "S"), save_every=2)
    logs = []
    r = run_finetune(sd, tok, data, str(tmp_path / "a"), steps=2, log=logs.append, **kw)
    assert "train state saved at step 2 -> " + str(tmp_path / "S") in logs
    logs.clear()
    r2 = run_finetune(sd, tok, data, str(tmp_path / "b"), steps=3, resume=True,
                      log=logs.append, **kw)
    assert f"resumed step 2 from {tmp_path / 'S'}" in logs
    assert [i for i, _ in r2["losses"]] == [2] and [i for i, _ in r["losses"]] == [0, 1]
    assert sum(line.startswith("step ") for line in logs) == 1
    assert r2["steps"] == 3 and r2["lora_path"] is None and np.isfinite(r2["final_loss"])

    with pytest.raises(RuntimeError, match=r"flags \(accum=1, accum_bf16=False, opt=adamw"):
        run_finetune(sd, tok, data, str(tmp_path / "c"), steps=3, resume=True,
                     log=lambda s: None, **{**kw, "opt_kind": "adamw"})
    with pytest.raises(FileNotFoundError, match="no train state"):
        run_finetune(sd, tok, data, str(tmp_path / "c"), steps=3, resume=True,
                     log=lambda s: None, **{**kw, "state_dir": str(tmp_path / "none")})
