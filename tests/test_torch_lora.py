"""LoRA at inference: the port's apply_lora, load_lora and save_lora against
sdtpu/lora.py, on the CPU, at the tiny config of tests/test_pipeline.py.

- apply_lora equals sdtpu's on the same numpy adapter (f32, 1e-6), passes
  every other leaf through by reference and casts to the weight's dtype.
- A file written by sdtpu's save_lora loads through the port's load_lora,
  and the other way round: the same tree, scale and metadata.
"""

import jax
import numpy as np
import pytest
import torch

from sdtpu import lora as jlora
from sdtpu.diffusion import scaled_linear_alphas_cumprod
from sdtpu.models import clip as jclip
from sdtpu.models import rng
from sdtpu.models import unet as junet
from sdtpu.models import vae as jvae
from sdtpu_torch import lora as tlora
from sdtpu_torch.io.native import flatten_tree, save_native
from sdtpu_torch.weights import from_numpy_tree
from test_pipeline import TINY

torch.set_num_threads(1)


def host_params(seed=0):
    """The TINY pipeline's weights from sdtpu's numpy initialiser."""
    params = {"clip": jclip.init_clip(rng.HostKey(seed), TINY.clip),
              "unet": junet.init_unet(rng.HostKey(seed + 1), TINY.unet),
              "autoencoder": jvae.init_autoencoder(rng.HostKey(seed + 2), TINY.vae)}
    params = jax.tree_util.tree_map(np.asarray, params)
    return {**params, "alphas_cumprod": np.asarray(scaled_linear_alphas_cumprod(1000)),
            "n_steps": 1000}


def nonzero_lora(unet, seed=0, rank=2):
    """An adapter of sdtpu's layout (init_lora's: every 2-D linear named in
    DEFAULT_TARGETS) whose b != 0, so that it changes the UNet, in numpy."""
    r = np.random.default_rng(seed)

    def rec(node, name):
        if not isinstance(node, dict):
            return None
        w = node.get("w")
        if name in jlora.DEFAULT_TARGETS and w is not None and w.ndim == 2:
            return {"a": (0.05 * r.standard_normal((w.shape[0], rank))).astype(np.float32),
                    "b": (0.05 * r.standard_normal((rank, w.shape[1]))).astype(np.float32)}
        sub = {k: rec(v, k) for k, v in node.items()}
        return {k: v for k, v in sub.items() if v is not None} or None

    return rec(unet, "")


@pytest.fixture(scope="module")
def base():
    params = host_params()
    return params, nonzero_lora(params["unet"])


def _flat_np(tree):
    return {k: np.asarray(v.float() if torch.is_tensor(v) else v)
            for k, v in flatten_tree(tree).items()}


def test_apply_equals_sdtpus(base):
    params, lora = base
    want = _flat_np(jax.tree_util.tree_map(np.asarray,
                                           jlora.apply_lora(params["unet"], lora, 2.0)))
    tunet = from_numpy_tree(params["unet"], device="cpu")
    got_tree = tlora.apply_lora(tunet, from_numpy_tree(lora, device="cpu"), 2.0)
    got = _flat_np(got_tree)
    assert got.keys() == want.keys()
    changed = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        changed += not np.array_equal(got[k], np.asarray(flatten_tree(params["unet"])[k]))
    # every adapted linear changed: attention q/k/v/out of each transformer
    assert changed == sum(1 for k in flatten_tree(lora) if k.endswith("/a"))
    # the leaves it does not adapt are the given tensors
    flat_in, flat_out = flatten_tree(tunet), flatten_tree(got_tree)
    assert flat_out["conv_out/w"] is flat_in["conv_out/w"]


def test_apply_casts_to_the_weights_dtype(base):
    params, lora = base
    tunet = from_numpy_tree(params["unet"], device="cpu", dtype=torch.bfloat16)
    out = tlora.apply_lora(tunet, lora, 1.0)
    w = flatten_tree(out)
    assert all(v.dtype == torch.bfloat16 for v in w.values() if v.is_floating_point())
    f32 = tlora.apply_lora(tunet, lora, 1.0, dtype=torch.float32)
    key = next(k for k in flatten_tree(lora) if k.endswith("/a"))[:-2] + "/w"
    assert flatten_tree(f32)[key].dtype == torch.float32


def test_sdtpu_file_loads_in_the_port(tmp_path, base):
    _, lora = base
    path = str(tmp_path / "a.lora.safetensors")
    jlora.save_lora(lora, path, rank=2, alpha=4.0, config_name=TINY.name)
    tree, scale, meta = tlora.load_lora(path)
    assert scale == 2.0 and meta["format"] == "sdtpu-lora" and meta["config"] == TINY.name
    want = _flat_np(lora)
    got = _flat_np(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_port_file_loads_in_sdtpu(tmp_path, base):
    _, lora = base
    path = str(tmp_path / "b.safetensors")
    tlora.save_lora(from_numpy_tree(lora, device="cpu"), path, rank=2, alpha=1.0,
                    config_name=TINY.name)
    tree, scale, meta = jlora.load_lora(path)
    assert scale == 0.5 and meta["rank"] == "2" and meta["alpha"] == "1.0"
    want, got = _flat_np(lora), _flat_np(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_load_refuses_other_files(tmp_path):
    path = str(tmp_path / "model.safetensors")
    save_native({"x": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="not an sdtpu LoRA file"):
        tlora.load_lora(path)
