"""The port's weight formats against sdtpu's, on the CPU at sd-tiny.

- The npy dump tree: a tree written by either package reads back in the
  other with every leaf bit-equal.
- Burn NamedMpk: the port's save_mpk writes sdtpu's bytes for the same
  params (both payload modes), its load_mpk reads sdtpu's files and the
  committed fixture tests/fixtures/tiny.mpk leaf-equal to sdtpu's reader,
  and it refuses an unknown record as sdtpu's does.
- The port's own msgpack codec (the card's machine does not promise the
  msgpack package) against the msgpack package: the same bytes for a
  randomized record and the same object back, and strict on what it does
  not take.
- The CompVis ckpt mapping: convert_state_dict and load_torch_ckpt give
  sdtpu's tree for a CLIP v1 and an OpenCLIP v2 state dict built here from
  the tiny params.
"""

import argparse
import os

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sdtpu.config import SD_TINY as J_SD_TINY
from sdtpu.io import ckpt as jckpt
from sdtpu.io import mpk as jmpk
from sdtpu.io import npy_tree as jnpy
from sdtpu_torch.config import SD_TINY
from sdtpu_torch.io import ckpt as tckpt
from sdtpu_torch.io import mpk as tmpk
from sdtpu_torch.io import npy_tree as tnpy
from sdtpu_torch.io.native import flatten_tree
from sdtpu_torch.models.unet import build_input_specs, build_output_specs
from sdtpu_torch.weights import from_numpy_tree, init_params

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.mpk")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy() if torch.is_tensor(tree) else tree


@pytest.fixture(scope="module")
def params():
    """sd-tiny params (sdtpu's tree; the port's initialiser, seed 0, which
    is quicker than jax's on the CPU) as a tree of numpy arrays."""
    return _numpy(init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu"))


def assert_leaves_equal(got, want):
    """The same keys, and every leaf bit-equal (as f32 numpy)."""
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert set(fg) == set(fw), set(fg) ^ set(fw)
    for k, w in fw.items():
        g = fg[k]
        if isinstance(w, (int, float)):
            assert g == w, k
            continue
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=k)


# ------------------------------------------------------------------ dump tree

@pytest.mark.parametrize("writer", ["port", "sdtpu"])
def test_dump_tree_between_packages(params, writer, tmp_path):
    """A dump tree written by one package, read by the other (and by the
    writer's own reader): every leaf bit-equal to the params. The port
    writes from torch tensors, as its pipeline holds them."""
    path = str(tmp_path / "dump")
    if writer == "port":
        tnpy.save_stable_diffusion_dump(from_numpy_tree(params, device="cpu"), path, SD_TINY)
    else:
        jnpy.save_stable_diffusion_dump(params, path, J_SD_TINY)
    port = tnpy.load_stable_diffusion_dump(path, SD_TINY)
    assert_leaves_equal(port, params)
    assert_leaves_equal(port, jnpy.load_stable_diffusion_dump(path, J_SD_TINY))


# ------------------------------------------------------------------ mpk

@pytest.mark.parametrize("mode", ["bytes", "value"])
def test_save_mpk_writes_sdtpus_bytes(params, mode, tmp_path):
    """The port's writer (from torch tensors) writes the bytes sdtpu's
    writer writes; each reader reads the file to the params."""
    ours, theirs = str(tmp_path / "port.mpk"), str(tmp_path / "sdtpu.mpk")
    tmpk.save_mpk(from_numpy_tree(params, device="cpu"), ours, mode=mode)
    jmpk.save_mpk(params, theirs, mode=mode)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got = tmpk.load_mpk(theirs)
    assert_leaves_equal(got, params)
    assert_leaves_equal(got, jmpk.load_mpk(theirs))


def test_load_mpk_fixture_as_sdtpu():
    assert_leaves_equal(tmpk.load_mpk(FIXTURE), jmpk.load_mpk(FIXTURE))


def test_mpk_strict_rejects_unknown_records(tmp_path):
    record = {"item": {"diffusion": {"mystery_module": {"something": "weird"}}}}
    path = str(tmp_path / "bad.mpk")
    with open(path, "wb") as f:
        f.write(msgpack.packb(record, use_bin_type=True))
    with pytest.raises(jmpk.MpkFormatError, match="mystery_module/something"):
        jmpk.load_mpk(path)
    with pytest.raises(tmpk.MpkFormatError, match="mystery_module/something"):
        tmpk.load_mpk(path)


# the msgpack subset rmp-serde's named records use, with the edges of every
# width (fixint/8/16/32/64-bit integers, fix/8/16-bit lengths)
_INTS = st.one_of(st.integers(-2 ** 63, 2 ** 64 - 1),
                  st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                                   -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
                                   -2 ** 31 - 1, -2 ** 63]))
_LEAVES = st.one_of(st.none(), st.booleans(), _INTS,
                    st.floats(allow_nan=False, width=64), st.text(max_size=300),
                    st.binary(max_size=300),
                    st.lists(st.floats(allow_nan=False), min_size=16, max_size=40))
_RECORDS = st.recursive(
    _LEAVES,
    lambda inner: st.one_of(st.lists(inner, max_size=20),
                            st.dictionaries(st.text(max_size=20), inner, max_size=20)),
    max_leaves=40)


@settings(max_examples=40, deadline=None)
@given(_RECORDS)
def test_msgpack_codec_agrees_with_msgpack(record):
    want = msgpack.packb(record, use_bin_type=True)
    assert tmpk.packb(record) == want
    assert tmpk.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("data,match", [
    (msgpack.packb({"a": [1, 2, 3]})[:-1], "truncated"),
    (msgpack.packb({"a": 1}) + b"\x00", "extra data"),
    (msgpack.packb(msgpack.ExtType(5, b"xy")), "0xd5"),
    (b"\xc1", "0xc1"),
])
def test_msgpack_codec_is_strict(data, match):
    with pytest.raises(tmpk.MpkFormatError, match=match):
        tmpk.unpackb(data)


# ------------------------------------------------------------------ ckpt

def ldm_state_dict(params, cfg, openclip=False, linear_proj=False):
    """sdtpu's tree -> a CompVis/LDM state dict of torch tensors (linears
    [out, in], convs OIHW), the inverse of the ckpt mapping. openclip: SD
    v2's text tower, q/k/v fused into in_proj, with one extra resblock the
    converter must skip. linear_proj: each SpatialTransformer's proj_in and
    proj_out as linear [out, in] weights, as SD v2.x files store them
    (use_linear_in_transformer)."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def lin(key, p):
        sd[f"{key}.weight"] = t(p["w"].T)
        if "b" in p:
            sd[f"{key}.bias"] = t(p["b"])

    def conv(key, p):
        sd[f"{key}.weight"] = t(np.transpose(p["w"], (3, 2, 0, 1)))
        if "b" in p:
            sd[f"{key}.bias"] = t(p["b"])

    def norm(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = t(p["g"]), t(p["b"])

    clip = params["clip"]
    if openclip:
        base = "cond_stage_model.model"
        sd[f"{base}.token_embedding.weight"] = t(clip["token_embedding"]["w"])
        sd[f"{base}.positional_embedding"] = t(clip["position_embedding"])
        for i, bp in enumerate(clip["blocks"] + clip["blocks"][:1]):
            rb = f"{base}.transformer.resblocks.{i}"
            a = bp["attn"]
            sd[f"{rb}.attn.in_proj_weight"] = t(np.concatenate(
                [a[k]["w"].T for k in ("query", "key", "value")]))
            sd[f"{rb}.attn.in_proj_bias"] = t(np.concatenate(
                [a[k]["b"] for k in ("query", "key", "value")]))
            lin(f"{rb}.attn.out_proj", a["out"])
            norm(f"{rb}.ln_1", bp["attn_ln"])
            lin(f"{rb}.mlp.c_fc", bp["mlp"]["fc1"])
            lin(f"{rb}.mlp.c_proj", bp["mlp"]["fc2"])
            norm(f"{rb}.ln_2", bp["mlp_ln"])
        norm(f"{base}.ln_final", clip["layer_norm"])
    else:
        base = "cond_stage_model.transformer.text_model"
        sd[f"{base}.embeddings.token_embedding.weight"] = t(clip["token_embedding"]["w"])
        sd[f"{base}.embeddings.position_embedding.weight"] = t(clip["position_embedding"])
        for i, bp in enumerate(clip["blocks"]):
            lb = f"{base}.encoder.layers.{i}"
            for k, name in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"),
                            ("out", "out_proj")):
                lin(f"{lb}.self_attn.{name}", bp["attn"][k])
            norm(f"{lb}.layer_norm1", bp["attn_ln"])
            lin(f"{lb}.mlp.fc1", bp["mlp"]["fc1"])
            lin(f"{lb}.mlp.fc2", bp["mlp"]["fc2"])
            norm(f"{lb}.layer_norm2", bp["mlp_ln"])
        norm(f"{base}.final_layer_norm", clip["layer_norm"])

    ub, unet = "model.diffusion_model", params["unet"]
    lin(f"{ub}.time_embed.0", unet["lin1_time_embed"])
    lin(f"{ub}.time_embed.2", unet["lin2_time_embed"])

    def res(key, p):
        for part, name in (("norm_in", "in_layers.0"), ("norm_out", "out_layers.0")):
            norm(f"{key}.{name}", p[part])
        for part, name in (("conv_in", "in_layers.2"), ("conv_out", "out_layers.3")):
            conv(f"{key}.{name}", p[part])
        lin(f"{key}.emb_layers.1", p["lin_embed"])
        if "skip_connection" in p:
            conv(f"{key}.skip_connection", p["skip_connection"])

    def transformer(key, p):
        norm(f"{key}.norm", p["norm"])
        for name in ("proj_in", "proj_out"):
            if linear_proj:  # the 1x1 kernel [1, 1, in, out] as [out, in]
                lin(f"{key}.{name}", {"w": p[name]["w"][0, 0], "b": p[name]["b"]})
            else:
                conv(f"{key}.{name}", p[name])
        tp, tb = p["transformer"], f"{key}.transformer_blocks.0"
        for n in ("attn1", "attn2"):
            for k, name in (("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
                            ("out", "to_out.0")):
                lin(f"{tb}.{n}.{name}", tp[n][k])
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{tb}.{n}", tp[n])
        lin(f"{tb}.ff.net.0.proj", tp["mlp"]["geglu"]["proj"])
        lin(f"{tb}.ff.net.2", tp["mlp"]["lin"])

    for idx, spec in enumerate(build_input_specs(cfg.unet)):
        p, kb = unet["input_blocks"][spec.name], f"{ub}.input_blocks.{idx}"
        if spec.kind in ("conv", "down"):
            conv(f"{kb}.0" + (".op" if spec.kind == "down" else ""), p)
        else:
            res(f"{kb}.0", p["res"] if spec.transformer else p)
            if spec.transformer:
                transformer(f"{kb}.1", p["transformer"])
    mid = unet["middle_block"]
    res(f"{ub}.middle_block.0", mid["res1"])
    transformer(f"{ub}.middle_block.1", mid["transformer"])
    res(f"{ub}.middle_block.2", mid["res2"])
    for idx, spec in enumerate(build_output_specs(cfg.unet)[0]):
        p, kb = unet["output_blocks"][spec.name], f"{ub}.output_blocks.{idx}"
        res(f"{kb}.0", p["res"] if (spec.transformer or spec.upsample) else p)
        if spec.transformer:
            transformer(f"{kb}.1", p["transformer"])
        if spec.upsample:
            conv(f"{kb}.{2 if spec.transformer else 1}.conv", p["upsample"]["conv"])
    norm(f"{ub}.out.0", unet["norm_out"])
    conv(f"{ub}.out.2", unet["conv_out"])

    fb, vae = "first_stage_model", params["autoencoder"]

    def vres(key, p):
        for i in (1, 2):
            norm(f"{key}.norm{i}", p[f"norm{i}"])
            conv(f"{key}.conv{i}", p[f"conv{i}"])
        if "nin_shortcut" in p:
            conv(f"{key}.nin_shortcut", p["nin_shortcut"])

    def vmid(key, p):
        vres(f"{key}.block_1", p["block_1"])
        vres(f"{key}.block_2", p["block_2"])
        norm(f"{key}.attn_1.norm", p["attn"]["norm"])
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{key}.attn_1.{n}", p["attn"][n])

    for side in ("encoder", "decoder"):
        e = vae[side]
        conv(f"{fb}.{side}.conv_in", e["conv_in"])
        conv(f"{fb}.{side}.conv_out", e["conv_out"])
        norm(f"{fb}.{side}.norm_out", e["norm_out"])
        vmid(f"{fb}.{side}.mid", e["mid"])
        n = len(e["blocks"])
        for j, blk in enumerate(e["blocks"]):
            # ldm's decoder registers up.{n-1} first (lowest resolution)
            kb = f"{fb}.encoder.down.{j}" if side == "encoder" else f"{fb}.decoder.up.{n - 1 - j}"
            for r in range(3 if side == "decoder" else 2):
                vres(f"{kb}.block.{r}", blk[f"res{r + 1}"])
            if "downsampler" in blk:
                conv(f"{kb}.downsample.conv", blk["downsampler"]["conv"])
            if "upsampler" in blk:
                conv(f"{kb}.upsample.conv", blk["upsampler"])
    conv(f"{fb}.quant_conv", vae["quant_conv"])
    conv(f"{fb}.post_quant_conv", vae["post_quant_conv"])
    sd["alphas_cumprod"] = t(params["alphas_cumprod"])
    return sd


@pytest.mark.parametrize("tower", ["clip_v1", "openclip_v2"])
def test_convert_state_dict_as_sdtpu(params, tower):
    """The port's mapping of a CompVis state dict equals sdtpu's and gives
    back the params it was built from (the v2 tower as exact GELU blocks
    with q/k/v biases: the state dict's own)."""
    sd = ldm_state_dict(params, SD_TINY, openclip=tower == "openclip_v2")
    got = tckpt.convert_state_dict(sd, SD_TINY)
    assert_leaves_equal(got, jckpt.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, J_SD_TINY))
    assert_leaves_equal(got, params)


def test_convert_linear_proj_in_out(params):
    """SD v2.x's linear proj_in/proj_out ([out, in]) convert to the tree of
    their 4-D 1x1 form. sdtpu's converter transposes them as 4-D OIHW
    weights and raises (a fault it keeps: ROADMAP queue 3)."""
    sd4 = ldm_state_dict(params, SD_TINY, openclip=True)
    sd2 = ldm_state_dict(params, SD_TINY, openclip=True, linear_proj=True)
    key = "model.diffusion_model.input_blocks.1.1.proj_in.weight"
    assert sd2[key].ndim == 2 and sd4[key].ndim == 4
    got = tckpt.convert_state_dict(sd2, SD_TINY)
    assert_leaves_equal(got, tckpt.convert_state_dict(sd4, SD_TINY))
    assert_leaves_equal(got, params)
    with pytest.raises(ValueError, match="axes don't match array"):
        jckpt.convert_state_dict({k: v.numpy() for k, v in sd2.items()}, J_SD_TINY)


def test_convert_state_dict_default_schedule(params):
    """Without alphas_cumprod in the state dict both packages take the
    scaled-linear schedule."""
    sd = ldm_state_dict(params, SD_TINY)
    del sd["alphas_cumprod"]
    got = tckpt.convert_state_dict(sd, SD_TINY)["alphas_cumprod"]
    want = jckpt.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                    J_SD_TINY)["alphas_cumprod"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)


def test_load_torch_ckpt_and_its_unpickling_fallback(params, tmp_path):
    """A {"state_dict": ...} checkpoint loads with weights_only=True; one
    holding another object needs full unpickling, which both packages do
    only after a warning; both give sdtpu's tree."""
    sd = ldm_state_dict(params, SD_TINY)
    path = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": sd}, path)
    assert_leaves_equal(tckpt.load_torch_ckpt(path, SD_TINY), params)
    torch.save({"state_dict": sd, "args": argparse.Namespace(lr=1e-4)}, path)
    with pytest.warns(UserWarning, match="full unpickling"):
        got = tckpt.load_torch_ckpt(path, SD_TINY)
    with pytest.warns(UserWarning, match="full unpickling"):
        want = jckpt.load_torch_ckpt(path, J_SD_TINY)
    assert_leaves_equal(got, want)
