"""The port's parallel/ (mesh, sharding rules, tp primitives, sharded
sampling) against sdtpu's, on the CPU under gloo.

Ranks are new processes (sdtpu_torch.parallel.spawn), one spawn per layout,
each checking several things: the rank functions below run there and
import nothing of jax or sdtpu (this module imports them inside the tests
only). sdtpu's sharded results come from the 8-device CPU mesh that
tests/conftest.py sets up, at sdtpu's tolerance for them (rtol 1e-5, atol
2e-4, tests/test_parallel.py).

- param_specs against sdtpu's _spec_for on every leaf of SD v1.4's and SD
  v2.1's trees (from shapes: jax.eval_shape of sdtpu's inits), and the
  count of sharded leaves per model at tp = 2;
- make_mesh's errors and its grid, on 4 ranks;
- each tp primitive's forward and gradient against the unsharded op;
- shard, then gather, gives the tree back bit-equal (the fused qkv's and
  GEGLU's halves rank by rank);
- a column/row attention sublayer, a 256-channel conv and the VAE's
  one-head attention (its weights gathered) against the whole op; K2's,
  K5's and K10's plain twins at local shapes, the residual and bias on tp
  rank 0, summed over the ranks, against the whole sublayer;
- sample_latent at dp x tp = 2x1, 1x2, 2x2 and 1x4 against the port's
  single process and sdtpu's sharded result; and, with every fused gate
  open, a 256-channel model at tp = 2 and 4 against its single process,
  the kernels' plain twins called at the local shapes.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from sdtpu_torch.config import SD_TINY, AutoencoderConfig, UNetConfig

# SD_TINY with a 256-channel UNet level and VAE (the sharded convs), heads of
# 32 (2 at the 64-wide level, 8 at 256), for the fused gates' paths
WIDE = dataclasses.replace(
    SD_TINY, name="sd-tiny-wide",
    unet=UNetConfig(model_channels=64, channel_mult=(1, 4), attention_levels=(0, 1),
                    head_dim=32, context_dim=32, time_embed_dim=64, groupnorm_groups=4),
    vae=AutoencoderConfig(encoder_channels=((8, 8), (8, 256)),
                          decoder_channels=((256, 256), (256, 8)), groupnorm_groups=4))
TOL = {"rtol": 1e-5, "atol": 2e-4}  # sdtpu's for its sharded sampling
SPAWN_TIMEOUT = 600  # seconds: a hung rank fails its test, not the whole run
# WIDE's: the same rtol; its 256-wide products summed in 4 partial sums (tp =
# 4) and CFG 7.5's amplification over 2 steps put f32's summation order at
# 2.7e-4 of latents about 90 in size
WIDE_TOL = {"rtol": 1e-5, "atol": 5e-4}


# ------------------------------------------------------------ the ranks

def _setup(dp, tp):
    from sdtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(dp=dp, tp=tp, device="cpu")


def _sample(params, cfg, inputs, mesh=None):
    """sample_latent (2 DDIM steps, CFG 7.5) and the decoded images."""
    from sdtpu_torch.pipeline import StableDiffusion

    lat, ctx, unctx, valid, unvalid = (torch.from_numpy(a) for a in inputs)
    sd = StableDiffusion(params, cfg, mesh=mesh)
    with torch.no_grad():
        z = sd.sample_latent(ctx, unctx, 7.5, 2, initial_latent=lat, ctx_valid=valid,
                             uncond_valid=unvalid)
        return z, sd.latent_to_image(z)


def _open_gates(put=setattr, setenv=None):
    """Every fused gate open at the test sizes (K2, K5, K10, K4, K6, K7);
    put and setenv: the setters (a test's monkeypatch.setattr and setenv,
    so that its process gets them back; a rank's process sets them)."""
    import os

    from sdtpu_torch.models import unet, vae
    from sdtpu_torch.ops import conv, dispatch

    (setenv or os.environ.__setitem__)("SDTPU_FUSED_XATTN", "1")
    put(unet, "FUSED_RES_MIN_ROWS", 64)
    put(unet, "_use_fused_proj", lambda rows, c: (not dispatch.in_training() and c % 8 == 0
                                                  and rows % 8 == 0))
    put(vae, "FUSED_CONV_MIN_ROWS", 64)
    put(conv, "FUSED_UP_MIN_ROWS", 64)


def _spy_plain(put=setattr):
    """Record each kernel wrapper's plain-twin call: (name, inner width,
    residual); put as _open_gates'."""
    from sdtpu_torch.ops import fused_conv, fused_cross_attention, fused_mlp, fused_transformer

    calls = []

    def wrap(mod, name, width, res=lambda a, k: k.get("residual", True)):
        f = getattr(mod, name)

        def spy(*a, **k):
            calls.append((name, width(a, k), res(a, k)))
            return f(*a, **k)

        put(mod, name, spy)

    wrap(fused_transformer, "fused_self_attention_plain",
         lambda a, k: a[3].shape[1] // 3, lambda a, k: a[8] if len(a) > 8 else True)
    wrap(fused_mlp, "fused_geglu_mlp_plain", lambda a, k: a[5].shape[0],
         lambda a, k: a[8] if len(a) > 8 else True)
    wrap(fused_cross_attention, "fused_cross_attention_kv_plain", lambda a, k: a[5].shape[1],
         lambda a, k: a[11] if len(a) > 11 else True)
    for name in ("conv3x3_fused_plain", "conv1x1_fused_plain", "upsample2x_conv_fused_plain"):
        wrap(fused_conv, name, lambda a, k: a[1].shape[-1], lambda a, k: True)
    return calls


def _primitives(mesh):
    """Each tp primitive's forward and input gradient against the whole op:
    a column shard then a row shard (copy_to_tp, reduce_from_tp), a
    block-wise column shard gathered (scatter_to_tp, gather_from_tp)."""
    from sdtpu_torch.parallel import tp as tpc

    tp = tpc.of_mesh(mesh)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 8, generator=g, dtype=torch.float64)
    w1, w2 = torch.randn(8, 12, generator=g, dtype=torch.float64), torch.randn(
        12, 5, generator=g, dtype=torch.float64)
    out = {}
    for blocks in (1, 3):  # rank r's columns: the r-th slice of each of `blocks` blocks
        xs, a, b = (t.clone().requires_grad_() for t in (x, w1, w2))
        y = tpc.copy_to_tp(xs, tp) @ tpc.scatter_to_tp(a, tp, -1, blocks)
        z = tpc.reduce_from_tp(y @ tpc.scatter_to_tp(b, tp, 0, blocks), tp)
        gathered = tpc.gather_from_tp(y, tp, -1, blocks)
        loss = (z ** 2).sum() + (gathered ** 3).sum()
        grads = torch.autograd.grad(loss, (xs, a, b))
        out[blocks] = [t.detach() for t in (z, gathered, *grads)]
    return out


def _roundtrip(mesh, cfg):
    """shard_params then gather_params of the pipeline's tree (with the
    fused qkv), bit-equal; and rank r's fused qkv and GEGLU leaves as
    [q_r | k_r | v_r] and [value_r | gate_r]."""
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.models.unet import fuse_qkv
    from sdtpu_torch.parallel import gather_params, param_specs, shard_params
    from sdtpu_torch.weights import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = {**params, "unet": fuse_qkv(params["unet"])}
    with torch.no_grad():
        local = shard_params(params, mesh)
        back = gather_params(local, mesh, param_specs(params, mesh.tp))
    whole, got, loc = ({k: v for k, v in flatten_tree(t).items() if torch.is_tensor(v)}
                       for t in (params, back, local))
    r, n = mesh.tp_rank, mesh.tp
    a1 = "unet/input_blocks/rt1/transformer/transformer/attn1/"
    q, k, v = (whole[a1 + f"{x}/w"] for x in ("query", "key", "value"))
    qkv_r = torch.cat([t.chunk(n, dim=1)[r] for t in (q, k, v)], dim=1)
    proj = "unet/input_blocks/rt1/transformer/transformer/mlp/geglu/proj/w"
    val, gate = whole[proj].chunk(2, dim=1)
    geglu_r = torch.cat([val.chunk(n, dim=1)[r], gate.chunk(n, dim=1)[r]], dim=1)
    return {"equal": sorted(whole) == sorted(got) and all(
                torch.equal(whole[key], got[key]) for key in whole),
            "sharded": sum(loc[key].shape != whole[key].shape for key in whole),
            "qkv": torch.equal(loc[a1 + "qkv/w"], qkv_r),
            "geglu": torch.equal(loc[proj], geglu_r)}


def _sublayers(mesh):
    """On WIDE's weights: the 256-wide transformer's attention (column /
    row), a 256-channel 3x3 conv, the VAE mid block's one-head attention
    (its weights gathered) and K2's, K5's and K10's plain twins at local
    shapes (residual and bias on tp rank 0, then the ranks' sum), each with
    the whole op's result on the whole weights."""
    from sdtpu_torch.models import unet as tunet
    from sdtpu_torch.models import vae as tvae
    from sdtpu_torch.ops import conv2d
    from sdtpu_torch.ops.fused_cross_attention import fused_cross_attention_kv
    from sdtpu_torch.ops.fused_mlp import fused_geglu_mlp
    from sdtpu_torch.ops.fused_transformer import fused_self_attention
    from sdtpu_torch.parallel import layers as tpl
    from sdtpu_torch.parallel import shard_params
    from sdtpu_torch.parallel import tp as tpc
    from sdtpu_torch.weights import init_params

    tp = tpc.of_mesh(mesh)
    params = init_params(WIDE, torch.Generator().manual_seed(1), device="cpu")
    params = {**params, "unet": tunet.fuse_qkv(params["unet"])}
    with torch.no_grad():
        local = shard_params(params, mesh)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, 256, generator=g)
    ctx = torch.randn(2, 77, 32, generator=g)
    m = torch.randn(2, 8, 8, 256, generator=g)
    res = {}
    path = ("input_blocks", "rt3", "transformer", "transformer")

    def sub(tree):
        for k in ("unet",) + path:
            tree = tree[k]
        return tree

    tw, tl = sub(params), sub(local)
    with torch.no_grad():
        with tpc.use(tp):
            res["attn1"] = (tunet._mha_apply(tl["attn1"], x, None, 8),
                            tunet._mha_apply(tw["attn1"], x, None, 8))
            res["attn2"] = (tunet._mha_apply(tl["attn2"], x, ctx, 8),
                            tunet._mha_apply(tw["attn2"], x, ctx, 8))
            cw = params["unet"]["input_blocks"]["rt3"]["res"]["conv_in"]
            cl = local["unet"]["input_blocks"]["rt3"]["res"]["conv_in"]
            mi = torch.randn(2, 8, 8, 64, generator=g)
            res["conv"] = (tpl.conv2d(cl, mi, padding=1), conv2d(cw, mi, padding=1))
            vw = params["autoencoder"]["decoder"]["mid"]["attn"]
            vl = local["autoencoder"]["decoder"]["mid"]["attn"]
            res["vae attn"] = (tvae._attn_apply(vl, m, WIDE.vae), tvae._attn_apply(vw, m, WIDE.vae))
        first = tp.rank == 0
        ln = (tw["norm1"]["g"], tw["norm1"]["b"])
        a1l, a1w = tl["attn1"], tw["attn1"]
        res["K2"] = (tpc.reduce_from_tp(fused_self_attention(
            x, *ln, a1l["qkv"]["w"], a1l["out"]["w"], a1l["out"]["b"], 8 // tp.size,
            residual=first), tp), fused_self_attention(
            x, *ln, a1w["qkv"]["w"], a1w["out"]["w"], a1w["out"]["b"], 8))
        mw, ml = tw["mlp"], tl["mlp"]
        res["K5"] = (tpc.reduce_from_tp(fused_geglu_mlp(
            x, *ln, ml["geglu"]["proj"]["w"], tpc.scatter_to_tp(mw["geglu"]["proj"]["b"], tp, 0, 2),
            ml["lin"]["w"], ml["lin"]["b"], residual=first), tp), fused_geglu_mlp(
            x, *ln, mw["geglu"]["proj"]["w"], mw["geglu"]["proj"]["b"], mw["lin"]["w"],
            mw["lin"]["b"]))
        a2l, a2w = tl["attn2"], tw["attn2"]
        valid = torch.arange(77)[None] < torch.tensor([5, 77])[:, None]

        def k10(a, heads, residual=True):
            kt = torch.matmul(ctx, a["key"]["w"]).transpose(1, 2)
            vt = torch.matmul(ctx, a["value"]["w"]).transpose(1, 2)
            return fused_cross_attention_kv(x, kt, vt, *ln, a["query"]["w"], a["out"]["w"],
                                            a["out"]["b"], valid, heads, residual=residual)

        res["K10"] = (tpc.reduce_from_tp(k10(a2l, 8 // tp.size, first), tp), k10(a2w, 8))
    return res


def _rank(layouts, np_params, inputs):
    """One rank of a spawn (a world of 2 or 4): on 2 ranks the tp checks
    (dp x tp = 1 x 2), on 4 make_mesh's errors; then sample_latent of
    sdtpu's tiny weights at each (dp, tp) layout of the world, and WIDE with
    every fused gate open at each tp-only layout."""
    import torch.distributed as dist

    from sdtpu_torch.parallel import make_mesh
    from sdtpu_torch.weights import from_numpy_tree, init_params

    torch.set_num_threads(1)
    out = {"tiny": {}, "wide": {}}
    if dist.get_world_size() == 2:
        mesh = make_mesh(dp=1, tp=2, device="cpu")
        out.update(primitives=_primitives(mesh), roundtrip=_roundtrip(mesh, WIDE),
                   sublayers=_sublayers(mesh))
    else:
        out["mesh"] = _mesh_errors()
    params = from_numpy_tree(np_params, device="cpu")
    meshes = {lay: make_mesh(*lay, device="cpu") for lay in layouts}
    for lay, mesh in meshes.items():
        out["tiny"][lay] = _sample(params, SD_TINY, inputs, mesh)
    _open_gates()
    calls = _spy_plain()
    wide = init_params(WIDE, torch.Generator().manual_seed(0), device="cpu")
    winputs = _wide_inputs()
    for lay, mesh in meshes.items():
        if lay[0] == 1:
            calls.clear()
            out["wide"][lay] = (*_sample(wide, WIDE, winputs, mesh), sorted(set(calls)))
    return out


def _mesh_errors():
    """make_mesh's errors on a world of 4, and its grid."""
    import torch.distributed as dist

    from sdtpu_torch.parallel import make_mesh

    got = {}
    for kw in ({"dp": 3, "tp": 1}, {"dp": 5, "tp": 1}, {"tp": 3}):
        try:
            make_mesh(device="cpu", **kw)
            got[str(kw)] = None
        except ValueError as e:
            got[str(kw)] = str(e)
    try:
        make_mesh(tp=2)  # no device given, and no card: no silent CPU
        got["no device"] = None
    except RuntimeError as e:
        got["no device"] = str(e)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sub = make_mesh(dp=1, tp=2, allow_idle=True, device="cpu")
    got["idle warning"] = [str(x.message) for x in w]
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    got["sub"] = (sub.shape, sub.active, sub.tp_rank)
    got["grid"] = (dist.get_rank(), mesh.dp_rank, mesh.tp_rank, mesh.backend, str(mesh.device),
                   mesh.shape)
    return got


def _wide_inputs():
    r = np.random.default_rng(3)
    lat = r.standard_normal((2, WIDE.latent_size, WIDE.latent_size, 4)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    unctx = r.standard_normal((1, 77, 32)).astype(np.float32)
    valid = np.arange(77)[None] < np.array([5, 9])[:, None]
    return lat, ctx, unctx, valid, np.arange(77)[None] < 2


# ------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def sdtpu_tiny():
    """sdtpu's tiny weights and a batch-4 sampling input, as numpy."""
    import jax
    import jax.numpy as jnp

    from sdtpu.config import SD_TINY as J_TINY
    from sdtpu.diffusion import scaled_linear_alphas_cumprod
    from sdtpu.models.clip import init_clip
    from sdtpu.models.unet import init_unet
    from sdtpu.models.vae import init_autoencoder

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"clip": init_clip(k1, J_TINY.clip), "unet": init_unet(k2, J_TINY.unet),
              "autoencoder": init_autoencoder(k3, J_TINY.vae),
              "alphas_cumprod": scaled_linear_alphas_cumprod(1000), "n_steps": 1000}
    inputs = (jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16, 4)),
              jax.random.normal(jax.random.PRNGKey(1), (4, 77, 32)),
              jax.random.normal(jax.random.PRNGKey(2), (1, 77, 32)),
              jnp.ones((4, 77), bool).at[:, 5:].set(False),
              jnp.ones((1, 77), bool).at[:, 2:].set(False))
    return params, tuple(np.asarray(a) for a in inputs)


@pytest.fixture(scope="module")
def single_tiny(sdtpu_tiny):
    """The port's single-process sampling of sdtpu's tiny weights."""
    import jax

    from sdtpu_torch.weights import from_numpy_tree

    params, inputs = sdtpu_tiny
    return _sample(from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
                   SD_TINY, inputs)


@pytest.fixture(scope="module")
def sampling_runs(sdtpu_tiny):
    """Two spawns: 2 ranks (dp x tp = 2x1 and 1x2) and 4 ranks (2x2, 1x4)."""
    import jax

    from sdtpu_torch.parallel import spawn

    params, inputs = sdtpu_tiny
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return {world: spawn(world, _rank, layouts, np_params, inputs, backend="gloo",
                         timeout=SPAWN_TIMEOUT)
            for world, layouts in ((2, ((2, 1), (1, 2))), (4, ((2, 2), (1, 4))))}


@pytest.fixture(scope="module")
def tp_run(sampling_runs):
    return sampling_runs[2]


def _shape_tree(init, *args):
    import jax

    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args))
    return tree


@pytest.mark.parametrize("preset", ["sd-v1-4", "sd-v2-1"])
def test_param_specs_equal_sdtpus(preset):
    import jax

    from sdtpu.config import PRESETS
    from sdtpu.models.clip import init_clip
    from sdtpu.models.unet import init_unet
    from sdtpu.models.vae import init_autoencoder
    from sdtpu.parallel.sharding import _path_str, _spec_for
    from sdtpu_torch.parallel import param_specs

    cfg = PRESETS[preset]
    tree = {"clip": _shape_tree(init_clip, cfg.clip), "unet": _shape_tree(init_unet, cfg.unet),
            "autoencoder": _shape_tree(init_autoencoder, cfg.vae)}
    for tp in (1, 2, 4):
        ours = param_specs(tree, tp)
        n = 0
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            want = tuple(_spec_for(_path_str(path), tuple(leaf.shape), tp))
            node = ours
            for p in path:
                node = node[getattr(p, "key", getattr(p, "idx", None))]
            assert node == want, (_path_str(path), node, want)
            n += 1
        assert n > 600
    specs = param_specs(tree, 2)
    sharded = {m: sum("tp" in s for s in jax.tree_util.tree_leaves(
        specs[m], is_leaf=lambda x: isinstance(x, tuple))) for m in specs}
    # UNet: 128 attention weights, 16 geglu.proj, 16 mlp.lin and 97 convs of
    # >= 256 output channels (the input conv and 3 upsamplers, 3 down convs,
    # 22 conv_in, 22 conv_out, 16 proj_in, 16 proj_out, 14 skip
    # connections); VAE: 55 convs
    clip = 72 if preset == "sd-v1-4" else 138
    assert sharded == {"clip": clip, "unet": 257, "autoencoder": 55}, sharded


def test_param_specs_of_the_ports_tree():
    """The port's own tree (its init, the fused qkv added) gets sdtpu's rule
    on every leaf sdtpu has, and a column shard of each third on qkv."""
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.models.unet import fuse_qkv
    from sdtpu_torch.parallel import param_specs
    from sdtpu_torch.parallel.sharding import _spec_for
    from sdtpu_torch.weights import init_params

    params = init_params(WIDE, torch.Generator().manual_seed(0), device="cpu")
    params = {**params, "unet": fuse_qkv(params["unet"])}
    flat = {k: v for k, v in flatten_tree(params).items() if torch.is_tensor(v)}
    specs = param_specs(params, 2)
    for path, leaf in flat.items():
        node = specs
        for p in path.split("/"):
            node = node[int(p)] if isinstance(node, list) else node[p]
        if path.endswith("attn1/qkv/w"):
            assert node == (None, "tp")
        else:
            assert node == _spec_for(path, tuple(leaf.shape), 2), path


def test_make_mesh_errors_and_grid(sampling_runs):
    res = [r["mesh"] for r in sampling_runs[4]]
    got = res[0]
    assert "idle" in got["{'dp': 3, 'tp': 1}"]
    assert "needs" in got["{'dp': 5, 'tp': 1}"]
    assert "does not divide" in got["{'tp': 3}"]
    assert "no CUDA device" in got["no device"]
    assert any("idle" in m for m in got["idle warning"])
    assert [r["sub"] for r in res] == [({"dp": 1, "tp": 2}, True, 0), ({"dp": 1, "tp": 2}, True, 1),
                                       ({"dp": 1, "tp": 2}, False, None),
                                       ({"dp": 1, "tp": 2}, False, None)]
    # rank r at (r // tp, r % tp), sdtpu's reshape(dp, tp)
    assert [r["grid"] for r in res] == [
        (r, r // 2, r % 2, "gloo", "cpu", {"dp": 2, "tp": 2}) for r in range(4)]


@pytest.mark.parametrize("blocks", [1, 3])
def test_tp_primitives_against_the_whole_op(tp_run, blocks):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 12, generator=g, dtype=torch.float64)
    w2 = torch.randn(12, 5, generator=g, dtype=torch.float64)
    xs, a, b = (t.clone().requires_grad_() for t in (x, w1, w2))
    y = xs @ a  # the whole op, whatever the blocks
    z = y @ b
    loss = (z ** 2).sum() + (y ** 3).sum()
    want = [z, y, *torch.autograd.grad(loss, (xs, a, b))]
    for res in tp_run:
        got = res["primitives"][blocks]
        for name, gt, wt in zip(("z", "gathered", "dx", "dw1", "dw2"), got, want):
            torch.testing.assert_close(gt, wt.detach(), rtol=1e-12, atol=1e-12, msg=name)


def test_shard_gather_round_trip(tp_run):
    for r, res in enumerate(tp_run):
        got = res["roundtrip"]
        assert got["equal"] and got["qkv"] and got["geglu"], (r, got)
        assert got["sharded"] > 40


@pytest.mark.parametrize("name", ["attn1", "attn2", "conv", "vae attn", "K2", "K5", "K10"])
def test_sublayer_on_shards_equals_whole(tp_run, name):
    for res in tp_run:
        got, want = res["sublayers"][name]
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world,layout", [(2, (2, 1)), (2, (1, 2)), (4, (2, 2)), (4, (1, 4))])
def test_sharded_sampling_equals_single_and_sdtpus(sampling_runs, sdtpu_tiny, single_tiny,
                                                   layout, world):
    import jax
    import jax.numpy as jnp

    from sdtpu.config import SD_TINY as J_TINY
    from sdtpu.parallel import make_mesh, shard_batch, shard_params
    from sdtpu.pipeline import StableDiffusion as JSD

    params, inputs = sdtpu_tiny
    single_z, single_img = single_tiny
    dp, tp = layout
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = make_mesh(dp=dp, tp=tp, allow_idle=True)
    lat, ctx, unctx, valid, unvalid = (jnp.asarray(a) for a in inputs)
    want = np.asarray(JSD(shard_params(params, mesh), J_TINY).sample_latent(
        shard_batch(ctx, mesh), unctx, 7.5, 2, initial_latent=shard_batch(lat, mesh),
        ctx_valid=shard_batch(valid, mesh), uncond_valid=unvalid))
    results = [r["tiny"][layout] for r in sampling_runs[world]]
    for z, img in results:
        np.testing.assert_allclose(z.numpy(), single_z.numpy(), **TOL)
        np.testing.assert_allclose(z.numpy(), want, **TOL)
        assert img.shape == single_img.shape
        assert np.abs(img.astype(int) - single_img.astype(int)).max() <= 1
    # every rank returns the same gathered batch
    assert all(torch.equal(z, results[0][0]) for z, _ in results)


@pytest.mark.parametrize("world,layout", [(2, (1, 2)), (4, (1, 4))])
def test_fused_gates_on_local_shapes(sampling_runs, monkeypatch, world, layout):
    """WIDE with every fused gate open: the plain twins ran at the local
    widths (inner width / tp, out channels / tp), rank 0 alone with the
    residual, and the result equals the single process's."""
    _open_gates(monkeypatch.setattr, monkeypatch.setenv)
    calls = _spy_plain(monkeypatch.setattr)
    from sdtpu_torch.weights import init_params

    wide = init_params(WIDE, torch.Generator().manual_seed(0), device="cpu")
    z1, img1 = _sample(wide, WIDE, _wide_inputs())
    whole = sorted(set(calls))
    tp = layout[1]
    for r, res in enumerate(sampling_runs[world]):
        z, img, local = res["wide"][layout]
        np.testing.assert_allclose(z.numpy(), z1.numpy(), **WIDE_TOL)
        assert np.abs(img.astype(int) - img1.astype(int)).max() <= 1
        names = {n for n, _, _ in local}
        assert names == {n for n, _, _ in whole} == {
            "fused_self_attention_plain", "fused_geglu_mlp_plain",
            "fused_cross_attention_kv_plain", "conv3x3_fused_plain", "conv1x1_fused_plain",
            "upsample2x_conv_fused_plain"}, names
        # K2 and K10 run at the 64-wide level alone (2 heads: at tp = 4 its
        # weights are gathered and the sublayer runs whole on every rank)
        split = {"fused_geglu_mlp_plain": True, "fused_self_attention_plain": 2 % tp == 0,
                 "fused_cross_attention_kv_plain": 2 % tp == 0}
        for n, on_shards in split.items():
            widths = {w for m, w, _ in whole if m == n}
            assert {w for m, w, _ in local if m == n} == (
                {w // tp for w in widths} if on_shards else widths), n
            assert {res_ for m, _, res_ in local if m == n} == {r == 0 or not on_shards}, n
        # the sharded convs (>= 256 output channels) at 256 / tp
        assert 256 // tp in {w for m, w, _ in local if m == "conv3x3_fused_plain"}
        assert 256 // tp in {w for m, w, _ in local if m == "upsample2x_conv_fused_plain"}


def _halves_case(name, dev, dtype):
    """(whole result by the plain version, the two tp ranks' kernel launches
    on their halves summed or concatenated, each launch against its plain
    version) of one sublayer at a tp-local shape."""
    from sdtpu_torch.ops import fused_conv, fused_cross_attention, fused_mlp, fused_transformer

    g = torch.Generator(device="cpu").manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    b, s, c = 2, 256, 320
    x, ln = rnd(b, s, c), (rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1))
    pairs = []  # (kernel output, plain output) of each rank's launch
    if name == "K2":
        wq, wk, wv, wo = (rnd(c, c, scale=c ** -0.5) for _ in range(4))
        bo = rnd(c, scale=0.1)
        whole = fused_transformer.fused_self_attention_plain(
            x, *ln, torch.cat([wq, wk, wv], 1), wo, bo, 8)
        for r in range(2):
            wqkv = torch.cat([w[:, r * 160:(r + 1) * 160] for w in (wq, wk, wv)], 1)
            args = (x, *ln, wqkv, wo[r * 160:(r + 1) * 160], bo, 4, 1e-5, r == 0)
            pairs.append((fused_transformer.fused_self_attention(*args),
                          fused_transformer.fused_self_attention_plain(*args)))
    elif name == "K5":
        c, h = 640, 2560
        x, ln = rnd(b, s, c), (rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1))
        wp, bp = rnd(c, 2 * h, scale=c ** -0.5), rnd(2 * h, scale=0.1)
        wl, bl = rnd(h, c, scale=h ** -0.5), rnd(c, scale=0.1)
        whole = fused_mlp.fused_geglu_mlp_plain(x, *ln, wp, bp, wl, bl)
        half = h // 2
        for r in range(2):
            cols = torch.cat([torch.arange(r * half, (r + 1) * half),
                              h + torch.arange(r * half, (r + 1) * half)]).to(dev)
            args = (x, *ln, wp[:, cols], bp[cols], wl[r * half:(r + 1) * half], bl, 1e-5, r == 0)
            pairs.append((fused_mlp.fused_geglu_mlp(*args), fused_mlp.fused_geglu_mlp_plain(*args)))
    elif name == "K10":
        ctx = rnd(b, 77, 768)
        wq, wo = rnd(c, c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5)
        wk, wv, bo = rnd(768, c, scale=768 ** -0.5), rnd(768, c, scale=768 ** -0.5), rnd(c)
        valid = (torch.arange(77)[None] < torch.tensor([5, 77])[:, None]).to(dev)
        kt, vt = (torch.matmul(ctx, w).transpose(1, 2) for w in (wk, wv))
        whole = fused_cross_attention.fused_cross_attention_kv_plain(
            x, kt, vt, *ln, wq, wo, bo, valid, 8)
        for r in range(2):
            sl = slice(r * 160, (r + 1) * 160)
            args = (x, kt[:, sl], vt[:, sl], *ln, wq[:, sl], wo[sl], bo, valid, 4, 1e-5, r == 0)
            pairs.append((fused_cross_attention.fused_cross_attention_kv(*args),
                          fused_cross_attention.fused_cross_attention_kv_plain(*args)))
    elif name == "K4":
        w, cb, res = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1), rnd(b, s, c)
        whole = fused_conv.conv1x1_fused_plain(x, w, cb, residual=res)
        for r in range(2):
            sl = slice(r * 160, (r + 1) * 160)
            args = (x, w[:, sl].contiguous(), cb[sl])
            kw = {"residual": res[..., sl].contiguous()}
            pairs.append((fused_conv.conv1x1_fused(*args, **kw),
                          fused_conv.conv1x1_fused_plain(*args, **kw)))
    else:  # K6: a VAE conv at 64², 512 -> 512, its prologue and residual
        xm = rnd(1, 64, 64, 512)
        sc, sh = rnd(1, 512, scale=0.1) + 1.0, rnd(1, 512, scale=0.1)
        w, cb, res = rnd(3, 3, 512, 512, scale=(9 * 512) ** -0.5), rnd(512, scale=0.1), rnd(
            1, 64, 64, 512)
        whole = fused_conv.conv3x3_fused_plain(xm, w, cb, sc, sh, residual=res)
        for r in range(2):
            sl = slice(r * 256, (r + 1) * 256)
            args = (xm, w[..., sl].contiguous(), cb[sl], sc, sh)
            kw = {"residual": res[..., sl].contiguous()}
            pairs.append((fused_conv.conv3x3_fused(*args, **kw),
                          fused_conv.conv3x3_fused_plain(*args, **kw)))
    concat = name in ("K4", "K6")  # out-channel slices; the others are partial sums
    got = torch.cat([p for p, _ in pairs], -1) if concat else pairs[0][0] + pairs[1][0]
    return whole, got, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["K2", "K5", "K10", "K4", "K6"])
def test_tp_local_kernels_on_card(name, dtype):
    """K2, K5, K10 (half the heads or inner width; the residual and bias on
    rank 0) and K4, K6 (half the output channels) at SD v1.4's tp = 2
    shapes: each launch within its tolerance of its plain version (f32: TF32
    products, 5e-3; bf16: 6e-2), and the two ranks' outputs, summed or
    concatenated, the whole sublayer's plain result within twice that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tol = 5e-3 if dtype == "float32" else 6e-2
    whole, got, pairs = _halves_case(name, torch.device("cuda"), getattr(torch, dtype))
    for k, p in pairs:
        torch.testing.assert_close(k.float(), p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), whole.float(), rtol=2 * tol, atol=2 * tol)
