"""The f32 masters, the optimizer state and the EMA held as tp parts by
sdtpu's rule (training.py, io/checkpoint.py), on the CPU under gloo:

- three steps of AdamW and of Adafactor on the WIDE test model at tp = 2,
  and of AdamW at dp x tp = 2 x 2: the gradients the optimizer gets and
  the state, gathered, equal the whole-state steps' leaf by leaf within
  STEP_TOL of each leaf's largest |value| (the parameters within it but
  for the flips test_torch_parallel_train.py describes);
- Adafactor on leaves whose tp part would be factored otherwise than the
  whole (a column half under 128, a row or out-channel half that is no
  longer the largest dim): factored by the whole shape, and five steps
  equal to sdtpu's make_optimizer(kind="adafactor") at weight decay 0,
  the global-norm clip active on some of them;
- a state saved at tp = 2 resumes at tp = 1 bit-equal, and one saved at
  tp = 1 resumes at tp = 2 bit-equal (each rank's part of it, saved again);
- the bytes a rank holds for SD v1.4's UNet masters and AdamW state at tp =
  2, from param_specs on the shapes alone, are under 0.55 of the whole.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import SPAWN_TIMEOUT, WIDE, _shape_tree
from test_torch_parallel_train import STEP_TOL, _close_but_flips, _unet

STEPS = 3
# the synthetic tree of the factoring check; tp = 2 halves each weight on
# the dim the rule splits: query's columns (200 -> 100, under 128), out's
# rows (300 -> 150, under its 256 columns), the conv's outputs (256 -> 128,
# under its 160 inputs)
TREE = {"attn": {"query": {"w": (256, 200)}, "out": {"w": (300, 256), "b": (256,)}},
        "conv": {"w": (3, 3, 160, 256), "b": (256,)}, "norm": {"g": (300,)}}
# f32 on both sides, the means and rms summed in parts over the ranks
ADAFACTOR_TOL = dict(rtol=1e-6, atol=1e-7)


def _of_shapes(fn, node=TREE):
    """TREE with each shape (a tuple leaf) replaced by fn(shape)."""
    if isinstance(node, dict):
        return {k: _of_shapes(fn, v) for k, v in node.items()}
    return fn(node)


def _np_tree(seed, scale=0.05):
    r = np.random.default_rng(seed)
    return _of_shapes(lambda s: (scale * r.standard_normal(s)).astype(np.float32))


def _np_grads(r, step):
    """Gradients whose global norm is above the clip (1.0) on even steps and
    below it on odd ones."""
    scale = 3.0 if step % 2 == 0 else 0.01
    return _of_shapes(lambda s: (scale * r.standard_normal(s) / np.sqrt(np.prod(s) * 6))
                      .astype(np.float32))


def _step_data(step):
    r = np.random.default_rng(100 + step)
    hw = WIDE.latent_size
    latents = r.standard_normal((4, hw, hw, 4)).astype(np.float32)
    context = r.standard_normal((4, 7, WIDE.unet.context_dim)).astype(np.float32)
    valid = np.arange(7)[None] < np.array([3, 7, 5, 1])[:, None]
    t = r.integers(0, 1000, 4)
    noise = r.standard_normal(latents.shape).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (latents, context, valid, t,
                                                                  noise)]


def _train(kind, mesh, state_dir, resume_dir=None):
    """STEPS steps of `kind` on WIDE's UNet (this rank's parts on a mesh):
    the gradients the optimizer got at each step and the final params,
    gathered whole, and the state (with an EMA) saved to state_dir."""
    from sdtpu_torch import training as ttrain
    from sdtpu_torch.io.checkpoint import restore_train_state, save_train_state
    from sdtpu_torch.parallel import shard_batch

    base = _unet()
    opt = ttrain.make_optimizer(lr=1e-4, warmup_steps=1, total_steps=10, kind=kind)
    tree, layout = ttrain.master_params(base, mesh), ttrain.tp_layout(base, mesh)
    state = opt.init(tree, layout)
    ema = ttrain.tree_map(lambda p: p.detach().clone(), tree)
    grads, apply = [], opt.apply  # the step hands its gradients to apply()

    def keep(params, g, st):
        grads.append(ttrain.whole_tree([x.detach().clone() for x in g], layout))
        return apply(params, g, st)

    opt.apply = keep
    step = ttrain.make_train_step(WIDE, opt, mesh=mesh, ema_decay=0.9)
    for i in range(STEPS):
        latents, context, valid, t, noise = _step_data(i)
        batch = tuple(shard_batch(a, mesh) for a in (latents, context, valid))
        tree, state, ema, _ = step(tree, state, ema, batch, t=t, noise=noise)
    write = mesh is None or mesh.rank == 0
    save_train_state(state_dir, tree, state, STEPS, ema=ema, write=write)
    out = {"grads": grads,
           "params": [p.detach() for p in ttrain.tree_leaves(ttrain.whole_tree(tree, layout))]}
    if resume_dir is not None:  # the state saved elsewhere, read into this run's parts
        restore_train_state(resume_dir, tree, state, ema=ema)
        save_train_state(state_dir + "_resaved", tree, state, STEPS, ema=ema, write=write)
    return out


def _factoring(mesh):
    """Five Adafactor (weight decay 0) and AdamW steps on TREE's parts:
    (the params gathered whole, the state's factored dims, the local
    shapes' own) per kind."""
    from sdtpu_torch import training as ttrain
    from sdtpu_torch.parallel import shard_params

    out = {}
    for kind in ("adafactor", "adamw"):
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.0,
                                    kind=kind)
        whole = ttrain.tree_map(torch.from_numpy, _np_tree(0))
        tree, layout = ttrain.master_params(whole, mesh), ttrain.tp_layout(whole, mesh)
        state = opt.init(tree, layout)
        r = np.random.default_rng(1)
        for i in range(5):
            g = ttrain.tree_map(torch.from_numpy, _np_grads(r, i))
            opt.update(tree, ttrain.tree_leaves(shard_params(g, mesh)), state)
        out[kind] = (ttrain.whole_tree(tree, layout), getattr(state, "dims", None),
                     [ttrain.Adafactor.factored_dims(tuple(p.shape))
                      for p in ttrain.tree_leaves(tree)])
    return out


def _rank2(tmp, tp1_dir):
    from sdtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(dp=1, tp=2, device="cpu")
    return {"factoring": _factoring(mesh),
            "adamw": _train("adamw", mesh, os.path.join(tmp, "adamw_tp2"),
                            resume_dir=os.path.join(tp1_dir, "adamw")),
            "adafactor": _train("adafactor", mesh, os.path.join(tmp, "adafactor_tp2"),
                                resume_dir=os.path.join(tp1_dir, "adafactor"))}


def _rank4(tmp):
    from sdtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    return {"adamw": _train("adamw", mesh, os.path.join(tmp, "adamw_dp2tp2"))}


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The whole-state runs in this process, their states saved at tp = 1."""
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("tp1"))
    return tmp, {kind: _train(kind, None, os.path.join(tmp, kind))
                 for kind in ("adamw", "adafactor")}


@pytest.fixture(scope="module")
def sharded(whole, tmp_path_factory):
    from sdtpu_torch.parallel import spawn

    tmp = str(tmp_path_factory.mktemp("tp2"))
    r2 = spawn(2, _rank2, tmp, whole[0], backend="gloo", timeout=SPAWN_TIMEOUT)
    r4 = spawn(4, _rank4, tmp, backend="gloo", timeout=SPAWN_TIMEOUT)
    return tmp, r2, r4


def _load(path):
    from sdtpu_torch.io.checkpoint import read_meta
    from sdtpu_torch.io.native import load_safetensors

    return load_safetensors(os.path.join(path, read_meta(path)["file"]), "cpu")[0]


def _leafwise(got, want):
    """Each leaf within STEP_TOL of its own largest |value|."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=STEP_TOL * float(w.abs().max()))


@pytest.mark.parametrize("case", ["adamw tp2", "adafactor tp2", "adamw dp2tp2"])
def test_sharded_state_steps_equal_the_whole_states(whole, sharded, case):
    from sdtpu_torch.training import tree_leaves

    kind, lay = case.split()
    tmp, r2, r4 = sharded
    want = whole[1][kind]
    runs = r2 if lay == "tp2" else r4
    for res in runs:
        got = res[kind]
        assert len(got["grads"]) == len(want["grads"]) == STEPS
        for g, w in zip(got["grads"], want["grads"]):
            _leafwise(tree_leaves(g), tree_leaves(w))
        _close_but_flips(got["params"], want["params"], lr=1e-4, steps=STEPS)
    saved, ref = _load(os.path.join(tmp, f"{kind}_{lay}")), _load(os.path.join(whole[0], kind))
    assert sorted(saved) == sorted(ref)
    state = sorted(k for k in ref if k.startswith("opt_state/"))
    assert state
    _leafwise([saved[k] for k in state], [ref[k] for k in state])


def test_sharded_adafactor_factors_by_the_whole_shape(sharded):
    """sdtpu's optax factors each leaf by its whole shape: so do the ranks,
    where their parts alone would be factored otherwise, and five steps
    equal sdtpu's; AdamW's equal the port's whole-state AdamW."""
    import jax
    import jax.numpy as jnp
    import optax

    from sdtpu import training as jtrain
    from sdtpu_torch import training as ttrain
    from sdtpu_torch.io.native import flatten_tree

    r = np.random.default_rng(1)
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.0,
                                 kind="adafactor")
    jp = jax.tree_util.tree_map(jnp.asarray, _np_tree(0))
    jstate = jopt.init(jp)
    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.0,
                                 kind="adamw")
    tw = ttrain.master_params(ttrain.tree_map(torch.from_numpy, _np_tree(0)))
    tstate = topt.init(tw)
    for i in range(5):
        g = _np_grads(r, i)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tw, [torch.from_numpy(x) for x in ttrain.tree_leaves(g)], tstate)
    jflat = flatten_tree(jp)  # jax orders a dict's keys; compare by path
    whole_dims = []
    _of_shapes(lambda shape: whole_dims.append(ttrain.Adafactor.factored_dims(shape)))
    for res in sharded[1]:
        params, dims, local_dims = res["factoring"]["adafactor"]
        assert list(dims) == whole_dims
        # the three weights' parts alone would be factored otherwise
        assert [d != w for d, w in zip(local_dims, whole_dims)] == [
            True, True, False, True, False, False]
        got = flatten_tree(params)
        assert sorted(got) == sorted(jflat)
        for k, want in jflat.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want), err_msg=k,
                                       **ADAFACTOR_TOL)
        params, _, _ = res["factoring"]["adamw"]
        for got, want in zip(ttrain.tree_leaves(params), ttrain.tree_leaves(tw)):
            torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_saved_state_resumes_across_tp(whole, sharded, kind):
    """tp = 2 -> tp = 1: the state the ranks saved, restored into this
    process's whole templates, is the file bit for bit. tp = 1 -> tp = 2:
    the ranks restored the state saved here into their parts and saved
    them again: the same file, bit for bit."""
    from sdtpu_torch import training as ttrain
    from sdtpu_torch.io.checkpoint import _tensors, restore_train_state

    tmp = sharded[0]
    path = os.path.join(tmp, f"{kind}_tp2")
    base = _unet()
    opt = ttrain.make_optimizer(lr=1e-4, warmup_steps=1, total_steps=10, kind=kind)
    tree = ttrain.master_params(base)
    state = opt.init(tree)
    ema = ttrain.tree_map(lambda p: p.detach().clone(), tree)
    assert restore_train_state(path, tree, state, ema=ema) == STEPS
    saved = _load(path)
    got = _tensors(tree, state, ema)
    assert sorted(got) == sorted(saved)
    for k, t in got.items():
        assert torch.equal(t.detach(), saved[k]), k
    back, ref = _load(os.path.join(tmp, f"{kind}_tp2_resaved")), _load(
        os.path.join(whole[0], kind))
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert torch.equal(back[k], ref[k]), k


def test_per_rank_state_bytes_at_tp2():
    """SD v1.4's UNet at tp = 2: the f32 masters and AdamW's two moments a
    rank holds, from param_specs on the shapes alone (jax.eval_shape of
    sdtpu's init: nothing allocated), are under 0.55 of the whole."""
    from sdtpu.config import SD_V1_4
    from sdtpu.models.unet import init_unet
    from sdtpu_torch.parallel.sharding import splits
    from sdtpu_torch.training import tree_leaves

    shapes = _shape_tree(init_unet, SD_V1_4.unet)
    leaves = tree_leaves(shapes)
    parts = tree_leaves(splits(shapes, 2))
    assert len(parts) == len(leaves)
    whole = sum(int(np.prod(x.shape)) for x in leaves)
    local = sum(int(np.prod(x.shape)) // (1 if s is None else 2)
                for x, s in zip(leaves, parts))
    whole_bytes, rank_bytes = 3 * 4 * whole, 3 * 4 * local
    assert 3.3e9 < whole_bytes / 3 < 3.5e9  # 860M f32 parameters
    assert rank_bytes < 0.55 * whole_bytes, rank_bytes / whole_bytes
