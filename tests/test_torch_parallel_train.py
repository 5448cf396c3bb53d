"""Fine-tuning on a ("dp", "tp") mesh against the single process, on the
CPU under gloo (two spawned ranks, one spawn for every check of the step).

- one AdamW step (also with remat "full", whose recompute enters the tp
  group again on autograd's thread), one Adafactor step and one LoRA step
  (over the attention linears, and over GEGLU's projection, whose tp part
  is [value_r | gate_r]),
  each at dp = 2 and at tp = 2, against the same step in one process (the
  batch is the rank's dp slice, t and noise the whole batch's, injected;
  at tp = 2 the masters, the optimizer state and LoRA's frozen base are the
  rank's tp parts, and the leaves and gradients are gathered to compare):
  the loss, the gradients the optimizer gets (dp-averaged) within 1e-5 of
  their largest, and the leaves after the step within 1e-5 but for at most
  OFF_SHARE of their elements, which stay within 2 lr: AdamW's first update
  g / (|g| + 1e-8), and Adafactor's g / sqrt(g² + 1e-30) on its unfactored
  leaves, are ±lr nearly everywhere, and move by up to 2 lr where the
  gradients' rounding moves a g near the epsilon (one element in 19 million
  measured);
- the WIDE test model (a 256-channel level: its convs are sharded too);
- run_finetune(tp=2) on two ranks writes one model, from rank 0, equal to
  the single run's, leaf by leaf as the step's; `python -m
  sdtpu_torch.finetune --tp 2` under torchrun (two processes, gloo)
  likewise.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import SPAWN_TIMEOUT, WIDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-5
OFF_SHARE = 1e-5
KINDS = ("adamw", "adamw remat", "adafactor", "lora", "lora geglu")
# the adapted linears of each LoRA kind
LORA_TARGETS = {"lora": ("query", "key", "value", "out"), "lora geglu": ("proj", "fc1")}


def _data(seed=5, b=4):
    r = np.random.default_rng(seed)
    hw = WIDE.latent_size
    latents = r.standard_normal((b, hw, hw, 4)).astype(np.float32)
    context = r.standard_normal((b, 7, WIDE.unet.context_dim)).astype(np.float32)
    valid = np.arange(7)[None] < np.array([3, 7, 5, 1][:b])[:, None]
    t = np.array([3, 300, 600, 999][:b])
    noise = r.standard_normal(latents.shape).astype(np.float32)
    return latents, context, valid, t, noise


def _unet():
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.weights import Init

    return init_unet(Init(torch.Generator().manual_seed(0), "cpu"), WIDE.unet)


def _step(kind, mesh=None):
    """(updated leaves, loss, the gradients the optimizer got at the last
    update) of one step of `kind` on the dp slice of _data() (the whole
    batch without a mesh). On a mesh the masters, the state and the LoRA
    base are this rank's tp parts; the leaves and gradients come back
    gathered whole."""
    from sdtpu_torch import lora as tlora
    from sdtpu_torch import training as ttrain
    from sdtpu_torch.parallel import shard_batch, shard_params

    latents, context, valid, t, noise = (torch.from_numpy(a) for a in _data())
    batch = tuple(shard_batch(a, mesh) for a in (latents, context, valid))
    base = _unet()
    opt = ttrain.make_optimizer(lr=1e-4, warmup_steps=0, total_steps=10,
                                kind="adafactor" if kind == "adafactor" else "adamw")
    grads, apply = [], opt.apply  # the step hands its gradients to apply()

    def keep(params, g, state):
        grads[:] = [x.detach().clone() for x in g]
        return apply(params, g, state)

    opt.apply = keep
    layout = None
    if kind in LORA_TARGETS:
        tree = ttrain.master_params(tlora.init_lora(torch.Generator().manual_seed(1), base, 2,
                                                    targets=LORA_TARGETS[kind]))
        # b moves off 0 at the first step; a's gradient is 0 there: a second step trains it
        step = tlora.make_lora_train_step(WIDE, opt, 0.5, mesh=mesh)
        state = opt.init(tree)
        for _ in range(2):
            tree, state, loss = step(tree, state, shard_params(base, mesh), batch, t=t,
                                     noise=noise)
    else:
        tree, layout = ttrain.master_params(base, mesh), ttrain.tp_layout(base, mesh)
        step = ttrain.make_train_step(WIDE, opt, mesh=mesh,
                                      remat="full" if kind == "adamw remat" else False)
        tree, _, loss = step(tree, opt.init(tree, layout), batch, t=t, noise=noise)
    leaves = ttrain.tree_leaves(ttrain.whole_tree(tree, layout))
    return ([p.detach() for p in leaves], float(loss),
            ttrain.tree_leaves(ttrain.whole_tree(grads, layout)))


def _close_but_flips(got, want, lr, steps):
    """Leaves within STEP_TOL but for at most OFF_SHARE of their elements,
    which are within 2 lr a step (the module docstring)."""
    off = 0
    for p, w in zip(got, want):
        assert p.shape == w.shape
        d = (p - w).abs()
        off += int((d > STEP_TOL).sum())
        assert float(d.max()) <= 2 * lr * steps * 1.01
    assert off <= OFF_SHARE * sum(w.numel() for w in want), off


def _steps_rank():
    from sdtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    meshes = {"dp": make_mesh(dp=2, tp=1, device="cpu"),
              "tp": make_mesh(dp=1, tp=2, device="cpu")}
    return {(kind, lay): _step(kind, mesh) for kind in KINDS for lay, mesh in meshes.items()}


def _write_model_and_cache(tmp):
    """A WIDE native model and a latent cache of 4 examples in tmp."""
    from sdtpu_torch.io.native import save_native
    from sdtpu_torch.weights import init_params

    model = os.path.join(tmp, "wide.safetensors")
    save_native(init_params(WIDE, torch.Generator().manual_seed(0), device="cpu"), model, WIDE)
    latents, context, valid, _, _ = _data()
    cache = os.path.join(tmp, "cache.npz")
    np.savez(cache, latents=latents, contexts=context, n_valid=valid.sum(1).astype(np.int32),
             image_size=np.int32(WIDE.image_size), config_name=np.bytes_(WIDE.name.encode()))
    return model, cache


def _finetune(model, cache, out, tp=1, **kw):
    from sdtpu_torch.finetune import run_finetune
    from sdtpu_torch.io.native import load_native
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer

    torch.set_num_threads(1)
    params, cfg = load_native(model, "cpu")
    return run_finetune(StableDiffusion(params, cfg), SimpleTokenizer(), cache, out, steps=2,
                        batch_size=2, lr=1e-4, tp=tp, log_every=1, log=lambda m: None, **kw)


def _leaves(path):
    from sdtpu_torch.io.native import flatten_tree, load_native

    params, _ = load_native(path, "cpu")
    return {k: v for k, v in flatten_tree(params).items() if torch.is_tensor(v)}


def _adapter_leaves(path):
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.lora import load_lora

    return flatten_tree(load_lora(path)[0])


@functools.lru_cache(maxsize=None)
def _single_step(kind):
    """_step(kind) in this process, once for both layouts' tests."""
    return _step(kind)


@pytest.fixture(scope="module")
def steps():
    from sdtpu_torch.parallel import spawn

    return spawn(2, _steps_rank, backend="gloo", timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("layout", ["dp", "tp"])
@pytest.mark.parametrize("kind", KINDS)
def test_step_on_the_mesh_equals_single(steps, kind, layout):
    from sdtpu_torch.training import tree_leaves

    want, want_loss, want_g = _single_step(kind)
    before = tree_leaves(_unet())
    g_max = max(float(g.abs().max()) for g in want_g)
    for res in steps:
        got, loss, got_g = res[(kind, layout)]
        assert len(got) == len(want) == len(got_g)
        assert abs(loss - want_loss) <= 1e-6 * max(1.0, abs(want_loss))
        for g, w in zip(got_g, want_g):
            torch.testing.assert_close(g, w, rtol=0, atol=STEP_TOL * g_max)
        _close_but_flips(got, want, lr=1e-4, steps=1 if kind not in LORA_TARGETS else 2)
    if kind not in LORA_TARGETS:  # the step moved the weights (by lr 1e-4 a leaf)
        moved = max(float((w - b).abs().max()) for w, b in zip(want, before))
        assert moved > 10 * STEP_TOL


def _finetune_rank(model, cache, out, lora_rank=None):
    import torch.distributed as dist

    result = _finetune(model, cache, out, tp=2, lora_rank=lora_rank)
    return dist.get_rank(), result["losses"]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The WIDE model, its cache and run_finetune's model in one process."""
    tmp = str(tmp_path_factory.mktemp("single"))
    model, cache = _write_model_and_cache(tmp)
    return model, cache, _finetune(model, cache, os.path.join(tmp, "single"))


def test_run_finetune_tp2_writes_the_single_runs_model(single_run, tmp_path):
    from sdtpu_torch.parallel import spawn

    model, cache, single = single_run
    res = spawn(2, _finetune_rank, model, cache, str(tmp_path / "tp"), backend="gloo",
                timeout=SPAWN_TIMEOUT)
    assert [r for r, _ in res] == [0, 1]
    assert res[0][1] == res[1][1]  # every rank logs the same losses
    np.testing.assert_allclose([l for _, l in res[0][1]], [l for _, l in single["losses"]],
                               rtol=1e-5)
    got, want = _leaves(str(tmp_path / "tp.safetensors")), _leaves(single["out_path"])
    assert sorted(got) == sorted(want)
    _close_but_flips([got[k] for k in want], list(want.values()), lr=1e-4, steps=2)
    # one model written, by rank 0 (no file of another name)
    assert os.listdir(tmp_path) == ["tp.safetensors"]


def test_run_finetune_lora_tp2_writes_the_single_runs_model(single_run, tmp_path):
    """A LoRA run at tp = 2 (the frozen base in tp parts, the merged model
    gathered from them) writes the single run's adapter and merged model."""
    from sdtpu_torch.parallel import spawn

    model, cache, _ = single_run
    want = _finetune(model, cache, str(tmp_path / "single"), lora_rank=2)
    res = spawn(2, _finetune_rank, model, cache, str(tmp_path / "tp"), 2, backend="gloo",
                timeout=SPAWN_TIMEOUT)
    assert res[0][1] == res[1][1]
    np.testing.assert_allclose([l for _, l in res[0][1]], [l for _, l in want["losses"]],
                               rtol=1e-5)
    for got, ref in ((_leaves(str(tmp_path / "tp.safetensors")), _leaves(want["out_path"])),
                     (_adapter_leaves(str(tmp_path / "tp.lora.safetensors")),
                      _adapter_leaves(want["lora_path"]))):
        assert sorted(got) == sorted(ref)
        _close_but_flips([got[k] for k in ref], list(ref.values()), lr=1e-4, steps=2)


def test_finetune_command_line_under_torchrun(single_run, tmp_path):
    """`python -m sdtpu_torch.finetune ... --tp 2 --backend gloo` on two
    processes of torchrun: the model equals run_finetune's in one process;
    without --backend it exits 1."""
    model, cache, single = single_run
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "2", "-m", "sdtpu_torch.finetune", "native", model, cache]
    flags = ["--device", "cpu", "--tp", "2", "--steps", "2", "--batch", "2", "--lr", "1e-4"]
    run = subprocess.run(base + [str(tmp_path / "cli")] + flags + ["--backend", "gloo"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    got, want = _leaves(str(tmp_path / "cli.safetensors")), _leaves(single["out_path"])
    assert sorted(got) == sorted(want)
    _close_but_flips([got[k] for k in want], list(want.values()), lr=1e-4, steps=2)
    bad = subprocess.run(base + [str(tmp_path / "bad")] + flags, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "--backend" in bad.stdout + bad.stderr
    assert not os.path.exists(tmp_path / "bad.safetensors")
