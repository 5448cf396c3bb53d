"""Fine-tuning end to end: image folder -> latent cache -> train -> model
(port of sdtpu/finetune.py, on one device), and its command line:

    python -m sdtpu_torch.finetune <burn|dump|native|ckpt> <model> \
        <data_dir|cache.npz> <out_model> [--steps N --batch B --fast ...]

(sdtpu's `finetune` flags; see sdtpu_torch.cli.finetune_main).

    dataset.build_latent_cache  (the port's VAE encoder and CLIP, once)
    dataset.LatentBatches       (shuffled batches, staged by a thread)
    training.make_train_step    (the loss inside dispatch.training(): K1
                                 forward and K9 backward in the attention at
                                 the 64² level, plain PyTorch elsewhere;
                                 AdamW or Adafactor; micro-batches summed in
                                 f32 or bf16; the EMA as the step's last op)
    lora.make_lora_train_step   (an adapter over the frozen base instead)
    io.checkpoint               (train-state save and resume)
    io.native.save_native       (the tuned model, sdtpu's format)

Only the UNet trains (CLIP and the VAE stay frozen, the split the latent
cache bakes in), from f32 master copies of sdtpu's UNet tree: the pipeline's
tree without the fused attn1.qkv leaves (models/unet.py:unfuse_qkv), so the
saved model holds sdtpu's keys and nothing else. run_textual_inversion
learns a concept's embedding rows instead. Inside an initialised
torch.distributed world (torchrun, parallel.launch.spawn) run_finetune
trains on the whole world as a ("dp", "tp") mesh, as sdtpu's does on every
visible device (training.py: the masters, the optimizer state and the EMA
held as tp parts by sdtpu's rule, gradients averaged over dp); rank 0
builds the latent cache and writes the files, whose sharded leaves every
rank of its tp group gathers with it. The work around the steps (the latent cache or
the concept's data, the train state's save and restore, the model's save)
adds its wall seconds to utils.profiling's phases.

With the pipeline's graphs on (the default on the card, graphs.py), the
data preparation replays the encoder's and CLIP's programs, and each step
is one CUDA graph, sdtpu's step_jit: the first step runs eagerly and the
capture follows it, every later step replays it (training.run_step). A run
on a mesh runs its steps eagerly. The run's result holds the graph cache's
stats (captures, replays, each graph's capture seconds and pool bytes),
taken before the run drops its step graphs, which hold its trees.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdtpu_torch.config import StableDiffusionConfig
from sdtpu_torch.dataset import LatentBatches, build_latent_cache, load_latent_cache
from sdtpu_torch.io.checkpoint import restore_train_state, save_train_state
from sdtpu_torch.io.native import save_native
from sdtpu_torch.lora import (apply_lora, init_lora, lora_param_count, make_lora_train_step,
                              save_lora)
from sdtpu_torch.models.unet import unfuse_qkv
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.mesh import make_mesh
from sdtpu_torch.parallel.sharding import shard_params
from sdtpu_torch.textual_inversion import (init_ti_embeddings, make_ti_train_step,
                                           prepare_ti_data, save_ti)
from sdtpu_torch.training import (AdamW, make_optimizer, make_train_step, master_params,
                                  tp_layout, tree_map, whole_tree)
from sdtpu_torch.utils import profiling


def _quiet(msg: str) -> None:
    """The log of every rank but 0."""


STEP_KINDS = ("train", "lora", "ti")  # the step graphs' kinds (training.run_step)


def _end_graphs(graphs) -> Optional[dict]:
    """The graph cache's stats (None without graphs), then the step graphs
    dropped: they read and write the run's trees by address."""
    if graphs is None:
        return None
    stats = graphs.stats()
    graphs.drop(STEP_KINDS)
    return stats


def resolve_cache(sd, tokenizer, data: str, batch: int = 8, flip: bool = False) -> str:
    """`data` is a prebuilt cache npz or a dataset directory; for a
    directory, build (or reuse) the configuration's cache beside its images.
    A cache older than any file of the directory is rebuilt."""
    if data.endswith(".npz"):
        if not os.path.exists(data):
            raise FileNotFoundError(f"latent cache not found: {data}")
        return data
    suffix = "_flip" if flip else ""
    cache = os.path.join(data, f"sdtpu_cache_{sd.config.name}{suffix}.npz")
    if os.path.exists(cache):
        newest = max(os.path.getmtime(os.path.join(data, f)) for f in os.listdir(data)
                     if not f.startswith("sdtpu_cache_"))
        if newest <= os.path.getmtime(cache):
            return cache
    build_latent_cache(sd, tokenizer, data, cache, batch=batch, flip=flip)
    return cache


def run_textual_inversion(
    sd,
    tokenizer,
    data_dir: str,
    out_path: str,
    *,
    placeholder: str = "<sks>",
    n_vectors: int = 1,
    init_token: Optional[str] = None,
    steps: int = 100,
    batch_size: int = 4,
    lr: float = 5e-3,
    compute_dtype=torch.float32,
    remat: bool | str = False,
    seed: int = 0,
    log_every: int = 10,
    log: Callable[[str], None] = print,
) -> dict:
    """Learn `n_vectors` new CLIP token-embedding rows for `placeholder`
    from the images in `data_dir` on sd's device; write an sdtpu-ti
    safetensors concept (`sample --concept`). The model is untouched: the
    rows are the only trained state, under plain Adam at `lr` (the
    standard recipe). Each step's batch is sdtpu's:
    np.random.default_rng(seed).choice(n, batch_size, replace=n <
    batch_size); its t and noise come from a torch.Generator seeded with
    `seed` on the device, and random initial rows (no init_token) from one
    seeded with seed + 1 (not sdtpu's draws).

    Returns {"steps", "final_loss", "losses", "out_path", "steps_per_sec",
    "graphs"} (graphs: the cache's stats, or None with the pipeline's
    graphs off).
    """
    if data_dir.endswith(".npz"):
        raise ValueError(
            "textual inversion needs the raw image directory (captions are "
            "re-tokenized with the placeholder), not a latent cache")
    cfg: StableDiffusionConfig = sd.config
    dev = sd.device
    with profiling.phase("ti_data", dev):
        latents, tokens, valid = prepare_ti_data(sd, tokenizer, data_dir,
                                                 placeholder=placeholder, n_vectors=n_vectors,
                                                 batch=min(8, max(batch_size, 1)))
    n = len(latents)
    log(f"dataset: {n} examples, placeholder {placeholder!r} x{n_vectors} vectors")
    init_id = None
    if init_token is not None:
        ids = tokenizer.encode(init_token)
        if len(ids) != 1:
            raise ValueError(f"init token {init_token!r} must be a single BPE token "
                             f"(got {len(ids)})")
        init_id = ids[0]
    new_emb = init_ti_embeddings(torch.Generator(device=dev).manual_seed(seed + 1),
                                 sd.params["clip"], n_vectors, init_id)
    new_emb = master_params(new_emb)
    opt = AdamW(lr)  # optax.adam(lr): no decay, no clip, no schedule
    opt_state = opt.init(new_emb)
    graphs = sd.graph_cache if getattr(sd, "graphs", False) else None
    step_fn = make_ti_train_step(cfg, opt, compute_dtype=compute_dtype, remat=remat,
                                 graphs=graphs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    losses = []
    t_start = time.perf_counter()
    try:
        for i in range(steps):
            idx = rng.choice(n, size=batch_size, replace=n < batch_size)
            batch = (torch.from_numpy(latents[idx]).to(dev),
                     torch.from_numpy(tokens[idx]).long().to(dev),
                     torch.from_numpy(valid[idx]).to(dev))
            new_emb, opt_state, loss = step_fn(new_emb, opt_state, sd.params, batch, gen)
            # the last step's loss is always kept, so final_loss means something
            # for any log_every, 0 included
            if (log_every and i % log_every == 0) or i + 1 == steps:
                loss_f = float(loss)
                losses.append((i, loss_f))
                if log_every:
                    log(f"step {i + 1}/{steps} loss {loss_f:.5f}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        graph_stats = _end_graphs(graphs)
    dt = time.perf_counter() - t_start

    if not out_path.endswith(".safetensors"):
        out_path = f"{out_path}.ti.safetensors"
    with profiling.phase("save_model"):
        save_ti(new_emb, out_path, placeholder, config_name=cfg.name)
    log(f"concept saved to {out_path}")
    return {
        "steps": steps,
        "final_loss": losses[-1][1] if losses else float("nan"),
        "losses": losses,
        "out_path": out_path,
        "steps_per_sec": steps / dt if dt > 0 else float("inf"),
        "graphs": graph_stats,
    }


def run_finetune(
    sd,
    tokenizer,
    data: str,
    out_model: str,
    *,
    steps: int = 100,
    batch_size: int = 4,
    accum: int = 1,
    accum_bf16: bool = False,
    lr: float = 1e-5,
    warmup_steps: int = 0,
    weight_decay: float = 1e-2,
    grad_clip: float = 1.0,
    opt_kind: str = "adamw",
    ema_decay: Optional[float] = None,
    lora_rank: Optional[int] = None,
    lora_alpha: Optional[float] = None,
    flip: bool = False,
    compute_dtype=torch.float32,
    remat: bool | str = False,
    tp: int = 1,
    seed: int = 0,
    save_every: int = 0,
    state_dir: Optional[str] = None,
    resume: bool = False,
    log_every: int = 10,
    log: Callable[[str], None] = print,
) -> dict:
    """Fine-tune `sd`'s UNet on `data` (an image folder or a cache npz) on
    sd's device; write `<out_model>.safetensors` (the EMA's weights when
    ema_decay is set).

    - accum > 1: each optimizer step averages the gradients of `accum`
      equal micro-batches, their running sum in f32, or in bf16 with
      accum_bf16 (which needs accum > 1). The loss logged at a step is the
      mean over its micro-batches.
    - opt_kind: "adamw" or "adafactor" (training.make_optimizer).
    - lora_rank: train a LoRA adapter over the attention linears of the f32
      unfused base instead of the UNet (lora_alpha defaults to the rank);
      writes `<out_model>.lora.safetensors` (the EMA's adapter with
      ema_decay) and the model merged against that base.
    - save_every with state_dir: the train state (io/checkpoint.py) saved
      every `save_every` optimizer steps; resume: start at the step saved
      in state_dir, under the flags it was saved with. The batches and the
      draws start again from the seed, as sdtpu's do.

    The step's t and noise come from a torch.Generator seeded with `seed`
    on the device, an adapter's initial `a` from one seeded with seed + 1
    (not sdtpu's draws); the batches from sdtpu's permutation of the cache.

    - tp: inside an initialised torch.distributed world, the mesh is the
      whole world, dp = world // tp (parallel.make_mesh, its errors), and
      each dp rank takes its slice of every batch; `sd` is each rank's
      pipeline on its own device, without a mesh (its whole tree, which
      every rank keeps). The masters, the optimizer state and the EMA are
      this rank's tp parts (a LoRA run: the adapter and its state whole,
      the frozen f32 base in parts, its whole copy dropped once they are
      made, the merged model gathered from the parts). Every rank returns the same result; rank 0 alone writes the
      cache, the model, the adapter and the train state, whose sharded
      leaves every rank gathers with it. Outside a world tp must be 1.

    Returns {"steps", "final_loss", "losses", "out_path", "lora_path",
    "steps_per_sec", "graphs"}; steps_per_sec counts the steps run since
    the resume; graphs: the graph cache's stats (the module docstring), or
    None where the steps ran eagerly (the pipeline's graphs off, or a
    mesh).
    """
    cfg: StableDiffusionConfig = sd.config
    mesh = None
    if getattr(sd, "mesh", None) is not None:
        raise ValueError("run_finetune takes a pipeline without a mesh (its whole tree)")
    if dist.is_initialized():
        mesh = make_mesh(tp=tp, device=sd.device)
        if (batch_size // accum) % mesh.dp:
            raise ValueError(
                f"micro-batch {batch_size}//{accum} must be divisible by "
                f"dp={mesh.dp} on a {mesh.world}-device backend")
        if mesh.rank:
            log = _quiet
        log(f"mesh: dp={mesh.dp} tp={mesh.tp} ({mesh.backend})")
    elif tp != 1:
        raise ValueError(f"tp={tp} needs an initialised torch.distributed world "
                         "(torchrun, or parallel.launch.spawn)")
    writer = mesh is None or mesh.rank == 0
    if batch_size % accum:
        raise ValueError(f"batch_size {batch_size} not divisible by accum {accum}")
    if accum_bf16 and accum <= 1:
        # there is no running gradient sum to keep in bf16
        raise ValueError("--accum-bf16 has no effect without --accum k>1")
    accum_dtype = torch.bfloat16 if accum_bf16 else None
    with profiling.phase("latent_cache", sd.device):
        if writer:
            cache = resolve_cache(sd, tokenizer, data, batch=min(8, batch_size), flip=flip)
        if mesh is not None:
            dist.barrier()
        if not writer:  # the cache rank 0 has just made (or found)
            cache = resolve_cache(sd, tokenizer, data, batch=min(8, batch_size), flip=flip)
    latents, contexts, n_valid = load_latent_cache(cache)
    log(f"dataset: {len(latents)} examples from {cache}")

    # f32 master copies of sdtpu's UNet tree (the fused attn1.qkv leaves
    # dropped); a LoRA run keeps it frozen, by reference where it is f32
    base = unfuse_qkv(sd.params["unet"])
    opt = make_optimizer(lr=lr, warmup_steps=warmup_steps, total_steps=steps,
                         weight_decay=weight_decay, grad_clip=grad_clip, kind=opt_kind)
    alpha, layout, base_layout = None, None, None
    graphs = sd.graph_cache if getattr(sd, "graphs", False) and mesh is None else None
    if lora_rank:
        base = tree_map(lambda p: p.float() if torch.is_tensor(p) else p, base)
        alpha = float(lora_alpha if lora_alpha is not None else lora_rank)
        train_tree = master_params(init_lora(
            torch.Generator(device=sd.device).manual_seed(seed + 1), base, rank=lora_rank))
        log(f"LoRA rank {lora_rank} alpha {alpha:g}: "
            f"{lora_param_count(train_tree) / 1e6:.2f}M adapter params")
        lora_step = make_lora_train_step(cfg, opt, alpha / lora_rank,
                                         compute_dtype=compute_dtype, remat=remat, accum=accum,
                                         accum_dtype=accum_dtype, mesh=mesh,
                                         ema_decay=ema_decay, graphs=graphs)
        # the frozen base as tp parts; its whole f32 copy goes (sd's own
        # tree stays whole), and the final merge runs on the parts
        base_parts, base_layout = shard_params(base, mesh), tp_layout(base, mesh)
        del base

        def step_fn(tree, state, ema, batch, gen):
            if ema is None:
                return lora_step(tree, state, base_parts, batch, gen)[-1]
            return lora_step(tree, state, ema, base_parts, batch, gen)[-1]
    else:
        train_tree, layout = master_params(base, mesh), tp_layout(base, mesh)
        full_step = make_train_step(cfg, opt, compute_dtype=compute_dtype, remat=remat,
                                    accum=accum, accum_dtype=accum_dtype, mesh=mesh,
                                    ema_decay=ema_decay, graphs=graphs)

        def step_fn(tree, state, ema, batch, gen):
            if ema is None:
                return full_step(tree, state, batch, gen)[-1]
            return full_step(tree, state, ema, batch, gen)[-1]
    opt_state = opt.init(train_tree, layout)
    # the EMA shadow, updated at the end of each optimizer step; what the run
    # saves
    ema = None if ema_decay is None else tree_map(lambda p: p.detach().clone(), train_tree)
    flags = {"opt_kind": opt_kind, "accum": accum, "accum_bf16": accum_bf16,
             "lora_rank": lora_rank or None, "lora_alpha": alpha, "ema": ema is not None}

    step0 = 0
    if resume:
        if not (state_dir and os.path.isdir(state_dir)):
            raise FileNotFoundError(f"--resume: no train state at {state_dir!r}")
        try:
            with profiling.phase("restore_train_state", sd.device):
                step0 = restore_train_state(state_dir, train_tree, opt_state, ema=ema,
                                            flags=flags)
        except (ValueError, KeyError, TypeError) as e:
            raise RuntimeError(
                f"--resume: failed to restore train state at {state_dir!r} "
                f"[{type(e).__name__}: {e}]. If these flags (accum={accum}, "
                f"accum_bf16={accum_bf16}, opt={opt_kind}, lora_rank={lora_rank}, "
                f"lora_alpha={alpha}, ema={ema is not None}) differ from the ones the state "
                f"was saved under, resume with the original flags or restart from the model "
                f"checkpoint; if they match, the saved state is likely incomplete or "
                f"corrupt.") from e
        log(f"resumed step {step0} from {state_dir}")

    gen = torch.Generator(device=sd.device).manual_seed(seed)
    batches = LatentBatches(latents, contexts, n_valid, batch_size=batch_size, seed=seed,
                            device=sd.device,
                            shard=None if mesh is None else (mesh.dp_rank, mesh.dp))
    losses = []
    t_start = time.perf_counter()
    try:
        for i in range(step0, steps):
            loss = step_fn(train_tree, opt_state, ema, next(batches), gen)
            if log_every and (i % log_every == 0 or i + 1 == steps):
                loss_f = float(loss)  # waits for the step; cadence bounded by log_every
                losses.append((i, loss_f))
                log(f"step {i + 1}/{steps} loss {loss_f:.5f}")
            if save_every and state_dir and (i + 1) % save_every == 0:
                with profiling.phase("save_train_state", sd.device):
                    save_train_state(state_dir, train_tree, opt_state, i + 1, ema=ema,
                                     flags=flags, write=writer)
                log(f"train state saved at step {i + 1} -> {state_dir}")
        if sd.device.type == "cuda":
            torch.cuda.synchronize(sd.device)
    finally:
        batches.close()
        graph_stats = _end_graphs(graphs)
    dt = time.perf_counter() - t_start

    # the sharded leaves gathered whole (every rank of the tp group takes part)
    final_tree = whole_tree(ema if ema is not None else train_tree, layout, keep=writer)
    out_path = out_model if out_model.endswith(".safetensors") else f"{out_model}.safetensors"
    lora_path = None
    full = dict(sd.params)
    if lora_rank:
        lora_path = out_path.replace(".safetensors", ".lora.safetensors")
        # the merge on each rank's parts (the adapter is whole everywhere),
        # then gathered
        with torch.no_grad(), tpc.use(tpc.of_mesh(mesh)):
            merged = apply_lora(base_parts, ema if ema is not None else train_tree,
                                alpha / lora_rank)
        full["unet"] = whole_tree(merged, base_layout, keep=writer)
        del merged
    with profiling.phase("save_model", sd.device):
        if writer:
            if lora_rank:
                save_lora(final_tree, lora_path, rank=lora_rank, alpha=alpha,
                          config_name=cfg.name)
                log(f"adapter saved to {lora_path}")
            else:
                full["unet"] = final_tree
            save_native(full, out_path, cfg)
        if mesh is not None:
            dist.barrier()  # the files are there when any rank returns
    log(f"model saved to {out_path}")
    return {
        "steps": steps,
        "final_loss": losses[-1][1] if losses else float("nan"),
        "losses": losses,
        "out_path": out_path,
        "lora_path": lora_path,
        "steps_per_sec": max(steps - step0, 1) / dt if dt > 0 else float("inf"),
        "graphs": graph_stats,
    }


if __name__ == "__main__":
    from sdtpu_torch.cli import finetune_main

    finetune_main()
