"""Fine-tuning the UNet end to end: image folder -> latent cache -> train ->
model (port of sdtpu/finetune.py: resolve_cache and run_finetune, on one
device).

    dataset.build_latent_cache  (the port's VAE encoder and CLIP, once)
    dataset.LatentBatches       (shuffled batches, staged by a thread)
    training.make_train_step    (the loss inside dispatch.training(): K1
                                 forward and K9 backward in the attention at
                                 the 64² level, plain PyTorch elsewhere)
    io.native.save_native       (the tuned model, sdtpu's format)

Only the UNet trains (CLIP and the VAE stay frozen, the split the latent
cache bakes in), from f32 master copies of sdtpu's UNet tree: the pipeline's
tree without the fused attn1.qkv leaves (models/unet.py:unfuse_qkv), so the
saved model holds sdtpu's keys and nothing else. sdtpu's options that the
port does not carry yet raise NotImplementedError and name their ROADMAP
item; none is ignored.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from sdtpu_torch.config import StableDiffusionConfig
from sdtpu_torch.dataset import LatentBatches, build_latent_cache, load_latent_cache
from sdtpu_torch.io.native import save_native
from sdtpu_torch.models.unet import unfuse_qkv
from sdtpu_torch.training import (ema_update, make_optimizer, make_train_step, master_params,
                                  tree_map)


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


def _refuse_unported(lora_rank, opt_kind, accum_bf16, state_dir, resume, save_every, tp):
    """sdtpu's options the port does not carry yet: raise, never ignore."""
    unported = []
    if lora_rank:
        unported.append("lora_rank (LoRA: ROADMAP queue 1, item 14)")
    if opt_kind == "adafactor":
        unported.append("opt_kind='adafactor' (ROADMAP queue 1, item 14)")
    if accum_bf16:
        unported.append("accum_bf16 (training.multi_steps: ROADMAP queue 1, item 14)")
    if state_dir or resume or save_every:
        unported.append("state_dir/resume/save_every (train-state resume, io/checkpoint.py: "
                        "ROADMAP queue 1, item 14)")
    if tp != 1:
        unported.append("tp (parallel/: ROADMAP queue 1, item 15)")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported))


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
    sd's device; write `<out_model>.safetensors`. accum > 1: each optimizer
    step averages the gradients of `accum` equal micro-batches in f32. The
    step's t and noise come from a torch.Generator seeded with `seed` on
    the device (not sdtpu's draws); the batches from sdtpu's permutation of
    the cache. lora_alpha matters only with LoRA.

    Returns {"steps", "final_loss", "losses", "out_path", "steps_per_sec"}.
    """
    _refuse_unported(lora_rank, opt_kind, accum_bf16, state_dir, resume, save_every, tp)
    cfg: StableDiffusionConfig = sd.config
    if batch_size % accum:
        raise ValueError(f"batch_size {batch_size} not divisible by accum {accum}")
    cache = resolve_cache(sd, tokenizer, data, batch=min(8, batch_size), flip=flip)
    latents, contexts, n_valid = load_latent_cache(cache)
    log(f"dataset: {len(latents)} examples from {cache}")

    params = master_params(unfuse_qkv(sd.params["unet"]))
    opt = make_optimizer(lr=lr, warmup_steps=warmup_steps, total_steps=steps,
                         weight_decay=weight_decay, grad_clip=grad_clip, kind=opt_kind)
    opt_state = opt.init(params)
    # the EMA shadow, updated at each optimizer step (sdtpu applies it on the
    # host at the step boundary); it is what the model saves when kept
    ema = None if ema_decay is None else tree_map(lambda p: p.detach().clone(), params)
    step_fn = make_train_step(cfg, opt, compute_dtype=compute_dtype, remat=remat, accum=accum)
    gen = torch.Generator(device=sd.device).manual_seed(seed)

    batches = LatentBatches(latents, contexts, n_valid, batch_size=batch_size, seed=seed,
                            device=sd.device)
    losses = []
    t_start = time.perf_counter()
    try:
        for i in range(steps):
            params, opt_state, loss = step_fn(params, opt_state, next(batches), gen)
            if ema is not None:
                ema_update(ema, params, ema_decay)
            if log_every and (i % log_every == 0 or i + 1 == steps):
                loss_f = float(loss)  # waits for the step; cadence bounded by log_every
                losses.append((i, loss_f))
                log(f"step {i + 1}/{steps} loss {loss_f:.5f}")
        if sd.device.type == "cuda":
            torch.cuda.synchronize(sd.device)
    finally:
        batches.close()
    dt = time.perf_counter() - t_start

    out_path = out_model if out_model.endswith(".safetensors") else f"{out_model}.safetensors"
    full = dict(sd.params)
    full["unet"] = ema if ema is not None else params
    save_native(full, out_path, cfg)
    log(f"model saved to {out_path}")
    return {
        "steps": steps,
        "final_loss": losses[-1][1] if losses else float("nan"),
        "losses": losses,
        "out_path": out_path,
        "steps_per_sec": steps / dt if dt > 0 else float("inf"),
    }
