"""dryrun_multichip(n): the port's counterpart of sdtpu's
__graft_entry__.py:dryrun_multichip, one pass over everything that runs on
a ("dp", "tp") mesh, at SD_TINY, on the n ranks of a world the caller has
set up (parallel.spawn, torchrun):

- two micro-batches of AdamW (optax.adamw(1e-4)'s decay) under remat
  "heavy" with the bf16 gradient accumulator, so that both the accumulate
  and the update branch run, on masters and state held as tp parts;
- one LoRA step on the same mesh (the adapter whole, the base in parts);
- dp-sharded DDIM and Euler sampling of 2 steps, held to one process's
  result (sdtpu's tolerance on the CPU, TOL["cuda"] on a card);
- one batch through serve.Batcher on the mesh.

tp = 2 where n >= 4 and n is even, else 1. Rank 0 prints sdtpu's summary
line. Under torchrun:

    torchrun --nproc-per-node 4 -m sdtpu_torch.parallel.dryrun --backend gloo [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# (rtol, atol) of the dp-sharded latents against one process's: sdtpu's on
# the CPU (tests/test_parallel.py); on a card, TF32 off, cuDNN and cuBLAS
# pick other kernels at the rank's batch than at the whole batch's
TOL = {"cpu": (1e-5, 2e-4), "cuda": (1e-4, 2e-3)}


def dryrun_multichip(n: int, device=None) -> Optional[str]:
    """Run the dry run on this rank of an n-rank world (every rank calls
    it); device: this rank's (None: its card, parallel.local_device).
    Returns the summary line on rank 0, None on the others; raises where a
    check fails."""
    from sdtpu_torch.config import SD_TINY
    from sdtpu_torch.lora import init_lora, make_lora_train_step
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.parallel.launch import local_device
    from sdtpu_torch.parallel.mesh import make_mesh
    from sdtpu_torch.parallel.sharding import shard_batch
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.serve import Batcher
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.training import (AdamW, make_train_step, master_params, tp_layout,
                                      tree_map, whole_tree)
    from sdtpu_torch.weights import init_params

    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"dryrun_multichip({n}) needs an initialised world of {n} ranks")
    dev = torch.device(device) if device is not None else local_device()
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(dp=n // tp, tp=tp, device=dev)
    dp, cfg = mesh.dp, SD_TINY

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params = init_params(cfg, seeded(0), device=dev)
    host = torch.Generator().manual_seed(1)

    def normal(*shape):  # the same draw on every rank
        return torch.randn(shape, generator=host).to(dev)

    # ---- the training step: two micro-batches (the accumulate and the
    # update branch), remat "heavy", the running sum in bf16
    unet = unfuse_qkv(params["unet"])
    masters, layout = master_params(unet, mesh), tp_layout(unet, mesh)
    opt = AdamW(1e-4, weight_decay=1e-4)
    state = opt.init(masters, layout)
    step = make_train_step(cfg, opt, remat="heavy", accum=2, accum_dtype=torch.bfloat16,
                           mesh=mesh)
    b = -(-max(n, 8) // dp) * dp  # a micro-batch, a multiple of dp
    latents, context = normal(2 * b, 16, 16, 4), normal(2 * b, 7, cfg.unet.context_dim)
    masters, state, loss = step(masters, state, (shard_batch(latents, mesh),
                                                 shard_batch(context, mesh)), seeded(3))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite training loss {loss}")
    if state.count != 1:
        raise RuntimeError(f"the optimizer made {state.count} updates, expected 1")
    trained = whole_tree(masters, layout)

    # ---- one LoRA step on the same mesh: the adapter whole, the base in parts
    lora = master_params(init_lora(seeded(7), trained, rank=2))
    lopt = AdamW(1e-3)
    lstep = make_lora_train_step(cfg, lopt, 1.0, mesh=mesh)
    base = tree_map(lambda p: p.detach(), masters)
    lora, _, lora_loss = lstep(lora, lopt.init(lora), base, (
        shard_batch(latents[:b], mesh), shard_batch(context[:b], mesh)), seeded(8))
    lora_loss = float(lora_loss)
    if not np.isfinite(lora_loss):
        raise RuntimeError(f"non-finite LoRA loss {lora_loss}")

    # ---- dp-sharded sampling (batched CFG, 2 steps) against one process
    params = {**params, "unet": tree_map(lambda p: p.detach(), trained)}
    sd_single = StableDiffusion(params, cfg)
    sd = StableDiffusion(params, cfg, mesh=mesh)
    ctx, unctx = normal(dp, 77, cfg.unet.context_dim), normal(1, 77, cfg.unet.context_dim)
    valid, unvalid = torch.ones((dp, 77), dtype=torch.bool, device=dev), torch.ones(
        (1, 77), dtype=torch.bool, device=dev)
    lat0 = normal(dp, 16, 16, 4)
    rtol, atol = TOL[dev.type]
    results, worst = {}, 0.0
    with torch.no_grad():
        for sampler in ("ddim", "euler"):  # one DDIM and one of the Karras family
            want = sd_single.sample_latent(ctx, unctx, 7.5, 2, initial_latent=lat0,
                                           ctx_valid=valid, uncond_valid=unvalid,
                                           sampler=sampler)
            got = sd.sample_latent(ctx, unctx, 7.5, 2, initial_latent=lat0, ctx_valid=valid,
                                   uncond_valid=unvalid, sampler=sampler)
            worst = max(worst, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda m, s=sampler: f"dp-sharded {s} != "
                                       f"single-device: {m}")
            results[sampler] = tuple(got.shape)
    del sd_single

    # ---- one batch through the serving micro-batcher on the mesh
    batcher = Batcher(sd, SimpleTokenizer(), max_batch=dp, window_ms=5.0, timeout_s=900.0)
    shape = None
    try:
        if mesh.rank == 0:
            imgs = batcher.submit("a mossy stone", steps=2, scale=5.0, seed=1, n_images=dp,
                                  negative="", sampler="ddim")
            if imgs.dtype != np.uint8 or imgs.shape[0] != dp:
                raise RuntimeError(f"the batcher gave {imgs.dtype} {imgs.shape}")
            shape = tuple(imgs.shape)
    finally:
        batcher.close(timeout=900.0)
    if mesh.rank != 0:
        return None
    line = (f"dryrun_multichip OK: mesh dp={dp} tp={tp}, train loss {loss:.4f}, LoRA step "
            f"loss {lora_loss:.4f}; dp-vs-single EQUAL (rtol {rtol:g}, atol {atol:g}; max "
            f"|difference| {worst:.3g}) for {sorted(results)}; serve micro-batcher produced "
            f"{shape} uint8 on the mesh")
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    """`torchrun ... -m sdtpu_torch.parallel.dryrun --backend B [--device cpu]`."""
    import argparse

    from sdtpu_torch.parallel.launch import init_from_env

    ap = argparse.ArgumentParser(prog="python -m sdtpu_torch.parallel.dryrun")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu for the host (default: this rank's card)")
    args = ap.parse_args(argv)
    _, world = init_from_env(args.backend)
    try:
        dryrun_multichip(world, args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
