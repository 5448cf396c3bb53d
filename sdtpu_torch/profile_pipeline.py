"""Where the time of an image, or of a fine-tuning step, goes on one NVIDIA
GPU.

    python -m sdtpu_torch.profile_pipeline [--preset P] [--size 512|768|1024] [--out FILE]
        [--repeats N]
    python -m sdtpu_torch.profile_pipeline --train [--preset P] [--out FILE] [--repeats N]

Builds the preset's model (sd-v1-4 by default; sd-v2-1 is SD v2.1-768) at
full width with random weights (seeded), bf16, at the given image size (the
same config with image_size set; the preset's own size by default: 512 for
sd-v1-4, 768 for sd-v2-1), and measures, after warm-up:

1. `generate` (20 DDIM steps, CFG 7.5 batched, batch 1) N + 1 times
   eagerly (StableDiffusion(..., graphs=False)) and N + 1 times replayed
   from CUDA graphs (graphs=True, the default on the card; its first run
   captures), over the same weights: the wall seconds of encode_prompt /
   denoise / decode of each run, and the means of the last N per image;
2. one UNet call (batch 2, the batched CFG pair) and one VAE decode, each
   also with its fused ResBlock gates closed (sdtpu's unfused branch:
   cuDNN convolutions between GroupNorm+SiLU passes; the UNet's gate only
   matters from 128x128 latents, 1024px, on): the mean wall time of N
   calls (host clock, synchronised), and the device kernel time of one
   call under torch.profiler, with its largest items;
3. the same UNet call replayed from a CUDA graph (graphs.GraphCache), and
   its largest difference from the eager output; the 20-step denoise and
   the decode replayed, each the mean wall of N calls and the device kernel
   time of one under torch.profiler (busy share: device over wall); each
   graph's capture seconds and the bytes it added to the shared pool.

With --train it measures instead a training step of the whole UNet at the
image size (training.make_train_step: batch 4 of random latents and
contexts with a key mask, bf16 compute, f32 masters, AdamW, the EMA in the
step, the preset's prediction target) for remat off, "full" and "dots",
replayed from its CUDA graph (sdtpu's step_jit) and eager, on the same
trees, in the turns replayed, eager, eager, replayed: the mean wall ms of
N warm steps a turn (host clock, synchronised; each turn's first call is
not timed: the replayed first turn's is the eager step and the capture),
the peak reserved device memory over each mode's warm steps (the
allocator's cache emptied before each turn; the replayed step's graph
pool included, and taken out of the eager step's, which does not use it),
the device kernel time of one profiled step with its largest items
(busy share: device over wall), and the graph's capture seconds, the bytes
it added to the pool and those it took outside it.

The report starts with the card's name and power limit, and goes to
stdout and, with --out, to FILE as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import Optional

import torch

from sdtpu_torch import graphs
from sdtpu_torch.config import PRESETS
from sdtpu_torch.models import unet as unet_model
from sdtpu_torch.models import vae as vae_model
from sdtpu_torch.models.unet import unet_apply
from sdtpu_torch.ops import conv
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.tokenizer import SimpleTokenizer
from sdtpu_torch.weights import init_params

PROMPT = "An ancient mossy stone."


def _wall_ms(fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeats


def device_profile(fn, top: Optional[int]):
    """(device ms of one call of fn, its first `top` [(name, ms, launches)],
    largest first; all with None): fn is called twice, and the second call
    profiled. The profiler's rows with device time and no CPU time of their
    own are the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def _train(sd, dev, args, say) -> None:
    """The --train report (see the module docstring)."""
    from sdtpu_torch.finetune import STEP_KINDS
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.training import make_optimizer, make_train_step, master_params, tree_map

    g = torch.Generator(device=dev).manual_seed(2)
    cfg = sd.config
    b, hw = 4, cfg.latent_size
    batch = (torch.randn((b, hw, hw, 4), generator=g, device=dev),
             torch.randn((b, cfg.clip.n_ctx, cfg.clip.n_state), generator=g, device=dev),
             torch.arange(cfg.clip.n_ctx, device=dev)[None, :] < torch.tensor(
                 [[2], [9], [20], [77]], device=dev))
    for remat in (False, "full", "dots"):
        params = master_params(unfuse_qkv(sd.params["unet"]))
        ema = tree_map(lambda p: p.detach().clone(), params)
        opt = make_optimizer(lr=1e-5, warmup_steps=0, total_steps=100 * (args.repeats + 2))
        state = opt.init(params)
        cache = graphs.GraphCache(dev)
        # the same trees under both: the graph reads and writes them by address
        steps = {mode: make_train_step(cfg, opt, compute_dtype=torch.bfloat16, remat=remat,
                                       ema_decay=0.9999, graphs=c)
                 for mode, c in (("replayed", cache), ("eager", None))}
        walls, reserved = {m: [] for m in steps}, {m: 0.0 for m in steps}
        for mode in ("replayed", "eager", "eager", "replayed"):
            def one(step=steps[mode]):
                step(params, state, ema, batch, g)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the other mode's cached blocks
            one()  # the replayed first turn's: the eager step, then the capture
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            walls[mode].append(_wall_ms(one, args.repeats))
            # the turn's warm steps: an eager step's blocks, or the trees and
            # the graph's pool; the pool is not an eager step's own
            own = torch.cuda.max_memory_reserved(dev) - (
                cache.pool_bytes() if mode == "eager" else 0)
            reserved[mode] = max(reserved[mode], own / 1024 ** 3)
        (graph,) = cache.stats()["graphs"]
        for mode, step in steps.items():
            dev_ms, top = device_profile(lambda: step(params, state, ema, batch, g), args.top)
            wall = sum(walls[mode]) / len(walls[mode])
            captured = (f"; captured in {graph['capture_s']:.3f} s, {graph['pool_bytes']} "
                        f"bytes added to the pool, {graph['exec_bytes']} bytes outside it, "
                        f"{graph['launches']} kernel launches a replay"
                        if mode == "replayed" else "")
            say(f"4. train step remat={remat!r} {mode} ({cfg.name} UNet, {cfg.image_size}px, "
                f"batch {b}, bf16, AdamW, EMA): wall {wall:.3f} ms (turns "
                f"{', '.join(f'{w:.3f}' for w in walls[mode])}, each the mean of "
                f"{args.repeats}); peak reserved over its warm steps {reserved[mode]:.2f} GiB "
                f"(the replayed step's pool included, the eager step's without it); device "
                f"kernels {dev_ms:.3f} ms in one profiled step, busy share {dev_ms / wall:.3f}"
                f"{captured}")
            for key, ms, n in top:
                say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")
        cache.drop(STEP_KINDS)
        del state, opt, params, ema, steps, cache
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="sd-v1-4",
                    help="the model (default sd-v1-4)")
    ap.add_argument("--size", type=int, choices=(512, 768, 1024), default=None,
                    help="image size (default: the preset's, 512 or 768)")
    ap.add_argument("--train", action="store_true",
                    help="profile a fine-tuning step instead of generate")
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the port on a GPU")
    lines = []

    def say(msg=""):
        print(msg, flush=True)
        lines.append(msg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    say(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    preset = PRESETS[args.preset]
    size = args.size or preset.image_size
    cfg_sd = dataclasses.replace(preset, image_size=size)
    params = init_params(cfg_sd, torch.Generator(device=dev).manual_seed(0), device=dev)
    sd = StableDiffusion(params, cfg_sd, compute_dtype=torch.bfloat16)
    tok = SimpleTokenizer()
    hw = cfg_sd.latent_size
    if args.train:
        del params
        _train(sd, dev, args, say)
        _write(args.out, lines)
        return
    sd_eager = StableDiffusion(params, cfg_sd, compute_dtype=torch.bfloat16, graphs=False)
    del params

    for label, pipe in (("eager", sd_eager), ("replayed from CUDA graphs", sd)):
        say(f"1. generate {cfg_sd.name} {size}x{size} bf16, 20 DDIM steps, CFG 7.5, batch 1, "
            f"{label} ({args.repeats + 1} runs, the first includes first-call costs)")
        warm = {"denoise": [], "decode": []}
        for i in range(args.repeats + 1):
            t0 = time.perf_counter()
            pipe.generate(tok, PROMPT, 7.5, 20,
                          generator=torch.Generator(device=dev).manual_seed(i))
            tm = pipe.timings
            say(f"   run {i}: wall {time.perf_counter() - t0:.4f} s = encode_prompt "
                f"{tm['encode_prompt']:.4f} + denoise {tm['denoise']:.4f} + decode "
                f"{tm['decode']:.4f}")
            if i:
                for name in warm:
                    warm[name].append(tm[name])
        say(f"   {label}: per image, mean of runs 1-{args.repeats}: denoise "
            f"{sum(warm['denoise']) / args.repeats:.4f} s, decode "
            f"{sum(warm['decode']) / args.repeats:.4f} s")

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, hw, hw, 4), generator=g, device=dev).to(torch.bfloat16)
    ctx, valid = sd.context(tok, PROMPT)
    unctx, unvalid = sd.context(tok, "")
    ctx2, valid2 = torch.cat([unctx, ctx]), torch.cat([unvalid, valid])
    t = torch.tensor([481.0], device=dev)  # on the device, so a graph can hold it
    unet, cfg = sd.params["unet"], cfg_sd.unet
    z = torch.randn((1, hw, hw, 4), generator=g, device=dev).to(torch.bfloat16)
    vae = sd.params["autoencoder"]

    def unet_call():
        return unet_apply(unet, x, t, ctx2, cfg, ctx_valid=valid2)

    def unet_unfused_call():
        gate = unet_model.FUSED_RES_MIN_ROWS
        unet_model.FUSED_RES_MIN_ROWS = 1 << 30
        try:
            return unet_call()
        finally:
            unet_model.FUSED_RES_MIN_ROWS = gate

    def decode_call():
        return vae_model.decode_latent(vae, z, cfg_sd.vae, sd.vae_phases)

    def decode_unfused_call():
        gates = vae_model.FUSED_CONV_MIN_ROWS, conv.FUSED_UP_MIN_ROWS
        vae_model.FUSED_CONV_MIN_ROWS = conv.FUSED_UP_MIN_ROWS = 1 << 30
        try:
            return decode_call()
        finally:
            vae_model.FUSED_CONV_MIN_ROWS, conv.FUSED_UP_MIN_ROWS = gates

    calls = [("UNet call (batch 2)", unet_call)]
    if hw * hw >= unet_model.FUSED_RES_MIN_ROWS:
        calls.append(("UNet call, fused ResBlock gate closed", unet_unfused_call))
    calls += [(f"VAE decode ({hw}x{hw} latent)", decode_call),
              ("VAE decode, fused gates closed", decode_unfused_call)]
    for name, fn in calls:
        wall = _wall_ms(fn, args.repeats)
        dev_ms, top = device_profile(fn, args.top)
        say(f"2. {name}: wall {wall:.3f} ms (mean of {args.repeats}); device kernels "
            f"{dev_ms:.3f} ms in one profiled call, busy share {dev_ms / wall:.3f}")
        for key, ms, n in top:
            say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")

    eager = unet_call()
    cache = sd.graph_cache
    inputs = {"x": x, "t": t, "ctx": ctx2, "valid": valid2}

    def unet_program(inp):
        return unet_apply(unet, inp["x"], inp["t"], inp["ctx"], cfg, ctx_valid=inp["valid"])

    ug = cache.ensure(graphs.Program("unet", {"config": cfg_sd}, inputs, unet_program, (unet,),
                                     graphs.UNET_GATES))
    replay_ms = _wall_ms(ug.graph.replay, args.repeats)
    diff = float((ug.output.float() - eager.float()).abs().max())
    say(f"3. UNet call replayed from a CUDA graph: wall {replay_ms:.3f} ms (mean of "
        f"{args.repeats}); max |graph - eager| {diff:.3e}")
    lat = torch.randn((1, hw, hw, 4), generator=g, device=dev)

    def denoise():
        return sd.sample_latent(ctx, unctx, 7.5, 20, initial_latent=lat, ctx_valid=valid,
                                uncond_valid=unvalid)

    def decode():
        return sd._decode_u8(lat)

    for name, fn in (("denoise, 20 DDIM steps", denoise), ("decode", decode)):
        wall = _wall_ms(fn, args.repeats)
        dev_ms, top = device_profile(fn, args.top)
        busy = f"{dev_ms / wall:.3f}" if dev_ms else "not measured (no device rows)"
        say(f"3. {name} replayed: wall {wall:.3f} ms (mean of {args.repeats}); device "
            f"kernels {dev_ms:.3f} ms in one profiled call, busy share {busy}")
        for key, ms, n in top[:4]:
            say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")
    for st in cache.stats()["graphs"]:
        say(f"3. graph {st['kind']} {st['inputs']}: captured in {st['capture_s']:.3f} s, "
            f"{st['pool_bytes']} bytes added to the pool, {st['replays']} replays, "
            f"{st['launches']} kernel launches a replay")
    say(f"3. the graphs' shared pool: {cache.pool_bytes()} bytes")

    _write(args.out, lines)


def _write(path, lines) -> None:
    if path:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
