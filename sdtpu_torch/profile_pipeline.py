"""Where the time of an image, or of a fine-tuning step, goes on one NVIDIA
GPU.

    python -m sdtpu_torch.profile_pipeline [--preset P] [--size 512|768|1024] [--out FILE]
        [--repeats N]
    python -m sdtpu_torch.profile_pipeline --train [--preset P] [--out FILE] [--repeats N]

Builds the preset's model (sd-v1-4 by default; sd-v2-1 is SD v2.1-768) at
full width with random weights (seeded), bf16, at the given image size (the
same config with image_size set; the preset's own size by default: 512 for
sd-v1-4, 768 for sd-v2-1), and measures, after warm-up:

1. `generate` (20 DDIM steps, CFG 7.5 batched, batch 1) N times: the wall
   seconds of encode_prompt / denoise / decode of each run;
2. one UNet call (batch 2, the batched CFG pair) and one VAE decode, each
   also with its fused ResBlock gates closed (sdtpu's unfused branch:
   cuDNN convolutions between GroupNorm+SiLU passes; the UNet's gate only
   matters from 128x128 latents, 1024px, on): the mean wall time of N
   calls (host clock, synchronised), and the device kernel time of one
   call under torch.profiler, with its largest items;
3. the same UNet call replayed from a CUDA graph, and its largest
   difference from the eager output.

With --train it measures instead a training step of the whole UNet at the
image size (training.make_train_step: batch 4 of random latents and
contexts with a key mask, bf16 compute, f32 masters, AdamW, the preset's
prediction target) for remat off,
"full" and "dots": the mean wall ms of N warm steps (host clock,
synchronised), the peak memory of a step, and the device kernel time of
one profiled step with its largest items.

The report starts with the card's name and power limit, and goes to
stdout and, with --out, to FILE as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch

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


def _device_profile(fn, top: int):
    """(device ms of one call of fn, [(name, ms, launches)] largest first):
    the profiler's rows with device time and no CPU time of their own are
    the kernels."""
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
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.training import make_optimizer, make_train_step, master_params

    g = torch.Generator(device=dev).manual_seed(2)
    cfg = sd.config
    b, hw = 4, cfg.latent_size
    batch = (torch.randn((b, hw, hw, 4), generator=g, device=dev),
             torch.randn((b, cfg.clip.n_ctx, cfg.clip.n_state), generator=g, device=dev),
             torch.arange(cfg.clip.n_ctx, device=dev)[None, :] < torch.tensor(
                 [[2], [9], [20], [77]], device=dev))
    params = master_params(unfuse_qkv(sd.params["unet"]))
    for remat in (False, "full", "dots"):
        opt = make_optimizer(lr=1e-5, warmup_steps=0, total_steps=10 * (args.repeats + 2))
        state = opt.init(params)
        step = make_train_step(cfg, opt, compute_dtype=torch.bfloat16, remat=remat)

        def one():
            step(params, state, batch, g)

        torch.cuda.reset_peak_memory_stats(dev)
        wall = _wall_ms(one, args.repeats)
        peak = torch.cuda.max_memory_allocated(dev) / 1024 ** 3
        dev_ms, top = _device_profile(one, args.top)
        say(f"4. train step remat={remat!r} ({cfg.name} UNet, {cfg.image_size}px, batch {b}, "
            f"bf16, AdamW): "
            f"wall {wall:.3f} ms (mean of {args.repeats}); peak memory {peak:.2f} GiB; device "
            f"kernels {dev_ms:.3f} ms in one profiled step, busy share {dev_ms / wall:.3f}")
        for key, ms, n in top:
            say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")
        del state, opt


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
    sd = StableDiffusion(init_params(cfg_sd, torch.Generator(device=dev).manual_seed(0),
                                     device=dev), cfg_sd, compute_dtype=torch.bfloat16)
    tok = SimpleTokenizer()
    hw = cfg_sd.latent_size
    if args.train:
        _train(sd, dev, args, say)
        _write(args.out, lines)
        return

    say(f"1. generate {cfg_sd.name} {size}x{size} bf16, 20 DDIM steps, CFG 7.5, batch 1 "
        f"({args.repeats + 1} runs, the first includes first-call costs)")
    for i in range(args.repeats + 1):
        t0 = time.perf_counter()
        sd.generate(tok, PROMPT, 7.5, 20, generator=torch.Generator(device=dev).manual_seed(i))
        tm = sd.timings
        say(f"   run {i}: wall {time.perf_counter() - t0:.4f} s = encode_prompt "
            f"{tm['encode_prompt']:.4f} + denoise {tm['denoise']:.4f} + decode "
            f"{tm['decode']:.4f}")

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
        dev_ms, top = _device_profile(fn, args.top)
        say(f"2. {name}: wall {wall:.3f} ms (mean of {args.repeats}); device kernels "
            f"{dev_ms:.3f} ms in one profiled call, busy share {dev_ms / wall:.3f}")
        for key, ms, n in top:
            say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")

    eager = unet_call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        unet_call()  # warm the allocator on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = unet_call()
    replay_ms = _wall_ms(graph.replay, args.repeats)
    diff = float((out.float() - eager.float()).abs().max())
    say(f"3. UNet call replayed from a CUDA graph: wall {replay_ms:.3f} ms (mean of "
        f"{args.repeats}); max |graph - eager| {diff:.3e}")

    _write(args.out, lines)


def _write(path, lines) -> None:
    if path:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
