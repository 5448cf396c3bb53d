"""Where the time of an image, or of a fine-tuning step, goes on one NVIDIA
GPU.

    python -m sdtpu_torch.profile_pipeline [--preset P] [--size 512|768|1024] [--out FILE]
        [--repeats N] [--f32]
    python -m sdtpu_torch.profile_pipeline --train [--preset P] [--out FILE] [--repeats N]
        [--f32]
    python -m sdtpu_torch.profile_pipeline --tp N [--preset P] [--size S] [--f32] [--repeats N]

Builds the preset's model (sd-v1-4 by default; sd-v2-1 is SD v2.1-768) at
full width with random weights (seeded), bf16 (with --f32 float32, the
default dtype of `sample`, `serve` and `finetune`), at the given image size
(the same config with image_size set; the preset's own size by default: 512
for sd-v1-4, 768 for sd-v2-1), and measures, after warm-up:

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
   time of one under torch.profiler (busy share: device over wall), the
   denoise with its --top largest items and the hand-written kernels'
   launches a replay by wrapper and route; each graph's capture seconds and
   the bytes it added to the shared pool.

With --train it measures instead a training step of the whole UNet at the
image size (training.make_train_step: batch 4 of random latents and
contexts with a key mask, bf16 compute, f32 masters, AdamW, the EMA in the
step, the preset's prediction target) for remat off, "full" and "dots"
(with --f32: float32 compute, `finetune`'s default, under remat "full"
alone, as chip_smoke.py's float32 step A/B runs it), replayed from its
CUDA graph (sdtpu's step_jit) and eager, on the same trees, in the turns
replayed, eager, eager, replayed: the mean wall ms of N warm steps a
turn (host clock, synchronised; each turn's first call is not timed: the
replayed first turn's is the eager step and the capture),
the peak reserved device memory over each mode's warm steps (the
allocator's cache emptied before each turn; the replayed step's graph
pool included, and taken out of the eager step's, which does not use it),
the device kernel time of one profiled step with its largest items
(busy share: device over wall), and the graph's capture seconds, the bytes
it added to the pool and those it took outside it.

With --tp N it measures instead one UNet call (batch 2) under tensor
parallelism, N ranks of a dp 1 x tp N mesh sharing the card (gloo): the
mean wall ms of N calls a turn, after two warm-up calls, in the turns
fused, unfused, unfused, fused, on the pipeline's tree (attn1's q | k | v
fused, then sharded) and on sdtpu's unfused tree sharded as it is (K2's
operand made from the three weights), with the bytes of float32 K-major
weight copies held after each turn.

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


# the kernel of torch.cuda._sleep (ATen's at::cuda::sleep), which nothing
# profiled here launches: device_profile's sentinel
SENTINEL = "spin_kernel"


def device_profile(fn, top: Optional[int]):
    """(device ms of one call of fn, its first `top` [(name, ms, launches)],
    largest first; all with None): fn is called twice, and the second call
    profiled. The profiler's rows with device time and no CPU time of their
    own are the kernels. A sentinel kernel runs after the call's last; a
    trace with kernels but without it lost the end of the call (CUPTI hands
    its records over after the work ends), and raises "trace incomplete"
    rather than report a partial call. A trace with no kernel at all (no
    device tracing) gives 0 ms and no rows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        # a short wait before the profiler stops, for the last records
        time.sleep(0.2)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    return profile_rows(rows, top)


def profile_rows(rows, top: Optional[int]):
    """device_profile's result from the profiler's kernel rows (name, ms,
    launches), the sentinel's among them: raises where kernels are there and
    the sentinel is not."""
    found = [r for r in rows if SENTINEL not in r[0]]
    if found and len(found) == len(rows):
        raise RuntimeError(f"trace incomplete: the profiler's trace lacks the sentinel kernel "
                           f"({SENTINEL}) launched after the profiled call, so its "
                           f"{len(found)} kernel rows may not cover the call")
    found.sort(key=lambda r: -r[1])
    return sum(r[1] for r in found), found[:top]


def _launches(fn) -> dict:
    """{wrapper: {shape key with its route: launches}} of one fn() call
    (kernels.count: a graph replay adds its capture's record)."""
    from sdtpu_torch import kernels

    before = {name: dict(w.shapes) for name, w in kernels.LAUNCHED.items()}
    fn()
    torch.cuda.synchronize()
    out = {}
    for name, w in kernels.LAUNCHED.items():
        d = {k: n - before.get(name, {}).get(k, 0) for k, n in w.shapes.items()}
        d = {k: n for k, n in d.items() if n}
        if d:
            out[name] = d
    return out


def _tp_unet_rank(preset: str, size: int, f32: bool, repeats: int) -> dict:
    """One rank of --tp (launch.spawn runs it): {tree: {"ms": [a turn's mean
    wall ms, ...], "kmajor_bytes": [...]}} of a UNet call on its shards."""
    import torch.distributed as dist

    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.ops import fused_mlp
    from sdtpu_torch.parallel import local_device, make_mesh
    from sdtpu_torch.parallel import tp as tpc

    dev = local_device()
    dtype = torch.float32 if f32 else torch.bfloat16
    cfg_sd = dataclasses.replace(PRESETS[preset], image_size=size)
    params = init_params(cfg_sd, torch.Generator(device=dev).manual_seed(0), device=dev)
    mesh = make_mesh(dp=1, tp=dist.get_world_size(), device=dev)
    sd = StableDiffusion(params, cfg_sd, compute_dtype=dtype, mesh=mesh)
    del params
    trees = {"fused": sd.params["unet"], "unfused": unfuse_qkv(sd.params["unet"])}
    g = torch.Generator(device=dev).manual_seed(1)
    hw = cfg_sd.latent_size
    x = torch.randn((2, hw, hw, 4), generator=g, device=dev).to(dtype)
    ctx = torch.randn((2, 77, cfg_sd.unet.context_dim), generator=g, device=dev).to(dtype)
    t = torch.tensor([481.0], device=dev)
    out = {k: {"ms": [], "kmajor_bytes": []} for k in trees}
    with torch.no_grad(), tpc.use(tpc.of_mesh(mesh)):
        for label in ("fused", "unfused", "unfused", "fused"):
            unet = trees[label]
            for _ in range(2):
                unet_apply(unet, x, t, ctx, cfg_sd.unet)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(repeats):
                unet_apply(unet, x, t, ctx, cfg_sd.unet)
            torch.cuda.synchronize()
            out[label]["ms"].append((time.perf_counter() - t0) * 1e3 / repeats)
            out[label]["kmajor_bytes"].append(fused_mlp.kmajor_bytes())
    return out


def _tp(args, size: int, say) -> None:
    """The --tp report (see the module docstring)."""
    from sdtpu_torch.parallel import spawn

    dname = "f32" if args.f32 else "bf16"
    say(f"UNet call {args.preset} {size}x{size} {dname} batch 2, tp = {args.tp} ranks sharing "
        f"the card (gloo), {args.repeats} calls a turn, turns fused, unfused, unfused, fused")
    results = spawn(args.tp, _tp_unet_rank, args.preset, size, args.f32, args.repeats,
                    backend="gloo")
    for rank, res in enumerate(results):
        for label, r in res.items():
            ms = r["ms"]
            say(f"rank {rank} {label:8s} tree: {' / '.join(f'{v:.3f}' for v in ms)} ms a call, "
                f"mean {sum(ms) / len(ms):.3f}; K-major copies held {r['kmajor_bytes']} bytes")


def _train(sd, dev, args, say, dtype=torch.bfloat16) -> None:
    """The --train report (see the module docstring), at compute dtype
    dtype."""
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
    dname = "f32" if dtype == torch.float32 else "bf16"
    for remat in (False, "full", "dots") if dtype == torch.bfloat16 else ("full",):
        params = master_params(unfuse_qkv(sd.params["unet"]))
        ema = tree_map(lambda p: p.detach().clone(), params)
        opt = make_optimizer(lr=1e-5, warmup_steps=0, total_steps=100 * (args.repeats + 2))
        state = opt.init(params)
        cache = graphs.GraphCache(dev)
        # the same trees under both: the graph reads and writes them by address
        steps = {mode: make_train_step(cfg, opt, compute_dtype=dtype, remat=remat,
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
                f"batch {b}, {dname}, AdamW, EMA): wall {wall:.3f} ms (turns "
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
    ap.add_argument("--f32", action="store_true",
                    help="compute in float32 (the command lines' default) instead of bf16")
    ap.add_argument("--tp", type=int, default=0,
                    help="time a UNet call on this many tensor-parallel ranks instead")
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
    dtype = torch.float32 if args.f32 else torch.bfloat16
    dname = "f32" if args.f32 else "bf16"
    dev = torch.device("cuda", 0)
    preset = PRESETS[args.preset]
    size = args.size or preset.image_size
    if args.tp:
        _tp(args, size, say)
        _write(args.out, lines)
        return
    cfg_sd = dataclasses.replace(preset, image_size=size)
    params = init_params(cfg_sd, torch.Generator(device=dev).manual_seed(0), device=dev)
    sd = StableDiffusion(params, cfg_sd, compute_dtype=dtype)
    tok = SimpleTokenizer()
    hw = cfg_sd.latent_size
    if args.train:
        del params
        _train(sd, dev, args, say, dtype)
        _write(args.out, lines)
        return
    sd_eager = StableDiffusion(params, cfg_sd, compute_dtype=dtype, graphs=False)
    del params

    for label, pipe in (("eager", sd_eager), ("replayed from CUDA graphs", sd)):
        say(f"1. generate {cfg_sd.name} {size}x{size} {dname}, 20 DDIM steps, CFG 7.5, batch 1, "
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
    x = torch.randn((2, hw, hw, 4), generator=g, device=dev).to(dtype)
    ctx, valid = sd.context(tok, PROMPT)
    unctx, unvalid = sd.context(tok, "")
    ctx2, valid2 = torch.cat([unctx, ctx]), torch.cat([unvalid, valid])
    t = torch.tensor([481.0], device=dev)  # on the device, so a graph can hold it
    unet, cfg = sd.params["unet"], cfg_sd.unet
    z = torch.randn((1, hw, hw, 4), generator=g, device=dev).to(dtype)
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
        say(f"3. {name} replayed ({dname}): wall {wall:.3f} ms (mean of {args.repeats}); "
            f"device kernels {dev_ms:.3f} ms in one profiled call, busy share {busy}")
        for key, ms, n in top[:args.top if name.startswith("denoise") else 4]:
            say(f"   {ms:9.3f} ms {n:5d} launches  {key[:90]}")
        if name.startswith("denoise"):
            say(f"   launches a replay by wrapper and shape: {_launches(fn)}")
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
