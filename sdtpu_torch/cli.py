"""The command lines of the port, argv-compatible with sdtpu's (port of
sdtpu/cli.py: load_model, sample_main, finetune_main and convert_main).

sample  (python -m sdtpu_torch.sample):
    sample <model_type(burn|dump|native|ckpt)> <model_name>
           <unconditional_guidance_scale> <n_diffusion_steps>
           <prompt> <output_image_name> [device(cuda|cpu)]

finetune (python -m sdtpu_torch.finetune):
    finetune <model_type> <model_name> <data_dir|cache.npz> <out_model>
             [training flags: see finetune_main]

convert (python -m sdtpu_torch.convert):
    convert <dump_path> <model_name>           # npy tree -> native
    convert --ckpt <sd.ckpt> <model_name>      # torch ckpt -> native
    convert --mpk <model.mpk> <model_name>     # Burn NamedMpk -> native
    convert --to-dump <native> <dump_path>     # native -> npy tree
    convert --to-mpk <native> <mpk_path>       # native -> Burn NamedMpk

sample's flags are sdtpu's: --seed N, --preset sd-v1-4|sd-v1-5|sd-v2-1|
sd-tiny, --bf16, --batch N, --sampler ddim|dpmpp|euler|euler_a|heun,
--negative "text", --init-image PATH [--strength F] (img2img), --mask PATH
(inpainting, white = regenerate), --lora ADAPTER.safetensors,
--concept TI.safetensors (a textual-inversion placeholder in the prompt)
and --karras (Karras sigma spacing on dpmpp|euler|euler_a|heun); convert
takes --preset for the formats that carry no configuration (dump, ckpt,
mpk).

The device argument: none, or `cuda`, runs on the card (cuda:0) and exits
1 when there is none, with no fallback; `cpu` runs on the host; sdtpu's
`tpu` and `mps` name no device of the port and exit 1. A seeded sample
draws its latent from torch.Generator(device).manual_seed(seed), so it
gives the image StableDiffusion.generate(..., generator=...) gives with
that generator on the same device. finetune takes sdtpu's --device
cuda|cpu flag with the same rule. convert moves weights between files
and computes nothing: it runs on the host, as sdtpu's does. With
SDTPU_PROFILE=1 sample and finetune print their phases' wall seconds
(utils.profiling) and each kernel's launches as one JSON line; sample's
also holds its warm start's timeline (seconds from its start to the
kernels' and the runtime's builds, to the join, to the captures) and its
graph cache's counts
(graphs.GraphCache.stats: captures, replays, each graph's capture seconds
and pool bytes, the warm-ups' launches, which the kernels' counts include);
finetune's holds its run's graph stats (finetune.py: the data preparation's
programs and the step's graph; None where the steps ran eagerly).

On the card, sample runs through CUDA graphs (StableDiffusion's graphs,
graphs.py): warm.WarmStart builds the kernels and the native runtime while
the weights load, then captures the first image's graphs; finetune's data
preparation replays the encoder's and CLIP's programs and its step is one
captured graph, replayed from the second step.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from sdtpu_torch.config import PRESETS
from sdtpu_torch.pipeline import SAMPLERS, StableDiffusion

MODEL_TYPES = ("burn", "dump", "native", "safetensors", "ckpt")


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def _select_device(device_arg) -> torch.device:
    """The reference's device argument -> the port's device: none or cuda,
    the card (exit 1 without one); cpu, the host; anything else, exit 1."""
    name = (device_arg or "cuda").lower()
    if name == "cuda":
        if not torch.cuda.is_available():
            _fail("Error: no CUDA device found; pass `cpu` as the device argument to run "
                  "on the host")
        return torch.device("cuda", 0)
    if name == "cpu":
        return torch.device("cpu")
    _fail(f"Error: unsupported device {device_arg!r}: this build runs on cuda (the default) "
          f"or cpu")


def load_params(model_type: str, model_name: str, preset: str = "sd-v1-4", device="cuda"):
    """(params on `device`, config) of a model file of any type: native
    (or safetensors) carries its config; dump, burn and ckpt take the
    preset's."""
    import os

    from sdtpu_torch.weights import from_numpy_tree

    if preset not in PRESETS:
        _fail(f"Unknown preset: {preset} (choose from {', '.join(PRESETS)})")
    cfg = PRESETS[preset]
    if model_type not in MODEL_TYPES:
        _fail(f"Unknown model type: {model_type} (burn|dump|native|ckpt)")
    if model_type != "dump" and not os.path.exists(model_name):
        _fail(f"Error loading model: file not found: {model_name}")
    if model_type in ("native", "safetensors"):
        from sdtpu_torch.io.native import load_native

        return load_native(model_name, device)
    if model_type == "dump":
        if not os.path.isdir(model_name):
            _fail(f"Error loading model dump: no such directory: {model_name}")
        from sdtpu_torch.io.npy_tree import load_stable_diffusion_dump

        tree = load_stable_diffusion_dump(model_name, cfg)
    elif model_type == "burn":
        from sdtpu_torch.io.mpk import load_mpk

        tree = load_mpk(model_name)
    else:
        from sdtpu_torch.io.ckpt import load_torch_ckpt

        tree = load_torch_ckpt(model_name, cfg)
    return from_numpy_tree(tree, device), cfg


def load_model(model_type: str, model_name: str, preset: str = "sd-v1-4",
               compute_dtype=None, pad_context: bool = True, device="cuda"):
    """A StableDiffusion over the weights of a model file of any type, on
    `device` (the card unless the caller asks for another)."""
    params, cfg = load_params(model_type, model_name, preset, device)
    return StableDiffusion(params, cfg, compute_dtype=compute_dtype or torch.float32,
                           pad_context=pad_context)


def _launch_counts() -> dict:
    """{kernel: {"launches": n, "shapes": {shape key: n}}} of every kernel
    wrapper that launched in this process (kernels.count)."""
    from sdtpu_torch.kernels import LAUNCHED

    return {name: {"launches": f.launches, "shapes": dict(f.shapes)}
            for name, f in LAUNCHED.items() if f.launches}


def sample_main(argv=None) -> None:
    argv = list(sys.argv if argv is None else argv)

    # the extras are flags, so the positional surface stays the reference's
    seed = None
    preset = "sd-v1-4"
    bf16 = False
    batch = 1
    sampler = "ddim"
    negative = ""
    init_image = None
    strength = 0.75
    mask_path = None
    lora_path = None
    concept_path = None
    karras = False
    i = 1
    positional = [argv[0]]

    def flag_value(idx: int) -> str:
        # a value-taking flag as the final argument is a usage error
        if idx + 1 >= len(argv):
            _fail(f"Error: {argv[idx]} requires a value")
        return argv[idx + 1]

    while i < len(argv):
        a = argv[i]
        if a == "--seed":
            seed = int(flag_value(i)); i += 2
        elif a == "--preset":
            preset = flag_value(i); i += 2
        elif a == "--bf16":
            bf16 = True; i += 1
        elif a == "--batch":
            batch = int(flag_value(i)); i += 2
        elif a == "--sampler":
            sampler = flag_value(i); i += 2
            if sampler not in SAMPLERS:
                _fail("Error: --sampler must be ddim|dpmpp|euler|euler_a|heun")
        elif a == "--negative":
            negative = flag_value(i); i += 2
        elif a == "--init-image":
            init_image = flag_value(i); i += 2
        elif a == "--strength":
            strength = float(flag_value(i)); i += 2
        elif a == "--mask":
            mask_path = flag_value(i); i += 2
        elif a == "--lora":
            lora_path = flag_value(i); i += 2
        elif a == "--concept":
            concept_path = flag_value(i); i += 2
        elif a == "--karras":
            karras = True; i += 1
        else:
            positional.append(a); i += 1
    argv = positional

    if len(argv) not in (7, 8):
        _fail(
            f"Usage: {argv[0]} <model_type(burn or dump)> <model_name> "
            "<unconditional_guidance_scale> <n_diffusion_steps> <prompt> "
            "<output_image_name> [device(cuda, cpu)]"
        )

    model_type, model_name = argv[1], argv[2]
    try:
        guidance_scale = float(argv[3])
    except ValueError:
        _fail("Error: Invalid unconditional guidance scale.")
    try:
        n_steps = int(argv[4])
    except ValueError:
        _fail("Error: Invalid number of diffusion steps.")
    prompt, output_name = argv[5], argv[6]
    if karras and sampler == "ddim":
        _fail("Error: --karras needs --sampler dpmpp|euler|euler_a|heun")
    if concept_path is not None and init_image is not None:
        # fail before the tokenizer and the model load
        _fail("Error: --concept is not supported with --init-image")
    device = _select_device(argv[7] if len(argv) == 8 else None)

    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils import profiling
    from sdtpu_torch.utils.image import save_images
    from sdtpu_torch.warm import WarmStart

    # where sdtpu starts its background compile (sdtpu/cli.py:198-223): the
    # kernels (on the card) and the native runtime build on a thread while
    # the tokenizer and the weights load; after the load, join captures the
    # graphs of the first image (generate's; an image-to-image run captures
    # the decode's, the rest at its first call). A build failure re-raises.
    warm = WarmStart(device, batch=batch, n_steps=n_steps, sampler=sampler,
                     karras_sigmas=karras, guidance_scale=guidance_scale,
                     sample=init_image is None).start()

    print("Loading tokenizer...")
    with profiling.phase("load_tokenizer"):
        tokenizer = SimpleTokenizer()
    print("Loading model...")
    compute_dtype = torch.bfloat16 if bf16 else torch.float32
    with profiling.phase("load_model", device):
        sd = load_model(model_type, model_name, preset, compute_dtype=compute_dtype,
                        device=device)
    if lora_path is not None:
        # a LoRA adapter merged into the loaded UNet (sdtpu's tree: the
        # pipeline fuses attn1's q/k/v again from the merged weights)
        from sdtpu_torch.lora import apply_lora, load_lora
        from sdtpu_torch.models.unet import unfuse_qkv

        lora, scale, _meta = load_lora(lora_path, device)
        params = {**sd.params, "unet": apply_lora(unfuse_qkv(sd.params["unet"]), lora, scale)}
        sd = StableDiffusion(params, sd.config, compute_dtype=compute_dtype,
                             pad_context=sd.pad_context)
        print(f"Applied LoRA adapter {lora_path} (scale {scale:g})")
    warm.join(sd)

    print("Sampling image...")
    t0 = time.perf_counter()
    generator = None if seed is None else torch.Generator(device).manual_seed(seed)
    if concept_path is not None:
        # a textual-inversion concept: the prompt's context over the
        # extended embedding table (--concept with --init-image was refused)
        from sdtpu_torch.textual_inversion import generate_with_ti, load_ti

        emb, placeholder, _meta = load_ti(concept_path, device)
        if placeholder not in prompt:
            print(f"Warning: prompt does not contain the concept "
                  f"placeholder {placeholder!r}")
        images = generate_with_ti(
            sd, tokenizer, prompt, emb, guidance_scale, n_steps,
            n_images=batch, generator=generator, sampler=sampler,
            negative_prompt=negative, placeholder=placeholder,
            karras_sigmas=karras)
    elif init_image is not None:
        # img2img / inpaint: --init-image PATH [--strength F] [--mask PATH]
        from sdtpu_torch.dataset import center_crop_resize, load_image_u8

        img = center_crop_resize(load_image_u8(init_image), sd.config.image_size)
        x = np.tile(img.astype(np.float32)[None] / 127.5 - 1.0, (batch, 1, 1, 1))
        if mask_path is not None:
            # white (>= 50% luma) pixels are regenerated, black kept
            m = center_crop_resize(load_image_u8(mask_path), sd.config.image_size)
            mask = np.tile((m.mean(axis=-1) > 127.5).astype(np.float32)[None],
                           (batch, 1, 1))
            images = sd.inpaint(tokenizer, prompt, x, mask, guidance_scale, n_steps,
                                generator=generator, sampler=sampler,
                                karras_sigmas=karras, negative_prompt=negative)
        else:
            images = sd.img2img(tokenizer, prompt, x, strength, guidance_scale, n_steps,
                                generator=generator, sampler=sampler,
                                karras_sigmas=karras, negative_prompt=negative)
    else:
        images = sd.generate(tokenizer, prompt, guidance_scale, n_steps,
                             n_images=batch, generator=generator, sampler=sampler,
                             negative_prompt=negative, karras_sigmas=karras)
    dt = time.perf_counter() - t0
    with profiling.phase("save_png"):
        paths = save_images(images, output_name)
    print(f"Saved {paths} ({dt:.2f}s sampling, "
          f"{images.shape[0] / dt:.3f} images/sec)")
    if profiling.enabled():
        print(profiling.REGISTRY.report({
            "n_steps": n_steps, "batch": batch, "guidance_scale": guidance_scale,
            "device": str(device), "sampling_s": round(dt, 4),
            "kernels": _launch_counts(), "warm": warm.timeline,
            "graphs": None if sd.graph_cache is None else sd.graph_cache.stats(),
        }))


def finetune_main(argv=None) -> None:
    """finetune <model_type> <model_name> <data_dir|cache.npz> <out_model>
             [--steps N] [--batch B] [--accum K] [--accum-bf16] [--lr F]
             [--ema DECAY] [--bf16] [--remat] [--remat-policy full|dots|heavy]
             [--opt adamw|adafactor] [--fast] [--save-every N]
             [--state-dir DIR] [--resume] [--preset P] [--seed N] [--tp N]
             [--backend gloo|nccl] [--device cuda|cpu] [--lora-rank R]
             [--lora-alpha A] [--flip]
             [--ti "<placeholder>" [--ti-vectors N] [--ti-init TOKEN] [--ti-lr F]]

    sdtpu's flags with sdtpu's meanings (sdtpu/cli.py:finetune_main). --fast
    is sdtpu's best-throughput full fine-tune (adafactor, batch 8, no
    remat), applied as defaults before parsing, so explicit flags override
    its pieces wherever they stand. --lora-rank trains an adapter and
    writes it beside the merged model (`<out_model>.lora.safetensors`);
    --ti learns a concept's embedding rows and writes
    `<out_model>.ti.safetensors` for `sample --concept`. --device: cuda (the
    default; exit 1 without a card) or cpu; sdtpu's tpu exits 1. The model
    loads in f32 and --bf16 is the training's compute dtype only (the
    master weights stay f32). With SDTPU_PROFILE=1 it prints its phases'
    wall seconds (the load, and inside the run the latent cache or the
    concept's data, the train state's save and restore and the model's
    save), the run's whole seconds (train_s), each kernel's launches and the
    peak device memory as one JSON line.

    Under torchrun (WORLD_SIZE > 1) every rank joins the world on
    --backend, which is then required (gloo where ranks share a card or
    run on the host, nccl where each has its own card), takes the card
    cuda:{LOCAL_RANK % cards} (or the host with --device cpu), and trains
    on the whole world as a ("dp", "tp") mesh with tp = --tp; rank 0 writes
    the files."""
    argv = list(sys.argv if argv is None else argv)

    opts = {"steps": 100, "batch": 4, "accum": 1, "accum_bf16": False, "lr": 1e-5, "ema": None,
            "bf16": False, "remat": False, "opt": "adamw", "save_every": 0, "state_dir": None,
            "resume": False, "preset": "sd-v1-4", "seed": 0, "tp": 1, "backend": None,
            "device": None,
            "lora_rank": None, "lora_alpha": None, "flip": False, "ti": None, "ti_vectors": 1,
            "ti_init": None, "ti_lr": None}
    if "--fast" in argv:
        argv = [a for a in argv if a != "--fast"]
        opts.update({"opt": "adafactor", "batch": 8, "remat": False})
    i, positional = 1, [argv[0]]

    def flag_value(idx: int) -> str:
        if idx + 1 >= len(argv):
            _fail(f"Error: {argv[idx]} requires a value")
        return argv[idx + 1]

    # flag -> (option, parse); parse None: a switch
    flags = {"--steps": ("steps", int), "--batch": ("batch", int), "--accum": ("accum", int),
             "--lr": ("lr", float), "--ema": ("ema", float), "--bf16": ("bf16", None),
             "--remat": ("remat", None), "--remat-policy": ("remat", str),
             "--accum-bf16": ("accum_bf16", None), "--opt": ("opt", str),
             "--save-every": ("save_every", int), "--state-dir": ("state_dir", str),
             "--resume": ("resume", None), "--preset": ("preset", str),
             "--seed": ("seed", int), "--tp": ("tp", int), "--backend": ("backend", str),
             "--device": ("device", str),
             "--lora-rank": ("lora_rank", int), "--lora-alpha": ("lora_alpha", float),
             "--flip": ("flip", None), "--ti": ("ti", str), "--ti-vectors": ("ti_vectors", int),
             "--ti-init": ("ti_init", str), "--ti-lr": ("ti_lr", float)}
    while i < len(argv):
        a = argv[i]
        if a not in flags:
            positional.append(a); i += 1
            continue
        key, parse = flags[a]
        if parse is None:
            opts[key] = True; i += 1
            continue
        opts[key] = parse(flag_value(i)); i += 2
        if a == "--remat-policy" and opts["remat"] not in ("full", "dots", "heavy"):
            _fail("Error: --remat-policy must be full|dots|heavy")
        if a == "--opt" and opts["opt"] not in ("adamw", "adafactor"):
            _fail("Error: --opt must be adamw|adafactor")

    if len(positional) != 5:
        _fail(f"Usage: {positional[0]} <model_type(burn|dump|native|ckpt)> "
              "<model_name> <data_dir|cache.npz> <out_model> [flags]")
    model_type, model_name, data, out_model = positional[1:5]
    device = _select_device(opts["device"])
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from sdtpu_torch.parallel import init_from_env, local_device

        if opts["backend"] not in ("gloo", "nccl"):
            _fail("Error: under torchrun pass --backend gloo|nccl (gloo where ranks share a "
                  "card or run on the host)")
        if opts["ti"] is not None:
            _fail("Error: --ti runs in one process, not under torchrun")
        init_from_env(opts["backend"])
        if device.type == "cuda":
            device = local_device()

    from sdtpu_torch import finetune
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils import profiling

    print("Loading tokenizer...")
    with profiling.phase("load_tokenizer"):
        tokenizer = SimpleTokenizer()
    print("Loading model...")
    with profiling.phase("load_model", device):
        # f32, as sdtpu loads it: --bf16 is the compute dtype, not the weights'
        sd = load_model(model_type, model_name, opts["preset"], device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    compute_dtype = torch.bfloat16 if opts["bf16"] else torch.float32

    t0 = time.perf_counter()
    if opts["ti"] is not None:
        print(f"Learning concept {opts['ti']!r} for {opts['steps']} steps "
              f"(batch {opts['batch']}, {opts['ti_vectors']} vectors)...")
        result = finetune.run_textual_inversion(
            sd, tokenizer, data, out_model, placeholder=opts["ti"], n_vectors=opts["ti_vectors"],
            init_token=opts["ti_init"], steps=opts["steps"], batch_size=opts["batch"],
            lr=opts["ti_lr"] if opts["ti_lr"] is not None else 5e-3,
            compute_dtype=compute_dtype, remat=opts["remat"], seed=opts["seed"])
        print(f"Done: final loss {result['final_loss']:.5f}, "
              f"{result['steps_per_sec']:.2f} steps/sec, concept at {result['out_path']}")
    else:
        print(f"Fine-tuning for {opts['steps']} steps "
              f"(batch {opts['batch']}, accum {opts['accum']}, lr {opts['lr']})...")
        result = finetune.run_finetune(
            sd, tokenizer, data, out_model,
            steps=opts["steps"], batch_size=opts["batch"], accum=opts["accum"],
            accum_bf16=opts["accum_bf16"], lr=opts["lr"], ema_decay=opts["ema"],
            opt_kind=opts["opt"], compute_dtype=compute_dtype, remat=opts["remat"],
            tp=opts["tp"], seed=opts["seed"], save_every=opts["save_every"],
            state_dir=opts["state_dir"], resume=opts["resume"],
            lora_rank=opts["lora_rank"], lora_alpha=opts["lora_alpha"], flip=opts["flip"])
        print(f"Done: final loss {result['final_loss']:.5f}, "
              f"{result['steps_per_sec']:.2f} steps/sec, model at {result['out_path']}")
    train_s = time.perf_counter() - t0
    if profiling.enabled():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        peak = (torch.cuda.max_memory_allocated(device) / 1024 ** 3
                if device.type == "cuda" else None)
        print(profiling.REGISTRY.report({
            "steps": opts["steps"], "batch": opts["batch"], "device": str(device),
            "train_s": round(train_s, 4),
            "steps_per_sec": result["steps_per_sec"], "losses": result["losses"],
            "peak_memory_gib": None if peak is None else round(peak, 4),
            "graphs": result.get("graphs"),
            "kernels": _launch_counts(),
        }))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def convert_main(argv=None) -> None:
    argv = list(sys.argv if argv is None else argv)
    from sdtpu_torch.io.native import load_native, save_native

    preset = "sd-v1-4"
    if "--preset" in argv:
        i = argv.index("--preset")
        if i + 1 >= len(argv):
            _fail("Error: --preset requires a value")
        preset = argv[i + 1]
        del argv[i : i + 2]
    if preset not in PRESETS:
        _fail(f"Unknown preset: {preset} (choose from {', '.join(PRESETS)})")
    cfg = PRESETS[preset]

    if len(argv) == 4 and argv[1] in ("--ckpt", "--mpk"):
        params, _ = load_params("ckpt" if argv[1] == "--ckpt" else "burn", argv[2], preset,
                                "cpu")
        save_native(params, f"{argv[3]}.safetensors", cfg)
        print(f"Model saved to {argv[3]}.safetensors")
        return
    if len(argv) == 4 and argv[1] == "--to-dump":
        from sdtpu_torch.io.npy_tree import save_stable_diffusion_dump

        params, cfg = load_native(argv[2], "cpu")
        save_stable_diffusion_dump(params, argv[3], cfg)
        print(f"Dump tree written to {argv[3]}")
        return
    if len(argv) == 4 and argv[1] == "--to-mpk":
        # the reference convert binary's own output direction
        # (src/bin/convert/main.rs:32-37): a Burn NamedMpk record
        from sdtpu_torch.io.mpk import save_mpk

        params, cfg = load_native(argv[2], "cpu")
        out = argv[3] if argv[3].endswith(".mpk") else f"{argv[3]}.mpk"
        save_mpk(params, out)
        print(f"Model saved to {out}")
        return
    if len(argv) != 3:
        _fail(f"Usage: {argv[0]} <dump_path> <model_name> | "
              f"{argv[0]} --ckpt <sd.ckpt> <model_name> | "
              f"{argv[0]} --mpk <model.mpk> <model_name> | "
              f"{argv[0]} --to-dump <native> <dump_path> | "
              f"{argv[0]} --to-mpk <native> <mpk_path>")

    dump_path, model_name = argv[1], argv[2]
    params, _ = load_params("dump", dump_path, preset, "cpu")
    save_native(params, f"{model_name}.safetensors", cfg)
    print(f"Model saved to {model_name}.safetensors")
