"""Drive the sdtpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines:

1. device and build: the card's name and power limit (nvidia-smi), then
   the kernels built from sdtpu_torch/csrc with nvcc;
2. each kernel against its plain PyTorch version on the card, at the
   shapes SD v1.4's 512px UNet and VAE decoder give it, in float32 and
   bfloat16: max error against the stated tolerance, and both times (CUDA
   events);
3. one SpatialTransformer at the 64x64 latent level (C=320), random
   weights, run on the card (kernels) and on the CPU (plain versions); then
   the VAE decoder at SD v1.4 width on a 16x16 latent with every fused gate
   opened, card against CPU;
4. StableDiffusion.generate at SD v1.4 width with random weights: bf16,
   512x512, 20 DDIM steps, CFG 7.5, batch 1. The output must be a
   [1, 512, 512, 3] uint8 image from finite latents, and the kernels'
   launch counters must read exactly what the dispatch implies.

It prints a JSON line of per-kernel results, then the card's name and
power limit, then, last, {"ok": true, "device": {...}}. Any failure
exits nonzero before that line; there is no CPU fallback.

Precision: float32 matmuls and convolutions in the plain versions run in
full float32 (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are both set False here). The kernels run
float32 products on the tensor cores as TF32 with float32 accumulation,
so the float32 tolerances below are TF32 tolerances.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
WARMUP, ITERS = 3, 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=ITERS) -> float:
    """Mean time of fn() on the card, CUDA events around `iters` calls."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (atol, rtol) per dtype for kernel vs plain on the card. float32: the
# kernels' TF32 products against full-f32 plain products. bfloat16: both
# round to bf16 at different points (2^-8 relative per rounding).
TOL = {"float32": (5e-3, 5e-3), "bfloat16": (6e-2, 3e-2)}
STATS_TOL = (1e-2, 1e-4)  # f32 sums over 4096 rows in another order


def within(got, want, atol, rtol) -> tuple[float, bool]:
    """(max abs error, whether got is finite and |got - want| <= atol + rtol|want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def kernel_cases(dtype, dev):
    """Main-path inputs for each kernel: (name, shape label, launches per
    image, fn, plain fn, args, kwargs). Shapes are SD v1.4's at 512px: the
    UNet's with batched CFG (B=2, 20 steps), the VAE decoder's (B=1, once)."""
    import torch

    from sdtpu_torch.ops import fused_conv, fused_groupnorm, fused_mlp, fused_transformer

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    x64 = rnd(2, 64, 64, 320)
    cases.append(("channel_partials", "64x64x320", 100, fused_groupnorm.channel_partials,
                  fused_groupnorm.channel_partials_plain, (x64,), {}))
    cases.append(("channel_partials", "vae 64x64x512", 2, fused_groupnorm.channel_partials,
                  fused_groupnorm.channel_partials_plain, (rnd(1, 64, 64, 512),), {}))
    cases.append(("channel_partials", "vae 128x128x512", 1,
                  fused_groupnorm.channel_partials, fused_groupnorm.channel_partials_plain,
                  (rnd(1, 128, 128, 512),), {}))

    c = 320
    xr = x64.reshape(2, 4096, c)
    gamma, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    scale, bias = fused_conv.stats_scale_bias(
        fused_groupnorm.channel_partials_plain(xr), 4096, gamma, beta, 32, 1e-5)
    w, cb = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    cases.append(("conv1x1_fused", "proj_in 4096x320", 100, fused_conv.conv1x1_fused,
                  fused_conv.conv1x1_fused_plain, (xr, w, cb, scale, bias), {}))
    cases.append(("conv1x1_fused", "proj_out 4096x320", 100, fused_conv.conv1x1_fused,
                  fused_conv.conv1x1_fused_plain, (xr, w, cb),
                  {"residual": rnd(2, 4096, c)}))

    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        x = rnd(2, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 3 * c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5),
                rnd(c, scale=0.1), 8)
        cases.append(("fused_self_attention", f"S={s} C={c} dh={c // 8}", 100,
                      fused_transformer.fused_self_attention,
                      fused_transformer.fused_self_attention_plain, args, {}))
    for s, c in ((1024, 640), (256, 1280)):
        x = rnd(2, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 8 * c, scale=c ** -0.5), rnd(8 * c, scale=0.1),
                rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1))
        cases.append(("fused_geglu_mlp", f"S={s} C={c}", 100, fused_mlp.fused_geglu_mlp,
                      fused_mlp.fused_geglu_mlp_plain, args, {}))

    # the VAE decoder's fused ResnetBlock convs (GN+SiLU prologue, residual,
    # output stats), its two large upsamplers and its output GroupNorm+SiLU
    for hw, ci, co, n in ((64, 512, 512, 10), (128, 512, 512, 6), (256, 512, 256, 1),
                          (256, 256, 256, 5), (512, 256, 128, 1), (512, 128, 128, 5)):
        x = rnd(1, hw, hw, ci)
        gamma, beta = rnd(ci, scale=0.1) + 1.0, rnd(ci, scale=0.1)
        scale, bias = fused_conv.stats_scale_bias(
            fused_groupnorm.channel_partials_plain(x), hw * hw, gamma, beta, 32, 1e-6)
        args = (x, rnd(3, 3, ci, co, scale=(9 * ci) ** -0.5), rnd(co, scale=0.1), scale, bias)
        cases.append(("conv3x3_fused", f"{hw}x{hw} {ci}->{co}", n, fused_conv.conv3x3_fused,
                      fused_conv.conv3x3_fused_plain, args,
                      {"residual": rnd(1, hw, hw, co), "emit_stats": True}))
    for hw, c in ((128, 512), (256, 256)):
        args = (rnd(1, hw, hw, c), rnd(3, 3, c, c, scale=(9 * c) ** -0.5), rnd(c, scale=0.1))
        cases.append(("upsample2x_conv_fused", f"{hw}x{hw}x{c} -> {2 * hw}x{2 * hw}", 1,
                      fused_conv.upsample2x_conv_fused, fused_conv.upsample2x_conv_fused_plain,
                      args, {"emit_stats": True}))
    x = rnd(1, 512, 512, 128)
    args = (x, rnd(128, scale=0.1) + 1.0, rnd(128, scale=0.1), 32, 1e-6)
    cases.append(("group_norm_silu", "512x512x128", 1, fused_groupnorm.group_norm_silu,
                  fused_groupnorm.group_norm_silu_plain, args,
                  {"sums": fused_groupnorm.channel_partials_plain(x)}))
    return cases


# name -> (route, source, the sdtpu function that reaches its pl.pallas_call)
KERNEL_INFO = {
    "channel_partials": ("cuda", "sdtpu_torch/csrc/channel_stats.cu",
                         "sdtpu/ops/fused_groupnorm.py:47"),
    "conv1x1_fused": ("cuda", "sdtpu_torch/csrc/gemm.cu", "sdtpu/ops/fused_conv.py:428"),
    "fused_self_attention": ("cuda", "sdtpu_torch/csrc/attention.cu",
                             "sdtpu/ops/fused_transformer.py:108"),
    "fused_geglu_mlp": ("cuda", "sdtpu_torch/csrc/gemm.cu", "sdtpu/ops/fused_mlp.py:68"),
    "conv3x3_fused": ("cuda", "sdtpu_torch/csrc/gemm.cu", "sdtpu/ops/fused_conv.py:152"),
    "upsample2x_conv_fused": ("cuda", "sdtpu_torch/csrc/gemm.cu",
                              "sdtpu/ops/fused_conv.py:316"),
    "group_norm_silu": ("cuda", "sdtpu_torch/csrc/groupnorm.cu",
                        "sdtpu/ops/fused_groupnorm.py:82"),
}


def wrappers() -> dict:
    """name -> the kernel's wrapper, which carries its launch count."""
    from sdtpu_torch.ops import fused_conv, fused_groupnorm, fused_mlp, fused_transformer

    fns = (fused_groupnorm.channel_partials, fused_conv.conv1x1_fused,
           fused_transformer.fused_self_attention, fused_mlp.fused_geglu_mlp,
           fused_conv.conv3x3_fused, fused_conv.upsample2x_conv_fused,
           fused_groupnorm.group_norm_silu)
    return {f.__name__: f for f in fns}


def phase_kernels(dev) -> dict:
    """Phase 2. Returns per-kernel {max_abs_err, ms, plain_ms} where ms are
    per image (each shape's time times its launches per image), from the
    bfloat16 run, the main path's dtype."""
    import torch

    from sdtpu_torch.ops.fused_groupnorm import channel_partials_plain

    results = {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        for name, shape, calls, fn, plain, args, kw in kernel_cases(dtype, dev):
            got, want = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            a, r = (STATS_TOL if name == "channel_partials" else (atol, rtol))
            if kw.get("emit_stats"):
                (got, got_st), (want, _) = got, want
                # the emitted statistics are sums over the f32 accumulator:
                # held to the sums of the kernel's own output, within that
                # output's rounding (bf16: 2^-8 of the sum of magnitudes;
                # f32: the summation order). Against the plain version they
                # would differ by TF32's rounding of the weights, which a
                # sum over a million rows does not average out.
                y_sums = channel_partials_plain(got)
                tol_st = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-5) * _stats_scale(got)
                st_err = float(((got_st - y_sums).abs() / tol_st).max())
                print(f"kernel {name:21s} {dname:8s} {shape:20s} emitted stats: max "
                      f"|err| / tol {st_err:.3f}", flush=True)
                if st_err > 1.0:
                    failed.append(f"{name} {dname} {shape} stats")
            err, ok = within(got, want, a, r)
            ms = cuda_ms(lambda: fn(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw))
            print(f"kernel {name:21s} {dname:8s} {shape:20s} max_abs_err {err:.3e} "
                  f"(tol {a:g} + {r:g}|ref|) {'ok' if ok else 'FAILED'}  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms", flush=True)
            if not ok:
                failed.append(f"{name} {dname} {shape}")
            if dtype == torch.bfloat16:
                e = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
                e["max_abs_err"] = max(e["max_abs_err"], err)
                e["ms"] += calls * ms
                e["plain_ms"] += calls * plain_ms
    if failed:
        fail("kernel disagrees with its plain version: " + "; ".join(failed))
    return results


def to(tree, device):
    """A parameter tree (dicts and lists of tensors) moved to device."""
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, device) for v in tree]
    return tree.to(device)


def _stats_scale(y):
    """[B, 2, C]: per-channel (sum |y|, sum y^2) of y [B, ..., C], f32, plus
    one, the scale a sum over y's rows is compared at."""
    import torch

    yf = y.float().reshape(y.shape[0], -1, y.shape[-1])
    return 1.0 + torch.stack([yf.abs().sum(1), (yf * yf).sum(1)], dim=1)


def phase_transformer(dev) -> None:
    """Phase 3: one SpatialTransformer at the 64x64 level of SD v1.4
    (C=320, 8 heads, 77 context tokens of width 768) in float32, on the
    card (where K3, K4 and K2 fire) and on the CPU (plain versions)."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import fused_conv, fused_groupnorm, fused_transformer
    from sdtpu_torch.weights import Init

    cfg, c = SD_V1_4.unet, 320
    g = torch.Generator().manual_seed(SEED)
    p_cpu = unet._init_transformer(Init(g, "cpu"), c, cfg.context_dim)
    x = torch.randn((2, 64, 64, c), generator=g)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    valid = torch.arange(77)[None, :] < torch.tensor([[1], [9]])  # uncond, cond

    p_dev = to(p_cpu, dev)
    counted = (fused_groupnorm.channel_partials, fused_conv.conv1x1_fused,
               fused_transformer.fused_self_attention)
    before = [f.launches for f in counted]
    got = unet._transformer_apply(p_dev, x.to(dev), ctx.to(dev), cfg, 8, valid.to(dev))
    torch.cuda.synchronize()
    fired = [f.launches - b for f, b in zip(counted, before)]
    want = unet._transformer_apply(p_cpu, x, ctx, cfg, 8, valid)
    atol, rtol = TOL["float32"]
    err, ok = within(got.cpu(), want, atol, rtol)
    print(f"transformer 64x64x320 card (kernels) vs cpu (plain) float32 max_abs_err "
          f"{err:.3e} (tol {atol:g} + {rtol:g}|ref|) launches K3/K4/K2 {fired} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail("SpatialTransformer on the card disagrees with the CPU")
    if fired != [1, 2, 1]:
        fail(f"SpatialTransformer at 64x64 launched K3/K4/K2 {fired}, expected [1, 2, 1]")


# the VAE decoder phase: decoder channels tolerate TF32 products through
# 33 chained convolutions (each ~1e-3 relative), GroupNorms in between
DECODE_TOL = (3e-2, 3e-2)


def phase_decode(dev) -> None:
    """Phase 3b: SD v1.4's VAE decoder at full width on a 16x16 latent
    (128x128 image), float32, random weights, with every fused gate opened
    so that all its ResnetBlocks run K6, all three upsamplers K7 and the
    output norm K8, each fed the previous kernel's statistics; the card
    (kernels) against the CPU (plain versions)."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.models import vae
    from sdtpu_torch.ops import conv
    from sdtpu_torch.weights import Init

    cfg = SD_V1_4.vae
    g = torch.Generator().manual_seed(SEED)
    params = vae.init_autoencoder(Init(g, "cpu"), cfg)
    z = torch.randn((1, 16, 16, 4), generator=g)

    gates = vae.FUSED_CONV_MIN_ROWS, conv.FUSED_UP_MIN_ROWS
    vae.FUSED_CONV_MIN_ROWS = conv.FUSED_UP_MIN_ROWS = 1
    try:
        fns = wrappers()
        before = {k: f.launches for k, f in fns.items()}
        got = vae.decode_latent(to(params, dev), z.to(dev), cfg)
        torch.cuda.synchronize()
        fired = {k: f.launches - before[k] for k, f in fns.items() if f.launches > before[k]}
        t0 = time.perf_counter()
        want = vae.decode_latent(params, z, cfg)
        cpu_s = time.perf_counter() - t0
    finally:
        vae.FUSED_CONV_MIN_ROWS, conv.FUSED_UP_MIN_ROWS = gates
    atol, rtol = DECODE_TOL
    err, ok = within(got.cpu(), want, atol, rtol)
    expect = {"channel_partials": 2, "conv3x3_fused": 28, "upsample2x_conv_fused": 3,
              "group_norm_silu": 1}
    print(f"vae decode 16x16 latent -> {tuple(got.shape)} card (kernels) vs cpu (plain, "
          f"{cpu_s:.1f} s) float32 max_abs_err {err:.3e} (tol {atol:g} + {rtol:g}|ref|) "
          f"launches {fired} {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail("the VAE decoder on the card disagrees with the CPU")
    if fired != expect:
        fail(f"the VAE decoder launched {fired}, expected {expect}")


# launches per image the dispatch implies for SD v1.4 at 512px with batched
# CFG and 20 steps. Per UNet call K2 fires in the 15 transformers at
# 64^2/32^2/16^2 (not the 8^2 middle), K5 in the 10 below 2048 tokens, K4
# twice and K3 once in the 5 at 64^2. The VAE decoder runs its 14
# ResnetBlocks (all at >= 64^2) as 28 K6 launches, the upsamplers at 128^2
# and 256^2 as K7 (the one at 64^2 stays plain), the output norm as K8, and
# K3 where no kernel handed statistics on: the two mid blocks and the block
# after the plain upsampler.
EXPECTED_LAUNCHES = {"channel_partials": 103, "conv1x1_fused": 200,
                     "fused_self_attention": 300, "fused_geglu_mlp": 200,
                     "conv3x3_fused": 28, "upsample2x_conv_fused": 2,
                     "group_norm_silu": 1}


def phase_generate(dev) -> dict:
    """Phase 4: StableDiffusion.generate at SD v1.4 width, random weights,
    bf16, 512x512, 20 DDIM steps, CFG 7.5, batch 1. Returns launch counts."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.weights import init_params

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(SD_V1_4, gen, device=dev)
    sd = StableDiffusion(params, SD_V1_4, compute_dtype=torch.bfloat16)
    del params
    tok = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f"generate: SD v1.4 random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    latents = []
    decode = sd.latent_to_image

    def keep_latent(latent):
        latents.append(latent)
        return decode(latent)

    sd.latent_to_image = keep_latent
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    images = sd.generate(tok, "An ancient mossy stone.", guidance_scale=7.5, n_steps=20,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}

    lat = latents[0]
    finite = bool(torch.isfinite(lat).all())
    print(f"generate 512x512 bf16 20 DDIM steps CFG 7.5: image {tuple(images.shape)} "
          f"{images.dtype}, latent {tuple(lat.shape)} finite={finite} "
          f"mean {float(lat.mean()):.4f} std {float(lat.std()):.4f}, pixels mean "
          f"{float(images.mean()):.2f} std {float(images.std()):.2f}", flush=True)
    print(f"generate wall {wall:.3f} s: encode_prompt {sd.timings['encode_prompt']:.3f} s, "
          f"denoise {sd.timings['denoise']:.3f} s, decode {sd.timings['decode']:.3f} s",
          flush=True)
    print(f"generate launches {launches} expected {EXPECTED_LAUNCHES}", flush=True)
    if images.shape != (1, 512, 512, 3) or str(images.dtype) != "uint8":
        fail(f"image {images.shape} {images.dtype}, expected (1, 512, 512, 3) uint8")
    if not finite:
        fail("the final latent has non-finite values")
    if launches != EXPECTED_LAUNCHES:
        fail(f"launch counts {launches} differ from {EXPECTED_LAUNCHES}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU only")
    try:
        import sdtpu_torch  # noqa: F401
    except ImportError:
        fail("sdtpu_torch is not importable: run from the root of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # phase 1: device and build
    print(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from sdtpu_torch import kernels

    t0 = time.perf_counter()
    path, _ = kernels.build()
    kernels.lib()
    print(f"build {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: each kernel against its plain version
    results = phase_kernels(dev)
    # phase 3: one SpatialTransformer, then the VAE decoder, card against CPU
    phase_transformer(dev)
    phase_decode(dev)
    # phase 4: the main path
    launches = phase_generate(dev)

    kernels_json = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels_json.append({"name": name, "route": route, "source": source,
                             "replaces": replaces, "launches": launches.get(name, 0),
                             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                             "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
