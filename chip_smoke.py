"""Drive the sdtpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines:

1. device and build: the card's name and power limit (nvidia-smi), then
   the kernels built from sdtpu_torch/csrc with nvcc (one process per
   source, all at once);
2. each kernel against its plain PyTorch version on the card, at the
   shapes SD v1.4's UNet, VAE decoder and VAE encoder give it at 512px and
   at 1024px (the UNet's also at batch 1, the two-pass mode's), and
   training's (K1 with its row statistics, K9, at UNet batch 4, 8 and 2;
   the encoder at batch 8, 4 and 1), and those SD v2.1 gives them at 768px
   (head width 64: 5 heads at 96², 10 at 48²; the VAE on 96² latents and
   768² images; training at batch 2; labels ending in "v2.1"), in float32
   and bfloat16: max error against the stated tolerance, the times of the
   kernel, of its plain version and, where one PyTorch call computes the
   same function, of that call (CUDA events), and the least time the card
   could take for the same work (its bound). Every kernel is also timed in
   bfloat16 by the card's own clock (sdtpu_torch.profile_kernels.device_ms:
   20 wrapper calls captured in a CUDA graph, the replay timed; a timing of
   a slow call takes fewer, about BUDGET_MS of calls and at least 3), and K5, K9,
   K2, K6, K1, K4, K10, K7 and K3 their Hopper kernels against the kernels
   they replaced, in turns (old, new, new, old). Planted faults must fail
   each kernel's tolerance at every case: for K6 the convolution without
   the border mask (the prologue applied to the zero-padded map) and, with a
   second input, the convolution without it; for K4 the product without its
   prologue (proj_in) or without its residual (proj_out); for K7 the phases
   interleaved with py and px swapped and the taps read one pixel off (the
   map shifted by one); for K2 the attention over every other key; for K1
   an all-zero output, the attention over every other key, with a key bias
   the attention that ignores it, with the row statistics those
   statistics in natural log, and at d = 512 the wide kernel's walk with
   each warpgroup's softmax on its own key slice's row maximum (no
   exchange) and with the two warpgroups' P slices swapped; for K3 the sums
   with one cluster rank's rows dropped and with batch b + 1's rows read for
   b; (K9 and K10 have their own, below);
3. one SpatialTransformer at the 64x64 latent level (C=320), random
   weights, run on the card (kernels) and on the CPU (plain versions); the
   VAE decoder at SD v1.4 width on a 16x16 latent with every fused gate
   opened, card against CPU; one fused up-path ResBlock of the 1024px UNet
   (128x128, 640 + 320 skip channels -> 320), card against CPU; the
   gradients of one 64x64 SpatialTransformer in training (K1 + K9), card
   against CPU;
4. StableDiffusion.generate at SD v1.4 width with random weights: bf16,
   20 DDIM steps, CFG 7.5, batch 1, first at 512x512, then at 1024x1024
   (the same config with image_size=1024). Each must give a
   [1, size, size, 3] uint8 image from finite latents, and the kernels'
   launch counters, set to 0 just before each run and read just after,
   must read exactly what the dispatch implies; K2's, K6's, K4's and K7's
   launches (and K10's in the serve phase), counted per route, must all
   take their Hopper kernels (here, in the serve phase and in the
   fine-tuning cache build), K3's its cluster kernel wherever its plan has
   one (every main-path C), and K1's one launch at 1024px (the decoder's
   d = 512) the wide kernel;
5. sdtpu_torch.finetune.run_finetune at SD v1.4 width and depth, 512x512,
   from a folder of synthetic PNGs: the latent cache through the port's
   VAE encoder and CLIP, then 3 AdamW steps at batch 4 in bf16, the tuned
   model written and read back; the launch counts of the cache build and
   of the training (K1 and K9 only, every K1 launch on the Hopper core),
   finite losses, every UNet leaf changed; then one more step each with
   remat "full" and "dots";
6. sdtpu_torch.serve at SD v1.4 width, 512x512, bf16, with K10's gate open
   (SDTPU_FUSED_XATTN=1) and one random LoRA adapter, driven through its
   socket: concurrent requests batched to 4, the other samplers, img2img,
   inpainting, the adapter, a bad request; a lone seeded request must
   equal generate() byte for byte and K10 must launch 15 times a UNet
   call, every launch on its Hopper route; then an A/B of K10's gate: the
   UNet call's device time in AB_PAIRS pairs of open and closed (in
   turns), and a lone request's latency in AB_ROUNDS rounds of open,
   closed, closed, open;
7. (run after phase 4) the command lines at SD v1.4 width and depth
   (phase 4's weights: init_params, seed 0, f32) in a temporary directory:
   the weights written once as native, `python -m sdtpu_torch.convert
   --to-dump` and back and `--to-mpk` and `--mpk` back, every leaf
   bit-equal, each file's size and each write's and read's seconds printed;
   `python -m sdtpu_torch.sample dump|native ... --seed 0 --bf16` on the
   card (the device argument omitted), each PNG byte-equal to an
   in-process generate in bf16 with the same generator, each run's load
   and sampling seconds and launches read from its SDTPU_PROFILE=1 report;
   then the two-pass generate (pad_context=False), its launches those of
   two UNet calls a step at batch 1 (on their Hopper routes), its image
   within TWOPASS_MEAN_TOL gray levels (mean) of the batched mode's, a
   bound that the guidance with uncond and cond swapped and the uncond
   context used for both calls exceed; and one denoising step's UNet work
   by device time in both modes, in turns; and, before them, one f32
   generate with the TF32 switches a fresh process has against the same
   generate with both off, its max and mean gray-level difference printed
   (a record, not a check);
8. (run after phase 5) `python -m sdtpu_torch.finetune` at SD v1.4 width
   and depth, 512x512 (phase 4's weights written once as native), on
   phase 5's PNGs with captions that hold a placeholder, in new processes
   on the card under SDTPU_PROFILE=1: --fast (adafactor, batch 8) with EMA
   and the train state saved, then resumed for one more step; LoRA with
   two micro-batches summed in bf16; textual inversion. Checks the losses,
   the state read back, the tuned model, the adapter's merge against the
   base, the concept's rows, and the launches of each run (K1 and K9 in
   training, on their Hopper routes, and the encoder's K3 and K6 where a
   run encodes images);
9. (run after phase 4) SD v2.1 at 768x768, full width and depth (SD_V2_1,
   random weights, seed 0, bf16): generate with DDIM and with DPM++ on the
   Karras ladder, img2img and inpainting on the DDIM image, one UNet call
   with K10's gate open (10 heads at 48²), `python -m sdtpu_torch.sample
   native ... --preset sd-v2-1 --sampler dpmpp --karras --seed 0 --bf16`
   byte-equal to an in-process generate, and run_finetune at 768px (the
   v target); each run's launches exactly the dispatch's, on their Hopper
   routes.

It prints a JSON line of per-kernel results, then the card's name and
power limit, then, last, {"ok": true, "device": {...}}. Any failure
exits nonzero before that line; there is no CPU fallback. In the JSON
line `launches` is the sum of the main paths' runs (both generate runs,
the CLI phase's two sample processes and two in-process generates, the
fine-tuning run with its cache build, the serve phase, phase 8's four
`finetune` processes, and phase 9's runs), and `ms`, `plain_ms`,
`bound_ms` and `library_ms` are for those launches: each wrapper counts
its launches per shape as well, and each shape's bfloat16 time (or bound)
from phase 2 is taken as many times as the runs launched it. A shape
launched there with no case in phase 2 is a failure. Every launched
kernel also carries `device_ms` (the same launches by device time), and K5,
K9, K2, K6, K1, K4, K10, K7 and K3 `replaced_device_ms` (those of the
kernels their bf16 route replaced: the WMMA kernels, K3's partials kernel with
its sum) and `sources_by_route`. K5's `library_ms` is both of its
products as two torch.matmul calls; K2's and K10's are SDPA on the core
alone, K6's cuDNN's convolution alone (F.conv2d), K7's cuDNN's convolution
over the already upsampled map.

Bounds: max(operations / peak rate, bytes / 3.35 TB/s), the inputs read
once and the outputs written once; products at the tensor cores' dense
bf16 peak (989 TFLOP/s), the normalisation passes at the f32 peak outside
them (67 TFLOP/s): the NVIDIA H100 SXM data sheet's rates, which assume a
700 W power limit.

Precision: float32 matmuls and convolutions in the plain versions run in
full float32 (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are both set False here). The kernels run
float32 products on the tensor cores as TF32 with float32 accumulation,
so the float32 tolerances below are TF32 tolerances.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

SEED = 0
WARMUP, ITERS = 3, 20
BUDGET_MS = 50  # the calls a phase-2 timing spends on a slow kernel
PEAK_TENSOR = 989e12  # dense bf16 FLOP/s
PEAK_F32 = 67e12      # f32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12    # dense TF32 FLOP/s: the float32 routes' products
# the prefix of a float32 launch's shape key in the main paths' totals: the
# wrappers' keys name no dtype, and phase 8's processes run the VAE encoder
# in float32 (the model loads in f32, as sdtpu's `finetune` loads it)
F32_KEY = "dtype=float32 "
HBM = 3.35e12         # bytes/s


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def budget(fn) -> int:
    """How many calls a timing of fn() takes: ITERS, or fewer where a call
    is slow, about BUDGET_MS of calls and at least 3 (one untimed call, then
    one timed by the host's clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(ITERS, int(BUDGET_MS / max(1e3 * (time.perf_counter() - t0), 1e-6))))


def cuda_ms(fn, iters=None) -> float:
    """Mean time of fn() on the card, CUDA events around `iters` calls
    (budget(fn) when None)."""
    import torch

    iters = budget(fn) if iters is None else iters
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
# K1's outputs are averages over thousands of keys, about (e/S)^1/2 in size
# (0.013 at S=16384), far below TOL's atol: its atol is this fraction of
# the largest |reference| instead, with this rtol (f32: TF32 products;
# bf16: a few ulps). phase_kernels checks that an all-zero output and one
# over every other key fail it. K9's gradients, sums over thousands of keys
# or queries, are held to the same: f32, TF32 products and Δ = rowsum(dO ∘
# o) from the TF32 forward's o; bf16, Δ from the bf16 o (rounded to 2^-8,
# where the plain version takes rowsum(dP ∘ P) in f32) and P, dS rounded to
# bf16 at other points; phase_kernels checks that a zeroed dk and the dq
# over every other key fail it.
FLASH_TOL = {"float32": (2.0 ** -8, 2.0 ** -10), "bfloat16": (2.0 ** -6, 2.0 ** -7)}
# K1's row statistics (log2 domain, values about 12 at S=4096): the scores
# differ by the summation order (bf16 inputs: 2e-6 measured) or TF32's
# rounding of q and k (f32: 5e-4); a wrong max or sum is off by far more
LSE_TOL = 2.0 ** -9


def within(got, want, atol, rtol) -> tuple[float, bool]:
    """(max abs error, whether got is finite and |got - want| <= atol + rtol|want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


class Case(NamedTuple):
    """One main-path shape of a kernel. ops and peak: the operations the
    function needs and the card's rate for them; library: one PyTorch call
    that computes the same function on the same inputs, or None; its time
    is taken less that of library_minus when given (K9: SDPA's forward and
    backward less its forward). old: the route the kernel replaced, in
    bf16; yardsticks: (label, fn) pairs timed and printed as well."""
    name: str
    shape: str
    fn: Callable
    plain: Callable
    args: tuple
    kw: dict
    ops: float
    peak: float = PEAK_TENSOR
    library: Optional[Callable] = None
    library_minus: Optional[Callable] = None
    # the route the kernel's bf16 Hopper kernel replaced (the WMMA kernels of K5, K9,
    # K2, K6, K1, K4, K10, K7; K3's partials kernel), timed against it in turns; and
    # yardsticks printed beside library
    old: Optional[Callable] = None
    yardsticks: tuple = ()


def decoder_convs(lat: int) -> list:
    """(hw, c_in, c_out, residual, stats) of each K6 launch of SD v1.4's VAE
    decoder on a lat x lat latent: the two mid ResnetBlocks, then three a
    level (the first changes the width), each as conv1 (no residual) and
    conv2 (with it); every conv emits statistics but the first mid block's
    conv2."""
    from sdtpu_torch.config import SD_V1_4

    chans = SD_V1_4.vae.decoder_channels
    mid = chans[0][0]
    blocks = [(lat, mid, mid)] * 2
    for level, (ci, co) in enumerate(chans):
        blocks += [(lat << level, ci, co)] + [(lat << level, co, co)] * 2
    convs = []
    for i, (hw, ci, co) in enumerate(blocks):
        convs += [(hw, ci, co, False, True), (hw, co, co, True, i != 0)]
    return convs


def encoder_resnets(size: int) -> tuple:
    """(map size, input channels, output channels) of the distinct
    ResnetBlocks of SD's VAE encoder (v1.4's and v2.1's are one) on a
    size x size image; the first of each level's two blocks changes the
    width, the mid block's two run at size/8 with 512 channels."""
    return ((size, 128, 128), (size // 2, 128, 256), (size // 2, 256, 256),
            (size // 4, 256, 512), (size // 4, 512, 512), (size // 8, 512, 512))


def kernel_cases(dtype, dev):
    """Main-path inputs for each kernel. Shapes are SD v1.4's at 512px and
    1024px: the UNet's with batched CFG (B=2, 20 steps), the VAE decoder's
    (B=1, once); and SD v2.1's at 768px (labels ending in "v2.1"): head
    width 64, so 5 heads at the UNet's 96² level and 10 at 48², context
    1024, the VAE on 96² latents and 768² images."""
    import torch
    import torch.nn.functional as F

    from sdtpu_torch.ops import (conv, flash_attention, fused_conv, fused_cross_attention,
                                 fused_groupnorm, fused_mlp, fused_transformer)

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def gn_fold(x, eps, x2=None):
        c = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
        gamma, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
        sums = fused_groupnorm.channel_partials_plain(x)
        if x2 is not None:
            sums = torch.cat([sums, fused_groupnorm.channel_partials_plain(x2)], dim=-1)
        return fused_conv.stats_scale_bias(sums, x.shape[1] * x.shape[2], gamma, beta, 32, eps)

    def k3_partials(x):
        """K3 on the partials kernel and its sum (two launches),
        which the cluster kernel replaced."""
        return fused_groupnorm._channel_partials(x, "partials")

    cases = []
    # K3: the UNet's ResBlock inputs and skips (1024px) and its transformers'
    # entry GroupNorm at 64x64 (512px: C=320, 1024px: C=640; the two-pass
    # mode's UNet at B=1, the serve phase's batch of 4 at B=8); the
    # decoder's (the serve phase's at B=4)
    for label, shape in (("64x64x320 B=2", (2, 64, 64, 320)),
                         ("64x64x320 B=1", (1, 64, 64, 320)),
                         ("64x64x320 B=8", (8, 64, 64, 320)),
                         ("vae 64x64x512 B=4", (4, 64, 64, 512)),
                         ("vae 128x128x512 B=4", (4, 128, 128, 512)),
                         ("64x64x640 B=2", (2, 64, 64, 640)),
                         ("128x128x320 B=2", (2, 128, 128, 320)),
                         ("128x128x640 B=2", (2, 128, 128, 640)),
                         ("vae 64x64x512", (1, 64, 64, 512)),
                         ("vae 128x128x512", (1, 128, 128, 512)),
                         # SD v2.1 at 768px: the transformers at 96², the
                         # decoder's mid blocks and its block after the
                         # plain 96² upsampler
                         ("96x96x320 B=2 v2.1", (2, 96, 96, 320)),
                         ("vae 96x96x512 v2.1", (1, 96, 96, 512)),
                         ("vae 192x192x512 v2.1", (1, 192, 192, 512))):
        x = rnd(*shape)
        cases.append(Case("channel_partials", label, fused_groupnorm.channel_partials,
                          fused_groupnorm.channel_partials_plain, (x,), {}, 3 * x.numel(),
                          PEAK_F32, old=k3_partials))

    # K4: proj_in (GroupNorm prologue) and proj_out (residual) at 64x64x320
    # (512px; B=1 in the two-pass mode, B=8 in the serve phase's batch),
    # 128x128x320 and 64x64x640 (1024px)
    def k4_wmma(x, w, cb, ps=None, pb=None, residual=None, silu=False, emit_stats=False):
        """K4 on the WMMA kernel its bf16 Hopper kernel replaced."""
        return fused_conv._conv1x1(x, w, cb, ps, pb, residual, silu, emit_stats, "wmma")

    for b, rows, c in ((2, 4096, 320), (2, 16384, 320), (2, 4096, 640), (8, 4096, 320),
                       (1, 4096, 320), (2, 9216, 320)):  # the last, SD v2.1's 96²
        xr = rnd(b, rows, c)
        scale, bias = fused_conv.stats_scale_bias(
            fused_groupnorm.channel_partials_plain(xr), rows, rnd(c, scale=0.1) + 1.0,
            rnd(c, scale=0.1), 32, 1e-5)
        w, cb = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
        ops = 2 * 2 * rows * c * c

        def product(*a, xr=xr, w=w, **k):  # the 1x1 product alone
            return torch.matmul(xr, w)

        tag = " v2.1" if rows == 9216 else ""
        cases.append(Case("conv1x1_fused", f"proj_in {rows}x{c} B={b}{tag}",
                          fused_conv.conv1x1_fused, fused_conv.conv1x1_fused_plain,
                          (xr, w, cb, scale, bias), {}, ops * b // 2, library=product,
                          old=k4_wmma))
        cases.append(Case("conv1x1_fused", f"proj_out {rows}x{c} B={b}{tag}",
                          fused_conv.conv1x1_fused, fused_conv.conv1x1_fused_plain,
                          (xr, w, cb), {"residual": rnd(b, rows, c)}, ops * b // 2,
                          library=product, old=k4_wmma))

    # K2 at every UNet level of both sizes (the 16x16 middle block at 1024px),
    # of the two-pass mode's batch 1 and of the serve phase's batch of 4
    # (B=8), 8 heads; and SD v2.1's at 768px, 5 heads at 96² and 10 at 48²,
    # all of 64 (24² has 576 tokens, no multiple of 128: no K2)
    for b, s, c, nh in ([(b, s, c, 8) for b, s, c in (
            (2, 4096, 320), (2, 1024, 640), (2, 256, 1280), (2, 16384, 320), (2, 4096, 640),
            (2, 1024, 1280), (1, 4096, 320), (1, 1024, 640), (1, 256, 1280), (8, 4096, 320),
            (8, 1024, 640), (8, 256, 1280))] + [(2, 9216, 320, 5), (2, 2304, 640, 10)]):
        x = rnd(b, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 3 * c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5),
                rnd(c, scale=0.1), nh)
        # the attention core alone, on the heads of the fused QKV product
        qkv4 = torch.matmul(x, args[3]).view(b, s, 3, nh, c // nh).permute(2, 0, 3, 1, 4)

        def core(*a, qkv4=qkv4, **k):
            return F.scaled_dot_product_attention(qkv4[0], qkv4[1], qkv4[2])

        def k2_wmma(*a):  # the WMMA route the bf16 Hopper kernels replaced
            return fused_transformer._self_attention(*a, 1e-5, "wmma")

        cases.append(Case("fused_self_attention",
                          f"S={s} C={c} dh={c // nh} B={b}{' v2.1' if nh != 8 else ''}",
                          fused_transformer.fused_self_attention,
                          fused_transformer.fused_self_attention_plain, args, {},
                          b * (8 * s * c * c + 4 * s * s * c), library=core, old=k2_wmma))
    # K5 at the UNet's levels below 2048 tokens (both sizes, batch 2, the
    # two-pass mode's 1 and the serve phase's 8), and two row counts that are
    # not a multiple of the Hopper kernel's 128-row tile (no main path
    # launches them)
    for b, s, c in ((2, 1024, 640), (2, 256, 1280), (2, 1024, 1280), (1, 1024, 640),
                    (1, 256, 1280), (8, 1024, 640), (8, 256, 1280), (1, 1000, 640),
                    (3, 333, 1280)):
        x = rnd(b, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 8 * c, scale=c ** -0.5), rnd(8 * c, scale=0.1),
                rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1))
        h = rnd(b, s, 4 * c)

        def first_product(*a, x=x, w=args[3], **k):  # LN(x)·W_proj's product alone
            return torch.matmul(x, w)

        def both_products(*a, x=x, h=h, w=args[3], w2=args[5], **k):  # the two products
            return torch.matmul(x, w), torch.matmul(h, w2)

        cases.append(Case("fused_geglu_mlp", f"S={s} C={c} B={b}", fused_mlp.fused_geglu_mlp,
                          fused_mlp.fused_geglu_mlp_plain, args, {}, b * 24 * s * c * c,
                          library=both_products, old=fused_mlp._mlp_wmma,
                          yardsticks=(("first product", first_product),)))

    # K10: the UNet's cross-attention sublayers at 512px with SDTPU_FUSED_XATTN=1
    # (S 4096/1024/256, C 320/640/1280, 8 heads, 77 keys), at the serve phase's
    # UNet batches: 2 (a lone request), 4, 8 (its batch of 4); and SD v2.1's
    # at 768px, the 48² level's (10 heads, a context of width 1024; 96² has
    # more than 4096 tokens, 24²'s 576 are no multiple of 128); kt/vt the
    # transposed views the UNet hands over, key_valid the padded prompts'
    for b, s, c, dctx, nh in ([(b, s, c, 768, 8) for b in (2, 4, 8) for s, c in (
            (4096, 320), (1024, 640), (256, 1280))] + [(2, 2304, 640, 1024, 10)]):
        x, ctx = rnd(b, s, c), rnd(b, 77, dctx)
        wk, wv = rnd(dctx, c, scale=dctx ** -0.5), rnd(dctx, c, scale=dctx ** -0.5)
        kt, vt = (torch.matmul(ctx, w).transpose(1, 2) for w in (wk, wv))
        valid = torch.arange(77, device=dev)[None] < torch.tensor(
            [2, 9] * (b // 2), device=dev)[:, None]
        args = (x, kt, vt, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1))
        # the attention core alone, on the heads of the Q product and of K
        # and V, with a boolean key mask
        q4, k4, v4 = (t.reshape(b, -1, nh, c // nh).transpose(1, 2) for t in (
            torch.matmul(x, args[5]), kt.transpose(1, 2), vt.transpose(1, 2)))

        def xcore(*a, q4=q4, k4=k4, v4=v4, key_valid=None, **k):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=key_valid[:, None, None, :])

        def xsublayer(x, kt, vt, g, beta, wq, wo, bo, k4=k4, v4=v4, key_valid=None, n_head=8,
                      **k):
            """The whole sublayer by library calls: F.layer_norm, two
            torch.matmul and SDPA."""
            q = torch.matmul(F.layer_norm(x, x.shape[-1:], g, beta), wq)
            o = F.scaled_dot_product_attention(
                q.view(*q.shape[:2], n_head, -1).transpose(1, 2), k4, v4,
                attn_mask=key_valid[:, None, None, :])
            return x + torch.matmul(o.transpose(1, 2).reshape(x.shape), wo) + bo

        def k10_wmma(*a, key_valid=None, n_head=8):
            """K10 on the WMMA kernels its bf16 Hopper route replaced."""
            return fused_cross_attention._cross_attention_kv(*a, key_valid, n_head, 1e-5,
                                                             "wmma")

        def k10_ctx_wmma(*a, key_valid=None, n_head=8):
            return fused_cross_attention._cross_attention(*a, key_valid, n_head, 1e-5, "wmma")

        tag = "" if nh == 8 else f" heads={nh} ctx={dctx} v2.1"
        cases.append(Case("fused_cross_attention_kv", f"S={s} C={c} B={b} Sk=77{tag}",
                          fused_cross_attention.fused_cross_attention_kv,
                          fused_cross_attention.fused_cross_attention_kv_plain, args,
                          {"key_valid": valid, "n_head": nh},
                          2 * b * s * c * (2 * c + 2 * 77), library=xcore, old=k10_wmma,
                          yardsticks=(("sublayer by library calls", xsublayer),)))
        if b == 2 and nh == 8:  # the entry that projects the context itself (no path runs it)
            cases.append(Case("fused_cross_attention", f"S={s} C={c} B={b} Sk=77",
                              fused_cross_attention.fused_cross_attention,
                              fused_cross_attention.fused_cross_attention_plain,
                              (x, ctx, *args[3:6], wk, wv, *args[6:]),
                              {"key_valid": valid, "n_head": 8},
                              2 * b * s * c * (2 * c + 2 * 77) + 2 * b * 77 * 768 * 2 * c,
                              library=xcore, old=k10_ctx_wmma))

    def heads4(n_head, *ts):
        return [t.view(t.shape[0] // n_head, n_head, *t.shape[1:]) for t in ts]

    # K1: the VAE's mid-block attention at 1024px (one head, d=512), a
    # key-padding bias case (no launch on the main path), and training's
    # forward at the 64² level of the 512px UNet (8 heads of 40) with the
    # row statistics K9 takes: batch 4 (phase 5, textual inversion), 8
    # (--fast) and 2 (LoRA's micro-batch); SD v2.1 at 768px: the VAE's mid
    # attention at 96² (S 9216, d 512; the encoder's at batch 2 in the
    # fine-tuning cache build) and training's forward at the UNet's 96²
    # level (batch 2, 5 heads of 64)
    for bh, n_head, s, d, bias, lse in ((1, 1, 16384, 512, False, False),
                                        (16, 8, 4096, 80, True, False),
                                        (32, 8, 4096, 40, False, True),
                                        (64, 8, 4096, 40, False, True),
                                        (16, 8, 4096, 40, False, True),
                                        (1, 1, 9216, 512, False, False),
                                        (2, 1, 9216, 512, False, False),
                                        (10, 5, 9216, 64, False, True)):
        q, k, v = rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d)
        kb = None
        if bias:
            kb = torch.where(torch.arange(s, device=dev)[None] < torch.tensor(
                [[s // 3], [s - 77]], device=dev), 0.0, -1e30).to(torch.float32)

        def sdpa(q, k, v, key_bias=None, n_head=1, return_lse=False):
            mask = None if key_bias is None else key_bias[:, None, None, :].to(q.dtype)
            return F.scaled_dot_product_attention(*heads4(n_head, q, k, v), attn_mask=mask)

        def k1_wmma(q, k, v, key_bias=None, n_head=1, return_lse=False):
            """K1 on the WMMA kernel (csrc/flash_attention.cu), which its
            bf16 routes replaced (the core at d <= 160, the wide kernel at
            d = 512)."""
            return flash_attention._heads(q, k, v, key_bias, n_head, return_lse, "wmma")

        cases.append(Case("flash_attention_heads",
                          f"BH={bh} S={s} d={d}{' bias' if bias else ''}{' lse' if lse else ''}"
                          f"{' v2.1' if s == 9216 else ''}",
                          flash_attention.flash_attention_heads,
                          flash_attention.flash_attention_heads_plain,
                          (q, k, v, kb, n_head), {"return_lse": lse}, 4 * bh * s * s * d,
                          library=sdpa, old=k1_wmma))

    # K9: training's backward at the 64² level of the 512px UNet (batch 4,
    # 8 and 2, as K1's), the 1024px UNet's 128² and 64² levels and its 32²
    # level's d=160 (batch 4, 8 heads), and SD v2.1's 96² level at 768px
    # (batch 2, 5 heads of 64), from K1's output and row statistics as
    # training hands them over
    for bh, n_head, s, d in ((32, 8, 4096, 40), (64, 8, 4096, 40), (16, 8, 4096, 40),
                             (32, 8, 16384, 40), (32, 8, 4096, 80), (32, 8, 1024, 160),
                             (10, 5, 9216, 64)):
        q, k, v, do = rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d)
        o, lse = flash_attention.flash_attention_heads(q, k, v, n_head=n_head, return_lse=True)

        def bwd_plain(q, k, v, do, o, lse, n_head):
            return flash_attention.flash_attention_bwd_heads_plain(q, k, v, do)

        def sdpa_fwd(q, k, v, do, o, lse, n_head):
            q4, k4, v4 = (t.detach().requires_grad_() for t in heads4(n_head, q, k, v))
            return F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4)

        def sdpa_fwd_bwd(q, k, v, do, o, lse, n_head):
            out, ins = sdpa_fwd(q, k, v, do, o, lse, n_head)
            return torch.autograd.grad(out, ins, do.view_as(out))

        def bwd_wmma(q, k, v, do, o, lse, n_head):
            return flash_attention._bwd_heads(q, k, v, do, o, lse, n_head, "wmma")

        cases.append(Case("flash_attention_bwd_heads",
                          f"BH={bh} S={s} d={d}{' v2.1' if s == 9216 else ''}",
                          flash_attention.flash_attention_bwd_heads, bwd_plain,
                          (q, k, v, do, o, lse), {"n_head": n_head}, 5 * 2 * bh * s * s * d,
                          library=sdpa_fwd_bwd, library_minus=sdpa_fwd, old=bwd_wmma))

    # K6 (GN+SiLU prologue, output statistics): the UNet's fused ResBlocks
    # at 128x128 (1024px, B=2): conv_in over x or over the implicit skip
    # concat (x2), conv_out with the residual; the VAE decoder's ResnetBlock
    # convs at both sizes
    def k6_wmma(x, w, cb, ps=None, pb=None, residual=None, silu=True, emit_stats=False,
                x2=None, prologue_scale2=None, prologue_bias2=None):
        """K6 on the WMMA kernel its bf16 Hopper kernel replaced."""
        return fused_conv._conv3x3(x, w, cb, ps, pb, residual, silu, emit_stats, x2,
                                   prologue_scale2, prologue_bias2, "wmma")

    def conv_case(label, b, hw, ci, co, c2, eps, residual=True, stats=True):
        x = rnd(b, hw, hw, ci)
        x2 = rnd(b, hw, hw, c2) if c2 else None
        scale, bias = gn_fold(x, eps, x2)
        w, cb = rnd(3, 3, ci + c2, co, scale=(9 * (ci + c2)) ** -0.5), rnd(co, scale=0.1)
        kw = {"residual": rnd(b, hw, hw, co) if residual else None, "emit_stats": stats}
        args = (x, w, cb, scale[:, :ci], bias[:, :ci])
        if c2:
            kw.update(x2=x2, prologue_scale2=scale[:, ci:], prologue_bias2=bias[:, ci:])
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def conv(*a, **k):  # the convolution alone, without prologue or epilogue
            xin = x if x2 is None else torch.cat([x, x2], dim=-1)
            return F.conv2d(xin.permute(0, 3, 1, 2), w_oihw, cb.to(dtype), padding=1)

        cases.append(Case("conv3x3_fused", label, fused_conv.conv3x3_fused,
                          fused_conv.conv3x3_fused_plain, args, kw,
                          2 * 9 * b * hw * hw * (ci + c2) * co, library=conv, old=k6_wmma))

    conv_case("unet 128x128 640+320->320 B=2", 2, 128, 640, 320, 320, 1e-5, residual=False)
    conv_case("unet 128x128 320+320->320 B=2", 2, 128, 320, 320, 320, 1e-5, residual=False)
    conv_case("unet 128x128 320->320 B=2", 2, 128, 320, 320, 0, 1e-5, residual=False)
    conv_case("unet 128x128 320->320 B=2 res", 2, 128, 320, 320, 0, 1e-5)
    # the decoder at 512px and 1024px (B=1), the serve phase's batch of 4,
    # and SD v2.1's at 768px (a 96² latent)
    seen = set()
    for b, lat in ((1, 64), (1, 128), (4, 64), (1, 96)):
        for conv_shape in decoder_convs(lat):
            if (b, conv_shape) in seen:
                continue
            seen.add((b, conv_shape))
            hw, ci, co, res, st = conv_shape
            conv_case(f"vae {hw}x{hw} {ci}->{co}{' res' if res else ''}"
                      f"{'' if st else ' no stats'} B={b}{' v2.1' if lat == 96 else ''}",
                      b, hw, ci, co, 0, 1e-6, res, st)

    # the VAE encoder's ResnetBlocks while the latent cache is built (512px,
    # chunks of 4 images, of 8 under --fast, textual inversion's data in
    # chunks of 4; SD v2.1 at 768px, a chunk of 2) and in img2img/inpainting
    # (one image, at 512px and 768px): K3 on each block's input, conv1 with
    # the statistics, conv2 with the residual and without them
    for b, size in ((8, 512), (4, 512), (1, 512), (2, 768), (1, 768)):
        tag = " v2.1" if size == 768 else ""
        for hw, ci, co in encoder_resnets(size):
            x = rnd(b, hw, hw, ci)
            cases.append(Case("channel_partials", f"encoder {hw}x{hw}x{ci} B={b}{tag}",
                              fused_groupnorm.channel_partials,
                              fused_groupnorm.channel_partials_plain, (x,), {}, 3 * x.numel(),
                              PEAK_F32, old=k3_partials))
            conv_case(f"encoder {hw}x{hw} {ci}->{co} B={b}{tag}", b, hw, ci, co, 0, 1e-6,
                      residual=False)
        for hw, co in sorted({(hw, co) for hw, _, co in encoder_resnets(size)}, reverse=True):
            conv_case(f"encoder {hw}x{hw} {co}->{co} B={b} res{tag}", b, hw, co, co, 0, 1e-6,
                      stats=False)

    # K7: the decoder's upsamplers at 128² and 256² (512px), 256² x 512 and
    # 512² (1024px), the serve phase's batch of 4, and 192² and 384² (SD
    # v2.1 at 768px; its 96² one stays plain), reading the phase weights
    # folded once, as the pipeline hands them over
    def k7_wmma(x, w, cb, emit_stats=False, phases=None):
        """K7 on the WMMA kernel its bf16 Hopper kernel replaced."""
        return fused_conv._upsample2x(x, w, cb, emit_stats, "wmma", phases)

    for b, hw, c, co in ((1, 128, 512, 512), (1, 256, 256, 256), (1, 256, 512, 512),
                         (1, 512, 256, 256), (4, 128, 512, 512), (4, 256, 256, 256),
                         (1, 192, 512, 512), (1, 384, 256, 256)):
        args = (rnd(b, hw, hw, c), rnd(3, 3, c, co, scale=(9 * c) ** -0.5), rnd(co, scale=0.1))
        # cuDNN's convolution alone over the already upsampled map, and the
        # path with the fused gate closed (ops/conv.py: four phase convs)
        xu = conv.nearest_upsample_2x(args[0]).permute(0, 3, 1, 2)
        w_oihw = args[1].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def up_conv(*a, xu=xu, w_oihw=w_oihw, cb=args[2], **k):
            return F.conv2d(xu, w_oihw, cb, padding=1)

        def gate_closed(x, w, cb, **k):
            gate = conv.FUSED_UP_MIN_ROWS
            conv.FUSED_UP_MIN_ROWS = 1 << 30
            try:
                return conv.upsample2x_conv({"w": w, "b": cb}, x)
            finally:
                conv.FUSED_UP_MIN_ROWS = gate

        cases.append(Case("upsample2x_conv_fused",
                          f"{hw}x{hw}x{c} -> {2 * hw}x{2 * hw} B={b}"
                          f"{' v2.1' if hw in (192, 384) else ''}",
                          fused_conv.upsample2x_conv_fused,
                          fused_conv.upsample2x_conv_fused_plain, args,
                          {"emit_stats": True,
                           "phases": fused_conv.phase_weight_stack(args[1], dtype)},
                          2 * 16 * b * hw * hw * c * co, library=up_conv, old=k7_wmma,
                          yardsticks=(("gate closed", gate_closed),)))
    for b, hw in ((1, 512), (1, 1024), (4, 512), (1, 768)):
        x = rnd(b, hw, hw, 128)
        args = (x, rnd(128, scale=0.1) + 1.0, rnd(128, scale=0.1), 32, 1e-6)
        cases.append(Case("group_norm_silu",
                          f"{hw}x{hw}x128 B={b}{' v2.1' if hw == 768 else ''}",
                          fused_groupnorm.group_norm_silu,
                          fused_groupnorm.group_norm_silu_plain, args,
                          {"sums": fused_groupnorm.channel_partials_plain(x)}, 8 * x.numel(),
                          PEAK_F32))
    return cases


# name -> (route, source, the sdtpu function that reaches its pl.pallas_call)
KERNEL_INFO = {
    "flash_attention_heads": ("cuda", "sdtpu_torch/csrc/attention_sm90.cu",
                              "sdtpu/ops/flash_attention.py:220"),
    "channel_partials": ("cuda", "sdtpu_torch/csrc/channel_stats_sm90.cu",
                         "sdtpu/ops/fused_groupnorm.py:47"),
    "conv1x1_fused": ("cuda", "sdtpu_torch/csrc/conv_sm90.cu", "sdtpu/ops/fused_conv.py:428"),
    "fused_self_attention": ("cuda", "sdtpu_torch/csrc/attention_sm90.cu",
                             "sdtpu/ops/fused_transformer.py:108"),
    "fused_geglu_mlp": ("cuda", "sdtpu_torch/csrc/gemm_sm90.cu", "sdtpu/ops/fused_mlp.py:68"),
    "conv3x3_fused": ("cuda", "sdtpu_torch/csrc/conv_sm90.cu", "sdtpu/ops/fused_conv.py:152"),
    "upsample2x_conv_fused": ("cuda", "sdtpu_torch/csrc/conv_sm90.cu",
                              "sdtpu/ops/fused_conv.py:316"),
    "group_norm_silu": ("cuda", "sdtpu_torch/csrc/groupnorm.cu",
                        "sdtpu/ops/fused_groupnorm.py:82"),
    "flash_attention_bwd_heads": ("cuda", "sdtpu_torch/csrc/flash_attention_bwd_sm90.cu",
                                  "sdtpu/ops/flash_attention.py:580"),
    "fused_cross_attention_kv": ("cuda", "sdtpu_torch/csrc/attention_sm90.cu",
                                 "sdtpu/ops/fused_cross_attention.py:119"),
}
# the kernels with two or more routes: route -> sources (K1's main-path
# launches take two: bf16 at d <= 160 on the Hopper core, the 1024px
# decode's d = 512 on the wide kernel, and the WMMA kernel stays the f32
# one; K7's and K10's bf16 launches take the Hopper route, the WMMA route
# they replaced stays the f32 one; K3's launches take the cluster kernel,
# the partials kernel stays for C not a multiple of 8)
KERNEL_ROUTES = {
    "flash_attention_heads": {"sm90": "sdtpu_torch/csrc/attention_sm90.cu",
                              "wide": "sdtpu_torch/csrc/attention_wide_sm90.cu",
                              "wmma": "sdtpu_torch/csrc/flash_attention.cu"},
    "channel_partials": {"sm90": "sdtpu_torch/csrc/channel_stats_sm90.cu",
                         "partials": "sdtpu_torch/csrc/channel_stats.cu"},
    "upsample2x_conv_fused": {"sm90": "sdtpu_torch/csrc/conv_sm90.cu",
                              "wmma": "sdtpu_torch/csrc/gemm.cu"},
    "fused_cross_attention_kv": {
        "sm90": "sdtpu_torch/csrc/gemm_sm90.cu + sdtpu_torch/csrc/attention_sm90.cu",
        "wmma": "sdtpu_torch/csrc/gemm.cu + sdtpu_torch/csrc/cross_attention.cu"},
}


def wrappers() -> dict:
    """name -> the kernel's wrapper, which carries its launch count."""
    from sdtpu_torch.ops import (flash_attention, fused_conv, fused_cross_attention,
                                 fused_groupnorm, fused_mlp, fused_transformer)

    fns = (flash_attention.flash_attention_heads, fused_groupnorm.channel_partials,
           fused_conv.conv1x1_fused, fused_transformer.fused_self_attention,
           fused_mlp.fused_geglu_mlp, fused_conv.conv3x3_fused,
           fused_conv.upsample2x_conv_fused, fused_groupnorm.group_norm_silu,
           flash_attention.flash_attention_bwd_heads,
           fused_cross_attention.fused_cross_attention_kv)
    return {f.__name__: f for f in fns}


def fired(counts: dict) -> dict:
    """{kernel: launches} of the kernels that launched."""
    return {n: k for n, k in counts.items() if k}


def read_and_zero() -> tuple[dict, dict]:
    """({kernel: launches}, {kernel: {shape: launches}}) of every wrapper
    since it was last set to 0, read after a synchronise; then sets them
    to 0."""
    import torch

    torch.cuda.synchronize()
    fns = wrappers()
    counts = ({n: f.launches for n, f in fns.items()},
              {n: dict(f.shapes) for n, f in fns.items()})
    for f in fns.values():
        f.launches, f.shapes = 0, {}
    return counts


class Totals:
    """Launch counts summed over runs, per kernel and per kernel and shape."""

    def __init__(self):
        self.launches = {name: 0 for name in KERNEL_INFO}
        self.shapes = {name: {} for name in KERNEL_INFO}

    def add(self, run_launches: dict, run_shapes: dict) -> None:
        for name in KERNEL_INFO:
            self.launches[name] += run_launches.get(name, 0)
            for key, n in run_shapes.get(name, {}).items():
                self.shapes[name][key] = self.shapes[name].get(key, 0) + n


def _nbytes(*trees) -> int:
    """Bytes of every tensor in the given (nested tuples/dicts of) values."""
    import torch

    n = 0
    for t in trees:
        if torch.is_tensor(t):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif isinstance(t, dict):
            n += _nbytes(*t.values())
    return n


def launched_key(c: "Case"):
    """(result of one call of c's kernel, the key of the shape it launched,
    under which its wrapper counts it)."""
    before = dict(c.fn.shapes)
    got = c.fn(*c.args, **c.kw)
    keys = [k for k, n in c.fn.shapes.items() if n != before.get(k, 0)]
    if len(keys) != 1:
        fail(f"{c.name} {c.shape}: one call counted shapes {keys}")
    return got, keys[0]


def _check_flash(c, got, want, dname, failed):
    """K1's check: the output within FLASH_TOL, scaled to the largest
    |reference|, and that tolerance fails an all-zero output, one over
    every other key and, with a key bias, one that ignores it; with
    return_lse, the row statistics within LSE_TOL, which fails them taken
    in natural log. Returns (max abs error of the output, ok, atol, rtol)."""
    import torch

    from sdtpu_torch.ops.flash_attention import flash_attention_heads_plain

    if c.kw.get("return_lse"):
        (got, got_lse), (want, want_lse) = got, want
        lse_err, lse_ok = within(got_lse, want_lse, LSE_TOL, 0.0)
        natural = within(got_lse * math.log(2.0), want_lse, LSE_TOL, 0.0)[1]
        print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} row log2-sum-exp max_abs_err "
              f"{lse_err:.3e} (tol {LSE_TOL:g}) {'ok' if lse_ok else 'FAILED'}; the tolerance "
              f"passes it in natural log: {natural}", flush=True)
        if not lse_ok:
            failed.append(f"{c.name} {dname} {c.shape} lse")
        if natural:
            failed.append(f"{c.name} {dname} {c.shape} lse tolerance too loose")
    frac, r = FLASH_TOL[dname]
    a = frac * float(want.float().abs().max())
    q, k, v, kb, n_head = c.args
    wrong = {"an all-zero output": torch.zeros_like(want),
             "one over every other key": flash_attention_heads_plain(
                 q, k[:, ::2], v[:, ::2], None if kb is None else kb[:, ::2], n_head)}
    if kb is not None:
        wrong["one that ignores the key bias"] = flash_attention_heads_plain(q, k, v, None,
                                                                             n_head)
    if q.shape[-1] == 512 and kb is None and n_head == 1:
        wrong["the wide kernel's walk without the max exchange"] = _k1_wide_walk(
            q, k, v, exchange=False)
        wrong["the wide kernel's walk with the P slices swapped"] = _k1_wide_walk(
            q, k, v, swap=True)
    passes = {label: within(w, want, a, r)[1] for label, w in wrong.items()}
    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max |ref| {a / frac:.4f}; the "
          f"tolerance passes " + ", ".join(f"{k}: {v}" for k, v in passes.items()), flush=True)
    if any(passes.values()):
        failed.append(f"{c.name} {dname} {c.shape} tolerance too loose")
    return (*within(got, want, a, r), a, r)


def _k1_wide_walk(q, k, v, exchange=True, swap=False):
    """csrc/attention_wide_sm90.cu's walk over q, k, v [BH, S, d] (one head
    a batch element, no bias) in f32 on the card, P rounded to bf16: key
    tiles of 64, each warpgroup's 32-key slice of S, the slices' row maxima
    exchanged, each warpgroup's 256-column slice of O rescaled and
    accumulated, its own row sums added at the end. The planted faults K1's
    tolerance must fail: exchange=False, each warpgroup's softmax on its own
    slice's running maximum; swap=True, the two warpgroups' P slices written
    into each other's columns."""
    import torch
    import torch.nn.functional as F

    from sdtpu_torch.ops import flash_attention as fa

    bh, sq, d = q.shape
    sk = k.shape[1]
    bt, nw = fa.WIDE_TILE, fa.WIDE_WARPGROUPS
    keys, cols = bt // nw, d // nw
    nk = -(-sk // bt)
    qf = q.float()
    kf, vf = (F.pad(t.float(), (0, 0, 0, nk * bt - sk)) for t in (k, v))
    scale_log2 = d ** -0.5 / math.log(2.0)
    m = [torch.full((bh, sq, 1), -math.inf, device=q.device) for _ in range(nw)]
    l = [torch.zeros((bh, sq, 1), device=q.device) for _ in range(nw)]
    o = [torch.zeros((bh, sq, cols), device=q.device) for _ in range(nw)]
    for j in range(nk):
        s = []
        for w in range(nw):
            k0 = j * bt + w * keys
            sw = torch.matmul(qf, kf[:, k0:k0 + keys].transpose(-1, -2)).mul_(scale_log2)
            if k0 + keys > sk:
                sw[..., max(0, sk - k0):] = -math.inf
            s.append(sw)
        part = [sw.amax(dim=-1, keepdim=True) for sw in s]
        p, alpha = [], []
        for w in range(nw):
            m_new = torch.maximum(m[w], torch.maximum(*part) if exchange else part[w])
            alpha.append(torch.exp2(m[w] - m_new))
            m[w] = m_new
            pw = torch.exp2(s[w] - m_new)
            l[w] = l[w] * alpha[w] + pw.sum(dim=-1, keepdim=True)
            p.append(pw.to(torch.bfloat16).float())
        pt = torch.cat(p[::-1] if swap else p, dim=-1)
        for w in range(nw):
            o[w] = o[w] * alpha[w] + torch.matmul(pt, vf[:, j * bt:(j + 1) * bt,
                                                         w * cols:(w + 1) * cols])
    return (torch.cat(o, dim=-1) / (l[0] + l[1])).to(q.dtype)


K10_SCALE_ERR = 0.97  # a K10 core or a K9 dq 3 % small must fail its check


def _check_k9(c, got, want, dname, failed):
    """K9's check: dq, dk and dv each within FLASH_TOL, scaled to its largest
    |reference|, and that tolerance fails a zeroed dk, the dq of the
    gradients over every other key and a dq K10_SCALE_ERR of the reference's.
    Returns (max abs error, ok, atol of dq, rtol)."""
    import torch

    from sdtpu_torch.ops.flash_attention import flash_attention_bwd_heads_plain

    frac, r = FLASH_TOL[dname]
    atols = [frac * float(w.float().abs().max()) for w in want]
    results = [within(g, w, a, r) for g, w, a in zip(got, want, atols)]
    q, k, v, do = c.args[:4]
    half_dq = flash_attention_bwd_heads_plain(q, k[:, ::2], v[:, ::2], do)[0]
    passes = [within(torch.zeros_like(want[1]), want[1], atols[1], r)[1],
              within(half_dq, want[0], atols[0], r)[1],
              within(K10_SCALE_ERR * want[0].float(), want[0], atols[0], r)[1]]
    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} dq/dk/dv max_abs_err "
          f"{' / '.join(f'{e:.3e}' for e, _ in results)} (tol {frac:g}·max|ref| = "
          f"{' / '.join(f'{a:.3g}' for a in atols)}, + {r:g}|ref|); the tolerance passes "
          f"a zeroed dk: {passes[0]}, the dq over every other key: {passes[1]}, a dq "
          f"x{K10_SCALE_ERR}: {passes[2]}", flush=True)
    if any(passes):
        failed.append(f"{c.name} {dname} {c.shape} tolerance too loose")
    return max(e for e, _ in results), all(ok for _, ok in results), atols[0], r


def _check_k10(c, got, want, dname, failed):
    """K10's check: the whole sublayer x + Wo·attn + bo within TOL, and the
    attention term alone (out - x against plain - x, the same difference)
    within FLASH_TOL's fraction of its largest |reference| plus FLASH_TOL's
    rtol of |out| (the output's own rounding). That tolerance fails a term
    K10_SCALE_ERR of the reference's, and the plain result without the key
    mask falls outside it around the kernel's masked result. Returns (max
    abs error, ok, atol of the term, rtol)."""
    atol, rtol = TOL[dname]
    err, ok = within(got, want, atol, rtol)
    frac, r = FLASH_TOL[dname]
    x = c.args[0].float()
    term = want.float() - x
    a = frac * float(term.abs().max())
    ok = ok and within(got, want, a, r)[1]
    scaled = x + K10_SCALE_ERR * term
    unmasked = c.plain(*c.args, **{**c.kw, "key_valid": None})
    passes = [within(scaled, want, a, r)[1], within(unmasked, got, a, r)[1]]
    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max |ref term| {a / frac:.4f}; the "
          f"term's tolerance passes a term x{K10_SCALE_ERR}: {passes[0]}, the unmasked plain "
          f"result: {passes[1]}", flush=True)
    if any(passes):
        failed.append(f"{c.name} {dname} {c.shape} tolerance too loose or the key mask is "
                      f"not applied")
    return err, ok, a, r


def _k6_faults(c):
    """The planted faults K6's tolerance must fail: the convolution without
    the border mask (TMA's zero fill taken through the prologue: the
    prologue applied to the zero-padded map), and with a second input the
    convolution without it (a dropped x2 half). Both in PyTorch ops."""
    import torch
    import torch.nn.functional as F

    from sdtpu_torch.ops.conv import conv2d
    from sdtpu_torch.ops.fused_conv import _prologue_plain, conv3x3_fused_plain

    x, w, cb, ps, pb = c.args
    kw = c.kw
    x2 = kw.get("x2")

    def pad_then_prologue(t, s, b):
        return _prologue_plain(F.pad(t, (0, 0, 1, 1, 1, 1)), s, b, True)

    xin = pad_then_prologue(x, ps, pb)
    if x2 is not None:
        xin = torch.cat([xin, pad_then_prologue(x2, kw["prologue_scale2"],
                                                kw["prologue_bias2"])], dim=-1)
    acc = conv2d({"w": w}, xin, padding=0).float() + cb.float()
    if kw.get("residual") is not None:
        acc = acc + kw["residual"].float()
    faults = {"without the border mask": acc.to(x.dtype)}
    if x2 is not None:
        c1 = x.shape[-1]
        faults["without x2"] = conv3x3_fused_plain(x, w[:, :, :c1], cb, ps, pb,
                                                   kw.get("residual"))
    return faults


def _k4_faults(c):
    """The planted faults K4's tolerance must fail, in PyTorch ops: the
    product without its prologue (proj_in) or without its residual
    (proj_out)."""
    from sdtpu_torch.ops.fused_conv import conv1x1_fused_plain

    x, w, cb = c.args[:3]
    faults = {}
    if len(c.args) > 3:
        faults["without its prologue"] = conv1x1_fused_plain(
            x, w, cb, residual=c.kw.get("residual"))
    if c.kw.get("residual") is not None:
        faults["without its residual"] = conv1x1_fused_plain(*c.args)
    return faults


def _k7_faults(c):
    """The planted faults K7's tolerance must fail, in PyTorch ops: the
    phases interleaved with py and px swapped (phase (py, px) stored at
    (2i + px, 2j + py)), and every tap read one pixel off (the map shifted
    by one, as the walk without the -1 in the tap offset reads it)."""
    import torch.nn.functional as F

    from sdtpu_torch.ops.fused_conv import upsample2x_conv_fused_plain

    x, w, cb = c.args
    b, h, wd, _ = x.shape
    co = w.shape[-1]
    want = upsample2x_conv_fused_plain(x, w, cb)
    swapped = want.reshape(b, h, 2, wd, 2, co).transpose(2, 4).reshape(want.shape)
    shifted = F.pad(x[:, 1:, 1:], (0, 0, 0, 1, 0, 1))
    return {"with py and px swapped": swapped,
            "with the taps one pixel off": upsample2x_conv_fused_plain(shifted, w, cb)}


def _k3_faults(c):
    """The planted faults K3's tolerance must fail, in PyTorch ops: the sums
    with the rows of the plan's last cluster rank that holds rows dropped
    (its partial left out), and the sums of batch b + 1's rows for b (zeros
    past the last)."""
    import torch

    from sdtpu_torch.ops.fused_groupnorm import channel_partials_plain, stats_plan

    (x,) = c.args
    xr = x.reshape(x.shape[0], -1, x.shape[-1])
    b, rows, ch = xr.shape
    chunk = -(-rows // stats_plan(b, rows, ch, x.element_size()).cluster)
    last = (rows - 1) // chunk
    kept = torch.cat([xr[:, :last * chunk], xr[:, (last + 1) * chunk:]], dim=1)
    shifted = torch.cat([xr[1:], torch.zeros_like(xr[:1])])
    return {"with one cluster rank's rows dropped": channel_partials_plain(kept),
            "of batch b + 1 for b": channel_partials_plain(shifted)}


def _check_k2(c, got, want, dname, failed):
    """K2's check: the whole sublayer x + Wo·attn + bo within TOL, and the
    attention term alone (out - x against plain - x) within FLASH_TOL's
    fraction of its largest |reference| plus FLASH_TOL's rtol of |out| (the
    output's own rounding), as K10's. That tolerance fails the sublayer over
    every other key. Returns (max abs error, ok, atol of the term, rtol)."""
    from sdtpu_torch.ops.attention import qkv_attention_plain
    from sdtpu_torch.ops.conv import linear
    from sdtpu_torch.ops.groupnorm import layer_norm

    atol, rtol = TOL[dname]
    err, ok = within(got, want, atol, rtol)
    frac, r = FLASH_TOL[dname]
    x, ln_g, ln_b, wqkv, wo, bo, n_head = c.args
    a = frac * float((want.float() - x.float()).abs().max())
    ok = ok and within(got, want, a, r)[1]
    q, k, v = linear({"w": wqkv}, layer_norm(x, ln_g, ln_b)).chunk(3, dim=-1)
    half = x + linear({"w": wo, "b": bo},
                      qkv_attention_plain(q, k[:, ::2], v[:, ::2], None, n_head))
    passes = within(half, want, a, r)[1]
    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max |ref term| {a / frac:.4f}; the "
          f"term's tolerance passes the sublayer over every other key: {passes}", flush=True)
    if passes:
        failed.append(f"{c.name} {dname} {c.shape} tolerance too loose")
    return err, ok, a, r


def phase_kernels(dev) -> tuple[dict, dict]:
    """Phase 2. Returns ({kernel: max abs error over both dtypes}, {(kernel,
    shape key): {label, ms, plain_ms, library_ms, bound_ms, ops_ms, bytes_ms,
    device_ms, old_ms, f32_ms}}), from the bfloat16 run, the main paths'
    dtype (old_ms, the replaced kernel's device time, for K5, K9, K2, K6,
    K1, K4, K10, K7, K3 only; f32_ms the float32 run's time, by device time
    where measured), and under F32_KEY + shape key the float32 run's (its
    products bound at the TF32 rate)."""
    import torch

    from sdtpu_torch.ops.fused_groupnorm import channel_partials_plain
    from sdtpu_torch.profile_kernels import device_ms

    def dev_time(fn):
        return device_ms(fn, iters=budget(fn))

    max_err, measured, f32_ms = {}, {}, {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        for c in kernel_cases(dtype, dev):
            (got, key), want = launched_key(c), c.plain(*c.args, **c.kw)
            torch.cuda.synchronize()
            peak = PEAK_TF32 if dtype == torch.float32 and c.peak == PEAK_TENSOR else c.peak
            ops_ms, bytes_ms = 1e3 * c.ops / peak, 1e3 * _nbytes(c.args, c.kw, got) / HBM
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            a, r = (STATS_TOL if c.name == "channel_partials" else (atol, rtol))
            if c.name == "flash_attention_heads":
                err, ok, a, r = _check_flash(c, got, want, dname, failed)
            elif c.name == "flash_attention_bwd_heads":
                err, ok, a, r = _check_k9(c, got, want, dname, failed)
            elif c.name.startswith("fused_cross_attention"):
                err, ok, a, r = _check_k10(c, got, want, dname, failed)
            elif c.name == "fused_self_attention":
                err, ok, a, r = _check_k2(c, got, want, dname, failed)
            else:
                if c.kw.get("emit_stats"):
                    (got, got_st), (want, _) = got, want
                    # the emitted statistics are sums over the f32
                    # accumulator: held to the sums of the kernel's own
                    # output, within that output's rounding (bf16: 2^-8 of
                    # the sum of magnitudes; f32: the summation order).
                    # Against the plain version they would differ by TF32's
                    # rounding of the weights, which a sum over a million
                    # rows does not average out.
                    y_sums = channel_partials_plain(got)
                    tol_st = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-5) * _stats_scale(got)
                    st_err = float(((got_st - y_sums).abs() / tol_st).max())
                    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} emitted stats: max "
                          f"|err| / tol {st_err:.3f}", flush=True)
                    if st_err > 1.0:
                        failed.append(f"{c.name} {dname} {c.shape} stats")
                err, ok = within(got, want, a, r)
                faults = {"conv3x3_fused": _k6_faults, "conv1x1_fused": _k4_faults,
                          "upsample2x_conv_fused": _k7_faults,
                          "channel_partials": _k3_faults}.get(c.name)
                if faults is not None:
                    passes = {k: within(f, want, a, r)[1] for k, f in faults(c).items()}
                    print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} the tolerance passes "
                          + ", ".join(f"the output {k}: {v}" for k, v in passes.items()),
                          flush=True)
                    if any(passes.values()):
                        failed.append(f"{c.name} {dname} {c.shape} tolerance too loose")
            del got, want
            ms = cuda_ms(lambda: c.fn(*c.args, **c.kw))
            plain_ms = cuda_ms(lambda: c.plain(*c.args, **c.kw))
            lib_ms = None if c.library is None else cuda_ms(lambda: c.library(*c.args, **c.kw))
            if c.library_minus is not None:
                lib_ms -= cuda_ms(lambda: c.library_minus(*c.args, **c.kw))
            lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
            for label, fn in c.yardsticks:
                lib += (f"  {label} {cuda_ms(lambda: fn(*c.args, **c.kw)):.4f} ms (device "
                        f"{dev_time(lambda: fn(*c.args, **c.kw)):.4f})")
            dev_ms = old_ms = None
            if c.old is not None or dtype == torch.bfloat16:
                dev_ms = dev_time(lambda: c.fn(*c.args, **c.kw))
                lib += f"  device {dev_ms:.4f} ms"
            print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max_abs_err {err:.3e} "
                  f"(tol {a:.3g} + {r:.3g}|ref|) {'ok' if ok else 'FAILED'}  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms "
                  f"({bound_by})  [{key}]", flush=True)
            if c.old is not None and dtype == torch.bfloat16:
                # the Hopper kernel against the kernel it replaced, by
                # device time, in turns
                new = lambda: c.fn(*c.args, **c.kw)  # noqa: E731
                old = lambda: c.old(*c.args, **c.kw)  # noqa: E731
                turns = [dev_time(f) for f in (old, new, new, old)]
                old_ms = (turns[0] + turns[3]) / 2
                print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} device ms old/new/new/old "
                      f"{' / '.join(f'{t:.4f}' for t in turns)}: new {dev_ms:.4f} against old "
                      f"{old_ms:.4f} ({old_ms / ((turns[1] + turns[2]) / 2):.2f}x), bound "
                      f"{bound_ms:.4f}", flush=True)
            if not ok:
                failed.append(f"{c.name} {dname} {c.shape}")
            max_err[c.name] = max(max_err.get(c.name, 0.0), err)
            entry = {"label": c.shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                     "device_ms": dev_ms, "old_ms": old_ms}
            if dtype == torch.float32:
                f32_ms[(c.name, c.shape)] = dev_ms if dev_ms is not None else ms
                # a float32 launch of the main paths: the route it takes is
                # the kernel the bf16 route replaced, so that kernel is its
                # own "replaced" time
                measured[(c.name, F32_KEY + key)] = {
                    **entry, "label": c.shape + " f32",
                    "old_ms": dev_ms if c.old is not None else None}
            else:
                measured[(c.name, key)] = {**entry, "f32_ms": f32_ms.get((c.name, c.shape))}
        torch.cuda.empty_cache()
    if failed:
        fail("kernel disagrees with its plain version: " + "; ".join(failed))
    return max_err, measured


def main_path_times(measured: dict, shapes: dict) -> dict:
    """Per kernel, {ms, plain_ms, library_ms, bound_ms, bound_by} of its
    launches in the generate runs: each launched shape's phase-2 time (or
    bound) times its launches there, as the wrapper counted them per shape,
    summed. library_ms is None where a launched shape has no library call;
    device_ms is the device time of the kernel, and old_ms (K5, K9, K2, K6,
    K1, K4, K10, K7, K3) of the one it replaced, None for the others. Fails if a
    launched shape has no case in phase 2."""
    totals, missing = {}, []
    for name in KERNEL_INFO:
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
             "bytes_ms": 0.0, "device_ms": 0.0, "old_ms": 0.0}
        for key, n in sorted(shapes[name].items()):
            m = measured.get((name, key))
            if m is None:
                missing.append(f"{name} [{key}] x{n}")
                continue
            lib = "" if m["library_ms"] is None else f"  library {n * m['library_ms']:.3f} ms"
            if m["device_ms"] is not None:
                lib += f"  device {n * m['device_ms']:.3f} ms"
            if m["old_ms"] is not None:
                lib += f", the replaced kernel's {n * m['old_ms']:.3f} ms"
            print(f"main path {name:21s} {m['label']:32s} launches {n:4d}: kernel "
                  f"{n * m['ms']:.3f} ms  plain {n * m['plain_ms']:.3f} ms{lib}  bound "
                  f"{n * m['bound_ms']:.3f} ms", flush=True)
            for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
                t[f] += n * m[f]
            for f in ("library_ms", "device_ms", "old_ms"):
                if m[f] is None or t[f] is None:
                    t[f] = None
                else:
                    t[f] += n * m[f]
        t["bound_by"] = "operations" if t.pop("ops_ms") >= t.pop("bytes_ms") else "bytes"
        totals[name] = t
    if missing:
        fail("shapes launched on the main path with no case in phase 2: " + "; ".join(missing))
    return totals


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


# one fused ResBlock through two K6 convolutions and a 1x1 skip connection
# of 960 channels: TF32 products, GroupNorm statistics folded in between
RESBLOCK_TOL = (1e-2, 1e-2)


def phase_resblock(dev) -> None:
    """Phase 3c: the first up-path ResBlock of SD v1.4's UNet at 1024px
    (128x128 latent, 640 channels + the 320-channel skip -> 320), float32,
    random weights, on the card (K3 on both parts, K6 with the skip as its
    second input, then K6 with the residual) and on the CPU (plain)."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import fused_conv
    from sdtpu_torch.weights import Init

    cfg = SD_V1_4.unet
    g = torch.Generator().manual_seed(SEED)
    p_cpu = unet._init_res_block(Init(g, "cpu"), 960, cfg.time_embed_dim, 320)
    x = torch.randn((1, 128, 128, 640), generator=g)
    skip = torch.randn((1, 128, 128, 320), generator=g)
    emb = torch.randn((1, cfg.time_embed_dim), generator=g)
    if not unet._use_fused_resblock(x, 320):
        fail("the 1024px up-path ResBlock does not pass the fused gate")
    fns = wrappers()
    before = {k: f.launches for k, f in fns.items()}
    before_x2 = fused_conv.conv3x3_fused.launches_x2
    got, st = unet._res_block_apply(to(p_cpu, dev), x.to(dev), emb.to(dev), cfg,
                                    emit_stats=True, skip=skip.to(dev))
    torch.cuda.synchronize()
    fired = {k: f.launches - before[k] for k, f in fns.items() if f.launches > before[k]}
    fired_x2 = fused_conv.conv3x3_fused.launches_x2 - before_x2
    want = unet._res_block_apply(p_cpu, x, emb, cfg, skip=skip)
    atol, rtol = RESBLOCK_TOL
    err, ok = within(got.cpu(), want, atol, rtol)
    # the emitted statistics against the sums of the card's own output (see
    # phase 2), f32 sums in another order
    from sdtpu_torch.ops.fused_groupnorm import channel_partials_plain

    st_err = float(((st - channel_partials_plain(got)).abs() / (1e-5 * _stats_scale(got))).max())
    print(f"resblock 128x128 640+320->320 card (kernels) vs cpu (plain) float32 max_abs_err "
          f"{err:.3e} (tol {atol:g} + {rtol:g}|ref|), stats max |err| / tol {st_err:.3f}, "
          f"launches {fired}, with x2 {fired_x2} {'ok' if ok and st_err <= 1 else 'FAILED'}",
          flush=True)
    if not ok or st_err > 1:
        fail("the fused ResBlock on the card disagrees with the CPU")
    if fired != {"channel_partials": 2, "conv3x3_fused": 2} or fired_x2 != 1:
        fail(f"the fused ResBlock launched {fired} ({fired_x2} with x2), expected K3 2, "
             f"K6 2 (1 with x2)")


# launches per image the dispatch implies for SD v1.4 with batched CFG and
# 20 steps (per UNet call, times 20).
# 512px: K2 in the 15 transformers at 64^2/32^2/16^2 (not the 8^2 middle),
# K5 in the 10 below 2048 tokens, K4 twice and K3 once in the 5 at 64^2.
# The VAE decoder runs its 14 ResnetBlocks (all at >= 64^2) as 28 K6
# launches, the upsamplers at 128^2 and 256^2 as K7 (the one at 64^2 stays
# plain), the output norm as K8, and K3 where no kernel handed statistics
# on: the two mid blocks and the block after the plain upsampler.
# 1024px: K2 in all 16 transformers (the 16^2 middle now passes its gate),
# K5 in the 6 below 2048 tokens (32^2 and the middle), K4 twice in the 10 at
# 128^2 and 64^2. The 5 ResBlocks at 128^2 take the fused branch: 10 K6, the
# 3 up-path conv_in with the skip as x2; K3 on their inputs (1 each, 2 on
# the up path: x and skip) and in the 5 transformers at 64^2 (those at 128^2
# take the ResBlock's statistics): 8 + 5. The decoder: 28 K6, all three
# upsamplers (128^2, 256^2, 512^2) as K7, K8 at the output, K3 in its two
# mid blocks, and K1 for its mid-block attention (16384 tokens, d=512).
EXPECTED_LAUNCHES = {
    512: {"flash_attention_heads": 0, "channel_partials": 103, "conv1x1_fused": 200,
          "fused_self_attention": 300, "fused_geglu_mlp": 200, "conv3x3_fused": 28,
          "upsample2x_conv_fused": 2, "group_norm_silu": 1, "flash_attention_bwd_heads": 0,
          "fused_cross_attention_kv": 0},
    1024: {"flash_attention_heads": 1, "channel_partials": 262, "conv1x1_fused": 400,
           "fused_self_attention": 320, "fused_geglu_mlp": 120, "conv3x3_fused": 228,
           "upsample2x_conv_fused": 3, "group_norm_silu": 1, "flash_attention_bwd_heads": 0,
           "fused_cross_attention_kv": 0},
}
# the two-pass mode at 512px (pad_context=False): two UNet calls a step at
# batch 1, uncond then cond, so twice 512px's UNet launches (K2 15, K5 10,
# K4 10 and K3 5 a call) at half the batch; the decode's are the same
EXPECTED_LAUNCHES["twopass"] = {
    **EXPECTED_LAUNCHES[512], "channel_partials": 2 * 100 + 3, "conv1x1_fused": 400,
    "fused_self_attention": 600, "fused_geglu_mlp": 400}
EXPECTED_X2 = {512: 0, 1024: 60}  # K6 launches with the skip as second input


def by_route(kernel_shapes: dict) -> dict:
    """{route: launches} of one wrapper's per-shape counts."""
    by = {}
    for key, n in kernel_shapes.items():
        route = key.rsplit("route=", 1)[-1]
        by[route] = by.get(route, 0) + n
    return by


# the kernels each of whose bf16 main-path shapes has a Hopper plan
HOPPER_ROUTED = {"fused_self_attention": "K2", "conv3x3_fused": "K6", "conv1x1_fused": "K4",
                 "upsample2x_conv_fused": "K7", "fused_cross_attention_kv": "K10"}


def check_routes(label: str, shapes: dict, k1: dict) -> None:
    """The launches of a bf16 main path by route (the wrappers count each
    shape under its route): K2's, K6's, K4's, K7's and K10's main-path
    shapes all have a Hopper plan, so none may take the WMMA kernels; K3's
    must take the cluster kernel where its plan has one and the partials kernel
    only where it has none; K1's must be k1 ({route: launches}: the core for
    training's d = 40, the wide kernel for the 1024px decode's d = 512)."""
    from sdtpu_torch.ops.fused_groupnorm import stats_plan

    by = {name: by_route(shapes[name]) for name in HOPPER_ROUTED}
    k1_got = by_route(shapes["flash_attention_heads"])
    k3_got = by_route(shapes["channel_partials"])
    k3_off = []
    for key in shapes["channel_partials"]:
        dims = dict(kv.split("=") for kv in key.split())
        want = "sm90" if stats_plan(int(dims["b"]), int(dims["rows"]), int(dims["c"])) else "partials"
        if dims["route"] != want:
            k3_off.append(f"[{key}] (its plan's route: {want})")
    print(f"{label} launches by route: " + ", ".join(
        f"{tag} {by[name]}" for name, tag in HOPPER_ROUTED.items()) + f", K3 {k3_got}, K1 "
          f"{k1_got} (expected {k1})", flush=True)
    wmma = {name: r["wmma"] for name, r in by.items() if r.get("wmma")}
    if wmma:
        fail(f"{label}: bf16 launches on the WMMA route {wmma}")
    if k3_off:
        fail(f"{label}: K3 launches off their plan's route: " + "; ".join(k3_off))
    if k1_got != k1:
        fail(f"{label}: K1 launched {k1_got} by route, expected {k1}")


def phase_generate(dev, size: int) -> tuple[dict, dict]:
    """Phase 4: StableDiffusion.generate at SD v1.4 width, random weights,
    bf16, size x size, 20 DDIM steps, CFG 7.5, batch 1. Returns the launch
    counts, per kernel and per kernel and shape."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.ops import fused_conv
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer

    cfg = dataclasses.replace(SD_V1_4, image_size=size)
    t0 = time.perf_counter()
    params = init_params_on(cfg, dev)
    sd = StableDiffusion(params, cfg, compute_dtype=torch.bfloat16)
    del params
    tok = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f"generate {size}: SD v1.4 random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    latents = []
    decode = sd.latent_to_image

    def keep_latent(latent):
        latents.append(latent)
        return decode(latent)

    sd.latent_to_image = keep_latent
    fns = wrappers()
    for f in fns.values():
        f.launches, f.shapes = 0, {}
    fused_conv.conv3x3_fused.launches_x2 = 0
    t0 = time.perf_counter()
    images = sd.generate(tok, "An ancient mossy stone.", guidance_scale=7.5, n_steps=20,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}
    shapes = {name: dict(f.shapes) for name, f in fns.items()}
    x2 = fused_conv.conv3x3_fused.launches_x2

    lat = latents[0]
    finite = bool(torch.isfinite(lat).all())
    print(f"generate {size}x{size} bf16 20 DDIM steps CFG 7.5: image {tuple(images.shape)} "
          f"{images.dtype}, latent {tuple(lat.shape)} finite={finite} "
          f"mean {float(lat.mean()):.4f} std {float(lat.std()):.4f}, pixels mean "
          f"{float(images.mean()):.2f} std {float(images.std()):.2f}", flush=True)
    print(f"generate {size} wall {wall:.3f} s: encode_prompt "
          f"{sd.timings['encode_prompt']:.3f} s, denoise {sd.timings['denoise']:.3f} s, "
          f"decode {sd.timings['decode']:.3f} s", flush=True)
    print(f"generate {size} launches {launches} (K6 with x2: {x2}) expected "
          f"{EXPECTED_LAUNCHES[size]} (K6 with x2: {EXPECTED_X2[size]})", flush=True)
    if images.shape != (1, size, size, 3) or str(images.dtype) != "uint8":
        fail(f"image {images.shape} {images.dtype}, expected (1, {size}, {size}, 3) uint8")
    if not finite:
        fail("the final latent has non-finite values")
    if launches != EXPECTED_LAUNCHES[size] or x2 != EXPECTED_X2[size]:
        fail(f"launch counts {launches} (x2 {x2}) differ from {EXPECTED_LAUNCHES[size]} "
             f"(x2 {EXPECTED_X2[size]})")
    check_routes(f"generate {size}", shapes, {"wide": 1} if size == 1024 else {})
    return launches, shapes


# phase 9: SD v2.1 (SD_V2_1: the OpenCLIP text tower, head width 64, a
# context of width 1024, v-prediction) at 768x768, bf16, 20 steps, CFG 7.5
V21_PROMPT, V21_STEPS, V21_SCALE = "An ancient mossy stone.", 20, 7.5
# its fine-tuning: synthetic PNGs (resized to 768 by the cache build), AdamW
V21_IMAGES, V21_BATCH, V21_TRAIN_STEPS = 2, 2, 2
V21_MIN_FREE = 12 * 1024 ** 3  # the f32 weights (5.2 GB), then the tuned model, and room


def v21_launches(unet_calls: int, encodes: int = 0) -> dict:
    """The launches the dispatch implies for SD v2.1 at 768px: `unet_calls`
    UNet calls at batch 2 (batched CFG), `encodes` runs of the VAE encoder
    on one image, and one decode.

    A UNet call on 96² latents: K2 in the 10 transformers at 96² (S 9216, 5
    heads of 64) and 48² (S 2304, 10 heads), none at 24² (576 tokens, no
    multiple of 128) or in the 12² middle (under 256); K5 in none (both
    levels have 2048 tokens or more); K4 twice and K3 once in the 5 at 96²
    (9216 rows, at least 4096); its ResBlocks stay unfused (under 16384
    rows). The decoder on a 96² latent: its 14 ResnetBlocks as 28 K6 (every
    map at least 4096 rows), the upsamplers at 192² and 384² as K7 (the one
    at 96², 9216 rows, is under 16384 and stays plain, as sdtpu's gate
    leaves it), K8 at the output, K3 in the two mid blocks and after the
    plain upsampler, and K1 on the wide kernel for the mid attention (9216
    tokens of 512). The encoder on a 768² image: its 10 ResnetBlocks, K3
    once and K6 twice each, and K1 for its mid attention at 96²; its output
    norm at 96² stays plain."""
    return {"flash_attention_heads": 1 + encodes,
            "channel_partials": 5 * unet_calls + 3 + 10 * encodes,
            "conv1x1_fused": 10 * unet_calls, "fused_self_attention": 10 * unet_calls,
            "fused_geglu_mlp": 0, "conv3x3_fused": 28 + 20 * encodes,
            "upsample2x_conv_fused": 2, "group_norm_silu": 1, "flash_attention_bwd_heads": 0,
            "fused_cross_attention_kv": 0}


# one UNet call at 768px with K10's gate open: K10 in the 5 cross-attention
# sublayers at 48² (S 2304, 10 heads; 96² has more than 4096 tokens), beside
# the call's K2, K4 and K3
V21_XATTN_CALL = {**{name: 0 for name in v21_launches(0)}, "fused_cross_attention_kv": 5,
                  "fused_self_attention": 10, "conv1x1_fused": 10, "channel_partials": 5}
# its fine-tuning: the cache build (the encoder at batch 2: K3 10, K6 20, K1
# 1 on the wide kernel), then per step K1 forward and K9 backward in the 5
# transformers at 96² (S 9216, 5 heads of 64; 48²'s 2304 tokens are no
# multiple of 512, so its attention stays plain)
V21_CACHE = {"flash_attention_heads": 1, "channel_partials": 10, "conv3x3_fused": 20}
V21_TRAIN = {"flash_attention_heads": 5 * V21_TRAIN_STEPS,
             "flash_attention_bwd_heads": 5 * V21_TRAIN_STEPS}


def phase_v21(dev, tf32_defaults) -> tuple[dict, dict]:
    """Phase 9: SD v2.1 (SD_V2_1) at 768x768, full width and depth, random
    weights (init_params, seed 0), bf16, one model in this process:
    generate with DDIM and with DPM++ on the Karras ladder (20 steps, CFG
    7.5, batch 1), img2img at strength 0.6 and inpainting on the DDIM image
    (the 768² encoder), each a [1, 768, 768, 3] uint8 image from finite
    latents; one UNet call with K10's gate open (SDTPU_FUSED_XATTN=1);
    `python -m sdtpu_torch.sample native ... --preset sd-v2-1 --sampler dpmpp
    --karras --seed 0 --bf16` from the weights written once as native (f32)
    in a temporary directory, its PNG byte-equal to an in-process generate
    with the same generator under the TF32 switches of a fresh process
    (tf32_defaults); then run_finetune on V21_IMAGES synthetic PNGs at 768px
    (AdamW, batch 2, bf16, the v target): finite losses, every UNet leaf of
    the tuned model changed. Every run's launches, set to 0 just before it
    and read just after, must be the dispatch's (v21_launches), on their
    Hopper routes (K1's decode and encode on the wide kernel, training's on
    the core). Prints each part's wall seconds and peak device memory.
    Returns the launch counts of its runs, per kernel and per kernel and
    shape."""
    import os
    import shutil
    import tempfile

    import torch

    from sdtpu_torch.config import SD_V2_1
    from sdtpu_torch.finetune import run_finetune
    from sdtpu_torch.io.native import flatten_tree, load_native, save_native
    from sdtpu_torch.models.unet import unet_apply, unfuse_qkv
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils.image import encode_png_rgb8

    t_phase = time.perf_counter()
    cfg, size, gb, gib = SD_V2_1, SD_V2_1.image_size, 1e9, 1024 ** 3
    totals = Totals()
    bad = []

    def check(label, counts, expected, k1):
        """A run's launches against the dispatch's, by route; added to the
        phase's."""
        if counts[0] != expected:
            bad.append(f"{label} launched {fired(counts[0])}, expected {fired(expected)}")
        check_routes(f"v2.1 {label}", counts[1], k1)
        totals.add(*counts)

    def peak():
        return f"peak device memory {torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB"

    t0 = time.perf_counter()
    params = init_params_on(cfg, dev)
    sd = StableDiffusion(params, cfg, compute_dtype=torch.bfloat16)
    tok = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f"v2.1: SD v2.1 random weights on the card in {time.perf_counter() - t0:.1f} s "
          f"({sum(v.numel() for v in flatten_tree(params).values() if torch.is_tensor(v)) / 1e9:.3f}"
          f"e9 values) | {card_line()}", flush=True)

    latents = []
    decode = sd.latent_to_image

    def keep_latent(latent):
        latents.append(latent)
        return decode(latent)

    sd.latent_to_image = keep_latent

    def pipeline_run(label, fn, expected, k1):
        """fn() (an image-making call of sd) counted and timed; its image
        and final latent checked."""
        latents.clear()
        read_and_zero()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        images = fn()
        wall = time.perf_counter() - t0
        counts = read_and_zero()
        lat = latents[-1]
        finite = bool(torch.isfinite(lat).all())
        phases = ", ".join(f"{k} {v:.3f}" for k, v in sd.timings.items()) if "generate" in label \
            else "in one call"
        print(f"v2.1 {label}: image {tuple(images.shape)} {images.dtype}, latent "
              f"{tuple(lat.shape)} finite={finite} mean {float(lat.mean()):.4f} std "
              f"{float(lat.std()):.4f}; wall {wall:.3f} s ({phases}), {peak()}; launches "
              f"{fired(counts[0])} expected {fired(expected)}", flush=True)
        if images.shape != (1, size, size, 3) or str(images.dtype) != "uint8" or not finite:
            bad.append(f"{label}: image {images.shape} {images.dtype}, finite latent {finite}")
        check(label, counts, expected, k1)
        return images

    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    ddim = pipeline_run("generate ddim", lambda: sd.generate(
        tok, V21_PROMPT, V21_SCALE, V21_STEPS, generator=gen(SEED + 1)),
        v21_launches(V21_STEPS), {"wide": 1})
    pipeline_run("generate dpmpp karras", lambda: sd.generate(
        tok, V21_PROMPT, V21_SCALE, V21_STEPS, generator=gen(SEED + 1), sampler="dpmpp",
        karras_sigmas=True), v21_launches(V21_STEPS), {"wide": 1})
    init = torch.from_numpy(ddim).float() / 127.5 - 1.0
    skip = round(0.4 * V21_STEPS)  # img2img's entry point at strength 0.6
    pipeline_run("img2img strength 0.6 ddim", lambda: sd.img2img(
        tok, "a mossy stone in the rain", init, 0.6, V21_SCALE, V21_STEPS, generator=gen(5)),
        v21_launches(V21_STEPS - skip, encodes=1), {"wide": 2})
    mask = torch.zeros((1, size, size))
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    pipeline_run("inpaint ddim", lambda: sd.inpaint(
        tok, "a red flower", init, mask, V21_SCALE, V21_STEPS, generator=gen(6)),
        v21_launches(V21_STEPS, encodes=1), {"wide": 2})
    sd.latent_to_image = decode

    # K10 at 10 heads: one UNet call (batch 2) with its gate open
    ctx, valid = sd.context(tok, V21_PROMPT)
    unctx, unvalid = sd.context(tok, "")
    hw = cfg.latent_size
    x2 = torch.randn((2, hw, hw, 4), generator=gen(SEED), device=dev).to(torch.bfloat16)
    env_before = os.environ.get("SDTPU_FUSED_XATTN")
    os.environ["SDTPU_FUSED_XATTN"] = "1"
    try:
        read_and_zero()
        out = unet_apply(sd.params["unet"], x2, torch.tensor([500.0], device=dev),
                         torch.cat([unctx, ctx]), cfg.unet, ctx_valid=torch.cat([unvalid, valid]))
        counts = read_and_zero()
    finally:
        if env_before is None:
            os.environ.pop("SDTPU_FUSED_XATTN", None)
        else:
            os.environ["SDTPU_FUSED_XATTN"] = env_before
    finite = bool(torch.isfinite(out).all())
    print(f"v2.1 UNet call 768px batch 2 with SDTPU_FUSED_XATTN=1: output {tuple(out.shape)} "
          f"finite={finite}; launches {fired(counts[0])} expected {fired(V21_XATTN_CALL)}, K10 "
          f"by shape {counts[1]['fused_cross_attention_kv']}", flush=True)
    if not finite:
        bad.append("the UNet call with K10's gate open gave non-finite values")
    check("UNet call, K10's gate open", counts, V21_XATTN_CALL, {})
    del out, x2

    env = {**os.environ, "SDTPU_PROFILE": "1"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v21_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"v2.1: temporary directory {tmp}, {free / gb:.1f} GB free", flush=True)
        if free < V21_MIN_FREE:
            fail(f"phase 9 needs {V21_MIN_FREE / gb:.0f} GB free in {tmp}, {free / gb:.1f} GB "
                 f"there")
        # the command line from the weights written once as native (f32)
        native = os.path.join(tmp, "sd21.safetensors")
        t0 = time.perf_counter()
        save_native(params, native, cfg)
        print(f"v2.1 write native: {time.perf_counter() - t0:.2f} s, "
              f"{_tree_bytes(native) / gb:.3f} GB", flush=True)
        del params
        prefix = os.path.join(tmp, "img")
        text, wall, rss = run_module("v2.1 sample", [
            "sdtpu_torch.sample", "native", native, str(V21_SCALE), str(V21_STEPS), V21_PROMPT,
            prefix, "--preset", "sd-v2-1", "--sampler", "dpmpp", "--karras", "--seed",
            str(SEED), "--bf16"], env)
        report = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
        kern, ph = report["kernels"], report["phases"]
        counts = ({n: kern.get(n, {}).get("launches", 0) for n in KERNEL_INFO},
                  {n: kern.get(n, {}).get("shapes", {}) for n in KERNEL_INFO})
        print(f"v2.1 sample native --preset sd-v2-1 --sampler dpmpp --karras --bf16 (device "
              f"{report['device']}): process wall {wall:.2f} s, load_model "
              f"{ph['load_model']:.2f} s, sampling {report['sampling_s']:.2f} s (denoise "
              f"{ph['denoise']:.3f}, decode {ph['decode']:.3f}), peak resident {_gib(rss)}; "
              f"launches {fired(counts[0])} | {card_line()}", flush=True)
        if report["device"] != "cuda:0":
            bad.append(f"v2.1 sample ran on {report['device']}")
        check("sample process", counts, v21_launches(V21_STEPS), {"wide": 1})
        with open(prefix + "0.png", "rb") as f:
            png = f.read()
        os.remove(native)

        # the same generate in process, under a fresh process's TF32 switches
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
        try:
            sd.latent_to_image = keep_latent
            same = pipeline_run("generate dpmpp karras seed 0 (as the sample process)",
                                lambda: sd.generate(tok, V21_PROMPT, V21_SCALE, V21_STEPS,
                                                    generator=gen(SEED), sampler="dpmpp",
                                                    karras_sigmas=True),
                                v21_launches(V21_STEPS), {"wide": 1})
            sd.latent_to_image = decode
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        equal = encode_png_rgb8(same[0]) == png
        print(f"v2.1 sample process PNG byte-equal to the in-process generate: {equal}",
              flush=True)
        if not equal:
            bad.append("the v2.1 sample process's PNG differs from generate()")

        # fine-tuning at 768px: the latent cache through the encoder, then
        # AdamW steps with the v target
        data = write_train_images(os.path.join(tmp, "data"), "a synthetic picture, number {i}",
                                  V21_IMAGES)
        marks = {"steps": []}

        def log(line):
            print(f"v2.1 finetune: {line}", flush=True)
            if line.startswith("dataset:"):
                marks["cache"] = read_and_zero()
                marks["t0"] = time.perf_counter()
            elif line.startswith("step "):
                marks["steps"].append(time.perf_counter())

        read_and_zero()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = run_finetune(sd, tok, data, os.path.join(tmp, "tuned"), steps=V21_TRAIN_STEPS,
                              batch_size=V21_BATCH, lr=1e-5, compute_dtype=torch.bfloat16,
                              remat=False, seed=SEED, log_every=1, log=log)
        wall = time.perf_counter() - t0
        train = read_and_zero()
        losses = [v for _, v in result["losses"]]
        times = [marks["t0"]] + marks["steps"]
        step_ms = [round(1e3 * (b - a), 1) for a, b in zip(times, times[1:])]
        print(f"v2.1 run_finetune 768px bf16 batch {V21_BATCH} AdamW {V21_TRAIN_STEPS} steps "
              f"(v target): losses {losses}, step wall ms {step_ms}, whole call {wall:.1f} s "
              f"(cache build {marks['t0'] - t0:.1f} s, steps and save "
              f"{time.perf_counter() - marks['t0']:.1f} s), {peak()}; cache build launches "
              f"{fired(marks['cache'][0])} expected "
              f"{V21_CACHE}, training launches {fired(train[0])} expected {V21_TRAIN}",
              flush=True)
        if len(losses) != V21_TRAIN_STEPS or not all(map(math.isfinite, losses)):
            bad.append(f"v2.1 run_finetune losses {losses}")
        check("finetune cache build", marks["cache"],
              {**{n: 0 for n in KERNEL_INFO}, **V21_CACHE}, {"wide": 1})
        check("finetune training", train, {**{n: 0 for n in KERNEL_INFO}, **V21_TRAIN},
              {"sm90": V21_TRAIN["flash_attention_heads"]})
        tuned, tuned_cfg = load_native(result["out_path"], device=dev)
        base = flatten_tree(unfuse_qkv(sd.params["unet"]))
        leaves = flatten_tree(tuned["unet"])
        stale = [k for k, v in leaves.items()
                 if v.dtype != torch.float32 or not bool(v.isfinite().all())
                 or torch.equal(v, base[k].float())]
        print(f"v2.1 tuned model: config {tuned_cfg.name}, {len(leaves)} UNet leaves (sdtpu's "
              f"keys: {set(leaves) == set(base)}), f32, finite and changed: "
              f"{len(leaves) - len(stale)}", flush=True)
        if tuned_cfg != cfg or set(leaves) != set(base) or stale:
            bad.append(f"v2.1 tuned model: config {tuned_cfg.name}, keys equal "
                       f"{set(leaves) == set(base)}, leaves not f32, finite and changed "
                       f"{stale[:5]}")
        del tuned, leaves, base
    del sd
    print(f"v2.1 phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        fail("phase 9 (SD v2.1): " + "; ".join(bad))
    return totals.launches, totals.shapes


# one SpatialTransformer's gradients, card (K1, K9, TF32 products) against
# CPU (full f32): this fraction of each gradient's largest |reference| plus
# this rtol (measured: 3.3e-4 of the largest |reference| at worst)
GRAD_TOL = (2.0 ** -9, 2.0 ** -9)


def phase_grad(dev) -> None:
    """Phase 3d: one SpatialTransformer at the 64x64 level of SD v1.4 (C=320,
    8 heads of 40, S=4096, batch 1, random weights, f32) inside
    dispatch.training(): sum(out · g) backpropagated on the card (the self-
    attention through K1 and K9, everything else plain) and on the CPU
    (plain versions). Every parameter's gradient and the input's must agree
    within GRAD_TOL, and every one on the card must be present and nonzero."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.models import unet
    from sdtpu_torch.ops import dispatch
    from sdtpu_torch.training import master_params, tree_leaves
    from sdtpu_torch.weights import Init

    cfg, c = SD_V1_4.unet, 320
    g = torch.Generator().manual_seed(SEED)
    p_cpu = unet._init_transformer(Init(g, "cpu"), c, cfg.context_dim)
    x = torch.randn((1, 64, 64, c), generator=g)
    ctx = torch.randn((1, 77, cfg.context_dim), generator=g)
    valid = torch.arange(77)[None, :] < 9
    gout = torch.randn((1, 64, 64, c), generator=g)

    def grads(device):
        params = master_params(to(p_cpu, device))
        xs = x.to(device).requires_grad_()
        with dispatch.training():
            out = unet._transformer_apply(params, xs, ctx.to(device), cfg, 8, valid.to(device))
        leaves = tree_leaves(params) + [xs]
        got = torch.autograd.grad((out * gout.to(device)).sum(), leaves, allow_unused=True)
        return dict(zip(list(flatten_tree(params)) + ["input"], got))

    fns = wrappers()
    for f in fns.values():
        f.launches, f.shapes = 0, {}
    card = grads(dev)
    torch.cuda.synchronize()
    fired = {k: f.launches for k, f in fns.items() if f.launches}
    k1_routes = by_route(fns["flash_attention_heads"].shapes)
    cpu = grads("cpu")
    frac, rtol = GRAD_TOL
    worst, bad = (0.0, ""), []
    for name, want in cpu.items():
        got = card[name]
        if got is None or not bool((got != 0).any()):
            bad.append(f"{name} has no gradient on the card")
            continue
        err, ok = within(got.cpu(), want, frac * float(want.abs().max()), rtol)
        rel = err / float(want.abs().max())
        worst = max(worst, (rel, name))
        if not ok:
            bad.append(f"{name} max_abs_err {err:.3e}")
    print(f"gradients of a 64x64x320 SpatialTransformer in training, card (K1 + K9) vs cpu "
          f"(plain) float32: {len(cpu)} gradients, all present and nonzero: "
          f"{not any('no gradient' in b for b in bad)}, worst max_abs_err / max|ref| "
          f"{worst[0]:.3e} ({worst[1]}; tol {frac:g} + {rtol:g}|ref|), launches {fired}, K1 "
          f"by route {k1_routes} (f32 keeps the WMMA kernel) {'ok' if not bad else 'FAILED'}",
          flush=True)
    if bad:
        fail("training gradients on the card disagree with the CPU: " + "; ".join(bad))
    if fired != {"flash_attention_heads": 1, "flash_attention_bwd_heads": 1}:
        fail(f"the transformer's training step launched {fired}, expected K1 1, K9 1")
    if k1_routes != {"wmma": 1}:
        fail(f"the f32 training step's K1 took {k1_routes}, expected the WMMA kernel")


# the serve phase: SD v1.4 at 512px in bf16 behind sdtpu_torch.serve, K10's
# gate open (SDTPU_FUSED_XATTN=1): 15 K10 launches a UNet call, the
# cross-attention sublayers at 64², 32² and 16² (the 8² middle one is below
# the gate)
SERVE_STEPS, K10_PER_UNET_CALL = 20, 15
AB_PAIRS = 3  # pairs of the UNet call's device time, gate open and closed, in turns
AB_ROUNDS = 1  # rounds of open, closed, closed, open of a lone request's latency
SERVE_PROMPT = "An ancient mossy stone."


def random_lora(unet, rank: int, gen):
    """A rank-`rank` adapter of sdtpu's layout on every attention linear of
    the UNet tree (sdtpu_torch.lora.DEFAULT_TARGETS), a and b both random,
    so that the merge changes every adapted weight."""
    import torch

    from sdtpu_torch.lora import DEFAULT_TARGETS

    def rec(node, name):
        if not isinstance(node, dict):
            return None
        w = node.get("w")
        if name in DEFAULT_TARGETS and torch.is_tensor(w) and w.ndim == 2:
            return {"a": torch.randn((w.shape[0], rank), generator=gen, device=gen.device)
                    / rank ** 0.5,
                    "b": 0.02 * torch.randn((rank, w.shape[1]), generator=gen,
                                            device=gen.device)}
        sub = {k: rec(v, k) for k, v in node.items()}
        return {k: v for k, v in sub.items() if v is not None} or None

    return rec(unet, "")


def phase_serve(dev) -> tuple[dict, dict]:
    """Phase 6: sdtpu_torch.serve at SD v1.4 width and depth, random weights
    (init_params, seed 0), bf16, 512x512, SDTPU_FUSED_XATTN=1 in this
    process for the phase, one random rank-4 LoRA adapter. make_server warms
    up (one 20-step request); then, through the socket: three concurrent
    /generate requests of one key (one batch, padded to 4), a lone
    dpmpp+karras request, a lone euler_a request with a negative prompt, a
    lone seeded DDIM request, /img2img and /inpaint on a generated PNG, a
    request naming the adapter, and a bad request (400). Every other reply
    must be 200 with 512x512x3 images; the lone seeded request must return
    the PNG bytes of StableDiffusion.generate with the same seed; K10 must
    have launched 15 times a UNet call, each on its Hopper route. The
    counters are set to 0 just before make_server and read after the
    generate() check. Then an A/B of K10's gate: the device time of one UNet
    call at batch 2 (profile_kernels.device_ms) in AB_PAIRS pairs of open
    and closed, the order alternating, and a lone 20-step request's latency
    in AB_ROUNDS rounds of open, closed, closed, open, with the medians of
    each side. Returns the launch counts, per kernel and per kernel and
    shape."""
    import base64
    import os
    import threading
    import urllib.error
    import urllib.request

    import torch

    from sdtpu_torch import serve
    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.models.unet import unet_apply, unfuse_qkv
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.profile_kernels import device_ms
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils.image import decode_png_rgb8, encode_png_rgb8

    cfg = SD_V1_4
    sd = StableDiffusion(init_params_on(cfg, dev), cfg, compute_dtype=torch.bfloat16)
    tok = SimpleTokenizer()
    lora = random_lora(unfuse_qkv(sd.params["unet"]), 4,
                       torch.Generator(device=dev).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    fns = wrappers()
    env_before = os.environ.get("SDTPU_FUSED_XATTN")
    os.environ["SDTPU_FUSED_XATTN"] = "1"
    server = thread = None
    bad = []
    try:
        for f in fns.values():
            f.launches, f.shapes = 0, {}
        t0 = time.perf_counter()
        server = serve.make_server(sd, tok, port=0, warmup=True, default_steps=SERVE_STEPS,
                                   batch_window_ms=100.0, loras={"style": (lora, 1.0)})
        print(f"serve: make_server with warm-up ({SERVE_STEPS} steps) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        unet_calls = SERVE_STEPS  # the warm-up

        def post(name, payload, path="/generate", want=200):
            t = time.perf_counter()
            req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    code, resp = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                code, resp = e.code, json.loads(e.read())
            wall = time.perf_counter() - t
            shapes = [decode_png_rgb8(base64.b64decode(im)).shape
                      for im in resp.get("images", [])]
            ok = code == want and (want != 200 or (shapes and all(
                sh == (512, 512, 3) for sh in shapes)))
            print(f"serve {name}: {code}, images {shapes}, latency_s "
                  f"{resp.get('latency_s')}, client wall {wall:.3f} s "
                  f"{'ok' if ok else 'FAILED ' + str(resp)[:200]}", flush=True)
            if not ok:
                bad.append(name)
            return resp

        # three concurrent requests of one key: one batch, padded to 4
        results, barrier = [None] * 3, threading.Barrier(3)

        def call(i):
            barrier.wait()
            results[i] = post(f"concurrent {i}", {"prompt": f"{SERVE_PROMPT} {i}", "seed": 10 + i,
                                                  "guidance_scale": 6.0 + i})

        calls = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        t0 = time.perf_counter()
        for t in calls:
            t.start()
        for t in calls:
            t.join(timeout=600)
        batch_wall = time.perf_counter() - t0
        unet_calls += SERVE_STEPS
        sizes = dict(server.state.batcher.batch_sizes)
        print(f"serve batch of 3 concurrent /generate ({SERVE_STEPS} DDIM steps, padded to 4, "
              f"UNet batch 8): wall {batch_wall:.3f} s, {3 / batch_wall:.3f} images/s; "
              f"batches run so far by padded size {sizes}", flush=True)
        if sizes != {1: 1, 4: 1}:
            bad.append(f"batches {sizes}, expected the warm-up (1) and one of 4")

        post("dpmpp karras", {"prompt": SERVE_PROMPT, "seed": 2, "sampler": "dpmpp",
                              "karras": True})
        post("euler_a negative", {"prompt": SERVE_PROMPT, "seed": 3, "sampler": "euler_a",
                                  "negative_prompt": "blurry, low quality"})
        lone = post("lone seeded ddim", {"prompt": SERVE_PROMPT, "seed": 4})
        unet_calls += 3 * SERVE_STEPS
        init = lone["images"][0]
        post("img2img strength 0.6", {"prompt": "a mossy stone in the rain", "seed": 5,
                                      "init_image": init, "strength": 0.6}, path="/img2img")
        unet_calls += SERVE_STEPS - round(0.4 * SERVE_STEPS)
        mask = torch.zeros((512, 512, 3), dtype=torch.uint8)
        mask[128:384, 128:384] = 255
        post("inpaint", {"prompt": "a red flower", "seed": 6, "init_image": init,
                         "mask": base64.b64encode(encode_png_rgb8(mask.numpy())).decode()},
             path="/inpaint")
        adapted = post("lora", {"prompt": SERVE_PROMPT, "seed": 4, "lora": "style"})
        unet_calls += 2 * SERVE_STEPS
        post("bad request", {"prompt": SERVE_PROMPT, "sampler": "plms"}, want=400)
        if adapted.get("images") == lone.get("images"):
            bad.append("the adapter changed nothing")

        # the lone seeded request against generate() with the same seed
        images = sd.generate(tok, SERVE_PROMPT, 7.5, SERVE_STEPS,
                             generator=torch.Generator(device=dev).manual_seed(4))
        unet_calls += SERVE_STEPS
        same = encode_png_rgb8(images[0]) == base64.b64decode(lone["images"][0])
        print(f"serve lone seeded /generate vs StableDiffusion.generate (seed 4): the same PNG "
              f"bytes: {same}", flush=True)
        if not same:
            bad.append("the lone seeded request differs from generate()")

        launches = {name: f.launches for name, f in fns.items()}
        shapes = {name: dict(f.shapes) for name, f in fns.items()}
        k10 = launches["fused_cross_attention_kv"]
        print(f"serve launches {launches}; K10 {k10} for {unet_calls} UNet calls (expected "
              f"{K10_PER_UNET_CALL * unet_calls}), by shape {shapes['fused_cross_attention_kv']}",
              flush=True)
        if k10 != K10_PER_UNET_CALL * unet_calls:
            bad.append(f"K10 launched {k10} times, expected {K10_PER_UNET_CALL * unet_calls}")
        check_routes("serve", shapes, {})

        # the merged pipeline's fused attn1 q/k/v (K2's operand) are its
        # merged q, k and v
        merged = server.state.batcher.sd_for("style").params["unet"]
        stale = [path for path, a1 in _attn1_blocks(merged) if not torch.equal(
            a1["qkv"]["w"], torch.cat([a1[k]["w"] for k in ("query", "key", "value")], dim=1))]
        if stale:
            bad.append(f"the merged pipeline keeps stale fused q/k/v in {stale[:3]}")

        # the A/B of K10's gate: the UNet call's device time in AB_PAIRS
        # pairs (open, closed, then closed, open, ...), the time step on the
        # device so that the call can be captured in a graph
        ctx, valid = sd.context(tok, SERVE_PROMPT)
        unctx, unvalid = sd.context(tok, "")
        ctx2, valid2 = torch.cat([unctx, ctx]), torch.cat([unvalid, valid])
        x2 = torch.randn((2, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(SEED),
                         device=dev).to(torch.bfloat16)
        t500 = torch.tensor([500.0], device=dev)
        unet_ab = {"1": [], "0": []}
        for i in range(AB_PAIRS):
            for gate in ("1", "0") if i % 2 == 0 else ("0", "1"):
                os.environ["SDTPU_FUSED_XATTN"] = gate
                unet_ab[gate].append(device_ms(lambda: unet_apply(
                    sd.params["unet"], x2, t500, ctx2, cfg.unet, ctx_valid=valid2), iters=5))
            print(f"serve A/B pair {i}: UNet call 512px batch 2 bf16 device ms, gate open "
                  f"{unet_ab['1'][-1]:.4f}, closed {unet_ab['0'][-1]:.4f}", flush=True)
        gaps = sorted(c - o for o, c in zip(unet_ab["1"], unet_ab["0"]))
        print(f"serve A/B of K10's gate, {AB_PAIRS} pairs by device time: UNet call median "
              f"open {statistics.median(unet_ab['1']):.4f} ms (min {min(unet_ab['1']):.4f}, "
              f"max {max(unet_ab['1']):.4f}), closed {statistics.median(unet_ab['0']):.4f} "
              f"(min {min(unet_ab['0']):.4f}, max {max(unet_ab['0']):.4f}); closed - open per "
              f"pair median {statistics.median(gaps):.4f} ms (min {gaps[0]:.4f}, max "
              f"{gaps[-1]:.4f})", flush=True)
        # and a lone request's latency, AB_ROUNDS rounds of open, closed,
        # closed, open
        lat_ab = {"1": [], "0": []}
        for gate in ("1", "0", "0", "1") * AB_ROUNDS:
            os.environ["SDTPU_FUSED_XATTN"] = gate
            resp = post(f"A/B gate {gate} lone", {"prompt": SERVE_PROMPT, "seed": 7})
            lat_ab[gate].append(resp.get("latency_s"))
        for gate, lat in lat_ab.items():
            lat = sorted(lat)
            print(f"serve A/B SDTPU_FUSED_XATTN={gate}, {len(lat)} lone {SERVE_STEPS}-step "
                  f"requests: latency_s median {statistics.median(lat):.3f} (min {lat[0]:.3f}, "
                  f"max {lat[-1]:.3f})", flush=True)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=60)
        if env_before is None:
            os.environ.pop("SDTPU_FUSED_XATTN", None)
        else:
            os.environ["SDTPU_FUSED_XATTN"] = env_before
    if bad:
        fail("the serve phase: " + "; ".join(bad))
    return launches, shapes


def _attn1_blocks(unet):
    """(path, attn1 dict) of every SpatialTransformer in a UNet tree."""
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            if "attn1" in node:
                out.append((path, node["attn1"]))
            for k, v in node.items():
                rec(v, f"{path}/{k}")

    rec(unet, "")
    return out


# run_finetune at SD v1.4 512px: 8 synthetic images, batch 4, bf16, AdamW
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_STEPS = 8, 4, 3
# its launches: the latent cache (2 chunks of 4 images through the VAE
# encoder: 10 ResnetBlocks on the fused gate, K3 once and K6 twice each; the
# mid attention at 64² and norm_out stay plain), then per step K1 in the
# forward and K9 in the backward of the 5 transformers at the 64² level and
# no other kernel (dispatch.training() closes their gates)
EXPECTED_CACHE = {"channel_partials": 20, "conv3x3_fused": 40}
EXPECTED_TRAIN = {"flash_attention_heads": 5 * TRAIN_STEPS,
                  "flash_attention_bwd_heads": 5 * TRAIN_STEPS}
# one more step with remat: "full" recomputes the blocks, K1 included; "dots"
# saves the attention outputs
EXPECTED_REMAT = {"full": {"flash_attention_heads": 10, "flash_attention_bwd_heads": 5},
                  "dots": {"flash_attention_heads": 5, "flash_attention_bwd_heads": 5}}


def write_train_images(folder: str, caption: str, n: int = TRAIN_IMAGES) -> str:
    """The fine-tuning phases' dataset: n random 512x512 PNGs (a
    torch.Generator seeded with SEED), each with the caption
    caption.format(i=i); returns the folder."""
    import os

    import torch

    from sdtpu_torch.utils.image import save_png

    os.mkdir(folder)
    g = torch.Generator().manual_seed(SEED)
    for i in range(n):
        img = torch.randint(0, 256, (512, 512, 3), generator=g, dtype=torch.uint8)
        save_png(img.numpy(), os.path.join(folder, f"img{i}.png"))
        with open(os.path.join(folder, f"img{i}.txt"), "w") as f:
            f.write(caption.format(i=i))
    return folder


def phase_train(dev) -> tuple[dict, dict]:
    """Phase 5: sdtpu_torch.finetune.run_finetune at SD v1.4 width and depth,
    512x512, random weights (init_params, seed 0), bf16 compute, batch 4,
    lr 1e-5, AdamW, 3 steps, remat off, on TRAIN_IMAGES synthetic PNGs with
    captions: it builds the latent cache with the port's encoder and CLIP,
    then trains. The counters are read and set to 0 when it reports the
    dataset (after the cache build) and read again at its end. Checks the
    losses, the saved model (sdtpu's keys, every UNet leaf finite and
    changed), then one more step each with remat "full" and "dots". Prints
    the warm step's wall ms and the peak memory of each. Returns the launch
    counts of the whole run (cache build and training), per kernel and per
    kernel and shape."""
    import os
    import tempfile

    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.dataset import LatentBatches, load_latent_cache
    from sdtpu_torch.finetune import resolve_cache, run_finetune
    from sdtpu_torch.io.native import flatten_tree, load_native
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.training import make_optimizer, make_train_step, master_params

    fns = wrappers()
    gib = 1024 ** 3
    tok = SimpleTokenizer()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_images(os.path.join(tmp, "data"), "a synthetic picture, number {i}")
        sd = StableDiffusion(init_params_on(SD_V1_4, dev), SD_V1_4, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()

        marks = {"steps": []}

        def log(line):
            print(f"finetune: {line}", flush=True)
            if line.startswith("dataset:"):
                torch.cuda.synchronize()
                marks["cache"] = read_and_zero()
                torch.cuda.reset_peak_memory_stats(dev)
                marks["t0"] = time.perf_counter()
            elif line.startswith("step "):
                marks["steps"].append(time.perf_counter())

        read_and_zero()
        t0 = time.perf_counter()
        result = run_finetune(sd, tok, data, os.path.join(tmp, "tuned"), steps=TRAIN_STEPS,
                              batch_size=TRAIN_BATCH, lr=1e-5, compute_dtype=torch.bfloat16,
                              remat=False, seed=SEED, log_every=1, log=log)
        wall = time.perf_counter() - t0
        train = read_and_zero()
        peak = torch.cuda.max_memory_allocated(dev) / gib
        cache = marks["cache"]
        times = [marks["t0"]] + marks["steps"]
        step_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
        losses = [v for _, v in result["losses"]]
        print(f"train cache build ({TRAIN_IMAGES} images, SD v1.4 encoder + CLIP, bf16): "
              f"launches {fired(cache[0])} expected {EXPECTED_CACHE}", flush=True)
        check_routes("train cache build", cache[1], {})
        print(f"train run_finetune SD v1.4 512px bf16 batch {TRAIN_BATCH} AdamW "
              f"{TRAIN_STEPS} steps remat=False: losses {losses}, step wall ms "
              f"{[round(t, 1) for t in step_ms]} (warm step {step_ms[-1]:.1f} ms), peak "
              f"memory {peak:.2f} GiB, whole call {wall:.1f} s; launches {fired(train[0])} "
              f"expected {EXPECTED_TRAIN}", flush=True)
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"run_finetune losses {losses}")
        if fired(cache[0]) != EXPECTED_CACHE or fired(train[0]) != EXPECTED_TRAIN:
            fail(f"run_finetune launched {fired(cache[0])} building the cache and "
                 f"{fired(train[0])} training")
        # every training K1 launch (bf16, d = 40) on the Hopper core
        check_routes("train", train[1], {"sm90": EXPECTED_TRAIN["flash_attention_heads"]})

        tuned, cfg = load_native(result["out_path"], device=dev)
        base = flatten_tree(unfuse_qkv(sd.params["unet"]))
        leaves = flatten_tree(tuned["unet"])
        stale = [k for k, v in leaves.items()
                 if v.dtype != torch.float32 or not bool(v.isfinite().all())
                 or torch.equal(v, base[k].float())]
        print(f"train saved model {os.path.getsize(result['out_path']) / gib:.2f} GiB: config "
              f"{cfg.name}, {len(leaves)} UNet leaves (sdtpu's keys: {set(leaves) == set(base)}, "
              f"a fused qkv leaf: {any('qkv' in k for k in leaves)}), f32, finite and changed: "
              f"{len(leaves) - len(stale)}", flush=True)
        if cfg != SD_V1_4 or set(leaves) != set(base) or stale:
            fail(f"the saved model: config {cfg.name}, keys equal {set(leaves) == set(base)}, "
                 f"leaves not f32, finite and changed: {stale[:5]}")

        # one more step with each remat policy, from the tuned weights
        params = master_params(tuned["unet"])
        del tuned, leaves
        latents, contexts, n_valid = load_latent_cache(resolve_cache(sd, tok, data))
        batches = LatentBatches(latents, contexts, n_valid, batch_size=TRAIN_BATCH, seed=SEED,
                                device=dev)
        try:
            batch = next(batches)
        finally:
            batches.close()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for remat, expected in EXPECTED_REMAT.items():
            opt = make_optimizer(lr=1e-5, warmup_steps=0, total_steps=2)
            state = opt.init(params)
            step = make_train_step(SD_V1_4, opt, compute_dtype=torch.bfloat16, remat=remat)
            step(params, state, batch, gen)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            read_and_zero()
            t0 = time.perf_counter()
            loss = float(step(params, state, batch, gen)[2])
            step_ms = 1e3 * (time.perf_counter() - t0)
            counts, step_shapes = read_and_zero()
            counts = fired(counts)
            check_routes(f"train step remat={remat!r}", step_shapes,
                         {"sm90": expected["flash_attention_heads"]})
            print(f"train step remat={remat!r} bf16 batch {TRAIN_BATCH}: loss {loss:.5f}, warm "
                  f"step {step_ms:.1f} ms, peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB; launches {counts} "
                  f"expected {expected}", flush=True)
            if not math.isfinite(loss) or counts != expected:
                fail(f"remat={remat!r}: loss {loss}, launches {counts}")
            del state, opt
    return ({n: cache[0][n] + train[0][n] for n in fns},
            {n: {k: cache[1][n].get(k, 0) + train[1][n].get(k, 0)
                 for k in set(cache[1][n]) | set(train[1][n])} for n in fns})

# phase 8: `python -m sdtpu_torch.finetune` at SD v1.4 512px on the 8 PNGs
# of phase 5, four runs in new processes, each read from its SDTPU_PROFILE=1
# report. Per step K1 forward and K9 backward at the 64² level's 5
# transformers, per micro-batch; textual inversion's backward skips the
# first transformer's self-attention (4 K9 a step), whose input no
# gradient needs: only the context is differentiated, and it enters after.
# The cache build at batch 8 (--fast) runs the encoder once (K3 10, K6 20),
# textual inversion's data at batch 4 twice (K3 20, K6 40)
FT_MIN_FREE = 17 * 1024 ** 3  # the model, the train state (UNet and EMA), a tuned model
FT_PLACEHOLDER = "<sks>"
FT_RUNS = {
    "a": (["--fast", "--bf16", "--steps", "2", "--ema", "0.9999", "--save-every", "2"],
          {"flash_attention_heads": 10, "flash_attention_bwd_heads": 10,
           "channel_partials": 10, "conv3x3_fused": 20}),
    "b": (["--fast", "--bf16", "--steps", "3", "--ema", "0.9999", "--save-every", "2",
           "--resume"],
          {"flash_attention_heads": 5, "flash_attention_bwd_heads": 5}),
    "c": (["--bf16", "--lora-rank", "4", "--accum", "2", "--accum-bf16", "--batch", "4",
           "--steps", "2"],
          {"flash_attention_heads": 20, "flash_attention_bwd_heads": 20}),
    "d": (["--bf16", "--ti", FT_PLACEHOLDER, "--ti-init", "person", "--ti-vectors", "2",
           "--batch", "4", "--steps", "3"],
          {"flash_attention_heads": 15, "flash_attention_bwd_heads": 12,
           "channel_partials": 20, "conv3x3_fused": 40}),
}


def phase_finetune_cli(dev) -> tuple[dict, dict]:
    """Phase 8: `python -m sdtpu_torch.finetune` (the device argument
    omitted: the card) under SDTPU_PROFILE=1 at SD v1.4 width and depth,
    512x512, from the weights of phase 4 (init_params, seed 0, f32) written
    once as native, on TRAIN_IMAGES PNGs whose captions hold the
    placeholder, in a temporary directory deleted at the end. Four runs
    (FT_RUNS): (a) --fast (adafactor, batch 8) with EMA and the train state
    saved at step 2: finite losses, the state read back by
    restore_train_state (step 2, its EMA bit-equal to the tuned model, its
    trained weights finite and every leaf changed), the tuned model with
    sdtpu's keys and every UNet leaf f32 and finite; (b) the same to step 3
    with --resume: it resumes at step 2 and runs one step; (c) LoRA rank 4
    with two micro-batches summed in bf16:
    the adapter loads, each merged leaf is base + a·b·scale within f32
    rounding and every other leaf is bit-equal to the base; (d) textual
    inversion of two vectors from "person": the concept loads and its rows
    have moved off that token's row. Each run's launches must be FT_RUNS'
    (K1 on the Hopper core; the encoder's, in float32, K6 on its float32
    kernel); prints each run's wall seconds, load, steps/sec, peak memory
    and launches. Returns the launch counts of the four runs, per kernel and
    per kernel and shape (the encoder's keys under F32_KEY)."""
    import os
    import shutil
    import tempfile

    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.io.checkpoint import read_meta, restore_train_state
    from sdtpu_torch.io.native import flatten_tree, load_native, save_native
    from sdtpu_torch.lora import load_lora
    from sdtpu_torch.models.unet import unfuse_qkv
    from sdtpu_torch.textual_inversion import load_ti
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.training import Adafactor

    t_phase = time.perf_counter()
    gb = 1e9
    totals = Totals()
    env = {**os.environ, "SDTPU_PROFILE": "1"}
    bad = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_finetune_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"finetune cli: temporary directory {tmp}, {free / gb:.1f} GB free", flush=True)
        if free < FT_MIN_FREE:
            fail(f"the finetune phase needs {FT_MIN_FREE / gb:.0f} GB free in {tmp}, "
                 f"{free / gb:.1f} GB there")
        data = write_train_images(os.path.join(tmp, "data"),
                                  "a synthetic picture of " + FT_PLACEHOLDER + ", number {i}")
        native, state_dir = os.path.join(tmp, "sd.safetensors"), os.path.join(tmp, "state")
        params = init_params_on(SD_V1_4, dev)
        save_native(params, native, SD_V1_4)
        base_unet = flatten_tree(unfuse_qkv(params["unet"]))
        (person,) = SimpleTokenizer().encode("person")
        person_row = params["clip"]["token_embedding"]["w"][person].clone()
        del params

        def run(label):
            args, expected = FT_RUNS[label]
            if label in "ab":
                args = args + ["--state-dir", state_dir]
            out = os.path.join(tmp, f"out_{label}")
            stamps = []
            text, wall, rss = run_module(f"finetune {label}", [
                "sdtpu_torch.finetune", "native", native, data, out, *args], env, stamps)
            # when each logged step's loss appeared (a wait for the step):
            # the steps after the first, by the host's clock
            at = [(int(ln.split()[1].split("/")[0]), t) for t, ln in stamps
                  if ln.startswith("step ")]
            later = ("not measured" if len(at) < 2 else
                     f"{1e3 * (at[-1][1] - at[0][1]) / (at[-1][0] - at[0][0]):.1f} ms")
            report = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
            kern = report["kernels"]
            run_launches = {n: kern.get(n, {}).get("launches", 0) for n in KERNEL_INFO}
            run_shapes = {n: kern.get(n, {}).get("shapes", {}) for n in KERNEL_INFO}
            fired = {n: k for n, k in run_launches.items() if k}
            # the encoder's launches (K3, K6) run in float32: K6's on its
            # float32 kernel (the WMMA route), K3's on its plan's route
            encoder = {n: run_shapes.pop(n) for n in ("channel_partials", "conv3x3_fused")}
            run_shapes.update({n: {} for n in encoder})
            odd = [f"{n} [{k}]" for n, shp in encoder.items() for k in shp
                   if n == "conv3x3_fused" and not k.endswith("route=wmma")]
            losses = [v for _, v in report["losses"]]
            ph = report["phases"]
            around = sum(v for k, v in ph.items() if k not in ("load_tokenizer", "load_model"))
            print(f"finetune {label} `{' '.join(args)}` (device {report['device']}): process "
                  f"wall {wall:.2f} s, load_model {ph['load_model']:.2f} s, the run "
                  f"{report['train_s']:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in ph.items() if k not in ('load_tokenizer', 'load_model'))}; "
                  f"the steps {report['train_s'] - around:.2f}; a step after the first "
                  f"{later}), {report['steps_per_sec']:.4f} steps/s, "
                  f"peak device memory {report['peak_memory_gib']:.2f} GiB, peak resident "
                  f"{_gib(rss)}; losses {losses}; launches {fired} expected {expected} "
                  f"| {card_line()}", flush=True)
            if report["device"] != "cuda:0":
                bad.append(f"finetune {label} ran on {report['device']}")
            if not losses or not all(map(math.isfinite, losses)):
                bad.append(f"finetune {label} losses {losses}")
            if fired != expected:
                bad.append(f"finetune {label} launched {fired}")
            if odd:
                bad.append(f"finetune {label}: float32 encoder launches off the WMMA route {odd}")
            check_routes(f"finetune {label}", run_shapes,
                         {"sm90": expected["flash_attention_heads"]})
            if any(encoder.values()):
                print(f"finetune {label} float32 encoder launches by route: K6 "
                      f"{by_route(encoder['conv3x3_fused'])}, K3 "
                      f"{by_route(encoder['channel_partials'])}", flush=True)
            for n, shp in encoder.items():
                run_shapes[n] = {F32_KEY + k: v for k, v in shp.items()}
            totals.add(run_launches, run_shapes)
            return text, out, report

        # (a) the full fine-tune, its state and its model
        _, out, _ = run("a")
        # the model holds the EMA; the state also holds the trained weights.
        # At decay 0.9999 two steps move the EMA by 1e-4 of a step of about
        # 1e-5 of a weight: below f32's resolution at the norm gains' 1.0, so
        # "changed" is asked of the trained weights, and the EMA's leaves
        # that changed are counted
        tuned, cfg = load_native(out + ".safetensors", device=dev)
        leaves = flatten_tree(tuned["unet"])
        del tuned
        meta = read_meta(state_dir)
        trained = {k: torch.empty_like(v) for k, v in leaves.items()}
        ema = {k: torch.empty_like(v) for k, v in leaves.items()}
        opt_state = Adafactor(1e-5).init(trained)
        step = restore_train_state(state_dir, trained, opt_state, ema=ema)
        ema_equal = all(torch.equal(ema[k], v) for k, v in leaves.items())
        odd = [k for k, v in leaves.items()
               if v.dtype != torch.float32 or not bool(v.isfinite().all())]
        stale = [k for k, v in trained.items()
                 if not bool(v.isfinite().all()) or torch.equal(v, base_unet[k])]
        ema_moved = sum(not torch.equal(v, base_unet[k]) for k, v in leaves.items())
        print(f"finetune a: state {sorted(os.listdir(state_dir))} ({_tree_bytes(state_dir) / gb:.3f}"
              f" GB, flags {meta['flags']}) read back at step {step}, optimizer count "
              f"{opt_state.count}, its EMA bit-equal to the tuned model: {ema_equal}, its "
              f"trained weights finite and changed: {len(trained) - len(stale)} of "
              f"{len(trained)}; the model: config {cfg.name}, {len(leaves)} UNet leaves "
              f"(sdtpu's keys: {set(leaves) == set(base_unet)}), f32 and finite: "
              f"{len(leaves) - len(odd)}, changed by the EMA: {ema_moved}", flush=True)
        if step != 2 or opt_state.count != 2 or not ema_equal or stale:
            bad.append(f"finetune a: the state at step {step}, count {opt_state.count}, EMA "
                       f"equal {ema_equal}, trained leaves unchanged {stale[:5]}")
        if cfg != SD_V1_4 or set(leaves) != set(base_unet) or odd:
            bad.append(f"finetune a: the model's config {cfg.name}, keys equal "
                       f"{set(leaves) == set(base_unet)}, leaves not f32 and finite {odd[:5]}")
        del trained, ema, opt_state, leaves
        os.remove(out + ".safetensors")

        # (b) the resume
        text, out, report = run("b")
        resumed = f"resumed step 2 from {state_dir}" in text
        print(f"finetune b: logs the resume at step 2: {resumed}; steps logged "
              f"{[i for i, _ in report['losses']]}", flush=True)
        if not resumed or [i for i, _ in report["losses"]] != [2]:
            bad.append(f"finetune b: resumed {resumed}, steps {report['losses']}")
        os.remove(out + ".safetensors")
        shutil.rmtree(state_dir)

        # (c) LoRA: the adapter and the merge
        _, out, _ = run("c")
        lora, scale, lmeta = load_lora(out + ".lora.safetensors", dev)
        merged, _ = load_native(out + ".safetensors", device=dev)
        merged = flatten_tree(merged["unet"])
        adapter = flatten_tree(lora)
        targets = {k[:-len("/a")] + "/w" for k in adapter if k.endswith("/a")}
        merge_err, off = 0.0, []
        for k, v in merged.items():
            if k in targets:
                a, b = adapter[k[:-len("/w")] + "/a"], adapter[k[:-len("/w")] + "/b"]
                want = base_unet[k] + (a @ b) * scale
                err = float(((v - want).abs() / (1e-6 + 1e-6 * want.abs())).max())
                merge_err = max(merge_err, err)
            elif not torch.equal(v, base_unet[k]):
                off.append(k)
        moved = sum(bool(v.any()) for k, v in adapter.items() if k.endswith("/b"))
        print(f"finetune c: adapter rank {lmeta['rank']} scale {scale:g}, {len(targets)} "
              f"adapted leaves ({moved} b moved off 0), merged within 1e-6 + 1e-6|ref|: max "
              f"|err| / tol {merge_err:.3f}; other leaves bit-equal to the base: "
              f"{len(merged) - len(targets) - len(off)} of {len(merged) - len(targets)}",
              flush=True)
        if merge_err > 1.0 or off or set(merged) != set(base_unet) or not moved:
            bad.append(f"finetune c: merge error {merge_err:.3f}, leaves off the base "
                       f"{off[:5]}, b moved {moved}")
        del merged, lora, adapter
        os.remove(out + ".safetensors")

        # (d) textual inversion
        _, out, _ = run("d")
        emb, placeholder, _ = load_ti(out + ".ti.safetensors", dev)
        moved = [float((r - person_row.float()).abs().max()) for r in emb]
        print(f"finetune d: concept {placeholder!r} {tuple(emb.shape)}, rows' max |change| "
              f"from 'person': {moved}", flush=True)
        if placeholder != FT_PLACEHOLDER or emb.shape != (2, 768) or not all(moved):
            bad.append(f"finetune d: concept {placeholder!r} {tuple(emb.shape)}, moved {moved}")
    print(f"finetune cli phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        fail("the finetune phase: " + "; ".join(bad))
    return totals.launches, totals.shapes

# the CLI phase: SD v1.4 at 512px from model files, bf16, 20 DDIM steps, CFG
# 7.5, seed 0, through `python -m sdtpu_torch.sample` and `.convert`
CLI_PROMPT, CLI_STEPS, CLI_SCALE = "An ancient mossy stone.", 20, 7.5
CLI_MIN_FREE = 10 * 1024 ** 3  # two 4.3 GB copies of the weights at once, and room
# the two-pass image against the batched mode's: the mean |difference| over
# its pixels, in gray levels (bf16 rounding at other places, batch 1 against
# 2 and 2 or N keys against 77 masked, through 20 steps of CFG 7.5; measured
# on an H100: 0.574, max 5). The planted faults (the guidance with uncond
# and cond swapped, the uncond context for both calls) must exceed it
# (measured: 25.1 and 14.1)
TWOPASS_MEAN_TOL = 2.0


def run_module(label: str, args: list, env: dict,
               stamps: Optional[list] = None) -> tuple[str, float, float]:
    """`python -m <args>` from the repository's root, to its end: (its
    output, wall seconds, its peak resident memory in GiB, or None where
    /proc shows none). The peak is the largest of the process's VmHWM and
    resident size (/proc/<pid>/status, /proc/<pid>/statm), read every 0.1 s
    while it runs: wait4's ru_maxrss would count this process's memory,
    which the child holds between fork and exec. stamps: a list to which
    each line of output is added as (seconds since the start, line) when
    it appears (read every 0.02 s; the child runs unbuffered). Fails if it
    exits nonzero."""
    import os
    import tempfile

    import sdtpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(sdtpu_torch.__file__)))
    page_kb = os.sysconf("SC_PAGE_SIZE") // 1024
    peak_kb, seen, partial = 0, 0, b""
    if stamps is not None:
        env = {**env, "PYTHONUNBUFFERED": "1"}
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        while proc.poll() is None:
            try:
                with open(f"/proc/{proc.pid}/statm") as f:
                    peak_kb = max(peak_kb, int(f.read().split()[1]) * page_kb)
                with open(f"/proc/{proc.pid}/status") as f:
                    peak_kb = max([peak_kb] + [int(ln.split()[1]) for ln in f
                                               if ln.startswith("VmHWM:")])
            except (OSError, ValueError, IndexError):
                pass
            if stamps is not None:
                new = os.pread(out.fileno(), 1 << 20, seen)
                seen += len(new)
                *lines, partial = (partial + new).split(b"\n")
                now = time.perf_counter() - t0
                stamps.extend((now, ln.decode(errors="replace")) for ln in lines)
            time.sleep(0.1 if stamps is None else 0.02)
        wall = time.perf_counter() - t0
        out.seek(0)
        text = out.read().decode(errors="replace")
    if proc.returncode:
        fail(f"{label}: `python -m {' '.join(args)}` exited {proc.returncode}:\n{text[-3000:]}")
    return text, wall, (peak_kb / 1024 ** 2 if peak_kb else None)


def _gib(gib) -> str:
    return "not measured" if gib is None else f"{gib:.2f} GiB"


def _tree_bytes(path: str) -> int:
    import os

    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_cli(dev, tf32_defaults) -> tuple[dict, dict]:
    """Phase 7: the command lines at SD v1.4 width and depth, random weights
    (init_params, seed 0, f32, the weights of phase 4), in a temporary
    directory deleted at the end. The weights are written once as native;
    `python -m sdtpu_torch.convert --to-dump` and back, then `--to-mpk` and
    `--mpk` back, must give every leaf bit-equal (the dump's and the mpk's
    reads also timed in this process; each conversion back replaces the
    native file, so two copies of the weights at most are on disk); `python -m sdtpu_torch.sample dump|native ... --seed 0
    --bf16` (the device argument omitted: the card) must write the PNG bytes
    of an in-process generate in bf16 with the same generator, each run's
    load and sampling seconds and launches read from its SDTPU_PROFILE=1
    report (launches as generate 512's, on their Hopper routes). Then the
    two-pass generate (pad_context=False): its launches those of two UNet
    calls a step at batch 1, and its image within TWOPASS_MEAN_TOL of the
    batched mode's, which the planted faults exceed. tf32_defaults: the
    (matmul, cuDNN) TF32 switches a fresh process has, which the CLI's
    processes run with and the in-process generates are given. Returns the
    launch counts of the CLI runs and the in-process generates, per kernel
    and per kernel and shape."""
    import os
    import shutil
    import tempfile

    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.io.mpk import load_mpk
    from sdtpu_torch.io.native import flatten_tree, load_native, save_native
    from sdtpu_torch.io.npy_tree import load_stable_diffusion_dump
    from sdtpu_torch.models.unet import unet_apply
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.profile_kernels import device_ms
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.utils.image import encode_png_rgb8

    t_phase = time.perf_counter()
    cfg, gb, gib = SD_V1_4, 1e9, 1024 ** 3
    params = init_params_on(cfg, dev)
    fns = wrappers()
    totals = Totals()
    flat = flatten_tree(params)

    def leaves_differ(tree) -> list:
        """The keys whose leaves are not bit-equal to the weights'."""
        got = flatten_tree(tree)
        bad = sorted(set(got) ^ set(flat))
        for k, want in flat.items():
            if k not in got:
                continue
            g = got[k]
            if torch.is_tensor(want):
                g = torch.as_tensor(g).to(want.device)
                if g.dtype != want.dtype or not torch.equal(g, want):
                    bad.append(k)
            elif g != want:
                bad.append(k)
        return bad

    env = {**os.environ, "SDTPU_PROFILE": "1"}
    bad = []
    pngs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"cli: temporary directory {tmp}, {free / gb:.1f} GB free", flush=True)
        if free < CLI_MIN_FREE:
            fail(f"the CLI phase needs {CLI_MIN_FREE / gb:.0f} GB free in {tmp}, "
                 f"{free / gb:.1f} GB there")
        native = os.path.join(tmp, "sd.safetensors")
        t0 = time.perf_counter()
        save_native(params, native, cfg)
        print(f"cli write native (save_native, in process): {time.perf_counter() - t0:.2f} s, "
              f"{_tree_bytes(native) / gb:.3f} GB | {card_line()}", flush=True)
        t0 = time.perf_counter()
        back, _ = load_native(native, device="cpu")
        print(f"cli read native (load_native to the host, in process): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del back

        def convert(label, *args):
            out, wall, rss = run_module(label, ["sdtpu_torch.convert", *args], env)
            print(f"cli {label}: {wall:.2f} s of wall, peak resident {_gib(rss)} "
                  f"| {card_line()}", flush=True)

        def round_trip(label, back_args):
            """Convert back to the native file (removed while the other
            format holds the weights, so at most two copies are on disk)
            and check every leaf against the weights."""
            os.remove(native)
            convert(label, *back_args, native[:-len(".safetensors")])
            got, got_cfg = load_native(native, device=dev)
            diff = leaves_differ(got)
            print(f"cli {label}: {len(flat)} leaves, config {got_cfg.name}, bit-equal to the "
                  f"weights: {not diff and got_cfg == cfg}", flush=True)
            if diff or got_cfg != cfg:
                bad.append(f"{label}: leaves differ {diff[:5]} (config {got_cfg.name})")
            del got

        def sample(fmt, model):
            prefix = os.path.join(tmp, f"img_{fmt}")
            out, wall, rss = run_module(
                f"sample {fmt}", ["sdtpu_torch.sample", fmt, model, str(CLI_SCALE),
                                  str(CLI_STEPS), CLI_PROMPT, prefix, "--seed", str(SEED),
                                  "--bf16"], env)
            report = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
            ph = report["phases"]
            kern = report["kernels"]
            run_launches = {n: kern.get(n, {}).get("launches", 0) for n in KERNEL_INFO}
            run_shapes = {n: kern.get(n, {}).get("shapes", {}) for n in KERNEL_INFO}
            print(f"cli sample {fmt} (device {report['device']}): load_model {ph['load_model']:.2f}"
                  f" s, sampling {report['sampling_s']:.2f} s (encode_prompt "
                  f"{ph['encode_prompt']:.3f}, denoise {ph['denoise']:.3f}, decode "
                  f"{ph['decode']:.3f}), process wall {wall:.2f} s, peak resident {_gib(rss)}; "
                  f"launches {fired(run_launches)} | {card_line()}", flush=True)
            if report["device"] != "cuda:0":
                bad.append(f"sample {fmt} ran on {report['device']}")
            if run_launches != EXPECTED_LAUNCHES[512]:
                bad.append(f"sample {fmt} launched {run_launches}")
            check_routes(f"cli sample {fmt}", run_shapes, {})
            totals.add(run_launches, run_shapes)
            with open(prefix + "0.png", "rb") as f:
                pngs[fmt] = f.read()

        # the npy dump tree; each in-process read is timed, and its leaves
        # are checked by the round trip, whose conversion reads them alike
        dump = os.path.join(tmp, "dump")
        convert("convert --to-dump", "--to-dump", native, dump)
        n_files = sum(len(fs) for _, _, fs in os.walk(dump))
        t0 = time.perf_counter()
        tree = load_stable_diffusion_dump(dump, cfg)
        read_s = time.perf_counter() - t0
        del tree
        print(f"cli dump tree: {n_files} files, {_tree_bytes(dump) / gb:.3f} GB; read "
              f"(load_stable_diffusion_dump, in process) {read_s:.2f} s", flush=True)
        round_trip("convert dump -> native", [dump])
        sample("dump", dump)
        shutil.rmtree(dump)
        sample("native", native)

        # the Burn mpk
        mpk = os.path.join(tmp, "sd.mpk")
        convert("convert --to-mpk", "--to-mpk", native, mpk)
        t0 = time.perf_counter()
        tree = load_mpk(mpk)
        read_s = time.perf_counter() - t0
        del tree
        print(f"cli mpk: {_tree_bytes(mpk) / gb:.3f} GB; read (load_mpk, in process) "
              f"{read_s:.2f} s", flush=True)
        round_trip("convert --mpk -> native", ["--mpk", mpk])
        os.remove(mpk)
        print(f"cli files done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # in process, with the TF32 switches the CLI's processes had
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    try:
        tok = SimpleTokenizer()
        # the f32 pipeline under a fresh process's TF32 switches against the
        # same generate with both off (a record, not a check: ROADMAP queue 3)
        sd32 = StableDiffusion(params, cfg)
        f32_images = {}
        for label, switches in (("a fresh process's", tf32_defaults), ("off", (False, False))):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches
            f32_images[label] = torch.from_numpy(sd32.generate(
                tok, CLI_PROMPT, CLI_SCALE, CLI_STEPS,
                generator=torch.Generator(device=dev).manual_seed(SEED))).float()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
        d = (f32_images["a fresh process's"] - f32_images["off"]).abs()
        print(f"cli f32 generate with the TF32 switches (matmul, cuDNN) = {tf32_defaults}, a "
              f"fresh process's, against both off: max |difference| {int(d.max())} gray "
              f"levels, mean {float(d.mean()):.4f} | {card_line()}", flush=True)
        del sd32, f32_images, d
        for f in fns.values():  # the f32 routes' launches belong to no main path
            f.launches, f.shapes = 0, {}
        sd = StableDiffusion(params, cfg, compute_dtype=torch.bfloat16)
        del params, flat
        torch.cuda.synchronize()

        def generate(pipe, label, expected):
            for f in fns.values():
                f.launches, f.shapes = 0, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = pipe.generate(tok, CLI_PROMPT, CLI_SCALE, CLI_STEPS,
                                   generator=torch.Generator(device=dev).manual_seed(SEED))
            wall = time.perf_counter() - t0
            run_launches = {n: f.launches for n, f in fns.items()}
            run_shapes = {n: dict(f.shapes) for n, f in fns.items()}
            print(f"cli {label}: wall {wall:.3f} s (encode_prompt "
                  f"{pipe.timings['encode_prompt']:.3f}, denoise {pipe.timings['denoise']:.3f}, "
                  f"decode {pipe.timings['decode']:.3f}); launches {fired(run_launches)} "
                  f"expected {fired(expected)}", flush=True)
            if run_launches != expected:
                bad.append(f"{label} launched {run_launches}")
            check_routes(f"cli {label}", run_shapes, {})
            totals.add(run_launches, run_shapes)
            return images

        padded = generate(sd, "generate (batched CFG, in process)", EXPECTED_LAUNCHES[512])
        png = encode_png_rgb8(padded[0])
        same = {fmt: data == png for fmt, data in pngs.items()}
        print(f"cli sample dump / native PNGs byte-equal to the in-process generate: {same}",
              flush=True)
        if not all(same.values()):
            bad.append(f"the CLI's PNGs differ from generate(): {same}")

        twopass = StableDiffusion(sd.params, cfg, compute_dtype=torch.bfloat16,
                                  pad_context=False)
        two = generate(twopass, "generate two-pass (pad_context=False)",
                       EXPECTED_LAUNCHES["twopass"])

        def distance(img):
            d = (torch.from_numpy(img).float() - torch.from_numpy(padded).float()).abs()
            return float(d.mean()), int(d.max())

        ctx, _ = twopass.context(tok, CLI_PROMPT)
        unctx, _ = twopass.context(tok, "")
        faults = {}
        for label, (c, u) in {"uncond and cond swapped": (unctx, ctx),
                              "the uncond context for both calls": (unctx, unctx)}.items():
            faults[label] = distance(twopass.sample_image(
                c, u, CLI_SCALE, CLI_STEPS,
                generator=torch.Generator(device=dev).manual_seed(SEED)))
        mean, peak = distance(two)
        print(f"cli two-pass image against the batched mode's: mean |difference| {mean:.4f} "
              f"gray levels (tol {TWOPASS_MEAN_TOL}), max {peak}; planted faults: "
              + ", ".join(f"{k} mean {m:.4f} max {p}" for k, (m, p) in faults.items()),
              flush=True)
        if mean > TWOPASS_MEAN_TOL:
            bad.append(f"the two-pass image is {mean:.4f} gray levels from the batched one")
        loose = [k for k, (m, _) in faults.items() if m <= TWOPASS_MEAN_TOL]
        if loose:
            bad.append(f"the two-pass bound passes the planted faults {loose}")

        # one denoising step's UNet work by device time (CUDA-graph replay),
        # in turns: the batched call at batch 2 over 77 masked keys, and the
        # two-pass mode's two calls at batch 1 over the contexts' own keys
        pctx, pvalid = sd.context(tok, CLI_PROMPT)
        punctx, punvalid = sd.context(tok, "")
        ctx2, valid2 = torch.cat([punctx, pctx]), torch.cat([punvalid, pvalid])
        hw = cfg.latent_size
        x1 = torch.randn((1, hw, hw, 4), generator=torch.Generator(device=dev).manual_seed(SEED),
                         device=dev).to(torch.bfloat16)
        x2, t500, unet = torch.cat([x1, x1]), torch.tensor([500.0], device=dev), sd.params["unet"]
        steps = {"batched": lambda: unet_apply(unet, x2, t500, ctx2, cfg.unet, ctx_valid=valid2),
                 "two-pass": lambda: (unet_apply(unet, x1, t500, unctx, cfg.unet),
                                      unet_apply(unet, x1, t500, ctx, cfg.unet))}
        step_ms = {"batched": [], "two-pass": []}
        for mode in ("batched", "two-pass", "two-pass", "batched"):
            step_ms[mode].append(device_ms(steps[mode], iters=5))
        b_ms, t_ms = (sum(step_ms[m]) / 2 for m in ("batched", "two-pass"))
        print(f"cli a denoising step's UNet device ms, in turns batched / two-pass / two-pass / "
              f"batched: {step_ms['batched'][0]:.4f} / {step_ms['two-pass'][0]:.4f} / "
              f"{step_ms['two-pass'][1]:.4f} / {step_ms['batched'][1]:.4f}: two-pass "
              f"{t_ms:.4f} against batched {b_ms:.4f} ({t_ms / b_ms:.2f}x), 20 steps "
              f"{20 * t_ms:.1f} against {20 * b_ms:.1f} ms | {card_line()}", flush=True)
        del sd, twopass
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"cli phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    if bad:
        fail("the CLI phase: " + "; ".join(bad))
    return totals.launches, totals.shapes


def init_params_on(cfg, dev):
    """SD v1.4's random weights of phases 4 and 7: init_params, seed SEED,
    f32, on the card."""
    import torch

    from sdtpu_torch.weights import init_params

    return init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU only")
    try:
        import sdtpu_torch  # noqa: F401
    except ImportError:
        fail("sdtpu_torch is not importable: run from the root of the repository")
    tf32_defaults = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

    # phase 1: device and build
    print(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from sdtpu_torch import kernels

    t0 = time.perf_counter()
    path, _ = kernels.build()
    kernels.lib()
    print(f"build {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    def took(label, t0):
        print(f"{label} took {time.perf_counter() - t0:.1f} s", flush=True)
        return time.perf_counter()

    # phase 2: each kernel against its plain version
    t0 = time.perf_counter()
    max_err, measured = phase_kernels(dev)
    t0 = took("phase 2 (kernels)", t0)
    # phase 3: one SpatialTransformer, the VAE decoder and one 1024px fused
    # ResBlock, card against CPU; one SpatialTransformer's training gradients
    phase_transformer(dev)
    phase_decode(dev)
    phase_resblock(dev)
    phase_grad(dev)
    t0 = took("phase 3 (card against CPU)", t0)
    # phases 4 to 8: the main paths, generate at 512px and at 1024px, the
    # command lines at 512px from each weight format and the two-pass
    # generate, the server at 512px, then fine-tuning at 512px in process
    # and through `python -m sdtpu_torch.finetune`
    totals = Totals()
    for label, run in (("phase 4 (generate 512)", lambda: phase_generate(dev, 512)),
                       ("phase 4 (generate 1024)", lambda: phase_generate(dev, 1024)),
                       ("phase 9 (SD v2.1 768)", lambda: phase_v21(dev, tf32_defaults)),
                       ("phase 7 (command lines)", lambda: phase_cli(dev, tf32_defaults)),
                       ("phase 6 (serve)", lambda: phase_serve(dev)),
                       ("phase 5 (run_finetune)", lambda: phase_train(dev)),
                       ("phase 8 (finetune command line)", lambda: phase_finetune_cli(dev))):
        totals.add(*run())
        t0 = took(label, t0)
        torch.cuda.empty_cache()
    times = main_path_times(measured, totals.shapes)
    launches = totals.launches

    kernels_json = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        t = times[name]
        kernels_json.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            **({"sources_by_route": KERNEL_ROUTES[name]} if name in KERNEL_ROUTES else {}),
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **({} if t["device_ms"] is None or not launches[name] else
               {"device_ms": t["device_ms"]}),
            **({} if t["old_ms"] is None or not launches[name] else
               {"replaced_device_ms": t["old_ms"]})})
    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
