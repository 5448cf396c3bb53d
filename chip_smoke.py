"""Drive the sdtpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines:

1. device and build: the card's name and power limit (nvidia-smi), then
   the kernels built from sdtpu_torch/csrc with nvcc;
2. each kernel against its plain PyTorch version on the card, at the
   shapes SD v1.4's UNet and VAE decoder give it at 512px and at 1024px, in
   float32 and bfloat16: max error against the stated tolerance, the times
   of the kernel, of its plain version and, where one PyTorch call computes
   the same function, of that call (CUDA events), and the least time the
   card could take for the same work (its bound);
3. one SpatialTransformer at the 64x64 latent level (C=320), random
   weights, run on the card (kernels) and on the CPU (plain versions); the
   VAE decoder at SD v1.4 width on a 16x16 latent with every fused gate
   opened, card against CPU; one fused up-path ResBlock of the 1024px UNet
   (128x128, 640 + 320 skip channels -> 320), card against CPU;
4. StableDiffusion.generate at SD v1.4 width with random weights: bf16,
   20 DDIM steps, CFG 7.5, batch 1, first at 512x512, then at 1024x1024
   (the same config with image_size=1024). Each must give a
   [1, size, size, 3] uint8 image from finite latents, and the kernels'
   launch counters, set to 0 just before each run and read just after,
   must read exactly what the dispatch implies.

It prints a JSON line of per-kernel results, then the card's name and
power limit, then, last, {"ok": true, "device": {...}}. Any failure
exits nonzero before that line; there is no CPU fallback. In the JSON
line `launches` is the sum of both generate runs, and `ms`, `plain_ms`,
`bound_ms` and `library_ms` are for those launches: each wrapper counts
its launches per shape as well, and each shape's bfloat16 time (or bound)
from phase 2 is taken as many times as the two runs launched it. A shape
launched there with no case in phase 2 is a failure.

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
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

SEED = 0
WARMUP, ITERS = 3, 20
PEAK_TENSOR = 989e12  # dense bf16 FLOP/s
PEAK_F32 = 67e12      # f32 FLOP/s outside the tensor cores
HBM = 3.35e12         # bytes/s


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
# K1's outputs are averages over thousands of keys, about (e/S)^1/2 in size
# (0.013 at S=16384), far below TOL's atol: its atol is this fraction of
# the largest |reference| instead, with this rtol (f32: TF32 products;
# bf16: a few ulps). phase_kernels checks that an all-zero output and one
# over every other key fail it.
FLASH_TOL = {"float32": (2.0 ** -8, 2.0 ** -10), "bfloat16": (2.0 ** -6, 2.0 ** -7)}


def within(got, want, atol, rtol) -> tuple[float, bool]:
    """(max abs error, whether got is finite and |got - want| <= atol + rtol|want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


class Case(NamedTuple):
    """One main-path shape of a kernel. ops and peak: the operations the
    function needs and the card's rate for them; library: one PyTorch call
    that computes the same function on the same inputs, or None."""
    name: str
    shape: str
    fn: Callable
    plain: Callable
    args: tuple
    kw: dict
    ops: float
    peak: float = PEAK_TENSOR
    library: Optional[Callable] = None


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


def kernel_cases(dtype, dev):
    """Main-path inputs for each kernel. Shapes are SD v1.4's at 512px and
    1024px: the UNet's with batched CFG (B=2, 20 steps), the VAE decoder's
    (B=1, once)."""
    import torch
    import torch.nn.functional as F

    from sdtpu_torch.ops import (flash_attention, fused_conv, fused_groupnorm, fused_mlp,
                                 fused_transformer)

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

    cases = []
    # K3: the UNet's ResBlock inputs and skips (1024px) and its transformers'
    # entry GroupNorm at 64x64 (512px: C=320, 1024px: C=640); the decoder's
    for label, shape in (("64x64x320 B=2", (2, 64, 64, 320)),
                         ("64x64x640 B=2", (2, 64, 64, 640)),
                         ("128x128x320 B=2", (2, 128, 128, 320)),
                         ("128x128x640 B=2", (2, 128, 128, 640)),
                         ("vae 64x64x512", (1, 64, 64, 512)),
                         ("vae 128x128x512", (1, 128, 128, 512))):
        x = rnd(*shape)
        cases.append(Case("channel_partials", label, fused_groupnorm.channel_partials,
                          fused_groupnorm.channel_partials_plain, (x,), {}, 3 * x.numel(),
                          PEAK_F32))

    # K4: proj_in (GroupNorm prologue) and proj_out (residual) at 64x64x320
    # (512px), 128x128x320 and 64x64x640 (1024px)
    for rows, c in ((4096, 320), (16384, 320), (4096, 640)):
        xr = rnd(2, rows, c)
        scale, bias = fused_conv.stats_scale_bias(
            fused_groupnorm.channel_partials_plain(xr), rows, rnd(c, scale=0.1) + 1.0,
            rnd(c, scale=0.1), 32, 1e-5)
        w, cb = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
        ops = 2 * 2 * rows * c * c
        cases.append(Case("conv1x1_fused", f"proj_in {rows}x{c}", fused_conv.conv1x1_fused,
                          fused_conv.conv1x1_fused_plain, (xr, w, cb, scale, bias), {}, ops))
        cases.append(Case("conv1x1_fused", f"proj_out {rows}x{c}",
                          fused_conv.conv1x1_fused, fused_conv.conv1x1_fused_plain,
                          (xr, w, cb), {"residual": rnd(2, rows, c)}, ops))

    # K2 at every UNet level of both sizes (the 16x16 middle block at 1024px)
    for s, c in ((4096, 320), (1024, 640), (256, 1280), (16384, 320), (4096, 640),
                 (1024, 1280)):
        x = rnd(2, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 3 * c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5),
                rnd(c, scale=0.1), 8)
        cases.append(Case("fused_self_attention", f"S={s} C={c} dh={c // 8}",
                          fused_transformer.fused_self_attention,
                          fused_transformer.fused_self_attention_plain, args, {},
                          2 * (8 * s * c * c + 4 * s * s * c)))
    for s, c in ((1024, 640), (256, 1280), (1024, 1280)):
        x = rnd(2, s, c)
        args = (x, rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1),
                rnd(c, 8 * c, scale=c ** -0.5), rnd(8 * c, scale=0.1),
                rnd(4 * c, c, scale=(4 * c) ** -0.5), rnd(c, scale=0.1))
        cases.append(Case("fused_geglu_mlp", f"S={s} C={c}", fused_mlp.fused_geglu_mlp,
                          fused_mlp.fused_geglu_mlp_plain, args, {}, 2 * 24 * s * c * c))

    # K1: the VAE's mid-block attention at 1024px (one head, d=512), and
    # training's narrow heads with and without a key-padding bias (no
    # launch on the main path)
    for bh, n_head, s, d, bias in ((1, 1, 16384, 512, False), (16, 8, 4096, 40, False),
                                   (16, 8, 4096, 80, True)):
        q, k, v = rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d)
        kb = None
        if bias:
            kb = torch.where(torch.arange(s, device=dev)[None] < torch.tensor(
                [[s // 3], [s - 77]], device=dev), 0.0, -1e30).to(torch.float32)

        def sdpa(q, k, v, key_bias=None, n_head=1):
            q4, k4, v4 = (t.view(t.shape[0] // n_head, n_head, *t.shape[1:])
                          for t in (q, k, v))
            mask = None if key_bias is None else key_bias[:, None, None, :].to(q.dtype)
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

        cases.append(Case("flash_attention_heads",
                          f"BH={bh} S={s} d={d}{' bias' if bias else ''}",
                          flash_attention.flash_attention_heads,
                          flash_attention.flash_attention_heads_plain,
                          (q, k, v, kb, n_head), {}, 4 * bh * s * s * d, library=sdpa))

    # K6 (GN+SiLU prologue, output statistics): the UNet's fused ResBlocks
    # at 128x128 (1024px, B=2): conv_in over x or over the implicit skip
    # concat (x2), conv_out with the residual; the VAE decoder's ResnetBlock
    # convs at both sizes
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
                          2 * 9 * b * hw * hw * (ci + c2) * co, library=conv))

    conv_case("unet 128x128 640+320->320 B=2", 2, 128, 640, 320, 320, 1e-5, residual=False)
    conv_case("unet 128x128 320+320->320 B=2", 2, 128, 320, 320, 320, 1e-5, residual=False)
    conv_case("unet 128x128 320->320 B=2", 2, 128, 320, 320, 0, 1e-5, residual=False)
    conv_case("unet 128x128 320->320 B=2 res", 2, 128, 320, 320, 0, 1e-5)
    seen = set()
    for lat in (64, 128):
        for conv_shape in decoder_convs(lat):
            if conv_shape not in seen:
                seen.add(conv_shape)
                hw, ci, co, res, st = conv_shape
                conv_case(f"vae {hw}x{hw} {ci}->{co}{' res' if res else ''}"
                          f"{'' if st else ' no stats'}", 1, hw, ci, co, 0, 1e-6, res, st)

    for hw, c, co in ((128, 512, 512), (256, 256, 256), (256, 512, 512), (512, 256, 256)):
        args = (rnd(1, hw, hw, c), rnd(3, 3, c, co, scale=(9 * c) ** -0.5), rnd(co, scale=0.1))
        cases.append(Case("upsample2x_conv_fused", f"{hw}x{hw}x{c} -> {2 * hw}x{2 * hw}",
                          fused_conv.upsample2x_conv_fused,
                          fused_conv.upsample2x_conv_fused_plain, args, {"emit_stats": True},
                          2 * 16 * hw * hw * c * co))
    for hw in (512, 1024):
        x = rnd(1, hw, hw, 128)
        args = (x, rnd(128, scale=0.1) + 1.0, rnd(128, scale=0.1), 32, 1e-6)
        cases.append(Case("group_norm_silu", f"{hw}x{hw}x128", fused_groupnorm.group_norm_silu,
                          fused_groupnorm.group_norm_silu_plain, args,
                          {"sums": fused_groupnorm.channel_partials_plain(x)}, 8 * x.numel(),
                          PEAK_F32))
    return cases


# name -> (route, source, the sdtpu function that reaches its pl.pallas_call)
KERNEL_INFO = {
    "flash_attention_heads": ("cuda", "sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/ops/flash_attention.py:220"),
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
    from sdtpu_torch.ops import (flash_attention, fused_conv, fused_groupnorm, fused_mlp,
                                 fused_transformer)

    fns = (flash_attention.flash_attention_heads, fused_groupnorm.channel_partials,
           fused_conv.conv1x1_fused, fused_transformer.fused_self_attention,
           fused_mlp.fused_geglu_mlp, fused_conv.conv3x3_fused,
           fused_conv.upsample2x_conv_fused, fused_groupnorm.group_norm_silu)
    return {f.__name__: f for f in fns}


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


def phase_kernels(dev) -> tuple[dict, dict]:
    """Phase 2. Returns ({kernel: max abs error}, {(kernel, shape key):
    {label, ms, plain_ms, library_ms, bound_ms, ops_ms, bytes_ms}}), both
    from the bfloat16 run, the main path's dtype."""
    import torch

    from sdtpu_torch.ops.fused_groupnorm import channel_partials_plain

    max_err, measured = {}, {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        for c in kernel_cases(dtype, dev):
            (got, key), want = launched_key(c), c.plain(*c.args, **c.kw)
            torch.cuda.synchronize()
            a, r = (STATS_TOL if c.name == "channel_partials" else (atol, rtol))
            if c.name == "flash_attention_heads":
                frac, r = FLASH_TOL[dname]
                a = frac * float(want.float().abs().max())
                q, k, v, kb, n_head = c.args
                every_other = c.plain(q, k[:, ::2], v[:, ::2],
                                      None if kb is None else kb[:, ::2], n_head)
                passes = [within(wrong, want, a, r)[1]
                          for wrong in (torch.zeros_like(want), every_other)]
                print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max |ref| "
                      f"{a / frac:.4f}; the tolerance passes an all-zero output: {passes[0]}, "
                      f"one over every other key: {passes[1]}", flush=True)
                if any(passes):
                    failed.append(f"{c.name} {dname} {c.shape} tolerance too loose")
                del every_other
            ops_ms, bytes_ms = 1e3 * c.ops / c.peak, 1e3 * _nbytes(c.args, c.kw, got) / HBM
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            if c.kw.get("emit_stats"):
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
                print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} emitted stats: max "
                      f"|err| / tol {st_err:.3f}", flush=True)
                if st_err > 1.0:
                    failed.append(f"{c.name} {dname} {c.shape} stats")
            err, ok = within(got, want, a, r)
            del got, want
            ms = cuda_ms(lambda: c.fn(*c.args, **c.kw))
            plain_ms = cuda_ms(lambda: c.plain(*c.args, **c.kw))
            lib_ms = None if c.library is None else cuda_ms(lambda: c.library(*c.args, **c.kw))
            lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
            print(f"kernel {c.name:21s} {dname:8s} {c.shape:30s} max_abs_err {err:.3e} "
                  f"(tol {a:.3g} + {r:.3g}|ref|) {'ok' if ok else 'FAILED'}  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms "
                  f"({bound_by})  [{key}]", flush=True)
            if not ok:
                failed.append(f"{c.name} {dname} {c.shape}")
            if dtype == torch.bfloat16:
                max_err[c.name] = max(max_err.get(c.name, 0.0), err)
                measured[(c.name, key)] = {
                    "label": c.shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms}
    if failed:
        fail("kernel disagrees with its plain version: " + "; ".join(failed))
    return max_err, measured


def main_path_times(measured: dict, shapes: dict) -> dict:
    """Per kernel, {ms, plain_ms, library_ms, bound_ms, bound_by} of its
    launches in the generate runs: each launched shape's phase-2 time (or
    bound) times its launches there, as the wrapper counted them per shape,
    summed. library_ms is None where a launched shape has no library call.
    Fails if a launched shape has no case in phase 2."""
    totals, missing = {}, []
    for name in KERNEL_INFO:
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
             "bytes_ms": 0.0}
        for key, n in sorted(shapes[name].items()):
            m = measured.get((name, key))
            if m is None:
                missing.append(f"{name} [{key}] x{n}")
                continue
            lib = "" if m["library_ms"] is None else f"  library {n * m['library_ms']:.3f} ms"
            print(f"main path {name:21s} {m['label']:32s} launches {n:4d}: kernel "
                  f"{n * m['ms']:.3f} ms  plain {n * m['plain_ms']:.3f} ms{lib}  bound "
                  f"{n * m['bound_ms']:.3f} ms", flush=True)
            for f in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
                t[f] += n * m[f]
            if m["library_ms"] is None or t["library_ms"] is None:
                t["library_ms"] = None
            else:
                t["library_ms"] += n * m["library_ms"]
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
          "upsample2x_conv_fused": 2, "group_norm_silu": 1},
    1024: {"flash_attention_heads": 1, "channel_partials": 262, "conv1x1_fused": 400,
           "fused_self_attention": 320, "fused_geglu_mlp": 120, "conv3x3_fused": 228,
           "upsample2x_conv_fused": 3, "group_norm_silu": 1},
}
EXPECTED_X2 = {512: 0, 1024: 60}  # K6 launches with the skip as second input


def phase_generate(dev, size: int) -> tuple[dict, dict]:
    """Phase 4: StableDiffusion.generate at SD v1.4 width, random weights,
    bf16, size x size, 20 DDIM steps, CFG 7.5, batch 1. Returns the launch
    counts, per kernel and per kernel and shape."""
    import torch

    from sdtpu_torch.config import SD_V1_4
    from sdtpu_torch.ops import fused_conv
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer
    from sdtpu_torch.weights import init_params

    cfg = dataclasses.replace(SD_V1_4, image_size=size)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
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
    return launches, shapes


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
    t_start = time.perf_counter()

    # phase 1: device and build
    print(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from sdtpu_torch import kernels

    t0 = time.perf_counter()
    path, _ = kernels.build()
    kernels.lib()
    print(f"build {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: each kernel against its plain version
    max_err, measured = phase_kernels(dev)
    # phase 3: one SpatialTransformer, the VAE decoder and one 1024px fused
    # ResBlock, card against CPU
    phase_transformer(dev)
    phase_decode(dev)
    phase_resblock(dev)
    # phase 4: the main path at 512px and at 1024px
    launches = {name: 0 for name in KERNEL_INFO}
    shapes = {name: {} for name in KERNEL_INFO}
    for size in (512, 1024):
        run_launches, run_shapes = phase_generate(dev, size)
        for name in KERNEL_INFO:
            launches[name] += run_launches[name]
            for key, n in run_shapes[name].items():
                shapes[name][key] = shapes[name].get(key, 0) + n
        torch.cuda.empty_cache()
    times = main_path_times(measured, shapes)

    kernels_json = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        t = times[name]
        kernels_json.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
