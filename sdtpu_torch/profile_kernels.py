"""Where the time of the port's Hopper kernels goes on one NVIDIA GPU.

    python -m sdtpu_torch.profile_kernels
        [--kernels K5,K9,K6,K2,K1,K4,K10,K7,K3,K5f,K2f,K6f,K7f,K4f,K9f,K1f,K10f]
        [--out FILE]

At main-path shapes, bf16, random inputs (seeded): K5 at S=1024 C=640 B=2
and S=256 C=1280 B=2 (csrc/gemm_sm90.cu), K9 at BH=32 S=4096 d=40
(csrc/flash_attention_bwd_sm90.cu), K6 at the UNet's 128² fused ResBlock
(640 + 320 -> 320, B=2) and the VAE decoder's 512² and 64² convs
(csrc/conv_sm90.cu), K2 at S=4096 C=320 B=2 and S=16384 C=320 B=2
(csrc/gemm_sm90.cu and csrc/attention_sm90.cu), K1 at training's BH=32
S=4096 d=40 and a key-bias case at d=80 (csrc/attention_sm90.cu) and the
VAE's BH=1 S=16384 d=512 (csrc/attention_wide_sm90.cu), K4 at its eight
main-path launches (proj_in with the GroupNorm prologue and proj_out with
the residual, at 4096 x 320 and 16384 x 320 B=2, 4096 x 640 B=2 and
4096 x 320 B=8; csrc/conv_sm90.cu at one tap), K10 at the serve phase's
S=4096 C=320 B=2, S=1024 C=640 B=4 and S=256 C=1280 B=8 with 77 masked keys
(csrc/gemm_sm90.cu and csrc/attention_sm90.cu), K7 at the decoder's 128² x
512, 256² x 256 and 512² x 256 (csrc/conv_sm90.cu at four taps), K3 at
its main-path shapes (csrc/channel_stats_sm90.cu); and in float32 (K5f, K2f,
K6f, K7f, K4f, K9f) K5 and K2 at the 512px generate's shapes on
csrc/gemm_tf32_sm90.cu and csrc/attention_tf32_sm90.cu, K6 at the 1024px
UNet's fused ResBlocks and the decoder's 512², 256² and 64² convs and K7 at
the decoder's four upsamplers on csrc/conv_tf32_sm90.cu, K4 at the 512px
and 1024px generates' proj_in and proj_out on the same kernel at one tap,
K9 at training's BH=32 S=4096 d=40 and SD v2.1's BH=10 S=9216 d=64 on
csrc/flash_attention_bwd_tf32_sm90.cu, K1 (K1f) at the same forward shapes
and a key-bias case at d=80 on csrc/attention_tf32_sm90.cu and at the
1024px and 768px decodes' d=512 on csrc/attention_wide_tf32_sm90.cu, and K10
(K10f) at the f32 512px generate's S=4096/1024/256, B=2, on
csrc/gemm_tf32_sm90.cu and csrc/attention_tf32_sm90.cu. --kernels picks
some of them (all by default). Device times are CUDA-graph replays (`device_ms`,
also what chip_smoke.py times the Hopper kernels by) or torch.profiler
kernel sums:

1. each launch of the bf16 routes (torch.profiler): K5's row statistics
   and its two GEMM launches, K9's Δ pre-pass, dK/dV and dQ kernels, K6's
   conv (and the statistics' sum), K2's row statistics, QKV product, core
   and Wo product;
2. K5's first product with and without its LayerNorm prologue (the
   prologue's cost), its second product on 64- and 128-column tiles, and
   cuBLAS's two matmuls of the same shapes; K6 with and without its
   prologue, on each tile width it has, the WMMA kernel it replaced, and
   cuDNN's convolution of the same shape; K2's QKV product, core and Wo
   product against cuBLAS's matmuls and SDPA of the same shapes; K1's core
   with and without the key bias and the log-sum-exp write, the WMMA
   kernel (csrc/flash_attention.cu) and SDPA; at d = 512 the wide kernel
   against the WMMA kernel in turns (old, new, new, old), and its products
   alone and its copies alone (the kernel's `probe`); K4 with and without its
   prologue, on each tile width it has, the WMMA kernel it replaced, and
   cuBLAS's x·W; K10's Q product, core and Wo product against cuBLAS's
   matmuls and SDPA, the whole route against the WMMA route and against
   the sublayer by library calls (F.layer_norm, two torch.matmul, SDPA);
   K7 on each tile width it has, the WMMA kernel it replaced, cuDNN's
   convolution over the upsampled map, the gate-closed path
   (ops/conv.upsample2x_conv's four phase convolutions), and the folding
   of its phase weights (host time a call and device time) against a
   launch's CUDA-event time; K3 against the partials kernel and its sum in
   turns (old, new, new, old), by device time and by CUDA
   events, beside torch.var_mean over the same rows (another function: a
   reference line, not the library column) and the bound; at three shapes
   every (channel block, cluster) the kernel takes, and the kernel over a
   16-row map, which reads almost nothing (the cost of the launch and the
   cluster barrier);
3. the depth of the rings: K5's 2, 3 or 4 stages (the plan's choice is 4),
   K6's, K4's and K7's 2 to 4 and K2's and K10's core's 3 to 5 where they
   fit;
4. float32 (K5f, K2f, K6f, K7f, K4f, K9f, K1f, K10f): each launch of the
   float32 route "tf32" (torch.profiler: K9's pre-pass, which writes the
   K-major copies and Δ, apart from its dK/dV and dQ kernels; K1's and
   K10's pre-pass, which rounds q and k and writes V's K-major copy, apart
   from their core); each TF32 product
   beside cuBLAS's matmul of the same shape with TF32 on and off (K4's x·W
   by device time); K2's and K1's TF32 cores beside SDPA (float32: the
   memory-efficient backend), K9 beside SDPA's backward; K1's pre-pass and
   core alone, with and without the lse; K10's products, pre-pass and core
   alone and the sublayer by library calls; K6, K7 and K4 on
   each tile width (K6 and K4 with and without their prologue) beside
   cuDNN's convolution with TF32 on and off; the whole sublayer against the
   WMMA route it replaced, in turns (wmma, tf32, tf32, wmma); the ring
   depths the route takes; the bytes of the K-major copies.

The report starts with the card's name and power limit, and goes to
stdout and, with --out, to FILE as well.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import time

import torch
import torch.nn.functional as F

from sdtpu_torch import kernels
from sdtpu_torch.ops import flash_attention as fa
from sdtpu_torch.ops import conv as cv
from sdtpu_torch.ops import fused_conv as fc
from sdtpu_torch.ops import fused_cross_attention as fx
from sdtpu_torch.ops import fused_mlp as fm
from sdtpu_torch.ops import fused_transformer as ft

WARMUP, ITERS = 3, 20


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA graph
    after a warm-up on a side stream, the replay timed by CUDA events (the
    best of three replays), so that no host gap between launches counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured as torch.cuda.graph captures, less the gc.collect() it runs
    # first (about 50 ms a capture in a process as large as chip_smoke.py's,
    # whose phase 2 captures about a thousand times); empty_cache() stays:
    # it releases the private pools of the graphs captured before
    torch.cuda.empty_cache()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(iters):
                fn()
        finally:
            graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def kernel_ms(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key] = t / calls / 1e3
    return out


def _gemm(a, w, out, m, n, k, plan, *, bias, gamma=None, beta=None, stats=None, res=None,
          geglu_off=0):
    """One launch of sdk_gemm_sm90 with the given plan (a Sm90Plan)."""
    rc = kernels.lib().sdk_gemm_sm90(
        a.data_ptr(), k, w.data_ptr(), w.shape[1], kernels.ptr(bias), kernels.ptr(gamma),
        kernels.ptr(beta), kernels.ptr(stats), kernels.ptr(res), n if res is not None else 0,
        out.data_ptr(), out.shape[1], m, n, k, geglu_off, plan.bn, plan.stages, plan.smem,
        kernels.stream(a))
    kernels.check(rc, "sdk_gemm_sm90")


def _with_stages(plan: fm.Sm90Plan, stages: int) -> fm.Sm90Plan:
    stage = (plan.smem - 1024) // plan.stages
    return plan._replace(stages=stages, smem=1024 + stages * stage)


def profile_k5(b, s, c, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16
    m, c4 = b * s, 4 * c

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    x, h = rnd(m, c), rnd(m, c4)
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wp, bp = rnd(c, 8 * c, scale=c ** -0.5), rnd(8 * c, scale=0.1)
    wl, bl = rnd(c4, c, scale=c4 ** -0.5), rnd(c, scale=0.1)
    stats = torch.empty(m, 2, device=dev)
    kernels.check(kernels.lib().sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, 1e-5,
                                              kernels.stream(x)), "sdk_row_stats")
    out1, out2 = torch.empty(m, c4, device=dev, dtype=dt), torch.empty(m, c, device=dev, dtype=dt)
    label = f"K5 S={s} C={c} B={b}"
    args = (x.view(b, s, c), g, beta, wp, bp, wl, bl)
    for name, ms in kernel_ms(lambda: fm.fused_geglu_mlp(*args)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    p1, p2 = fm.sm90_plan(m, c4, c, True), fm.sm90_plan(m, c, c4, False)

    def first(plan, ln=True):
        return lambda: _gemm(x, wp, out1, m, c4, c, plan, bias=bp, gamma=g if ln else None,
                             beta=beta if ln else None, stats=stats if ln else None,
                             geglu_off=c4)

    def second(plan):
        return lambda: _gemm(h, wl, out2, m, c, c4, plan, bias=bl, res=x)

    p2_64 = fm.Sm90Plan(64, 1, p2.stages, 1024 + p2.stages * (16384 + 8192 + 16), None)
    p2_128 = fm.Sm90Plan(128, 2, p2.stages, 1024 + p2.stages * (16384 + 2 * 8192 + 16), None)
    log(f"{label}: first product with the LayerNorm prologue {device_ms(first(p1)):.4f} ms, "
        f"without {device_ms(first(p1, ln=False)):.4f}; second product on 64-column tiles "
        f"{device_ms(second(p2_64)):.4f} ms, 128-column {device_ms(second(p2_128)):.4f} (the "
        f"plan takes {p2.bn}); cuBLAS x·W_proj {device_ms(lambda: torch.matmul(x, wp)):.4f} "
        f"ms, h·W_lin {device_ms(lambda: torch.matmul(h, wl)):.4f}")
    rings = [f"{st} stages {device_ms(first(_with_stages(p1, st))):.4f} / "
             f"{device_ms(second(_with_stages(p2, st))):.4f}" for st in (2, 3, 4)]
    log(f"{label}: first / second product by ring depth: " + ", ".join(rings) +
        f" (the plan takes {p1.stages})")


def profile_k9(bh, s, d, n_head, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev).to(dt) for _ in range(4))
    o, lse = fa.flash_attention_heads(q, k, v, n_head=n_head, return_lse=True)
    label = f"K9 BH={bh} S={s} d={d}"
    for name, ms in kernel_ms(lambda: fa.flash_attention_bwd_heads(q, k, v, do, o, lse,
                                                                  n_head)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")


def profile_k6(b, hw, c1, c2, co, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    ct = c1 + c2
    x, x2 = rnd(b, hw, hw, c1), (rnd(b, hw, hw, c2) if c2 else None)
    w, cb = rnd(3, 3, ct, co, scale=(9 * ct) ** -0.5), rnd(co, scale=0.1)
    s = 1.0 + 0.1 * torch.randn(b, ct, generator=gen, device=dev)
    o = 0.1 * torch.randn(b, ct, generator=gen, device=dev)
    label = f"K6 {hw}x{hw} {c1}{f'+{c2}' if c2 else ''}->{co} B={b}"

    def conv(route, prologue=True):
        pro = (s[:, :c1], o[:, :c1]) if prologue else (None, None)
        pro2 = (s[:, c1:], o[:, c1:]) if prologue and c2 else (None, None)
        return lambda: fc._conv3x3(x, w, cb, *pro, None, True, True, x2, *pro2, route)

    for name, ms in kernel_ms(conv("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    plan = fc.sm90_plan(b, hw, hw, c1, c2, co, True)
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cudnn = device_ms(lambda: F.conv2d(xin.permute(0, 3, 1, 2), w_oihw, padding=1))
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or co % bn == 0:
            p = fc.sm90_plan(b, hw, hw, c1, c2, co, True, bn=bn)
            p0 = fc.sm90_plan(b, hw, hw, c1, c2, co, False, bn=bn)
            widths.append(f"{bn} channels {device_ms(conv(p)):.4f} ms with the prologue, "
                          f"{device_ms(conv(p0, prologue=False)):.4f} without")
    flops = 2 * 9 * b * hw * hw * ct * co
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the WMMA kernel "
        f"{device_ms(conv('wmma')):.4f} ms; cuDNN's conv of the concat {cudnn:.4f} ms; bound "
        f"{1e3 * flops / 989e12:.4f} ms")
    rings = []
    for st in range(2, fc.SM90_CONV_MAX_STAGES + 1):
        try:
            p = fc.sm90_plan(b, hw, hw, c1, c2, co, True, bn=plan.bn, stages=st)
        except ValueError:
            continue
        if p is not None:
            rings.append(f"{st} stages {device_ms(conv(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


def profile_k2(b, s, c, n_head, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    m, d = b * s, c // n_head
    x = rnd(b, s, c)
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wqkv, wo, bo = rnd(c, 3 * c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    label = f"K2 S={s} C={c} B={b}"
    args = (x, g, beta, wqkv, wo, bo, n_head)
    for name, ms in kernel_ms(lambda: ft.fused_self_attention(*args)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    plan = ft.sm90_plan(b, s, c, n_head)
    stats = torch.empty(m, 2, device=dev)
    kernels.check(kernels.lib().sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, 1e-5,
                                              kernels.stream(x)), "sdk_row_stats")
    qkv, attn = torch.empty(b, s, 3 * c, device=dev, dtype=dt), rnd(b, s, c)
    out = torch.empty_like(x)
    xm = x.view(m, c)
    _gemm(xm, wqkv, qkv.view(m, 3 * c), m, 3 * c, c, plan.qkv, bias=None, gamma=g, beta=beta,
          stats=stats)
    q4 = qkv.view(b, s, 3, n_head, d).permute(2, 0, 3, 1, 4)
    am = attn.view(m, c)
    t = {name: device_ms(fn) for name, fn in (
        ("qkv", lambda: _gemm(xm, wqkv, qkv.view(m, 3 * c), m, 3 * c, c, plan.qkv, bias=None,
                              gamma=g, beta=beta, stats=stats)),
        ("qkv cuBLAS", lambda: torch.matmul(xm, wqkv)),
        ("core", lambda: ft.attention_core_sm90(qkv, attn, n_head, plan.core)),
        ("core SDPA", lambda: F.scaled_dot_product_attention(q4[0], q4[1], q4[2])),
        ("wo", lambda: _gemm(am, wo, out.view(m, c), m, c, c, plan.out, bias=bo, res=xm)),
        ("wo cuBLAS", lambda: torch.matmul(am, wo)),
        ("wmma", lambda: ft._self_attention(*args, 1e-5, "wmma")))}
    log(f"{label}: QKV product (LayerNorm prologue) {t['qkv']:.4f} ms, cuBLAS x·Wqkv "
        f"{t['qkv cuBLAS']:.4f}; core {t['core']:.4f} ms, SDPA {t['core SDPA']:.4f}; Wo product "
        f"(bias, residual) {t['wo']:.4f} ms, cuBLAS o·Wo {t['wo cuBLAS']:.4f}; the WMMA route "
        f"(three launches) {t['wmma']:.4f}")
    rings = []
    for st in (3, 4, 5):
        core = plan.core._replace(stages=st, smem=plan.core.smem + (st - plan.core.stages)
                                  * 2 * plan.core.tile * plan.core.dpad * 2)
        if core.smem <= kernels.SMEM_LIMIT:
            ms = device_ms(lambda: ft.attention_core_sm90(qkv, attn, n_head, core))
            rings.append(f"{st} stages {ms:.4f}")
    log(f"{label}: core by ring depth: " + ", ".join(rings) +
        f" (the plan takes {plan.core.stages})")


def _tf32_matmul_ms(a, w) -> tuple[float, float]:
    """cuBLAS's a·w (float32) by device time, TF32 on and off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = device_ms(lambda: torch.matmul(a, w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return on, device_ms(lambda: torch.matmul(a, w))


def _turns(fa, fb) -> tuple[float, float]:
    """Device ms of fa and fb in turns (a, b, b, a), each its two turns'
    mean."""
    t = [device_ms(f) for f in (fa, fb, fb, fa)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def profile_k5f(b, s, c, log, gen):
    """K5's float32 route (csrc/gemm_tf32_sm90.cu), section 4."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    m, c4 = b * s, 4 * c
    x, h = rnd(m, c), fm.round_tf32(rnd(m, c4))
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wp, bp = rnd(c, 8 * c, scale=c ** -0.5), rnd(8 * c, scale=0.1)
    wl, bl = rnd(c4, c, scale=c4 ** -0.5), rnd(c, scale=0.1)
    label = f"K5 f32 S={s} C={c} B={b}"
    args = (x.view(b, s, c), g, beta, wp, bp, wl, bl)
    for name, ms in kernel_ms(lambda: fm.fused_geglu_mlp(*args)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    stats = torch.empty(m, 2, device=dev)
    fm.row_stats_f32(x, stats, m, c, 1e-5)
    out1, out2 = torch.empty(m, c4, device=dev), torch.empty(m, c, device=dev)
    w1, w2 = fm.kmajor(wp), fm.kmajor(wl)

    def products(stages=None):
        p1, p2 = fm.tf32_plan(m, c4, c, True), fm.tf32_plan(m, c, c4, False)
        if stages is not None:
            p1, p2 = (p._replace(stages=stages, smem=1024 + stages * ((p.smem - 1024)
                                                                      // p.stages))
                      for p in (p1, p2))
        return (lambda: fm.gemm_tf32(x, c, w1, c, out1, c4, m, c4, c, p1, bias=bp, gamma=g,
                                     beta=beta, stats=stats, geglu_off=c4, round_out=True),
                lambda: fm.gemm_tf32(h, c4, w2, c4, out2, c, m, c, c4, p2, bias=bl, res=x,
                                     ldr=c), p1, p2)

    f1, f2, p1, p2 = products()
    first, second = device_ms(f1), device_ms(f2)
    on1, off1 = _tf32_matmul_ms(x, wp)
    on2, off2 = _tf32_matmul_ms(h, wl)
    wmma, whole = _turns(lambda: fm._fused_geglu_mlp(*args, route="wmma"),
                         lambda: fm._fused_geglu_mlp(*args, route="tf32"))
    flops = 2 * m * c * 12 * c
    log(f"{label}: first product (LayerNorm, GEGLU) {first:.4f} ms, cuBLAS x·W_proj TF32 "
        f"{on1:.4f} / f32 {off1:.4f}; second product (bias, residual) {second:.4f} ms (bn "
        f"{p2.bn}), cuBLAS h·W_lin TF32 {on2:.4f} / f32 {off2:.4f}; the sublayer "
        f"{whole:.4f} ms, the WMMA route {wmma:.4f} (in turns); TF32 bound "
        f"{1e3 * flops / 495e12:.4f} ms; K-major copies {fm.kmajor_bytes()} bytes")
    rings = []
    for st in range(2, max(p1.stages, p2.stages) + 1):
        g1, g2, q1, q2 = products(st)
        if max(q1.smem, q2.smem) + 2 * fm.TF32_LN_MAX_K * 4 <= kernels.SMEM_LIMIT:
            rings.append(f"{st} stages {device_ms(g1):.4f} / {device_ms(g2):.4f}")
    log(f"{label}: first / second product by ring depth: " + ", ".join(rings)
        + f" (the plans take {p1.stages} / {p2.stages})")


def profile_k2f(b, s, c, n_head, log, gen):
    """K2's float32 route (csrc/gemm_tf32_sm90.cu, csrc/attention_tf32_sm90.cu),
    section 4."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    m, d = b * s, c // n_head
    x = rnd(b, s, c)
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wqkv, wo, bo = rnd(c, 3 * c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    label = f"K2 f32 S={s} C={c} B={b} d={d}"
    args = (x, g, beta, wqkv, wo, bo, n_head)
    for name, ms in kernel_ms(lambda: ft.fused_self_attention(*args)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    plan = ft.tf32_plan(b, s, c, n_head)
    stats = torch.empty(m, 2, device=dev)
    fm.row_stats_f32(x, stats, m, c, 1e-5)
    qk = torch.empty(b, s, 2 * c, device=dev)
    vt = torch.empty(b, n_head, d, s, device=dev)
    attn = fm.round_tf32(rnd(b, s, c))
    out = torch.empty_like(x)
    xm = x.view(m, c)
    w1, w2 = fm.kmajor(wqkv), fm.kmajor(wo)

    def qkv():
        fm.gemm_tf32(xm, c, w1, c, qk, 2 * c, m, 3 * c, c, plan.qkv, gamma=g, beta=beta,
                     stats=stats, round_out=True, vt=vt, vt_col=2 * c, vt_s=s, vt_d=d,
                     vt_h=n_head)

    def wo_product():
        fm.gemm_tf32(attn.view(m, c), c, w2, c, out, c, m, c, c, plan.out, bias=bo, res=xm,
                     ldr=c)

    qkv()
    core = plan.core
    q4 = qk.view(b, s, 2, n_head, d).permute(2, 0, 3, 1, 4)
    v4 = torch.randn(b, n_head, s, d, generator=gen, device=dev)
    t_qkv, t_wo = device_ms(qkv), device_ms(wo_product)
    on_qkv, off_qkv = _tf32_matmul_ms(xm, wqkv)
    on_wo, off_wo = _tf32_matmul_ms(attn.view(m, c), wo)
    t_core = device_ms(lambda: ft.attention_core_tf32(qk, vt, attn, n_head, core))
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(q4[0], q4[1], v4))
    wmma, whole = _turns(lambda: ft._self_attention(*args, 1e-5, "wmma"),
                         lambda: ft._self_attention(*args, 1e-5, "tf32"))
    flops = b * (8 * s * c * c + 4 * s * s * c)
    log(f"{label}: QKV product (LayerNorm, V transposed) {t_qkv:.4f} ms, cuBLAS TF32 "
        f"{on_qkv:.4f} / f32 {off_qkv:.4f}; core {t_core:.4f} ms (tile {core.tile}, "
        f"{core.stages} stages), SDPA (float32) {sdpa:.4f}; Wo product {t_wo:.4f} ms, cuBLAS "
        f"TF32 {on_wo:.4f} / f32 {off_wo:.4f}; the sublayer {whole:.4f} ms, the WMMA route "
        f"{wmma:.4f} (in turns); TF32 bound {1e3 * flops / 495e12:.4f} ms")
    rings = []
    for st in range(3, 7):
        cp = core._replace(stages=st, smem=core.smem + (st - core.stages) * 2 * core.tile * d * 4)
        if cp.smem <= kernels.SMEM_LIMIT:
            ms = device_ms(lambda: ft.attention_core_tf32(qk, vt, attn, n_head, cp))
            rings.append(f"{st} stages {ms:.4f}")
    log(f"{label}: core by ring depth: " + ", ".join(rings) + f" (the plan takes "
        f"{core.stages})")


def _cudnn_tf32_ms(fn) -> tuple[float, float]:
    """cuDNN's fn() (float32) by device time, TF32 on and off."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        on = device_ms(fn)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return on, device_ms(fn)


def profile_k6f(b, hw, c1, c2, co, log, gen):
    """K6's float32 route (csrc/conv_tf32_sm90.cu), section 4."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ct = c1 + c2
    x, x2 = rnd(b, hw, hw, c1), (rnd(b, hw, hw, c2) if c2 else None)
    w, cb = rnd(3, 3, ct, co, scale=(9 * ct) ** -0.5), rnd(co, scale=0.1)
    s, o = 1.0 + rnd(b, ct, scale=0.1), rnd(b, ct, scale=0.1)
    label = f"K6 f32 {hw}x{hw} {c1}{f'+{c2}' if c2 else ''}->{co} B={b}"

    def conv(route, prologue=True):
        pro = (s[:, :c1], o[:, :c1]) if prologue else (None, None)
        pro2 = (s[:, c1:], o[:, c1:]) if prologue and c2 else (None, None)
        return lambda: fc._conv3x3(x, w, cb, *pro, None, True, True, x2, *pro2, route)

    for name, ms in kernel_ms(conv("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    plan = fc.tf32_conv_plan(b, hw, hw, c1, c2, co, True)
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or co % bn == 0:
            p = fc.tf32_conv_plan(b, hw, hw, c1, c2, co, True, bn=bn)
            p0 = fc.tf32_conv_plan(b, hw, hw, c1, c2, co, False, bn=bn)
            widths.append(f"{bn} channels {device_ms(conv(p)):.4f} ms with the prologue, "
                          f"{device_ms(conv(p0, prologue=False)):.4f} without")
    xin = (x if x2 is None else torch.cat([x, x2], dim=-1)).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    on, off = _cudnn_tf32_ms(lambda: F.conv2d(xin, w_oihw, padding=1))
    wmma, tf32 = _turns(conv("wmma"), conv("tf32"))
    flops = 2 * 9 * b * hw * hw * ct * co
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the route {tf32:.4f} "
        f"ms against the WMMA kernel {wmma:.4f} (in turns); cuDNN's conv of the concat TF32 "
        f"{on:.4f} / f32 {off:.4f}; TF32 bound {1e3 * flops / 495e12:.4f} ms; K-major copies "
        f"{fm.kmajor_bytes()} bytes")
    rings = []
    for st in range(2, fc.TF32_CONV_MAX_STAGES + 1):
        p = fc.tf32_conv_plan(b, hw, hw, c1, c2, co, True, bn=plan.bn, stages=st)
        if p is not None:
            rings.append(f"{st} stages {device_ms(conv(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


def profile_k4f(b, rows, c, co, kind, log, gen):
    """K4's float32 route (csrc/conv_tf32_sm90.cu at one tap), section 4."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, w, cb = rnd(b, rows, c), rnd(1, 1, c, co, scale=c ** -0.5), rnd(co, scale=0.1)
    s, o = 1.0 + rnd(b, c, scale=0.1), rnd(b, c, scale=0.1)
    res = rnd(b, rows, co) if kind == "proj_out" else None
    label = f"K4 f32 {kind} {rows}x{c}->{co} B={b}"

    def conv(route, prologue=True):
        pro = (s, o) if prologue and kind == "proj_in" else (None, None)
        return lambda: fc._conv1x1(x, w, cb, *pro, res, False, False, route)

    for name, ms in kernel_ms(conv("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    plan = fc.conv1x1_tf32_plan(b, rows, c, co, kind == "proj_in")
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or co % bn == 0:
            p = fc.conv1x1_tf32_plan(b, rows, c, co, kind == "proj_in", bn=bn)
            t = f"{bn} channels {device_ms(conv(p)):.4f} ms"
            if kind == "proj_in":
                p0 = fc.conv1x1_tf32_plan(b, rows, c, co, False, bn=bn)
                t += f" with the prologue, {device_ms(conv(p0, prologue=False)):.4f} without"
            widths.append(t)
    on, off = _tf32_matmul_ms(x, w[0, 0])
    wmma, tf32 = _turns(conv("wmma"), conv("tf32"))
    nbytes = 4 * (b * rows * c + (1 if res is None else 2) * b * rows * co + c * co)
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the route {tf32:.4f} "
        f"ms against the WMMA kernel {wmma:.4f} (in turns); cuBLAS x·W TF32 {on:.4f} / f32 "
        f"{off:.4f}; bound (bytes) {1e3 * nbytes / 3.35e12:.4f} ms; K-major copies "
        f"{fm.kmajor_bytes()} bytes")
    rings = []
    for st in range(2, fc.TF32_CONV_MAX_STAGES + 1):
        p = fc.conv1x1_tf32_plan(b, rows, c, co, kind == "proj_in", bn=plan.bn, stages=st)
        if p is not None:
            rings.append(f"{st} stages {device_ms(conv(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


def profile_k9f(bh, s, d, n_head, log, gen):
    """K9's float32 route (csrc/flash_attention_bwd_tf32_sm90.cu), section 4:
    the pre-pass (the K-major copies of q, dO and k, and Δ), dK/dV and dQ
    by the profiler; the route against the WMMA kernel in turns; SDPA's
    backward (its forward and backward less its forward) with TF32 on and
    off."""
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev) for _ in range(4))
    o, lse = fa.flash_attention_heads(q, k, v, n_head=n_head, return_lse=True)
    label = f"K9 f32 BH={bh} S={s} d={d}"
    for name, ms in kernel_ms(lambda: fa._bwd_heads(q, k, v, do, o, lse, n_head,
                                                    "tf32")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    wmma, tf32 = _turns(lambda: fa._bwd_heads(q, k, v, do, o, lse, n_head, "wmma"),
                        lambda: fa._bwd_heads(q, k, v, do, o, lse, n_head, "tf32"))
    q4, k4, v4 = (t.view(bh // n_head, n_head, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(bh // n_head, n_head, s, d)

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (q4, k4, v4), do4)

    sdpa = []
    for tf32_on in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32_on
        try:
            sdpa.append(events_ms(fwd_bwd) - events_ms(fwd))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    log(f"{label} ({fa.bwd_tf32_plan(d)}): the route {tf32:.4f} ms against the WMMA kernel "
        f"{wmma:.4f} (in turns); SDPA's backward {sdpa[0]:.4f} (TF32 on) / {sdpa[1]:.4f} "
        f"(off) by CUDA events; TF32 bound {1e3 * 5 * 2 * bh * s * s * d / 495e12:.4f} ms")


def _sdpa_tf32_ms(fn) -> tuple[float, float]:
    """fn (an SDPA call, float32) by device time, TF32 on and off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = device_ms(fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return on, device_ms(fn)


def profile_k1f(bh, n_head, s, d, bias, log, gen):
    """K1's float32 routes (csrc/attention_tf32_sm90.cu at d <= 160,
    csrc/attention_wide_tf32_sm90.cu at d = 512), section 4: the pre-pass
    and the core by the profiler; the pre-pass alone, the core alone, with
    and without the lse (and the bias); the route against the WMMA kernel
    in turns; SDPA with TF32 on and off."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev) for _ in range(3))
    kb = None
    if bias:  # a key-padding row a batch element: a third of the keys masked
        kb = torch.where(torch.arange(s, device=dev)[None] < 2 * s // 3, 0.0, -1e30)
        kb = kb.expand(bh // n_head, s).contiguous()
    plan = fa.fwd_route(torch.float32, d, bias)
    label = f"K1 f32 BH={bh} S={s} d={d}{' bias' if bias else ''} ({plan})"
    for name, ms in kernel_ms(lambda: fa.flash_attention_heads(q, k, v, kb, n_head,
                                                               True)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route {fa.ROUTE_NAMES[type(plan)]})")
    q4, k4, v4 = (t.view(bh // n_head, n_head, s, d) for t in (q, k, v))
    qr, kr, vt = fa.tf32_copies(q4, k4, v4)
    out = torch.empty_like(q4)
    lse = torch.empty((bh, s), device=dev)
    parts = [f"pre-pass {device_ms(lambda: fa.tf32_copies(q4, k4, v4)):.4f} ms"]
    variants = [("core", kb, None), ("core with the lse", kb, lse)]
    if bias:
        variants.append(("core without the bias", None, None))
    for name, b_, l_ in variants:
        ms = device_ms(lambda: fa.attend_tf32(qr, kr, vt, b_, out, l_, plan))
        parts.append(f"{name} {ms:.4f} ms")
    wmma, tf32 = _turns(lambda: fa._heads(q, k, v, kb, n_head, False, "wmma"),
                        lambda: fa.flash_attention_heads(q, k, v, kb, n_head))
    mask = None if kb is None else kb[:, None, None, :]
    on, off = _sdpa_tf32_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask))
    log(f"{label}: " + "; ".join(parts) + f"; the route {tf32:.4f} ms against the WMMA kernel "
        f"{wmma:.4f} (in turns); SDPA {on:.4f} (TF32 on) / {off:.4f} (off); TF32 bound "
        f"{1e3 * 4 * bh * s * s * d / 495e12:.4f} ms")


def profile_k10f(b, s, c, n_head, log, gen):
    """K10's float32 route (csrc/gemm_tf32_sm90.cu and csrc/attention_tf32_sm90.cu),
    section 4: each launch by the profiler; the Q product, the pre-pass,
    the core and the Wo product alone beside cuBLAS's matmuls and SDPA with
    TF32 on; the route against the WMMA route in turns; the sublayer by
    library calls with TF32 on and off."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    sk, d, m = 77, c // n_head, b * s
    x, ctx = rnd(b, s, c), rnd(b, sk, 768)
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wq, wo, bo = rnd(c, c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    kt, vt = (torch.matmul(ctx, rnd(768, c, scale=768 ** -0.5)).transpose(1, 2)
              for _ in range(2))
    valid = torch.arange(sk, device=dev)[None] < torch.tensor([2, 9] * (b // 2),
                                                              device=dev)[:, None]
    label = f"K10 f32 S={s} C={c} B={b} Sk={sk}"
    args = (x, kt, vt, g, beta, wq, wo, bo)
    for name, ms in kernel_ms(lambda: fx.fused_cross_attention_kv(
            *args, key_valid=valid, n_head=n_head)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    plan = fx.route_plan(torch.float32, b, s, c, n_head, sk, True)
    bias = torch.where(valid, 0.0, fa.NEG_INF).float()
    stats = torch.empty(m, 2, device=dev)
    fm.row_stats_f32(x, stats, m, c, 1e-5)
    w1, w2 = fm.kmajor(wq), fm.kmajor(wo)
    q, attn, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    k, v = kt.transpose(1, 2), vt.transpose(1, 2)
    k4, v4 = fx._heads_of(k, n_head), fx._heads_of(v, n_head)
    _, kr, vc = fa.tf32_copies(None, k4, v4)
    q4 = fx._heads_of(q, n_head)
    mask = valid[:, None, None, :]

    def library():  # the sublayer by library calls
        h = F.layer_norm(x, (c,), g, beta)
        o = F.scaled_dot_product_attention(fx._heads_of(torch.matmul(h, wq), n_head), k4, v4,
                                           attn_mask=mask)
        return x + torch.matmul(o.transpose(1, 2).reshape(b, s, c), wo) + bo

    t = {name: device_ms(fn) for name, fn in (
        ("q", lambda: fm.gemm_tf32(x, c, w1, c, q, c, m, c, c, plan.q, gamma=g, beta=beta,
                                   stats=stats, round_out=True)),
        ("pre-pass", lambda: fa.tf32_copies(None, k4, v4)),
        ("core", lambda: fa.attend_tf32(q4, kr, vc, bias, fx._heads_of(attn, n_head), None,
                                        plan.core, round_o=True)),
        ("wo", lambda: fm.gemm_tf32(attn, c, w2, c, out, c, m, c, c, plan.out, bias=bo,
                                    res=x, ldr=c)))}
    wmma, tf32 = _turns(lambda: fx._cross_attention_kv(*args, valid, n_head, 1e-5, "wmma"),
                        lambda: fx.fused_cross_attention_kv(*args, key_valid=valid,
                                                            n_head=n_head))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        q_cublas = device_ms(lambda: torch.matmul(x, wq))
        core_sdpa = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     attn_mask=mask))
        lib_on = device_ms(library)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    lib_off = device_ms(library)
    log(f"{label} ({plan.core}): Q product (LayerNorm prologue) {t['q']:.4f} ms, cuBLAS x·Wq "
        f"{q_cublas:.4f} (TF32 on); pre-pass (k rounded, V's copy) {t['pre-pass']:.4f} ms; "
        f"core (key bias) {t['core']:.4f} ms, SDPA {core_sdpa:.4f} (TF32 on); Wo product "
        f"(bias, residual) {t['wo']:.4f} ms; the route {tf32:.4f} ms against the WMMA route "
        f"{wmma:.4f} (in turns); the sublayer by library calls {lib_on:.4f} (TF32 on) / "
        f"{lib_off:.4f} (off); TF32 bound {1e3 * 2 * b * s * c * (2 * c + 2 * sk) / 495e12:.4f}"
        f" ms")


def profile_k7f(b, hw, c, co, log, gen):
    """K7's float32 route (csrc/conv_tf32_sm90.cu at four taps), section 4."""
    dev = torch.device("cuda")
    x = torch.randn(b, hw, hw, c, generator=gen, device=dev)
    w = torch.randn(3, 3, c, co, generator=gen, device=dev) * (9 * c) ** -0.5
    cb = 0.1 * torch.randn(co, generator=gen, device=dev)
    label = f"K7 f32 {hw}x{hw}x{c} -> {2 * hw}x{2 * hw}x{co} B={b}"
    phases = fc.phase_weight_stack(w, torch.float32)

    def up(route):
        return lambda: fc._upsample2x(x, w, cb, True, route, phases)

    for name, ms in kernel_ms(up("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call (route tf32)")
    plan = fc.upsample_tf32_plan(b, hw, hw, c, co)
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or co % bn == 0:
            p = fc.upsample_tf32_plan(b, hw, hw, c, co, bn=bn)
            widths.append(f"{bn} channels {device_ms(up(p)):.4f} ms")
    xu = cv.nearest_upsample_2x(x).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    on, off = _cudnn_tf32_ms(lambda: F.conv2d(xu, w_oihw, padding=1))
    wmma, tf32 = _turns(up("wmma"), up("tf32"))
    flops = 2 * 16 * b * hw * hw * c * co
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the route "
        f"{tf32:.4f} ms against the WMMA kernel {wmma:.4f} (in turns); "
        f"cuDNN's conv over the upsampled map TF32 {on:.4f} / f32 {off:.4f}; TF32 bound "
        f"{1e3 * flops / 495e12:.4f} ms")
    rings = []
    for st in range(2, fc.TF32_CONV_MAX_STAGES + 1):
        p = fc.upsample_tf32_plan(b, hw, hw, c, co, bn=plan.bn, stages=st)
        if p is not None:
            rings.append(f"{st} stages {device_ms(up(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


def profile_k1(bh, n_head, s, d, bias, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev).to(dt) for _ in range(3))
    kb = None
    if bias:  # a key-padding row a batch element: a third of the keys masked
        kb = torch.where(torch.arange(s, device=dev)[None] < 2 * s // 3, 0.0, -1e30)
        kb = kb.expand(bh // n_head, s).contiguous()
    label = f"K1 BH={bh} S={s} d={d}{' bias' if bias else ''}"
    q4, k4, v4 = (t.view(bh // n_head, n_head, s, d) for t in (q, k, v))
    mask = None if kb is None else kb[:, None, None, :].to(dt)
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask))
    old = device_ms(lambda: fa._heads(q, k, v, kb, n_head, False, "wmma"))
    flops = 4 * bh * s * s * d
    parts = []
    if fa.fwd_route(dt, d, bias) is not None:
        for name, ms in kernel_ms(lambda: fa.flash_attention_heads(q, k, v, kb, n_head,
                                                                   True)).items():
            log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
        variants = [("core", kb, False), ("core with the log-sum-exp", kb, True)]
        if bias:
            variants.append(("core without the bias", None, False))
        for name, b_, lse in variants:
            ms = device_ms(lambda: fa.flash_attention_heads(q, k, v, b_, n_head, lse))
            parts.append(f"{name} {ms:.4f} ms")
    plan = fa.fwd_route(dt, d, bias)
    if isinstance(plan, fa.WidePlan):
        new = lambda: fa.flash_attention_heads(q, k, v, kb, n_head)  # noqa: E731
        old_ = lambda: fa._heads(q, k, v, kb, n_head, False, "wmma")  # noqa: E731
        turns = [device_ms(f) for f in (old_, new, new, old_)]
        parts.append("in turns old/new/new/old " + " / ".join(f"{t:.4f}" for t in turns))
        out = torch.empty_like(q)
        for probe, name in ((1, "products alone"), (2, "copies alone")):
            def run(probe=probe):
                rc = kernels.lib().sdk_attention_wide_sm90(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *(x for t in (q, k, v, out) for x in (t.stride(0), 0, t.stride(1))), None,
                    s, None, bh, 1, s, s, d, float(d) ** -0.5, *plan, probe, kernels.stream(q))
                kernels.check(rc, "sdk_attention_wide_sm90")
            parts.append(f"{name} {device_ms(run):.4f} ms")
    log(f"{label}: " + "; ".join(parts + [f"the WMMA kernel {old:.4f} ms", f"SDPA {sdpa:.4f} ms",
                                          f"bound {1e3 * flops / 989e12:.4f} ms"]))


# (B, rows, C) of K3's launches on the main paths: the UNet's at 512px and
# 1024px (B=2; the serve phase's B=8), the VAE decoder's (B=1; the serve
# phase's B=4), the VAE encoder's in the latent cache (B=4) and in img2img
# (B=1)
K3_SHAPES = ((2, 4096, 320), (8, 4096, 320), (2, 4096, 640), (2, 16384, 320),
             (2, 16384, 640), (1, 4096, 512), (1, 16384, 512), (4, 4096, 512),
             (4, 16384, 512), (4, 262144, 128), (4, 65536, 128), (4, 65536, 256),
             (4, 16384, 256), (1, 262144, 128), (1, 65536, 128), (1, 65536, 256),
             (1, 16384, 256))


def profile_k3(b, rows, c, log, gen):
    from sdtpu_torch.ops import fused_groupnorm as fg

    x = torch.randn(b, rows, c, generator=gen, device="cuda").to(torch.bfloat16)
    new = lambda: fg.channel_partials(x)  # noqa: E731
    old = lambda: fg._channel_partials(x, "partials")  # noqa: E731
    turns = [device_ms(f) for f in (old, new, new, old)]
    ev_old, ev_new = events_ms(old), events_ms(new)
    ref = device_ms(lambda: torch.var_mean(x, dim=1))
    bound = 1e3 * (x.numel() * 2 + b * 2 * c * 4) / 3.35e12
    log(f"K3 {rows}x{c} B={b} {fg.stats_plan(b, rows, c)}: device ms old/new/new/old "
        + " / ".join(f"{1e3 * t:.2f} us" for t in turns)
        + f"; events old {1e3 * ev_old:.2f} us, new {1e3 * ev_new:.2f} us; torch.var_mean "
          f"(a reference line) {1e3 * ref:.2f} us; bound {1e3 * bound:.2f} us")


def sweep_k3(b, rows, c, log, gen):
    """K3's device time at every (channel block, cluster) the kernel takes."""
    x = torch.randn(b, rows, c, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty(b, 2, c, device="cuda")
    res = []
    for cb in (64, 32, 16):
        for cluster in (1, 2, 4, 8, 16):
            if cluster > rows:
                continue

            def run(cb=cb, cluster=cluster):
                kernels.check(kernels.lib().sdk_channel_stats_sm90(
                    kernels.dtype_code(x), x.data_ptr(), out.data_ptr(), b, rows, c, cb, cluster,
                    kernels.stream(x)), "sdk_channel_stats_sm90")
            res.append(f"{cb}/{cluster} ({b * -(-c // cb) * cluster} CTAs) "
                       f"{1e3 * device_ms(run):.2f}")
    log(f"K3 {rows}x{c} B={b} by channel block/cluster, device us: " + "; ".join(res))


def profile_k4(b, rows, c, kind, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    x, w, cb = rnd(b, rows, c), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    s = 1.0 + 0.1 * torch.randn(b, c, generator=gen, device=dev)
    o = 0.1 * torch.randn(b, c, generator=gen, device=dev)
    res = rnd(b, rows, c) if kind == "proj_out" else None
    label = f"K4 {kind} {rows}x{c} B={b}"

    def conv(route, prologue=True):
        pro = (s, o) if prologue and kind == "proj_in" else (None, None)
        return lambda: fc._conv1x1(x, w, cb, *pro, res, False, False, route)

    for name, ms in kernel_ms(conv("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    plan = fc.conv1x1_sm90_plan(b, rows, c, c, kind == "proj_in")
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or c % bn == 0:
            p = fc.conv1x1_sm90_plan(b, rows, c, c, kind == "proj_in", bn=bn)
            t = f"{bn} channels {device_ms(conv(p)):.4f} ms"
            if kind == "proj_in":
                p0 = fc.conv1x1_sm90_plan(b, rows, c, c, False, bn=bn)
                t += f" with the prologue, {device_ms(conv(p0, prologue=False)):.4f} without"
            widths.append(t)
    nbytes = 2 * (2 if res is None else 3) * b * rows * c
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the WMMA kernel "
        f"{device_ms(conv('wmma')):.4f} ms; cuBLAS x·W "
        f"{device_ms(lambda: torch.matmul(x, w)):.4f} ms; bound (bytes) "
        f"{1e3 * nbytes / 3.35e12:.4f} ms")
    rings = []
    for st in range(2, fc.SM90_CONV_MAX_STAGES + 1):
        p = fc.conv1x1_sm90_plan(b, rows, c, c, kind == "proj_in", bn=plan.bn, stages=st)
        if p is not None:
            rings.append(f"{st} stages {device_ms(conv(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


def events_ms(fn, iters: int = ITERS) -> float:
    """Time of one eager fn() call between CUDA events (host gaps count)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_k10(b, s, c, n_head, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    sk, d, m = 77, c // n_head, b * s
    x, ctx = rnd(b, s, c), rnd(b, sk, 768)
    g, beta = rnd(c, scale=0.1) + 1.0, rnd(c, scale=0.1)
    wq, wo, bo = rnd(c, c, scale=c ** -0.5), rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    kt, vt = (torch.matmul(ctx, rnd(768, c, scale=768 ** -0.5)).transpose(1, 2)
              for _ in range(2))
    valid = torch.arange(sk, device=dev)[None] < torch.tensor([2, 9] * (b // 2),
                                                              device=dev)[:, None]
    label = f"K10 S={s} C={c} B={b} Sk={sk}"
    args = (x, kt, vt, g, beta, wq, wo, bo)
    for name, ms in kernel_ms(lambda: fx.fused_cross_attention_kv(
            *args, key_valid=valid, n_head=n_head)).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    plan = fx.route_plan(dt, b, s, c, n_head, sk, True)
    bias = torch.where(valid, 0.0, fa.NEG_INF).float()
    stats = torch.empty(m, 2, device=dev)
    kernels.check(kernels.lib().sdk_row_stats(x.data_ptr(), c, stats.data_ptr(), m, c, 1e-5,
                                              kernels.stream(x)), "sdk_row_stats")
    q, attn, out = rnd(b, s, c), rnd(b, s, c), torch.empty_like(x)
    xm, qm, am = x.view(m, c), q.view(m, c), attn.view(m, c)
    k, v = kt.transpose(1, 2), vt.transpose(1, 2)
    q4, k4, v4 = (t.reshape(b, -1, n_head, d).transpose(1, 2) for t in (q, k, v))
    mask = valid[:, None, None, :]

    def core(p):
        def run():
            kernels.check(kernels.lib().sdk_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr(), s * c, d, c,
                k.stride(0), d, k.stride(1), v.stride(0), d, v.stride(1), s * c, d, c,
                bias.data_ptr(), sk, None, b * n_head, n_head, s, sk, d, float(d) ** -0.5, *p,
                kernels.stream(x)), "sdk_attention_sm90")
        return run

    def library():  # the sublayer by library calls
        h = F.layer_norm(x, (c,), g, beta)
        o = F.scaled_dot_product_attention(torch.matmul(h, wq).view(b, s, n_head, d)
                                           .transpose(1, 2), k4, v4, attn_mask=mask)
        return x + torch.matmul(o.transpose(1, 2).reshape(b, s, c), wo) + bo

    t = {name: device_ms(fn) for name, fn in (
        ("q", lambda: _gemm(xm, wq, qm, m, c, c, plan.q, bias=None, gamma=g, beta=beta,
                            stats=stats)),
        ("q cuBLAS", lambda: torch.matmul(xm, wq)),
        ("core", core(plan.core)),
        ("core SDPA", lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)),
        ("wo", lambda: _gemm(am, wo, out.view(m, c), m, c, c, plan.out, bias=bo, res=xm)),
        ("wo cuBLAS", lambda: torch.matmul(am, wo)),
        ("sm90", lambda: fx.fused_cross_attention_kv(*args, key_valid=valid, n_head=n_head)),
        ("wmma", lambda: fx._cross_attention_kv(*args, valid, n_head, 1e-5, "wmma")),
        ("library", library))}
    ev = events_ms(lambda: fx.fused_cross_attention_kv(*args, key_valid=valid, n_head=n_head))
    log(f"{label}: Q product (LayerNorm prologue) {t['q']:.4f} ms, cuBLAS x·Wq "
        f"{t['q cuBLAS']:.4f}; core (key bias) {t['core']:.4f} ms, SDPA {t['core SDPA']:.4f}; "
        f"Wo product (bias, residual) {t['wo']:.4f} ms, cuBLAS o·Wo {t['wo cuBLAS']:.4f}; the "
        f"route {t['sm90']:.4f} ms (events {ev:.4f}), the WMMA route {t['wmma']:.4f}, the "
        f"sublayer by library calls {t['library']:.4f}; bound "
        f"{1e3 * 2 * b * s * c * (2 * c + 2 * sk) / 989e12:.4f} ms")
    rings = []
    for st in (3, 4, 5):
        p = plan.core._replace(stages=st, smem=plan.core.smem + (st - plan.core.stages)
                               * (2 * plan.core.tile * plan.core.dpad * 2 + plan.core.tile * 4))
        if p.smem <= kernels.SMEM_LIMIT:
            rings.append(f"{st} stages {device_ms(core(p)):.4f}")
    log(f"{label}: core by ring depth: " + ", ".join(rings) +
        f" (the plan takes {plan.core.stages})")


def profile_k7(b, hw, c, co, log, gen):
    dev, dt = torch.device("cuda"), torch.bfloat16
    x = torch.randn(b, hw, hw, c, generator=gen, device=dev).to(dt)
    w = (torch.randn(3, 3, c, co, generator=gen, device=dev) * (9 * c) ** -0.5).to(dt)
    cb = (0.1 * torch.randn(co, generator=gen, device=dev)).to(dt)
    label = f"K7 {hw}x{hw}x{c} -> {2 * hw}x{2 * hw}x{co} B={b}"
    phases = fc.phase_weight_stack(w, dt)  # folded once, as the pipeline does

    def up(route):
        return lambda: fc._upsample2x(x, w, cb, True, route, phases)

    for name, ms in kernel_ms(up("auto")).items():
        log(f"{label}: {name[:72]}: {ms:.4f} ms a call")
    plan = fc.upsample_sm90_plan(b, hw, hw, c, co)
    widths = []
    for bn in (128, *fc.SM90_CONV_WIDE):
        if bn == 128 or co % bn == 0:
            p = fc.upsample_sm90_plan(b, hw, hw, c, co, bn=bn)
            widths.append(f"{bn} channels {device_ms(up(p)):.4f} ms")
    xu = cv.nearest_upsample_2x(x).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    cudnn = device_ms(lambda: F.conv2d(xu, w_oihw, padding=1))
    gate = cv.FUSED_UP_MIN_ROWS

    def closed():
        cv.FUSED_UP_MIN_ROWS = 1 << 30
        try:
            return cv.upsample2x_conv({"w": w, "b": cb}, x)
        finally:
            cv.FUSED_UP_MIN_ROWS = gate

    # the phase weights' folding, were it done a call: host time (enqueue
    # only) and device time
    n = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fc.phase_weight_stack(w, dt)
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    fold = device_ms(lambda: fc.phase_weight_stack(w, dt))
    ev = events_ms(up("auto"))
    flops = 2 * 16 * b * hw * hw * c * co
    log(f"{label}: " + "; ".join(widths) + f" (the plan takes {plan.bn}); the WMMA kernel "
        f"{device_ms(up('wmma')):.4f} ms; cuDNN's conv over the upsampled map {cudnn:.4f} ms; "
        f"the gate-closed path {device_ms(closed):.4f} ms; bound {1e3 * flops / 989e12:.4f} ms")
    log(f"{label}: the phase weights' folding {host:.4f} ms of host a call, {fold:.4f} ms of "
        f"device; a launch {ev:.4f} ms by events ({100 * (host + fold) / ev:.1f} %)")
    rings = []
    for st in range(2, fc.SM90_CONV_MAX_STAGES + 1):
        p = fc.upsample_sm90_plan(b, hw, hw, c, co, bn=plan.bn, stages=st)
        if p is not None:
            rings.append(f"{st} stages {device_ms(up(p)):.4f}")
    log(f"{label}: by ring depth: " + ", ".join(rings) + f" (the plan takes {plan.stages})")


PROFILES = ("K5", "K9", "K6", "K2", "K1", "K4", "K10", "K7", "K3", "K5f", "K2f", "K6f",
            "K7f", "K4f", "K9f", "K1f", "K10f")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(PROFILES),
                    help="the kernels to break down, comma-separated (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    picked = set(args.kernels.split(","))
    if picked - set(PROFILES):
        raise SystemExit(f"--kernels takes some of {', '.join(PROFILES)}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the kernels on a GPU only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lines = []

    def log(line):
        print(line, flush=True)
        lines.append(line)

    log(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "K5" in picked:
        for b, s, c in ((2, 1024, 640), (2, 256, 1280)):
            profile_k5(b, s, c, log, gen)
    if "K9" in picked:
        profile_k9(32, 4096, 40, 8, log, gen)
    if "K6" in picked:
        for b, hw, c1, c2, co in ((2, 128, 640, 320, 320), (1, 512, 128, 0, 128),
                                  (1, 64, 512, 0, 512)):
            profile_k6(b, hw, c1, c2, co, log, gen)
    if "K2" in picked:
        for b, s, c in ((2, 4096, 320), (2, 16384, 320)):
            profile_k2(b, s, c, 8, log, gen)
    if "K1" in picked:
        for bh, n_head, s, d, bias in ((32, 8, 4096, 40, False), (16, 8, 4096, 80, True),
                                       (1, 1, 16384, 512, False)):
            profile_k1(bh, n_head, s, d, bias, log, gen)
    if "K4" in picked:
        for b, rows, c in ((2, 4096, 320), (2, 16384, 320), (2, 4096, 640), (8, 4096, 320)):
            for kind in ("proj_in", "proj_out"):
                profile_k4(b, rows, c, kind, log, gen)
    if "K10" in picked:
        for b, s, c in ((2, 4096, 320), (4, 1024, 640), (8, 256, 1280)):
            profile_k10(b, s, c, 8, log, gen)
    if "K7" in picked:
        for b, hw, c, co in ((1, 128, 512, 512), (1, 256, 256, 256), (1, 512, 256, 256)):
            profile_k7(b, hw, c, co, log, gen)
    if "K5f" in picked:
        for b, s, c in ((2, 1024, 640), (2, 256, 1280)):
            profile_k5f(b, s, c, log, gen)
    if "K2f" in picked:
        for b, s, c, n_head in ((2, 4096, 320, 8), (2, 1024, 640, 8), (2, 256, 1280, 8),
                                (2, 9216, 320, 5)):
            profile_k2f(b, s, c, n_head, log, gen)
    if "K6f" in picked:
        for b, hw, c1, c2, co in ((2, 128, 640, 320, 320), (2, 128, 320, 0, 320),
                                  (1, 512, 128, 0, 128), (1, 256, 256, 0, 256),
                                  (1, 64, 512, 0, 512)):
            profile_k6f(b, hw, c1, c2, co, log, gen)
    if "K7f" in picked:
        for b, hw, c, co in ((1, 128, 512, 512), (1, 256, 256, 256), (1, 256, 512, 512),
                             (1, 512, 256, 256)):
            profile_k7f(b, hw, c, co, log, gen)
    if "K4f" in picked:
        for b, rows, c, co in ((2, 4096, 320, 320), (2, 16384, 320, 320), (2, 4096, 640, 640)):
            for kind in ("proj_in", "proj_out"):
                profile_k4f(b, rows, c, co, kind, log, gen)
    if "K9f" in picked:
        for bh, s, d, n_head in ((32, 4096, 40, 8), (10, 9216, 64, 5)):
            profile_k9f(bh, s, d, n_head, log, gen)
    if "K1f" in picked:
        for bh, n_head, s, d, bias in ((32, 8, 4096, 40, False), (10, 5, 9216, 64, False),
                                       (16, 8, 4096, 80, True), (1, 1, 16384, 512, False),
                                       (1, 1, 9216, 512, False)):
            profile_k1f(bh, n_head, s, d, bias, log, gen)
    if "K10f" in picked:
        for b, s, c in ((2, 4096, 320), (2, 1024, 640), (2, 256, 1280)):
            profile_k10f(b, s, c, 8, log, gen)
    if "K3" in picked:
        for b, rows, c in K3_SHAPES:
            profile_k3(b, rows, c, log, gen)
        for b, rows, c in ((2, 4096, 320), (2, 16384, 640), (1, 262144, 128), (2, 16, 320)):
            sweep_k3(b, rows, c, log, gen)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
