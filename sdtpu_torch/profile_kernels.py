"""Where the time of K5's and K9's Hopper kernels goes on one NVIDIA GPU.

    python -m sdtpu_torch.profile_kernels [--out FILE]

At the 512px main-path shapes, bf16, random inputs (seeded): K5 at S=1024
C=640 B=2 and S=256 C=1280 B=2 (csrc/gemm_sm90.cu), K9 at BH=32 S=4096
d=40 (csrc/flash_attention_bwd_sm90.cu). Device times are CUDA-graph
replays (`device_ms`, also what chip_smoke.py times K5 and K9 by) or
torch.profiler kernel sums:

1. each launch of the bf16 routes (torch.profiler): K5's row statistics
   and its two GEMM launches, K9's Δ pre-pass, dK/dV and dQ kernels;
2. K5's first product with and without its LayerNorm prologue (the
   prologue's cost), its second product on 64- and 128-column tiles, and
   cuBLAS's two matmuls of the same shapes;
3. the depth of K5's ring: 2, 3 or 4 stages (the plan's choice is 4).

The report starts with the card's name and power limit, and goes to
stdout and, with --out, to FILE as well.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import torch

from sdtpu_torch import kernels
from sdtpu_torch.ops import flash_attention as fa
from sdtpu_torch.ops import fused_mlp as fm

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
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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
        a.data_ptr(), k, w.data_ptr(), w.shape[1], bias.data_ptr(), kernels.ptr(gamma),
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
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
    for b, s, c in ((2, 1024, 640), (2, 256, 1280)):
        profile_k5(b, s, c, log, gen)
    profile_k9(32, 4096, 40, 8, log, gen)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
