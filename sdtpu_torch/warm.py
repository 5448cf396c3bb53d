"""Cold-start overlap (port of sdtpu/warm.py): the kernel library and the
native runtime built on a background thread while the weights load, then
the CUDA graphs of the first image captured for the shapes the caller
names.

sdtpu's first image waits for its jit compiles, which need only shapes, so
sdtpu/warm.py runs them on a thread while the weights load
(sdtpu/cli.py:198-223). The port's counterparts are the nvcc build of the
kernel library (kernels.build, every source at once) and the g++ build of
the native runtime (runtime.build), which need only sources; and the
captures of the sampler, the decode and CLIP (graphs.py), which need the
weights, so join() makes them after the load:

    warm = WarmStart(device, batch=1, n_steps=20, sampler="ddim").start()
    sd = load_model(...)                 # meanwhile: nvcc, g++
    warm.join(sd)                        # waits, re-raises, captures

Unlike sdtpu's, which is best-effort, a failure is not swallowed: join()
re-raises the kernel build's error (the first launch would fail the same
way) and a capture's. The runtime is optional by design (its callers take
their Python paths without it), so join() records whether it loaded.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch


def capture(sd, *, batch: int = 1, n_steps: int = 20, sampler: str = "ddim",
            karras_sigmas: bool = False, guidance_scale: float = 7.5,
            sample: bool = True) -> None:
    """Capture the graphs that sd.generate(..., n_images=batch, n_steps,
    sampler, karras_sigmas) with a scalar guidance scale replays: CLIP's and
    the sampler's (with sample) and the decode's, from zero inputs of
    generate's shapes, drawing no random number. sd: a pipeline with its
    graphs on and pad_context (the two-pass mode's context lengths are the
    prompt's, known only with it)."""
    if not sd.graphs:
        raise ValueError("capture needs a pipeline with its graphs on")
    if not sd.pad_context:
        raise ValueError("capture needs pad_context: the two-pass mode's shapes depend on "
                         "the prompt")
    from sdtpu_torch.parallel import tp as tpc

    cfg, dev, dt = sd.config, sd.device, sd.compute_dtype
    n_ctx, hw = cfg.clip.n_ctx, cfg.latent_size
    cache = sd.graph_cache
    with tpc.use(sd.tp):
        if sample:
            tokens = torch.zeros((1, n_ctx), dtype=torch.long, device=dev)
            cache.ensure(sd._clip_program(tokens))
            ctx = torch.zeros((batch, n_ctx, cfg.unet.context_dim), dtype=dt, device=dev)
            valid = torch.ones((batch, n_ctx), dtype=torch.bool, device=dev)
            cache.ensure(sd._sampler_program(
                ctx, ctx[:1], guidance_scale, n_steps, None, None, valid, valid[:1], sampler,
                0, karras_sigmas, None, None, lambda shape: torch.zeros(shape)))
        cache.ensure(sd._decode_program(
            torch.zeros((batch, hw, hw, cfg.unet.in_channels), dtype=torch.float32,
                        device=dev)))


class WarmStart:
    """Builds the kernel library (on a CUDA device) and the native runtime
    on a background thread; join(sd) waits for them, re-raises a build
    failure, then captures sd's graphs for the shapes given here (capture()).
    timeline: (label, seconds from start()) marks."""

    def __init__(self, device, *, batch: int = 1, n_steps: int = 20, sampler: str = "ddim",
                 karras_sigmas: bool = False, guidance_scale: float = 7.5,
                 sample: bool = True):
        self.device = torch.device(device)
        self.shapes = dict(batch=batch, n_steps=n_steps, sampler=sampler,
                           karras_sigmas=karras_sigmas, guidance_scale=guidance_scale,
                           sample=sample)
        self.runtime_loaded: Optional[bool] = None
        self.error: Optional[BaseException] = None
        self.timeline: list = []
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    def _mark(self, label: str) -> None:
        self.timeline.append((label, round(time.perf_counter() - self._t0, 3)))

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                from sdtpu_torch import kernels

                kernels.lib()
                self._mark("kernels_built")
            from sdtpu_torch import runtime

            self.runtime_loaded = runtime.available()
            self._mark("runtime_built")
        except BaseException as e:  # noqa: BLE001 -- re-raised by join()
            self.error = e
            self._mark(f"error:{type(e).__name__}")

    def start(self) -> "WarmStart":
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True, name="sdtpu-warm")
        self._thread.start()
        return self

    def join(self, sd=None) -> None:
        """Wait for the builds and re-raise their failure; then, for a
        pipeline with its graphs on, capture its graphs (capture())."""
        if self._thread is not None:
            self._thread.join()
        self._mark("joined")
        if self.error is not None:
            raise self.error
        if sd is not None and sd.graphs:
            capture(sd, **self.shapes)
            self._mark("captured")
