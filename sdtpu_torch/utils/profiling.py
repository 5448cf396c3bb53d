"""Wall-clock phases and profiler traces (port of sdtpu/utils/profiling.py).

- `phase(name, device=None)`: a wall-clock span added to a registry of
  named phases (load_model, encode_prompt, denoise, decode, save_png ...),
  reported as one JSON object. PyTorch returns before the card has run
  what it was given, so a span that times device work names its device:
  on a CUDA device the span ends with torch.cuda.synchronize(device).
- `trace(log_dir)`: torch.profiler around a block (CPU, and the card when
  there is one), written into log_dir as a Chrome trace (`trace.json`,
  for chrome://tracing or Perfetto).
- `enabled()`: SDTPU_PROFILE set to another value than "0", "" or
  "false"; the CLI then prints the registry's report.

The registry's keys and JSON shape are sdtpu's. Under CUDA graphs
(graphs.py) a span times the replay as it would the eager calls (the
replay is device work, waited for at the span's end), and the first call
with a key includes its capture; a trace shows a replay's kernels one by
one, as the eager calls'.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional


class PhaseRegistry:
    def __init__(self):
        self.spans: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.spans.clear()
        self.counts.clear()

    def summary(self) -> dict:
        total = sum(self.spans.values())
        return {
            "phases": {k: round(v, 4) for k, v in self.spans.items()},
            "counts": dict(self.counts),
            "total_s": round(total, 4),
        }

    def report(self, extra: Optional[dict] = None) -> str:
        s = self.summary()
        if extra:
            s.update(extra)
        return json.dumps(s)


REGISTRY = PhaseRegistry()


def enabled() -> bool:
    return os.environ.get("SDTPU_PROFILE", "0") not in ("0", "", "false")


def _sync(device) -> None:
    if device is not None:
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, device=None) -> Iterator[None]:
    """Add the block's wall seconds to REGISTRY under `name`; with a CUDA
    `device`, the block's device work is waited for before the span ends."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        REGISTRY.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler over the block, CPU and (when present) CUDA
    activities; the Chrome trace is written to log_dir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
