"""Kernel dispatch while a loss is differentiated: the port's counterpart of
sdtpu/ops/dispatch.py:force_xla(allow_differentiable=True).

Most of the port's kernels are forward-only: a wrapper writes its output
through ctypes, so the output has no grad_fn, and a backward would leave
every parameter upstream without a gradient (each such wrapper raises when
autograd would record it: kernels.refuse_autograd). Inside `training()`
every forward-only gate returns False, so the UNet and the VAE take their
unfused plain-PyTorch branches: models/unet.py's fused ResBlock, fused
self-attention and MLP (K2, K5) and fused projections (K3 + K4),
models/vae.py's fused ResnetBlock (K6), ops/conv.py's fused upsample (K7),
ops/groupnorm.py's fused GroupNorm+SiLU (K8), and ops/attention.py's
forward-only flash attention (K1). The one path left open is the
differentiable flash attention, K1 forward and K9 backward
(ops/flash_attention.py:flash_qkv_attention_diff). sdtpu's SDTPU_KERNELS
modes and its backend allowlist are TPU machinery and have no counterpart.

The state is a context variable, so it belongs to the thread (and asyncio
task) that entered it. A checkpointed block that autograd recomputes in its
backward, on autograd's own thread, enters it again itself
(models/unet.py:_checkpointed).
"""

from __future__ import annotations

import contextlib
import contextvars

_TRAINING = contextvars.ContextVar("sdtpu_torch_training", default=False)


@contextlib.contextmanager
def training():
    """Close every forward-only kernel gate inside the context."""
    token = _TRAINING.set(True)
    try:
        yield
    finally:
        _TRAINING.reset(token)


def in_training() -> bool:
    """True inside training(): the forward-only gates are closed."""
    return _TRAINING.get()
