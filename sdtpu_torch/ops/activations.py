"""Elementwise activations (port of sdtpu/ops/activations.py)."""

import torch
import torch.nn.functional as F


def silu(x):
    """x * sigmoid(x) (sdtpu/ops/activations.py:silu)."""
    return x * torch.sigmoid(x)


def quick_gelu(x):
    """x * sigmoid(1.702 x): CLIP v1's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x):
    """Exact erf-based GELU."""
    return F.gelu(x, approximate="none")


def geglu(x, gate):
    """GEGLU gate: x * gelu(gate)."""
    return x * gelu(gate)
