"""Sinusoidal timestep embedding (port of sdtpu/ops/timestep.py).

freqs = exp(-ln(max_period) * arange(half) / half); args = t * freqs;
embedding = concat(cos(args), sin(args)) — cos FIRST, as in the reference.
"""

import math

import torch


def timestep_embedding(timesteps, dim: int, max_period: int = 10000,
                       dtype=torch.float32, device=None):
    """timesteps: scalar or [B] int/float -> [B, dim] (or [1, dim])."""
    t = torch.as_tensor(timesteps, dtype=torch.float32, device=device).reshape(-1)
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(float(max_period)) / half))
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return emb.to(dtype)
