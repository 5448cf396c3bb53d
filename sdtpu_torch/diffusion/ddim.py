"""DDIM sampler pieces (port of sdtpu/diffusion/ddim.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def ddim_schedule(n_train_steps: int, n_steps: int) -> Tuple[list, int]:
    """Descending timesteps: step = n_train // n; t = n_train-1, n_train-1-step, ..."""
    step_size = n_train_steps // n_steps
    return list(range(n_train_steps - 1, -1, -step_size)), step_size


def ddim_alphas(alphas_cumprod, timesteps, step_size: int):
    """(alpha_t, alpha_prev) per step; alpha_prev = alphas_cumprod[t - step]
    for t >= step, else 1.0 (the last step's prev_alpha = 1)."""
    ts = torch.as_tensor(timesteps, dtype=torch.long, device=alphas_cumprod.device)
    a_t = alphas_cumprod[ts]
    prev = ts - step_size
    a_prev = torch.where(prev >= 0, alphas_cumprod[prev.clamp(min=0)],
                         torch.ones_like(a_t))
    return a_t, a_prev


def ddim_step(latent, eps, alpha_t, alpha_prev, sigma: float = 0.0, noise=None):
    """One DDIM update (sigma = 0 on the sampling path):

    predx0 = (latent - eps*sqrt(1-a_t)) / sqrt(a_t)
    next   = predx0*sqrt(a_prev) + eps*sqrt(1 - a_prev - sigma^2) (+ sigma*noise)
    """
    predx0 = (latent - eps * torch.sqrt(1.0 - alpha_t)) / torch.sqrt(alpha_t)
    out = predx0 * torch.sqrt(alpha_prev) + eps * torch.sqrt(1.0 - alpha_prev - sigma * sigma)
    if sigma > 0.0 and noise is not None:
        out = out + noise * sigma
    return out
