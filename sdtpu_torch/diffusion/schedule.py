"""Noise schedule (port of sdtpu/diffusion/schedule.py)."""

import numpy as np
import torch


def scaled_linear_alphas_cumprod(n_steps: int = 1000, beta_start: float = 0.00085,
                                 beta_end: float = 0.012):
    """The LDM 'scaled linear' schedule: betas = linspace(sqrt(b0),
    sqrt(b1), N)^2, alphas_cumprod = cumprod(1 - betas), f32. Computed in
    numpy exactly as sdtpu computes it, so the two tables are identical."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_steps,
                        dtype=np.float32) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
