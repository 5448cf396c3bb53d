"""Noise schedules (port of sdtpu/diffusion/schedule.py)."""

import math

import numpy as np
import torch


def offset_cosine_schedule_cumprod(n_steps: int):
    """The offset cosine schedule, f32: cos² of n_steps angles spaced evenly
    from acos(0.95) towards acos(0.02), at times 1..=n (sdtpu's, computed in
    numpy as sdtpu computes it)."""
    start_angle = math.acos(0.95)
    end_angle = math.acos(0.02)
    times = np.arange(1, n_steps + 1, dtype=np.float32)
    angles = times * ((end_angle - start_angle) / n_steps) + start_angle
    return torch.from_numpy((np.cos(angles) ** 2).astype(np.float32))


def scaled_linear_alphas_cumprod(n_steps: int = 1000, beta_start: float = 0.00085,
                                 beta_end: float = 0.012):
    """The LDM 'scaled linear' schedule: betas = linspace(sqrt(b0),
    sqrt(b1), N)^2, alphas_cumprod = cumprod(1 - betas), f32. Computed in
    numpy exactly as sdtpu computes it, so the two tables are identical."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_steps,
                        dtype=np.float32) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
