"""Karras-family ODE samplers: Euler, Euler-ancestral, Heun (port of
sdtpu/diffusion/karras.py).

The standard k-diffusion/EDM discretisations (Karras et al. 2022) of the
probability-flow ODE in the variance-exploding (sigma) parameterisation:

    sigma_t = sqrt((1 - abar_t) / abar_t)
    x_VE    = x_VP * sqrt(1 + sigma_t^2)         (x_VE = x0 at sigma = 0)
    dx/dsigma = eps(x_VE / sqrt(1 + sigma^2), t)

Euler-ancestral splits each step into a deterministic part (to sigma_down)
and fresh noise (sigma_up): sigma_up^2 = sigma_next^2 (sigma^2 -
sigma_next^2) / sigma^2, sigma_down^2 = sigma_next^2 - sigma_up^2.

The per-step tables are computed in numpy float32 (sdtpu computes them
with jnp on the host's f32 values); the step functions are torch on f32
tensors, the step constants 0-d f32 tensors, so that every product is
taken in f32 as sdtpu's are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.diffusion.ddim import ddim_schedule


class KarrasArrays(NamedTuple):
    """Per-step tables, length n_steps, in sampling order (t descending).
    t_next / sigma_next describe each step's target (sigma_next[-1] == 0:
    the last step lands on x0)."""

    timesteps: np.ndarray   # i32 (f32 on the Karras ladder)
    t_next: np.ndarray
    sigma: np.ndarray       # f32
    sigma_next: np.ndarray  # f32


def karras_arrays(alphas_cumprod, n_train_steps: int, n_steps: int) -> KarrasArrays:
    """Sigma ladder on the DDIM leading-uniform timesteps."""
    timesteps, _ = ddim_schedule(n_train_steps, n_steps)
    ts = np.asarray(timesteps, np.int32)
    abar = np.asarray(alphas_cumprod, np.float32)[ts]
    sigma = np.sqrt((np.float32(1.0) - abar) / abar)
    sigma_next = np.concatenate([sigma[1:], np.zeros((1,), np.float32)])
    t_next = np.concatenate([ts[1:], np.zeros((1,), np.int32)])
    return KarrasArrays(ts, t_next, sigma, sigma_next)


def karras_sigma_arrays(alphas_cumprod, n_steps: int, rho: float = 7.0) -> KarrasArrays:
    """Karras et al. (2022) eq. 5 spacing: sigmas interpolate between the
    table's sigma_max (t = T-1) and sigma_min (t = 0) in sigma^(1/rho)
    space. Each ladder sigma maps to a fractional timestep by linear
    interpolation of the log-sigma table (k-diffusion's sigma_to_t), so
    timesteps and t_next are f32."""
    abar = np.asarray(alphas_cumprod, np.float32)
    table = np.sqrt((np.float32(1.0) - abar) / abar)  # ascending in t
    sigma_min, sigma_max = table[0], table[-1]
    ramp = np.linspace(0.0, 1.0, n_steps, dtype=np.float32)
    inv_rho = np.float32(1.0 / rho)
    min_inv = pow32(sigma_min, inv_rho)
    max_inv = pow32(sigma_max, inv_rho)
    sigma = pow32(max_inv + ramp * (min_inv - max_inv), np.float32(rho))
    sigma_next = np.concatenate([sigma[1:], np.zeros((1,), np.float32)])

    log_table = log32(table)
    t_grid = np.arange(table.shape[0], dtype=np.float32)

    def to_t(s):
        # the ends clamp: sigma 0 (the final boundary, never fed to the
        # UNet) maps to t = 0
        return interp32(log32(np.maximum(s, np.float32(1e-20))), log_table, t_grid)

    return KarrasArrays(to_t(sigma), to_t(sigma_next), sigma, sigma_next)


def log32(x):
    """f32 log, correctly rounded (through f64). XLA's f32 log and pow, which
    sdtpu's tables go through, are not correctly rounded: the tables agree
    with sdtpu's to a few f32 ulps, not bit for bit."""
    return np.log(np.asarray(x, np.float64)).astype(np.float32)


def pow32(x, y):
    """f32 power, correctly rounded (through f64); see log32."""
    return (np.asarray(x, np.float64) ** np.float64(y)).astype(np.float32)


def interp32(x, xp, fp):
    """jnp.interp's formula in f32 (numpy's interp works in f64): the slope
    between the bracketing points, the ends clamped."""
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * df
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f).astype(np.float32)


def model_input(x, sigma):
    """VE state -> the VP latent the UNet was trained on."""
    return x / torch.sqrt(sigma * sigma + 1.0)


def vp_alpha(sigma):
    """abar_t implied by sigma (numpy or torch)."""
    return 1.0 / (sigma * sigma + 1.0)


def euler_step(x, eps, sigma, sigma_next):
    """First-order step: in the VE parameterisation dx/dsigma == eps."""
    return x + eps * (sigma_next - sigma)


def ancestral_sigmas(sigma, sigma_next):
    """k-diffusion's variance split (see the module docstring)."""
    up2 = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / torch.clamp(sigma ** 2, min=1e-20)
    up = torch.sqrt(torch.clamp(up2, min=0.0))
    down = torch.sqrt(torch.clamp(sigma_next ** 2 - up2, min=0.0))
    return down, up


def euler_ancestral_step(x, eps, noise, sigma, sigma_next):
    down, up = ancestral_sigmas(sigma, sigma_next)
    return x + eps * (down - sigma) + noise * up


def heun_step(x, eps1, eps2, sigma, sigma_next):
    """Second-order (trapezoid) correction; Euler when sigma_next == 0
    (eps2 is then evaluated and ignored, as in sdtpu's branch-free scan)."""
    d = torch.where(sigma_next > 0.0, 0.5 * (eps1 + eps2), eps1)
    return x + d * (sigma_next - sigma)
