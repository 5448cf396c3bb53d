"""DPM-Solver++(2M) multistep sampler (port of sdtpu/diffusion/dpm_solver.py).

Deterministic second-order multistep solver in the data-prediction
parameterisation:

    alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t), lambda_t = log(alpha_t / sigma_t)
    x0  = (x - sigma_t eps) / alpha_t,  h_i = lambda_{i+1} - lambda_i
    D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1},  r_i = h_{i-1} / h_i
    x_{i+1} = (sigma_{i+1} / sigma_i) x - alpha_{i+1} (exp(-h_i) - 1) D_i

The first step, and a landing on sigma = 0, are first order (D = x0). The
tables are numpy float32 (as in karras.py, within a few ulps of sdtpu's);
the step is torch on f32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.diffusion.ddim import ddim_schedule
from sdtpu_torch.diffusion.karras import karras_sigma_arrays, log32


class DpmArrays(NamedTuple):
    alpha_t: np.ndarray
    sigma_t: np.ndarray
    lam_t: np.ndarray
    alpha_n: np.ndarray  # each step's target (less noisy) boundary
    sigma_n: np.ndarray
    lam_n: np.ndarray
    timesteps: np.ndarray


def _split(a):
    alpha = np.sqrt(a)
    sigma = np.sqrt(np.float32(1.0) - a)
    # lambda is infinite at sigma = 0: clamp, as sdtpu does
    lam = log32(alpha / np.maximum(sigma, np.float32(1e-10)))
    return alpha, sigma, lam


def dpmpp_arrays(alphas_cumprod, n_train_steps: int, n_steps: int) -> DpmArrays:
    """Step constants on the DDIM timestep grid; the final target is
    alphas_cumprod[0], the cleanest tabulated state."""
    timesteps, step_size = ddim_schedule(n_train_steps, n_steps)
    ts = np.asarray(timesteps, np.int32)
    ac = np.asarray(alphas_cumprod, np.float32)
    a_t = ac[ts]
    a_n = ac[np.maximum(ts - step_size, 0)]
    return DpmArrays(*_split(a_t), *_split(a_n), ts)


def dpmpp_karras_arrays(alphas_cumprod, n_steps: int, rho: float = 7.0) -> DpmArrays:
    """The same constants on the Karras sigma ladder: the VE sigma implies
    abar = 1/(1 + sigma^2); the final boundary sigma = 0 gives abar = 1.
    Timesteps are fractional f32."""
    arrs = karras_sigma_arrays(alphas_cumprod, n_steps, rho)

    def abar(sigma_ve):
        return np.float32(1.0) / (sigma_ve * sigma_ve + np.float32(1.0))

    return DpmArrays(*_split(abar(arrs.sigma)), *_split(abar(arrs.sigma_next)),
                     arrs.timesteps)


class DpmState(NamedTuple):
    x: torch.Tensor
    x0_prev: torch.Tensor
    h_prev: torch.Tensor  # 0-d; 0.0 marks "no previous step"


def dpmpp_init(latent) -> DpmState:
    return DpmState(latent, torch.zeros_like(latent),
                    torch.zeros((), dtype=torch.float32, device=latent.device))


def dpmpp_2m_step(state: DpmState, eps, step) -> DpmState:
    """One DPM-Solver++(2M) update. step: (alpha_t, sigma_t, lam_t,
    alpha_n, sigma_n, lam_n), 0-d f32 tensors of one step."""
    alpha_t, sigma_t, lam_t, alpha_n, sigma_n, lam_n = step
    x = state.x
    x0 = (x - sigma_t * eps) / alpha_t
    h = lam_n - lam_t
    r = state.h_prev / h
    # first order on step 0 (no history) and on a sigma_n == 0 landing
    use_second = (state.h_prev != 0.0) & (sigma_n > 0.0)
    coef = 1.0 / (2.0 * torch.where(use_second, r, torch.ones_like(r)))
    d = torch.where(use_second, (1.0 + coef) * x0 - coef * state.x0_prev, x0)
    x_next = (sigma_n / sigma_t) * x - alpha_n * (torch.exp(-h) - 1.0) * d
    return DpmState(x_next, x0, h)
