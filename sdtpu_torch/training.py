"""Diffusion training (port of sdtpu/training.py): the epsilon / v
objective, AdamW with global-norm clipping under a warmup-cosine schedule,
the EMA of the weights, and the training step with gradient accumulation.

The loss runs the UNet inside dispatch.training(), so the forward-only
kernels stay out of the graph and the one differentiable kernel pair runs
(K1 forward, K9 backward: ops/flash_attention.py). jax.value_and_grad is
torch.autograd.grad over the leaves of the parameter tree. The optimizer is
written to optax's definitions, the counterpart of sdtpu's
optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule)); it
updates the parameters and its own state in place where sdtpu returns new
trees, which saves a copy of each (3.4 GB per f32 copy of SD v1's UNet).

Not ported yet (ROADMAP queue 1, item 14): adafactor, training.multi_steps
(the bf16 gradient accumulator), LoRA and textual inversion.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sdtpu_torch.config import StableDiffusionConfig
from sdtpu_torch.models.unet import unet_apply
from sdtpu_torch.ops import dispatch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def master_params(tree):
    """f32 master copies of a parameter tree's floating leaves, each a new
    tensor that requires grad (sdtpu's `jnp.asarray(p, jnp.float32)` of the
    trained tree): the weights train in f32 whatever the compute dtype."""
    def master(p):
        if torch.is_tensor(p) and p.is_floating_point():
            return p.detach().to(torch.float32, copy=True).requires_grad_(True)
        return p

    return tree_map(master, tree)


def q_sample(x0, noise, alphas_cumprod, t):
    """Forward diffusion: x_t = sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
    a_t = alphas_cumprod[t].reshape(-1, 1, 1, 1)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise


@functools.lru_cache(maxsize=8)
def _alphas_for(n_train_steps: int) -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n_train_steps, dtype=np.float64) ** 2
    a = np.cumprod(1.0 - betas).astype(np.float32)
    a.flags.writeable = False
    return a


def cfg_alphas(cfg: StableDiffusionConfig) -> np.ndarray:
    """The training schedule's alphas_cumprod (sdtpu/training.py:61-73): a
    float64 linspace of sqrt(beta), squared, then the f32 cast of the
    cumulative product. The cached array is read-only."""
    return _alphas_for(cfg.n_train_steps)


def diffusion_loss(unet_params, cfg: StableDiffusionConfig, latents, context, t, noise,
                   ctx_valid=None, compute_dtype=torch.float32, remat=False):
    """MSE between the UNet prediction and the target (epsilon, or v for
    v-prediction models), f32. latents: [B, h, w, 4] f32; t: [B] int;
    noise: latents' shape. x_t and the context are cast to compute_dtype;
    the UNet runs inside dispatch.training(). remat: see
    models/unet.py:_remat_policy."""
    alphas = torch.from_numpy(cfg_alphas(cfg).copy()).to(latents.device)
    x_t = q_sample(latents, noise, alphas, t)
    with dispatch.training():
        pred = unet_apply(unet_params, x_t.to(compute_dtype), t, context.to(compute_dtype),
                          cfg.unet, ctx_valid=ctx_valid, remat=remat)
    pred = pred.float()
    if cfg.prediction_type == "v":
        a_t = alphas[t].reshape(-1, 1, 1, 1)
        target = torch.sqrt(a_t) * noise - torch.sqrt(1.0 - a_t) * latents
    else:
        target = noise
    return torch.mean((pred - target) ** 2)


@dataclass
class AdamWState:
    """count: completed updates; mu, nu: the f32 moments, one per leaf of
    the parameter tree (tree_leaves order)."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay)) with schedule = optax.warmup_cosine_decay_schedule(0, lr,
    warmup_steps, max(total_steps, warmup_steps + 1)), as sdtpu's
    make_optimizer builds it:

    - clip: g · max / ||g|| where the global norm ||g|| >= max, else g
      (no epsilon, unlike torch.nn.utils.clip_grad_norm_);
    - Adam: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g², u =
      mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps), n counted from 1;
    - decoupled weight decay on every leaf (no mask): u + wd · p;
    - p -= schedule(n - 1) · u, the schedule counted from 0.

    update() works in place on the parameters and the state."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, warmup_steps: int, total_steps: int,
                 weight_decay: float, grad_clip: float):
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def schedule(self, count: int) -> float:
        """The learning rate of update `count` (from 0): a linear warmup
        from 0, then a cosine decay to 0 (optax's join of linear_schedule
        and cosine_decay_schedule at warmup_steps)."""
        w = self.warmup_steps
        if count < w:
            return self.lr * min(max(count, 0), w) / w
        decay = self.decay_steps - w
        c = min(count - w, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        return AdamWState(0, [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                          [torch.zeros_like(p, dtype=torch.float32) for p in leaves])

    @torch.no_grad()
    def update(self, params, grads, state: AdamWState) -> None:
        """One step on params (a tree) from grads (f32, tree_leaves order),
        which it clips in place."""
        leaves = tree_leaves(params)
        g = list(grads)
        norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
        if not norm < self.grad_clip:
            torch._foreach_div_(g, norm)
            torch._foreach_mul_(g, self.grad_clip)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        lr = self.schedule(state.count)
        state.count += 1
        n = np.float32(state.count)
        u = torch._foreach_div(state.mu, float(1 - np.float32(b1) ** n))
        den = torch._foreach_div(state.nu, float(1 - np.float32(b2) ** n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(u, leaves, alpha=self.weight_decay)
        torch._foreach_add_(leaves, u, alpha=-lr)


def make_optimizer(lr: float = 1e-4, warmup_steps: int = 1000, total_steps: int = 1_000_000,
                   weight_decay: float = 1e-2, grad_clip: float = 1.0,
                   kind: str = "adamw") -> AdamW:
    """sdtpu's diffusion-training recipe: global-norm clip + AdamW with a
    linear warmup into a cosine decay (sdtpu/training.py:76-103).
    kind="adafactor" is not ported yet."""
    if kind == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported yet (ROADMAP queue 1, item 14); use kind='adamw'")
    if kind != "adamw":
        raise ValueError(f"kind must be adamw|adafactor, got {kind!r}")
    return AdamW(lr, warmup_steps, total_steps, weight_decay, grad_clip)


@torch.no_grad()
def ema_update(ema_params, params, decay: float = 0.9999):
    """Exponential moving average of params (the weights SD ships):
    e · decay + p · (1 - decay), in place on ema_params, which it returns."""
    e = tree_leaves(ema_params)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [p.to(x.dtype) for p, x in zip(tree_leaves(params), e)],
                        alpha=1.0 - decay)
    return ema_params


def loss_and_grads(params, cfg: StableDiffusionConfig, latents, context, t, noise,
                   ctx_valid=None, compute_dtype=torch.float32, remat=False, accum: int = 1):
    """(loss, f32 gradients in tree_leaves order) of diffusion_loss. accum >
    1: the batch splits into `accum` equal micro-batches, run one after the
    other, whose losses and gradients are averaged in f32 (activation
    memory of one micro-batch, the gradient of the whole batch)."""
    leaves = tree_leaves(params)
    b = latents.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by accum {accum}")
    mb = b // accum
    loss_sum, g_sum = None, None
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        loss = diffusion_loss(params, cfg, latents[sl], context[sl], t[sl], noise[sl],
                              None if ctx_valid is None else ctx_valid[sl],
                              compute_dtype=compute_dtype, remat=remat)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p, dtype=torch.float32) if x is None else x.float()
             for p, x in zip(leaves, g)]
        if g_sum is None:
            loss_sum, g_sum = loss.detach(), g
        else:
            loss_sum = loss_sum + loss.detach()
            torch._foreach_add_(g_sum, g)
        del g
    if accum > 1:
        loss_sum = loss_sum / accum
        torch._foreach_mul_(g_sum, 1.0 / accum)
    return loss_sum, g_sum


def make_train_step(cfg: StableDiffusionConfig, optimizer: AdamW,
                    compute_dtype=torch.float32, remat: bool | str = False, accum: int = 1,
                    ema_decay: Optional[float] = None):
    """Returns train_step(params, opt_state, batch, generator=None, *,
    t=None, noise=None) -> (params, opt_state, loss), sdtpu's step_core.
    batch = (latents, context) or (latents, context, ctx_valid). params: a
    tree of f32 leaves that require grad (master_params), updated in place.
    t ([B] int) and noise (latents' shape) are drawn from `generator` (the
    default generator of the latents' device when None), t first, unless
    given: tests inject sdtpu's draws. loss is a 0-dim f32 tensor, left on
    the device.

    accum > 1: equal micro-batches, gradients averaged in f32, one update
    (loss_and_grads); the draws are made for the whole batch first, so the
    result equals accum=1's up to f32 summation order.

    ema_decay set: train_step(params, opt_state, ema_params, batch, ...) ->
    (params, opt_state, ema_params, loss), the EMA updated in place after
    the optimizer step."""

    def step_core(params, opt_state, batch, generator=None, *, t=None, noise=None):
        latents, context = batch[0], batch[1]
        ctx_valid = batch[2] if len(batch) > 2 else None
        gdev = latents.device if generator is None else generator.device
        if t is None:
            t = torch.randint(0, cfg.n_train_steps, (latents.shape[0],), generator=generator,
                              device=gdev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=gdev)
        t, noise = t.to(latents.device), noise.to(latents.device, torch.float32)
        loss, grads = loss_and_grads(params, cfg, latents, context, t, noise, ctx_valid,
                                     compute_dtype, remat, accum)
        optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    if ema_decay is None:
        return step_core

    def train_step_ema(params, opt_state, ema_params, batch, generator=None, *, t=None,
                       noise=None):
        params, opt_state, loss = step_core(params, opt_state, batch, generator, t=t,
                                            noise=noise)
        return params, opt_state, ema_update(ema_params, params, ema_decay), loss

    return train_step_ema
