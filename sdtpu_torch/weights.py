"""Parameters of the port: conversion from sdtpu's numpy tree and random
initialisation (port of sdtpu/models/initializers.py).

The tree is sdtpu's: nested dicts (and, for the CLIP blocks, a list) with
the reference dump-tree names, linear weights [in, out], conv weights HWIO.
Leaves here are torch tensors on one device: the card unless the caller
passes another (`device="cpu"`); with no card the default raises, as torch
does.
"""

from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.config import StableDiffusionConfig


def from_numpy_tree(tree, device="cuda", dtype=torch.float32):
    """sdtpu's parameter tree of numpy arrays -> the same tree of tensors.
    Floating leaves become `dtype`; integer leaves keep their type;
    Python scalars (e.g. "n_steps") pass through."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device, dtype) for v in tree]
    if isinstance(tree, (int, float)):
        return tree
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def to_numpy(leaf) -> np.ndarray:
    """A tensor (on any device; bf16 widened to f32, which numpy lacks) or
    an array-like -> a numpy array on the host."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


class Init:
    """Draws parameters from one torch.Generator, on the generator's
    device, then moves them to `device` in `dtype`."""

    def __init__(self, generator: torch.Generator, device, dtype=torch.float32):
        self.g = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def _finish(self, t):
        return t.to(self.device, self.dtype)

    def uniform(self, shape, bound: float):
        t = torch.rand(shape, generator=self.g, device=self.g.device)
        return self._finish(t * (2 * bound) - bound)

    def normal(self, shape, scale: float):
        t = torch.randn(shape, generator=self.g, device=self.g.device)
        return self._finish(t * scale)

    def linear(self, n_in: int, n_out: int, bias: bool = True):
        """Fan-in uniform U(-1/sqrt(n_in), 1/sqrt(n_in)), weight [in, out]."""
        bound = n_in ** -0.5
        p = {"w": self.uniform((n_in, n_out), bound)}
        if bias:
            p["b"] = self.uniform((n_out,), bound)
        return p

    def conv2d(self, n_in: int, n_out: int, k: int = 3, bias: bool = True):
        """Fan-in uniform over n_in*k*k, weight HWIO."""
        bound = (n_in * k * k) ** -0.5
        p = {"w": self.uniform((k, k, n_in, n_out), bound)}
        if bias:
            p["b"] = self.uniform((n_out,), bound)
        return p

    def norm(self, n: int):
        return {"g": torch.ones(n, device=self.device, dtype=self.dtype),
                "b": torch.zeros(n, device=self.device, dtype=self.dtype)}

    def embedding(self, n_vocab: int, n_dim: int):
        return {"w": self.normal((n_vocab, n_dim), 0.02)}


def init_params(cfg: StableDiffusionConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32):
    """Random weights for the whole pipeline, with sdtpu's shapes and
    scales (the draws differ from sdtpu's: another generator).
    Returns {clip, unet, autoencoder, alphas_cumprod, n_steps}."""
    from sdtpu_torch.diffusion.schedule import scaled_linear_alphas_cumprod
    from sdtpu_torch.models.clip import init_clip
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.models.vae import init_autoencoder

    init = Init(generator, device, dtype)
    return {
        "clip": init_clip(init, cfg.clip),
        "unet": init_unet(init, cfg.unet),
        "autoencoder": init_autoencoder(init, cfg.vae),
        "alphas_cumprod": scaled_linear_alphas_cumprod(
            cfg.n_train_steps).to(device),
        "n_steps": cfg.n_train_steps,
    }
