"""Text-to-image pipeline (port of sdtpu/pipeline.py, DDIM path).

Classifier-free guidance runs the uncond/cond pair as one batched UNet call
on contexts right-padded to n_ctx, the padded keys masked out of
cross-attention by ctx_valid (sdtpu's pad_context=True). sdtpu's two-call
parity mode on unpadded contexts (pad_context=False) is not ported. sdtpu's
jitted lax.scan over the steps is a Python loop here. The sampler is DDIM;
img2img, inpainting and the other samplers are not ported yet.
encode_image (the VAE encoder) serves the fine-tuning latent cache.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sdtpu_torch.config import SD_V1_4, StableDiffusionConfig
from sdtpu_torch.diffusion.ddim import ddim_alphas, ddim_schedule, ddim_step
from sdtpu_torch.models.clip import clip_apply
from sdtpu_torch.models.unet import fuse_qkv, unet_apply
from sdtpu_torch.models.vae import decode_latent, encode_image

# leaves that keep their own type under compute_dtype (sdtpu's _cast_param_tree)
_UNCAST = ("alphas_cumprod", "n_steps")


def _cast_param_tree(params, dtype):
    """Cast the floating weights to the compute dtype once, at
    construction, as sdtpu's _cast_param_tree does; alphas_cumprod stays f32."""
    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        if torch.is_tensor(node) and node.is_floating_point():
            return node.to(dtype)
        return node

    return {k: (v if k in _UNCAST else cast(v)) for k, v in params.items()}


class StableDiffusion:
    """Owns the parameter tree {clip, unet, autoencoder, alphas_cumprod,
    n_steps} (tensors on one device, see sdtpu_torch.weights) and runs the
    pipeline on that device.

    After generate(), `timings` holds the wall seconds of its phases
    (encode_prompt, denoise, decode), each ended by a device synchronise.
    """

    def __init__(self, params, config: StableDiffusionConfig = SD_V1_4,
                 compute_dtype=torch.float32):
        if config.prediction_type != "epsilon":
            raise NotImplementedError(
                f"{config.name}: only epsilon-prediction models are ported "
                f"(v-prediction, SD v2.1-768, is not)")
        if compute_dtype != torch.float32:
            params = _cast_param_tree(params, compute_dtype)
        self.params = {**params, "unet": fuse_qkv(params["unet"])}
        self.config = config
        self.compute_dtype = compute_dtype
        self.n_train_steps = int(params.get("n_steps", config.n_train_steps))
        self.device = params["alphas_cumprod"].device
        self.timings: dict = {}

    # ---------------------------------------------------------- context

    def context(self, tokenizer, text: str):
        """Prompt -> (context [1, n_ctx, n_state], valid [1, n_ctx] bool):
        SOT/EOT wrap, truncation keeping EOT last, and a right pad to n_ctx
        whose keys `valid` marks invalid."""
        ids = tokenizer.encode_prompt(text)
        n_ctx = self.config.clip.n_ctx
        if len(ids) > n_ctx:
            ids = ids[: n_ctx - 1] + [ids[-1]]
        n_valid = len(ids)
        ids = ids + [0] * (n_ctx - len(ids))
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        ctx = clip_apply(self.params["clip"], tokens, self.config.clip)
        valid = torch.arange(len(ids), device=self.device)[None, :] < n_valid
        return ctx.to(self.compute_dtype), valid

    # ---------------------------------------------------------- sampler

    def sample_latent(self, context, unconditional_context,
                      unconditional_guidance_scale: float, n_steps: int,
                      generator: Optional[torch.Generator] = None,
                      initial_latent=None, ctx_valid=None, uncond_valid=None):
        """DDIM with classifier-free guidance. context: [B, S, D]; the
        unconditional context [1, S', D] is broadcast to B. initial_latent:
        [B, h, w, 4] (NHWC); drawn N(0, 1) from `generator` when None.
        Returns the final latent [B, h, w, 4] f32."""
        cfg = self.config
        b = context.shape[0]
        if initial_latent is None:
            hw = cfg.latent_size
            gen_dev = generator.device if generator is not None else self.device
            initial_latent = torch.randn((b, hw, hw, cfg.unet.in_channels),
                                         generator=generator, device=gen_dev)
        lat = torch.as_tensor(initial_latent, dtype=torch.float32).to(self.device)

        timesteps, step_size = ddim_schedule(self.n_train_steps, n_steps)
        alphas = self.params["alphas_cumprod"].float()
        a_t, a_prev = ddim_alphas(alphas, timesteps, step_size)
        unet = self.params["unet"]
        dt = self.compute_dtype
        scale = torch.tensor(unconditional_guidance_scale, dtype=torch.float32,
                             device=self.device)
        uncond_b = unconditional_context.expand((b,) + unconditional_context.shape[1:])
        uvalid_b = (None if uncond_valid is None
                    else uncond_valid.expand((b,) + uncond_valid.shape[1:]))

        ctx2 = torch.cat([uncond_b, context], dim=0)
        valid2 = None if ctx_valid is None else torch.cat([uvalid_b, ctx_valid], dim=0)
        for i, t in enumerate(timesteps):
            eps2 = unet_apply(unet, torch.cat([lat, lat], dim=0).to(dt), t, ctx2,
                              cfg.unet, ctx_valid=valid2).float()
            e_un, e_c = eps2[:b], eps2[b:]
            lat = ddim_step(lat, e_un + (e_c - e_un) * scale, a_t[i], a_prev[i])
        return lat

    # ---------------------------------------------------------- decode

    def _decode_u8(self, latent):
        """decode(latent / latent_scale) -> (x+1)/2*255 -> round, clamp ->
        uint8, on the device."""
        z = (latent * (1.0 / self.config.latent_scale)).to(self.compute_dtype)
        img = decode_latent(self.params["autoencoder"], z, self.config.vae)
        img = (img.float() + 1.0) / 2.0 * 255.0
        return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)

    def latent_to_image(self, latent) -> np.ndarray:
        """Returns [B, H, W, 3] uint8 on the host."""
        return self._decode_u8(latent).cpu().numpy()

    def encode_image(self, image):
        """image: [B, H, W, 3] in [-1, 1] (numpy or a tensor) -> latent
        [B, H/8, W/8, 4] in the compute dtype, on the device; not scaled by
        latent_scale (sdtpu/pipeline.py:431-439)."""
        x = torch.as_tensor(image, dtype=self.compute_dtype, device=self.device)
        with torch.no_grad():
            return encode_image(self.params["autoencoder"], x, self.config.vae)

    # ---------------------------------------------------------- top level

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokenizer, prompt: str, guidance_scale: float = 7.5,
                 n_steps: int = 20, n_images: int = 1,
                 generator: Optional[torch.Generator] = None, initial_latent=None,
                 negative_prompt: str = "") -> np.ndarray:
        """Prompt string -> uint8 images [n_images, H, W, 3].
        negative_prompt replaces the empty unconditional prompt."""
        t0 = time.perf_counter()
        ctx, valid = self.context(tokenizer, prompt)
        unctx, unvalid = self.context(tokenizer, negative_prompt)
        if n_images > 1:
            ctx = ctx.repeat(n_images, 1, 1)
            valid = valid.repeat(n_images, 1)
        self._sync()
        t1 = time.perf_counter()
        latent = self.sample_latent(
            ctx, unctx, guidance_scale, n_steps, generator=generator,
            initial_latent=initial_latent, ctx_valid=valid, uncond_valid=unvalid)
        self._sync()
        t2 = time.perf_counter()
        images = self.latent_to_image(latent)
        t3 = time.perf_counter()
        self.timings = {"encode_prompt": t1 - t0, "denoise": t2 - t1, "decode": t3 - t2}
        return images
