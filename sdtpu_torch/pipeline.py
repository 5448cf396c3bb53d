"""Text-to-image, image-to-image and inpainting (port of sdtpu/pipeline.py).

Classifier-free guidance runs the uncond/cond pair as one batched UNet call
on contexts right-padded to n_ctx, the padded keys masked out of
cross-attention by ctx_valid (sdtpu's default, pad_context=True). With
pad_context=False the contexts are not padded and each step runs two UNet
calls, uncond then cond, on the unpadded contexts with no key mask: sdtpu's
two-pass mode, the reference's own variable-length behaviour. The
five samplers are sdtpu's: ddim, dpmpp (DPM-Solver++ 2M), euler, euler_a
(ancestral) and heun, the last four also on the Karras sigma ladder
(karras_sigmas), each with per-item guidance scales and negative prompts.
A v-prediction model (SD v2.1-768, config.prediction_type "v") has its
guided output turned into epsilon once a UNet evaluation (to_eps), so every
sampler's update is the epsilon one.
sdtpu's jitted lax.scan over the steps is a Python loop here. Where sdtpu
splits a JAX key inside the loop (euler_a's noise, inpainting's
re-imposition), the port draws from a torch.Generator, or from an injected
draw_noise(shape), which the tests feed with sdtpu's own draws.
encode_image (the VAE encoder) serves img2img, inpainting and the
fine-tuning latent cache.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from sdtpu_torch.config import SD_V1_4, StableDiffusionConfig
from sdtpu_torch.diffusion.ddim import ddim_alphas, ddim_schedule, ddim_step
from sdtpu_torch.diffusion.dpm_solver import (dpmpp_2m_step, dpmpp_arrays, dpmpp_init,
                                             dpmpp_karras_arrays)
from sdtpu_torch.diffusion.karras import (euler_ancestral_step, euler_step, heun_step,
                                         karras_arrays, karras_sigma_arrays, model_input,
                                         vp_alpha)
from sdtpu_torch.models.clip import clip_apply
from sdtpu_torch.models.unet import fuse_qkv, unet_apply
from sdtpu_torch.models.vae import decode_latent, encode_image, upsample_phase_stacks
from sdtpu_torch.utils import profiling

SAMPLERS = ("ddim", "dpmpp", "euler", "euler_a", "heun")

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


def to_eps(model_out, x, abar, prediction_type: str):
    """The guided model output as epsilon (sdtpu/pipeline.py:141-147): a
    v-prediction model emits v = sqrt(abar) eps - sqrt(1 - abar) x0, so
    eps = sqrt(abar) v + sqrt(1 - abar) x, f32, with x the latent the UNet
    was given and abar its noise level; an epsilon model's output as it is."""
    if prediction_type == "v":
        return torch.sqrt(abar) * model_out + torch.sqrt(1.0 - abar) * x
    return model_out


class StableDiffusion:
    """Owns the parameter tree {clip, unet, autoencoder, alphas_cumprod,
    n_steps} (tensors on one device, see sdtpu_torch.weights) and runs the
    pipeline on that device.

    pad_context: True, the batched guidance on padded contexts; False,
    sdtpu's two-pass mode (see the module docstring).

    After generate(), `timings` holds the wall seconds of its phases
    (encode_prompt, denoise, decode), each ended by a device synchronise;
    they are added to utils.profiling.REGISTRY as well.
    """

    def __init__(self, params, config: StableDiffusionConfig = SD_V1_4,
                 compute_dtype=torch.float32, pad_context: bool = True):
        if compute_dtype != torch.float32:
            params = _cast_param_tree(params, compute_dtype)
        self.params = {**params, "unet": fuse_qkv(params["unet"])}
        # the decoder's upsampler weights folded into K7's phase stacks once
        self.vae_phases = upsample_phase_stacks(params["autoencoder"])
        self.config = config
        self.compute_dtype = compute_dtype
        self.pad_context = pad_context
        self.n_train_steps = int(params.get("n_steps", config.n_train_steps))
        self.device = params["alphas_cumprod"].device
        self.timings: dict = {}

    # ---------------------------------------------------------- context

    def context(self, tokenizer, text: str):
        """Prompt -> (context [1, S, n_state], valid [1, S] bool) of its
        SOT/EOT-wrapped ids (encode_ids)."""
        return self.encode_ids(tokenizer.encode_prompt(text))

    def encode_ids(self, ids, clip_params=None):
        """SOT/EOT-wrapped token ids -> (context [1, S, n_state], valid
        [1, S] bool) through CLIP (self's, or clip_params): truncation
        keeping EOT last, and, with pad_context, a right pad to S = n_ctx
        whose keys `valid` marks invalid (else S is the prompt's own
        length)."""
        n_ctx = self.config.clip.n_ctx
        if len(ids) > n_ctx:
            ids = ids[: n_ctx - 1] + [ids[-1]]
        n_valid = len(ids)
        if self.pad_context:
            ids = ids + [0] * (n_ctx - len(ids))
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        ctx = clip_apply(clip_params or self.params["clip"], tokens, self.config.clip)
        valid = torch.arange(len(ids), device=self.device)[None, :] < n_valid
        return ctx.to(self.compute_dtype), valid

    # ---------------------------------------------------------- sampler

    def _draw_from(self, generator: Optional[torch.Generator]) -> Callable:
        """draw_noise(shape): N(0, 1) from `generator` on its device, or from
        torch's global generator on the pipeline's device when None."""
        gen_dev = generator.device if generator is not None else self.device
        return lambda shape: torch.randn(shape, generator=generator, device=gen_dev)

    def sample_latent(self, context, unconditional_context, unconditional_guidance_scale,
                      n_steps: int, generator: Optional[torch.Generator] = None,
                      initial_latent=None, ctx_valid=None, uncond_valid=None,
                      sampler: str = "ddim", skip_steps: int = 0,
                      karras_sigmas: bool = False, known_latent=None, known_mask=None,
                      draw_noise: Optional[Callable] = None):
        """sdtpu's sampler (sdtpu/pipeline.py:68-280): classifier-free
        guidance as one batched UNet call, or as two (uncond, then cond)
        without pad_context. context: [B, S, D]; the unconditional context
        is [1, S', D] (broadcast to B) or already [B, S', D]. ctx_valid and
        uncond_valid: the key masks, or None (no mask); the two-pass mode
        reads none (its contexts are unpadded, as sdtpu's).
        unconditional_guidance_scale: a float, or [B] per-item scales.
        initial_latent: [B, h, w, 4] NHWC, drawn N(0, 1) when None.
        sampler: ddim | dpmpp | euler | euler_a | heun; karras_sigmas puts
        the sigma-ladder samplers on Karras et al.'s spacing; skip_steps
        starts mid-schedule (img2img). known_latent / known_mask: inpainting,
        the known region (mask 0) re-imposed after every step at the step's
        target noise level, in the sampler's own domain (VP for ddim and
        dpmpp, VE for the euler family).

        Every random draw (the initial latent, euler_a's per-step noise, the
        re-imposition's noise, in that order) comes from draw_noise(shape)
        when given, else from `generator` (torch's global generator when
        None). Returns the final latent [B, h, w, 4] f32."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
        if karras_sigmas and sampler == "ddim":
            raise ValueError("karras_sigmas is only defined for the sigma-ladder samplers "
                             "(dpmpp|euler|euler_a|heun), not 'ddim'")
        cfg, dev = self.config, self.device
        draw_noise = draw_noise or self._draw_from(generator)
        b = context.shape[0]
        if initial_latent is None:
            hw = cfg.latent_size
            initial_latent = draw_noise((b, hw, hw, cfg.unet.in_channels))
        lat = torch.as_tensor(initial_latent, dtype=torch.float32).to(dev)

        def noise_like(x):
            return torch.as_tensor(draw_noise(tuple(x.shape)), dtype=torch.float32).to(dev)

        unet, dt = self.params["unet"], self.compute_dtype
        scale = torch.as_tensor(unconditional_guidance_scale, dtype=torch.float32).to(dev)
        if scale.ndim == 1:  # per-item guidance (serving batches)
            scale = scale[:, None, None, None]
        uncond_b = unconditional_context.expand((b,) + unconditional_context.shape[1:])
        if self.pad_context:
            ctx2 = torch.cat([uncond_b, context], dim=0)
            valid2 = (None if ctx_valid is None else torch.cat(
                [uncond_valid.expand((b,) + uncond_valid.shape[1:]), ctx_valid], dim=0))

            def denoise(x, t):
                eps2 = unet_apply(unet, torch.cat([x, x], dim=0).to(dt), t, ctx2, cfg.unet,
                                  ctx_valid=valid2).float()
                e_un, e_c = eps2[:b], eps2[b:]
                return e_un + (e_c - e_un) * scale
        else:
            def denoise(x, t):  # sdtpu's parity_two_pass
                x = x.to(dt)
                e_un = unet_apply(unet, x, t, uncond_b, cfg.unet).float()
                e_c = unet_apply(unet, x, t, context, cfg.unet).float()
                return e_un + (e_c - e_un) * scale

        kind = cfg.prediction_type
        inpaint = known_latent is not None
        if inpaint:
            z0 = torch.as_tensor(known_latent, dtype=torch.float32).to(dev)
            mask = torch.as_tensor(known_mask, dtype=torch.float32).to(dev)

        def reimpose(x, alpha, sigma):
            """The known region q-sampled to (alpha, sigma) of the sampler's
            domain: known = alpha z0 + sigma N(0, 1); mask 1 = regenerate."""
            if not inpaint:
                return x
            known = alpha * z0 + sigma * noise_like(z0)
            return mask * x + (1.0 - mask) * known

        alphas = self.params["alphas_cumprod"].float()
        ac = alphas.cpu().numpy()

        def table(a):  # per-step constants as 0-d f32 tensors on the device
            return torch.from_numpy(np.ascontiguousarray(a[skip_steps:])).to(dev)

        if sampler == "ddim":
            timesteps, step_size = ddim_schedule(self.n_train_steps, n_steps)
            timesteps = timesteps[skip_steps:]
            a_t, a_prev = ddim_alphas(alphas, timesteps, step_size)
            for i, t in enumerate(timesteps):
                eps = to_eps(denoise(lat, t), lat, a_t[i], kind)
                lat = ddim_step(lat, eps, a_t[i], a_prev[i])
                # VP domain at the next level
                lat = reimpose(lat, torch.sqrt(a_prev[i]), torch.sqrt(1.0 - a_prev[i]))
            return lat

        if sampler == "dpmpp":
            arrs = (dpmpp_karras_arrays(ac, n_steps) if karras_sigmas
                    else dpmpp_arrays(ac, self.n_train_steps, n_steps))
            steps = [table(a) for a in arrs[:6]]
            state = dpmpp_init(lat)
            for i, t in enumerate(arrs.timesteps[skip_steps:]):
                step = [a[i] for a in steps]
                # abar_t = alpha_t^2 (sdtpu/pipeline.py:198)
                eps = to_eps(denoise(state.x, t), state.x, step[0] * step[0], kind)
                state = dpmpp_2m_step(state, eps, step)
                # VP domain at the step's target (alpha_n, sigma_n)
                state = state._replace(x=reimpose(state.x, step[3], step[4]))
            return state.x

        arrs = (karras_sigma_arrays(ac, n_steps) if karras_sigmas
                else karras_arrays(ac, self.n_train_steps, n_steps))
        sig, sig_next = table(arrs.sigma), table(arrs.sigma_next)
        # the VP N(0, 1) latent -> the VE domain (x0 comes out unscaled)
        x = lat * torch.sqrt(sig[0] ** 2 + 1.0)

        def eps_at(x, sigma, t):
            # v converted on the scaled model input, at abar = vp_alpha(sigma)
            inp = model_input(x, sigma)
            return to_eps(denoise(inp, t), inp, vp_alpha(sigma), kind)

        # VE domain: the known latent is x0-scale, so the re-imposition at
        # the target level is z0 + sigma_next * noise
        for i, (t, tn) in enumerate(zip(arrs.timesteps[skip_steps:],
                                        arrs.t_next[skip_steps:])):
            sg, sn = sig[i], sig_next[i]
            if sampler == "euler":
                x = euler_step(x, eps_at(x, sg, t), sg, sn)
            elif sampler == "heun":
                e1 = eps_at(x, sg, t)
                # the second evaluation at the target sigma, ignored when
                # sn == 0 (the last step is Euler's)
                e2 = eps_at(euler_step(x, e1, sg, sn), torch.clamp(sn, min=1e-20), tn)
                x = heun_step(x, e1, e2, sg, sn)
            else:  # euler_a
                noise = noise_like(x)
                x = euler_ancestral_step(x, eps_at(x, sg, t), noise, sg, sn)
            x = reimpose(x, 1.0, sn)
        return x

    # ---------------------------------------------------------- decode

    def _decode_u8(self, latent):
        """decode(latent / latent_scale) -> (x+1)/2*255 -> round, clamp ->
        uint8, on the device."""
        z = (latent * (1.0 / self.config.latent_scale)).to(self.compute_dtype)
        img = decode_latent(self.params["autoencoder"], z, self.config.vae, self.vae_phases)
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

    def sample_image(self, context, unconditional_context, unconditional_guidance_scale,
                     n_steps: int, **kw) -> np.ndarray:
        """sample_latent, then the decode: uint8 images [B, H, W, 3] on the host."""
        return self.latent_to_image(self.sample_latent(
            context, unconditional_context, unconditional_guidance_scale, n_steps, **kw))

    def generate(self, tokenizer, prompt: str, guidance_scale: float = 7.5,
                 n_steps: int = 20, n_images: int = 1,
                 generator: Optional[torch.Generator] = None, initial_latent=None,
                 sampler: str = "ddim", negative_prompt: str = "",
                 karras_sigmas: bool = False) -> np.ndarray:
        """Prompt string -> uint8 images [n_images, H, W, 3].
        negative_prompt replaces the empty unconditional prompt."""
        t0 = time.perf_counter()
        ctx, valid, unctx, unvalid = self._prompt_pair(tokenizer, prompt, negative_prompt,
                                                       n_images)
        self._sync()
        t1 = time.perf_counter()
        latent = self.sample_latent(
            ctx, unctx, guidance_scale, n_steps, generator=generator,
            initial_latent=initial_latent, ctx_valid=valid, uncond_valid=unvalid,
            sampler=sampler, karras_sigmas=karras_sigmas)
        self._sync()
        t2 = time.perf_counter()
        images = self.latent_to_image(latent)
        t3 = time.perf_counter()
        self.timings = {"encode_prompt": t1 - t0, "denoise": t2 - t1, "decode": t3 - t2}
        for name, seconds in self.timings.items():
            profiling.REGISTRY.add(name, seconds)
        return images

    def _prompt_pair(self, tokenizer, prompt: str, negative_prompt: str, b: int):
        """(context, valid) of the prompt repeated to b, and of the
        negative prompt once (sample_latent broadcasts it)."""
        ctx, valid = self.context(tokenizer, prompt)
        unctx, unvalid = self.context(tokenizer, negative_prompt)
        if b > 1:
            ctx, valid = ctx.repeat(b, 1, 1), valid.repeat(b, 1)
        return ctx, valid, unctx, unvalid

    def _scaled_latent(self, image):
        """encode(image) * latent_scale, f32: the clean latent z0."""
        return self.encode_image(image).float() * self.config.latent_scale

    def img2img(self, tokenizer, prompt: str, image, strength: float = 0.75,
                guidance_scale: float = 7.5, n_steps: int = 20,
                generator: Optional[torch.Generator] = None, sampler: str = "ddim",
                negative_prompt: str = "", karras_sigmas: bool = False,
                draw_noise: Optional[Callable] = None) -> np.ndarray:
        """Image-to-image (sdtpu/pipeline.py:497-556): encode `image`
        ([B, H, W, 3] in [-1, 1]) to the scaled latent z0, q-sample it to
        the strength's entry point of the schedule, denoise the remaining
        steps. The entry point is the skip position round((1 - strength) n)
        of the uniform grid, or, with karras_sigmas, the Karras ladder's
        sigma there (abar = 1 / (1 + sigma^2)); the q-sample is the VP
        noising either way. The q-sample's N(0, 1) draw comes first, then the
        sampler's (euler_a's per-step noise), each from draw_noise(shape)
        when given, else from `generator`."""
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        if karras_sigmas and sampler == "ddim":
            raise ValueError("karras_sigmas needs sampler dpmpp|euler|euler_a|heun")
        z0 = self._scaled_latent(image)
        ctx, valid, unctx, unvalid = self._prompt_pair(tokenizer, prompt, negative_prompt,
                                                       z0.shape[0])
        skip = min(int(round((1.0 - strength) * n_steps)), n_steps - 1)
        ac = self.params["alphas_cumprod"].float().cpu().numpy()
        if karras_sigmas:
            a_t = vp_alpha(karras_sigma_arrays(ac, n_steps).sigma[skip])
        else:
            timesteps, _ = ddim_schedule(self.n_train_steps, n_steps)
            a_t = ac[timesteps[skip]]
        draw_noise = draw_noise or self._draw_from(generator)
        noise = torch.as_tensor(draw_noise(tuple(z0.shape)), dtype=torch.float32)
        a_t = torch.tensor(a_t, dtype=torch.float32, device=self.device)
        x_t = torch.sqrt(a_t) * z0 + torch.sqrt(1.0 - a_t) * noise.to(self.device)
        return self.sample_image(ctx, unctx, guidance_scale, n_steps, initial_latent=x_t,
                                 ctx_valid=valid, uncond_valid=unvalid, sampler=sampler,
                                 skip_steps=skip, karras_sigmas=karras_sigmas,
                                 draw_noise=draw_noise)

    def inpaint(self, tokenizer, prompt: str, image, mask, guidance_scale: float = 7.5,
                n_steps: int = 20, generator: Optional[torch.Generator] = None,
                negative_prompt: str = "", sampler: str = "ddim",
                karras_sigmas: bool = False, initial_latent=None,
                draw_noise: Optional[Callable] = None) -> np.ndarray:
        """Masked inpainting (sdtpu/pipeline.py:558-606), RePaint-style on
        any sampler: after every step the known region is re-imposed,
        q-sampled to the step's noise level (see sample_latent). image:
        [B, H, W, 3] in [-1, 1]; mask: [B, H, W, 1] or [B, H, W], 1 =
        regenerate. A latent cell is regenerated if any of its pixels is
        (the mask max-pooled to latent resolution)."""
        mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
        if mask.ndim == 3:
            mask = mask[..., None]
        f = self.config.vae_factor
        b, hh, ww, _ = mask.shape
        m_lat = mask.reshape(b, hh // f, f, ww // f, f, 1).amax(dim=(2, 4))
        z0 = self._scaled_latent(image)
        ctx, valid, unctx, unvalid = self._prompt_pair(tokenizer, prompt, negative_prompt, b)
        return self.sample_image(ctx, unctx, guidance_scale, n_steps, generator=generator,
                                 initial_latent=initial_latent, ctx_valid=valid,
                                 uncond_valid=unvalid, sampler=sampler,
                                 karras_sigmas=karras_sigmas, known_latent=z0,
                                 known_mask=m_lat, draw_noise=draw_noise)
