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
sdtpu's jitted lax.scan over the steps is a Python loop here, and on the
card the whole loop is one CUDA graph (graphs.py), captured on the first
call with a given key and replayed after: each user action (the sampler,
the decode to uint8, the CLIP encode, the VAE encode) is one Program,
prepared outside the graph and run inside it, as sdtpu runs each as one
jit. Where sdtpu splits a JAX key inside the loop (euler_a's noise,
inpainting's re-imposition), the port draws from a torch.Generator, or
from an injected draw_noise(shape), which the tests feed with sdtpu's own
draws; every draw is made before the loop, in the loop's order, so the
graph replays on device tensors alone and the values are those of draws
made step by step. encode_image (the VAE encoder) serves img2img,
inpainting and the fine-tuning latent cache.

On a parallel.Mesh (one StableDiffusion a rank, every rank calling the same
methods with the same arguments) the pipeline holds this rank's tp shards
(parallel/sharding.py) and runs its models inside the mesh's tp group. The
sampler runs this dp rank's slice of the batch: every random draw (the
initial latent, euler_a's and the re-imposition's noise) is made for the
whole batch, alike on every rank, then sliced, so a dp run equals the
single run; the latent and the images are all-gathered over dp, so every
rank returns the whole batch. The tp ranks of a dp row run the same slice
in lockstep.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import numpy as np
import torch

from sdtpu_torch import graphs
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
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.sharding import gather_batch, shard_batch, shard_params
from sdtpu_torch.utils import profiling

SAMPLERS = ("ddim", "dpmpp", "euler", "euler_a", "heun")

# the DPM-Solver++ step constants, in dpmpp_2m_step's order
DPM_COLUMNS = ("alpha_t", "sigma_t", "lam_t", "alpha_n", "sigma_n", "lam_n")

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

    mesh: a parallel.Mesh (see the module docstring); params are the whole
    tree, of which the pipeline keeps this rank's shards.

    graphs: run sample_latent, the decode (latent_to_image, _decode_u8),
    encode_ids (CLIP) and encode_image each as one CUDA graph a call
    (graphs.py; `graph_cache` holds them and their counts). None, the
    default: on for a CUDA pipeline without a mesh, off on the CPU and on
    a mesh (gloo's collectives run on the host and cannot be captured).
    False runs the same Programs eagerly, one dispatch an op. True on the
    CPU or on a mesh raises.
    """

    def __init__(self, params, config: StableDiffusionConfig = SD_V1_4,
                 compute_dtype=torch.float32, pad_context: bool = True, mesh=None,
                 graphs: Optional[bool] = None):
        if compute_dtype != torch.float32:
            params = _cast_param_tree(params, compute_dtype)
        params = {**params, "unet": fuse_qkv(params["unet"])}
        with torch.no_grad():
            self.params = shard_params(params, mesh)
        self.mesh = mesh
        self.tp = tpc.of_mesh(mesh)
        # the decoder's upsampler weights (this rank's) folded into K7's
        # phase stacks once
        self.vae_phases = upsample_phase_stacks(self.params["autoencoder"])
        self.config = config
        self.compute_dtype = compute_dtype
        self.pad_context = pad_context
        self.n_train_steps = int(params.get("n_steps", config.n_train_steps))
        self.device = params["alphas_cumprod"].device
        self.timings: dict = {}
        self.graphs = False
        self.graph_cache = None
        self._set_graphs(graphs)

    def _set_graphs(self, on: Optional[bool]) -> None:
        on_card = self.device.type == "cuda"
        if on is None:
            on = on_card and self.mesh is None
        if on and not on_card:
            raise ValueError(f"graphs=True needs a CUDA pipeline; this one is on {self.device}")
        if on and self.mesh is not None:
            raise ValueError("graphs=True on a mesh: the mesh paths run eagerly (gloo's "
                             "collectives run on the host and cannot be captured)")
        if on and self.graph_cache is None:
            self.graph_cache = graphs.GraphCache(self.device)
        self.graphs = on

    def with_graphs(self, on: bool) -> "StableDiffusion":
        """A pipeline that shares this one's weights, options and graph
        cache, with its graphs on or off (the eager side of an A/B against
        the replayed programs)."""
        sd = copy.copy(self)
        sd.timings = {}
        sd._set_graphs(on)
        return sd

    def with_unet(self, unet) -> "StableDiffusion":
        """A pipeline that shares this one's weights, mesh and options but
        the UNet's: `unet`, sdtpu's unfused tree in the compute dtype as
        this rank holds it (its tp parts on a mesh), fused as the
        constructor fuses it (a LoRA merge, serve.Batcher.sd_for)."""
        sd = copy.copy(self)
        sd.params = {**self.params, "unet": fuse_qkv(unet)}
        sd.timings = {}
        return sd

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
        length). Through self's CLIP it is one Program (sdtpu's _clip_impl);
        a caller's clip_params (a textual-inversion table, a new tree each
        call) run eagerly."""
        n_ctx = self.config.clip.n_ctx
        if len(ids) > n_ctx:
            ids = ids[: n_ctx - 1] + [ids[-1]]
        n_valid = len(ids)
        if self.pad_context:
            ids = ids + [0] * (n_ctx - len(ids))
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        valid = torch.arange(len(ids), device=self.device)[None, :] < n_valid
        program = self._clip_program(tokens, clip_params)
        with tpc.use(self.tp):
            ctx = program.fn(program.inputs) if clip_params is not None else self._run(program)
        return ctx, valid

    def _clip_program(self, tokens, clip_params=None) -> graphs.Program:
        """CLIP over tokens [1, S] -> the context in the compute dtype, as a
        Program (sdtpu's _clip_impl)."""
        cfg, dt = self.config, self.compute_dtype
        clip = self.params["clip"] if clip_params is None else clip_params

        def encode(inp):
            return clip_apply(clip, inp["tokens"], cfg.clip).to(dt)

        inputs = {"tokens": tokens}
        return graphs.Program("clip", {"config": cfg, "compute_dtype": dt}, inputs, encode,
                              (clip,), graphs.CLIP_GATES)

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

        Every random draw (the initial latent, then each step's euler_a
        noise and re-imposition noise, in that order) comes from
        draw_noise(shape) when given, else from `generator` (torch's global
        generator when None), for the whole batch, all made before the loop
        runs (on the card, as one CUDA graph replay: graphs.py). Returns the final latent [B, h, w, 4]
        f32. On a mesh, B must divide by dp: the rank runs its slice and
        returns the latent gathered over dp."""
        with tpc.use(self.tp):
            return gather_batch(self._run(self._sampler_program(
                context, unconditional_context, unconditional_guidance_scale, n_steps,
                generator, initial_latent, ctx_valid, uncond_valid, sampler, skip_steps,
                karras_sigmas, known_latent, known_mask, draw_noise)), self.mesh)

    def _schedule(self, n_steps: int, sampler: str, skip_steps: int,
                  karras_sigmas: bool) -> dict:
        """The sampler's per-step constants from step skip_steps on, as f32
        tensors on the device: "t", the UNet's timestep of each step, and
        ddim's a_t, a_prev; dpmpp's DPM_COLUMNS; the Karras family's
        t_next, sigma, sigma_next."""
        dev = self.device
        alphas = self.params["alphas_cumprod"].float()
        ac = alphas.cpu().numpy()

        def table(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a[skip_steps:], np.float32))).to(dev)

        if sampler == "ddim":
            timesteps, step_size = ddim_schedule(self.n_train_steps, n_steps)
            timesteps = timesteps[skip_steps:]
            a_t, a_prev = ddim_alphas(alphas, timesteps, step_size)
            return {"t": torch.tensor(timesteps, dtype=torch.float32).to(dev), "a_t": a_t,
                    "a_prev": a_prev}
        if sampler == "dpmpp":
            arrs = (dpmpp_karras_arrays(ac, n_steps) if karras_sigmas
                    else dpmpp_arrays(ac, self.n_train_steps, n_steps))
            return {"t": table(arrs.timesteps),
                    **{name: table(getattr(arrs, name)) for name in DPM_COLUMNS}}
        arrs = (karras_sigma_arrays(ac, n_steps) if karras_sigmas
                else karras_arrays(ac, self.n_train_steps, n_steps))
        return {"t": table(arrs.timesteps), "t_next": table(arrs.t_next),
                "sigma": table(arrs.sigma), "sigma_next": table(arrs.sigma_next)}

    def _sampler_program(self, context, unconditional_context, unconditional_guidance_scale,
                         n_steps, generator, initial_latent, ctx_valid, uncond_valid, sampler,
                         skip_steps, karras_sigmas, known_latent, known_mask,
                         draw_noise) -> graphs.Program:
        """The sampler on this dp rank's slice of the batch, as a Program
        (graphs.py): (a) the preparation (the
        schedule tables, the guidance scale, the contexts and masks on the
        device), (b) every random draw, made here in the order and the
        shapes the loop consumes them, and (c) the loop, which reads only
        the device tensors of (a) and (b)."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
        if karras_sigmas and sampler == "ddim":
            raise ValueError("karras_sigmas is only defined for the sigma-ladder samplers "
                             "(dpmpp|euler|euler_a|heun), not 'ddim'")
        cfg, dev, mesh = self.config, self.device, self.mesh
        draw_noise = draw_noise or self._draw_from(generator)
        b_all = context.shape[0]
        inpaint = known_latent is not None

        def f32(a):  # an f32 tensor on the device
            return torch.as_tensor(a, dtype=torch.float32).to(dev)

        def rows(a):  # this rank's rows of a per-item argument ([B, ...] or [1, ...])
            return shard_batch(a, mesh) if a is not None and a.shape[0] == b_all > 1 else a

        # (a) the preparation
        inp = self._schedule(n_steps, sampler, skip_steps, karras_sigmas)
        n_loop = inp["t"].shape[0]
        context, ctx_valid = shard_batch(context, mesh), shard_batch(ctx_valid, mesh)
        b = context.shape[0]
        scale = f32(unconditional_guidance_scale)
        if scale.ndim == 1:  # per-item guidance (serving batches)
            scale = rows(scale)[:, None, None, None]
        inp["scale"] = scale
        unconditional_context, uncond_valid = rows(unconditional_context), rows(uncond_valid)
        if self.pad_context:
            uncond_b = unconditional_context.expand((b,) + unconditional_context.shape[1:])
            inp["ctx2"] = torch.cat([uncond_b, context], dim=0)
            if ctx_valid is not None:
                inp["valid2"] = torch.cat(
                    [uncond_valid.expand((b,) + uncond_valid.shape[1:]), ctx_valid], dim=0)
        else:  # the loop broadcasts the unconditional context
            inp["uncond"], inp["context"] = unconditional_context, context
        if inpaint:
            inp["z0"], inp["mask"] = rows(f32(known_latent)), rows(f32(known_mask))

        # (b) the draws: the initial latent, then each step's euler_a noise
        # and re-imposition noise, in that order; each for the whole batch,
        # then this rank's rows
        if initial_latent is None:
            hw = cfg.latent_size
            initial_latent = draw_noise((b_all, hw, hw, cfg.unet.in_channels))
        inp["latent"] = shard_batch(f32(initial_latent), mesh)
        per_step = ([(b_all,) + tuple(inp["latent"].shape[1:])] if sampler == "euler_a" else [])
        if inpaint:
            per_step.append((b_all,) + tuple(inp["z0"].shape[1:]))
        k = len(per_step)
        if k and n_loop:
            inp["noise"] = torch.stack([shard_batch(f32(draw_noise(shape)), mesh)
                                        for _ in range(n_loop) for shape in per_step])

        # (c) the loop
        unet, dt, kind, pad = self.params["unet"], self.compute_dtype, cfg.prediction_type, \
            self.pad_context

        def denoise(inp, x, t):
            if pad:
                eps2 = unet_apply(unet, torch.cat([x, x], dim=0).to(dt), t, inp["ctx2"],
                                  cfg.unet, ctx_valid=inp.get("valid2")).float()
                e_un, e_c = eps2[:b], eps2[b:]
            else:  # sdtpu's parity_two_pass
                x = x.to(dt)
                uncond = inp["uncond"]
                e_un = unet_apply(unet, x, t, uncond.expand((b,) + uncond.shape[1:]),
                                  cfg.unet).float()
                e_c = unet_apply(unet, x, t, inp["context"], cfg.unet).float()
            return e_un + (e_c - e_un) * inp["scale"]

        def reimpose(inp, i, x, alpha, sigma):
            """The known region q-sampled to (alpha, sigma) of the sampler's
            domain: known = alpha z0 + sigma N(0, 1) (the step's last draw);
            mask 1 = regenerate."""
            if not inpaint:
                return x
            known = alpha * inp["z0"] + sigma * inp["noise"][i * k + k - 1]
            return inp["mask"] * x + (1.0 - inp["mask"]) * known

        def loop(inp):
            lat, t = inp["latent"], inp["t"]
            if sampler == "ddim":
                a_t, a_prev = inp["a_t"], inp["a_prev"]
                for i in range(n_loop):
                    eps = to_eps(denoise(inp, lat, t[i]), lat, a_t[i], kind)
                    lat = ddim_step(lat, eps, a_t[i], a_prev[i])
                    # VP domain at the next level
                    lat = reimpose(inp, i, lat, torch.sqrt(a_prev[i]),
                                   torch.sqrt(1.0 - a_prev[i]))
                return lat

            if sampler == "dpmpp":
                columns = [inp[name] for name in DPM_COLUMNS]
                state = dpmpp_init(lat)
                for i in range(n_loop):
                    step = [c[i] for c in columns]
                    # abar_t = alpha_t^2 (sdtpu/pipeline.py:198)
                    eps = to_eps(denoise(inp, state.x, t[i]), state.x, step[0] * step[0],
                                 kind)
                    state = dpmpp_2m_step(state, eps, step)
                    # VP domain at the step's target (alpha_n, sigma_n)
                    state = state._replace(x=reimpose(inp, i, state.x, step[3], step[4]))
                return state.x

            sig, sig_next, t_next = inp["sigma"], inp["sigma_next"], inp["t_next"]
            # the VP N(0, 1) latent -> the VE domain (x0 comes out unscaled)
            x = lat * torch.sqrt(sig[0] ** 2 + 1.0)

            def eps_at(x, sigma, t):
                # v converted on the scaled model input, at abar = vp_alpha(sigma)
                inp_x = model_input(x, sigma)
                return to_eps(denoise(inp, inp_x, t), inp_x, vp_alpha(sigma), kind)

            # VE domain: the known latent is x0-scale, so the re-imposition
            # at the target level is z0 + sigma_next * noise
            for i in range(n_loop):
                sg, sn = sig[i], sig_next[i]
                if sampler == "euler":
                    x = euler_step(x, eps_at(x, sg, t[i]), sg, sn)
                elif sampler == "heun":
                    e1 = eps_at(x, sg, t[i])
                    # the second evaluation at the target sigma, ignored when
                    # sn == 0 (the last step is Euler's)
                    e2 = eps_at(euler_step(x, e1, sg, sn), torch.clamp(sn, min=1e-20),
                                t_next[i])
                    x = heun_step(x, e1, e2, sg, sn)
                else:  # euler_a: the step's first draw
                    x = euler_ancestral_step(x, eps_at(x, sg, t[i]), inp["noise"][i * k], sg,
                                             sn)
                x = reimpose(inp, i, x, 1.0, sn)
            return x

        def warm(inp):  # one guided UNet evaluation at the first step's shapes
            if n_loop:
                denoise(inp, inp["latent"], inp["t"][0])

        statics = {"config": cfg, "compute_dtype": dt, "n_train_steps": self.n_train_steps,
                   "n_steps": n_steps, "parity_two_pass": not pad, "sampler": sampler,
                   "skip_steps": skip_steps, "karras_sigmas": karras_sigmas,
                   "inpaint": inpaint, "guidance": "per_item" if scale.ndim else "scalar",
                   "masks": ctx_valid is not None}
        return graphs.Program("sample", statics, inp, loop, (unet,), graphs.UNET_GATES, warm)

    def _run(self, program: graphs.Program):
        """program's output: replayed from its CUDA graph (graphs.py), or
        run eagerly when the pipeline's graphs are off."""
        if self.graphs:
            return self.graph_cache.run(program)
        return program.fn(program.inputs)

    # ---------------------------------------------------------- decode

    def _decode_program(self, latent) -> graphs.Program:
        """decode(latent / latent_scale) -> (x+1)/2*255 -> round, clamp ->
        uint8, as a Program (sdtpu's _decode_u8_impl)."""
        cfg, dt = self.config, self.compute_dtype
        vae, phases = self.params["autoencoder"], self.vae_phases

        def decode(inp):
            z = (inp["latent"] * (1.0 / cfg.latent_scale)).to(dt)
            img = decode_latent(vae, z, cfg.vae, phases)
            img = (img.float() + 1.0) / 2.0 * 255.0
            return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)

        inputs = {"latent": latent}
        trees = (vae, phases)
        return graphs.Program("decode", {"config": cfg, "compute_dtype": dt}, inputs, decode,
                              trees, graphs.VAE_GATES)

    def _decode_u8(self, latent):
        """The decode to uint8 images on the device (on a mesh: this dp
        rank's rows, gathered)."""
        with tpc.use(self.tp):
            return gather_batch(self._run(self._decode_program(shard_batch(latent, self.mesh))),
                                self.mesh)

    def latent_to_image(self, latent) -> np.ndarray:
        """Returns [B, H, W, 3] uint8 on the host."""
        return self._decode_u8(latent).cpu().numpy()

    def encode_image(self, image):
        """image: [B, H, W, 3] in [-1, 1] (numpy or a tensor) -> latent
        [B, H/8, W/8, 4] in the compute dtype, on the device; not scaled by
        latent_scale (sdtpu/pipeline.py:431-439). One Program (sdtpu's
        _encode_impl)."""
        x = shard_batch(torch.as_tensor(image, dtype=self.compute_dtype, device=self.device),
                        self.mesh)
        cfg, vae = self.config, self.params["autoencoder"]

        def encode(inp):
            return encode_image(vae, inp["image"], cfg.vae)

        inputs = {"image": x}
        program = graphs.Program("encode", {"config": cfg}, inputs, encode, (vae,),
                                 graphs.VAE_GATES)
        with torch.no_grad(), tpc.use(self.tp):
            return gather_batch(self._run(program), self.mesh)

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
