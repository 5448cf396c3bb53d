"""Textual inversion: learning a concept and using it (port of
sdtpu/textual_inversion.py).

A textual-inversion concept is `n_vectors` new rows of the CLIP token
embedding table, learned for a placeholder word (e.g. "<sks>"); the model's
weights are untouched. The table is extended by concatenation when a
context is encoded: no tokenizer or module is mutated. Training runs the
whole CLIP text encoder inside the graph, and the gradients reach only the
new rows. The placeholder
cannot go through BPE (it would split): `splice_prompt_ids` splits the
prompt on the placeholder string and inserts the new ids (n_vocab ..
n_vocab + n_vectors - 1) between the BPE-encoded segments, inside the
usual SOT/EOT wrap.

Files are sdtpu's: safetensors with one "embeddings" tensor [n_vectors,
n_state] (f32) and format=sdtpu-ti, the placeholder and the config name in
the metadata, read and written by the port's own safetensors code
(io/native.py), so each package reads the other's.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.io.native import load_safetensors, save_safetensors
from sdtpu_torch.models.clip import clip_apply
from sdtpu_torch.ops import dispatch
from sdtpu_torch.tokenizer import EOT_ID, SOT_ID
from sdtpu_torch.training import diffusion_loss, run_step, step_inputs

DEFAULT_PLACEHOLDER = "<sks>"


def splice_prompt_ids(tokenizer, prompt: str, placeholder: str,
                      n_vocab: int, n_vectors: int) -> List[int]:
    """SOT + (BPE segments with each placeholder occurrence expanded to
    the n_vectors new ids) + EOT."""
    new_ids = list(range(n_vocab, n_vocab + n_vectors))
    ids: List[int] = [SOT_ID]
    for i, part in enumerate(prompt.split(placeholder)):
        if i:
            ids.extend(new_ids)
        if part.strip():
            ids.extend(tokenizer.encode(part.strip()))
    ids.append(EOT_ID)
    return ids


def init_ti_embeddings(generator: torch.Generator, clip_params, n_vectors: int,
                       init_token_id: Optional[int] = None) -> torch.Tensor:
    """New rows [n_vectors, n_state], f32 on the table's device: copies of
    an existing token's row (init_token_id, the standard recipe: a word
    close to the concept), else N(0, 1) from `generator` times the table's
    population std."""
    w = clip_params["token_embedding"]["w"]
    if init_token_id is not None:
        return w[init_token_id].float()[None].repeat(n_vectors, 1)
    std = float(w.float().std(correction=0))
    rows = torch.randn((n_vectors, w.shape[1]), generator=generator, device=generator.device)
    return (rows * std).to(w.device)


def extend_clip(clip_params, new_embeddings):
    """The CLIP params with the token table extended by the new rows, cast
    to the table's dtype and device; every other leaf passed by reference."""
    te = clip_params["token_embedding"]
    w = te["w"]
    rows = torch.as_tensor(new_embeddings).to(w.device, w.dtype)
    return {**clip_params, "token_embedding": {**te, "w": torch.cat([w, rows], dim=0)}}


def ti_context(sd, tokenizer, prompt: str, new_embeddings,
               placeholder: str = DEFAULT_PLACEHOLDER):
    """(context [1, S, D], valid [1, S]) of a prompt containing the
    placeholder: StableDiffusion.encode_ids over the extended table, padded
    to n_ctx only with sd.pad_context."""
    cfg = sd.config
    ids = splice_prompt_ids(tokenizer, prompt, placeholder,
                            cfg.clip.n_vocab, len(new_embeddings))
    return sd.encode_ids(ids, extend_clip(sd.params["clip"], new_embeddings))


def generate_with_ti(sd, tokenizer, prompt: str, new_embeddings,
                     guidance_scale: float = 7.5, n_steps: int = 20,
                     n_images: int = 1, generator: Optional[torch.Generator] = None,
                     sampler: str = "ddim", negative_prompt: str = "",
                     placeholder: str = DEFAULT_PLACEHOLDER,
                     karras_sigmas: bool = False, initial_latent=None) -> np.ndarray:
    """Prompt with the placeholder -> uint8 images [n_images, H, W, 3]:
    StableDiffusion.generate with the concept's context swapped in."""
    ctx, valid = ti_context(sd, tokenizer, prompt, new_embeddings, placeholder)
    unctx, unvalid = sd.context(tokenizer, negative_prompt)
    if n_images > 1:
        ctx, valid = ctx.repeat(n_images, 1, 1), valid.repeat(n_images, 1)
    latent = sd.sample_latent(
        ctx, unctx, guidance_scale, n_steps, generator=generator,
        initial_latent=initial_latent, sampler=sampler,
        ctx_valid=valid, uncond_valid=unvalid,
        karras_sigmas=karras_sigmas)
    return sd.latent_to_image(latent)


def make_ti_train_step(cfg, optimizer, compute_dtype=torch.float32, remat: bool | str = False,
                       graphs=None):
    """train_step(new_emb, opt_state, params, batch, generator=None, *,
    t=None, noise=None) -> (new_emb, opt_state, loss), sdtpu's
    make_ti_train_step. new_emb: the rows, f32, requires grad, updated in
    place; params: the frozen model tree ({"clip", "unet", ...}); batch =
    (latents, tokens [B, n_ctx] int, ctx_valid [B, n_ctx] bool). The CLIP
    forward runs here, recorded by autograd (dispatch.training(), as sdtpu's
    force_xla), on the table extend_clip rebuilds from new_emb each step,
    and the gradients reach only the new rows. t and noise as in
    training.make_train_step; graphs: as its (the body, CLIP included, one
    CUDA graph a key)."""
    statics = {"config": cfg, "optimizer": optimizer.flags(), "remat": remat,
               "compute_dtype": compute_dtype}

    def body(new_emb, opt_state, params, inp):
        with dispatch.training():
            ctx = clip_apply(extend_clip(params["clip"], new_emb), inp["tokens"], cfg.clip)
        loss = diffusion_loss(params["unet"], cfg, inp["latents"], ctx, inp["t"], inp["noise"],
                              ctx_valid=inp["ctx_valid"], compute_dtype=compute_dtype,
                              remat=remat)
        (grad,) = torch.autograd.grad(loss, [new_emb])
        optimizer.apply(new_emb, [grad.float()], opt_state)
        return loss.detach()

    def train_step(new_emb, opt_state, params, batch, generator=None, *, t=None, noise=None):
        inputs = step_inputs(cfg, batch, ("latents", "tokens", "ctx_valid"), generator, t,
                             noise)
        optimizer.stage(opt_state)
        trees = (new_emb, opt_state.tensors(), params["clip"], params["unet"])
        loss = run_step(graphs, "ti", statics, inputs,
                        functools.partial(body, new_emb, opt_state, params), trees)
        return new_emb, opt_state, loss

    return train_step


def prepare_ti_data(sd, tokenizer, data_dir: str, placeholder: str = DEFAULT_PLACEHOLDER,
                    n_vectors: int = 1, batch: int = 4
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (latents [N, h, w, 4] f32, tokens [N, n_ctx] int32, valid [N,
    n_ctx] bool), numpy. The latents are sd.encode_image's in chunks of
    `batch` images (the last at its own size, as dataset.build_latent_cache
    encodes it), times latent_scale; the
    captions come from the usual sidecar files and must contain the
    placeholder (an image without one gets "a photo of <placeholder>")."""
    from sdtpu_torch.dataset import center_crop_resize, list_examples, load_image_u8

    cfg = sd.config
    examples = list_examples(data_dir)
    size, n_ctx = cfg.image_size, cfg.clip.n_ctx
    lat_list, tok_list, nv_list = [], [], []
    for start in range(0, len(examples), batch):
        chunk = examples[start:start + batch]
        imgs = np.stack([center_crop_resize(load_image_u8(p), size) for p, _ in chunk])
        x = imgs.astype(np.float32) / 127.5 - 1.0
        lat_list.append(sd.encode_image(x).float().cpu().numpy() * cfg.latent_scale)
        for _, caption in chunk:
            caption = caption or f"a photo of {placeholder}"
            if placeholder not in caption:
                raise ValueError(f"caption {caption!r} does not contain the placeholder "
                                 f"{placeholder!r}")
            ids = splice_prompt_ids(tokenizer, caption, placeholder, cfg.clip.n_vocab, n_vectors)
            ids = ids[: n_ctx - 1] + [ids[-1]] if len(ids) > n_ctx else ids
            nv_list.append(len(ids))
            tok_list.append(ids + [0] * (n_ctx - len(ids)))
    tokens = np.asarray(tok_list, np.int32)
    valid = np.arange(n_ctx)[None, :] < np.asarray(nv_list)[:, None]
    return np.concatenate(lat_list), tokens, valid


def save_ti(new_embeddings, path: str, placeholder: str, config_name: str = "") -> None:
    rows = torch.as_tensor(new_embeddings).detach().to("cpu", torch.float32)
    save_safetensors({"embeddings": rows}, path,
                     {"format": "sdtpu-ti", "placeholder": placeholder,
                      "config": config_name})


def load_ti(path: str, device="cpu") -> Tuple[torch.Tensor, str, Dict[str, str]]:
    """-> (embeddings [n_vectors, n_state] f32 on `device`, placeholder,
    metadata)."""
    flat, meta = load_safetensors(path, device)
    if meta.get("format") != "sdtpu-ti":
        raise ValueError(f"{path}: not an sdtpu textual-inversion file")
    return flat["embeddings"], meta["placeholder"], meta
