"""Textual inversion at inference (port of the inference half of
sdtpu/textual_inversion.py).

A textual-inversion concept is `n_vectors` new rows of the CLIP token
embedding table, learned for a placeholder word (e.g. "<sks>"); the model's
weights are untouched. The table is extended by concatenation when a
context is encoded: no tokenizer or module is mutated. The placeholder
cannot go through BPE (it would split): `splice_prompt_ids` splits the
prompt on the placeholder string and inserts the new ids (n_vocab ..
n_vocab + n_vectors - 1) between the BPE-encoded segments, inside the
usual SOT/EOT wrap.

Files are sdtpu's: safetensors with one "embeddings" tensor [n_vectors,
n_state] (f32) and format=sdtpu-ti, the placeholder and the config name in
the metadata, read and written by the port's own safetensors code
(io/native.py), so each package reads the other's. Learning the rows
(sdtpu's init_ti_embeddings, make_ti_train_step and prepare_ti_data) is not
ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.io.native import load_safetensors, save_safetensors
from sdtpu_torch.tokenizer import EOT_ID, SOT_ID

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
