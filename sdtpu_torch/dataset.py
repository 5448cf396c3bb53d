"""Training data: an image+caption folder -> a latent/context cache ->
shuffled minibatches staged on the device by a prefetch thread (port of
sdtpu/dataset.py).

- The once-per-example work (VAE encode, CLIP encode) runs in batches
  through the pipeline and is cached to an `.npz` with sdtpu's keys and
  layout, so each package reads the other's cache.
- LatentBatches keeps sdtpu's np.random.Generator(PCG64(seed))
  permutations (the same index sequence as sdtpu's for the same seed), the
  wrap-around into the next epoch so every batch has one shape, and the
  [B, S] key-validity mask built from the cached lengths. A daemon thread
  stages `prefetch` batches on the device ahead of the consumer, on a
  stream of its own; the consumer's stream waits for each batch's copies
  before it reads them (a train step copies them into its graph's static
  buffers on its own stream, and may be capturing meanwhile).

Dataset layout: a directory of `<stem>.png` (8-bit RGB) or `<stem>.npy`
([H, W, 3] uint8) images, each with an optional `<stem>.txt` caption (no
caption: the empty prompt, which trains the unconditional branch).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

IMAGE_EXTS = (".png", ".npy")


def list_examples(data_dir: str) -> List[Tuple[str, str]]:
    """[(image_path, caption)] sorted by file name."""
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"dataset directory not found: {data_dir}")
    out = []
    for name in sorted(os.listdir(data_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTS:
            continue
        cap_path = os.path.join(data_dir, stem + ".txt")
        caption = ""
        if os.path.exists(cap_path):
            with open(cap_path, "r", encoding="utf-8") as f:
                caption = f.read().strip()
        out.append((os.path.join(data_dir, name), caption))
    if not out:
        raise FileNotFoundError(f"no {'/'.join(IMAGE_EXTS)} images found in {data_dir}")
    return out


def load_image_u8(path: str) -> np.ndarray:
    """[H, W, 3] uint8 from a .png (the port's own reader) or a .npy."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected [H,W,3] uint8, got {img.dtype} {img.shape}")
        return img
    from sdtpu_torch.utils.image import decode_png_rgb8

    with open(path, "rb") as f:
        return decode_png_rgb8(f.read())


def center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop to a square, then a nearest-neighbour resize to
    [size, size, 3] (sdtpu's offline data prep, no PIL)."""
    h, w, _ = img.shape
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    img = img[y0:y0 + side, x0:x0 + side]
    if side != size:
        idx = (np.arange(size) * side // size).astype(np.int64)
        img = img[idx][:, idx]
    return img


def build_latent_cache(sd, tokenizer, data_dir: str, out_path: str, batch: int = 8,
                       flip: bool = False) -> str:
    """Encode every example once and write the cache npz (sdtpu's keys:
    latents, contexts, n_valid, image_size, config_name).

    The latents are stored scaled into the sampler's latent space
    (encode(x) · latent_scale), so the training loop consumes them as they
    are; the contexts are the full padded [n_ctx, D] CLIP sequences with
    each example's valid length. Chunks of `batch` images go through
    sd.encode_image, the last one at its own size (sdtpu pads it with zeros
    to keep one compiled shape; here it is one more graph key, captured on
    its own images: a zero-padded chunk replayed from the full chunks'
    graph differed from its eager run through cuDNN's convolutions).
    flip: also encode the horizontal mirror of every image, at the pixel
    level (the VAE's asymmetric padding makes a flipped latent differ from
    the latent of the flipped image). With sd's graphs on, every chunk
    replays the encoder's program and every caption CLIP's (graphs.py)."""
    examples = list_examples(data_dir)
    size = sd.config.image_size
    lat_list, ctx_list, nv_list = [], [], []

    def encode_chunk(imgs):
        x = imgs.astype(np.float32) / 127.5 - 1.0  # u8 -> [-1, 1]
        return sd.encode_image(x).float().cpu().numpy() * sd.config.latent_scale

    for start in range(0, len(examples), batch):
        chunk = examples[start:start + batch]
        imgs = np.stack([center_crop_resize(load_image_u8(p), size) for p, _ in chunk])
        lat_list.append(encode_chunk(imgs))
        if flip:
            lat_list.append(encode_chunk(np.ascontiguousarray(imgs[:, :, ::-1])))
        for _, caption in chunk:
            with torch.no_grad():
                ctx, valid = sd.context(tokenizer, caption)
            ctx_list.append(ctx.float().cpu().numpy()[0])
            nv_list.append(int(valid.sum()))
        if flip:  # mirrored copies share their caption's context
            ctx_list.extend(ctx_list[-len(chunk):])
            nv_list.extend(nv_list[-len(chunk):])
    np.savez(out_path, latents=np.concatenate(lat_list), contexts=np.stack(ctx_list),
             n_valid=np.asarray(nv_list, np.int32), image_size=np.int32(size),
             config_name=np.bytes_(sd.config.name.encode()))
    return out_path


def load_latent_cache(path: str):
    """-> (latents [N, h, w, 4] f32, contexts [N, S, D] f32, n_valid [N] i32)."""
    with np.load(path) as z:
        return z["latents"], z["contexts"], z["n_valid"]


class LatentBatches:
    """Infinite shuffled minibatch stream with background device staging.

    Each epoch is a fresh permutation from one seeded PCG64 generator (the
    index sequence of sdtpu's LatentBatches for the same seed); the last
    partial batch wraps into the next epoch. device=False yields numpy
    batches (latents, contexts[, n_valid]); otherwise a torch device (the
    card unless told otherwise) to which each batch (latents, contexts[,
    valid [B, S] bool]) is copied by the prefetch thread. On the card the
    thread copies from pinned memory on its own stream and records an event;
    next() makes the caller's current stream wait for that event and marks
    the batch's tensors as used there (so their memory is not handed back
    to the thread's stream before the caller is done). close() stops the
    thread.

    shard=(dp_rank, dp): each batch's rows dp_rank·B/dp .. (dp_rank+1)·B/dp
    only, a dp rank's slice (sdtpu's sharding= staging); the order is the
    whole batch's, the same permutation on every rank."""

    def __init__(self, latents, contexts, n_valid=None, batch_size: int = 4, seed: int = 0,
                 prefetch: int = 2, device="cuda", shard=None):
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} is not divisible by dp={shard[1]}")
        self.shard = shard
        self.latents = np.ascontiguousarray(latents, np.float32)
        self.contexts = np.ascontiguousarray(contexts, np.float32)
        self.n_valid = None if n_valid is None else np.ascontiguousarray(n_valid, np.int32)
        self.batch_size = int(batch_size)
        self.device = device
        self._copy_stream = None
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self._perm: np.ndarray = self._rng.permutation(len(self.latents))
        self._pos = 0
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _next_indices(self) -> np.ndarray:
        take = []
        while len(take) < self.batch_size:
            if self._pos >= len(self._perm):
                self._perm = self._rng.permutation(len(self.latents))
                self._pos = 0
            need = self.batch_size - len(take)
            sel = self._perm[self._pos:self._pos + need]
            take.extend(sel.tolist())
            self._pos += len(sel)
        return np.asarray(take, np.int64)

    def _stage(self, idx: np.ndarray):
        if self.shard is not None:
            rank, dp = self.shard
            n = len(idx) // dp
            idx = idx[rank * n:(rank + 1) * n]
        lat, ctx = self.latents[idx], self.contexts[idx]
        nv = None if self.n_valid is None else self.n_valid[idx]
        if self.device is False:
            return (lat, ctx) if nv is None else (lat, ctx, nv)
        host = [torch.from_numpy(lat), torch.from_numpy(ctx)]
        if nv is not None:
            host.append(torch.from_numpy(np.arange(ctx.shape[1])[None, :] < nv[:, None]))
        dev = torch.device(self.device)
        if dev.type != "cuda":
            return tuple(x.to(dev) for x in host), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = tuple(x.pin_memory().to(dev, non_blocking=True) for x in host)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._stage(self._next_indices())
            except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise RuntimeError("staging a batch failed") from batch
        if self.device is False:
            return batch
        batch, done = batch
        if done is not None:
            stream = torch.cuda.current_stream(batch[0].device)
            stream.wait_event(done)
            for x in batch:
                x.record_stream(stream)
        return batch

    def close(self) -> None:
        self._stop.set()
        try:  # unblock a worker parked on a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
