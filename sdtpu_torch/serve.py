"""HTTP serving for text-to-image, image-to-image and inpainting (port of
sdtpu/serve.py): a stdlib ThreadingHTTPServer over one StableDiffusion, a
micro-batcher for /generate, warm-up before it reports ready, JSON in and
base64 PNGs out.

    python -m sdtpu_torch.serve <burn|dump|native|ckpt> <model> --port 8000 --bf16 \\
        [--steps N] [--preset P] [--lora name=adapter.safetensors,...]
    curl -X POST localhost:8000/generate \\
         -d '{"prompt": "an ancient mossy stone", "steps": 20, "seed": 1}'
    # -> {"images": ["<base64 png>"], "latency_s": ..., "images_per_sec": ...}
    curl -X POST localhost:8000/img2img \\
         -d '{"prompt": "...", "init_image": "<base64 png>", "strength": 0.6}'
    curl -X POST localhost:8000/inpaint \\
         -d '{"prompt": "...", "init_image": "<b64>", "mask": "<b64, white = redo>"}'
    curl localhost:8000/healthz

A request may name a sampler (ddim|dpmpp|euler|euler_a|heun), "karras":
true (the sigma-ladder samplers), a negative_prompt, a guidance_scale,
n_images and a loaded LoRA adapter ("lora").

Seeds: a request's seed makes its latent (and every other draw of its
sampler) through a torch.Generator on the pipeline's device, seeded with
it, so a lone seeded /generate returns the image StableDiffusion.generate
gives with generator=torch.Generator(device=sd.device).manual_seed(seed)
on the same card. Without a seed the generator is seeded from the clock.

On the card a pipeline runs through CUDA graphs (graphs.py): each batch
replays the graphs of its key (steps, sampler, karras, the adapter's UNet,
the batch padded to a power of two, so the keys stay few, as sdtpu's jit
cache's do), captured at the key's first batch; make_server's warm-up
request captures the default key. An adapter's pipeline has its own UNet
tree and so its own graphs, in the base pipeline's cache (one memory pool).
Every output leaves the graph as a clone, so a batch's images stay intact
while the next batch replays.

The server's state (pipeline, tokenizer, batcher) belongs to the server
object make_server returns; server_close() also stops the batcher's
threads. main() serves a model file of any of the CLI's types on the card
(sdtpu_torch.cli.load_model; --preset names a dump's, ckpt's or mpk's
configuration). A pipeline without pad_context batches only requests
whose prompts, and whose negative prompts, have one token count, since
their unpadded contexts stack only at one length (sdtpu's batcher keys on
neither and fails such a batch).

On a mesh (a StableDiffusion built with mesh=, as sdtpu's batcher runs
over a sharded pipeline) every rank constructs the Batcher with the same
arguments. Rank 0 takes the requests: its worker collects each batch as
it does alone, then broadcasts the batch's description (prompts, negative
prompts, scales, seeds, image counts, steps, sampler, karras, adapter;
parallel.broadcast_object) before it runs it, and close() broadcasts a
stop. Every other rank runs a follower thread that takes each description
and runs the same batch, so every rank makes the same collective calls in
the same order (the CLIP encodings of its context cache among them), and
whose submit() raises. Rank 0 alone answers callers; collectives run on
the worker threads only. make_server serves a pipeline without a mesh.
A batch that fails on any rank of a mesh ends the Batcher on every rank:
the ranks' collectives may be out of step after it, so the failing rank
destroys the torch.distributed world (on gloo that ends the other ranks'
pending collectives at once, so their batch fails too), the followers
stop, and rank 0 answers the batch's callers, then every request queued
or to come, with the error.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from sdtpu_torch.parallel.mesh import broadcast_object
from sdtpu_torch.pipeline import SAMPLERS


class Overloaded(RuntimeError):
    """The request queue is full: callers get a 503."""


class RequestTimeout(RuntimeError):
    """The request did not complete within its deadline: callers get a 504."""


def _seed(seed) -> int:
    """The request's seed, or one drawn from the clock."""
    return time.monotonic_ns() % (2 ** 63) if seed is None else int(seed)


def _generator(device, seed):
    """The request's generator on the pipeline's device (see the module
    docstring)."""
    return torch.Generator(device=device).manual_seed(_seed(seed))


class Batcher:
    """Dynamic micro-batching: concurrent /generate requests that share
    (n_steps, sampler, karras, lora) run as one device batch, padded to a
    power of two. Guidance scales, negative prompts and seeds stay per item.

    At most `max_queue` requests wait; past that submit() raises Overloaded
    at once (HTTP 503). Each request has a deadline, `timeout_s`: a caller
    not served by then gets RequestTimeout (HTTP 504) and the worker drops
    the abandoned slot. A request whose key differs from the batch being
    filled is held, and the next batch starts from the oldest hold and
    sweeps the other holds for key-mates.

    Two threads: the worker collects and runs batches; the completer copies
    each finished batch to the host (after an event recorded on the
    worker's stream), so the worker can launch the next batch meanwhile.
    batch_sizes counts the padded batches run, by size. On a mesh (the
    module docstring) a batch is padded to a multiple of dp as well, and
    ranks but 0 run a follower thread instead."""

    def __init__(self, sd, tokenizer, max_batch: int = 8, window_ms: float = 15.0,
                 max_queue: int = 32, timeout_s: float = 120.0, ctx_cache_size: int = 256,
                 loras=None):
        self.sd = sd
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_queue = max_queue
        self.timeout_s = timeout_s
        self.queue: "queue.Queue" = queue.Queue()
        # held items: mutated by the worker, counted by submitters for the
        # capacity check; the lock makes that count a consistent snapshot
        self._held = []
        self._held_lock = threading.Lock()
        # loaded adapters: name -> (adapter tree, scale); the merged
        # pipelines are built at first use and kept (sd_for)
        self.loras = dict(loras or {})
        self._lora_sd = {}
        self._lora_lock = threading.Lock()
        # prompt -> (context, valid) LRU: the CLIP forward, once per distinct
        # prompt; the encoding is deterministic, so caching changes nothing.
        # Worker (or follower) thread only.
        self._ctx_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._ctx_cache_size = ctx_cache_size
        self.batch_sizes: "collections.Counter" = collections.Counter()
        self._closing = False
        # on a mesh, the error that ended it (the module docstring)
        self.failed = None
        self.mesh = sd.mesh
        self.leader = self.mesh is None or self.mesh.rank == 0
        if not self.leader:  # runs what rank 0 broadcasts until its stop
            self.thread = threading.Thread(target=self._follow, daemon=True)
            self.thread.start()
            return
        # at most 2 batches in flight to the host
        self._readback_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._completer = threading.Thread(target=self._complete, daemon=True)
        self._completer.start()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def sd_for(self, lora):
        """The pipeline for an adapter name (None or "": the base one): one
        whose UNet weights are the merge w + (a @ b) * scale, built once
        and cached (StableDiffusion.with_unet: from sdtpu's unfused tree,
        attn1's q/k/v fused again from the merged weights; the CLIP and VAE
        leaves and the mesh are the base pipeline's). On a mesh each rank
        merges its tp parts (lora.apply_lora)."""
        if not lora:
            return self.sd
        if lora not in self.loras:
            raise ValueError(f"unknown lora {lora!r} (loaded: {sorted(self.loras)})")
        with self._lora_lock:
            sd = self._lora_sd.get(lora)
            if sd is None:
                from sdtpu_torch.lora import apply_lora
                from sdtpu_torch.models.unet import unfuse_qkv
                from sdtpu_torch.parallel import tp as tpc

                tree, scale = self.loras[lora]
                with tpc.use(self.sd.tp), torch.no_grad():
                    sd = self.sd.with_unet(
                        apply_lora(unfuse_qkv(self.sd.params["unet"]), tree, scale))
                self._lora_sd[lora] = sd
            return sd

    def submit(self, prompt, steps, scale, seed, n_images, negative, sampler: str = "ddim",
               karras: bool = False, lora=None):
        """Queue one request and wait for its images ([n, H, W, 3] uint8).
        On a mesh, rank 0's alone."""
        if not self.leader:
            raise RuntimeError(f"on a mesh rank 0 takes the requests; rank {self.mesh.rank} "
                               f"runs what it broadcasts")
        if lora and lora not in self.loras:
            raise ValueError(f"unknown lora {lora!r} (loaded: {sorted(self.loras)})")
        if self.failed:
            raise RuntimeError(f"the mesh failed: {self.failed}")
        # capacity counts the requests really waiting: abandoned holds are
        # purged by the worker and must not refuse new arrivals
        with self._held_lock:
            waiting = sum(1 for it in self._held if not it[-1]["abandoned"])
        if self.queue.qsize() + waiting >= self.max_queue:
            raise Overloaded(f"queue full ({self.max_queue} requests waiting)")
        ev = threading.Event()
        slot = {"abandoned": False}
        self.queue.put((prompt, steps, scale, seed, n_images, negative, sampler, karras, lora,
                        ev, slot))
        if not ev.wait(self.timeout_s):
            slot["abandoned"] = True  # the worker skips or discards it
            raise RequestTimeout(f"no capacity within {self.timeout_s:.0f}s")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["images"]

    def close(self, timeout: float = 30.0) -> None:
        """Stop both threads once the batch in hand is done (on a mesh,
        rank 0's broadcasts the stop). On another rank of a mesh: wait up to
        `timeout` s for that stop to end the follower."""
        if not self.leader:
            self.thread.join(timeout)
            return
        self.queue.put(None)
        self.thread.join(timeout)
        self._completer.join(timeout)

    # ------------------------------------------------------------ worker

    def _key(self, it):
        """What one device batch shares: (n_steps, sampler, karras, lora),
        and without pad_context the token counts of the prompt and of the
        negative prompt, since unpadded contexts stack only at one length."""
        key = (it[1], it[6], it[7], it[8])
        if self.sd.pad_context:
            return key
        n_ctx = self.sd.config.clip.n_ctx
        return key + tuple(min(len(self.tokenizer.encode_prompt(p)), n_ctx)
                           for p in (it[0], it[5]))

    def _collect(self):
        """The next batch's items ([] when every one was abandoned), or None
        when the batcher is closing and nothing is held."""
        with self._held_lock:
            self._held = [it for it in self._held if not it[-1]["abandoned"]]
            items = []
            if self._held:
                # start from the oldest hold and sweep the others for key-mates
                items = [self._held.pop(0)]
                total, key = items[0][4], self._key(items[0])
                still = []
                for it in self._held:
                    if self._key(it) == key and total + it[4] <= self.max_batch:
                        items.append(it)
                        total += it[4]
                    else:
                        still.append(it)
                self._held = still
        if not items:
            if self._closing:
                return None
            it = self.queue.get()
            if it is None:
                return None
            items = [it]
            total, key = it[4], self._key(it)
        deadline = time.monotonic() + self.window_s
        while total < self.max_batch and not self._closing:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                it = self.queue.get(timeout=timeout)
            except queue.Empty:
                break
            if it is None:
                self._closing = True
                break
            if it[-1]["abandoned"]:
                continue
            if self._key(it) == key and total + it[4] <= self.max_batch:
                items.append(it)
                total += it[4]
            else:
                # hold it for a later batch and keep filling this one
                with self._held_lock:
                    self._held.append(it)
        return [it for it in items if not it[-1]["abandoned"]]

    def _worker(self):
        while True:
            items = self._collect()
            if items is None:
                break
            if not items:  # every waiter already timed out
                continue
            try:
                self._run_batch(items)
            except Exception as e:  # a failed batch answers its callers
                _answer(items, f"{type(e).__name__}: {e}")
                if self.mesh is not None:
                    self._end_mesh()
                    break
        if self.failed:
            self._refuse_until_closed()
        elif self.mesh is not None:
            broadcast_object(None, self.mesh)  # the followers' stop
        self._readback_q.put(None)

    def _end_mesh(self):
        """A batch failed on this rank of a mesh: record it and destroy the
        world (the module docstring)."""
        self.failed = traceback.format_exc(limit=1).strip().splitlines()[-1]
        traceback.print_exc()
        if dist.is_initialized():
            dist.destroy_process_group()

    def _refuse_until_closed(self):
        """Rank 0 after the mesh failed: every request held, queued or yet
        to come gets the error, until close()."""
        msg = f"the mesh failed: {self.failed}"
        with self._held_lock:
            held, self._held = self._held, []
        _answer(held, msg)
        while not self._closing:
            it = self.queue.get()
            if it is None:
                break
            _answer([it], msg)

    def _follow(self):
        """A rank but 0 of a mesh: each batch rank 0 broadcasts, run as it
        runs it, until its stop, or until a batch fails here or on another
        rank (the module docstring)."""
        while True:
            try:
                desc = broadcast_object(None, self.mesh)
                if desc is None:
                    break
                self._run(desc)
            except Exception:
                self._end_mesh()
                break

    def _context_cached(self, prompt: str):
        cache = self._ctx_cache
        if prompt in cache:
            cache.move_to_end(prompt)
            return cache[prompt]
        out = self.sd.context(self.tokenizer, prompt)
        cache[prompt] = out
        if len(cache) > self._ctx_cache_size:
            cache.popitem(last=False)
        return out

    def _run_batch(self, items):
        """Run one batch of requests (rank 0's worker): its description,
        broadcast on a mesh, then _run; the images go to the completer."""
        desc = {"steps": items[0][1], "sampler": items[0][6], "karras": items[0][7],
                "lora": items[0][8], "prompts": [it[0] for it in items],
                "negatives": [it[5] for it in items], "scales": [it[2] for it in items],
                # drawn here, so that every rank of a mesh draws the same noise
                "seeds": [_seed(it[3]) for it in items], "counts": [it[4] for it in items]}
        if self.mesh is not None:
            broadcast_object(desc, self.mesh)
        images = self._run(desc)
        done = None
        if images.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(images.device))
        # the worker is free for the next batch while this one is copied
        self._readback_q.put((images, done, items, desc["counts"]))

    def _run(self, desc):
        """The images of one batch description ([sum of counts, H, W, 3]
        uint8 on the device; on a mesh gathered over dp on every rank)."""
        # adapters change only the UNet: the context cache serves them all
        sd = self.sd_for(desc["lora"])
        dev, hw = sd.device, sd.config.latent_size
        ctxs, valids, unctxs, unvalids, scales, latents = [], [], [], [], [], []
        gens = []
        for prompt, negative, scale, seed, n_images in zip(
                desc["prompts"], desc["negatives"], desc["scales"], desc["seeds"],
                desc["counts"]):
            ctx, valid = self._context_cached(prompt)
            unctx, unvalid = self._context_cached(negative)
            gen = _generator(dev, seed)
            gens.append(gen)
            latents.append(torch.randn((n_images, hw, hw, sd.config.unet.in_channels),
                                       generator=gen, device=dev))
            for _ in range(n_images):
                ctxs.append(ctx[0])
                valids.append(valid[0])
                unctxs.append(unctx[0])
                unvalids.append(unvalid[0])
                scales.append(scale)

        b = len(ctxs)
        b_pad = 1 << (b - 1).bit_length()
        if self.mesh is not None:  # sample_latent splits the batch over dp
            b_pad = -(-b_pad // self.mesh.dp) * self.mesh.dp
        pad = b_pad - b
        if pad:
            for lst in (ctxs, valids, unctxs, unvalids, scales):
                lst += [lst[0]] * pad
            latents.append(torch.zeros((pad,) + tuple(latents[0].shape[1:]), device=dev))
        self.batch_sizes[b_pad] += 1
        # euler_a's per-step noise, one draw for the whole batch, continues
        # the first item's generator (a lone request draws what generate()
        # draws)
        latent = sd.sample_latent(
            torch.stack(ctxs), torch.stack(unctxs), torch.tensor(scales, dtype=torch.float32),
            desc["steps"], generator=gens[0], initial_latent=torch.cat(latents, dim=0),
            ctx_valid=torch.stack(valids), uncond_valid=torch.stack(unvalids),
            sampler=desc["sampler"], karras_sigmas=desc["karras"])
        return sd._decode_u8(latent)[:b]

    def _complete(self):
        while True:
            job = self._readback_q.get()
            if job is None:
                break
            images, done, items, counts = job
            try:
                if done is not None:
                    done.synchronize()  # the worker's stream reached the decode's end
                host = images.cpu().numpy()  # one copy to the host for the batch
                i = 0
                for (*_rest, ev, slot), n in zip(items, counts):
                    slot["images"] = host[i:i + n]
                    i += n
                    ev.set()
            except Exception as e:  # the batch's callers get the error
                _answer(items, f"{type(e).__name__}: {e}")


def _answer(items, error: str):
    """Fail each queued item with `error`: its caller's submit raises it."""
    for *_rest, ev, slot in items:
        slot["error"] = error
        ev.set()


def _pngs(imgs, dt):
    from sdtpu_torch.utils.image import encode_png_rgb8

    pngs = [base64.b64encode(encode_png_rgb8(np.asarray(im))).decode() for im in imgs]
    return {"images": pngs, "latency_s": round(dt, 3),
            "images_per_sec": round(len(pngs) / dt, 3)}


def _generate(state, prompt, steps, scale, seed, batch, negative, sampler="ddim",
              karras=False, lora=None):
    t0 = time.perf_counter()
    imgs = state.batcher.submit(prompt, steps, scale, seed, batch, negative, sampler, karras,
                                lora)
    return _pngs(imgs, time.perf_counter() - t0)


def _decode_image(state, b64, batch):
    """A base64 PNG -> [batch, size, size, 3] uint8, center-cropped and
    resized to the model's image size."""
    from sdtpu_torch.dataset import center_crop_resize
    from sdtpu_torch.utils.image import decode_png_rgb8

    img = center_crop_resize(decode_png_rgb8(base64.b64decode(b64)), state.sd.config.image_size)
    return np.tile(img[None], (batch, 1, 1, 1))


def _img2img(state, prompt, init_image_b64, strength, steps, scale, seed, batch, negative,
             sampler="ddim", mask_b64=None, karras=False, lora=None):
    """img2img, or inpainting when mask_b64 (white = regenerate) is given;
    not batched across requests (each carries its own image). state.lock
    runs image requests one at a time; the batcher's worker runs beside
    them."""
    x = _decode_image(state, init_image_b64, batch).astype(np.float32) / 127.5 - 1.0
    sd = state.batcher.sd_for(lora)
    gen = _generator(sd.device, seed)
    t0 = time.perf_counter()
    with state.lock:
        if mask_b64 is not None:
            m = _decode_image(state, mask_b64, batch)
            mask = (m.mean(axis=-1) > 127.5).astype(np.float32)
            imgs = sd.inpaint(state.tokenizer, prompt, x, mask, scale, steps, generator=gen,
                              sampler=sampler, karras_sigmas=karras, negative_prompt=negative)
        else:
            imgs = sd.img2img(state.tokenizer, prompt, x, strength, scale, steps,
                              generator=gen, sampler=sampler, karras_sigmas=karras,
                              negative_prompt=negative)
    return _pngs(imgs, time.perf_counter() - t0)


class Handler(BaseHTTPRequestHandler):
    def _send(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        state = self.server.state
        if self.path == "/healthz":
            self._send(200 if state.ready else 503, {"ready": state.ready})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        state = self.server.state
        if self.path not in ("/generate", "/img2img", "/inpaint"):
            self._send(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            prompt = req["prompt"]
            steps = int(req.get("steps", state.default_steps))
            scale = float(req.get("guidance_scale", state.default_scale))
            seed = req.get("seed")
            batch = int(req.get("n_images", 1))
            negative = req.get("negative_prompt", "")
            sampler = req.get("sampler", "ddim")
            if not (1 <= steps <= 1000) or not (1 <= batch <= 16):
                raise ValueError("steps in [1,1000], n_images in [1,16]")
            if sampler not in SAMPLERS:
                raise ValueError(f"sampler must be {'|'.join(SAMPLERS)}")
            karras = req.get("karras", False)
            if not isinstance(karras, bool):
                # bool("false") is True: refuse what is not a JSON boolean
                raise ValueError("karras must be a JSON boolean")
            if karras and sampler == "ddim":
                raise ValueError("karras needs sampler dpmpp|euler|euler_a|heun")
            lora = req.get("lora") or None  # "" means no adapter
            if lora is not None and lora not in state.batcher.loras:
                raise ValueError(f"unknown lora {lora!r} (loaded: "
                                 f"{sorted(state.batcher.loras)})")
            mask = None
            if self.path in ("/img2img", "/inpaint"):
                init_image = req["init_image"]  # base64 PNG
                strength = float(req.get("strength", 0.75))
                if not (0.0 < strength <= 1.0):
                    raise ValueError("strength in (0,1]")
            if self.path == "/inpaint":
                mask = req["mask"]  # base64 PNG, white = regenerate
            seed = None if seed is None else int(seed)
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        try:
            if self.path in ("/img2img", "/inpaint"):
                self._send(200, _img2img(state, prompt, init_image, strength, steps, scale,
                                         seed, batch, negative, sampler, mask_b64=mask,
                                         karras=karras, lora=lora))
            else:
                self._send(200, _generate(state, prompt, steps, scale, seed, batch, negative,
                                          sampler, karras, lora=lora))
        except Overloaded as e:
            self._send(503, {"error": str(e)})
        except RequestTimeout as e:
            self._send(504, {"error": str(e)})
        except Exception as e:  # the server keeps serving; the caller gets the error
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):  # quiet
        pass


class ServerState:
    """What the handlers of one server share."""

    def __init__(self, sd, tokenizer, batcher, default_steps: int):
        self.sd = sd
        self.tokenizer = tokenizer
        self.batcher = batcher
        self.default_steps = default_steps
        self.default_scale = 7.5
        self.lock = threading.Lock()
        self.ready = False


class Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, state: ServerState):
        super().__init__(address, Handler)
        self.state = state

    def server_close(self):
        super().server_close()
        self.state.batcher.close()


def load_loras(spec: str, device="cpu"):
    """Parse `name=path[,name=path...]` (a bare path is named by its file
    name without .lora.safetensors or .safetensors) into {name: (adapter
    tree on `device`, scale)}."""
    from sdtpu_torch.lora import load_lora

    loras = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" in part:
            name, path = part.split("=", 1)
        else:
            path = part
            name = os.path.basename(path)
            for suffix in (".lora.safetensors", ".safetensors"):
                if name.endswith(suffix):
                    name = name[: -len(suffix)]
                    break
        if name in loras:
            raise ValueError(f"duplicate lora name {name!r}")
        tree, scale, _meta = load_lora(path, device)
        loras[name] = (tree, scale)
    return loras


def make_server(sd, tokenizer, port: int = 8000, warmup: bool = True,
                default_steps: int = 20, max_batch: int = 8, batch_window_ms: float = 15.0,
                max_queue: int = 32, timeout_s: float = 120.0, loras=None) -> Server:
    """A server bound to `port` (0: any free one, see server_address) that
    has run one warm-up request (on the card: the default key's graphs
    captured) and reports ready. Serve with
    serve_forever(); stop with shutdown() and server_close(). sd: a
    pipeline without a mesh (on a mesh, build a Batcher on every rank)."""
    if sd.mesh is not None:
        raise ValueError("make_server serves a pipeline without a mesh: on a mesh every "
                         "rank builds a Batcher, and rank 0 submits")
    batcher = Batcher(sd, tokenizer, max_batch=max_batch, window_ms=batch_window_ms,
                      max_queue=max_queue, timeout_s=timeout_s, loras=loras)
    state = ServerState(sd, tokenizer, batcher, default_steps)
    server = Server(("0.0.0.0", port), state)
    if warmup:
        _generate(state, "warmup", default_steps, 7.5, 0, 1, "")
    state.ready = True
    return server


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    port, steps, preset, bf16, lora_spec = 8000, 20, "sd-v1-4", False, None

    def usage():
        print(f"Usage: {argv[0]} <model_type> <model> [--port N] [--steps N] [--preset P]"
              " [--bf16] [--lora name=A.safetensors,...]", file=sys.stderr)
        sys.exit(1)

    def val(i):  # the value of a --flag; a bare trailing flag prints the usage
        if i + 1 >= len(argv):
            usage()
        return argv[i + 1]

    pos = [argv[0]]
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "--port":
            port = int(val(i))
            i += 2
        elif a == "--steps":
            steps = int(val(i))
            i += 2
        elif a == "--preset":
            preset = val(i)
            i += 2
        elif a == "--lora":
            lora_spec = val(i)
            i += 2
        elif a == "--bf16":
            bf16 = True
            i += 1
        else:
            pos.append(a)
            i += 1
    if len(pos) != 3:
        usage()

    from sdtpu_torch.cli import _select_device, load_model
    from sdtpu_torch.tokenizer import SimpleTokenizer

    print("Loading model...", flush=True)
    sd = load_model(pos[1], pos[2], preset,
                    compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                    device=_select_device(None))
    loras = load_loras(lora_spec, sd.device) if lora_spec else None
    if loras:
        print(f"Loaded LoRA adapters: {sorted(loras)}", flush=True)
    print("Warming up...", flush=True)
    server = make_server(sd, SimpleTokenizer(), port, default_steps=steps, loras=loras)
    print(f"Serving on :{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
