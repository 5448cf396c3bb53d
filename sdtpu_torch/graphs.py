"""One captured CUDA graph per user action: the port's counterpart of sdtpu's
jax.jit over _sample_latent_impl (the whole N-step sampling loop, the
guidance and the scheduler maths included, one lax.scan), _decode_u8_impl,
_clip_impl and _encode_impl (sdtpu/pipeline.py:35-68), and over the
fine-tuning step (sdtpu/finetune.py's step_jit and the textual-inversion
step: training.run_step).

A Program is one such action, split as a jit splits it: its static
arguments, its inputs (device tensors), and `fn`, which reads only those
inputs and the parameter trees named in `trees`, and does only device work:
no copy from the host, no synchronise, no random draw (the pipeline makes
its schedule tables and draws every random number before; pipeline.py).
GraphCache.run(program):

- on the first call with a key, captures: the inputs are copied into
  static buffers (ordinary device memory), `warm` runs once eagerly on the
  capture stream (one UNet call for the sampler, the whole call for the
  others: cuBLAS's and cuDNN's handles, workspaces and plans, the kernel
  library's build and its first launches, none of which may happen inside
  a capture), then `fn` runs under torch.cuda.graph, under
  torch.no_grad(), with its kernel launches recorded (kernels.recording);
- copies the inputs into the static buffers, replays, adds the recorded
  launches to the kernels' counters (kernels.add_record), and returns a
  clone of the static output, which the next replay overwrites.

A train step (Program(..., step=True)) differs in three ways. Its `fn`
runs with autograd on (the loss's gradients, K9 in the backward, which
runs on autograd's device thread on the capture stream: the launch record
follows that stream, kernels.recording). It updates trees in place (the
trained tree, the optimizer state, the EMA), which the graph reads and
writes by address; its output is the loss. And a warm-up would be a step:
so the first call with a key runs the step itself eagerly on the capture
stream, with its real inputs, as the warm-up, and returns its loss; the
capture follows, which launches nothing and moves no tree; the next call
replays. Its key holds the identity of every tensor of its trees.

A Program computes its key (key()): its static arguments (for the
sampler, every static argument of sdtpu's jit), the shapes and dtypes of
the inputs, the identity of the parameter trees (the entry keeps a
reference to them: a graph reads its weights by address, and no other tree
can take a kept tree's id), and the values, when the key is made, of the
dispatch gates that its model reads (UNET_GATES, VAE_GATES, CLIP_GATES: a
graph captured with a gate open must not replay with it shut, and a gate
that only the UNet reads must not make the decode captured again).

Memory: the graphs of one cache capture into one shared pool
(torch.cuda.graph_pool_handle()). That is safe because replays are
serialised: under the cache's lock, each replay waits on the event that
the previous replay recorded after its output was cloned, so nothing of
one replay is read once the next begins, and a graph's temporaries may be
another graph's. The pool then holds about the largest graph's
activations, not their sum. Each graph records the bytes its capture added
to the pool, and the device bytes its capture took beyond the growth of
PyTorch's allocator (the instantiated graph, where the driver had no freed
memory to reuse).

A cache keeps at most MAX_GRAPHS graphs, the least recently used dropped
first (counted in `evictions`). Past the pool, a graph holds its static
buffers and its instantiated graph, so the bound is set to be out of a
server's reach and still stop growth without end: a served variant (steps,
sampler, Karras sigmas, guidance form, adapter) takes at most four sampler
graphs (batches padded to 1, 2, 4, 8), and a pipeline four decodes and one
CLIP, so 64 holds about a dozen variants at every batch size. Past it,
every miss captures again on the caller's thread (1.5-2.5 s for a 512px
sampler), while the server's queue waits.

Threads: capture_error_mode "thread_local". The server's handler threads
run CUDA work (img2img, a readback) while its batcher captures; "global"
would fail a capture for their calls, "relaxed" would let this thread's
own unsafe calls through. A failed capture or replay raises: nothing falls
back to the eager path.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional

import torch

from sdtpu_torch import kernels

CAPTURE_ERROR_MODE = "thread_local"
MAX_GRAPHS = 64

# the switches each model's call reads (the fused-path gates, module
# constants that tools and tests change at run time; K10's
# SDTPU_FUSED_XATTN; dispatch.training(); PyTorch's TF32 and
# reduced-precision switches): a Program's key holds its model's alone
COMMON_GATES = ("FLASH_MIN_SEQ", "training", "matmul.allow_tf32", "cudnn.allow_tf32",
                "float32_matmul_precision", "matmul.allow_bf16_reduced_precision_reduction")
UNET_GATES = ("FUSED_RES_MIN_ROWS", "FUSED_UP_MIN_ROWS", "FUSED_GN_MIN_ROWS",
              "SDTPU_FUSED_XATTN", *COMMON_GATES)
VAE_GATES = ("FUSED_CONV_MIN_ROWS", "FUSED_UP_MIN_ROWS", "FUSED_GN_MIN_ROWS", *COMMON_GATES)
CLIP_GATES = COMMON_GATES


def gates(names) -> tuple:
    """((name, value), ...) of the named gates, now."""
    from sdtpu_torch.models import unet, vae
    from sdtpu_torch.ops import attention, conv, dispatch, groupnorm

    matmul = torch.backends.cuda.matmul
    values = {"FUSED_RES_MIN_ROWS": unet.FUSED_RES_MIN_ROWS,
              "FUSED_CONV_MIN_ROWS": vae.FUSED_CONV_MIN_ROWS,
              "FUSED_UP_MIN_ROWS": conv.FUSED_UP_MIN_ROWS,
              "FUSED_GN_MIN_ROWS": groupnorm.FUSED_GN_MIN_ROWS,
              "FLASH_MIN_SEQ": attention.FLASH_MIN_SEQ,
              "SDTPU_FUSED_XATTN": unet.xattn_enabled(),
              "training": dispatch.in_training(),
              "matmul.allow_tf32": matmul.allow_tf32,
              "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "float32_matmul_precision": torch.get_float32_matmul_precision(),
              "matmul.allow_bf16_reduced_precision_reduction":
                  matmul.allow_bf16_reduced_precision_reduction}
    return tuple((name, values[name]) for name in names)


def key(kind: str, statics: dict, inputs: dict, trees, gate_names) -> tuple:
    """(kind, statics by name, (name, shape, dtype) of each input, the ids
    of the trees, gates(gate_names))."""
    return (kind, tuple(sorted(statics.items(), key=lambda kv: kv[0])),
            tuple((name, tuple(t.shape), t.dtype) for name, t in sorted(inputs.items())),
            tuple(id(t) for t in trees), gates(gate_names))


@dataclasses.dataclass(eq=False)
class Program:
    """One user action as a graph captures it (see the module docstring).
    `key` is computed from the rest; `warm` is `fn` unless given."""
    kind: str                              # sample | decode | clip | encode | ...
    statics: dict                          # the static arguments, by name
    inputs: dict                           # name -> device tensor
    fn: Callable[[dict], torch.Tensor]     # inputs -> output, device work only
    trees: tuple                           # what fn reads besides its inputs
    gates: tuple                           # the gates its model reads (UNET_GATES, ...)
    warm: Optional[Callable[[dict], object]] = None  # the eager warm-up before a capture
    step: bool = False                     # a train step (see the module docstring)
    key: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        if self.warm is None:
            self.warm = self.fn
        if self.step and self.warm is not self.fn:
            raise ValueError("a train step's warm-up is its first step")
        self.key = key(self.kind, self.statics, self.inputs, self.trees, self.gates)


def key_fields(k: tuple) -> dict:
    """A key as {"kind", each static by name, "inputs", "trees", "gates"}."""
    kind, statics, inputs, trees, gate_values = k
    return {"kind": kind, **dict(statics), "inputs": inputs, "trees": trees,
            "gates": dict(gate_values)}


class Graph:
    """A captured program: the graph, its static inputs and output, the
    launches one replay makes, and what the capture cost."""

    def __init__(self, program: Program, graph, static: dict, output, record: dict,
                 capture_s: float, pool_bytes: int, exec_bytes: int):
        self.kind = program.kind
        self.key = program.key
        self.trees = program.trees  # kept alive while the graph reads them
        self.graph = graph
        self.static = static
        self.output = output
        self.record = record
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.exec_bytes = exec_bytes
        self.replays = 0

    def summary(self) -> dict:
        fields = key_fields(self.key)
        shapes = {name: list(shape) for name, shape, _ in fields["inputs"]}
        return {"kind": self.kind, "inputs": shapes, "capture_s": round(self.capture_s, 4),
                "pool_bytes": self.pool_bytes, "exec_bytes": self.exec_bytes,
                "replays": self.replays,
                "launches": sum(n for shapes in self.record.values() for n in shapes.values())}


class GraphCache:
    """The captured programs of one device (see the module docstring).
    captures, replays and evictions count by kind; warmups holds the launches of the
    warm-ups run before captures, {kernel: {shape: launches}} (real
    launches, counted by the kernels' counters as well)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.lock = threading.Lock()
        self.graphs: "collections.OrderedDict[tuple, Graph]" = collections.OrderedDict()
        self.captures: "collections.Counter" = collections.Counter()
        self.replays: "collections.Counter" = collections.Counter()
        self.evictions: "collections.Counter" = collections.Counter()
        self.warmups: dict = {}
        self._pool = None
        self._stream = None
        self._done = None  # recorded after the last replay's clone

    def run(self, program: Program) -> torch.Tensor:
        """program's output: replayed from its graph, captured first if
        the key is new (a train step's first call: the step run eagerly,
        then the capture); a clone, which no later replay touches."""
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            if program.step and program.key not in self.graphs:
                out = self._first_step(program)
            else:
                g = self._get(program)
                for name, t in program.inputs.items():
                    g.static[name].copy_(t)
                g.graph.replay()
                kernels.add_record(g.record)
                out = g.output.clone()
                g.replays += 1
                self.replays[g.kind] += 1
            self._done = torch.cuda.Event()
            self._done.record(stream)
            return out

    def ensure(self, program: Program) -> Graph:
        """program's graph, captured now if its key is new (nothing replayed;
        not for a train step, whose capture follows its first step)."""
        if program.step:
            raise ValueError("a train step is captured by its first run (GraphCache.run)")
        with self.lock:
            return self._get(program)

    def drop(self, kinds) -> int:
        """Drop every graph of the given kinds (a fine-tuning run's step
        graphs when it ends: they hold its trees); returns how many."""
        with self.lock:
            gone = [k for k, g in self.graphs.items() if g.kind in kinds]
            if gone:
                torch.cuda.synchronize(self.device)  # their last replays have ended
            for k in gone:
                self.graphs.pop(k).graph.reset()
            return len(gone)

    def stats(self) -> dict:
        """captures, replays and evictions by kind, the pool's bytes, each
        graph's summary (least recently used first) and the warm-ups'
        launches."""
        with self.lock:
            return {"captures": dict(self.captures), "replays": dict(self.replays),
                    "evictions": dict(self.evictions),
                    "pool_bytes": self.pool_bytes(),
                    "graphs": [g.summary() for g in self.graphs.values()],
                    "warmup_launches": {name: dict(s) for name, s in self.warmups.items()}}

    def pool_bytes(self) -> int:
        """Device bytes the shared pool's segments hold."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s["device"] == self.device.index
                   and tuple(s.get("segment_pool_id", ())) == pool)

    # ------------------------------------------------------------ capture

    def _get(self, program: Program) -> Graph:
        g = self.graphs.get(program.key)
        if g is not None:
            self.graphs.move_to_end(program.key)
            return g
        t0 = time.perf_counter()
        current = self._prepare()
        static = {name: t.clone() for name, t in program.inputs.items()}
        self._warm(program, static, current)
        return self._capture(program, static, t0)

    def _first_step(self, program: Program) -> torch.Tensor:
        """A train step's first call with its key: the step itself, run
        eagerly on the capture stream as the warm-up, then its capture;
        returns the step's output."""
        current = self._prepare()
        static = {name: t.clone() for name, t in program.inputs.items()}
        out = self._warm(program, static, current).clone()
        # the capture's seconds alone: the step is a step, not an overhead.
        # torch.cuda.graph empties the allocator's cache as it opens: the
        # step's freed blocks go back to the device before the pool grows
        torch.cuda.synchronize(self.device)
        self._capture(program, static, time.perf_counter())
        return out

    def _prepare(self):
        """Room for one more graph (the least recently used dropped), the
        pool and the capture stream made; the current stream."""
        if len(self.graphs) >= MAX_GRAPHS:
            torch.cuda.synchronize(self.device)  # its last replay has ended
            old = self.graphs.popitem(last=False)[1]
            old.graph.reset()
            self.evictions[old.kind] += 1
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.current_stream(self.device)

    @staticmethod
    def _grad(program: Program):
        return torch.enable_grad() if program.step else torch.no_grad()

    def _warm(self, program: Program, static: dict, current):
        """program.warm(static), eagerly on the capture stream: its launches
        are real, counted, and tallied as warm-ups (a train step's are its
        first step's, not tallied); the current stream waits for it.
        Returns its output."""
        self._stream.wait_stream(current)
        with kernels.recording(self._stream.cuda_stream) as warm_record, \
                self._grad(program), torch.cuda.stream(self._stream):
            out = program.warm(static)
        kernels.add_record(warm_record)
        for wrapper, shapes in ({} if program.step else warm_record).items():
            tally = self.warmups.setdefault(wrapper.__name__, {})
            for (shape, _also), n in shapes.items():
                tally[shape] = tally.get(shape, 0) + n
        current.wait_stream(self._stream)
        return out

    def _capture(self, program: Program, static: dict, t0: float) -> Graph:
        """program.fn(static) captured (nothing runs) and kept under its
        key."""
        dev = self.device
        before = self.pool_bytes()
        free, reserved = torch.cuda.mem_get_info(dev)[0], torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with kernels.recording(self._stream.cuda_stream) as record, self._grad(program), \
                torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                 capture_error_mode=CAPTURE_ERROR_MODE):
            output = program.fn(static)
        # what the device lost beyond the allocator's growth: the graph's own,
        # less what the driver reused of graphs freed before
        taken = free - torch.cuda.mem_get_info(dev)[0]
        grown = torch.cuda.memory_reserved(dev) - reserved
        g = Graph(program, graph, static, output, record, time.perf_counter() - t0,
                  self.pool_bytes() - before, taken - grown)
        self.graphs[program.key] = g
        self.captures[g.kind] += 1
        return g
