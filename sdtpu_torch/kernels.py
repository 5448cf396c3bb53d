"""Build and bind the hand-written Hopper kernels in `csrc/`.

The sources compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded through
ctypes: one nvcc process per source, all started together, then one link.
The library is built at first use from the sources in the package and
nothing else, into `build/kernels/` at the root of the checkout, under a
name keyed by a hash of the sources and flags: an edited source builds
anew, an unchanged one loads the library already there.

Every C entry launches on the stream it is given, allocates nothing, and
returns cudaGetLastError(); `check` raises on a nonzero code. Pointers and
the stream are passed as ctypes.c_void_p. A wrapper passes the current
stream (`stream`), so a launch made while a CUDA graph is captured on that
stream joins the graph.

Launch accounting (`count`): each wrapper counts its launches, per shape.
While a thread captures a graph (`recording`), its wrappers launch nothing:
their counts go into the capture's record instead, and each replay of the
graph adds the record once (`add_record`), so the counters read what ran.
The record follows the capture's stream too: a train step's backward runs
on autograd's device thread, on the stream of its forward, and its
launches (K9's) join the record of the capture on that stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# dynamic shared memory a block can take on the H100, and its SMs (the
# Hopper kernels' tile plans stay within the one and fill the other)
SMEM_LIMIT = 232448
SM_COUNT = 132

# prologue codes of sdk_gemm (csrc/gemm.cu)
PRO_NONE, PRO_LAYERNORM, PRO_AFFINE, PRO_AFFINE_SILU = 0, 1, 2, 3

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sdk_gemm": [_I, _P, _LL, _LL, _P, _LL, _P, _P, _LL, _LL, _P, _LL, _LL,
                 _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "sdk_gemm_row_tiles": [_I],
    "sdk_row_stats": [_P, _LL, _P, _I, _I, _F, _P],
    "sdk_gemm_sm90": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _LL, _P, _LL, *[_I] * 7, _P],
    "sdk_row_stats_f32": [_P, _LL, _P, _I, _I, _F, _P],
    "sdk_gemm_tf32": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _LL, _P, _LL, *[_I] * 5, _P,
                      *[_I] * 7, _P],
    "sdk_flash_attention_tf32": [*[_P] * 4, *[_LL] * 12, _P, _LL, _P, *[_I] * 5, _F,
                                 *[_I] * 4, _P],
    "sdk_attention_prep_tf32": [*([_P, *[_LL] * 3] * 3), *[_P] * 3, *[_I] * 5, _P],
    "sdk_attention_wide_tf32": [*[_P] * 4, *[_LL] * 12, _P, _LL, _P, *[_I] * 5, _F,
                                *[_I] * 3, _P],
    "sdk_conv": [_I, _P, _I, _LL, _P, _I, _P, _P, _P, _LL, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sdk_group_norm_silu": [_I, _P, _P, _P, _P, _I, _LL, _I, _I, _P],
    "sdk_attention": [_I, _P, _P, _I, _I, _I, _I, _F, _P],
    "sdk_cross_attention": [_I, _P, _P, _P, *[_LL] * 6, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sdk_flash_attention": [_I, _P, _P, _P, _P, *[_LL] * 12, _P, _P, _I, _I, _I, _I, _I, _F,
                            _P],
    "sdk_flash_attention_bwd": [_I, *[_P] * 10, *[_LL] * 6, _I, _I, _I, _I, _I, _F, _P],
    "sdk_flash_attention_bwd_sm90": [*[_P] * 10, *[_LL] * 6, *[_I] * 5, _F, *[_I] * 5, _P],
    "sdk_flash_attention_bwd_tf32": [*[_P] * 13, *[_LL] * 6, *[_I] * 5, _F, *[_I] * 6, _P],
    "sdk_conv3x3_sm90": [*[_P] * 6, _LL, _P, _P, _LL, _I, _P, _P, _P, *[_I] * 10, _P],
    "sdk_conv1x1_sm90": [*[_P] * 5, _LL, _I, _P, _P, _P, *[_I] * 7, _P],
    "sdk_upsample_conv_sm90": [*[_P] * 5, *[_I] * 9, _P],
    "sdk_conv3x3_tf32": [*[_P] * 6, _LL, _P, _P, _LL, _I, _P, _P, _P, *[_I] * 10, _P],
    "sdk_conv1x1_tf32": [*[_P] * 5, _LL, _I, _P, _P, _P, *[_I] * 7, _P],
    "sdk_upsample_conv_tf32": [*[_P] * 5, *[_I] * 9, _P],
    "sdk_attention_sm90": [*[_P] * 4, *[_LL] * 12, _P, _LL, _P, *[_I] * 5, _F, *[_I] * 4, _P],
    "sdk_attention_wide_sm90": [*[_P] * 4, *[_LL] * 12, _P, _LL, _P, *[_I] * 5, _F,
                                *[_I] * 4, _P],
    "sdk_channel_partials": [_I, _P, _P, _I, _I, _I, _I, _P],
    "sdk_channel_stats_sm90": [_I, _P, _P, *[_I] * 5, _P],
    "sdk_error_string": [_I],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsdtpu_kernels_{h.hexdigest()[:16]}.so"


# one build (and one load) at a time in this process: a background build
# (warm.WarmStart) and a first launch never start two nvcc runs
_BUILD_LOCK = threading.RLock()


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns (path, compiler output); the output is empty when nothing was
    built. The output (with ptxas's registers, shared memory and spills per
    kernel) is also kept in a .log beside the library. Thread-safe: a
    second caller waits for the first's build and then finds the library."""
    with _BUILD_LOCK:
        return _build()


def _build() -> tuple[Path, str]:
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tag = out.parent / f"{out.name}.{os.getpid()}"
    objs = [Path(f"{tag}.{f.stem}.o") for f in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for f, o in zip(cu, objs)]
    logs, failed = [], []
    for f, proc in zip(cu, procs):
        logs.append(f"== {f.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{f.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp = Path(f"{tag}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    log = "\n".join(logs)
    out.with_name(out.name + ".log").write_text(log)
    return out, log


@functools.cache
def lib() -> ctypes.CDLL:
    with _BUILD_LOCK:
        return _load()


def _load() -> ctypes.CDLL:
    path, _ = build()
    so = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "sdk_error_string" else ctypes.c_int
    return so


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().sdk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the plain version applies: every tensor lies on the CPU.
    A CUDA tensor means the kernel; any other device, or a CPU/CUDA mix,
    raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernels take CPU or CUDA tensors on one device, got {kinds}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record a forward-only kernel: its output is
    written through ctypes and has no grad_fn, so a backward would leave
    every parameter upstream without a gradient, silently. Only an input
    that requires grad while grad mode is on counts, so inference without
    torch.no_grad() (StableDiffusion.generate) keeps launching."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is forward-only and an input requires grad; run it under "
            "torch.no_grad(), or inside sdtpu_torch.ops.dispatch.training(), whose gates "
            "keep training off forward-only kernels")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# the wrappers that have launched in this process, by name (see count)
LAUNCHED: dict = {}

# the records of the captures open now, by the handle of the stream each
# captures on (see recording)
_BY_STREAM: dict = {}


def current_stream_handle():
    """The handle of this thread's current CUDA stream, or None where CUDA
    has not been initialised (no stream can be capturing)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream().cuda_stream


def _open_record():
    """The record a launch made now joins: that of the capture open on this
    thread's current stream, else None."""
    return _BY_STREAM.get(current_stream_handle()) if _BY_STREAM else None


def count(wrapper, also: str | None = None, **dims) -> None:
    """Record one launch of wrapper's kernel: wrapper.launches += 1, and one
    more in wrapper.shapes under the dimensions that set the launch's work
    ("b=2 s=4096 c=320 ..."), so that a run can be told which shapes it
    launched and how often; the wrapper joins LAUNCHED. also: the name of
    one more counter of the wrapper that this launch adds one to. On a
    thread whose current stream is one that recording() was given, the
    launch goes into that capture's record instead (a captured launch runs
    only when the graph is replayed)."""
    key = " ".join(f"{k}={v}" for k, v in dims.items())
    record = _open_record()
    if record is not None:
        shapes = record.setdefault(wrapper, {})
        shapes[key, also] = shapes.get((key, also), 0) + 1
        return
    _add(wrapper, key, also, 1)


def _add(wrapper, key: str, also: str | None, n: int) -> None:
    wrapper.launches += n
    wrapper.shapes[key] = wrapper.shapes.get(key, 0) + n
    if also is not None:
        setattr(wrapper, also, getattr(wrapper, also) + n)
    LAUNCHED[wrapper.__name__] = wrapper


@contextmanager
def recording(stream: int):
    """Within the block, the count() calls of every thread whose current
    stream is `stream` (the handle of the stream a capture is on,
    current_stream_handle()) fill the yielded record ({wrapper: {(shape
    key, also): launches}}) and leave the counters alone: a graph being
    captured launches nothing. The capturing thread runs on that stream,
    and so does autograd's device thread in a backward of its forward.
    Threads on other streams count as before."""
    if stream in _BY_STREAM:
        raise RuntimeError(f"a capture already records on stream {stream:#x}")
    record: dict = {}
    _BY_STREAM[stream] = record
    try:
        yield record
    finally:
        del _BY_STREAM[stream]


def add_record(record: dict, times: int = 1) -> None:
    """Count `times` runs of a recorded capture: each wrapper's launches and
    per-shape counts go up by the record's, times `times` (a graph replay)."""
    for wrapper, shapes in record.items():
        for (key, also), n in shapes.items():
            _add(wrapper, key, also, n * times)


def gemm(a, w, out, *, M: int, N: int, K: int, batch: int = 1,
         lda: int, a_bs: int = 0, ldw: int, ldo: int, o_bs: int = 0,
         bias=None, res=None, ldr: int = 0, r_bs: int = 0,
         pa=None, pb=None, prologue: int = PRO_NONE, geglu_off: int = 0,
         eps: float = 0.0, stats=None) -> None:
    """Launch the shared GEMM (csrc/gemm.cu) on the current stream.
    a, w, out, res share one dtype; bias, pa, pb, stats are float32.
    The kernel moves 16 bytes at a time: K, N, the leading dimensions and
    geglu_off must be multiples of 8, and the tensors 16-byte aligned."""
    dims = {"K": K, "N": N, "lda": lda, "ldw": ldw, "ldo": ldo, "ldr": ldr,
            "geglu_off": geglu_off}
    bad = [f"{k}={v}" for k, v in dims.items() if v % 8]
    bad += [f"{n} is not 16-byte aligned" for n, t in
            (("a", a), ("w", w), ("out", out), ("res", res))
            if t is not None and t.data_ptr() % 16]
    if bad:
        raise ValueError("sdk_gemm: " + ", ".join(bad))
    rc = lib().sdk_gemm(dtype_code(a), ptr(a), lda, a_bs, ptr(w), ldw, ptr(bias),
                        ptr(out), ldo, o_bs, ptr(res), ldr, r_bs, ptr(pa), ptr(pb),
                        ptr(stats), M, N, K, batch, prologue, geglu_off, eps,
                        stream(a))
    check(rc, "sdk_gemm")


def gemm_row_tiles(m: int) -> int:
    return lib().sdk_gemm_row_tiles(m)


def conv(x, w, out, *, C: int, H: int, W: int, N: int, batch: int, kw: int,
         nphase: int, up: int, bias=None, res=None, pa=None, pb=None,
         prologue: int = PRO_NONE, stats=None, x2=None, C2: int = 0) -> None:
    """Launch the shared GEMM as an implicit-GEMM convolution (sdk_conv in
    csrc/gemm.cu): x [batch, H, W, C] NHWC; optional x2 [batch, H, W, C2],
    the second part of an implicit channel concat (conv3x3 only); w
    [nphase, kw*kw*(C + C2), N]; out and res [batch, H*up, W*up, N]; pa, pb
    [batch, C + C2]. x, x2, w, out, res share one dtype; bias, pa, pb, stats
    are float32. C, C2 and N must be multiples of 8."""
    bad = [f"{k}={v}" for k, v in (("C", C), ("C2", C2), ("N", N)) if v % 8]
    bad += [f"{n} is not 16-byte aligned" for n, t in
            (("x", x), ("x2", x2), ("w", w), ("out", out), ("res", res))
            if t is not None and t.data_ptr() % 16]
    if bad:
        raise ValueError("sdk_conv: " + ", ".join(bad))
    rc = lib().sdk_conv(dtype_code(x), ptr(x), C, H * W * C, ptr(x2), C2, ptr(w), ptr(bias),
                        ptr(out), H * W * up * up * N, ptr(res), ptr(pa), ptr(pb),
                        ptr(stats), H, W, N, batch, kw, nphase, up, prologue,
                        stream(x))
    check(rc, "sdk_conv")
