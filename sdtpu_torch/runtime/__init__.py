"""The port's native runtime (its own copy of sdtpu/runtime/): a C++
library bound with ctypes, built at first use.

- the CLIP BPE fast path for ASCII prompts (src/tokenizer.cc);
- the PNG RGB8 encoder (src/png.cc, zlib);
- a threaded bulk reader of many files (src/npy_bulk.cc), for the npy
  dump tree.

The library is compiled by g++ (or $CXX) from src/ into `build/runtime/`
at the root of the checkout, under a name keyed by a hash of the sources
and flags, as kernels.py builds the CUDA library: one process compiles,
a changed source builds anew. Every entry point has a pure-Python
counterpart that gives the same result (tokenizer.py, utils/image.py,
io/npy_tree.py), which the callers take where `available()` is False: a
host without a compiler runs the same program.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import mmap
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "runtime"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
LIBS = ("-lz", "-lpthread")

_P, _I, _U64P = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _sources() -> List[Path]:
    return sorted(SRC.glob("*.cc"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsdtpu_runtime_{h.hexdigest()[:16]}.so"


# one build at a time in this process: a background build (warm.WarmStart)
# and a first use never run two compilers on one temporary file
_BUILD_LOCK = threading.Lock()


def build() -> Path:
    """Compile the library unless the one for these sources exists;
    returns its path. Raises RuntimeError with the compiler's output where
    it fails, OSError where there is no compiler. Thread-safe: a second
    caller waits for the first's build and then finds the library."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, *map(str, _sources()), "-o", str(tmp),
           *LIBS]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({run.returncode}):\n"
                           f"{run.stdout}{run.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The bound library, built at first use; None where it cannot be
    built or loaded (the callers then take their Python paths)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        return None
    lib.sdtpu_tokenizer_new.restype = _P
    lib.sdtpu_tokenizer_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.sdtpu_tokenizer_free.restype = None
    lib.sdtpu_tokenizer_free.argtypes = [_P]
    lib.sdtpu_tokenizer_vocab_size.restype = _I
    lib.sdtpu_tokenizer_vocab_size.argtypes = [_P]
    lib.sdtpu_tokenizer_encode.restype = _I
    lib.sdtpu_tokenizer_encode.argtypes = [_P, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                                           _I]
    lib.sdtpu_png_encode_rgb8.restype = _I
    lib.sdtpu_png_encode_rgb8.argtypes = [_U8P, _I, _I, ctypes.POINTER(_U8P),
                                          ctypes.POINTER(ctypes.c_size_t)]
    lib.sdtpu_free.restype = None
    lib.sdtpu_free.argtypes = [_P]
    lib.sdtpu_file_sizes.restype = _I
    lib.sdtpu_file_sizes.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I, _U64P]
    lib.sdtpu_read_files.restype = _I
    lib.sdtpu_read_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I,
                                     ctypes.POINTER(_U8P), _U64P, _I]
    return lib


def available() -> bool:
    """The library is built (or builds now) and loads."""
    return _lib() is not None


class NativeTokenizer:
    """The ASCII fast path of the CLIP BPE encoder over the merges file's
    text. encode() returns None for input it does not take (non-ASCII), and
    the caller falls back to Python."""

    def __init__(self, merges_text: bytes):
        lib = _lib()
        if lib is None:
            raise RuntimeError("the native runtime is not built")
        self._lib = lib
        self._h = lib.sdtpu_tokenizer_new(merges_text, len(merges_text))
        if not self._h:
            raise RuntimeError("native tokenizer init failed")

    @property
    def n_vocab(self) -> int:
        return self._lib.sdtpu_tokenizer_vocab_size(self._h)

    def encode(self, text: str) -> Optional[List[int]]:
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        cap = max(256, 4 * len(raw) + 16)
        buf = (ctypes.c_uint32 * cap)()
        n = self._lib.sdtpu_tokenizer_encode(self._h, raw, buf, cap)
        if n < 0:
            return None
        return list(buf[:n])

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sdtpu_tokenizer_free(h)
            self._h = None


def png_encode_rgb8(img: np.ndarray) -> Optional[bytes]:
    """img [H, W, 3] uint8 -> PNG bytes (filter 0 on every row, zlib level
    6: the bytes of utils/image.encode_png_rgb8); None without the
    library."""
    lib = _lib()
    if lib is None:
        return None
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    h, w, _ = img.shape
    out, out_len = _U8P(), ctypes.c_size_t()
    rc = lib.sdtpu_png_encode_rgb8(img.ctypes.data_as(_U8P), h, w, ctypes.byref(out),
                                   ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"native PNG encoder failed ({rc}) on {img.shape}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.sdtpu_free(out)


# read_files_bulk's arenas: name -> (mmap flags, advised MADV_HUGEPAGE)
ARENAS = {
    "huge": (mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS, True),
    "private": (mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS, False),
    "shared": (mmap.MAP_SHARED | mmap.MAP_ANONYMOUS, False),
}


def read_files_bulk(paths: List[str], n_threads: int = 8,
                    arena: str = "huge") -> Optional[List[memoryview]]:
    """Every file of `paths` read by `n_threads` threads at once: a
    memoryview of each file's bytes, in order, all into one anonymous mmap
    arena that each view keeps alive. None without the library or where a
    file could not be opened or read whole.

    sdtpu's reader (SD v1 scale: 2,793 files, 4.3 GB), which avoids a
    ctypes buffer a file, copied out. The arena (ARENAS) is private
    anonymous memory advised MADV_HUGEPAGE ("huge"), as numpy advises an
    array of 4 MiB or more, so np.load's arrays: the threads' first touches
    fault 2 MiB pages where the host's transparent huge pages allow it.
    "private" leaves it 4 KiB pages; "shared" is sdtpu's mmap.mmap(-1, n),
    shared anonymous memory, which the kernel keeps in shmem: 4 KiB pages
    (shmem_enabled rules it, whatever the advice), each fault dearer."""
    lib = _lib()
    if lib is None:
        return None
    flags, huge = ARENAS[arena]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lens = (ctypes.c_uint64 * n)()
    lib.sdtpu_file_sizes(c_paths, n, lens)
    sizes = [int(lens[i]) for i in range(n)]
    # a missing file also reads as size 0
    arena_map = mmap.mmap(-1, max(sum(sizes), 1), flags=flags)
    if huge:
        arena_map.madvise(mmap.MADV_HUGEPAGE)
    base = ctypes.addressof(ctypes.c_char.from_buffer(arena_map))
    bufs = (_U8P * n)()
    offsets, off = [], 0
    for i, s in enumerate(sizes):
        offsets.append(off)
        bufs[i] = ctypes.cast(base + off, _U8P)
        off += s
    if lib.sdtpu_read_files(c_paths, n, bufs, lens, n_threads) != n:
        return None
    view = memoryview(arena_map)
    return [view[o:o + s] for o, s in zip(offsets, sizes)]
