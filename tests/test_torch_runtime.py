"""The port's native runtime (sdtpu_torch/runtime: its own copy of
sdtpu/runtime's sources, built by g++ into build/runtime/) against the
Python paths it stands beside and against sdtpu's:

- the BPE fast path equals sdtpu's SimpleTokenizer(use_native=False) on
  tests/test_runtime.py's corpus and on 500 seeded random ASCII strings; a
  prompt that is not ASCII goes through Python, as sdtpu's does;
- the PNG encoder's bytes equal the port's and sdtpu's encode_png_rgb8 on
  seeded images, 1x1 and odd widths among them, and save_png writes them;
- read_files_bulk returns each file's bytes;
- an npy dump tree loaded through the bulk reader equals, leaf by leaf and
  bit for bit, the same tree loaded file by file and sdtpu's
  load_stable_diffusion_dump of it.

The tests skip only where no C++ compiler exists.
"""

import os
import random
import shutil
import string

import numpy as np
import pytest
import torch

from sdtpu_torch import runtime


@pytest.fixture(scope="session")
def lib():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this host")
    path = runtime.build()
    assert path.parent == runtime.BUILD_DIR and path.exists()
    assert runtime.available()
    return runtime


def _corpus():
    """tests/test_runtime.py's cases, then 500 seeded random ASCII strings
    (letters of both cases, digits, punctuation and whitespace)."""
    rng = random.Random(0)
    alphabet = string.ascii_letters + string.digits + " .,!?'\"-()[]{}:;/<>|@#$%^&*"
    cases = [
        "Hello world! <|startoftext|>asdf<|startoftext|>",
        "<|startoftext|>An ancient mossy stone.<|endoftext|>",
        "it's we're I'll they'd you've can't",
        "",
        "    ",
        "...",
        "<|startoftext|><|endoftext|>",
        "a" * 200,
    ] + ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 80)))
         for _ in range(200)]
    r = random.Random(14)
    ascii_ = string.printable  # includes \t \n \r \x0b \x0c
    return cases + ["".join(r.choice(ascii_) for _ in range(r.randint(0, 120)))
                    for _ in range(500)]


def test_native_tokenizer_equals_sdtpus_python_path(lib):
    from sdtpu.tokenizer import SimpleTokenizer as JTokenizer
    from sdtpu_torch.tokenizer import SimpleTokenizer

    nat, py = SimpleTokenizer(), JTokenizer(use_native=False)
    assert nat._native is not None and nat._native.n_vocab == py.n_vocab == 49408
    for text in _corpus():
        assert nat._native.encode(text) == py.encode(text), repr(text)
        assert nat.encode(text) == py.encode(text), repr(text)


def test_non_ascii_falls_back_to_python(lib):
    from sdtpu.tokenizer import SimpleTokenizer as JTokenizer
    from sdtpu_torch.tokenizer import SimpleTokenizer

    nat, py = SimpleTokenizer(), SimpleTokenizer(use_native=False)
    for text in ("naïve café über", "東京の夜", "a photo — 4k"):
        assert nat._native.encode(text) is None
        assert nat.encode(text) == py.encode(text) == JTokenizer(use_native=False).encode(text)
    assert py._native is None


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (33, 17), (64, 64), (5, 301)])
def test_native_png_bytes(lib, shape, tmp_path):
    from sdtpu.utils.image import encode_png_rgb8 as jencode
    from sdtpu_torch.utils.image import decode_png_rgb8, encode_png_rgb8, save_png

    img = np.random.default_rng(shape[1]).integers(0, 256, (*shape, 3)).astype(np.uint8)
    data = lib.png_encode_rgb8(img)
    assert data == encode_png_rgb8(img) == jencode(img)
    np.testing.assert_array_equal(decode_png_rgb8(data), img)
    save_png(img, str(tmp_path / "a.png"))
    assert (tmp_path / "a.png").read_bytes() == data
    with pytest.raises(ValueError):
        lib.png_encode_rgb8(img.astype(np.float32))


@pytest.mark.parametrize("arena", list(runtime.ARENAS))
def test_read_files_bulk(lib, tmp_path, arena):
    r = np.random.default_rng(3)
    want = {}
    for i, n in enumerate([0, 1, 4096, 100003, 7]):
        path = str(tmp_path / f"f{i}.bin")
        data = r.integers(0, 256, n, dtype=np.uint8).tobytes()
        with open(path, "wb") as f:
            f.write(data)
        want[path] = data
    got = lib.read_files_bulk(list(want), n_threads=3, arena=arena)
    assert [bytes(v) for v in got] == list(want.values())
    assert lib.read_files_bulk([str(tmp_path / "missing")], arena=arena) is None


def test_dump_tree_through_the_bulk_reader(lib, tmp_path, monkeypatch):
    from sdtpu.config import SD_TINY as J_TINY
    from sdtpu.io.npy_tree import load_stable_diffusion_dump as jload
    from sdtpu_torch.config import SD_TINY
    from sdtpu_torch.io import npy_tree
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.utils import profiling
    from sdtpu_torch.weights import init_params

    dump = str(tmp_path / "dump")
    npy_tree.save_stable_diffusion_dump(
        init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu"), dump, SD_TINY)
    profiling.REGISTRY.reset()
    bulk = flatten_tree(npy_tree.load_stable_diffusion_dump(dump, SD_TINY))
    assert profiling.REGISTRY.counts.get("bulk_read") == 1
    monkeypatch.setattr(runtime, "available", lambda: False)
    files = flatten_tree(npy_tree.load_stable_diffusion_dump(dump, SD_TINY))
    assert profiling.REGISTRY.counts.get("bulk_read") == 1  # no second bulk read
    ref = flatten_tree(jload(dump, J_TINY))
    assert sorted(bulk) == sorted(files) == sorted(ref)
    for k, v in bulk.items():
        a, b, c = np.asarray(v), np.asarray(files[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape == c.shape, k
        assert np.array_equal(a, b) and np.array_equal(a, c.astype(a.dtype)), k


def test_dump_load_takes_the_read_it_is_asked_for(lib, tmp_path):
    """bulk=False reads file by file and bulk=True through the bulk reader,
    to the same leaves."""
    from sdtpu_torch.config import SD_TINY
    from sdtpu_torch.io import npy_tree
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.utils import profiling
    from sdtpu_torch.weights import init_params

    dump = str(tmp_path / "dump")
    npy_tree.save_stable_diffusion_dump(
        init_params(SD_TINY, torch.Generator().manual_seed(1), device="cpu"), dump, SD_TINY)
    profiling.REGISTRY.reset()
    files = flatten_tree(npy_tree.load_stable_diffusion_dump(dump, SD_TINY, bulk=False))
    assert profiling.REGISTRY.counts.get("bulk_read", 0) == 0
    bulk = flatten_tree(npy_tree.load_stable_diffusion_dump(dump, SD_TINY, bulk=True))
    assert profiling.REGISTRY.counts.get("bulk_read") == 1
    assert sorted(bulk) == sorted(files)
    for k, v in bulk.items():
        assert np.array_equal(np.asarray(v), np.asarray(files[k])), k
