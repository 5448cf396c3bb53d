"""Times reading SD v1.4's npy dump tree in process on this host: np.load
file by file against the native bulk reader into each of its arenas
(runtime.ARENAS), each read with the minor page faults it took.

    python -m sdtpu_torch.runtime.bench_read [--dir DIR] [--threads 8] [--out FILE]

Writes the dump of SD v1.4's random weights (weights.init_params, seed 0,
on the card where there is one, else on the host) under DIR (a new
temporary directory by default, removed after; 4.3 GB), then reads it,
every read against the page cache the write left warm:

- the raw bytes of every file: np.load of each file, then read_files_bulk
  into each arena, in the order A B C D D C B A, so that each variant runs
  once early and once late;
- the whole tree, io.npy_tree.load_stable_diffusion_dump with bulk=False
  and bulk=True, in the order F B B F.

Prints one line a read, the host's transparent-huge-page settings and the
process's peak resident memory; --out also gets them as JSON.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import resource
import shutil
import tempfile
import time

import numpy as np
import torch

from sdtpu_torch import runtime
from sdtpu_torch.config import SD_V1_4
from sdtpu_torch.io.npy_tree import load_stable_diffusion_dump, save_stable_diffusion_dump
from sdtpu_torch.weights import init_params

THP = ("enabled", "defrag", "shmem_enabled")


def _faults() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def _thp() -> dict:
    out = {}
    for name in THP:
        try:
            with open(f"/sys/kernel/mm/transparent_hugepage/{name}") as f:
                out[name] = f.read().strip()
        except OSError:
            out[name] = "not readable"
    return out


def _timed(label: str, fn, rows: list) -> None:
    """Run fn once, dropping what it returns; one row of its seconds and
    minor faults."""
    gc.collect()
    f0, t0 = _faults(), time.perf_counter()
    out = fn()
    seconds, faults = time.perf_counter() - t0, _faults() - f0
    if out is None:
        raise RuntimeError(f"{label}: the read failed")
    del out
    gc.collect()
    rows.append({"read": label, "s": seconds, "minor_faults": faults})
    print(f"bench_read {label}: {seconds:.3f} s, {faults} minor page faults", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="where to write the dump (default: a temp dir)")
    ap.add_argument("--threads", type=int, default=8, help="the bulk reader's threads")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args(argv)

    if not runtime.available():
        raise SystemExit("bench_read: the native runtime does not build or load here")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    root = args.dir or tempfile.mkdtemp(prefix="bench_read_")
    dump = os.path.join(root, "dump")
    try:
        t0 = time.perf_counter()
        params = init_params(SD_V1_4, torch.Generator(device=dev).manual_seed(0), device=dev)
        save_stable_diffusion_dump(params, dump, SD_V1_4)
        del params
        paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(dump) for f in fs
                       if f.endswith(".npy"))
        n_bytes = sum(os.path.getsize(p) for p in paths)
        print(f"bench_read: wrote {len(paths)} files, {n_bytes / 1e9:.3f} GB in "
              f"{time.perf_counter() - t0:.1f} s; transparent huge pages {_thp()}", flush=True)
        raw = {"np.load a file": lambda: [np.load(p) for p in paths]}
        for arena in runtime.ARENAS:
            raw[f"bulk, {arena} arena"] = functools.partial(
                runtime.read_files_bulk, paths, args.threads, arena)
        tree = {
            "load_stable_diffusion_dump, np.load": lambda: load_stable_diffusion_dump(
                dump, SD_V1_4, bulk=False),
            "load_stable_diffusion_dump, bulk": lambda: load_stable_diffusion_dump(
                dump, SD_V1_4, bulk=True),
        }
        rows = []
        for group in (raw, tree):
            order = list(group) + list(group)[::-1]
            for label in order:
                _timed(label, group[label], rows)
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    result = {"files": len(paths), "bytes": n_bytes, "threads": args.threads, "thp": _thp(),
              "peak_rss_bytes": peak, "rows": rows}
    print(f"bench_read: the process's peak resident memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
