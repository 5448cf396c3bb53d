"""Debug invariants (port of sdtpu/utils/debug.py).

- `assert_finite(tree, name)`: a NaN/Inf check over every floating leaf of
  a tree of dicts, lists and tensors (or arrays), on the host
- `checked(fn)`: wraps a function with the same check on its output when
  SDTPU_DEBUG_NANS is set to another value than "0", "" or "false" (the
  function itself otherwise, at no cost)
- `shape_check(x, expect)`: an explicit shape invariant with a readable
  error (None in `expect` matches any size)
"""

from __future__ import annotations

import os

import numpy as np
import torch


def debug_enabled() -> bool:
    return os.environ.get("SDTPU_DEBUG_NANS", "0") not in ("0", "", "false")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if torch.is_tensor(leaf):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    a = np.asarray(leaf)
    return a.dtype.kind != "f" or bool(np.isfinite(a).all())


def assert_finite(tree, name: str = "tree") -> None:
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def checked(fn):
    """In debug mode, fn with a NaN/Inf check on its output."""
    if not debug_enabled():
        return fn

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if not all(_finite(leaf) for _, leaf in _leaves(out)):
            raise FloatingPointError("NaN detected")
        return out

    return wrapped


def shape_check(x, expect, name: str = "tensor") -> None:
    shape = tuple(x.shape)
    assert len(shape) == len(expect) and all(
        e is None or s == e for s, e in zip(shape, expect)
    ), f"{name}: expected shape {expect}, got {shape}"
