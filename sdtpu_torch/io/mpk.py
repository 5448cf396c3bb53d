"""Burn NamedMpk (`SDv1-4.mpk`) checkpoint reader and writer (port of
sdtpu/io/mpk.py).

The reference distributes weights as a Burn `NamedMpkFileRecorder::
<FullPrecisionSettings>` record (the reference's src/bin/sample/main.rs:25-34)
and its convert binary emits one (src/bin/convert/main.rs:32-37):
rmp-serde "named" msgpack, where each Rust record struct is a map keyed by
field name. The param tree uses the same field names as the reference's
module structs, so reading an .mpk is a structural transform:

- Param<Tensor> records unwrap ({"id": ..., "param": <tensor>})
- tensor payloads ({"shape": [...], "value"/"bytes": ...}) -> np.ndarray
- gamma/beta -> g/b, weight -> w (conv OIHW -> HWIO), bias -> b
- module hyperparams stored in records (n_head, eps, stride, ...) and
  stateless modules (SILU records) are dropped
- StableDiffusion root: alpha_cumulative_products -> alphas_cumprod,
  diffusion -> unet (the reference's stablediffusion/mod.rs:41-48)

The reader is strict, as sdtpu's: a record shape it does not know raises
MpkFormatError rather than vanish. It returns numpy arrays on the host
(`weights.from_numpy_tree` puts them on a device); an f32 bytes payload
is a view of the file's one buffer where it lies aligned, else one copy.
save_mpk is its inverse and writes the bytes sdtpu's save_mpk writes for
the same tree, streaming each tensor's bytes to the file.

The card's machine does not promise the `msgpack` package, so this module
carries its own codec (pack, packb, unpackb) for the subset rmp-serde's
named records use: maps, arrays, str, bin, nil, bool, integers and floats.
It encodes as msgpack-python's packb(obj, use_bin_type=True) does: the
shortest form of each integer, str8 for short strings, floats as float64.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np

from sdtpu_torch.weights import to_numpy

_DROP_KEYS = {
    "n_head", "n_group", "n_channel", "eps", "epsilon", "stride",
    "kernel_size", "dilation", "groups", "padding", "padding_actual",
    "silu", "silu_in", "silu_out", "silu_embed", "silu_time_embed",
    "silu1", "silu2", "gelu",
}

_RENAME = {
    "gamma": "g",
    "beta": "b",
    "alpha_cumulative_products": "alphas_cumprod",
    "diffusion": "unet",
}


class MpkFormatError(ValueError):
    """An .mpk file that is not msgpack of the supported subset, or a
    subtree that matches no known Burn record shape."""


# ------------------------------------------------------------ msgpack codec

def _pack_len(write, n: int, fix_base, fix_max: int, codes, what: str) -> None:
    """The header of a str, bin, array or map of n items: a fix form
    (fix_base | n, for n <= fix_max) when the type has one, else the first
    of the 8/16/32-bit length codes (None where the type has no such width)
    that holds n."""
    if fix_base is not None and n <= fix_max:
        write(bytes((fix_base | n,)))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            write(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"{what} of {n} items is too long for msgpack")


def _pack_int(write, v: int) -> None:
    if 0 <= v <= 0x7F:
        write(bytes((v,)))
    elif -32 <= v < 0:
        write(struct.pack(">b", v))
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= limit:
                write(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if v >= limit:
                write(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    """Encode obj as msgpack through write(bytes). bytes, bytearray and
    memoryview encode as bin (a memoryview is handed to write as it is, so
    a tensor's bytes reach the file without a copy); str as str, list and
    tuple as array, dict as map."""
    if obj is None:
        write(b"\xc0")
    elif obj is True:
        write(b"\xc3")
    elif obj is False:
        write(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(write, obj)
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(write, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str")
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        _pack_len(write, n, None, 0, (0xC4, 0xC5, 0xC6), "bin")
        write(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(write, len(obj), 0x90, 15, (None, 0xDC, 0xDD), "array")
        for v in obj:
            pack(v, write)
    elif isinstance(obj, dict):
        _pack_len(write, len(obj), 0x80, 15, (None, 0xDE, 0xDF), "map")
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


def packb(obj: Any) -> bytes:
    parts = []
    pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
# the length's format after bin8/16/32, str8/16/32, array16/32, map16/32
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Reader:
    """Decodes one msgpack object from a buffer. bin values are memoryview
    slices of the buffer (bytes where they are map keys, which must hash)."""

    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.mv):
            raise MpkFormatError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if isinstance(k, memoryview):
                k = bytes(k)
            out[k] = self.read()
        return out

    def read(self) -> Any:
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c <= 0x8F:
            return self.map(c & 0x0F)
        if c <= 0x9F:
            return self.array(c & 0x0F)
        if c <= 0xBF:
            return self.str(c & 0x1F)
        if c in _CONSTANTS:
            return _CONSTANTS[c]
        if c in _LENGTHS:
            n = self.unpack(_LENGTHS[c])
            if c <= 0xC6:
                return self.take(n)
            if c <= 0xDB:
                return self.str(n)
            return self.array(n) if c <= 0xDD else self.map(n)
        if c in _SCALARS:
            return self.unpack(_SCALARS[c])
        raise MpkFormatError(f"msgpack type 0x{c:02x} at offset {self.pos - 1} is not "
                             f"in the supported subset (ext types are not)")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise MpkFormatError(f"invalid UTF-8 in a msgpack str: {e}") from None


def unpackb(buf) -> Any:
    """Decode the one msgpack object that fills buf (bytes, bytearray,
    memoryview or a uint8 array); trailing bytes are an error."""
    r = _Reader(buf)
    obj = r.read()
    if r.pos != len(r.mv):
        raise MpkFormatError(f"{len(r.mv) - r.pos} bytes of extra data after the msgpack "
                             f"object")
    return obj


# ------------------------------------------------------------ reader

def _to_tensor(node) -> np.ndarray | None:
    """Recognise burn's tensor-data records."""
    if not isinstance(node, dict):
        return None
    keys = set(node.keys())
    if "shape" not in keys:
        return None
    shape = node["shape"]
    if "value" in keys:
        return np.asarray(node["value"], np.float32).reshape(shape)
    if "bytes" in keys:
        raw = node["bytes"]
        if isinstance(raw, (bytes, bytearray, memoryview)):
            dtype = {"F32": np.float32, "F64": np.float64}.get(
                str(node.get("dtype", "F32")), np.float32
            )
            a = np.frombuffer(raw, dtype=dtype).astype(np.float32, copy=False)
            if not a.flags.aligned:  # a view at an odd offset of the file's buffer
                a = a.copy()
            return a.reshape(shape)
        return np.asarray(raw, np.float32).reshape(shape)
    return None


def _transform(node: Any, path: str = "") -> Any:
    # Param unwrap
    if isinstance(node, dict) and "param" in node and "id" in node:
        return _transform(node["param"], path)

    t = _to_tensor(node)
    if t is not None:
        return t

    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            kpath = f"{path}/{k}"
            if k in _DROP_KEYS:
                continue
            nk = _RENAME.get(k, k)
            tv = _transform(v, kpath)
            if tv is None:
                # a record field not recognised: dropping it silently would
                # corrupt the model, so fail loudly
                raise MpkFormatError(
                    f"unrecognized .mpk record at {kpath!r} "
                    f"(type {type(v).__name__}"
                    + (f", keys {sorted(v)[:6]}" if isinstance(v, dict) else "")
                    + ")")
            if k == "weight":
                if tv.ndim == 4:  # burn Conv2d OIHW -> HWIO
                    tv = np.transpose(tv, (2, 3, 1, 0))
                nk = "w"
            elif k == "bias":
                nk = "b"
            out[nk] = tv
        return out if out else None

    if isinstance(node, (list, tuple)):
        vals = []
        for i, v in enumerate(node):
            tv = _transform(v, f"{path}[{i}]")
            if tv is None:
                raise MpkFormatError(f"unrecognized .mpk list entry at {path}[{i}]")
            vals.append(tv)
        return vals

    if isinstance(node, (int, float)):
        return node
    return None


def load_mpk(path: str) -> dict:
    """SDv1-4.mpk -> the param tree (numpy arrays on the host). Raises
    MpkFormatError on any subtree that matches no known Burn record shape.
    The file is read once into one buffer."""
    raw = unpackb(np.fromfile(path, dtype=np.uint8))
    # Burn wraps the record in {"item": ..., "metadata": ...} in some
    # versions; unwrap if present.
    if isinstance(raw, dict) and "item" in raw:
        raw = raw["item"]
    params = _transform(raw)
    if isinstance(params.get("n_steps"), float):
        params["n_steps"] = int(params["n_steps"])
    params.setdefault("n_steps", 1000)
    return params


# ------------------------------------------------------------ writer

_INV_RENAME = {v: k for k, v in _RENAME.items()}


def _tensor_record(arr: np.ndarray, mode: str):
    a = np.ascontiguousarray(arr.astype(np.float32, copy=False))
    if mode == "bytes":
        return {"shape": list(a.shape), "bytes": memoryview(a).cast("B"), "dtype": "F32"}
    return {"shape": list(a.shape), "value": a.reshape(-1).tolist()}


def _param_record(arr: np.ndarray, pid: int, mode: str):
    """Burn Param<Tensor>: {"id": <ulid-ish string>, "param": <tensor>}."""
    return {"id": f"{pid:026d}", "param": _tensor_record(arr, mode)}


def _emit(node: Any, counter: list, mode: str) -> Any:
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            nk = _INV_RENAME.get(k, k)
            if k == "w":
                arr = to_numpy(v)
                if arr.ndim == 4:  # HWIO -> burn Conv2d OIHW
                    arr = np.transpose(arr, (3, 2, 0, 1))
                counter[0] += 1
                out["weight"] = _param_record(arr, counter[0], mode)
            elif k == "b" and not isinstance(v, dict):
                counter[0] += 1
                out["bias"] = _param_record(to_numpy(v), counter[0], mode)
            elif k == "g" and not isinstance(v, dict):
                counter[0] += 1
                out["gamma"] = _param_record(to_numpy(v), counter[0], mode)
            else:
                out[nk] = _emit(v, counter, mode)
        # norm records: "b" became "bias" above, but burn norms call it
        # "beta": disambiguate by the sibling gamma
        if "gamma" in out and "bias" in out:
            out["beta"] = out.pop("bias")
        return out
    if isinstance(node, (list, tuple)):
        return [_emit(v, counter, mode) for v in node]
    if hasattr(node, "shape"):  # bare tensor (e.g. position_embedding)
        counter[0] += 1
        return _param_record(to_numpy(node), counter[0], mode)
    return node  # scalar hyperparam (n_steps)


def save_mpk(params: dict, path: str, mode: str = "bytes") -> None:
    """Param tree (numpy or torch leaves, any device) -> Burn NamedMpk
    record (the reference convert binary's output format,
    src/bin/convert/main.rs:32-37).

    mode: "bytes" (compact, TensorData-style) or "value" (burn 0.14
    DataSerialize-style flat float list). load_mpk reads both.
    """
    counter = [0]
    item = _emit(params, counter, mode)
    record = {"item": item, "metadata": {"float": "f32", "int": "i64",
                                         "format": "sdtpu-namedmpk"}}
    with open(path, "wb") as f:
        pack(record, f.write)
