"""PNG encode and decode with numpy and zlib, no PIL (the port's own copy
of sdtpu/utils/image.py, without its native-encoder branch): the card's
machine does not promise PIL. tests/test_torch_finetune.py holds both
directions equal to sdtpu's.
"""

from __future__ import annotations

import struct
import zlib
import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png_rgb8(img: np.ndarray) -> bytes:
    """img: [H, W, 3] uint8 -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def save_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_rgb8(np.ascontiguousarray(img)))


def save_images(images, basepath: str) -> list:
    """Write {basepath}{i}.png for each image of the batch (the reference's
    naming, as sdtpu's save_images). Returns the written paths."""
    paths = []
    for i, img in enumerate(images):
        path = f"{basepath}{i}.png"
        save_png(np.asarray(img), path)
        paths.append(path)
    return paths


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB, non-interlaced, filters 0-4): the
    dataset's images and the golden artifacts."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, w, h, idat = 8, 0, 0, b""
    bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", chunk[:10])
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type != 2:
        raise ValueError(f"only 8-bit RGB PNGs are read, got bit depth {bit_depth}, "
                         f"color type {color_type}")
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        f = raw[p]
        line = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if f == 0:
            cur = line
        elif f == 2:  # Up
            cur = (line + prev) % 256
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:  # Paeth
                    pp = a + b - c
                    pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) % 256
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3)
