"""Minimal dependency-free PNG writer/reader (plays stb_image_write's role).

The reference writes 8-bit RGB PNGs via stb (src/renderer.cpp:19). We encode
the same format with zlib from the stdlib: 8-bit/channel RGB, no interlace,
filter type 0 per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, image_u8: np.ndarray) -> None:
    """Write [H, W, 3] uint8 RGB to `path`."""
    img = np.asarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, RGB
    payload = (
        _PNG_SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(payload)


def read_png(path: str) -> np.ndarray:
    """Read an RGB8 PNG written by write_png (for tests/round-trips)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, *_ = struct.unpack(">IIBBBBB", body)
            if depth != 8 or color != 2:
                raise ValueError("only RGB8 supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        ftype = raw[y * stride]
        row = np.frombuffer(raw[y * stride + 1 : (y + 1) * stride], np.uint8).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported filter {ftype}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(h, w, 3)
