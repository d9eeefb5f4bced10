"""Minimal dependency-free PNG IO (the reference's pixmap PNG role,
``vello_common/src/pixmap.rs``)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def to_rgba8(img: np.ndarray) -> np.ndarray:
    """Premultiplied f32 (H,W,4) -> straight-alpha uint8."""
    if img.dtype == np.uint8:
        return img
    a = np.clip(img[..., 3:4], 0.0, 1.0)
    # Pixels whose alpha quantizes to 0 are invisible; their unpremultiplied
    # color is undefined (0/0) and dividing by a ~1e-5 float-noise alpha
    # amplifies coverage residue into full-brightness rgb-at-alpha-0
    # artifacts that differ per backend/summation order. Emit 0 there.
    vis = a >= (1.0 / 510.0)
    safe = np.where(vis, a, 1.0)
    rgb = np.where(vis, np.clip(img[..., :3] / safe, 0.0, 1.0), 0.0)
    out = np.concatenate([rgb, a], axis=-1)
    return (out * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    rgba = to_rgba8(np.asarray(img))
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read an RGBA8 PNG written by write_png (8-bit, color type 6, no
    interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 6, "only RGBA8 supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 4 + 1
    out = np.empty((h, w, 4), dtype=np.uint8)
    prev = np.zeros(w * 4, dtype=np.uint8)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        ftype = row[0]
        cur = np.frombuffer(row[1:], dtype=np.uint8).copy()
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(4, len(cur)):
                cur[i] = (cur[i] + cur[i - 4]) & 0xFF
        elif ftype == 2:  # Up
            cur = (cur + prev) & 0xFF
        elif ftype == 3:  # Average
            for i in range(len(cur)):
                left = cur[i - 4] if i >= 4 else 0
                cur[i] = (cur[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(len(cur)):
                a = int(cur[i - 4]) if i >= 4 else 0
                b = int(prev[i])
                c = int(prev[i - 4]) if i >= 4 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pr) & 0xFF
        out[y] = cur.reshape(w, 4)
        prev = cur
    return out
