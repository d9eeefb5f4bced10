"""Dependency-free PNG IO (the reference's pixmap PNG role,
``vello_common/src/pixmap.rs``): RGBA8 out, and ``decode_png`` in, which
reads every PNG of the specification (color types 0, 2, 3, 4 and 6, bit
depths 1-16, PLTE and tRNS, filters 0-4, Adam7 interlace) into what
``PIL.Image.open(...).convert("RGBA")`` gives."""

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
    """Read a PNG file as (H, W, 4) uint8 RGBA (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (x0, y0, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's pixels as (H, W, 4) uint8 RGBA, equal to what
    ``PIL.Image.open(...).convert("RGBA")`` gives: gray of depth 1, 2 and
    4 scaled to 8 bits (x255, x85, x17), 16-bit samples narrowed to their
    high byte, but 16-bit gray clipped at 255 (PIL's mode I;16); tRNS made
    alpha 0 where PIL's converted value equals the chunk's value (for
    1-bit gray, 0 or 255); a palette index past PLTE black, and past tRNS
    opaque. Raises ValueError for a PNG it cannot read, naming its color
    type and bit depth."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos, idat, header, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length:
            raise ValueError(f"PNG chunk {tag!r} overruns the data")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = payload
        elif tag == b"tRNS":
            trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = header
    what = f"PNG of color type {ctype} and bit depth {depth}"
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"cannot read a {what}")
    if compression or filtering or interlace > 1:
        raise ValueError(f"cannot read a {what} with compression "
                         f"{compression}, filter method {filtering} and "
                         f"interlace {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{what} has no PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{what}: {e}") from e
    channels = _CHANNELS[ctype]
    samples = np.zeros((h, w, channels), np.uint16)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-(pw * channels * depth) // 8)
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise ValueError(f"{what}: the image data is too short")
        rows = _unfilter(raw[pos:pos + size], ph, stride,
                         max(1, channels * depth // 8), what)
        pos += size
        samples[y0::dy, x0::dx] = _unpack(rows, pw, channels, depth)
    return _to_rgba(samples, ctype, depth, plte, trns)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int,
              what: str) -> np.ndarray:
    """The (h, stride) uint8 rows of one (sub)image from its filtered
    bytes: Sub and Up vectorised, Average and Paeth byte by byte."""
    buf = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)          # row -1 of zeros
    for y in range(h):
        ftype, cur, prev = buf[y, 0], buf[y, 1:], out[y]
        if ftype == 0:
            out[y + 1] = cur
        elif ftype == 1:        # Sub: a running sum per byte of a pixel
            out[y + 1] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            out[y + 1] = cur + prev
        elif ftype in (3, 4):
            row = bytearray(cur.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:  # Average
                    row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0      # Paeth
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if pa <= pb and pa <= pc else b if pb <= pc else c
                row[i] = (row[i] + pr) & 0xFF
            out[y + 1] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{what}: row filter {ftype} is not one of 0-4")
    return out[1:]


def _unpack(rows: np.ndarray, w: int, channels: int,
            depth: int) -> np.ndarray:
    """(h, stride) uint8 rows -> (h, w, channels) samples."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        v = rows
    else:                       # 1, 2 or 4 bits, first sample highest
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, -1)[:, :w * channels].reshape(h, w, channels)


def _to_rgba(s: np.ndarray, ctype: int, depth: int, plte, trns) -> np.ndarray:
    """Samples -> RGBA8 the way PIL converts its mode to RGBA."""
    h, w, _ = s.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        colors = np.frombuffer(plte, np.uint8)[:768]
        pal[:len(colors) // 3, :3] = colors[:len(colors) // 3 * 3].reshape(
            -1, 3)
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[s[..., 0]]
    if ctype in (0, 4):
        if depth == 16:
            # PIL: a 16-bit gray is mode I;16, clipped at 255; with alpha,
            # narrowed like the other 16-bit types
            gray = (np.minimum(s[..., 0], 255) if ctype == 0
                    else s[..., 0] >> 8)
        else:
            gray = s[..., 0] * {1: 255, 2: 85, 4: 17, 8: 1}[depth]
        out[..., :3] = gray[..., None]
        if ctype == 4:
            out[..., 3] = s[..., 1] >> 8 if depth == 16 else s[..., 1]
        elif trns is not None and len(trns) >= 2:
            (key,) = struct.unpack_from(">H", trns)
            if depth == 1:
                key = 255 if key else 0
            out[..., 3][gray == key] = 0
        return out
    rgb = s[..., :3] >> 8 if depth == 16 else s[..., :3]
    out[..., :3] = rgb
    if ctype == 6:
        out[..., 3] = s[..., 3] >> 8 if depth == 16 else s[..., 3]
    elif trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack_from(">3H", trns))
        out[..., 3][(rgb == key).all(axis=-1)] = 0
    return out
