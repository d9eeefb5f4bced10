"""Color glyphs on the port with no font package: COLR v1 paint graphs
(``sfnt.ColrV1Table``, ``colr.ColrV1``), CBLC/CBDT and sbix bitmap strikes
(``sfnt``, ``colr.bitmap_glyph``) and the PNG decoder
(``utils.png.decode_png``), against fontTools, PIL and the JAX package.

The fonts the port ships for color glyphs, ``vello_tpu_torch/assets/fonts/
test/{ColrV1Paints,CbdtStrikes,SbixStrikes}.ttf``, are written by the
font builders of this module with fontTools (and this module's own PNG
encoder): ``PYTHONPATH=. python tests/test_torch_color_glyphs.py`` writes
them again.
"""

import importlib
import io
import math
import os
import pickle
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from test_torch_host import _assert_same
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_text import _build_colr_v1_font, _resolve_both
from vello_tpu_torch import text
from vello_tpu_torch.sfnt import SfntFont
from vello_tpu_torch.utils.png import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
TEST_FONTS = os.path.join(REPO, "vello_tpu_torch", "assets", "fonts", "test")
COLR_FONT = os.path.join(TEST_FONTS, "ColrV1Paints.ttf")
CBDT_FONT = os.path.join(TEST_FONTS, "CbdtStrikes.ttf")
SBIX_FONT = os.path.join(TEST_FONTS, "SbixStrikes.ttf")


# -- a PNG encoder: every color type, bit depth, row filter and Adam7 ---------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(ftype, row, prior, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _pack_row(samples, depth):
    """One row's samples (ints) as bytes, big-endian, bits first-high."""
    if depth == 16:
        return struct.pack(f">{len(samples)}H", *samples)
    if depth == 8:
        return bytes(samples)
    bits = "".join(format(int(v), f"0{depth}b") for v in samples)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def encode_png(samples, ctype, depth, filters=(0, 1, 2, 3, 4),
               interlace=False, plte=None, trns=None, n_idat=1):
    """(H, W, channels) integer samples -> PNG bytes; row y of each
    (sub)image takes ``filters[y % len(filters)]``."""
    samples = np.asarray(samples)
    h, w, channels = samples.shape
    assert channels == CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for y, row in enumerate(sub):
            packed = _pack_row(row.reshape(-1).tolist(), depth)
            prior = prior or bytes(len(packed))
            raw += _filter_row(filters[y % len(filters)], packed, prior, bpp)
            prior = packed
    z = zlib.compress(raw, 9)
    cut = [len(z) * k // n_idat for k in range(n_idat + 1)]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).reshape(-1)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cut, cut[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


# -- the fonts ----------------------------------------------------------------

UPEM = 1000
# head.created and head.modified, fixed so that a rebuild writes the same
# bytes (seconds since 1904: 2026-01-01)
HEAD_TIMESTAMP = 3850156800


def _pen():
    from fontTools.pens.ttGlyphPen import TTGlyphPen
    return TTGlyphPen(None)


def _circle(pen, cx, cy, r, clockwise=True):
    """A circle of eight quadratic arcs (TrueType outer contours run
    clockwise; a hole runs the other way)."""
    k = r / math.cos(math.pi / 8)
    sign = -1 if clockwise else 1
    on = [(cx + r * math.cos(sign * i * math.pi / 4),
           cy + r * math.sin(sign * i * math.pi / 4)) for i in range(8)]
    off = [(cx + k * math.cos(sign * (i + 0.5) * math.pi / 4),
            cy + k * math.sin(sign * (i + 0.5) * math.pi / 4))
           for i in range(8)]
    pen.moveTo(tuple(map(round, on[0])))
    for i in range(8):
        pen.qCurveTo(tuple(map(round, off[i])),
                     tuple(map(round, on[(i + 1) % 8])))
    pen.closePath()


def _polygon(pen, pts):
    pen.moveTo(pts[0])
    for p in pts[1:]:
        pen.lineTo(p)
    pen.closePath()


def _outlines():
    """glyph name -> TrueType glyph: the clip shapes of the paints."""
    def glyph(draw):
        pen = _pen()
        draw(pen)
        return pen.glyph()

    def ring(pen):
        _circle(pen, 500, 400, 440)
        _circle(pen, 500, 400, 200, clockwise=False)

    def band(pen):          # a rainbow's arc: upper half-ring
        _polygon(pen, [(60, 250), (60, 300), (200, 620), (500, 760),
                       (800, 620), (940, 300), (940, 250), (780, 250),
                       (780, 290), (690, 520), (500, 600), (310, 520),
                       (220, 290), (220, 250)])

    def star(pen):
        pts = []
        for i in range(10):
            r = 460 if i % 2 == 0 else 190
            a = math.pi / 2 - i * math.pi / 5
            pts.append((round(500 + r * math.cos(a)),
                        round(380 + r * math.sin(a))))
        _polygon(pen, pts)

    def heart(pen):
        pen.moveTo((500, -20))
        pen.qCurveTo((80, 300), (100, 560))
        pen.qCurveTo((140, 820), (360, 800))
        pen.qCurveTo((460, 780), (500, 660))
        pen.qCurveTo((540, 780), (640, 800))
        pen.qCurveTo((860, 820), (900, 560))
        pen.qCurveTo((920, 300), (500, -20))
        pen.closePath()

    return {
        ".notdef": glyph(lambda p: _polygon(p, [(50, 0), (50, 700),
                                                (450, 700), (450, 0)])),
        "face": glyph(lambda p: _circle(p, 500, 400, 450)),
        "eye_l": glyph(lambda p: _circle(p, 340, 520, 70)),
        "eye_r": glyph(lambda p: _circle(p, 660, 520, 70)),
        "mouth": glyph(lambda p: _polygon(p, [(260, 300), (740, 300),
                                              (640, 160), (500, 110),
                                              (360, 160)])),
        "ring": glyph(ring),
        "band": glyph(band),
        "star": glyph(star),
        "heart": glyph(heart),
        "tri": glyph(lambda p: _polygon(p, [(120, 40), (500, 820),
                                            (880, 40)])),
        "square": glyph(lambda p: _polygon(p, [(100, -20), (100, 820),
                                               (900, 820), (900, -20)])),
        "dot": glyph(lambda p: _circle(p, 500, 400, 110)),
    }


# (code point, glyph name) of the color glyphs, in glyph order
COLR_GLYPHS = (
    (0x1F600, "grin"), (0x1F60D, "heart_eyes"), (0x1F308, "rainbow"),
    (0x2B50, "star_glow"), (0x2764, "red_heart"), (0x1F389, "party"),
    (0x1F31E, "sun_face"), (0x1F535, "blue_disc"), (0x1F369, "donut"),
    (0x1F3AF, "target"))

PALETTE = [(1.0, 0.8, 0.1, 1.0), (0.95, 0.45, 0.05, 1.0),
           (0.25, 0.15, 0.1, 1.0), (0.9, 0.1, 0.2, 1.0),
           (0.2, 0.5, 1.0, 1.0), (0.3, 0.85, 0.35, 1.0),
           (0.6, 0.2, 0.9, 1.0), (1.0, 1.0, 1.0, 0.6),
           (0.05, 0.05, 0.3, 1.0), (1.0, 0.55, 0.7, 1.0)]


def _colr_paints():
    """base glyph name -> paint graph: together every one of the 32 paint
    formats (the Var ones at VarIndexBase 0xFFFFFFFF, no variation), the
    three extends, seven composite modes and PaintColrGlyph reuse."""
    def line(extend, *stops):
        return {"Extend": extend, "ColorStop": [
            {"StopOffset": o, "PaletteIndex": i, "Alpha": a}
            for o, i, a in stops]}

    def var_line(extend, *stops):
        return {"Extend": extend, "ColorStop": [
            {"StopOffset": o, "PaletteIndex": i, "Alpha": a,
             "VarIndexBase": 0xFFFFFFFF} for o, i, a in stops]}

    def glyph(name, paint):
        return {"Format": 10, "Glyph": name, "Paint": paint}

    def solid(i, alpha=1.0, var=False):
        p = {"Format": 3 if var else 2, "PaletteIndex": i, "Alpha": alpha}
        if var:
            p["VarIndexBase"] = 0xFFFFFFFF
        return p

    def comp(mode, src, backdrop):
        return {"Format": 32, "CompositeMode": mode, "SourcePaint": src,
                "BackdropPaint": backdrop}

    V = {"VarIndexBase": 0xFFFFFFFF}
    face = glyph("face", {
        "Format": 6, "ColorLine": line("pad", (0.0, 0, 1.0), (1.0, 1, 1.0)),
        "x0": 420, "y0": 560, "r0": 30, "x1": 500, "y1": 400, "r1": 520})
    return {
        "face_base": face,
        "grin": {"Format": 1, "Layers": [
            {"Format": 11, "Glyph": "face_base"},
            glyph("eye_l", solid(2)),
            glyph("eye_r", solid(2, 0.9, var=True)),
            glyph("mouth", {
                "Format": 4, "ColorLine": line(
                    "reflect", (0.0, 2, 1.0), (0.5, 3, 1.0)),
                "x0": 500, "y0": 300, "x1": 500, "y1": 200, "x2": 600,
                "y2": 300})]},
        "heart_eyes": {"Format": 1, "Layers": [
            {"Format": 11, "Glyph": "face_base"},
            {"Format": 14, "dx": 190, "dy": 400, "Paint": {
                "Format": 16, "scaleX": 0.3, "scaleY": 0.3,
                "Paint": glyph("heart", solid(3))}},
            {"Format": 15, "dx": 510, "dy": 420, **V, "Paint": {
                "Format": 17, "scaleX": 0.3, "scaleY": 0.25, **V,
                "Paint": glyph("heart", solid(3))}},
            glyph("mouth", solid(2))]},
        "rainbow": {"Format": 1, "Layers": [
            glyph("band", {
                "Format": 8, "ColorLine": line(
                    "repeat", (0.0, 3, 1.0), (0.2, 1, 1.0), (0.4, 0, 1.0),
                    (0.6, 5, 1.0), (0.8, 4, 1.0), (1.0, 6, 1.0)),
                "centerX": 500, "centerY": 250, "startAngle": 0.0,
                "endAngle": 90.0}),
            glyph("dot", {
                "Format": 9, "ColorLine": var_line(
                    "reflect", (0.0, 7, 1.0), (1.0, 4, 0.5)),
                "centerX": 500, "centerY": 400, "startAngle": -45.0,
                "endAngle": 315.0, **V})]},
        "star_glow": {"Format": 1, "Layers": [
            glyph("face", solid(8)),
            {"Format": 26, "angle": 12.0, "centerX": 500, "centerY": 380,
             "Paint": glyph("star", {
                 "Format": 5, "ColorLine": var_line(
                     "pad", (0.0, 0, 1.0), (1.0, 1, 1.0)),
                 "x0": 500, "y0": 840, "x1": 500, "y1": -80, "x2": 700,
                 "y2": 840, **V})}]},
        "red_heart": comp("multiply", glyph("heart", {
            "Format": 4, "ColorLine": line(
                "pad", (0.0, 7, 1.0), (1.0, 9, 1.0)),
            "x0": 200, "y0": 800, "x1": 800, "y1": 0, "x2": 200,
            "y2": 0}), glyph("heart", solid(3))),
        "party": {"Format": 1, "Layers": [
            {"Format": 28, "xSkewAngle": 15.0, "ySkewAngle": 0.0,
             "Paint": glyph("tri", {
                 "Format": 8, "ColorLine": line(
                     "pad", (0.0, 0, 1.0), (0.5, 9, 1.0), (1.0, 6, 1.0)),
                 "centerX": 500, "centerY": 40, "startAngle": 0.0,
                 "endAngle": 180.0})},
            {"Format": 29, "xSkewAngle": -10.0, "ySkewAngle": 5.0, **V,
             "Paint": glyph("dot", solid(5))},
            {"Format": 30, "xSkewAngle": 20.0, "ySkewAngle": -10.0,
             "centerX": 300, "centerY": 700,
             "Paint": glyph("dot", solid(4))},
            {"Format": 31, "xSkewAngle": -20.0, "ySkewAngle": 10.0,
             "centerX": 700, "centerY": 700, **V,
             "Paint": glyph("dot", solid(3))}]},
        "sun_face": comp("screen", {
            "Format": 20, "scale": 0.6, "Paint": glyph("face", {
                "Format": 6, "ColorLine": line(
                    "reflect", (0.0, 7, 1.0), (0.5, 0, 0.0)),
                "x0": 500, "y0": 400, "r0": 0, "x1": 500, "y1": 400,
                "r1": 150})}, {"Format": 1, "Layers": [
            {"Format": 22, "scale": 1.1, "centerX": 500, "centerY": 400,
             "Paint": glyph("star", solid(1))},
            {"Format": 23, "scale": 0.8, "centerX": 500, "centerY": 400,
             **V, "Paint": glyph("face", solid(0))},
            {"Format": 21, "scale": 1.0, **V,
             "Paint": glyph("mouth", solid(2))}]}),
        "blue_disc": {"Format": 1, "Layers": [
            {"Format": 12, "Transform": {
                "xx": 1.0, "yx": 0.1, "xy": -0.2, "yy": 0.9, "dx": 40.5,
                "dy": 20.25}, "Paint": glyph("face", {
                    "Format": 7, "ColorLine": var_line(
                        "repeat", (0.0, 4, 1.0), (0.5, 8, 1.0)),
                    "x0": 500, "y0": 400, "r0": 20, "x1": 520, "y1": 420,
                    "r1": 180, **V})},
            {"Format": 13, "Transform": {
                "xx": 0.5, "yx": 0.0, "xy": 0.0, "yy": 0.5, "dx": 250.0,
                "dy": 200.0, **V}, "Paint": glyph("ring", solid(7))}]},
        "donut": {"Format": 1, "Layers": [
            comp("dest_out", glyph("dot", solid(2)), glyph("ring", {
                "Format": 24, "angle": 30.0, "Paint": {
                    "Format": 4, "ColorLine": line(
                        "repeat", (0.0, 9, 1.0), (0.25, 6, 1.0)),
                    "x0": 0, "y0": 0, "x1": 200, "y1": 0, "x2": 0,
                    "y2": 200}})),
            {"Format": 18, "scaleX": 0.5, "scaleY": 0.4, "centerX": 500,
             "centerY": 400, "Paint": glyph("ring", solid(7))},
            {"Format": 19, "scaleX": 0.3, "scaleY": 0.3, "centerX": 500,
             "centerY": 400, **V, "Paint": {
                 "Format": 25, "angle": -20.0, **V,
                 "Paint": glyph("star", solid(5))}}]},
        "target": {"Format": 1, "Layers": [
            comp("xor", glyph("dot", solid(3)), glyph("face", solid(7))),
            comp("plus", glyph("ring", solid(4, 0.5)),
                 glyph("square", solid(8))),
            comp("difference", {
                "Format": 27, "angle": 45.0, "centerX": 500, "centerY": 400,
                **V, "Paint": glyph("tri", solid(0))},
                glyph("dot", solid(9))),
            comp("src_in", glyph("star", solid(5)),
                 glyph("ring", solid(6)))]},
    }


def _font_builder(order, cmap, family, glyf=None):
    """A FontBuilder with the tables every font here has, and glyf (a
    dict of TrueType glyphs) when given; a bitmap-only font has none."""
    from fontTools.fontBuilder import FontBuilder
    fb = FontBuilder(UPEM, isTTF=True)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap(cmap)
    if glyf is not None:
        fb.setupGlyf({name: glyf[name] for name in order})
    else:
        fb.setupMaxp()
    _setup_metrics(fb, order)
    fb.setupHorizontalHeader(ascent=950, descent=-250)
    fb.setupNameTable({"familyName": family, "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=950, sTypoDescender=-250, usWinAscent=950,
                usWinDescent=250)
    fb.setupPost()
    return fb


def _setup_metrics(fb, order, advance=UPEM):
    """hmtx: one advance, each left side bearing the glyph's xMin (a
    glyph set draws an outline shifted by lsb - xMin)."""
    glyf = fb.font.get("glyf")
    lsb = {}
    for name in order:
        g = glyf[name] if glyf is not None else None
        if g is not None and g.numberOfContours:
            g.recalcBounds(glyf)
        lsb[name] = getattr(g, "xMin", 0) if g is not None else 0
    fb.setupHorizontalMetrics({name: (advance, lsb[name]) for name in order})


def build_colr_v1_paints(path):
    """ColrV1Paints.ttf: ten emoji-like COLR v1 glyphs at U+1F600 ...
    (COLR_GLYPHS) over a face_base glyph they reuse (PaintColrGlyph)."""
    outlines = _outlines()
    colored = ["face_base"] + [name for _, name in COLR_GLYPHS]
    order = list(outlines) + colored
    glyf = dict(outlines)
    for name in colored:
        glyf[name] = outlines["face"]
    fb = _font_builder(order, {cp: name for cp, name in COLR_GLYPHS},
                       "ColrV1Paints", glyf)
    fb.setupCOLR(_colr_paints(), version=1)
    fb.setupCPAL([PALETTE])
    fb.font["head"].created = fb.font["head"].modified = HEAD_TIMESTAMP
    fb.save(path)


# -- COLR v1 against fontTools ------------------------------------------------

def _assert_paint_equal(got, ref, tt, where, depth=0, seen=None):
    """The port's paint record against fontTools' decode, field by field
    (``==``, so the same Python numbers): glyph names to ids, enums to
    ints, ColorLines and Affine2x3s by their fields; children recursively
    (once per shared record)."""
    seen = set() if seen is None else seen
    assert got.Format == ref.Format, where
    if id(got) in seen:
        return
    seen.add(id(got))
    names = set(got.field_names)
    ref_names = {c.name for c in ref.getConverters()} - {
        "Format", "VarIndexBase"}
    assert names == ref_names, (where, names, ref_names)
    for name in got.field_names:
        g, r = getattr(got, name), getattr(ref, name)
        at = f"{where}.{name}"
        if name in ("Paint", "SourcePaint", "BackdropPaint"):
            _assert_paint_equal(g, r, tt, at, depth + 1, seen)
        elif name == "Glyph":
            assert g == tt.getGlyphID(r), at
        elif name == "ColorLine":
            assert g.Extend == int(r.Extend), at
            assert len(g.ColorStop) == len(r.ColorStop), at
            for k, (gs, rs) in enumerate(zip(g.ColorStop, r.ColorStop)):
                for f in ("StopOffset", "PaletteIndex", "Alpha"):
                    assert getattr(gs, f) == getattr(rs, f), (at, k, f)
                    assert type(getattr(gs, f)) is type(getattr(rs, f))
        elif name == "Transform":
            for f in ("xx", "yx", "xy", "yy", "dx", "dy"):
                assert getattr(g, f) == getattr(r, f), (at, f)
        else:
            assert g == r, (at, g, r)
            assert type(g) is type(int(r) if name == "CompositeMode"
                                   else r), (at, type(g), type(r))


def _sfnt(path):
    with open(path, "rb") as f:
        return SfntFont(f.read())


# -- the bitmap fonts ---------------------------------------------------------

# (code point, glyph name) of the bitmap glyphs, glyph ids 1-10
BITMAP_GLYPHS = (
    (0x1F600, "grin"), (0x1F534, "red_disc"), (0x2764, "heart"),
    (0x2B50, "star"), (0x1F7E9, "green_square"), (0x1F315, "moon"),
    (0x1F3AF, "target"), (0x1F536, "diamond"), (0x1F30D, "globe"),
    (0x1F4A7, "drop"))


def _shape_alpha(kind, n, ss=4):
    """(n, n) coverage in [0, 1] of an emoji shape, ss x ss supersampled
    (y down, the shape in the unit square)."""
    t = (np.arange(n * ss) + 0.5) / (n * ss)
    v, u = np.meshgrid(t, t, indexing="ij")
    r = np.hypot(u - 0.5, v - 0.5)
    if kind in ("disc", "moon", "globe", "target"):
        m = r < 0.45
        if kind == "moon":
            m &= np.hypot(u - 0.68, v - 0.4) > 0.33
    elif kind == "heart":
        x, y = (u - 0.5) * 2.6, (0.45 - v) * 2.6
        m = (x * x + y * y - 1) ** 3 - x * x * y ** 3 < 0
    elif kind == "star":
        a = np.arctan2(v - 0.52, u - 0.5) + np.pi / 2
        m = r < 0.22 + 0.24 * (np.cos(5 * a) + 1) / 2
    elif kind == "square":
        m = (np.abs(u - 0.5) < 0.42) & (np.abs(v - 0.5) < 0.42)
    elif kind == "diamond":
        m = np.abs(u - 0.5) + np.abs(v - 0.5) < 0.46
    else:                                   # a drop
        m = (r < 0.3) & (v > 0.4) | (np.abs(u - 0.5) < (v - 0.05) * 0.6) \
            & (v < 0.6)
    return m.reshape(n, ss, n, ss).mean(axis=(1, 3))


def _emoji_rgba(name, n):
    """(n, n, 4) uint8 straight RGBA of one bitmap glyph: flat colors,
    a second tone below the middle, anti-aliased edges."""
    kind = {"grin": "disc", "red_disc": "disc", "green_square": "square"
            }.get(name, name)
    color = {"grin": (255, 204, 26), "red_disc": (230, 30, 40),
             "heart": (225, 20, 60), "star": (255, 190, 20),
             "green_square": (60, 200, 80), "moon": (235, 235, 200),
             "target": (240, 240, 240), "diamond": (255, 140, 30),
             "globe": (40, 120, 230), "drop": (60, 170, 250)}[name]
    a = _shape_alpha(kind, n)
    rgb = np.empty((n, n, 3))
    rgb[:] = color
    lower = np.arange(n) >= n * 0.6
    rgb[lower] *= 0.8
    t = (np.arange(n) + 0.5) / n
    v, u = np.meshgrid(t, t, indexing="ij")
    if name == "grin":                       # eyes and a mouth
        eyes = (np.hypot(u - 0.35, v - 0.38) < 0.06) | \
            (np.hypot(u - 0.65, v - 0.38) < 0.06)
        mouth = (np.hypot(u - 0.5, v - 0.55) < 0.22) & (v > 0.58)
        rgb[eyes | mouth] = (70, 40, 20)
    elif name == "target":
        ring = (np.hypot(u - 0.5, v - 0.5) // 0.1) % 2 == 1
        rgb[ring] = (220, 30, 40)
    elif name == "globe":
        land = np.sin(u * 11) * np.cos(v * 7) > 0.3
        rgb[land] = (60, 170, 70)
    out = np.concatenate([rgb, a[..., None] * 255], axis=-1)
    return np.round(out).astype(np.uint8)


def _png_of(rgba, ctype, depth=8, **kw):
    """An RGBA8 picture as a PNG of another color type (the pixels that
    type can hold): RGB and gray composited onto a backdrop, palette and
    low-depth gray quantized, 16 bits widened (v * 257)."""
    rgba = np.asarray(rgba, np.int64)
    a = rgba[..., 3:] / 255.0
    on_white = np.round(rgba[..., :3] * a + 255 * (1 - a)).astype(np.int64)
    gray = np.round(on_white @ np.array([0.299, 0.587, 0.114])).astype(
        np.int64)[..., None]
    if ctype == 6:
        s = rgba
    elif ctype == 2:
        s = on_white
    elif ctype == 4:
        s = np.concatenate([np.round(rgba[..., :3] @ np.array(
            [0.299, 0.587, 0.114]))[..., None].astype(np.int64),
            rgba[..., 3:]], axis=-1)
    elif ctype == 0:
        s = gray >> (8 - depth) if depth < 8 else gray
    else:
        # palette: 4 levels per channel of color and a few alphas
        q = (rgba[..., :3] + 32) // 85
        qa = (rgba[..., 3] + 42) // 85
        keys = (q[..., 0] * 16 + q[..., 1] * 4 + q[..., 2]) * 4 + qa
        uniq, idx = np.unique(keys, return_inverse=True)
        assert len(uniq) <= (1 << depth), len(uniq)
        colors = np.stack([(uniq // 4 // 16) % 4, (uniq // 4 // 4) % 4,
                           (uniq // 4) % 4], axis=-1) * 85
        kw.setdefault("plte", colors)
        alpha = (uniq % 4) * 85
        n_trns = int(np.nonzero(alpha < 255)[0].max()) + 1 \
            if (alpha < 255).any() else 0
        kw.setdefault("trns", bytes(alpha[:n_trns].astype(np.uint8)))
        s = idx.reshape(rgba.shape[:2])[..., None]
    if depth == 16:
        s = s * 257
    return encode_png(s, ctype, depth, **kw)


# the big strike's PNGs, glyph ids 1-10: every color type (palette with
# tRNS, gray with a tRNS key, RGB with one), 1-, 4-, 8- and 16-bit, an
# interlaced one and one split over three IDAT chunks; each cycles its rows
# through filters 0-4
BIG_PNGS = {
    1: dict(ctype=6), 2: dict(ctype=2, trns=struct.pack(">3H", 255, 255,
                                                          255)),
    3: dict(ctype=3), 4: dict(ctype=0, trns=struct.pack(">H", 255)),
    5: dict(ctype=4), 6: dict(ctype=6, depth=16, interlace=True),
    7: dict(ctype=3, depth=4), 8: dict(ctype=6, n_idat=3),
    9: dict(ctype=2, depth=16), 10: dict(ctype=4, depth=16,
                                         interlace=True),
}


def _bitmap_png(gid, ppem, big):
    name = BITMAP_GLYPHS[gid - 1][1]
    spec = dict(BIG_PNGS[gid]) if big else {"ctype": (6, 3, 4)[gid % 3]}
    return _png_of(_emoji_rgba(name, ppem), **spec)


def _metrics(ppem, small):
    """(height, width, bearing x, bearing y, advance) [+ vertical] of a
    ppem x ppem picture whose top is 0.8 ppem above the baseline."""
    hori = (ppem, ppem, ppem // 12, round(0.8 * ppem), ppem + ppem // 6)
    if small:
        return struct.pack(">BBbbB", *hori)
    return struct.pack(">BBbbBbbB", *hori, -(ppem // 2), ppem // 12, ppem)


def _cbdt_record(image_format, png, ppem):
    if image_format == 17:
        return _metrics(ppem, True) + struct.pack(">L", len(png)) + png
    if image_format == 18:
        return _metrics(ppem, False) + struct.pack(">L", len(png)) + png
    return struct.pack(">L", len(png)) + png


# each strike's index subtables: (index format, image format, glyph ids);
# the big strike (ppem 48) holds glyph 1-10 in index formats 1-5 and image
# formats 17-19, the small one (ppem 24) sparse subtables
CBDT_STRIKES = (
    (24, ((4, 17, (1, 3, 5)), (5, 19, (2, 4, 6)),
          (1, 18, (7, 8, 9, 10)))),
    (48, ((1, 17, (1, 2)), (2, 19, (3, 4)), (3, 18, (5, 6)),
          (4, 17, (7, 8)), (5, 19, (9, 10)))),
)


def _cblc_cbdt():
    """CBLC and CBDT (version 3.0) of CBDT_STRIKES, written with struct:
    fontTools compiles neither from scratch."""
    cbdt = bytearray(struct.pack(">HH", 3, 0))
    sizes, arrays = [], []
    array_at = 8 + 48 * len(CBDT_STRIKES)
    for ppem, subtables in CBDT_STRIKES:
        big = ppem == max(p for p, _ in CBDT_STRIKES)
        records, bodies = b"", []
        at = 8 * len(subtables)
        for index_format, image_format, gids in subtables:
            data = [_cbdt_record(image_format, _bitmap_png(g, ppem, big),
                                 ppem) for g in gids]
            if index_format in (2, 5):          # one size for every glyph
                size = max(map(len, data))
                data = [d + bytes(size - len(d)) for d in data]
            image_at = len(cbdt)
            cbdt += b"".join(data)
            offs = np.cumsum([0] + [len(d) for d in data]).tolist()
            body = struct.pack(">HHL", index_format, image_format, image_at)
            if index_format == 1:
                body += struct.pack(f">{len(offs)}L", *offs)
            elif index_format == 3:
                body += struct.pack(f">{len(offs)}H", *offs)
                body += bytes(-len(body) % 4)
            elif index_format == 4:
                body += struct.pack(">L", len(gids)) + b"".join(
                    struct.pack(">HH", g, o) for g, o in
                    zip(list(gids) + [0], offs))
                body += bytes(-len(body) % 4)
            else:
                body += struct.pack(">L", size) + _metrics(ppem, False)
                if index_format == 5:
                    body += struct.pack(f">L{len(gids)}H", len(gids), *gids)
                    body += bytes(-len(body) % 4)
            records += struct.pack(">HHL", gids[0], gids[-1], at)
            at += len(body)
            bodies.append(body)
        arrays.append(records + b"".join(bodies))
        line = struct.pack(">bbBbbbbbbbbb", round(0.8 * ppem),
                           -round(0.2 * ppem), ppem, 0, 0, 0, 0, 0, 0, 0, 0,
                           0)
        sizes.append(struct.pack(">LLLL", array_at, len(arrays[-1]),
                                 len(subtables), 0) + line + line
                     + struct.pack(">HHBBBb", 1, len(BITMAP_GLYPHS), ppem,
                                   ppem, 32, 1))
        array_at += len(arrays[-1])
    cblc = struct.pack(">HHL", 3, 0, len(sizes)) + b"".join(sizes) \
        + b"".join(arrays)
    return cblc, bytes(cbdt)


def _raw_table(tag, data):
    from fontTools.ttLib.tables.DefaultTable import DefaultTable
    t = DefaultTable(tag)
    t.data = data
    return t


def build_cbdt_strikes(path):
    """CbdtStrikes.ttf: a bitmap-only font (no glyf, as Noto's CBTF
    emoji), BITMAP_GLYPHS in two CBDT strikes."""
    order = [".notdef"] + [name for _, name in BITMAP_GLYPHS]
    fb = _font_builder(order, {cp: name for cp, name in BITMAP_GLYPHS},
                       "CbdtStrikes")
    cblc, cbdt = _cblc_cbdt()
    fb.font["CBLC"] = _raw_table("CBLC", cblc)
    fb.font["CBDT"] = _raw_table("CBDT", cbdt)
    fb.font["head"].created = fb.font["head"].modified = HEAD_TIMESTAMP
    fb.save(path)


# sbix: two strikes; glyph 5 is a "dupe" record in the big strike (the
# small strike's png is drawn), glyph 6 is in the small strike only
SBIX_PPEMS = (24, 48)


def _sbix():
    strikes = []
    n = len(BITMAP_GLYPHS) + 1
    for ppem in SBIX_PPEMS:
        big = ppem == max(SBIX_PPEMS)
        records = [b""]                      # .notdef: no record
        for gid in range(1, n):
            ox, oy = gid % 3 - 1, -(ppem // 6) - gid % 2
            if big and gid == 5:
                rec = struct.pack(">hh4sH", ox, oy, b"dupe", 1)
            elif big and gid == 6:
                rec = b""
            else:
                rec = struct.pack(">hh4s", ox, oy, b"png ") + _bitmap_png(
                    gid, ppem, big)
            records.append(rec)
        offs = np.cumsum([4 + 4 * (n + 1)] + [len(r) for r in records])
        strikes.append(struct.pack(">HH", ppem, 72)
                       + struct.pack(f">{n + 1}L", *offs.tolist())
                       + b"".join(records))
    head = 8 + 4 * len(strikes)
    offs = np.cumsum([head] + [len(s) for s in strikes[:-1]]).tolist()
    return (struct.pack(">HHL", 1, 1, len(strikes))
            + struct.pack(f">{len(strikes)}L", *offs) + b"".join(strikes))


def build_sbix_strikes(path):
    """SbixStrikes.ttf: BITMAP_GLYPHS as sbix ``png `` records in two
    strikes, over empty glyf outlines (as Apple's color fonts have)."""
    order = [".notdef"] + [name for _, name in BITMAP_GLYPHS]
    empty = _pen().glyph()
    fb = _font_builder(order, {cp: name for cp, name in BITMAP_GLYPHS},
                       "SbixStrikes", {name: empty for name in order})
    fb.font["sbix"] = _raw_table("sbix", _sbix())
    fb.font["head"].created = fb.font["head"].modified = HEAD_TIMESTAMP
    fb.save(path)


FONT_BUILDERS = {COLR_FONT: build_colr_v1_paints,
                 CBDT_FONT: build_cbdt_strikes, SBIX_FONT: build_sbix_strikes}


# -- the tests ----------------------------------------------------------------

def _fonttools(path):
    pytest.importorskip("fontTools")
    from fontTools.ttLib import TTFont
    return TTFont(path)


@pytest.mark.parametrize("path", sorted(FONT_BUILDERS), ids=os.path.basename)
def test_committed_fonts_are_their_builders_output(path, tmp_path):
    """Each committed font's color tables are what its builder here writes
    (``python tests/test_torch_color_glyphs.py`` rewrites them); each is a
    few kB."""
    out = str(tmp_path / "font.ttf")
    FONT_BUILDERS[path](out)
    got, ref = _sfnt(path), _sfnt(out)
    tags = set(ref.tables) & {"COLR", "CPAL", "CBLC", "CBDT", "sbix", "glyf",
                              "cmap", "hmtx"}
    assert tags and set(got.tables) == set(ref.tables)
    for tag in tags:
        assert got.table(tag) == ref.table(tag), tag
    assert os.path.getsize(path) < 16384


@pytest.fixture(scope="module")
def colr_fonts(tmp_path_factory):
    """The COLR v1 fonts: the committed one, and test_torch_text's."""
    other = str(tmp_path_factory.mktemp("colr1") / "colr1.ttf")
    _build_colr_v1_font(other)
    return {"ColrV1Paints": COLR_FONT, "test_torch_text": other}


def _reachable(table):
    """Every paint of a ColrV1Table reachable from its records."""
    seen, todo = {}, list(table.base.values()) + list(table.layers)
    while todo:
        p = todo.pop()
        if id(p) in seen:
            continue
        seen[id(p)] = p
        todo += [getattr(p, n) for n in ("Paint", "SourcePaint",
                                          "BackdropPaint")
                 if n in p.field_names]
    return list(seen.values())


@pytest.mark.parametrize("name", ["ColrV1Paints", "test_torch_text"])
def test_colr_v1_paints_equal_fonttools(colr_fonts, name):
    """Every paint record (base glyphs, then the LayerList), decoded by
    sfnt.py, equal field by field to fontTools' decode, and the font's
    head bounding box and CPAL to fontTools'."""
    path = colr_fonts[name]
    tt = _fonttools(path)
    sf = _sfnt(path)
    table, ref = sf.colr_v1(), tt["COLR"].table
    base = {tt.getGlyphID(r.BaseGlyph): r.Paint
            for r in ref.BaseGlyphList.BaseGlyphPaintRecord}
    assert set(table.base) == set(base)
    for gid, paint in base.items():
        _assert_paint_equal(table.base[gid], paint, tt, f"base[{gid}]")
    layers = ref.LayerList.Paint if ref.LayerList else []
    assert len(table.layers) == len(layers)
    for i, (got, paint) in enumerate(zip(table.layers, layers)):
        _assert_paint_equal(got, paint, tt, f"layers[{i}]")
    head = tt["head"]
    assert sf.bbox == (head.xMin, head.yMin, head.xMax, head.yMax)
    assert [[(c.red, c.green, c.blue, c.alpha) for c in pal]
            for pal in tt["CPAL"].palettes] == sf.palettes()


def test_colr_v1_font_has_every_paint_format():
    """ColrV1Paints.ttf holds each of the 32 paint formats, the three
    extends, several composite modes and a PaintColrGlyph reuse."""
    table = _sfnt(COLR_FONT).colr_v1()
    paints = _reachable(table)
    assert {p.Format for p in paints} == set(range(1, 33))
    assert {p.ColorLine.Extend for p in paints if "ColorLine"
            in p.field_names} == {0, 1, 2}
    assert len({p.CompositeMode for p in paints if p.Format == 32}) >= 6
    # one PaintColrGlyph record (fontTools shares equal tables), in the
    # layers of two glyphs
    reuse = [i for i, p in enumerate(table.layers) if p.Format == 11]
    assert len(reuse) == 2 and table.layers[reuse[0]].Glyph in table.base


def _color_run(path, chars, px=64.0):
    """A run of a color font's glyphs, one a cell, through each package."""
    def build(pkg):
        t = importlib.import_module(f"{pkg.__name__}.text")
        font = t.Font(path)
        s = pkg.Scene()
        glyphs = [t.Glyph(font.glyph_id(ch), 4.0 + 70.0 * (i % 3),
                          60.0 + 70.0 * (i // 3)) for i, ch in
                  enumerate(chars)]
        (s.draw_glyphs(font).font_size(px).transform(
            pkg.Affine.translate(0.5, 0.25)).draw(pkg.Fill.NON_ZERO,
                                                  glyphs))
        return s
    return build


COLR_CHARS = chip_smoke.PICKERS["color_glyphs"][1]
BITMAP_CHARS = chip_smoke.PICKERS["bitmap_glyphs"][1]


@pytest.mark.parametrize("ch", list(COLR_CHARS), ids=lambda c: f"U+{ord(c):X}")
def test_colr_v1_glyph_resolves_equal_to_jax(ch):
    """Each glyph of ColrV1Paints.ttf through both packages (the JAX
    package's walk reads fontTools): the same ResolvedScene, gradient
    paints, clip and blend layers."""
    rs = _resolve_both(_color_run(COLR_FONT, ch), 80, 80)
    assert rs.layers


def test_color_picker_resolves_equal_to_jax():
    """chip_smoke.py's color_glyphs picker at TEXT_SIZE through both
    packages, and the characters of both pickers are their fonts' color
    glyphs."""
    def build(pkg):
        return chip_smoke.picker_scene(pkg, "color_glyphs",
                                       float(chip_smoke.TEXT_SIZE))
    n = chip_smoke.TEXT_SIZE
    rs = _resolve_both(build, n, n)
    assert len(rs.layers) >= 2 * chip_smoke.PICKER_COLS * \
        chip_smoke.PICKER_ROWS
    colr = text.Font(COLR_FONT).colr_v1()
    assert all(colr.has_glyph(text.Font(COLR_FONT).glyph_id(c))
               for c in COLR_CHARS)
    for name in ("CbdtStrikes.ttf", "SbixStrikes.ttf"):
        font = text.Font(os.path.join(TEST_FONTS, name))
        assert all(font.bitmap_glyph(font.glyph_id(c)) is not None
                   for c in BITMAP_CHARS)


def test_color_picker_frame_near_jax():
    """The color picker at 128 x 128: the port's CPU frame within 1 u8
    level of the JAX package's Renderer frame (JAX_PLATFORMS=cpu)."""
    from vello_tpu.models.renderer import Renderer as JaxRenderer
    n = 128
    frames = []
    for pkg, renderer in ((vello_tpu_torch,
                           vello_tpu_torch.Renderer(device="cpu")),
                          (vello_tpu, JaxRenderer())):
        scene = chip_smoke.picker_scene(pkg, "color_glyphs", float(n))
        frames.append(renderer.render_u8(scene, pkg.RenderParams(
            n, n, base_color=chip_smoke.BASE)))
    got, ref = frames
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1, (int(d.max()), int((d > 1).sum()))
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 100


# -- bitmap strikes -----------------------------------------------------------

def test_cbdt_strikes_equal_fonttools():
    """Each CBLC strike's ppem, and each glyph of its index subtables:
    image format, horizontal metrics (small, big, or for format 19 its
    index's) and PNG bytes, equal to fontTools' decode."""
    tt = _fonttools(CBDT_FONT)
    sf = _sfnt(CBDT_FONT)
    assert sf.loca is None and "glyf" not in sf.tables
    strikes = sf.cbdt_strikes()
    ref = tt["CBLC"].strikes
    assert len(strikes) == len(ref) == 2
    formats = set()
    for strike, rs, data in zip(strikes, ref, tt["CBDT"].strikeData):
        assert (strike.ppem_x, strike.ppem_y) == (
            rs.bitmapSizeTable.ppemX, rs.bitmapSizeTable.ppemY)
        index_metrics = {}
        for sub in rs.indexSubTables:
            formats.add((sub.indexFormat, sub.imageFormat))
            for name in sub.names:
                index_metrics[name] = getattr(sub, "metrics", None)
        assert set(strike.glyphs) == {tt.getGlyphID(n) for n in data}
        for name, g in data.items():
            g.ensureDecompiled()
            got = sf.cbdt_glyph(strike, tt.getGlyphID(name))
            m = getattr(g, "metrics", None) or index_metrics[name]
            hori = ((m.height, m.width, m.BearingX, m.BearingY, m.Advance)
                    if hasattr(m, "BearingX") else
                    (m.height, m.width, m.horiBearingX, m.horiBearingY,
                     m.horiAdvance))
            assert got.image_format == int(type(g).__name__[-2:])
            assert got.metrics == hori, name
            assert got.png == g.imageData, name
    assert {f for f, _ in formats} == {1, 2, 3, 4, 5}
    assert {f for _, f in formats} == {17, 18, 19}


def test_sbix_strikes_equal_fonttools():
    tt = _fonttools(SBIX_FONT)
    strikes = _sfnt(SBIX_FONT).sbix_strikes()
    ref = tt["sbix"].strikes
    assert sorted(strikes) == sorted(ref) == [24, 48]
    for ppem, strike in ref.items():
        got = strikes[ppem]
        kept = {n: g for n, g in strike.glyphs.items() if g.graphicType}
        assert set(got) == {tt.getGlyphID(n) for n in kept}
        for name, g in kept.items():
            mine = got[tt.getGlyphID(name)]
            assert (mine.origin_x, mine.origin_y, mine.graphic_type) == (
                g.originOffsetX, g.originOffsetY, g.graphicType)
            if g.graphicType == "png ":
                assert mine.data == g.imageData


def _bitmap_cases():
    """(font, glyph id, the JAX package raises): the CBDT glyphs in image
    formats 18 and 19 meet the reference's BearingX fault."""
    big = dict(CBDT_STRIKES)[48]
    fmt = {g: image for _, image, gids in big for g in gids}
    return ([(CBDT_FONT, g, fmt[g] != 17) for g in range(1, 11)]
            + [(SBIX_FONT, g, False) for g in range(1, 11)])


@pytest.mark.parametrize("path,gid,faulty", _bitmap_cases(),
                         ids=lambda v: os.path.basename(v)
                         if isinstance(v, str) else str(v))
def test_bitmap_glyph_equals_jax(path, gid, faulty):
    """``bitmap_glyph``: the JAX package's strike choice and values (the
    image's pixels, bearings, ppem). A CBDT glyph of image format 18 or 19
    makes the JAX package raise AttributeError (it reads ``BearingX``, a
    field of format 17's small metrics only): there the port's bearings are
    fontTools' ``horiBearingX/Y`` and its pixels PIL's."""
    from vello_tpu import text as jax_text
    got = text.Font(path).bitmap_glyph(gid)
    assert got is not None and got[0].data.dtype == np.uint8
    if not faulty:
        ref = jax_text.Font(path).bitmap_glyph(gid)
        assert got[1:] == ref[1:]
        assert np.array_equal(got[0].data, ref[0].data)
        assert got[0].quality == ref[0].quality
        return
    with pytest.raises(AttributeError):
        jax_text.Font(path).bitmap_glyph(gid)
    PIL = pytest.importorskip("PIL.Image")
    tt = _fonttools(path)
    name = tt.getGlyphName(gid)
    strike = tt["CBLC"].strikes[1]
    sub = [s for s in strike.indexSubTables if name in s.names][0]
    g = tt["CBDT"].strikeData[1][name]
    g.ensureDecompiled()
    m = getattr(g, "metrics", None) or sub.metrics
    assert got[1:] == (float(m.horiBearingX), float(m.horiBearingY),
                       float(strike.bitmapSizeTable.ppemY))
    ref = np.asarray(PIL.open(io.BytesIO(g.imageData)).convert("RGBA"))
    assert np.array_equal(got[0].data, ref)


def _bitmap_run(path, gids):
    def build(pkg):
        t = importlib.import_module(f"{pkg.__name__}.text")
        font = t.Font(path)
        s = pkg.Scene()
        glyphs = [t.Glyph(g, 4.0 + 40.0 * (i % 3), 40.0 + 40.0 * (i // 3))
                  for i, g in enumerate(gids)]
        (s.draw_glyphs(font).font_size(36.0).transform(
            pkg.Affine.translate(0.25, 0.5)).draw(pkg.Fill.NON_ZERO, glyphs))
        return s
    return build


@pytest.mark.parametrize("path", [CBDT_FONT, SBIX_FONT],
                         ids=os.path.basename)
def test_bitmap_glyphs_resolve_equal_to_jax(path):
    """A run of bitmap glyphs (the CBDT font's format 17 ones, where the
    JAX package draws; every sbix one) through both packages: the same
    ResolvedScene, one image paint a glyph."""
    from vello_tpu_torch.encoding.resolve import PAINT_IMAGE
    gids = ([g for _, image, gids in dict(CBDT_STRIKES)[48] if image == 17
             for g in gids] if path == CBDT_FONT else list(range(1, 11)))
    rs = _resolve_both(_bitmap_run(path, gids), 128, 128)
    assert int((rs.paint_kind == PAINT_IMAGE).sum()) == len(gids)


def test_bitmap_picker_renders_near_its_oracle():
    """chip_smoke.py's bitmap_glyphs picker (CBDT and sbix, every image
    format) at 128 x 128 on the CPU within the corpus bar of the port's
    oracle."""
    from vello_tpu_torch.oracle import OracleRenderer
    scene = chip_smoke.picker_scene(vello_tpu_torch, "bitmap_glyphs", 128.0)
    params = vello_tpu_torch.RenderParams(128, 128,
                                          base_color=chip_smoke.BASE)
    img = vello_tpu_torch.Renderer(device="cpu").render(scene, params)
    ref = OracleRenderer().render(scene, params)
    assert np.abs(img - ref).mean() < chip_smoke.ORACLE_MEAN_TOL
    assert img[..., 0].max() > 0.9


# -- malformed and deep paint graphs ------------------------------------------

def _colr_with(paint_bytes, tmp_path):
    """test_torch_text's COLR v1 font with its COLR table replaced by one
    whose base glyph 'emoji' points at ``paint_bytes``."""
    pytest.importorskip("fontTools")
    from fontTools.ttLib import TTFont
    path = str(tmp_path / "colr1.ttf")
    _build_colr_v1_font(path)
    tt = TTFont(path)
    gid = tt.getGlyphID("emoji")
    base_list = 34
    colr = (struct.pack(">HHLLHLLLLL", 1, 0, 0, 0, 0, base_list, 0, 0, 0, 0)
            + struct.pack(">LHL", 1, gid, 10) + paint_bytes)
    from fontTools.ttLib.tables.DefaultTable import DefaultTable
    t = DefaultTable("COLR")
    t.data = colr
    tt["COLR"] = t
    out = str(tmp_path / "patched.ttf")
    tt.save(out)
    return out


@pytest.mark.parametrize("case", ["unknown_format", "offset_outside",
                                  "null_child", "truncated_stop"])
def test_malformed_colr_raises_value_error(case, tmp_path):
    """Malformed COLR v1 data raises ValueError when the font is drawn;
    the glyph never falls back to its outline."""
    paint = {
        "unknown_format": struct.pack(">B", 33),
        "offset_outside": struct.pack(">B", 14) + (900).to_bytes(3, "big")
        + struct.pack(">hh", 0, 0),
        "null_child": struct.pack(">B", 10) + (0).to_bytes(3, "big")
        + struct.pack(">H", 2),
        "truncated_stop": struct.pack(">B", 4) + (16).to_bytes(3, "big")
        + struct.pack(">6h", 0, 0, 100, 0, 0, 100) + struct.pack(
            ">BH", 0, 3) + struct.pack(">hHh", 0, 0, 16384),
    }[case]
    path = _colr_with(paint, tmp_path)
    font = text.Font(path)
    s = vello_tpu_torch.Scene()
    with pytest.raises(ValueError, match="COLR"):
        (s.draw_glyphs(font).font_size(64.0).draw(
            vello_tpu_torch.Fill.NON_ZERO,
            [text.Glyph(font.glyph_id("A"), 0.0, 60.0)]))


@pytest.mark.parametrize("case", ["cycle", "chain_of_40"])
def test_deep_paint_graphs_stop_where_jax_stops(case, tmp_path):
    """A PaintColrGlyph cycle (a glyph that paints itself inside a clip)
    and a chain of 40 nested PaintTranslates stop at depth 33, as the JAX
    package's walk does: the same ResolvedScene, no error."""
    gid = 1                                   # 'emoji'
    if case == "cycle":
        # PaintColrLayers is not used: PaintGlyph(back) -> PaintColrGlyph
        paint = (struct.pack(">B", 10) + (6).to_bytes(3, "big")
                 + struct.pack(">H", 2) + struct.pack(">BH", 11, gid))
    else:
        paint = b"".join(struct.pack(">B", 14) + (8).to_bytes(3, "big")
                         + struct.pack(">hh", 3, -2) for _ in range(40))
        paint += struct.pack(">BHh", 2, 1, 16384)
    path = _colr_with(paint, tmp_path)

    def build(pkg):
        t = importlib.import_module(f"{pkg.__name__}.text")
        font = t.Font(path)
        s = pkg.Scene()
        (s.draw_glyphs(font).font_size(48.0).draw(
            pkg.Fill.NON_ZERO, [t.Glyph(font.glyph_id("A"), 4.0, 50.0)]))
        return s
    rs = _resolve_both(build, 64, 64)
    assert rs.layers


# -- PNG ----------------------------------------------------------------------

def _png_case(ctype, depth, interlace, seed, size=(13, 9), trns=None,
              plte=None, filters=(0, 1, 2, 3, 4), n_idat=1):
    rng = np.random.default_rng(seed)
    w, h = size
    hi = (1 << depth) if ctype != 3 else min(1 << depth, 6)
    s = rng.integers(0, hi, (h, w, CHANNELS[ctype]))
    if ctype == 3 and plte is None:
        plte = rng.integers(0, 256, (5, 3))   # index 5 lies past PLTE
    if trns == "key":                 # a value the picture holds
        v = s[h // 2, w // 2]
        trns = struct.pack(f">{len(v)}H", *v.tolist())
    return encode_png(s, ctype, depth, filters=filters, interlace=interlace,
                      plte=plte, trns=trns, n_idat=n_idat)


def _png_cases():
    cases = {}
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (False, True):
                cases[f"c{ctype}d{depth}{'i' if interlace else ''}"] = dict(
                    ctype=ctype, depth=depth, interlace=interlace,
                    seed=ctype * 100 + depth)
    for f in range(5):
        cases[f"filter{f}"] = dict(ctype=6, depth=8, interlace=False,
                                   seed=f, filters=(f,))
    cases.update({
        "gray_trns_key": dict(ctype=0, depth=8, interlace=False, seed=1,
                              trns="key"),
        "gray1_trns": dict(ctype=0, depth=1, interlace=False, seed=2,
                           trns=struct.pack(">H", 1)),
        "gray2_trns_zero": dict(ctype=0, depth=2, interlace=True, seed=3,
                                trns=struct.pack(">H", 0)),
        "gray4_trns_unscaled": dict(ctype=0, depth=4, interlace=False,
                                    seed=4, trns=struct.pack(">H", 3)),
        "gray16_trns_255": dict(ctype=0, depth=16, interlace=False, seed=5,
                                trns=struct.pack(">H", 255)),
        "gray16_trns_key": dict(ctype=0, depth=16, interlace=False, seed=6,
                                trns="key"),
        "rgb_trns_key": dict(ctype=2, depth=8, interlace=True, seed=7,
                             trns="key"),
        "rgb16_trns_key": dict(ctype=2, depth=16, interlace=False, seed=8,
                               trns="key"),
        "rgb16_trns_narrow": dict(ctype=2, depth=16, interlace=False,
                                  seed=9, trns=struct.pack(">3H", 1, 2, 3)),
        "palette_trns_short": dict(ctype=3, depth=8, interlace=False,
                                   seed=10, trns=bytes([0, 128])),
        "palette_trns_simple": dict(ctype=3, depth=4, interlace=True,
                                    seed=11, trns=bytes([255, 0, 255])),
        "palette_trns_long": dict(ctype=3, depth=2, interlace=False,
                                  seed=12, trns=bytes([10, 20, 30, 40, 50,
                                                       60, 70])),
        "idat_split": dict(ctype=6, depth=8, interlace=True, seed=13,
                           n_idat=4),
        "one_pixel": dict(ctype=6, depth=16, interlace=True, seed=14,
                          size=(1, 1)),
        "narrow_tall": dict(ctype=3, depth=1, interlace=True, seed=15,
                            size=(3, 17)),
        "wide": dict(ctype=2, depth=8, interlace=False, seed=16,
                     size=(70, 3)),
    })
    return cases


PNG_CASES = _png_cases()


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_decode_png_equals_pil(case):
    """decode_png equals PIL's ``convert("RGBA")`` on PNGs of every color
    type and bit depth, tRNS of every kind (a palette's shorter or longer
    than PLTE, gray and RGB keys, 16-bit ones), each filter, several IDAT
    chunks and Adam7 (the encoder above writes them)."""
    PIL = pytest.importorskip("PIL.Image")
    data = _png_case(**PNG_CASES[case])
    ref = np.asarray(PIL.open(io.BytesIO(data)).convert("RGBA"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), np.argwhere(got != ref)[:5]


@pytest.mark.parametrize("path", [CBDT_FONT, SBIX_FONT],
                         ids=os.path.basename)
def test_decode_png_equals_pil_on_the_fonts(path):
    """Every PNG of the committed bitmap fonts decodes as PIL decodes it."""
    PIL = pytest.importorskip("PIL.Image")
    sf = _sfnt(path)
    pngs = ([sf.cbdt_glyph(st, g).png for st in sf.cbdt_strikes()
             for g in st.glyphs] if path == CBDT_FONT else
            [g.data for st in sf.sbix_strikes().values()
             for g in st.values() if g.graphic_type == "png "])
    assert len(pngs) >= 18
    for data in pngs:
        ref = np.asarray(PIL.open(io.BytesIO(data)).convert("RGBA"))
        assert np.array_equal(decode_png(data), ref)


@pytest.mark.parametrize("ctype,depth", [(2, 4), (6, 2), (3, 16), (5, 8)])
def test_decode_png_names_what_it_cannot_read(ctype, depth):
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 2, 2, depth, ctype, 0, 0, 0)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"color type {ctype} and bit "
                                         f"depth {depth}"):
        decode_png(data)


def test_decode_png_rejects_a_bad_filter():
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 2, 2, 8, 6, 0, 0, 0)) + _chunk(b"IDAT", zlib.compress(
            b"\x00" + bytes(8) + b"\x07" + bytes(8))) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="row filter 7"):
        decode_png(data)


# -- with no font package -----------------------------------------------------

_BLOCKED = """
import pickle
import sys
for name in ("fontTools", "matplotlib", "PIL"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
import chip_smoke
import vello_tpu_torch as vt
out = {{}}
for picker in ("color_glyphs", "bitmap_glyphs"):
    scene = chip_smoke.picker_scene(vt, picker, 128.0)
    params = vt.RenderParams(128, 128, base_color=chip_smoke.BASE)
    out[picker] = (vt.resolve(scene.encoding, params),
                   vt.Renderer(device="cpu").render_u8(scene, params))
out["loaded"] = sorted(m for m, v in sys.modules.items() if v is not None
                       and m.split(".")[0] in ("fontTools", "matplotlib",
                                               "PIL", "jax", "vello_tpu"))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def test_color_fonts_draw_with_no_font_package(tmp_path):
    """In a process that refuses fontTools, matplotlib and PIL, the port
    draws both pickers (COLR v1; CBDT and sbix): the same ResolvedScenes
    and CPU frames as here, and nothing of the three packages loaded."""
    out = str(tmp_path / "out.pkl")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED.format(repo=REPO),
                           out], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        blocked = pickle.load(f)
    assert blocked["loaded"] == []
    params = vello_tpu_torch.RenderParams(128, 128,
                                          base_color=chip_smoke.BASE)
    for picker in ("color_glyphs", "bitmap_glyphs"):
        scene = chip_smoke.picker_scene(vello_tpu_torch, picker, 128.0)
        rs, img = blocked[picker]
        _assert_same(rs, vello_tpu_torch.resolve(scene.encoding, params),
                     "ResolvedScene")
        assert np.array_equal(img, vello_tpu_torch.Renderer(
            device="cpu").render_u8(scene, params))


if __name__ == "__main__":
    os.makedirs(TEST_FONTS, exist_ok=True)
    for path, builder in FONT_BUILDERS.items():
        builder(path)
        print(path, os.path.getsize(path))
