"""COLR v1 paint-graph rendering and bitmap (CBDT/sbix) glyphs.

The reference covers these via skrifa + the color-glyph adapters in
``vello/src/scene.rs:957-1131`` (COLR painting: clip to glyph, paint
solids/gradients through the transform stack, composite groups) and the
glifo bitmap strikes. Here the COLR v1 paint graph is walked once per
glyph and emitted as ordinary scene ops — fills, gradients, clip layers
(which the layered compositor's clip-chain collapse keeps cheap), and
blend layers for composite modes.

All coordinates stay in glyph space (y-up font units); the caller's
glyph transform maps them to device space. Both read the font through the
port's own ``sfnt.py`` (the paint records under fontTools' field names,
glyphs by id) and decode PNGs with ``utils.png.decode_png``: no font or
image package.
"""

from __future__ import annotations

import math
from typing import Optional

from .kurbo import Affine, BezPath, rect_path
from .peniko import (BlendMode, Color, Compose, Extend, Fill, Gradient,
                     Image, ImageQuality, Mix, stops)
from .utils.png import decode_png

# OT CompositeMode -> (Mix, Compose); unlisted modes fall back to src-over
# (the JAX package's map, with OpenType's modes 5-9 mismatched: kept, so
# that the scenes match; ROADMAP §3)
_COMPOSITE_MAP = {
    3: (Mix.NORMAL, Compose.SRC_OVER),
    6: (Mix.NORMAL, Compose.SRC_IN),
    8: (Mix.NORMAL, Compose.SRC_ATOP),
    10: (Mix.NORMAL, Compose.DEST_ATOP),
    11: (Mix.NORMAL, Compose.XOR),
    12: (Mix.NORMAL, Compose.PLUS),
    13: (Mix.SCREEN, Compose.SRC_OVER),
    14: (Mix.OVERLAY, Compose.SRC_OVER),
    15: (Mix.DARKEN, Compose.SRC_OVER),
    16: (Mix.LIGHTEN, Compose.SRC_OVER),
    17: (Mix.COLOR_DODGE, Compose.SRC_OVER),
    18: (Mix.COLOR_BURN, Compose.SRC_OVER),
    19: (Mix.HARD_LIGHT, Compose.SRC_OVER),
    20: (Mix.SOFT_LIGHT, Compose.SRC_OVER),
    21: (Mix.DIFFERENCE, Compose.SRC_OVER),
    22: (Mix.EXCLUSION, Compose.SRC_OVER),
    23: (Mix.MULTIPLY, Compose.SRC_OVER),
    24: (Mix.HUE, Compose.SRC_OVER),
    25: (Mix.SATURATION, Compose.SRC_OVER),
    26: (Mix.COLOR, Compose.SRC_OVER),
    27: (Mix.LUMINOSITY, Compose.SRC_OVER),
}

_EXTEND = {0: Extend.PAD, 1: Extend.REPEAT, 2: Extend.REFLECT}


class ColrV1:
    """COLR v1 renderer for one font (lazily built)."""

    def __init__(self, font):
        self.font = font
        table = font.sfnt.colr_v1()
        self.palettes = font.sfnt.palettes()
        self.base = table.base          # glyph id -> root paint
        self.layers = table.layers
        self.bbox = font.sfnt.bbox

    def has_glyph(self, gid: int) -> bool:
        return gid in self.base

    def _color(self, palette_ix: int, alpha: float,
               foreground: Color) -> Color:
        if palette_ix == 0xFFFF:
            c = foreground
        else:
            if palette_ix >= len(self.palettes[0]):
                raise ValueError(f"COLR: palette index {palette_ix} past "
                                 f"CPAL's {len(self.palettes[0])} entries")
            r, g, b, a = self.palettes[0][palette_ix]
            c = Color(r / 255.0, g / 255.0, b / 255.0, a / 255.0)
        return c.multiply_alpha(alpha)

    def _stops(self, color_line, foreground: Color):
        return stops(*[(s.StopOffset,
                        self._color(s.PaletteIndex, s.Alpha, foreground))
                       for s in color_line.ColorStop])

    def _fill_rect(self) -> BezPath:
        x0, y0, x1, y1 = self.bbox
        pad = 0.1 * max(x1 - x0, y1 - y0, 1)
        return rect_path(x0 - pad, y0 - pad, x1 + pad, y1 + pad)

    def emit(self, scene, gid: int, transform: Affine,
             foreground: Color) -> bool:
        """Emit the glyph's paint graph into the scene. transform maps
        glyph space (font units, y-up) to device space."""
        paint = self.base.get(gid)
        if paint is None:
            return False
        # whole-glyph clip so unbounded fills never leak
        scene.push_clip_layer(transform, self._fill_rect())
        self._paint(scene, paint, transform, foreground, 0)
        scene.pop_layer()
        return True

    def _paint(self, scene, p, t: Affine, fg: Color, depth: int) -> None:
        if depth > 32:
            return
        f = p.Format
        if f == 1:      # PaintColrLayers
            lo = p.FirstLayerIndex
            for i in range(p.NumLayers):
                self._paint(scene, self.layers[lo + i], t, fg, depth + 1)
        elif f in (2, 3):    # PaintSolid
            scene.fill(Fill.NON_ZERO, t,
                       self._color(p.PaletteIndex, p.Alpha, fg), None,
                       self._fill_rect())
        elif f in (4, 5):    # PaintLinearGradient
            g = Gradient.linear((p.x0, p.y0), (p.x1, p.y1),
                                self._stops(p.ColorLine, fg),
                                _EXTEND.get(int(p.ColorLine.Extend), 0))
            scene.fill(Fill.NON_ZERO, t, g, None, self._fill_rect())
        elif f in (6, 7):    # PaintRadialGradient (two-point)
            g = Gradient.radial((p.x1, p.y1), float(p.r1),
                                self._stops(p.ColorLine, fg),
                                _EXTEND.get(int(p.ColorLine.Extend), 0),
                                center0=(p.x0, p.y0), radius0=float(p.r0))
            scene.fill(Fill.NON_ZERO, t, g, None, self._fill_rect())
        elif f in (8, 9):    # PaintSweepGradient (angles in degrees,
            # 0 = +x axis, counter-clockwise in y-up glyph space)
            a0 = math.radians(float(p.startAngle))
            a1 = math.radians(float(p.endAngle))
            g = Gradient.sweep((p.centerX, p.centerY), a0, a1,
                               self._stops(p.ColorLine, fg),
                               _EXTEND.get(int(p.ColorLine.Extend), 0))
            scene.fill(Fill.NON_ZERO, t, g, None, self._fill_rect())
        elif f == 10:   # PaintGlyph: clip to outline
            from .text import _GLOBAL_CACHE
            outline = _GLOBAL_CACHE.outline(self.font, p.Glyph)
            if outline.is_empty():
                return
            scene.push_clip_layer(t, outline)
            self._paint(scene, p.Paint, t, fg, depth + 1)
            scene.pop_layer()
        elif f == 11:   # PaintColrGlyph
            sub = self.base.get(p.Glyph)
            if sub is not None:
                self._paint(scene, sub, t, fg, depth + 1)
        elif f in (12, 13):  # PaintTransform
            m = p.Transform
            t2 = t @ Affine((m.xx, m.yx, m.xy, m.yy, m.dx, m.dy))
            self._paint(scene, p.Paint, t2, fg, depth + 1)
        elif f in (14, 15):  # PaintTranslate
            self._paint(scene, p.Paint, t @ Affine.translate(p.dx, p.dy),
                        fg, depth + 1)
        elif f in (16, 17):  # PaintScale
            self._paint(scene, p.Paint,
                        t @ Affine.scale(p.scaleX, p.scaleY), fg, depth + 1)
        elif f in (18, 19):  # PaintScaleAroundCenter
            cx, cy = p.centerX, p.centerY
            t2 = t @ (Affine.translate(cx, cy)
                      @ Affine.scale(p.scaleX, p.scaleY)
                      @ Affine.translate(-cx, -cy))
            self._paint(scene, p.Paint, t2, fg, depth + 1)
        elif f in (20, 21):  # PaintScaleUniform
            self._paint(scene, p.Paint, t @ Affine.scale(p.scale), fg,
                        depth + 1)
        elif f in (22, 23):
            cx, cy = p.centerX, p.centerY
            t2 = t @ (Affine.translate(cx, cy) @ Affine.scale(p.scale)
                      @ Affine.translate(-cx, -cy))
            self._paint(scene, p.Paint, t2, fg, depth + 1)
        elif f in (24, 25):  # PaintRotate (degrees, CCW in y-up)
            self._paint(scene, p.Paint,
                        t @ Affine.rotate(math.radians(float(p.angle))),
                        fg, depth + 1)
        elif f in (26, 27):
            cx, cy = p.centerX, p.centerY
            t2 = t @ (Affine.translate(cx, cy)
                      @ Affine.rotate(math.radians(float(p.angle)))
                      @ Affine.translate(-cx, -cy))
            self._paint(scene, p.Paint, t2, fg, depth + 1)
        elif f in (28, 29):  # PaintSkew
            sx = math.tan(math.radians(float(p.xSkewAngle)))
            sy = math.tan(math.radians(float(p.ySkewAngle)))
            self._paint(scene, p.Paint,
                        t @ Affine((1.0, -sy, -sx, 1.0, 0.0, 0.0)), fg,
                        depth + 1)
        elif f in (30, 31):
            cx, cy = p.centerX, p.centerY
            sx = math.tan(math.radians(float(p.xSkewAngle)))
            sy = math.tan(math.radians(float(p.ySkewAngle)))
            t2 = t @ (Affine.translate(cx, cy)
                      @ Affine((1.0, -sy, -sx, 1.0, 0.0, 0.0))
                      @ Affine.translate(-cx, -cy))
            self._paint(scene, p.Paint, t2, fg, depth + 1)
        elif f == 32:   # PaintComposite
            mix, compose = _COMPOSITE_MAP.get(
                int(p.CompositeMode), (Mix.NORMAL, Compose.SRC_OVER))
            self._paint(scene, p.BackdropPaint, t, fg, depth + 1)
            scene.push_layer(BlendMode(mix, compose), 1.0, t, None)
            self._paint(scene, p.SourcePaint, t, fg, depth + 1)
            scene.pop_layer()


def bitmap_glyph(font, gid: int):
    """Best-strike bitmap for a glyph from CBDT/CBLC or sbix.

    Returns (Image rgba8, bearing_x_px, bearing_y_px, ppem) or None.
    bearing_y is the distance from the baseline UP to the bitmap top
    (pixels at the strike's ppem). The strike is the JAX package's choice:
    CBLC's largest ppemY (the first of equals), then sbix's largest ppem
    with a ``png `` record. A CBDT glyph's bearings are the horizontal ones
    of either metrics record (the JAX package reads ``BearingX``, which
    only format 17's small metrics have: ROADMAP §3)."""
    sfnt = font.sfnt
    if "CBLC" in sfnt.tables and "CBDT" in sfnt.tables:
        strikes = sfnt.cbdt_strikes()
        best = max(range(len(strikes)), key=lambda i: strikes[i].ppem_y)
        data = sfnt.cbdt_glyph(strikes[best], gid)
        if data is not None and data.png:
            _, _, bearing_x, bearing_y, _ = data.metrics
            img = Image(data=decode_png(data.png),
                        quality=ImageQuality.MEDIUM)
            return (img, float(bearing_x), float(bearing_y),
                    float(strikes[best].ppem_y))
    if "sbix" in sfnt.tables:
        strikes = sfnt.sbix_strikes()
        for ppem in sorted(strikes, reverse=True):
            g = strikes[ppem].get(gid)
            if g is not None and g.graphic_type == "png " and g.data:
                arr = decode_png(g.data)
                img = Image(data=arr, quality=ImageQuality.MEDIUM)
                # sbix draws from the glyph origin; originOffset in pixels
                return (img, float(g.origin_x),
                        float(arr.shape[0] + g.origin_y), float(ppem))
    return None
