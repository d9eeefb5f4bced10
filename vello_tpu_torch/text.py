"""Text: fonts, glyph outlines, glyph caching, and the DrawGlyphs API.

Reference parity: ``vello::DrawGlyphs`` (``vello/src/scene.rs:487-893``), the
glyph resolver + cache (``vello_encoding/src/glyph_cache.rs``, ``glifo``).
The port reads its fonts itself (``sfnt.py``: metrics, cmap, glyf outlines,
COLR v0 and v1, CPAL, and the CBDT and sbix bitmap strikes, whose PNGs
``utils/png.py`` decodes), the job ``skrifa`` does for the reference
(SURVEY.md §1 L0), and ships its default font, DejaVu Sans, in
``assets/fonts/`` (its licence in ``LICENSE_DEJAVU`` there). A font
package is imported only for the features in ``FONT_PACKAGE_FEATURES``,
each queued in ROADMAP.md, and only when a font or a run asks for one. Outlines are cached per (font,
glyph-id) in font units — scaling happens through the affine transform, so
one cache entry serves every size (the reference caches per size because
of hinting, which we don't apply).
"""

from __future__ import annotations

import errno
import functools
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .kurbo import Affine, BezPath
from .peniko import Brush, Color, Fill
from .sfnt import SfntFont

FONT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "fonts")
DEFAULT_FONT = os.path.join(FONT_DIR, "DejaVuSans.ttf")

# the features still read through a font package: feature -> (package,
# what it is, its item in ROADMAP.md)
FONT_PACKAGE_FEATURES = {
    "variations": ("fontTools", "variable-font instancing (gvar, fvar, avar)",
                   24),
    "hinting": ("PIL", "hinting through FreeType", 27),
    "cff": ("fontTools", "CFF outlines", 28),
}


def package_missing(feature: str) -> ImportError:
    """The error of a feature whose font package is not installed."""
    package, what, item = FONT_PACKAGE_FEATURES[feature]
    return ImportError(f"{what} needs {package}, which is not installed "
                       f"(ROADMAP.md item {item}); outlines, metrics, COLR "
                       f"and bitmap strikes need no font package")


class Font:
    """A TrueType/OpenType font (the ``skrifa`` analog, SURVEY.md §1 L0):
    metrics, cmap, glyf outlines, COLR v0 and v1 and bitmap strikes from
    ``sfnt.SfntFont``; a bitmap-only font (CBDT, no glyf) opens too.

    variations: optional {axis_tag: user value} for variable fonts — the
    skrifa ``LocationRef`` analog (vello/src/scene.rs DrawGlyphs
    normalized_coords); instancing goes through fontTools (ROADMAP item
    24). Each Font instance gets its own cache id, so two instances of one
    file at different locations never share outlines."""

    _next_id = [0]

    def __init__(self, path: str, variations: Optional[dict] = None):
        self.path = path
        self.variations = dict(variations) if variations else None
        with open(path, "rb") as f:
            self.sfnt = SfntFont(f.read())
        tables = self.sfnt.tables
        self.upem = self.sfnt.units_per_em
        self._cmap = self.sfnt.cmap          # code point -> glyph id
        self._tt = None
        # fontTools' glyph set, for the outlines sfnt.py does not read: a
        # variable font at a location, or CFF outlines
        self._glyph_set = None
        if self.variations and "fvar" in tables:
            self._glyph_set = self.fonttools("variations").getGlyphSet(
                location=self.variations)
        elif "glyf" not in tables and ("CFF " in tables or "CFF2" in tables):
            self._glyph_set = self.fonttools("cff").getGlyphSet()
        self.id = Font._next_id[0]
        Font._next_id[0] += 1
        colr_version = self.sfnt.colr_version
        self._cpal = (self.sfnt.palettes()
                      if colr_version == 0 and "CPAL" in tables else None)
        self._colr_v1 = None
        self._has_colr_v1 = colr_version == 1 and "CPAL" in tables
        self.has_bitmaps = ("CBDT" in tables and "CBLC" in tables) \
            or "sbix" in tables

    def fonttools(self, feature: str):
        """fontTools' ``TTFont`` of this file, opened at first use, for one
        of the features of ``FONT_PACKAGE_FEATURES``."""
        if self._tt is None:
            try:
                from fontTools.ttLib import TTFont
            except ImportError as e:
                raise package_missing(feature) from e
            self._tt = TTFont(self.path, lazy=True)
        return self._tt

    @property
    def tt(self):
        """fontTools' ``TTFont`` (lazy): read only by the features that are
        still on fontTools, variations and CFF outlines."""
        return self.fonttools("variations" if self.variations else "cff")

    @property
    def glyph_order(self) -> List[str]:
        """Glyph names, from fontTools (variations and CFF only)."""
        return self.tt.getGlyphOrder()

    def colr_v1(self):
        """Lazy COLR v1 paint-graph renderer (None if absent)."""
        if self._has_colr_v1 and self._colr_v1 is None:
            from .colr import ColrV1
            self._colr_v1 = ColrV1(self)
        return self._colr_v1

    def bitmap_glyph(self, gid: int):
        """(Image, bearing_x_px, bearing_y_px, ppem) from the best
        CBDT/sbix strike, or None (glifo bitmap strikes role)."""
        if not self.has_bitmaps:
            return None
        from .colr import bitmap_glyph
        return bitmap_glyph(self, gid)

    def colr_layers(self, gid: int, palette: int = 0):
        """COLR v0 color-glyph layers: [(layer_gid, Color | None)] bottom
        to top, or None if this glyph has no color layers (the COLR
        painting adapter of vello/src/scene.rs:957-1131; palette index
        0xFFFF = the run's foreground brush)."""
        if self._cpal is None:
            return None
        layers = self.sfnt.colr_layers(gid)
        if not layers:
            return None
        pal = self._cpal[palette]
        out = []
        for lgid, color_id in layers:
            if color_id == 0xFFFF:
                out.append((lgid, None))
            else:
                r, g, b, a = pal[color_id]
                out.append((lgid, Color(r / 255.0, g / 255.0, b / 255.0,
                                        a / 255.0)))
        return out

    def glyph_id(self, ch: str) -> int:
        return self._cmap.get(ord(ch), 0)

    def advance(self, gid: int) -> float:
        return self.sfnt.advances[gid]

    def line_metrics(self) -> Tuple[float, float, float]:
        """(ascent, descent, line_gap) in font units."""
        return self.sfnt.ascent, self.sfnt.descent, self.sfnt.line_gap


class _PathPen:
    """fontTools pen that records into a BezPath (y-up font space)."""

    def __init__(self):
        self.path = BezPath()

    def moveTo(self, p):
        self.path.move_to(p[0], p[1])

    def lineTo(self, p):
        self.path.line_to(p[0], p[1])

    def qCurveTo(self, *points):
        # TrueType: run of off-curve points with implied on-curve midpoints;
        # the final point is on-curve (or None for a closed all-offcurve
        # contour, which fontTools normalizes before we see it in practice).
        cur = self.path.points[-1] if self.path.points else (0.0, 0.0)
        pts = list(points)
        if pts[-1] is None:
            pts[-1] = cur
        offs = pts[:-1]
        end = pts[-1]
        for i, c in enumerate(offs):
            if i + 1 < len(offs):
                mid = ((c[0] + offs[i + 1][0]) / 2.0,
                       (c[1] + offs[i + 1][1]) / 2.0)
            else:
                mid = end
            self.path.quad_to(c[0], c[1], mid[0], mid[1])

    def curveTo(self, c1, c2, p):
        self.path.curve_to(c1[0], c1[1], c2[0], c2[1], p[0], p[1])

    def closePath(self):
        self.path.close()

    def endPath(self):
        self.path.close()

    def addComponent(self, name, transform):
        raise _NeedsDecompose()


class _NeedsDecompose(Exception):
    pass


class GlyphCache:
    """(font.id, gid) -> BezPath outline in font units (glyph_cache.rs
    analog; LRU maintenance via generation counting). Outlines come from
    ``sfnt.SfntFont.draw`` by glyph id; the same pen records the same path
    from fontTools' glyph set, which draws a variable font's location and
    CFF outlines."""

    def __init__(self, max_entries: int = 4096):
        self._cache: Dict[Tuple[int, int], BezPath] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def outline(self, font: Font, gid: int) -> BezPath:
        key = (font.id, gid)
        got = self._cache.pop(key, None)
        if got is not None:
            self.hits += 1
            self._cache[key] = got   # re-insert: most-recently-used at end
            return got
        self.misses += 1
        pen = _PathPen()
        if font._glyph_set is None:
            font.sfnt.draw(gid, pen)
        else:
            # a variable location or CFF outlines, through fontTools
            glyph = font._glyph_set[font.tt.getGlyphName(gid)]
            try:
                glyph.draw(pen)
            except _NeedsDecompose:
                # composite glyph: decompose components
                from fontTools.pens.recordingPen import \
                    DecomposingRecordingPen

                rp = DecomposingRecordingPen(font._glyph_set)
                glyph.draw(rp)
                pen = _PathPen()
                rp.replay(pen)
        if len(self._cache) >= self.max_entries:
            # LRU eviction (dicts preserve insertion order; hits re-insert)
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = pen.path
        return pen.path


_GLOBAL_CACHE = GlyphCache()
_PIL_FONTS: Dict[tuple, object] = {}
_HINT_CACHE: Dict[tuple, tuple] = {}


class GlyphRasterCache:
    """(font.id, gid, quantized size, rgba8) -> rendered glyph Image.

    The glyph-atlas analog of ``glifo/src/atlas`` (SURVEY.md §2.4): each
    (glyph, size, color) is rasterized ONCE on the host (via the oracle's
    exact-area coverage) and subsequent draws reuse the cached Image —
    placed as a bilinear-sampled rect, so a page of text costs dozens of
    image rects instead of thousands of flattened outlines. Opt-in via
    ``DrawGlyphs.raster(True)`` (the OptimizeSpeed analog); the default
    path stays vector-exact.

    Tradeoff: raster cuts host encode (~74k -> ~13k lines on text_heavy,
    4000 glyphs at 1024²) but each glyph becomes its own image-paint path
    (40 -> 3240 paths), and per-path work grows the device frame. Prefer
    the default vector path unless host encode time is the bottleneck
    (e.g. dynamic text re-encoded per frame). (The JAX package's TPU
    frame times are dropped from this copy: they are not the port's.)"""

    def __init__(self, max_entries: int = 4096):
        self._cache: Dict[tuple, tuple] = {}
        self.max_entries = max_entries

    def image(self, font: Font, gid: int, size: float, color) -> tuple:
        """Returns (Image | None, (offset_x, offset_y)) — the offset of
        the image's top-left from the glyph origin (baseline)."""
        import math

        q = round(size * 2.0) / 2.0      # 0.5 px size quantization
        rgba = (round(color.r * 255), round(color.g * 255),
                round(color.b * 255), round(color.a * 255))
        key = (font.id, gid, q, rgba)
        got = self._cache.get(key)
        if got is not None:
            return got
        outline = _GLOBAL_CACHE.outline(font, gid)
        if outline.is_empty():
            entry = (None, (0.0, 0.0))
        else:
            scale = q / font.upem
            path = outline.transform(Affine.scale(scale, -scale))
            bb = path.bounding_box()
            pad = 1
            ox = math.floor(bb.x0) - pad
            oy = math.floor(bb.y0) - pad
            w = int(math.ceil(bb.x1)) - ox + pad
            h = int(math.ceil(bb.y1)) - oy + pad
            from .oracle import OracleRenderer
            from .encoding.config import RenderParams
            from .peniko import Image, ImageQuality
            mini = _scene_cls()()
            mini.fill(Fill.NON_ZERO, Affine.translate(-ox, -oy),
                      Color(1, 1, 1, 1), None, path)
            img = OracleRenderer().render(
                mini, RenderParams(w, h, base_color=(0, 0, 0, 0)))
            mask = np.clip(img[..., 3], 0.0, 1.0)
            data = np.empty((h, w, 4), np.uint8)
            data[..., 0] = rgba[0]
            data[..., 1] = rgba[1]
            data[..., 2] = rgba[2]
            data[..., 3] = np.round(mask * rgba[3]).astype(np.uint8)
            entry = (Image(data=data, quality=ImageQuality.MEDIUM),
                     (float(ox), float(oy)))
        if len(self._cache) >= self.max_entries:
            self._cache.clear()          # epoch eviction (glifo LRU analog)
        self._cache[key] = entry
        return entry


def _scene_cls():
    from .scene import Scene
    return Scene


_GLOBAL_RASTER_CACHE = GlyphRasterCache()


@dataclass
class Glyph:
    gid: int
    x: float
    y: float


class DrawGlyphs:
    """Builder mirroring vello's DrawGlyphs (scene.rs:487-893)."""

    def __init__(self, scene, font: Font):
        self.scene = scene
        self.font = font
        self._size = 16.0
        self._brush: Brush = Color(0, 0, 0, 1)
        self._transform = Affine.IDENTITY
        self._glyph_transform: Optional[Affine] = None
        self._brush_transform: Optional[Affine] = None
        self._cache = _GLOBAL_CACHE
        self._raster = False
        self._hint = False

    def font_size(self, size: float) -> "DrawGlyphs":
        self._size = float(size)
        return self

    def brush(self, brush: Brush) -> "DrawGlyphs":
        self._brush = brush
        return self

    def transform(self, t: Affine) -> "DrawGlyphs":
        self._transform = t
        return self

    def glyph_transform(self, t: Optional[Affine]) -> "DrawGlyphs":
        self._glyph_transform = t
        return self

    def brush_transform(self, t: Optional[Affine]) -> "DrawGlyphs":
        """Extra transform applied to the brush (gradient/image) relative
        to the run transform (scene.rs DrawGlyphs::brush_transform)."""
        self._brush_transform = t
        return self

    def hint(self, on: bool = True) -> "DrawGlyphs":
        """Grid-fitted (hinted) rendering for small solid-color text:
        glyphs rasterize through FreeType's hinter (via PIL, ROADMAP item
        27: without it an applicable run raises ImportError) and land on
        integer pixel positions — the glifo hinting-cache role. Falls
        back to vector outlines for non-solid brushes, glyph transforms,
        or non-translation run transforms (the reference's own hinting
        applicability rule, vello/src/scene.rs hint handling)."""
        self._hint = bool(on)
        return self

    def raster(self, on: bool = True) -> "DrawGlyphs":
        """Use the glyph raster atlas (bilinear image rects) instead of
        vector outlines — OptimizeSpeed analog. Requires a solid Color
        brush and no glyph_transform; otherwise falls back to vectors."""
        self._raster = bool(on)
        return self

    def embolden(self, strength: float) -> "DrawGlyphs":
        """Synthetic emboldening: dilate outlines by ~``strength`` user-space
        pixels (the reference's FontEmbolden role, glyph.rs
        glyphs_emboldened). Approximated as fill + round-joined stroke of
        width 2*strength over the same outline — equivalent dilation for
        glyph-shaped contours, without skrifa's per-point offsetting."""
        self._embolden = float(strength)
        return self

    def draw(self, style, glyphs: Iterable[Glyph]) -> None:
        """``style`` is a Fill rule for filled runs or a kurbo ``Stroke``
        for stroked runs (reference DrawGlyphs::draw StyleRef, sparse
        stroke_glyphs). Stroked and emboldened runs always use vector
        outlines (the hinted raster path only fills)."""
        from .kurbo import Stroke as _Stroke
        stroke_style = style if isinstance(style, _Stroke) else None
        embolden = getattr(self, "_embolden", 0.0)
        scale = self._size / self.font.upem
        t = self._transform
        use_hint = (self._hint and isinstance(self._brush, Color)
                    and self._glyph_transform is None
                    and stroke_style is None and embolden == 0.0
                    and abs(t.coeffs[0] - 1.0) < 1e-9
                    and abs(t.coeffs[1]) < 1e-9 and abs(t.coeffs[2]) < 1e-9
                    and abs(t.coeffs[3] - 1.0) < 1e-9)
        if use_hint:
            drew_any = self._draw_hinted(style, glyphs)
            if drew_any is not None:
                return
        use_raster = (self._raster and isinstance(self._brush, Color)
                      and self._glyph_transform is None
                      and stroke_style is None and embolden == 0.0)
        fg = self._brush if isinstance(self._brush, Color) \
            else Color(0, 0, 0, 1)
        colr1 = self.font.colr_v1() if hasattr(self.font, "colr_v1") \
            else None
        combined = BezPath()
        for g in glyphs:
            # bitmap strikes (CBDT/sbix): draw the best strike as an
            # image rect scaled to the run size (glifo bitmap role)
            if self.font.has_bitmaps:
                bm = self.font.bitmap_glyph(g.gid)
                if bm is not None:
                    img, bx, by, ppem = bm
                    s = self._size / ppem
                    t = (self._transform
                         @ Affine.translate(g.x + bx * s, g.y - by * s)
                         @ Affine.scale(s))
                    self.scene.draw_image(img, t)
                    continue
            # COLR v1 paint graph (scene.rs:957-1131 adapter role)
            if colr1 is not None and colr1.has_glyph(g.gid):
                t = (self._transform @ Affine.translate(g.x, g.y)
                     @ Affine.scale(scale, -scale))
                if self._glyph_transform is not None:
                    t = t @ self._glyph_transform
                colr1.emit(self.scene, g.gid, t, fg)
                continue
            if use_raster and self.font.colr_layers(g.gid) is None:
                img, (ox, oy) = _GLOBAL_RASTER_CACHE.image(
                    self.font, g.gid, self._size, self._brush)
                if img is not None:
                    t = self._transform @ Affine.translate(g.x + ox, g.y + oy)
                    self.scene.draw_image(img, t)
                continue
            # font units are y-up; flip into y-down device space
            t = Affine.translate(g.x, g.y) @ Affine.scale(scale, -scale)
            if self._glyph_transform is not None:
                t = t @ self._glyph_transform
            layers = self.font.colr_layers(g.gid)
            if layers is not None:
                # COLR v0 color glyph: one fill per layer, bottom to top
                # (scene.rs:957-1131 draw_colr analog; v1 gradients/transforms
                # are not supported — such glyphs fall back to outlines).
                for lgid, color in layers:
                    lpath = self._cache.outline(self.font, lgid)
                    if lpath.is_empty():
                        continue
                    brush = self._brush if color is None else color
                    # color glyph layers are always filled (reference
                    # draw_colr ignores the run's stroke style)
                    lstyle = Fill.NON_ZERO if stroke_style is not None \
                        else style
                    self.scene.fill(lstyle, self._transform, brush,
                                    self._brush_transform,
                                    lpath.transform(t))
                continue
            outline = self._cache.outline(self.font, g.gid)
            if outline.is_empty():
                continue
            combined.extend(outline.transform(t))
        if combined.is_empty():
            return
        if stroke_style is not None:
            self.scene.stroke(stroke_style, self._transform, self._brush,
                              self._brush_transform, combined)
            return
        self.scene.fill(style, self._transform, self._brush,
                        self._brush_transform, combined)
        if embolden > 0.0:
            from .kurbo import Stroke as _S
            self.scene.stroke(_S(width=2.0 * embolden, join="round",
                                 start_cap="round", end_cap="round"),
                              self._transform, self._brush,
                              self._brush_transform, combined)

    def _draw_hinted(self, style, glyphs):
        """FreeType-hinted raster path (solid brush, pure translation).
        Raises ImportError without PIL (ROADMAP item 27); returns None
        (caller falls back) when the font can't be loaded by FreeType;
        otherwise draws and returns True."""
        try:
            from PIL import ImageFont
        except ImportError as e:
            raise package_missing("hinting") from e
        key = (self.font.path, int(round(self._size)))
        pil = _PIL_FONTS.get(key)
        if pil is None:
            try:
                pil = ImageFont.truetype(self.font.path,
                                         int(round(self._size)))
            except Exception:
                return None
            _PIL_FONTS[key] = pil
        rev = getattr(self.font, "_rev_cmap", None)
        if rev is None:
            rev = {gid: chr(cp) for cp, gid in self.font._cmap.items()}
            self.font._rev_cmap = rev
        ascent, _ = pil.getmetrics()
        tx, ty = self._transform.coeffs[4], self._transform.coeffs[5]
        color = self._brush
        import numpy as _np
        for g in glyphs:
            ch = rev.get(g.gid)
            if ch is None:
                continue
            ck = (id(pil), ch, color.r, color.g, color.b, color.a)
            ent = _HINT_CACHE.get(ck)
            if ent is None:
                mask = pil.getmask(ch, mode="L")
                if mask.size[0] == 0 or mask.size[1] == 0:
                    _HINT_CACHE[ck] = (None, 0, 0)
                    continue
                a = (_np.frombuffer(bytes(mask), dtype=_np.uint8)
                     .reshape(mask.size[1], mask.size[0]))
                bbox = pil.getbbox(ch)
                rgba = _np.empty(a.shape + (4,), dtype=_np.uint8)
                rgba[..., 0] = int(round(color.r * 255))
                rgba[..., 1] = int(round(color.g * 255))
                rgba[..., 2] = int(round(color.b * 255))
                rgba[..., 3] = (a.astype(_np.float32)
                                * color.a).astype(_np.uint8)
                from .peniko import Image, ImageQuality
                if len(_HINT_CACHE) > 4096:
                    _HINT_CACHE.pop(next(iter(_HINT_CACHE)))
                _HINT_CACHE[ck] = (Image(data=rgba,
                                         quality=ImageQuality.LOW),
                                   bbox[0], bbox[1])
                ent = _HINT_CACHE[ck]
            img, bx, by = ent
            if img is None:
                continue
            # grid fit: integer device position; PIL masks sit at the
            # glyph bbox, origin at the TOP of the line (baseline-ascent)
            px = round(tx + g.x) + bx
            py = round(ty + g.y) - ascent + by
            self.scene.draw_image(img, Affine.translate(px, py))
        return True


def layout_text(font: Font, size: float, text: str,
                origin: Tuple[float, float] = (0.0, 0.0)) -> List[Glyph]:
    """Minimal shaping: advances only (no kerning/ligatures)."""
    scale = size / font.upem
    x, y = origin
    out = []
    for ch in text:
        if ch == "\n":
            asc, desc, gap = font.line_metrics()
            y += (asc - desc + gap) * scale
            x = origin[0]
            continue
        gid = font.glyph_id(ch)
        out.append(Glyph(gid, x, y))
        x += font.advance(gid) * scale
    return out


@functools.lru_cache(maxsize=4)
def default_font() -> Font:
    """DejaVu Sans, shipped with the package (``assets/fonts/``)."""
    if not os.path.isfile(DEFAULT_FONT):
        raise FileNotFoundError(errno.ENOENT, "the default font is missing",
                                DEFAULT_FONT)
    return Font(DEFAULT_FONT)
