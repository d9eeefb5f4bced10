"""TrueType reading for the text path, in numpy and ``struct`` only.

The tables the outline path needs: the table directory, ``head``
(unitsPerEm, indexToLocFormat), ``hhea`` (ascent, descent, lineGap,
numberOfHMetrics), ``maxp`` (numGlyphs), ``hmtx``, ``loca``, ``cmap``
(formats 4 and 12, the subtable chosen in fontTools' ``getBestCmap``
order), ``glyf`` (simple and composite glyphs), COLR v0 and v1 with CPAL,
and the bitmap strikes of CBLC/CBDT and sbix. This is the job fontTools
does for ``vello_tpu`` and ``skrifa`` for the reference (SURVEY.md §1 L0).

COLR v1 paints (``ColrV1Table``) carry fontTools' field names and the
Python values fontTools decodes (F2Dot14 ``v / 16384``, Fixed ``v /
65536``, angles ``(v / 16384 + bias) * 180`` with a bias of 1.0 for a
sweep's start and end), so that ``colr.ColrV1`` builds the same scene ops
from either reader; glyphs are named by id. The Var formats are read at
their default values: their VarIndexBase is skipped, as the JAX package
skips it. Malformed data (an offset outside its table, an unknown format)
raises ValueError.

``SfntFont.draw`` sends a glyph's contours to a segment pen (``moveTo``,
``lineTo``, ``qCurveTo``, ``curveTo``, ``closePath``) with the same points,
in the same order and through the same arithmetic as fontTools' glyph set
drawn through its ``DecomposingRecordingPen``: each contour starts at its
first on-curve point, a contour with none is one ``qCurveTo(*offs, None)``,
a simple glyph at the top level is shifted by ``lsb - xMin``, and a
composite's components go through their F2Dot14 transforms, composed as
fontTools' ``Transform.transform`` composes them. A pen therefore records
the same path from either reader. Where fontTools' pen path does not read a
component (a point-matched one) or ignores its flags
(``SCALED_COMPONENT_OFFSET``, ``ROUND_XY_TO_GRID``), this reader follows the
OpenType specification, as fontTools' ``getCoordinates`` does.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# simple-glyph point flags
ON_CURVE = 0x01
X_SHORT = 0x02
Y_SHORT = 0x04
REPEAT = 0x08
X_SAME = 0x10
Y_SAME = 0x20
CUBIC = 0x80

# composite-glyph component flags
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004
WE_HAVE_A_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080
SCALED_COMPONENT_OFFSET = 0x0800
UNSCALED_COMPONENT_OFFSET = 0x1000

# (platformID, encodingID) of the Unicode cmap subtables, best first
# (fontTools' getBestCmap, HarfBuzz's order)
CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1),
                    (0, 0))
SFNT_VERSIONS = (0x00010000, 0x74727565, 0x4F54544F)   # 1.0, 'true', 'OTTO'
MAX_COMPONENT_DEPTH = 64

Transform = Tuple[float, float, float, float, float, float]
IDENTITY: Transform = (1, 0, 0, 1, 0, 0)


@dataclass
class SimpleGlyph:
    x_min: int
    coords: List[Tuple[int, int]]      # absolute font units
    end_pts: List[int]
    flags: List[int]


@dataclass
class Component:
    gid: int
    flags: int
    matrix: Optional[Tuple[float, float, float, float]]   # xx, xy, yx, yy
    args: Tuple[int, int]    # x, y offset; or (parent point, own point)

    @property
    def point_matched(self) -> bool:
        return not self.flags & ARGS_ARE_XY_VALUES


@dataclass
class CompositeGlyph:
    components: List[Component]


def _f2dot14(v: int) -> float:
    return v / 16384


def compose(outer: Transform, inner: Transform) -> Transform:
    """``outer`` after ``inner``, as fontTools' ``Transform.transform``."""
    xx1, xy1, yx1, yy1, dx1, dy1 = inner
    xx2, xy2, yx2, yy2, dx2, dy2 = outer
    return (xx1 * xx2 + xy1 * yx2, xx1 * xy2 + xy1 * yy2,
            yx1 * xx2 + yy1 * yx2, yx1 * xy2 + yy1 * yy2,
            xx2 * dx1 + yx2 * dy1 + dx2, xy2 * dx1 + yy2 * dy1 + dy2)


def apply(t: Transform, p) -> tuple:
    xx, xy, yx, yy, dx, dy = t
    x, y = p
    return (xx * x + yx * y + dx, xy * x + yy * y + dy)


class TransformPen:
    """Each point through ``t`` on its way to ``pen`` (fontTools'
    ``TransformPen``; the None that closes an all-off-curve contour
    passes through)."""

    def __init__(self, pen, t: Transform):
        self.pen = pen
        self.t = t

    def moveTo(self, p):
        self.pen.moveTo(apply(self.t, p))

    def lineTo(self, p):
        self.pen.lineTo(apply(self.t, p))

    def qCurveTo(self, *points):
        self.pen.qCurveTo(*[None if p is None else apply(self.t, p)
                            for p in points])

    def curveTo(self, *points):
        self.pen.curveTo(*[apply(self.t, p) for p in points])

    def closePath(self):
        self.pen.closePath()


def _maybe_int(v):
    return int(v) if v == int(v) else v


def draw_contours(pen, coords, end_pts, flags) -> None:
    """One simple glyph's contours onto ``pen`` (fontTools'
    ``Glyph.draw``)."""
    start = 0
    for end in end_pts:
        end += 1
        contour = coords[start:end]
        on = [f & ON_CURVE for f in flags[start:end]]
        cubic_flags = [f & CUBIC for f in flags[start:end]]
        start = end
        if 1 not in on:
            if all(cubic_flags) and cubic_flags:
                count = len(contour)
                last, first = contour[-1], contour[0]
                pen.moveTo((_maybe_int((last[0] + first[0]) * 0.5),
                            _maybe_int((last[1] + first[1]) * 0.5)))
                for i in range(0, count, 2):
                    p1, p2 = contour[i], contour[i + 1]
                    p4 = contour[i + 2 if i + 2 < count else 0]
                    pen.curveTo(p1, p2, (_maybe_int((p2[0] + p4[0]) * 0.5),
                                         _maybe_int((p2[1] + p4[1]) * 0.5)))
            else:
                pen.qCurveTo(*contour, None)
        else:
            # rotate the contour to end at its first on-curve point, where
            # it starts
            k = on.index(1) + 1
            contour = contour[k:] + contour[:k]
            on = on[k:] + on[:k]
            cubic_flags = cubic_flags[k:] + cubic_flags[:k]
            pen.moveTo(contour[-1])
            while contour:
                nxt = on.index(1) + 1
                if nxt == 1:
                    # the closing line is implied by closePath
                    if len(contour) > 1:
                        pen.lineTo(contour[0])
                elif any(cubic_flags[:nxt - 1]):
                    for i in range(0, nxt - 3, 2):
                        p1, p2, p4 = contour[i], contour[i + 1], contour[i + 2]
                        pen.curveTo(p1, p2, (
                            _maybe_int((p2[0] + p4[0]) * 0.5),
                            _maybe_int((p2[1] + p4[1]) * 0.5)))
                    pen.curveTo(*contour[nxt - 3:nxt])
                else:
                    pen.qCurveTo(*contour[:nxt])
                contour = contour[nxt:]
                on = on[nxt:]
                cubic_flags = cubic_flags[nxt:]
        pen.closePath()


class SfntFont:
    """The tables of one TrueType font file (``data``, its bytes)."""

    def __init__(self, data: bytes):
        self.data = data
        version, n_tables = struct.unpack_from(">IH", data, 0)
        if version not in SFNT_VERSIONS:
            raise ValueError(f"not a TrueType/OpenType font (version "
                             f"0x{version:08x})")
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(n_tables):
            tag, _, offset, length = struct.unpack_from(">4sIII", data,
                                                        12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (offset, length)
        head = self.table("head")
        self.units_per_em = struct.unpack_from(">H", head, 18)[0]
        self.index_to_loc_format = struct.unpack_from(">h", head, 50)[0]
        self.num_glyphs = struct.unpack_from(">H", self.table("maxp"), 4)[0]
        hhea = self.table("hhea")
        self.ascent, self.descent, self.line_gap = struct.unpack_from(
            ">hhh", hhea, 4)
        n_metrics = min(struct.unpack_from(">H", hhea, 34)[0],
                        self.num_glyphs)
        self.advances, self.lsbs = self._hmtx(n_metrics)
        self.cmap = self._best_cmap()
        self._glyphs: Dict[int, object] = {}
        if "glyf" in self.tables:
            fmt = ">u4" if self.index_to_loc_format else ">u2"
            loca = np.frombuffer(self.table("loca"), fmt,
                                 count=self.num_glyphs + 1).astype(np.int64)
            self.loca = (loca if self.index_to_loc_format
                         else loca * 2).tolist()
            self.glyf = self.table("glyf")
        else:
            self.loca = None
        # head's xMin, yMin, xMax, yMax, as the file holds them
        self.bbox = struct.unpack_from(">hhhh", head, 36)
        self.colr_version = (struct.unpack_from(">H", self.table("COLR"), 0)[0]
                             if "COLR" in self.tables else None)
        self._colr_v0 = None
        self._colr_v1 = None
        self._cbdt_strikes = None
        self._cbdt = None
        self._sbix_strikes = None

    def table(self, tag: str) -> bytes:
        if tag not in self.tables:
            raise ValueError(f"the font has no '{tag}' table")
        offset, length = self.tables[tag]
        return self.data[offset:offset + length]

    # -- metrics and cmap ---------------------------------------------------
    def _hmtx(self, n_metrics: int):
        hmtx = self.table("hmtx")
        long = np.frombuffer(hmtx, [("advance", ">u2"), ("lsb", ">i2")],
                             count=n_metrics)
        advances = long["advance"].astype(np.int64).tolist()
        lsbs = long["lsb"].astype(np.int64).tolist()
        n_rest = self.num_glyphs - n_metrics
        # glyphs past numberOfHMetrics take the last advance
        advances += advances[-1:] * n_rest
        lsbs += np.frombuffer(hmtx, ">i2", count=n_rest,
                              offset=4 * n_metrics).astype(np.int64).tolist()
        return advances, lsbs

    def _best_cmap(self) -> Dict[int, int]:
        """Code point -> glyph id of the best Unicode subtable; glyph id 0
        is left out, as fontTools leaves it out."""
        if "cmap" not in self.tables:
            return {}
        cmap = self.table("cmap")
        _, n = struct.unpack_from(">HH", cmap, 0)
        subtables = {}
        for i in range(n):
            pid, eid, offset = struct.unpack_from(">HHL", cmap, 4 + 8 * i)
            fmt = struct.unpack_from(">H", cmap, offset)[0]
            length = (struct.unpack_from(">L", cmap, offset + 4)[0]
                      if fmt in (8, 10, 12, 13) else
                      struct.unpack_from(">L", cmap, offset + 2)[0]
                      if fmt == 14 else
                      struct.unpack_from(">H", cmap, offset + 2)[0])
            if length:
                subtables.setdefault((pid, eid), (fmt, offset))
        for key in CMAP_PREFERENCES:
            if key in subtables:
                fmt, offset = subtables[key]
                if fmt == 4:
                    return _cmap_format_4(cmap, offset)
                if fmt == 12:
                    return _cmap_format_12(cmap, offset)
                raise ValueError(f"cmap subtable {key} has format {fmt}; "
                                 f"formats 4 and 12 are read")
        return {}

    # -- glyf -------------------------------------------------------------
    def glyph(self, gid: int):
        """The parsed glyph: a SimpleGlyph, a CompositeGlyph, or None for an
        empty one (``loca[gid] == loca[gid + 1]``, or no contours)."""
        if gid in self._glyphs:
            return self._glyphs[gid]
        g = None
        if self.loca is not None and 0 <= gid < self.num_glyphs:
            start, end = self.loca[gid], self.loca[gid + 1]
            if end > start:
                g = _parse_glyph(self.glyf[start:end])
        self._glyphs[gid] = g
        return g

    def component_transforms(self, g: CompositeGlyph, depth: int = 0):
        """[(gid, transform)] of a composite's components, each transform
        (xx, xy, yx, yy, dx, dy) as fontTools' ``getComponentInfo`` gives
        it; a scaled offset (``SCALED_COMPONENT_OFFSET`` without
        ``UNSCALED_COMPONENT_OFFSET``) goes through the component's matrix
        and, with ``ROUND_XY_TO_GRID``, to the nearest unit; a
        point-matched component moves its point onto its parent's."""
        out = []
        placed = None             # the parent's points so far, when needed
        for i, c in enumerate(g.components):
            xx, xy, yx, yy = c.matrix or (1, 0, 0, 1)
            if c.point_matched:
                if placed is None:
                    placed = []
                    for gid, t in out:
                        placed += [apply(t, p)
                                   for p in self.points(gid, depth + 1)]
                own = self.points(c.gid, depth + 1)
                x1, y1 = placed[c.args[0]]
                x2, y2 = apply((xx, xy, yx, yy, 0, 0), own[c.args[1]])
                dx, dy = x1 - x2, y1 - y2
            else:
                dx, dy = c.args
                if (c.matrix is not None and c.flags & SCALED_COMPONENT_OFFSET
                        and not c.flags & UNSCALED_COMPONENT_OFFSET):
                    dx, dy = apply((xx, xy, yx, yy, 0, 0), (dx, dy))
                    if c.flags & ROUND_XY_TO_GRID:
                        dx, dy = math.floor(dx + 0.5), math.floor(dy + 0.5)
            t = ((xx, xy, yx, yy, dx, dy) if c.matrix is not None
                 else (1, 0, 0, 1, dx, dy))
            out.append((c.gid, t))
            if placed is not None:
                placed += [apply(t, p) for p in self.points(c.gid, depth + 1)]
        return out

    def points(self, gid: int, depth: int = 0) -> list:
        """A glyph's points in its own units, components placed (fontTools'
        ``getCoordinates``)."""
        if depth > MAX_COMPONENT_DEPTH:
            raise ValueError(f"glyph {gid}: components nest deeper than "
                             f"{MAX_COMPONENT_DEPTH} (a cycle?)")
        g = self.glyph(gid)
        if g is None:
            return []
        if isinstance(g, SimpleGlyph):
            return list(g.coords)
        out = []
        for cgid, t in self.component_transforms(g, depth):
            out += [apply(t, p) for p in self.points(cgid, depth + 1)]
        return out

    def draw(self, gid: int, pen) -> None:
        """Glyph ``gid``'s outline onto a segment pen, as fontTools draws
        it through ``DecomposingRecordingPen``."""
        self._draw(gid, pen, None, 0)

    def _draw(self, gid, pen, t: Optional[Transform], depth: int) -> None:
        if depth > MAX_COMPONENT_DEPTH:
            raise ValueError(f"glyph {gid}: components nest deeper than "
                             f"{MAX_COMPONENT_DEPTH} (a cycle?)")
        g = self.glyph(gid)
        if g is None:
            return
        if isinstance(g, CompositeGlyph):
            for cgid, ct in self.component_transforms(g, depth):
                if t is not None:
                    ct = compose(t, ct)
                self._draw(cgid, pen, None if ct == IDENTITY else ct,
                           depth + 1)
            return
        coords = g.coords
        # the top level only: x shifted so that xMin lands on the lsb
        offset = self.lsbs[gid] - g.x_min if depth == 0 else 0
        if offset:
            coords = [(x + offset, y) for x, y in coords]
        draw_contours(pen if t is None else TransformPen(pen, t), coords,
                      g.end_pts, g.flags)

    # -- COLR v0 and CPAL ------------------------------------------------
    def colr_layers(self, gid: int) -> Optional[List[Tuple[int, int]]]:
        """COLR v0 layers of a base glyph, bottom to top: [(layer gid,
        palette index)], or None when it has none."""
        if self.colr_version != 0:
            return None
        if self._colr_v0 is None:
            colr = self.table("COLR")
            _, n_base, base_off, layer_off, n_layers = struct.unpack_from(
                ">HHLLH", colr, 0)
            layers = np.frombuffer(colr, ">u2", count=2 * n_layers,
                                   offset=layer_off).reshape(-1, 2).tolist()
            self._colr_v0 = {}
            for i in range(n_base):
                base, first, count = struct.unpack_from(">HHH", colr,
                                                        base_off + 6 * i)
                self._colr_v0[base] = [tuple(r) for r in
                                       layers[first:first + count]]
        return self._colr_v0.get(gid) or None

    def palettes(self) -> List[List[Tuple[int, int, int, int]]]:
        """CPAL palettes, each a list of (red, green, blue, alpha) bytes."""
        cpal = self.table("CPAL")
        _, n_entries, n_palettes, n_records, records_off = \
            struct.unpack_from(">HHHHL", cpal, 0)
        firsts = struct.unpack_from(f">{n_palettes}H", cpal, 12)
        bgra = np.frombuffer(cpal, np.uint8, count=4 * n_records,
                             offset=records_off).reshape(-1, 4)
        rgba = bgra[:, [2, 1, 0, 3]].tolist()
        return [[tuple(c) for c in rgba[f:f + n_entries]] for f in firsts]

    # -- COLR v1 ------------------------------------------------------------
    def colr_v1(self) -> "ColrV1Table":
        """The COLR v1 paint graph (read at first use)."""
        if self.colr_version != 1:
            raise ValueError(f"the font's COLR table is version "
                             f"{self.colr_version}, not 1")
        if self._colr_v1 is None:
            self._colr_v1 = ColrV1Table(self.table("COLR"))
        return self._colr_v1

    # -- bitmap strikes -------------------------------------------------------
    def cbdt_strikes(self) -> List["BitmapStrike"]:
        """CBLC's strikes, in the table's order, each with the CBDT
        location of every glyph its index subtables hold."""
        if self._cbdt_strikes is None:
            self._cbdt_strikes = _read_cblc(self.table("CBLC"))
        return self._cbdt_strikes

    def cbdt_glyph(self, strike: "BitmapStrike",
                   gid: int) -> Optional["BitmapGlyph"]:
        """Glyph ``gid`` of a CBLC strike from CBDT, or None when the strike
        has no image for it."""
        loc = strike.glyphs.get(gid)
        if loc is None:
            return None
        if self._cbdt is None:          # read once: emoji CBDTs are MBs
            self._cbdt = self.table("CBDT")
        return _read_cbdt_glyph(self._cbdt, *loc)

    def sbix_strikes(self) -> Dict[int, Dict[int, "SbixGlyph"]]:
        """sbix's strikes: ppem -> {glyph id: its glyph data record}, the
        glyphs with an empty record left out."""
        if self._sbix_strikes is None:
            self._sbix_strikes = _read_sbix(self.table("sbix"),
                                            self.num_glyphs)
        return self._sbix_strikes


def _cmap_format_4(cmap: bytes, offset: int) -> Dict[int, int]:
    seg_count = struct.unpack_from(">H", cmap, offset + 6)[0] // 2
    length = struct.unpack_from(">H", cmap, offset + 2)[0]
    words = np.frombuffer(cmap, ">u2", count=(length - 14) // 2,
                          offset=offset + 14).astype(np.int64).tolist()
    end_code = words[:seg_count]
    start_code = words[seg_count + 1:2 * seg_count + 1]   # past reservedPad
    id_delta = words[2 * seg_count + 1:3 * seg_count + 1]
    id_range_offset = words[3 * seg_count + 1:4 * seg_count + 1]
    glyph_ids = words[4 * seg_count + 1:]
    out: Dict[int, int] = {}
    for i in range(seg_count - 1):         # the last segment is 0xFFFF
        start, delta, ro = start_code[i], id_delta[i], id_range_offset[i]
        partial = ro // 2 - start + i - seg_count
        for code in range(start, end_code[i] + 1):
            if ro == 0:
                gid = (code + delta) & 0xFFFF
            else:
                gid = glyph_ids[code + partial]
                gid = (gid + delta) & 0xFFFF if gid else 0
            if gid:
                out[code] = gid
    return out


def _cmap_format_12(cmap: bytes, offset: int) -> Dict[int, int]:
    n_groups = struct.unpack_from(">L", cmap, offset + 12)[0]
    groups = np.frombuffer(cmap, ">u4", count=3 * n_groups,
                           offset=offset + 16).reshape(-1, 3).tolist()
    out: Dict[int, int] = {}
    for start, end, first in groups:
        for code in range(start, end + 1):
            gid = first + code - start
            if gid:
                out[code] = gid
    return out


def _parse_glyph(buf: bytes):
    n_contours, x_min = struct.unpack_from(">hh", buf, 0)
    if n_contours == 0:
        return None
    if n_contours < 0:
        return CompositeGlyph(_parse_components(buf))
    end_pts = list(struct.unpack_from(f">{n_contours}H", buf, 10))
    pos = 10 + 2 * n_contours
    n_instructions = struct.unpack_from(">H", buf, pos)[0]
    pos += 2 + n_instructions
    n_points = end_pts[-1] + 1
    flags: List[int] = []
    while len(flags) < n_points:
        f = buf[pos]
        pos += 1
        repeat = 1
        if f & REPEAT:
            repeat += buf[pos]
            pos += 1
        flags += [f] * repeat
    if len(flags) != n_points:
        raise ValueError("glyph flags repeat past the last point")
    xs, pos = _deltas(buf, pos, flags, X_SHORT, X_SAME)
    ys, pos = _deltas(buf, pos, flags, Y_SHORT, Y_SAME)
    return SimpleGlyph(x_min, list(zip(xs, ys)), end_pts,
                       [f & (ON_CURVE | CUBIC) for f in flags])


def _deltas(buf: bytes, pos: int, flags, short: int, same: int):
    """One axis of a simple glyph's points: short (a byte, ``same`` its
    sign) or long (an int16) deltas, or a repeat of the last value;
    returns the absolute values and the position after them."""
    out = []
    v = 0
    for f in flags:
        if f & short:
            d = buf[pos]
            pos += 1
            v += d if f & same else -d
        elif not f & same:
            v += struct.unpack_from(">h", buf, pos)[0]
            pos += 2
        out.append(v)
    return out, pos


def _parse_components(buf: bytes) -> List[Component]:
    out = []
    pos = 10
    more = True
    while more:
        flags, gid = struct.unpack_from(">HH", buf, pos)
        pos += 4
        xy = flags & ARGS_ARE_XY_VALUES
        if flags & ARG_1_AND_2_ARE_WORDS:
            args = struct.unpack_from(">hh" if xy else ">HH", buf, pos)
            pos += 4
        else:
            args = struct.unpack_from(">bb" if xy else ">BB", buf, pos)
            pos += 2
        matrix = None
        if flags & WE_HAVE_A_SCALE:
            s = _f2dot14(struct.unpack_from(">h", buf, pos)[0])
            matrix = (s, 0, 0, s)
            pos += 2
        elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
            sx, sy = struct.unpack_from(">hh", buf, pos)
            matrix = (_f2dot14(sx), 0, 0, _f2dot14(sy))
            pos += 4
        elif flags & WE_HAVE_A_TWO_BY_TWO:
            matrix = tuple(_f2dot14(v) for v in
                           struct.unpack_from(">hhhh", buf, pos))
            pos += 8
        out.append(Component(gid, flags, matrix, tuple(args)))
        more = bool(flags & MORE_COMPONENTS)
    return out


# -- COLR v1 ---------------------------------------------------------------

class _Reader:
    """Bounds-checked big-endian reads from one table (``name`` for its
    errors)."""

    def __init__(self, name: str, data: bytes):
        self.name = name
        self.data = data

    def unpack(self, fmt: str, offset: int) -> tuple:
        size = struct.calcsize(fmt)
        if offset < 0 or offset + size > len(self.data):
            raise ValueError(f"{self.name}: {size} bytes at offset {offset} "
                             f"lie outside the table ({len(self.data)} "
                             f"bytes)")
        return struct.unpack_from(fmt, self.data, offset)

    def offset24(self, offset: int) -> int:
        hi, lo = self.unpack(">BH", offset)
        return hi << 16 | lo


@dataclass
class ColorStop:
    StopOffset: float
    PaletteIndex: int
    Alpha: float


@dataclass
class ColorLine:
    Extend: int
    ColorStop: List[ColorStop]


@dataclass
class Affine2x3:
    xx: float
    yx: float
    xy: float
    yy: float
    dx: float
    dy: float


def _angle(v: int, bias: float = 0.0) -> float:
    return (v / 16384 + bias) * 180


# value kind -> (struct code, decode)
_SCALARS = {
    "u8": (">B", int), "u16": (">H", int), "u32": (">L", int),
    "fword": (">h", int), "ufword": (">H", int), "glyph": (">H", int),
    "f2dot14": (">h", _f2dot14), "angle": (">h", _angle),
    "biased_angle": (">h", lambda v: _angle(v, 1.0)),
}
# what an Offset24 field points to
_CHILD_KINDS = ("paint", "line", "var_line", "affine", "var_affine")

# the static paint formats: format -> its fields after the format byte,
# (fontTools' name, kind), in the order the table holds them
_PAINT_FIELDS = {
    1: (("NumLayers", "u8"), ("FirstLayerIndex", "u32")),
    2: (("PaletteIndex", "u16"), ("Alpha", "f2dot14")),
    4: (("ColorLine", "line"), ("x0", "fword"), ("y0", "fword"),
        ("x1", "fword"), ("y1", "fword"), ("x2", "fword"), ("y2", "fword")),
    6: (("ColorLine", "line"), ("x0", "fword"), ("y0", "fword"),
        ("r0", "ufword"), ("x1", "fword"), ("y1", "fword"),
        ("r1", "ufword")),
    8: (("ColorLine", "line"), ("centerX", "fword"), ("centerY", "fword"),
        ("startAngle", "biased_angle"), ("endAngle", "biased_angle")),
    10: (("Paint", "paint"), ("Glyph", "glyph")),
    11: (("Glyph", "glyph"),),
    12: (("Paint", "paint"), ("Transform", "affine")),
    14: (("Paint", "paint"), ("dx", "fword"), ("dy", "fword")),
    16: (("Paint", "paint"), ("scaleX", "f2dot14"), ("scaleY", "f2dot14")),
    18: (("Paint", "paint"), ("scaleX", "f2dot14"), ("scaleY", "f2dot14"),
         ("centerX", "fword"), ("centerY", "fword")),
    20: (("Paint", "paint"), ("scale", "f2dot14")),
    22: (("Paint", "paint"), ("scale", "f2dot14"), ("centerX", "fword"),
         ("centerY", "fword")),
    24: (("Paint", "paint"), ("angle", "angle")),
    26: (("Paint", "paint"), ("angle", "angle"), ("centerX", "fword"),
         ("centerY", "fword")),
    28: (("Paint", "paint"), ("xSkewAngle", "angle"),
         ("ySkewAngle", "angle")),
    30: (("Paint", "paint"), ("xSkewAngle", "angle"), ("ySkewAngle", "angle"),
         ("centerX", "fword"), ("centerY", "fword")),
    32: (("SourcePaint", "paint"), ("CompositeMode", "u8"),
         ("BackdropPaint", "paint")),
}
# each Var format (the odd ones but 1 and 11), one past its static twin,
# has the twin's fields with a VarColorLine or VarAffine2x3 in place of a
# ColorLine or Affine2x3 and, but for PaintVarTransform (13), a trailing
# VarIndexBase (read and skipped: its name is None)
for _f in (3, 5, 7, 9, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31):
    _PAINT_FIELDS[_f] = tuple(
        (name, {"line": "var_line", "affine": "var_affine"}.get(kind, kind))
        for name, kind in _PAINT_FIELDS[_f - 1]) + (
            () if _f == 13 else ((None, "u32"),))
del _f


class Paint:
    """One COLR v1 paint table: ``Format`` and its fields under fontTools'
    names and values. A child paint (``Paint``, ``SourcePaint``,
    ``BackdropPaint``) is read when first asked for, so that a walk that
    stops at its depth limit reads no deeper; ``field_names`` lists the
    fields in table order."""

    def __init__(self, table: "ColrV1Table", fmt: int, fields: dict,
                 children: dict, names: tuple):
        self.Format = fmt
        self.__dict__.update(fields)
        self._table = table
        self._children = children       # name -> offset in the table
        self.field_names = names

    def __getattr__(self, name):
        children = self.__dict__.get("_children", {})
        if name in children:
            return self._table.paint(children[name])
        raise AttributeError(name)


class ColrV1Table:
    """A COLR v1 table: ``base`` (glyph id -> its root Paint, from the
    BaseGlyphList) and ``layers`` (the LayerList's Paints). The ClipList,
    VarIndexMap and ItemVariationStore offsets are read and not used."""

    def __init__(self, colr: bytes):
        self.r = _Reader("COLR", colr)
        # the ClipList, VarIndexMap and ItemVariationStore offsets end the
        # header; the Var paints are read at their defaults
        (_, _, _, _, _, base_list, layer_list, _, _,
         _) = self.r.unpack(">HHLLHLLLLL", 0)
        self._paints: Dict[int, Paint] = {}
        self.layers: List[Paint] = []
        if layer_list:
            (n,) = self.r.unpack(">L", layer_list)
            offsets = self.r.unpack(f">{n}L", layer_list + 4)
            self.layers = [self.paint(layer_list + o) for o in offsets]
        self.base: Dict[int, Paint] = {}
        if base_list:
            (n,) = self.r.unpack(">L", base_list)
            for i in range(n):
                gid, offset = self.r.unpack(">HL", base_list + 4 + 6 * i)
                self.base[gid] = self.paint(base_list + offset)
        for p in self._paints.values():
            if p.Format == 1 and (p.FirstLayerIndex + p.NumLayers
                                  > len(self.layers)):
                raise ValueError(
                    f"COLR: PaintColrLayers takes layers "
                    f"{p.FirstLayerIndex}..{p.FirstLayerIndex + p.NumLayers}"
                    f" of a LayerList of {len(self.layers)}")

    def paint(self, offset: int) -> Paint:
        """The paint table at ``offset`` in COLR (read once)."""
        got = self._paints.get(offset)
        if got is None:
            got = self._paints[offset] = self._read_paint(offset)
        return got

    def _read_paint(self, offset: int) -> Paint:
        (fmt,) = self.r.unpack(">B", offset)
        spec = _PAINT_FIELDS.get(fmt)
        if spec is None:
            raise ValueError(f"COLR: paint format {fmt} at offset {offset} "
                             f"is not one of 1-32")
        fields, children = {}, {}
        pos = offset + 1
        for name, kind in spec:
            if kind in _CHILD_KINDS:
                child = self.r.offset24(pos)
                pos += 3
                if not child:
                    raise ValueError(f"COLR: paint format {fmt} at offset "
                                     f"{offset} has a null {name}")
                if kind == "paint":
                    children[name] = offset + child
                elif kind in ("line", "var_line"):
                    fields[name] = self._color_line(offset + child,
                                                    kind == "var_line")
                else:
                    fields[name] = Affine2x3(*(
                        v / 65536 for v in self.r.unpack(">6l",
                                                         offset + child)))
                    if kind == "var_affine":
                        self.r.unpack(">L", offset + child + 24)
                continue
            code, decode = _SCALARS[kind]
            (v,) = self.r.unpack(code, pos)
            pos += struct.calcsize(code)
            if name is not None:
                fields[name] = decode(v)
        names = tuple(name for name, _ in spec if name is not None)
        return Paint(self, fmt, fields, children, names)

    def _color_line(self, offset: int, var: bool) -> ColorLine:
        extend, n = self.r.unpack(">BH", offset)
        size = 10 if var else 6
        stops = []
        for i in range(n):
            stop, index, alpha = self.r.unpack(">hHh",
                                               offset + 3 + size * i)
            if var:
                self.r.unpack(">L", offset + 3 + size * i + 6)
            stops.append(ColorStop(_f2dot14(stop), index, _f2dot14(alpha)))
        return ColorLine(extend, stops)


# -- bitmap strikes (CBLC/CBDT, sbix) ----------------------------------------

# glyph metrics records: height, width, bearing x, bearing y, advance (the
# horizontal part of BigGlyphMetrics, whose vertical part follows)
SMALL_METRICS = ">BBbbB"
BIG_METRICS = ">BBbbBbbB"


@dataclass
class BitmapStrike:
    ppem_x: int
    ppem_y: int
    # glyph id -> (offset of its record in CBDT, its length, its image
    # format, the BigGlyphMetrics of an index subtable of format 2 or 5)
    glyphs: Dict[int, tuple]


@dataclass
class BitmapGlyph:
    image_format: int           # 17, 18 or 19
    # (height, width, bearing x, bearing y, advance), horizontal: the
    # glyph's own metrics (17: small, 18: big) or, for 19, its index's
    metrics: Tuple[int, int, int, int, int]
    png: bytes


@dataclass
class SbixGlyph:
    origin_x: int
    origin_y: int
    graphic_type: str
    data: bytes


def _read_cblc(cblc: bytes) -> List[BitmapStrike]:
    r = _Reader("CBLC", cblc)
    (n_sizes,) = r.unpack(">L", 4)
    strikes = []
    for i in range(n_sizes):
        rec = 8 + 48 * i
        array, _, n_subtables = r.unpack(">LLL", rec)
        ppem_x, ppem_y = r.unpack(">BB", rec + 44)
        glyphs: Dict[int, tuple] = {}
        for k in range(n_subtables):
            first, last, extra = r.unpack(">HHL", array + 8 * k)
            sub = array + extra
            index_format, image_format, data_offset = r.unpack(">HHL", sub)
            if image_format not in (17, 18, 19):
                raise ValueError(f"CBLC: image format {image_format} is not "
                                 f"a CBDT PNG format (17, 18 or 19)")
            n = last - first + 1
            metrics = None
            located = []                   # (glyph id, start, length)
            if index_format in (1, 3):
                offs = r.unpack(f">{n + 1}{'L' if index_format == 1 else 'H'}",
                                sub + 8)
                located = [(first + j, offs[j], offs[j + 1] - offs[j])
                           for j in range(n)]
            elif index_format in (2, 5):
                (size,) = r.unpack(">L", sub + 8)
                metrics = r.unpack(BIG_METRICS, sub + 12)[:5]
                if index_format == 2:
                    ids = range(first, last + 1)
                else:
                    (count,) = r.unpack(">L", sub + 20)
                    ids = r.unpack(f">{count}H", sub + 24)
                located = [(gid, size * j, size) for j, gid in enumerate(ids)]
            elif index_format == 4:
                (count,) = r.unpack(">L", sub + 8)
                pairs = r.unpack(f">{2 * (count + 1)}H", sub + 12)
                located = [(pairs[2 * j], pairs[2 * j + 1],
                            pairs[2 * j + 3] - pairs[2 * j + 1])
                           for j in range(count)]
            else:
                raise ValueError(f"CBLC: index subtable format "
                                 f"{index_format} is not one of 1-5")
            if image_format == 19 and metrics is None:
                raise ValueError(f"CBLC: image format 19 under index format "
                                 f"{index_format}, which holds no metrics")
            for gid, start, length in located:
                if length > 0:          # an empty record is no glyph
                    glyphs[gid] = (data_offset + start, length, image_format,
                                   metrics)
        strikes.append(BitmapStrike(ppem_x, ppem_y, glyphs))
    return strikes


def _read_cbdt_glyph(cbdt: bytes, offset: int, length: int,
                     image_format: int, index_metrics) -> BitmapGlyph:
    r = _Reader("CBDT", cbdt)
    r.unpack(f">{length}x", offset)
    if image_format == 17:
        metrics = r.unpack(SMALL_METRICS, offset)
        pos = offset + 5
    elif image_format == 18:
        metrics = r.unpack(BIG_METRICS, offset)[:5]
        pos = offset + 8
    else:
        metrics, pos = index_metrics, offset
    (n,) = r.unpack(">L", pos)
    if pos + 4 + n > offset + length:
        raise ValueError(f"CBDT: a PNG of {n} bytes overruns its glyph "
                         f"record of {length} bytes at offset {offset}")
    return BitmapGlyph(image_format, tuple(metrics),
                       cbdt[pos + 4:pos + 4 + n])


def _read_sbix(sbix: bytes, num_glyphs: int) -> Dict[int, Dict[int,
                                                              SbixGlyph]]:
    r = _Reader("sbix", sbix)
    (n_strikes,) = r.unpack(">L", 4)
    strikes: Dict[int, Dict[int, SbixGlyph]] = {}
    for offset in r.unpack(f">{n_strikes}L", 8):
        ppem, _ = r.unpack(">HH", offset)
        if ppem in strikes:
            raise ValueError(f"sbix: two strikes of ppem {ppem}")
        offs = r.unpack(f">{num_glyphs + 1}L", offset + 4)
        glyphs = {}
        for gid in range(num_glyphs):
            start, end = offset + offs[gid], offset + offs[gid + 1]
            if end == start:
                continue
            if end < start + 8:
                raise ValueError(f"sbix: glyph {gid} of strike {ppem} has a "
                                 f"record of {end - start} bytes")
            ox, oy, tag = r.unpack(">hh4s", start)
            r.unpack(f">{end - start}x", start)
            glyphs[gid] = SbixGlyph(ox, oy, tag.decode("latin-1"),
                                    sbix[start + 8:end])
        strikes[ppem] = glyphs
    return strikes
