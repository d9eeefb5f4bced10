"""Scene encoding: packed SoA streams + the path-tag state machine.

Mirrors the reference's stream design (``vello_encoding/src/encoding.rs:26-53``,
tag semantics per ``doc/pathseg.md:13-63``) with TPU-driven simplifications:

* Coordinates are always f32 (no i16 variant) — the device gathers them
  directly; there is no byte-unpacking win on TPU.
* The path-tag monoid is a vector of additive counters, so the device-side
  "pathtag scan" is a plain exclusive cumsum (see ops/pathtag.py) rather than
  the reference's 2/3-level reduce-then-scan tree.
* Draw payloads are kept as typed records host-side and resolved to dense SoA
  arrays by the Resolver; only the path streams use the packed-tag encoding.

Tag byte layout (f32-only subset of the reference scheme):
  bits 0-1: segment kind (1=line, 2=quad, 3=cubic)
  bit 2:    subpath-end (segment consumes its final point)
  bit 4:    path marker (0x10) — appended after a path's segments
  bit 5:    transform marker (0x20)
  bit 6:    style marker (0x40)
A segment reads (tag&3)+1 points starting at its scanned point offset; the
monoid advances by (tag&3) + end_bit points so consecutive segments share
their join point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from ..kurbo import (Affine, BezPath, CLOSE, CURVE_TO, LINE_TO, MOVE_TO,
                     QUAD_TO, Stroke)
from ..peniko import BlendMode, Brush, Color, Fill, Gradient, Image

# Tag constants
TAG_LINE = 1
TAG_QUAD = 2
TAG_CUBIC = 3
TAG_END_BIT = 0x4
TAG_PATH = 0x10
TAG_TRANSFORM = 0x20
TAG_STYLE = 0x40

# Draw record kinds
DRAW_COLOR = 0
DRAW_GRADIENT = 1
DRAW_IMAGE = 2
DRAW_BEGIN_LAYER = 3
DRAW_END_LAYER = 4
DRAW_BLUR_RECT = 5


@dataclass
class DrawRecord:
    kind: int
    fill_rule: int = int(Fill.NON_ZERO)
    brush: Optional[Brush] = None
    brush_transform: Optional[Affine] = None   # composed with path transform
    # layer fields
    blend: Optional[BlendMode] = None
    alpha: float = 1.0
    has_path: bool = True
    # blurred rounded rect fields
    blur_rect: Optional[Tuple[float, float, float, float]] = None
    blur_radius: float = 0.0
    blur_std_dev: float = 0.0
    # paint 1-coverage instead (inset box shadows; reference
    # vello_cpu/src/render.rs fill_blurred_rounded_rect invert)
    blur_inverse: bool = False
    # layer filter: (kind, sigma, dx, dy, r, g, b, a) — see ops/filters.py
    layer_filter: Optional[Tuple] = None
    # Batched solid fills (Scene.fill_batch): this ONE record stands for
    # batch_colors.shape[0] consecutive color draws — the resolver assigns
    # the whole block vectorised instead of walking N Python records
    # (30k records cost ~0.3 s/frame of pure interpreter overhead).
    batch_colors: Optional[np.ndarray] = None   # (N, 4) straight RGBA


class Encoding:
    """Appendable SoA scene encoding."""

    def __init__(self):
        self.path_tags: List[int] = []
        self.path_data: List[float] = []       # flat x,y pairs
        self.transforms: List[Tuple[float, ...]] = []
        self.styles: List[int] = []            # fill rule per style entry
        # stroke half-width per style entry (0.0 = fill). Parallels the
        # reference's Style stream carrying fill-vs-stroke + line width
        # (vello_encoding/src/path.rs Style); device-expanded strokes
        # flatten their centerlines in-frame (flatten.wgsl:328-630 role).
        self.style_hw: List[float] = []
        self.draws: List[DrawRecord] = []
        self.n_paths = 0
        self.n_path_segments = 0
        self.n_open_layers = 0

    def is_empty(self) -> bool:
        return not self.path_tags and not self.draws

    def reset(self):
        self.__init__()

    # -- stream appends ----------------------------------------------------
    def encode_transform(self, t: Affine) -> None:
        c = tuple(float(v) for v in t.coeffs)
        if self.transforms and self.transforms[-1] == c:
            return
        self.transforms.append(c)
        self.path_tags.append(TAG_TRANSFORM)

    def encode_fill_style(self, fill: Fill) -> None:
        s = int(fill)
        if self.styles and self.styles[-1] == s and self.style_hw[-1] == 0.0:
            return
        self.styles.append(s)
        self.style_hw.append(0.0)
        self.path_tags.append(TAG_STYLE)

    def encode_stroke_style(self, width: float) -> None:
        """Style entry for a DEVICE-expanded stroke: the following paths'
        centerline segments are offset/joined in the device flatten stage
        (ops/flatten.py stroke branch) instead of being outlined on the
        host. Winding rule is NonZero (the quad/bevel union is positively
        oriented by construction)."""
        hw = float(width) * 0.5
        if self.styles and self.styles[-1] == int(Fill.NON_ZERO) \
                and self.style_hw[-1] == hw:
            return
        self.styles.append(int(Fill.NON_ZERO))
        self.style_hw.append(hw)
        self.path_tags.append(TAG_STYLE)

    def encode_path(self, path: BezPath, is_fill: bool = True) -> bool:
        """Encode a BezPath; returns False if it produced no segments.

        Uses the C++ encoder (native/vello_native.cpp) when available; the
        Python state machine below is the reference implementation and
        fallback (byte-identical output, tested in test_encoding_native).
        """
        from .. import native
        if native.available() and path.verbs:
            tags, data, n_segs = native.encode_path(
                np.asarray(path.verbs, dtype=np.uint8),
                np.asarray(path.points, dtype=np.float32)
                if path.points else np.zeros((0, 2), np.float32),
                close_subpaths=is_fill)
            if n_segs == 0:
                return False
            self.path_tags.extend(tags.tolist())
            self.path_data.extend(data.reshape(-1).tolist())
            self.path_tags.append(TAG_PATH)
            self.n_paths += 1
            self.n_path_segments += n_segs
            return True
        enc = PathEncoder(self)
        for verb, pts in path.elements():
            if verb == MOVE_TO:
                enc.move_to(*pts[0])
            elif verb == LINE_TO:
                enc.line_to(*pts[0])
            elif verb == QUAD_TO:
                enc.quad_to(*pts[0], *pts[1])
            elif verb == CURVE_TO:
                enc.curve_to(*pts[0], *pts[1], *pts[2])
            elif verb == CLOSE:
                enc.close()
        n = enc.finish(insert_path_marker=True, close_subpaths=is_fill)
        return n > 0

    def encode_polygons(self, polys: List[np.ndarray]) -> bool:
        """Encode pre-flattened closed polygons (stroke expansion output)."""
        from .. import native
        if native.available() and polys:
            sizes = np.asarray([len(p) for p in polys], dtype=np.int32)
            cat = (np.concatenate([np.asarray(p, dtype=np.float32)
                                   for p in polys])
                   if len(polys) else np.zeros((0, 2), np.float32))
            tags, data, n_segs = native.encode_polygons(cat, sizes)
            if n_segs == 0:
                return False
            self.path_tags.extend(tags.tolist())
            self.path_data.extend(data.reshape(-1).tolist())
            self.path_tags.append(TAG_PATH)
            self.n_paths += 1
            self.n_path_segments += n_segs
            return True
        enc = PathEncoder(self)
        for poly in polys:
            if len(poly) < 2:
                continue
            enc.move_to(float(poly[0, 0]), float(poly[0, 1]))
            for p in poly[1:]:
                enc.line_to(float(p[0]), float(p[1]))
            enc.close()
        n = enc.finish(insert_path_marker=True, close_subpaths=True)
        return n > 0

    def encode_draw(self, rec: DrawRecord) -> None:
        self.draws.append(rec)

    def encode_path_batch(self, pts: np.ndarray, seg_kind: int) -> int:
        """Encode N single-subpath CLOSED paths with a uniform segment kind
        in one vectorised append (the batched-SceneBuilder role; reference
        encodes per path, ``vello_encoding/src/path.rs``, but its Rust
        per-call cost is ~ns — the Python equivalent is the host-encode
        bottleneck at mmark scale, so the batch API exists here).

        pts: (N, 1 + kind*k, 2) f32 — moveto point then k segments' control
        points. Paths must end at their start point (no auto-close line).
        Returns the number of paths encoded."""
        pts = np.asarray(pts, dtype=np.float32)
        n, p, _ = pts.shape
        k, rem = divmod(p - 1, seg_kind)
        if n == 0 or k <= 0 or rem:
            raise ValueError(f"bad batch shape {pts.shape} for kind "
                             f"{seg_kind}")
        tpl = np.full(k + 1, seg_kind, dtype=np.int64)
        tpl[k - 1] |= TAG_END_BIT
        tpl[k] = TAG_PATH
        self.path_tags.extend(np.tile(tpl, n).tolist())
        self.path_data.extend(pts.reshape(-1).tolist())
        self.n_paths += n
        self.n_path_segments += n * k
        return n

    def encode_stroke_path_batch(self, pts: np.ndarray,
                                 widths: np.ndarray) -> int:
        """N OPEN cubic centerline paths with per-path stroke styles in one
        vectorised append — the device expands them in-frame (ops/flatten
        stroke branch; the role of the reference's flatten.wgsl:328-630).
        Uploading centerlines instead of host-expanded outlines keeps the
        stream at cubic-segment scale (~16x smaller for stroke-heavy
        scenes, measured at mmark-30k).

        pts: (N, 1 + 3k, 2) f32 — start point + k cubic segments.
        widths: (N,) full stroke widths. Returns N."""
        pts = np.asarray(pts, dtype=np.float32)
        n, p, _ = pts.shape
        k, rem = divmod(p - 1, 3)
        if n == 0 or k <= 0 or rem:
            raise ValueError(f"bad stroke batch shape {pts.shape}")
        widths = np.broadcast_to(np.asarray(widths, np.float64), (n,))
        if (widths <= 0).any():
            raise ValueError("stroke widths must be positive")
        # [STYLE, k segments (last carries END), PATH] per path
        tpl = np.full(k + 2, TAG_CUBIC, dtype=np.int64)
        tpl[0] = TAG_STYLE
        tpl[k] |= TAG_END_BIT
        tpl[k + 1] = TAG_PATH
        self.path_tags.extend(np.tile(tpl, n).tolist())
        self.path_data.extend(pts.reshape(-1).tolist())
        self.styles.extend([int(Fill.NON_ZERO)] * n)
        self.style_hw.extend((widths * 0.5).tolist())
        self.n_paths += n
        self.n_path_segments += n * k
        return n

    def encode_polygons_flat(self, cat: np.ndarray,
                             sizes: np.ndarray) -> int:
        """Encode Q closed polygons as Q single-subpath paths in one
        vectorised append (the stroke-batch analog of encode_path_batch;
        per-polygon encode_polygons cost ~40 us of Python at mmark scale).

        cat (M, 2) f32 concatenated polygon points (polygon q occupies
        sizes[q] rows, NOT repeated at the end); sizes (Q,). Each polygon
        closes with an explicit line back to its first point. Returns Q."""
        sizes = np.asarray(sizes, dtype=np.int64)
        q = len(sizes)
        if q == 0:
            return 0
        if (sizes < 2).any():
            # sizes==1 would OR the END bit into the previous polygon's
            # TAG_PATH marker; sizes==0 would wrap tends-1 to the stream
            # end — both corrupt the tag stream.
            raise ValueError("encode_polygons_flat: every polygon needs "
                             ">= 2 points")
        cat = np.asarray(cat, dtype=np.float32)
        # tags: per polygon [1]*v with END on the last, then TAG_PATH
        tags = np.ones(int((sizes + 1).sum()), dtype=np.int64)
        tends = np.cumsum(sizes + 1) - 1
        tags[tends - 1] |= TAG_END_BIT
        tags[tends] = TAG_PATH
        # data: per polygon its v points + the first point again (the
        # closing line's endpoint, consumed by the end bit)
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        data = np.empty((int(sizes.sum()) + q, 2), dtype=np.float32)
        dstarts = offs + np.arange(q)
        dends = dstarts + sizes
        data[dends] = cat[offs]
        mask = np.ones(len(data), dtype=bool)
        mask[dends] = False
        data[mask] = cat
        self.path_tags.extend(tags.tolist())
        self.path_data.extend(data.reshape(-1).tolist())
        self.n_paths += q
        self.n_path_segments += int(sizes.sum())
        return q

    def append(self, other: "Encoding", transform: Affine = None) -> None:
        """Append another encoding, optionally rebasing its transforms
        (``encoding.rs:94-174``)."""
        if transform is not None and not transform.is_identity():
            # Tags preceding other's FIRST transform marker bind to the
            # encoding-initial implicit identity; without an explicit
            # marker they would silently bind to self's LAST transform
            # after the append. Prepend the rebased identity when other's
            # stream doesn't open with a marker (encoding.rs append
            # semantics).
            if other.path_tags:
                try:
                    ft = other.path_tags.index(TAG_TRANSFORM)
                except ValueError:
                    ft = -1
                if ft != 0:
                    self.transforms.append(
                        tuple(float(v) for v in transform.coeffs))
                    self.path_tags.append(TAG_TRANSFORM)
            for c in other.transforms:
                t = transform @ Affine(c)
                self.transforms.append(tuple(float(v) for v in t.coeffs))
        else:
            self.transforms.extend(other.transforms)
        self.path_tags.extend(other.path_tags)
        self.path_data.extend(other.path_data)
        self.styles.extend(other.styles)
        self.style_hw.extend(other.style_hw)
        self.draws.extend(other.draws)
        self.n_paths += other.n_paths
        self.n_path_segments += other.n_path_segments
        self.n_open_layers += other.n_open_layers

    # -- packing -------------------------------------------------------------
    def packed_streams(self):
        """Return the numpy stream arrays for the device / oracle."""
        tags = np.asarray(self.path_tags, dtype=np.uint8)
        data = np.asarray(self.path_data, dtype=np.float32).reshape(-1, 2)
        transforms = (np.asarray(self.transforms, dtype=np.float32)
                      if self.transforms
                      else np.zeros((0, 6), dtype=np.float32))
        styles = np.asarray(self.styles, dtype=np.int32)
        return tags, data, transforms, styles

    def style_hw_array(self) -> np.ndarray:
        """Per-style-entry stroke half-widths (0 = fill), parallel to the
        styles stream from packed_streams()."""
        return np.asarray(self.style_hw, dtype=np.float32)


class PathEncoder:
    """State machine converting verbs to the tag encoding.

    Matches the semantics of ``vello_encoding/src/path.rs:426-878``: the
    moveto point is encoded once; end-subpath bits close segment runs; lone
    movetos are elided; for fills, open subpaths are closed with a lineto.
    """

    def __init__(self, enc: Encoding):
        self.enc = enc
        self.first_pt: Optional[Tuple[float, float]] = None
        self.cur_pt: Optional[Tuple[float, float]] = None
        self.nsub_segs = 0          # segments in current subpath
        self.n_segments = 0
        self._start_in_data = False  # subpath start point present & unconsumed
        self._last_tag_idx = -1

    def _end_subpath(self, close_line: bool):
        """End the current subpath: optional closing line, set end bit."""
        if self.nsub_segs == 0:
            if self._start_in_data:
                # Lone moveto: remove the orphan point.
                del self.enc.path_data[-2:]
                self._start_in_data = False
            return
        if close_line and self.cur_pt != self.first_pt:
            self._emit(TAG_LINE, [self.first_pt])
        self.enc.path_tags[self._last_tag_idx] |= TAG_END_BIT
        self.nsub_segs = 0
        # The end-bit advance consumes the shared final point; a new segment
        # without a fresh moveto must re-append its start point.
        self._start_in_data = False

    def move_to(self, x: float, y: float):
        self._end_subpath(close_line=True)
        self.first_pt = (float(x), float(y))
        self.cur_pt = self.first_pt
        self.enc.path_data.extend(self.first_pt)
        self._start_in_data = True
        self.nsub_segs = 0

    def _emit(self, kind: int, pts):
        # Drop zero-length linetos (they contribute nothing).
        if kind == TAG_LINE and pts[0] == self.cur_pt:
            return
        if not self._start_in_data:
            # Resuming after close(): the new subpath starts at cur_pt.
            self.enc.path_data.extend(self.cur_pt)
            self.first_pt = self.cur_pt
            self._start_in_data = True
        self.enc.path_tags.append(kind)
        self._last_tag_idx = len(self.enc.path_tags) - 1
        for p in pts:
            self.enc.path_data.extend((float(p[0]), float(p[1])))
        self.cur_pt = pts[-1]
        self.nsub_segs += 1
        self.n_segments += 1

    def line_to(self, x: float, y: float):
        if self.cur_pt is None:
            return
        self._emit(TAG_LINE, [(float(x), float(y))])

    def quad_to(self, x1, y1, x2, y2):
        if self.cur_pt is None:
            return
        self._emit(TAG_QUAD, [(float(x1), float(y1)), (float(x2), float(y2))])

    def curve_to(self, x1, y1, x2, y2, x3, y3):
        if self.cur_pt is None:
            return
        self._emit(TAG_CUBIC, [(float(x1), float(y1)),
                               (float(x2), float(y2)),
                               (float(x3), float(y3))])

    def close(self):
        if self.cur_pt is None or self.nsub_segs == 0:
            return
        cur = self.cur_pt
        self._end_subpath(close_line=True)
        self.cur_pt = self.first_pt
        del cur

    def finish(self, insert_path_marker: bool, close_subpaths: bool) -> int:
        self._end_subpath(close_line=close_subpaths)
        if self.nsub_segs > 0:
            # Unclosed subpath kept open (stroke-style encodes).
            self.enc.path_tags[self._last_tag_idx] |= TAG_END_BIT
            self.nsub_segs = 0
            self._start_in_data = False
        if self.n_segments > 0 and insert_path_marker:
            self.enc.path_tags.append(TAG_PATH)
            self.enc.n_paths += 1
        self.enc.n_path_segments += self.n_segments
        return self.n_segments


def decode_segments(tags: np.ndarray, data: np.ndarray,
                    transforms: np.ndarray, styles: np.ndarray,
                    style_hw: np.ndarray = None):
    """Host-side (numpy) reference decode of the tag streams.

    Returns dict of per-segment arrays: kind (1/2/3), points (S,4,2) padded,
    path_ix, trans_ix, style. Exactly the computation the device performs in
    ops/pathtag.py — used by the oracle and by tests as the golden model.

    style_hw: optional per-style stroke half-widths; adds "hw" (S,) f32
    (0 = fill) and "join" (S,) i32 (1 when the NEXT segment continues the
    same subpath — the end bit is unset) to the output.
    """
    tags = tags.astype(np.int64)
    kind = tags & 3
    is_seg = (kind > 0).astype(np.int64)
    end_bit = ((tags >> 2) & 1) * is_seg
    size = kind + end_bit
    # Exclusive scans
    pt_off = np.cumsum(size) - size
    path_ix = np.cumsum((tags >> 4) & 1) - ((tags >> 4) & 1)
    trans_ix = np.cumsum((tags >> 5) & 1) - ((tags >> 5) & 1)
    style_ix = np.cumsum((tags >> 6) & 1) - ((tags >> 6) & 1)
    sel = is_seg.astype(bool)
    s_kind = kind[sel]
    s_off = pt_off[sel]
    n = len(s_kind)
    pts = np.zeros((n, 4, 2), dtype=np.float32)
    for i in range(4):
        idx = np.minimum(s_off + i, len(data) - 1) if len(data) else \
            np.zeros_like(s_off)
        valid = i <= s_kind  # kind k segment has k+1 points
        if len(data):
            pts[:, i] = np.where(valid[:, None], data[idx], 0.0)
    s_path = path_ix[sel]
    # Transform/style markers PRECEDE their segments, so the active entry is
    # (count of markers before) - 1. Path markers FOLLOW their segments, so
    # path_ix needs no adjustment.
    s_trans = np.clip(trans_ix[sel] + ((tags[sel] >> 5) & 1) - 1, 0,
                      max(len(transforms) - 1, 0)).astype(np.int64)
    s_style_ix = np.clip(style_ix[sel] + ((tags[sel] >> 6) & 1) - 1, 0,
                         max(len(styles) - 1, 0)).astype(np.int64)
    s_style = styles[s_style_ix] if len(styles) else np.zeros(n, np.int32)
    tmat = transforms[s_trans] if len(transforms) else \
        np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), (n, 1))
    out = {
        "kind": s_kind.astype(np.int32),
        "points": pts,
        "path_ix": s_path.astype(np.int32),
        "transform": tmat,
        "fill_rule": s_style.astype(np.int32),
        "n_paths": int(((tags >> 4) & 1).sum()),
    }
    if style_hw is not None and len(style_hw):
        out["hw"] = style_hw[s_style_ix].astype(np.float32)
        out["join"] = (1 - end_bit[sel]).astype(np.int32)
    else:
        out["hw"] = np.zeros(n, np.float32)
        out["join"] = np.zeros(n, np.int32)
    return out
