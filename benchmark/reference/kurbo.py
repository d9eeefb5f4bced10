"""2D geometry foundation (the role of the ``kurbo`` crate in the reference).

Provides affine transforms, Bezier paths, rects, shapes (circle/ellipse/
rounded-rect/arc), and host-side curve flattening used by the CPU oracle and
the capacity estimator.  Everything is plain Python + NumPy; the device
pipeline has its own vectorised flattening in ``ops.flatten``.

Reference parity: kurbo 0.13 subset as used by vello
(``vello/src/scene.rs:14-22``, ``Cargo.toml:82-107``).
This is a from-scratch implementation of standard computational-geometry
formulas, not a translation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

import numpy as np

Point = Tuple[float, float]

# Path verb codes (shared with the encoder and the oracle).
MOVE_TO = 0
LINE_TO = 1
QUAD_TO = 2
CURVE_TO = 3
CLOSE = 4

_VERB_POINTS = {MOVE_TO: 1, LINE_TO: 1, QUAD_TO: 2, CURVE_TO: 3, CLOSE: 0}


@dataclass(frozen=True)
class Affine:
    """Affine transform, stored as [xx, yx, xy, yy, dx, dy] (kurbo layout).

    Maps (x, y) -> (xx*x + xy*y + dx, yx*x + yy*y + dy).
    """

    coeffs: Tuple[float, float, float, float, float, float] = (
        1.0, 0.0, 0.0, 1.0, 0.0, 0.0)

    IDENTITY: "Affine" = None  # set below

    @staticmethod
    def identity() -> "Affine":
        return Affine()

    @staticmethod
    def translate(dx: float, dy: float) -> "Affine":
        return Affine((1.0, 0.0, 0.0, 1.0, float(dx), float(dy)))

    @staticmethod
    def scale(sx: float, sy: float = None) -> "Affine":
        if sy is None:
            sy = sx
        return Affine((float(sx), 0.0, 0.0, float(sy), 0.0, 0.0))

    @staticmethod
    def rotate(theta: float) -> "Affine":
        c, s = math.cos(theta), math.sin(theta)
        return Affine((c, s, -s, c, 0.0, 0.0))

    @staticmethod
    def rotate_about(theta: float, cx: float, cy: float) -> "Affine":
        return (Affine.translate(cx, cy) @ Affine.rotate(theta)
                @ Affine.translate(-cx, -cy))

    @staticmethod
    def skew(sx: float, sy: float) -> "Affine":
        return Affine((1.0, math.tan(sy), math.tan(sx), 1.0, 0.0, 0.0))

    def __matmul__(self, other: "Affine") -> "Affine":
        a = self.coeffs
        b = other.coeffs
        return Affine((
            a[0] * b[0] + a[2] * b[1],
            a[1] * b[0] + a[3] * b[1],
            a[0] * b[2] + a[2] * b[3],
            a[1] * b[2] + a[3] * b[3],
            a[0] * b[4] + a[2] * b[5] + a[4],
            a[1] * b[4] + a[3] * b[5] + a[5],
        ))

    def apply(self, pts: np.ndarray) -> np.ndarray:
        """Apply to an (..., 2) array of points."""
        pts = np.asarray(pts, dtype=np.float64)
        a = self.coeffs
        x = pts[..., 0] * a[0] + pts[..., 1] * a[2] + a[4]
        y = pts[..., 0] * a[1] + pts[..., 1] * a[3] + a[5]
        return np.stack([x, y], axis=-1)

    def apply_pt(self, p: Point) -> Point:
        a = self.coeffs
        return (p[0] * a[0] + p[1] * a[2] + a[4],
                p[0] * a[1] + p[1] * a[3] + a[5])

    def inverse(self) -> "Affine":
        a, b, c, d, e, f = self.coeffs
        det = a * d - b * c
        if det == 0.0:
            # Singular transform (e.g. an animation frame passing through
            # scale(0)): the mapped geometry is degenerate and draws nothing.
            # Return an all-zero map instead of raising so paint resolution
            # survives, matching the reference's device-side inf/NaN ->
            # nothing-drawn behavior.
            return Affine((0.0, 0.0, 0.0, 0.0, 0.0, 0.0))
        inv_det = 1.0 / det
        return Affine((
            d * inv_det, -b * inv_det, -c * inv_det, a * inv_det,
            (c * f - d * e) * inv_det, (b * e - a * f) * inv_det,
        ))

    def determinant(self) -> float:
        a, b, c, d, _, _ = self.coeffs
        return a * d - b * c

    def scale_factor(self) -> float:
        """Upper bound on how much this transform stretches distances."""
        a, b, c, d, _, _ = self.coeffs
        # Operator norm bound via Frobenius norm (within sqrt(2) of exact).
        return math.sqrt(a * a + b * b + c * c + d * d)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.coeffs, dtype=np.float32)

    def is_identity(self) -> bool:
        return self.coeffs == (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


Affine.IDENTITY = Affine()


@dataclass(frozen=True)
class Rect:
    x0: float
    y0: float
    x1: float
    y1: float

    @property
    def width(self) -> float:
        return self.x1 - self.x0

    @property
    def height(self) -> float:
        return self.y1 - self.y0

    def union(self, other: "Rect") -> "Rect":
        return Rect(min(self.x0, other.x0), min(self.y0, other.y0),
                    max(self.x1, other.x1), max(self.y1, other.y1))

    def intersect(self, other: "Rect") -> "Rect":
        return Rect(max(self.x0, other.x0), max(self.y0, other.y0),
                    min(self.x1, other.x1), min(self.y1, other.y1))

    def is_empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def inset(self, d: float) -> "Rect":
        return Rect(self.x0 + d, self.y0 + d, self.x1 - d, self.y1 - d)


@dataclass(frozen=True)
class Stroke:
    """Stroke style (kurbo ``Stroke`` subset)."""

    width: float = 1.0
    join: str = "round"          # "bevel" | "miter" | "round"
    miter_limit: float = 4.0
    start_cap: str = "round"     # "butt" | "square" | "round"
    end_cap: str = "round"
    dash_pattern: Tuple[float, ...] = ()
    dash_offset: float = 0.0

    @staticmethod
    def new(width: float) -> "Stroke":
        return Stroke(width=width)

    def with_caps(self, cap: str) -> "Stroke":
        return Stroke(self.width, self.join, self.miter_limit, cap, cap,
                      self.dash_pattern, self.dash_offset)

    def with_join(self, join: str) -> "Stroke":
        return Stroke(self.width, join, self.miter_limit, self.start_cap,
                      self.end_cap, self.dash_pattern, self.dash_offset)

    def with_dashes(self, offset: float,
                    pattern: Sequence[float]) -> "Stroke":
        return Stroke(self.width, self.join, self.miter_limit,
                      self.start_cap, self.end_cap, tuple(pattern), offset)


class BezPath:
    """A Bezier path: sequence of verbs + control points.

    Verbs are MOVE_TO/LINE_TO/QUAD_TO/CURVE_TO/CLOSE; points are stored in a
    flat list with _VERB_POINTS entries each.
    """

    __slots__ = ("verbs", "points")

    def __init__(self):
        self.verbs: List[int] = []
        self.points: List[Point] = []

    # -- builders ---------------------------------------------------------
    def move_to(self, x: float, y: float) -> "BezPath":
        self.verbs.append(MOVE_TO)
        self.points.append((float(x), float(y)))
        return self

    def line_to(self, x: float, y: float) -> "BezPath":
        self.verbs.append(LINE_TO)
        self.points.append((float(x), float(y)))
        return self

    def quad_to(self, x1: float, y1: float, x2: float, y2: float) -> "BezPath":
        self.verbs.append(QUAD_TO)
        self.points.append((float(x1), float(y1)))
        self.points.append((float(x2), float(y2)))
        return self

    def curve_to(self, x1, y1, x2, y2, x3, y3) -> "BezPath":
        self.verbs.append(CURVE_TO)
        self.points.append((float(x1), float(y1)))
        self.points.append((float(x2), float(y2)))
        self.points.append((float(x3), float(y3)))
        return self

    def close(self) -> "BezPath":
        self.verbs.append(CLOSE)
        return self

    def extend(self, other: "BezPath") -> "BezPath":
        self.verbs.extend(other.verbs)
        self.points.extend(other.points)
        return self

    def is_empty(self) -> bool:
        return not self.verbs

    def transform(self, affine: Affine) -> "BezPath":
        out = BezPath()
        out.verbs = list(self.verbs)
        if self.points:
            pts = affine.apply(np.asarray(self.points))
            out.points = [tuple(p) for p in pts]
        return out

    # -- iteration --------------------------------------------------------
    def elements(self) -> Iterable[Tuple[int, List[Point]]]:
        """Yields (verb, points) tuples."""
        i = 0
        for verb in self.verbs:
            n = _VERB_POINTS[verb]
            yield verb, self.points[i:i + n]
            i += n

    def subpaths(self) -> Iterable[List[Tuple[int, List[Point]]]]:
        """Yields lists of (verb, pts) per subpath (each starts with MOVE_TO)."""
        cur: List[Tuple[int, List[Point]]] = []
        for verb, pts in self.elements():
            if verb == MOVE_TO:
                if cur:
                    yield cur
                cur = [(verb, pts)]
            elif cur:
                cur.append((verb, pts))
        if cur:
            yield cur

    def bounding_box(self) -> Rect:
        """Control-point bounding box (conservative)."""
        if not self.points:
            return Rect(0.0, 0.0, 0.0, 0.0)
        pts = np.asarray(self.points)
        return Rect(float(pts[:, 0].min()), float(pts[:, 1].min()),
                    float(pts[:, 0].max()), float(pts[:, 1].max()))

    def reversed_subpaths(self) -> "BezPath":
        """Reverse the direction of every subpath (flips winding)."""
        out = BezPath()
        for sub in self.subpaths():
            pts_seq: List[Point] = []
            closed = False
            segs = []  # (verb, [pts including start])
            cur = None
            start = None
            for verb, pts in sub:
                if verb == MOVE_TO:
                    cur = pts[0]
                    start = cur
                elif verb == CLOSE:
                    closed = True
                    if cur != start:
                        segs.append((LINE_TO, [cur, start]))
                        cur = start
                else:
                    segs.append((verb, [cur] + pts))
                    cur = pts[-1]
            if cur is None:
                continue
            out.move_to(*cur)
            for verb, pts in reversed(segs):
                rp = list(reversed(pts))
                if verb == LINE_TO:
                    out.line_to(*rp[1])
                elif verb == QUAD_TO:
                    out.quad_to(*rp[1], *rp[2])
                else:
                    out.curve_to(*rp[1], *rp[2], *rp[3])
            if closed:
                out.close()
        return out


# ---------------------------------------------------------------------------
# Shapes


def rect_path(x0: float, y0: float, x1: float, y1: float) -> BezPath:
    p = BezPath()
    p.move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()
    return p


# Magic constant for approximating a quarter circle with a cubic Bezier.
KAPPA = 4.0 * (math.sqrt(2.0) - 1.0) / 3.0


def ellipse_path(cx: float, cy: float, rx: float, ry: float,
                 rotation: float = 0.0) -> BezPath:
    k = KAPPA
    p = BezPath()
    p.move_to(cx + rx, cy)
    p.curve_to(cx + rx, cy + k * ry, cx + k * rx, cy + ry, cx, cy + ry)
    p.curve_to(cx - k * rx, cy + ry, cx - rx, cy + k * ry, cx - rx, cy)
    p.curve_to(cx - rx, cy - k * ry, cx - k * rx, cy - ry, cx, cy - ry)
    p.curve_to(cx + k * rx, cy - ry, cx + rx, cy - k * ry, cx + rx, cy)
    p.close()
    if rotation:
        return p.transform(Affine.rotate_about(rotation, cx, cy))
    return p


def circle_path(cx: float, cy: float, r: float) -> BezPath:
    return ellipse_path(cx, cy, r, r)


def rounded_rect_path(x0, y0, x1, y1, r) -> BezPath:
    r = min(r, (x1 - x0) / 2.0, (y1 - y0) / 2.0)
    if r <= 0:
        return rect_path(x0, y0, x1, y1)
    k = KAPPA * r
    p = BezPath()
    p.move_to(x0 + r, y0)
    p.line_to(x1 - r, y0)
    p.curve_to(x1 - r + k, y0, x1, y0 + r - k, x1, y0 + r)
    p.line_to(x1, y1 - r)
    p.curve_to(x1, y1 - r + k, x1 - r + k, y1, x1 - r, y1)
    p.line_to(x0 + r, y1)
    p.curve_to(x0 + r - k, y1, x0, y1 - r + k, x0, y1 - r)
    p.line_to(x0, y0 + r)
    p.curve_to(x0, y0 + r - k, x0 + r - k, y0, x0 + r, y0)
    p.close()
    return p


def arc_path(cx: float, cy: float, r: float, start_angle: float,
             sweep_angle: float) -> BezPath:
    """Circular arc as cubic Beziers (≤ pi/2 per segment)."""
    p = BezPath()
    n = max(1, int(math.ceil(abs(sweep_angle) / (math.pi / 2.0))))
    da = sweep_angle / n
    # Tangent-length factor for a cubic approximating an arc of angle da.
    k = 4.0 / 3.0 * math.tan(da / 4.0)
    a = start_angle
    p.move_to(cx + r * math.cos(a), cy + r * math.sin(a))
    for _ in range(n):
        c0 = (math.cos(a), math.sin(a))
        a2 = a + da
        c1 = (math.cos(a2), math.sin(a2))
        p.curve_to(
            cx + r * (c0[0] - k * c0[1]), cy + r * (c0[1] + k * c0[0]),
            cx + r * (c1[0] + k * c1[1]), cy + r * (c1[1] - k * c1[0]),
            cx + r * c1[0], cy + r * c1[1])
        a = a2
    return p


def star_path(cx, cy, n, inner, outer, rot=-math.pi / 2) -> BezPath:
    p = BezPath()
    for i in range(2 * n):
        r = outer if i % 2 == 0 else inner
        a = rot + math.pi * i / n
        x, y = cx + r * math.cos(a), cy + r * math.sin(a)
        if i == 0:
            p.move_to(x, y)
        else:
            p.line_to(x, y)
    p.close()
    return p


# ---------------------------------------------------------------------------
# Flattening (host side — the oracle / estimator path)


def wang_quad_count(p0, p1, p2, tol: float) -> int:
    """Wang's bound: subdivisions so a quadratic deviates < tol from chords."""
    d = np.asarray(p0) - 2.0 * np.asarray(p1) + np.asarray(p2)
    l = 2.0 * float(np.hypot(d[0], d[1]))
    return max(1, int(math.ceil(math.sqrt(l / (8.0 * tol)))))


def wang_cubic_count(p0, p1, p2, p3, tol: float) -> int:
    a = np.asarray(p0) - 2.0 * np.asarray(p1) + np.asarray(p2)
    b = np.asarray(p1) - 2.0 * np.asarray(p2) + np.asarray(p3)
    l = 6.0 * max(float(np.hypot(a[0], a[1])), float(np.hypot(b[0], b[1])))
    return max(1, int(math.ceil(math.sqrt(l / (8.0 * tol)))))


def eval_quad(p0, p1, p2, t):
    t = np.asarray(t)[..., None]
    p0, p1, p2 = (np.asarray(p, dtype=np.float64) for p in (p0, p1, p2))
    mt = 1.0 - t
    return mt * mt * p0 + 2.0 * mt * t * p1 + t * t * p2


def eval_cubic(p0, p1, p2, p3, t):
    t = np.asarray(t)[..., None]
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float64)
                      for p in (p0, p1, p2, p3))
    mt = 1.0 - t
    return (mt ** 3 * p0 + 3.0 * mt * mt * t * p1
            + 3.0 * mt * t * t * p2 + t ** 3 * p3)


def flatten_path(path: BezPath, affine: Affine = Affine.IDENTITY,
                 tol: float = 0.25) -> List[np.ndarray]:
    """Flatten to a list of closed polylines (one (N,2) array per subpath).

    Every subpath is implicitly closed (fill semantics — matches the
    reference's fill behavior where open subpaths are closed for filling,
    vello_common/src/flatten.rs).
    """
    polylines: List[np.ndarray] = []
    scale = affine.scale_factor()
    tol_local = tol / max(scale, 1e-12)
    for sub in path.subpaths():
        pts: List[Point] = []
        start = None
        cur = None
        for verb, vp in sub:
            if verb == MOVE_TO:
                start = vp[0]
                cur = start
                pts.append(cur)
            elif verb == LINE_TO:
                cur = vp[0]
                pts.append(cur)
            elif verb == QUAD_TO:
                n = wang_quad_count(cur, vp[0], vp[1], tol_local)
                ts = np.arange(1, n + 1) / n
                seg = eval_quad(cur, vp[0], vp[1], ts)
                pts.extend(map(tuple, seg))
                cur = vp[1]
            elif verb == CURVE_TO:
                n = wang_cubic_count(cur, vp[0], vp[1], vp[2], tol_local)
                ts = np.arange(1, n + 1) / n
                seg = eval_cubic(cur, vp[0], vp[1], vp[2], ts)
                pts.extend(map(tuple, seg))
                cur = vp[2]
            elif verb == CLOSE:
                if cur != start:
                    pts.append(start)
                cur = start
        if len(pts) >= 2:
            arr = affine.apply(np.asarray(pts, dtype=np.float64))
            # Ensure closed.
            if not np.allclose(arr[0], arr[-1]):
                arr = np.concatenate([arr, arr[:1]], axis=0)
            polylines.append(arr.astype(np.float64))
    return polylines
