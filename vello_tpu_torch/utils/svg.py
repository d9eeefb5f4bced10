"""Minimal SVG scene loader: enough of SVG 1.1 (paths, groups, transforms,
fills/strokes) to load path-heavy test assets like the Ghostscript tiger
(the reference's tiger benchmark config). Not a general SVG engine."""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Optional

from ..kurbo import Affine, BezPath, Stroke
from ..peniko import Color, Fill
from ..scene import Scene

_NUM = re.compile(r"[-+]?(?:\d*\.\d+|\d+\.?)(?:[eE][-+]?\d+)?")

_NAMED = {
    "black": "#000000", "white": "#ffffff", "red": "#ff0000",
    "green": "#008000", "blue": "#0000ff", "yellow": "#ffff00",
    "none": None, "transparent": None,
}


def _parse_color(s: Optional[str], opacity: float = 1.0) -> Optional[Color]:
    if s is None:
        return None
    s = s.strip()
    if s.lower() in _NAMED:
        s = _NAMED[s.lower()]
        if s is None:
            return None
    if s.startswith("#"):
        h = s[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        v = int(h, 16)
        return Color.from_rgba8((v >> 16) & 255, (v >> 8) & 255, v & 255,
                                int(255 * opacity))
    m = re.match(r"rgb\(([^)]*)\)", s)
    if m:
        parts = [float(p.strip().rstrip("%")) for p in m.group(1).split(",")]
        return Color(parts[0] / 255, parts[1] / 255, parts[2] / 255, opacity)
    return Color(0, 0, 0, opacity)


def _parse_transform(s: Optional[str]) -> Affine:
    t = Affine.IDENTITY
    if not s:
        return t
    for m in re.finditer(r"(\w+)\s*\(([^)]*)\)", s):
        op = m.group(1)
        args = [float(x) for x in _NUM.findall(m.group(2))]
        if op == "matrix" and len(args) == 6:
            t = t @ Affine(tuple(args))
        elif op == "translate":
            t = t @ Affine.translate(args[0], args[1] if len(args) > 1 else 0)
        elif op == "scale":
            t = t @ Affine.scale(args[0], args[1] if len(args) > 1 else None)
        elif op == "rotate":
            if len(args) == 3:
                t = t @ Affine.rotate_about(math.radians(args[0]), args[1],
                                            args[2])
            else:
                t = t @ Affine.rotate(math.radians(args[0]))
        elif op == "skewX":
            t = t @ Affine.skew(math.radians(args[0]), 0)
        elif op == "skewY":
            t = t @ Affine.skew(0, math.radians(args[0]))
    return t


def _arc_to_cubics(path: BezPath, x0, y0, rx, ry, rot, large, sweep, x1, y1):
    """SVG elliptical arc -> cubics (endpoint parameterization, F.6.5)."""
    if rx == 0 or ry == 0 or (x0 == x1 and y0 == y1):
        path.line_to(x1, y1)
        return
    rx, ry = abs(rx), abs(ry)
    phi = math.radians(rot)
    cp, sp = math.cos(phi), math.sin(phi)
    dx, dy = (x0 - x1) / 2.0, (y0 - y1) / 2.0
    x1p = cp * dx + sp * dy
    y1p = -sp * dx + cp * dy
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1:
        s = math.sqrt(lam)
        rx *= s
        ry *= s
    num = rx * rx * ry * ry - rx * rx * y1p * y1p - ry * ry * x1p * x1p
    den = rx * rx * y1p * y1p + ry * ry * x1p * x1p
    co = math.sqrt(max(num / den, 0.0))
    if large == sweep:
        co = -co
    cxp = co * rx * y1p / ry
    cyp = -co * ry * x1p / rx
    cx = cp * cxp - sp * cyp + (x0 + x1) / 2.0
    cy = sp * cxp + cp * cyp + (y0 + y1) / 2.0

    def ang(ux, uy, vx, vy):
        d = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1, min(1, (ux * vx + uy * vy) / d)))
        return -a if ux * vy - uy * vx < 0 else a

    th1 = ang(1, 0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry,
              (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    n = max(1, int(math.ceil(abs(dth) / (math.pi / 2))))
    dd = dth / n
    k = 4.0 / 3.0 * math.tan(dd / 4.0)

    def to_dev(ux, uy):
        """unit-circle point -> device (scale by radii, rotate phi, center)."""
        ex, ey = rx * ux, ry * uy
        return cp * ex - sp * ey + cx, sp * ex + cp * ey + cy

    a = th1
    for _ in range(n):
        a2 = a + dd
        ca, sa = math.cos(a), math.sin(a)
        ca2, sa2 = math.cos(a2), math.sin(a2)
        c1 = to_dev(ca - k * sa, sa + k * ca)
        c2 = to_dev(ca2 + k * sa2, sa2 - k * ca2)
        e = to_dev(ca2, sa2)
        path.curve_to(c1[0], c1[1], c2[0], c2[1], e[0], e[1])
        a = a2


def parse_path_data(d: str) -> BezPath:
    path = BezPath()
    tokens = re.findall(r"[MmLlHhVvCcSsQqTtAaZz]|" + _NUM.pattern, d)
    i = 0
    cmd = None
    cx = cy = sx = sy = 0.0
    pcx = pcy = None  # previous control point for S/T
    prev_cmd = ""

    def num():
        nonlocal i
        v = float(tokens[i])
        i += 1
        return v

    while i < len(tokens):
        tok = tokens[i]
        if tok.isalpha():
            cmd = tok
            i += 1
        elif cmd is None or cmd.upper() == "Z":
            # Numeric token with no active command (leading number, or a
            # number after Z): malformed per the SVG path grammar — raising
            # here also prevents an infinite loop on the unconsumed token.
            raise ValueError(
                f"malformed path data: unexpected token {tok!r} at {i}")
        # implicit repeat of last command
        c = cmd
        rel = c.islower()
        cu = c.upper()
        if cu == "M":
            x, y = num(), num()
            if rel:
                x += cx
                y += cy
            path.move_to(x, y)
            cx, cy, sx, sy = x, y, x, y
            cmd = "l" if rel else "L"
        elif cu == "L":
            x, y = num(), num()
            if rel:
                x += cx
                y += cy
            path.line_to(x, y)
            cx, cy = x, y
        elif cu == "H":
            x = num()
            if rel:
                x += cx
            path.line_to(x, cy)
            cx = x
        elif cu == "V":
            y = num()
            if rel:
                y += cy
            path.line_to(cx, y)
            cy = y
        elif cu == "C":
            x1, y1, x2, y2, x, y = (num() for _ in range(6))
            if rel:
                x1 += cx; y1 += cy; x2 += cx; y2 += cy; x += cx; y += cy
            path.curve_to(x1, y1, x2, y2, x, y)
            pcx, pcy = x2, y2
            cx, cy = x, y
        elif cu == "S":
            x2, y2, x, y = (num() for _ in range(4))
            if rel:
                x2 += cx; y2 += cy; x += cx; y += cy
            if prev_cmd.upper() in ("C", "S") and pcx is not None:
                x1, y1 = 2 * cx - pcx, 2 * cy - pcy
            else:
                x1, y1 = cx, cy
            path.curve_to(x1, y1, x2, y2, x, y)
            pcx, pcy = x2, y2
            cx, cy = x, y
        elif cu == "Q":
            x1, y1, x, y = (num() for _ in range(4))
            if rel:
                x1 += cx; y1 += cy; x += cx; y += cy
            path.quad_to(x1, y1, x, y)
            pcx, pcy = x1, y1
            cx, cy = x, y
        elif cu == "T":
            x, y = num(), num()
            if rel:
                x += cx; y += cy
            if prev_cmd.upper() in ("Q", "T") and pcx is not None:
                x1, y1 = 2 * cx - pcx, 2 * cy - pcy
            else:
                x1, y1 = cx, cy
            path.quad_to(x1, y1, x, y)
            pcx, pcy = x1, y1
            cx, cy = x, y
        elif cu == "A":
            rx, ry, rot, large, sweep, x, y = (num() for _ in range(7))
            if rel:
                x += cx; y += cy
            _arc_to_cubics(path, cx, cy, rx, ry, rot, large != 0,
                           sweep != 0, x, y)
            cx, cy = x, y
        elif cu == "Z":
            path.close()
            cx, cy = sx, sy
        else:
            i += 1
        prev_cmd = c
    return path


_CAPS = {"butt": "butt", "round": "round", "square": "square"}
_JOINS = {"miter": "miter", "round": "round", "bevel": "bevel"}


def load_svg(path_or_text: str, scene: Optional[Scene] = None,
             transform: Affine = Affine.IDENTITY) -> Scene:
    """Load an SVG file (or text) into a Scene."""
    if path_or_text.lstrip().startswith("<"):
        root = ET.fromstring(path_or_text)
    else:
        root = ET.parse(path_or_text).getroot()
    scene = scene or Scene()

    def strip_ns(tag):
        return tag.split("}")[-1]

    def walk(el, t: Affine, style: dict):
        st = dict(style)
        for k in ("fill", "stroke", "stroke-width", "stroke-linecap",
                  "stroke-linejoin", "stroke-miterlimit", "opacity",
                  "fill-opacity", "stroke-opacity", "fill-rule"):
            if el.get(k) is not None:
                st[k] = el.get(k)
        # style="a:b;c:d"
        if el.get("style"):
            for part in el.get("style").split(";"):
                if ":" in part:
                    k, v = part.split(":", 1)
                    st[k.strip()] = v.strip()
        tl = t @ _parse_transform(el.get("transform"))
        tag = strip_ns(el.tag)
        d = None
        if tag == "path":
            d = el.get("d", "")
            bez = parse_path_data(d)
        elif tag == "rect":
            from ..kurbo import rounded_rect_path, rect_path
            x = float(el.get("x", 0)); y = float(el.get("y", 0))
            w = float(el.get("width", 0)); h = float(el.get("height", 0))
            r = float(el.get("rx", el.get("ry", 0)) or 0)
            bez = rounded_rect_path(x, y, x + w, y + h, r) if r \
                else rect_path(x, y, x + w, y + h)
        elif tag == "circle":
            from ..kurbo import circle_path
            bez = circle_path(float(el.get("cx", 0)), float(el.get("cy", 0)),
                              float(el.get("r", 0)))
        elif tag == "ellipse":
            from ..kurbo import ellipse_path
            bez = ellipse_path(float(el.get("cx", 0)), float(el.get("cy", 0)),
                               float(el.get("rx", 0)), float(el.get("ry", 0)))
        elif tag in ("polygon", "polyline"):
            nums = [float(x) for x in _NUM.findall(el.get("points", ""))]
            bez = BezPath()
            if len(nums) >= 4:
                bez.move_to(nums[0], nums[1])
                for j in range(2, len(nums) - 1, 2):
                    bez.line_to(nums[j], nums[j + 1])
                if tag == "polygon":
                    bez.close()
        elif tag == "line":
            bez = BezPath().move_to(float(el.get("x1", 0)),
                                    float(el.get("y1", 0))) \
                .line_to(float(el.get("x2", 0)), float(el.get("y2", 0)))
        else:
            bez = None

        if bez is not None and not bez.is_empty():
            op = float(st.get("opacity", 1.0))
            fill_c = _parse_color(st.get("fill", "#000000"),
                                  float(st.get("fill-opacity", 1.0)) * op)
            if fill_c is not None and tag not in ("polyline", "line"):
                rule = Fill.EVEN_ODD if st.get("fill-rule") == "evenodd" \
                    else Fill.NON_ZERO
                scene.fill(rule, tl, fill_c, None, bez)
            stroke_c = _parse_color(st.get("stroke"),
                                    float(st.get("stroke-opacity", 1.0)) * op)
            if stroke_c is not None and st.get("stroke", "none") != "none":
                width = float(st.get("stroke-width", 1.0))
                stroke = Stroke(
                    width=width,
                    start_cap=_CAPS.get(st.get("stroke-linecap", "butt"),
                                        "butt"),
                    end_cap=_CAPS.get(st.get("stroke-linecap", "butt"),
                                      "butt"),
                    join=_JOINS.get(st.get("stroke-linejoin", "miter"),
                                    "miter"),
                    miter_limit=float(st.get("stroke-miterlimit", 4.0)))
                scene.stroke(stroke, tl, stroke_c, None, bez)

        for child in el:
            walk(child, tl, st)

    walk(root, transform, {})
    return scene
