"""Test scene corpus — procedural recreations of the reference's scene roster
(``examples/scenes/src/test_scenes.rs``: funky_paths, fill_types,
stroke_styles, tricky_strokes, gradients, blend_grid, deep_blend, many_clips,
mmark, many_draw_objects...). Used by snapshot tests and benchmarks.

Each function returns a Scene; sizes are parameterised so the same scene
works at test (small) and bench (large) resolutions.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..kurbo import (Affine, BezPath, Rect, Stroke, circle_path, ellipse_path,
                     rect_path, rounded_rect_path, star_path)
from ..peniko import (BlendMode, Color, Compose, Extend, Fill, Gradient, Mix,
                      palette, stops)
from ..scene import Scene
from .reference_scenes import ASSETS_DIR

COLORS = [palette.RED, palette.ORANGE, palette.YELLOW, palette.LIME,
          palette.CYAN, palette.BLUE, palette.PURPLE, palette.MAGENTA,
          palette.TEAL, palette.HOT_PINK, palette.SEA_GREEN, palette.TOMATO]


def funky_paths(size: float = 256.0) -> Scene:
    """Degenerate-ish path soup (reference: funky_paths)."""
    s = Scene()
    k = size / 256.0
    t = Affine.scale(k)
    # zero-width triangle slivers, collinear points, repeated points
    p = BezPath().move_to(10, 10).line_to(10, 10).line_to(200, 10) \
        .line_to(200, 11).close()
    s.fill(Fill.NON_ZERO, t, palette.YELLOW, None, p)
    p = BezPath().move_to(30, 40).line_to(30, 40).close()
    s.fill(Fill.NON_ZERO, t, palette.RED, None, p)
    # subpath after close without moveto
    p = BezPath().move_to(40, 60).line_to(120, 60).line_to(120, 120).close() \
        .line_to(40, 180).line_to(120, 180).close()
    s.fill(Fill.NON_ZERO, t, palette.CYAN.with_alpha(0.8), None, p)
    # long thin spikes
    p = BezPath().move_to(150, 30)
    for i in range(12):
        p.line_to(150 + 90 * math.cos(i * 2.3), 130 + 90 * math.sin(i * 2.3))
        p.line_to(150, 130)
    p.close()
    s.fill(Fill.EVEN_ODD, t, palette.MAGENTA.with_alpha(0.7), None, p)
    return s


def fill_types(size: float = 256.0) -> Scene:
    """NonZero vs EvenOdd on self-intersecting shapes (reference: fill_types)."""
    s = Scene()
    k = size / 256.0
    for col, rule in ((0, Fill.NON_ZERO), (1, Fill.EVEN_ODD)):
        for row, nper in ((0, 5), (1, 7)):
            cx = (64 + 128 * col) * k
            cy = (64 + 128 * row) * k
            p = BezPath()
            r = 54 * k
            for i in range(nper):
                a = -math.pi / 2 + i * 2 * math.pi * 2 / nper
                x, y = cx + r * math.cos(a), cy + r * math.sin(a)
                if i == 0:
                    p.move_to(x, y)
                else:
                    p.line_to(x, y)
            p.close()
            s.fill(rule, Affine.identity(), COLORS[(col + 2 * row) % 12],
                   None, p)
    return s


def stroke_styles(size: float = 256.0) -> Scene:
    """Cap/join/dash matrix (reference: stroke_styles)."""
    s = Scene()
    k = size / 256.0
    y = 20.0
    for cap in ("butt", "square", "round"):
        st = Stroke(width=12 * k).with_caps(cap)
        p = BezPath().move_to(20 * k, y * k).line_to(120 * k, y * k)
        s.stroke(st, Affine.identity(), palette.WHITE, None, p)
        y += 28
    for join in ("bevel", "miter", "round"):
        st = Stroke(width=12 * k, join=join, miter_limit=6.0)
        p = BezPath().move_to(150 * k, (y - 84 + 14) * k) \
            .line_to(230 * k, (y - 84) * k).line_to(170 * k, (y - 84 - 20) * k)
        s.stroke(st, Affine.identity(), palette.CYAN, None, p)
        y += 28
    for i, dash in enumerate(([8, 4], [2, 2], [12, 2, 2, 2])):
        st = Stroke(width=6 * k).with_dashes(0.0, [d * k for d in dash])
        s.stroke(st, Affine.identity(), COLORS[i + 4], None,
                 circle_path(70 * k, (150 + 34 * i) * k, 26 * k))
    p = BezPath().move_to(150 * k, 150 * k) \
        .curve_to(190 * k, 120 * k, 200 * k, 200 * k, 235 * k, 170 * k)
    s.stroke(Stroke(width=10 * k), Affine.identity(), palette.YELLOW, None, p)
    return s


def tricky_strokes(size: float = 256.0) -> Scene:
    """Cusps, tight curvature, degenerate control points."""
    s = Scene()
    k = size / 256.0
    cases = [
        # cusp-ish cubics
        [(20, 40), (120, 40), (20, 60), (120, 60)],
        [(20, 100), (150, 40), (20, 140), (120, 100)],
        # coincident control points
        [(20, 180), (20, 180), (120, 180), (120, 180)],
        [(140, 180), (240, 120), (240, 120), (240, 220)],
        [(140, 40), (240, 40), (140, 100), (240, 100)],
    ]
    for i, c in enumerate(cases):
        p = BezPath().move_to(c[0][0] * k, c[0][1] * k)
        p.curve_to(c[1][0] * k, c[1][1] * k, c[2][0] * k, c[2][1] * k,
                   c[3][0] * k, c[3][1] * k)
        s.stroke(Stroke(width=7 * k), Affine.identity(), COLORS[i], None, p)
    return s


def gradient_suite(size: float = 256.0) -> Scene:
    s = Scene()
    k = size / 256.0
    cells = [
        Gradient.linear((0, 0), (120 * k, 0),
                        stops(palette.RED, palette.YELLOW, palette.LIME),
                        Extend.PAD),
        Gradient.linear((0, 0), (40 * k, 0),
                        stops(palette.BLUE, palette.WHITE), Extend.REPEAT),
        Gradient.linear((0, 0), (40 * k, 40 * k),
                        stops(palette.TEAL, palette.MAGENTA), Extend.REFLECT),
        Gradient.radial((60 * k, 60 * k), 55 * k,
                        stops(palette.YELLOW, palette.RED)),
        Gradient.radial((60 * k, 60 * k), 55 * k,
                        stops(palette.CYAN, palette.NAVY), Extend.REFLECT,
                        center0=(40 * k, 40 * k), radius0=10 * k),
        Gradient.sweep((60 * k, 60 * k), 0, 2 * math.pi,
                       stops(palette.RED, palette.BLUE, palette.RED)),
    ]
    for i, g in enumerate(cells):
        col = i % 3
        row = i // 3
        org = Affine.translate((8 + col * 124) * k, (8 + row * 124) * k)
        s.fill(Fill.NON_ZERO, org, g, None,
               rect_path(0, 0, 116 * k, 116 * k))
    return s


def blend_grid(size: float = 256.0) -> Scene:
    """All mix modes over a colorful backdrop (reference: blend_grid).
    Layered — oracle-only until the device layer compositor lands."""
    s = Scene()
    k = size / 256.0
    mixes = [Mix.NORMAL, Mix.MULTIPLY, Mix.SCREEN, Mix.OVERLAY, Mix.DARKEN,
             Mix.LIGHTEN, Mix.COLOR_DODGE, Mix.COLOR_BURN, Mix.HARD_LIGHT,
             Mix.SOFT_LIGHT, Mix.DIFFERENCE, Mix.EXCLUSION, Mix.HUE,
             Mix.SATURATION, Mix.COLOR, Mix.LUMINOSITY]
    cell = 64 * k
    for i, m in enumerate(mixes):
        cx = (i % 4) * cell
        cy = (i // 4) * cell
        t = Affine.translate(cx, cy)
        g = Gradient.linear((0, 0), (cell, 0),
                            stops(palette.RED, palette.YELLOW, palette.LIME))
        s.fill(Fill.NON_ZERO, t, g, None, rect_path(2, 2, cell - 2, cell - 2))
        s.push_layer(BlendMode(m, Compose.SRC_OVER), 1.0, t,
                     rect_path(2, 2, cell - 2, cell - 2))
        g2 = Gradient.linear((0, 0), (0, cell),
                             stops(palette.BLUE, palette.MAGENTA))
        s.fill(Fill.NON_ZERO, t, g2, None,
               circle_path(cell / 2, cell / 2, cell * 0.42))
        s.pop_layer()
    return s


def many_clips(size: float = 256.0, n: int = 12) -> Scene:
    s = Scene()
    k = size / 256.0
    rng = np.random.default_rng(42)
    for i in range(n):
        cx, cy = rng.uniform(30, 226, 2) * k
        s.push_clip_layer(Affine.identity(),
                          star_path(cx, cy, 5 + i % 4, 12 * k, 34 * k))
        g = Gradient.linear((cx - 30 * k, cy), (cx + 30 * k, cy),
                            stops(COLORS[i % 12], COLORS[(i + 5) % 12]))
        s.fill(Fill.NON_ZERO, Affine.identity(), g, None,
               rect_path(0, 0, size, size))
        s.pop_layer()
    return s


def deep_blend(size: float = 256.0, depth: int = 8) -> Scene:
    """Nested layers with alpha (reference: deep_blend)."""
    s = Scene()
    k = size / 256.0
    for i in range(depth):
        r = (120 - 12 * i) * k
        s.push_layer(BlendMode(Mix.NORMAL, Compose.SRC_OVER), 0.85,
                     Affine.identity(), circle_path(128 * k, 128 * k, r))
        s.fill(Fill.NON_ZERO, Affine.identity(), COLORS[i % 12], None,
               rect_path(0, 0, size, size))
    for _ in range(depth):
        s.pop_layer()
    return s


def many_draw_objects(size: float = 1024.0, n: int = 4096) -> Scene:
    s = Scene()
    rng = np.random.default_rng(9)
    for i in range(n):
        x, y = rng.uniform(0, size, 2)
        r = rng.uniform(2, 10)
        c = COLORS[i % 12].with_alpha(0.8)
        s.fill(Fill.NON_ZERO, Affine.identity(), c, None,
               rect_path(x - r, y - r, x + r, y + r))
    return s


def mmark(complexity: int = 1, size: float = 1024.0,
          seed: int = 1) -> Scene:
    """MotionMark-style stroke soup (reference: examples/scenes/src/mmark.rs).

    complexity n => ~n*1000 curved stroked path elements grouped into
    multi-segment paths, mixed quads/cubics/lines, varying widths.
    """
    n = complexity * 1000
    rng = np.random.default_rng(seed)
    s = Scene()
    scale = size / 1600.0
    # Grid random walk over an 80x40 lattice with ~1-4-cell hops
    # (mmark.rs GridPoint::random_point + OFFSETS), triangle-folded into
    # the grid instead of boundary-reflected (statistically equivalent).
    GW, GH = 80, 40
    sx = 1600.0 / (GW + 1) * scale
    sy = 900.0 / (GH + 1) * scale
    OFF = np.array([(-4, 0), (2, 0), (1, -2), (1, 2)], dtype=np.int64)
    steps = OFF[rng.integers(0, 4, size=2 * n + 4)]
    walk = np.cumsum(steps, axis=0) + np.array([GW // 2, GH // 2])

    def fold(v, m):
        v = np.abs(v) % (2 * m)
        return np.where(v > m, 2 * m - v, v)

    chain = np.stack([(fold(walk[:, 0], GW) + 0.5) * sx,
                      100.0 * scale + (fold(walk[:, 1], GH) + 0.5) * sy],
                     axis=-1)                          # (2n+4, 2)
    # element s spans chain[2s] -> chain[2s+2]; interior chain points act
    # as control points. seg_type per mmark.rs: 0-1 line, 2 quad, 3 cubic.
    # Deviation from mmark.rs: line elements here span TWO grid hops (the
    # reference's span one), and the cubic's second control branches off
    # the endpoint rather than chaining controls — element-length stats
    # are close but not identical to the reference workload.
    i0 = 2 * np.arange(n)
    p0, pm, p1, pq = chain[i0], chain[i0 + 1], chain[i0 + 2], chain[i0 + 3]
    st = rng.integers(0, 4, size=n)
    is_line = (st < 2)[:, None]
    is_quad = (st == 2)[:, None]
    # exact elevation to cubics
    c1 = np.where(is_line, p0 + (p1 - p0) / 3.0,
                  np.where(is_quad, p0 + 2.0 / 3.0 * (pm - p0), pm))
    c2 = np.where(is_line, p0 + 2.0 / 3.0 * (p1 - p0),
                  np.where(is_quad, p1 + 2.0 / 3.0 * (pm - p1), pq))
    # split elements into paths (mmark.rs is_split: ~Bernoulli(1/2) =>
    # geometric path lengths, mean ~2 elements)
    split = rng.random(n) < 0.5
    split[-1] = True
    first = np.concatenate([[True], split[:-1]])
    pid = np.cumsum(first) - 1
    n_paths = int(pid[-1]) + 1
    plen = np.bincount(pid, minlength=n_paths)
    # per-PATH style (mmark.rs: width = u^5 * 20 + 1, 7-color palette)
    widths = (rng.random(n_paths) ** 5 * 20.0 + 1.0) * scale
    pal = np.asarray([(0x10, 0x10, 0x10), (0x80, 0x80, 0x80),
                      (0xc0, 0xc0, 0xc0), (0x10, 0x10, 0x10),
                      (0x80, 0x80, 0x80), (0xc0, 0xc0, 0xc0),
                      (0xe0, 0x10, 0x40)], dtype=np.float32) / 255.0
    cols = np.concatenate([pal[rng.integers(0, 7, size=n_paths)],
                           np.ones((n_paths, 1), np.float32)], axis=1)
    # bucket paths by pow2 element count; pad with repeated-endpoint
    # degenerate cubics (the expander's dedup drops them)
    style = Stroke(width=1.0, join="bevel", start_cap="butt",
                   end_cap="butt")
    starts_of = np.concatenate([[0], np.cumsum(plen)[:-1]])
    kmax = int(plen.max())
    k = 1
    while True:
        sel = np.nonzero((plen > k // 2) & (plen <= k))[0] if k > 1 \
            else np.nonzero(plen == 1)[0]
        k_next = k * 2
        if len(sel):
            nb = len(sel)
            # gather each path's elements, padded to k by repeating the
            # last element's endpoint as a degenerate cubic
            eidx = starts_of[sel][:, None] + np.arange(k)[None, :]
            valid = np.arange(k)[None, :] < plen[sel][:, None]
            eidx = np.minimum(eidx, (starts_of[sel] + plen[sel] - 1)[:, None])
            pe = p1[eidx]                              # (nb, k, 2) endpoints
            pc1 = np.where(valid[..., None], c1[eidx], pe)
            pc2 = np.where(valid[..., None], c2[eidx], pe)
            trip = np.stack([pc1, pc2, pe], axis=2).reshape(nb, 3 * k, 2)
            pts = np.concatenate([p0[starts_of[sel]][:, None], trip],
                                 axis=1)               # (nb, 1+3k, 2)
            s.stroke_batch(style, Affine.identity(), cols[sel], pts,
                           widths=widths[sel])
        if k >= kmax:
            break
        k = k_next
    return s


def filled_mmark(complexity: int = 1, size: float = 1024.0,
                 seed: int = 2) -> Scene:
    """Fill-heavy variant: many small curved blobs (no stroke expansion on
    the host, so the whole flatten load hits the device)."""
    n = complexity * 1000
    rng = np.random.default_rng(seed)
    s = Scene()
    width, height = size, size * 0.75
    # Vectorised build via the batch API (the per-path Python loop cost
    # 2.3 s at 30k paths — ~40% of the old host encode).
    cxy = rng.uniform([20, 20], [width - 20, height - 20], size=(n, 2))
    r = rng.uniform(3, 14, size=n)
    cx, cy = cxy[:, 0], cxy[:, 1]
    kk = 0.5523 * r
    z = np.zeros_like(r)

    def pt(dx, dy):
        return np.stack([cx + dx, cy + dy], axis=-1)

    pts = np.stack([
        pt(r, z),
        pt(r, kk), pt(kk, r), pt(z, r),
        pt(-kk, r), pt(-r, kk), pt(-r, z),
        pt(-r, -kk), pt(-kk, -r), pt(z, -r),
        pt(kk, -r), pt(r, -kk), pt(r, z),
    ], axis=1).astype(np.float32)                     # (n, 13, 2)
    colors = np.asarray(
        [(COLORS[i % 12].r, COLORS[i % 12].g, COLORS[i % 12].b, 0.8)
         for i in range(12)], dtype=np.float32)[np.arange(n) % 12]
    s.fill_batch(Fill.NON_ZERO, Affine.identity(), colors, pts)
    return s


def splash(size: float = 256.0) -> Scene:
    """Mixed-feature splash scene (device-compatible: no layers)."""
    s = Scene()
    k = size / 256.0
    g = Gradient.linear((0, 0), (0, size),
                        stops(Color.from_hex("#1a2a6c"),
                              Color.from_hex("#b21f1f"),
                              Color.from_hex("#fdbb2d")))
    s.fill(Fill.NON_ZERO, Affine.identity(), g, None,
           rect_path(0, 0, size, size))
    s.fill(Fill.EVEN_ODD, Affine.rotate_about(0.3, 128 * k, 110 * k),
           palette.WHITE.with_alpha(0.9), None,
           star_path(128 * k, 110 * k, 8, 40 * k, 85 * k))
    rg = Gradient.radial((128 * k, 110 * k), 42 * k,
                         stops(palette.YELLOW, palette.TOMATO))
    s.fill(Fill.NON_ZERO, Affine.identity(), rg, None,
           circle_path(128 * k, 110 * k, 40 * k))
    s.stroke(Stroke(width=4 * k).with_dashes(0, [10 * k, 5 * k]),
             Affine.identity(), palette.WHITE, None,
             circle_path(128 * k, 110 * k, 100 * k))
    for i in range(10):
        a = i * 2 * math.pi / 10
        x = 128 * k + 100 * k * math.cos(a)
        y = 110 * k + 100 * k * math.sin(a)
        s.fill(Fill.NON_ZERO, Affine.identity(), COLORS[i % 12], None,
               circle_path(x, y, 7 * k))
    return s


# Scenes safe for the device pipeline today (no layers):
DEVICE_SCENES = {
    "funky_paths": funky_paths,
    "fill_types": fill_types,
    "stroke_styles": stroke_styles,
    "tricky_strokes": tricky_strokes,
    "gradient_suite": gradient_suite,
    "splash": splash,
}
# Scenes requiring the layer compositor (oracle today):
LAYER_SCENES = {
    "blend_grid": blend_grid,
    "many_clips": many_clips,
    "deep_blend": deep_blend,
}


def text_scene(size: float = 256.0) -> Scene:
    """Glyph-run scene (reference: text-heavy scenes, glyph tests)."""
    s = Scene()
    k = size / 256.0
    s.draw_text("The quick brown", 8 * k, 40 * k, 26 * k, palette.WHITE)
    s.draw_text("fox jumps over", 8 * k, 80 * k, 26 * k, palette.YELLOW)
    s.draw_text("the lazy dog", 8 * k, 120 * k, 26 * k, palette.CYAN)
    g = Gradient.linear((0, 140 * k), (size, 140 * k),
                        stops(palette.RED, palette.MAGENTA, palette.BLUE))
    s.draw_text("Gradients! 0123456789", 8 * k, 170 * k, 20 * k, g)
    s.draw_text("tiny 8px text for coverage", 8 * k, 210 * k, 10 * k,
                palette.LIME)
    return s


def text_heavy(size: float = 1024.0, lines: int = 40) -> Scene:
    """Paragraph-scale glyph load (the text-heavy benchmark config)."""
    from ..text import default_font, layout_text
    s = Scene()
    font = default_font()
    msg = ("Sphinx of black quartz, judge my vow. " * 3)
    for i in range(lines):
        s.draw_text(msg, 8, 20 + i * (size - 30) / lines, 14, palette.WHITE,
                    font=font)
    return s


ACCENTED = "Ångström café naïve — Ωμέγα"


def glyph_runs(size: float = 1024.0, raster: bool = False) -> Scene:
    """Accented DejaVu Sans, whose letters are composite glyphs (a base
    and its accent): a filled, a stroked and an emboldened run, or with
    ``raster`` filled runs through the glyph atlas (image rects)."""
    from ..text import default_font, layout_text
    s = Scene()
    font = default_font()
    k = size / 256.0
    px = 13.0 * k
    glyphs = layout_text(font, px, ACCENTED)

    def run(line, color):
        origin = Affine.translate(6.0 * k, (40.0 + 50.0 * line) * k)
        return (s.draw_glyphs(font).font_size(px).brush(color)
                .transform(origin))
    if raster:
        run(0, palette.WHITE).raster(True).draw(Fill.NON_ZERO, glyphs)
        run(1, palette.LIME).raster(True).draw(Fill.NON_ZERO, glyphs)
    else:
        run(0, palette.WHITE).draw(Fill.NON_ZERO, glyphs)
        run(1, palette.YELLOW).draw(Stroke(width=1.5, join="round"), glyphs)
        run(2, palette.CYAN).embolden(0.6 * k).draw(Fill.NON_ZERO, glyphs)
    return s


DEVICE_SCENES["text_scene"] = text_scene


TIGER_ASSET = os.path.join(ASSETS_DIR, "Ghostscript_Tiger.svg")


def tiger(size: float = 256.0, asset: str = None) -> Scene:
    """The Ghostscript tiger benchmark scene (~180 paths with fills+strokes),
    auto-fitted to the viewport. Requires the SVG asset on disk."""
    import os

    from ..encoding.encoding import decode_segments
    from ..utils.svg import load_svg

    asset = asset or TIGER_ASSET
    if not os.path.exists(asset):
        raise FileNotFoundError(asset)
    probe = load_svg(asset)
    tags, data, transforms, styles = probe.encoding.packed_streams()
    d = decode_segments(tags, data, transforms, styles)
    t = d["transform"]
    pts = d["points"]
    x = pts[..., 0] * t[:, None, 0] + pts[..., 1] * t[:, None, 2] \
        + t[:, None, 4]
    y = pts[..., 0] * t[:, None, 1] + pts[..., 1] * t[:, None, 3] \
        + t[:, None, 5]
    import numpy as _np
    npts = d["kind"] + 1
    mask = _np.arange(4)[None, :] < npts[:, None]
    x0, x1 = x[mask].min(), x[mask].max()
    y0, y1 = y[mask].min(), y[mask].max()
    s = 0.94 * size / max(x1 - x0, y1 - y0)
    fit = Affine.translate(
        (size - s * (x1 - x0)) / 2 - s * x0,
        (size - s * (y1 - y0)) / 2 - s * y0) @ Affine.scale(s)
    return load_svg(asset, transform=fit)


def luminance_masks(size: float = 256.0) -> Scene:
    """Luminance-mask layer scene (reference: mask test suite)."""
    s = Scene()
    k = size / 256.0
    g = Gradient.linear((0, 0), (size, size),
                        stops(palette.RED, palette.BLUE))
    s.fill(Fill.NON_ZERO, Affine.identity(), g, None,
           rect_path(0, 0, size, size))
    s.push_luminance_mask_layer(1.0, Affine.identity(),
                                rect_path(0, 0, size, size))
    mg = Gradient.radial((128 * k, 128 * k), 120 * k,
                         stops(palette.WHITE, palette.BLACK))
    s.fill(Fill.NON_ZERO, Affine.identity(), mg, None,
           circle_path(128 * k, 128 * k, 120 * k))
    s.pop_layer()
    return s


LAYER_SCENES["luminance_masks"] = luminance_masks


def longpathdash(size: float = 256.0, cap: str = "butt") -> Scene:
    """One long multi-segment path with a dense dash pattern (reference:
    longpathdash — stresses the dasher and stroke expansion)."""
    s = Scene()
    k = size / 256.0
    p = BezPath()
    p.move_to(16 * k, 48 * k)
    import math as m
    for i in range(1, 80):
        x = (16 + i * 2.8) * k
        y = (48 + 40 * m.sin(i * 0.4) + i * 1.8) * k
        p.line_to(x, y)
    s.stroke(Stroke(width=2.5 * k).with_dashes(0.0, [3 * k, 2.5 * k])
             .with_caps(cap), Affine.identity(), palette.YELLOW, None, p)
    return s


DEVICE_SCENES["longpathdash"] = longpathdash
DEVICE_SCENES["many_draw_objects"] = lambda size=256.0: many_draw_objects(
    size, n=256)


def filter_suite(size: float = 256.0) -> Scene:
    """Layer filter showcase: blur, drop shadow, offset, flood."""
    s = Scene()
    k = size / 256.0
    s.push_blur_layer(4.0 * k)
    s.fill(Fill.NON_ZERO, Affine.identity(), palette.CYAN, None,
           star_path(64 * k, 64 * k, 6, 18 * k, 44 * k))
    s.pop_layer()
    s.push_drop_shadow_layer(5 * k, 5 * k, 3.0 * k, Color(0, 0, 0, 0.7))
    s.fill(Fill.NON_ZERO, Affine.identity(), palette.YELLOW, None,
           rounded_rect_path(150 * k, 30 * k, 230 * k, 100 * k, 12 * k))
    s.pop_layer()
    s.push_offset_layer(10 * k, 6 * k)
    s.fill(Fill.NON_ZERO, Affine.identity(), palette.LIME, None,
           circle_path(64 * k, 180 * k, 36 * k))
    s.pop_layer()
    s.push_flood_layer(Color(1, 0, 1, 0.6),
                       clip_path=star_path(190 * k, 185 * k, 5, 18 * k,
                                           42 * k))
    s.pop_layer()
    return s


LAYER_SCENES["filter_suite"] = filter_suite


def _blob_pts(rng, n, width, height):
    """(n, 13, 2) closed 4-cubic circle blobs (filled_mmark geometry)."""
    cxy = rng.uniform([20, 20], [width - 20, height - 20], size=(n, 2))
    r = rng.uniform(3, 14, size=n)
    cx, cy = cxy[:, 0], cxy[:, 1]
    kk = 0.5523 * r
    z = np.zeros_like(r)

    def pt(dx, dy):
        return np.stack([cx + dx, cy + dy], axis=-1)

    pts = np.stack([
        pt(r, z),
        pt(r, kk), pt(kk, r), pt(z, r),
        pt(-kk, r), pt(-r, kk), pt(-r, z),
        pt(-r, -kk), pt(-kk, -r), pt(z, -r),
        pt(kk, -r), pt(r, -kk), pt(r, z),
    ], axis=1).astype(np.float32)                     # (n, 13, 2)
    return pts, cx, cy, r


def mixed_paint_mmark(complexity: int = 1, size: float = 1024.0,
                      seed: int = 2) -> Scene:
    """Benchmark variant off the solid-fill fast path: filled_mmark blob
    geometry with ~80% solid fills (batched), ~15% gradient fills (linear/
    radial/sweep round-robin) and ~5% image fills. kinds_present spans
    solid+gradients+image, so the composite runs eval_paints + the
    materialized (F, 4, 256) src tensor instead of the paint8 slim path."""
    from ..peniko import Image, ImageQuality
    n = complexity * 1000
    rng = np.random.default_rng(seed)
    s = Scene()
    width, height = size, size * 0.75
    pts, cx, cy, r = _blob_pts(rng, n, width, height)
    n_solid = int(n * 0.8)
    colors = np.asarray(
        [(COLORS[i % 12].r, COLORS[i % 12].g, COLORS[i % 12].b, 0.8)
         for i in range(12)], dtype=np.float32)[np.arange(n_solid) % 12]
    s.fill_batch(Fill.NON_ZERO, Affine.identity(), colors, pts[:n_solid])
    # a small checkerboard texture shared by all image fills
    tex = np.zeros((16, 16, 4), np.uint8)
    tex[::2, ::2] = (255, 60, 60, 255)
    tex[1::2, 1::2] = (60, 60, 255, 255)
    tex[::2, 1::2] = (250, 250, 90, 255)
    tex[1::2, ::2] = (30, 200, 140, 255)
    img = Image(tex, Extend.REPEAT, Extend.REPEAT, ImageQuality.MEDIUM)
    n_img = max(n // 20, 1)
    grads = [
        lambda ci, cj, rr: Gradient.linear(
            (ci - rr, cj - rr), (ci + rr, cj + rr),
            stops(palette.RED, palette.YELLOW), Extend.PAD),
        lambda ci, cj, rr: Gradient.radial(
            (ci, cj), rr, stops(palette.CYAN, palette.NAVY), Extend.PAD),
        lambda ci, cj, rr: Gradient.sweep(
            (ci, cj), 0.0, 2 * math.pi,
            stops(palette.MAGENTA, palette.LIME, palette.MAGENTA)),
    ]
    for i in range(n_solid, n):
        p = pts[i]
        path = BezPath().move_to(*p[0])
        for j in range(1, 13, 3):
            path.curve_to(p[j, 0], p[j, 1], p[j + 1, 0], p[j + 1, 1],
                          p[j + 2, 0], p[j + 2, 1])
        path.close()
        if i < n - n_img:
            brush = grads[i % 3](cx[i], cy[i], r[i])
        else:
            brush = img
        s.fill(Fill.NON_ZERO, Affine.identity(), brush, None, path)
    return s


def layered_mmark(complexity: int = 1, size: float = 1024.0,
                  n_layers: int = 24, seed: int = 2) -> Scene:
    """Benchmark variant through the SCAN compositor: filled_mmark blob
    geometry split into n_layers alpha/blend groups (push_layer around
    batched fills), so frames run the layered plan-as-data pipeline
    (pipeline/layered.py) instead of the flat composite."""
    n = complexity * 1000
    rng = np.random.default_rng(seed)
    s = Scene()
    width, height = size, size * 0.75
    pts, _, _, _ = _blob_pts(rng, n, width, height)
    colors = np.asarray(
        [(COLORS[i % 12].r, COLORS[i % 12].g, COLORS[i % 12].b, 0.8)
         for i in range(12)], dtype=np.float32)[np.arange(n) % 12]
    per = max(n // n_layers, 1)
    mixes = [Mix.NORMAL, Mix.MULTIPLY, Mix.SCREEN, Mix.NORMAL]
    for g in range(n_layers):
        lo, hi = g * per, min((g + 1) * per, n)
        if lo >= hi:
            break
        s.push_layer(mixes[g % 4], 0.85, Affine.identity(), None)
        s.fill_batch(Fill.NON_ZERO, Affine.identity(), colors[lo:hi],
                     pts[lo:hi])
        s.pop_layer()
    return s
