"""Faithful ports of the reference's golden-snapshot test scenes.

Each function reproduces the scene built by the same-named function in
``examples/scenes/src/test_scenes.rs`` of linebender/vello (cited per scene) so
device output can be diffed against the reference's stored snapshot PNGs
(``vello_tests/snapshots/*.png``) — an independent ground truth that the
shared-math oracle cannot provide. Scene *data* (coordinates, colors,
layout) matches the reference; the construction uses this package's API.

Scenes report the reference's ``params.resolution`` /
``params.base_color``; ``build_for_golden`` applies the same
scale-to-fit-viewport rule as ``vello_tests::encode_test_scene``
(vello_tests/src/lib.rs:290-301).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from ..kurbo import Affine, BezPath, Rect, Stroke, circle_path, rect_path
from ..peniko import (BlendMode, Color, Compose, Extend, Fill, Gradient, Mix,
                      palette, stops)
from ..scene import Scene

# Assets the repository does not commit: the Roboto font of the scenes that
# draw text, and the tiger SVG (scenes/test_scenes.py). They are looked up in
# the repository's assets/ only; while absent, roboto_available() is False
# and those scenes are not built.
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
_ROBOTO = os.path.join(ASSETS_DIR, "roboto", "Roboto-Regular.ttf")


@dataclass
class SceneParams:
    """Mirror of scenes::SceneParams for the fields the ports use."""

    time: float = 0.0
    complexity: int = 100
    resolution: Optional[Tuple[float, float]] = None
    base_color: Optional[Color] = None
    _font: object = None

    def text(self, scene: Scene, size: float, transform: Affine,
             text: str, brush: Optional[Color] = None) -> None:
        """SimpleText::add — Roboto, advance-only layout, default WHITE
        (examples/scenes/src/simple_text.rs:170-230)."""
        from ..text import Font, layout_text
        if self._font is None:
            self._font = Font(_ROBOTO)
        glyphs = layout_text(self._font, size, text)
        (scene.draw_glyphs(self._font).font_size(size)
         .brush(brush or palette.WHITE).transform(transform)
         .draw(Fill.NON_ZERO, glyphs))


def roboto_available() -> bool:
    return os.path.exists(_ROBOTO)


def _path(els) -> BezPath:
    """els: list of ('M'|'L'|'C'|'Q', *coords) or ('Z',)."""
    p = BezPath()
    for e in els:
        k = e[0]
        if k == "M":
            p.move_to(e[1], e[2])
        elif k == "L":
            p.line_to(e[1], e[2])
        elif k == "C":
            p.curve_to(*e[1:7])
        elif k == "Q":
            p.quad_to(*e[1:5])
        elif k == "Z":
            p.close()
    return p


# ---------------------------------------------------------------------------
# test_scenes.rs:293-333
def funky_paths(scene: Scene, params: SceneParams) -> None:
    missing_movetos = _path([
        ("M", 0.0, 0.0), ("L", 100.0, 100.0), ("L", 100.0, 200.0), ("Z",),
        ("L", 0.0, 400.0), ("L", 100.0, 400.0)])
    only_movetos = _path([("M", 0.0, 0.0), ("M", 100.0, 100.0)])
    empty = BezPath()
    scene.fill(Fill.NON_ZERO, Affine.translate(100.0, 100.0),
               palette.BLUE, None, missing_movetos)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.BLUE, None, empty)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.BLUE, None,
               only_movetos)
    scene.stroke(Stroke(width=8.0), Affine.translate(100.0, 100.0),
                 palette.AQUA, None, missing_movetos)


# test_scenes.rs:699-771
def fill_types(scene: Scene, params: SceneParams) -> None:
    params.resolution = (1400.0, 700.0)
    rect = rect_path(0.0, 0.0, 500.0, 500.0)
    star = _path([("M", 250.0, 0.0), ("L", 105.0, 450.0),
                  ("L", 490.0, 175.0), ("L", 10.0, 175.0),
                  ("L", 395.0, 450.0), ("Z",)])
    arcs = _path([
        ("M", 0.0, 480.0),
        ("C", 500.0, 480.0, 500.0, -10.0, 0.0, -10.0), ("Z",),
        ("M", 500.0, -10.0),
        ("C", 0.0, -10.0, 0.0, 480.0, 500.0, 480.0), ("Z",)])
    scale = Affine.scale(0.6)
    t0 = Affine.translate(10.0, 25.0)
    rules = [(Fill.NON_ZERO, "Non-Zero", star),
             (Fill.EVEN_ODD, "Even-Odd", star),
             (Fill.NON_ZERO, "Non-Zero", arcs),
             (Fill.EVEN_ODD, "Even-Odd", arcs)]
    for i, (rule, label, shape) in enumerate(rules):
        t = Affine.translate((i % 2) * 306.0, (i // 2) * 340.0) @ t0
        params.text(scene, 24.0, t, label)
        t = Affine.translate(0.0, 5.0) @ t @ scale
        scene.fill(Fill.NON_ZERO, t, palette.GRAY, None, rect)
        scene.fill(rule, Affine.translate(0.0, 10.0) @ t,
                   palette.YELLOW, None, shape)
    t0 = Affine.translate(700.0, 0.0) @ t0
    for i, (rule, label, shape) in enumerate(rules):
        t = Affine.translate((i % 2) * 306.0, (i // 2) * 340.0) @ t0
        params.text(scene, 24.0, t, label)
        t = Affine.translate(0.0, 5.0) @ t @ scale
        scene.fill(Fill.NON_ZERO, t, palette.GRAY, None, rect)
        tt = Affine.translate(0.0, 10.0) @ t
        scene.fill(rule, tt, palette.YELLOW, None, shape)
        scene.fill(rule, tt @ Affine.rotate(0.06),
                   Color(0.0, 1.0, 0.7, 0.6), None, shape)
        scene.fill(rule, tt @ Affine.rotate(-0.06),
                   Color(0.9, 0.7, 0.5, 0.6), None, shape)


# test_scenes.rs:978-1044
def gradient_extend(scene: Scene, params: SceneParams) -> None:
    colors = stops(palette.RED, palette.LIME, palette.BLUE)
    w = h = 300.0

    def square(kind, transform, extend):
        if kind == "linear":
            g = Gradient.linear((w * 0.35, h * 0.5), (w * 0.65, h * 0.5),
                                colors, extend)
        elif kind == "radial":
            c = (w * 0.5, h * 0.5)
            r = w * 0.25
            g = Gradient.radial(c, r, colors, extend,
                                center0=c, radius0=r * 0.25)
        else:
            g = Gradient.sweep((w * 0.5, h * 0.5),
                               math.radians(30.0), math.radians(150.0),
                               colors, extend)
        scene.fill(Fill.NON_ZERO, transform, g, None,
                   rect_path(0.0, 0.0, w, h))

    for x, extend in enumerate([Extend.PAD, Extend.REPEAT, Extend.REFLECT]):
        for y, kind in enumerate(["linear", "radial", "sweep"]):
            square(kind, Affine.translate(x * 350.0 + 50.0,
                                          y * 350.0 + 100.0), extend)
    for i, label in enumerate(["Pad", "Repeat", "Reflect"]):
        params.text(scene, 32.0, Affine.translate(i * 350.0 + 50.0, 70.0),
                    label, palette.WHITE)
    params.resolution = (1200.0, 1200.0)


# test_scenes.rs: deep_blend
def deep_blend(scene: Scene, params: SceneParams) -> None:
    params.resolution = (1000.0, 1000.0)
    main_rect = rect_path(10.0, 10.0, 910.0, 910.0)
    scene.fill(Fill.EVEN_ODD, Affine.identity(), palette.RED, None,
               main_rect)
    options = [(800.0, palette.AQUA), (700.0, palette.RED),
               (600.0, palette.ALICE_BLUE), (500.0, palette.YELLOW),
               (400.0, palette.GREEN), (300.0, palette.BLUE),
               (200.0, palette.ORANGE), (100.0, palette.WHITE)]
    depth = 0
    for width, color in options[:min(params.complexity, len(options) - 1)]:
        scene.push_layer(BlendMode(Mix.NORMAL, Compose.SRC_OVER), 0.9,
                         Affine.identity(),
                         rect_path(10.0, 10.0, 10.0 + width, 10.0 + width))
        scene.fill(Fill.EVEN_ODD, Affine.identity(), color, None, main_rect)
        depth += 1
    for _ in range(depth):
        scene.pop_layer()


# test_scenes.rs: many_clips (StdRng seed 42 reproduced bit-exactly)
def many_clips(scene: Scene, params: SceneParams) -> None:
    from ..utils.rust_rand import StdRng
    params.resolution = (1000.0, 1000.0)
    rng = StdRng(42)
    base_tri = _path([("M", -50.0, 0.0), ("L", 25.0, -43.3),
                      ("L", 25.0, 43.3)])
    for y in range(10):
        for x in range(10):
            translate = Affine.translate(100.0 * (x + 0.5),
                                         100.0 * (y + 0.5))
            rots = []
            for _ in range(3):
                rots.append(Affine.rotate(
                    rng.random_range_f64(0.0, math.pi)))
            for rot in rots:
                scene.push_clip_layer(translate @ rot, base_tri)
            rot = Affine.rotate(rng.random_range_f64(0.0, math.pi))
            color = Color(rng.random_f32(), rng.random_f32(),
                          rng.random_f32(), 1.0)
            scene.fill(Fill.NON_ZERO, translate @ rot, color, None,
                       base_tri)
            for _ in range(3):
                scene.pop_layer()


def _pentagram(cx, cy, r) -> BezPath:
    start = -math.pi / 2.0
    pts = [(cx + math.cos(start + i * 2.0 * math.pi / 5.0) * r,
            cy + math.sin(start + i * 2.0 * math.pi / 5.0) * r)
           for i in range(5)]
    order = [0, 2, 4, 1, 3]
    p = BezPath()
    p.move_to(*pts[order[0]])
    for i in order[1:]:
        p.line_to(*pts[i])
    p.close()
    return p


# test_scenes.rs: clip_test (time = 0)
def clip_test(scene: Scene, params: SceneParams) -> None:
    clip = _path([("M", 50.0, 0.0), ("L", 200.0, 0.0), ("L", 200.0, 500.0),
                  ("L", 50.0, 500.0), ("L", 50.0, 500.0), ("Z",)])
    scene.push_clip_layer(Affine.identity(), clip)
    text_size = 60.0 + 40.0 * math.sin(params.time)
    params.text(scene, text_size, Affine.translate(110.0, 100.0),
                "Some clipped text!")
    scene.pop_layer()

    demo_rect = rect_path(250.0, 20.0, 450.0, 220.0)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.BLUE, None,
               demo_rect)
    star = _pentagram(350.0, 120.0, 90.0)
    scene.push_clip_layer(Affine.identity(), star, Fill.EVEN_ODD)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.RED, None,
               demo_rect)
    scene.pop_layer()

    stroke_demo_rect = rect_path(250.0, 240.0, 450.0, 440.0)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.SLATE_GRAY, None,
               stroke_demo_rect)
    stroke_star = _pentagram(350.0, 340.0, 85.0)
    st = Stroke(width=18.0, join="round", start_cap="round",
                end_cap="round")
    scene.push_clip_layer(Affine.identity(), stroke_star, style=st)
    grad = Gradient.linear((250.0, 240.0), (450.0, 440.0),
                           stops(palette.MAGENTA, palette.CYAN))
    scene.fill(Fill.NON_ZERO, Affine.identity(), grad, None,
               stroke_demo_rect)
    scene.pop_layer()

    stroke_demo_rect = rect_path(250.0, 460.0, 450.0, 660.0)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.LIGHT_GREEN, None,
               stroke_demo_rect)
    stroke_star = _pentagram(350.0, 560.0, 85.0)
    st = Stroke(width=5.0, join="round", start_cap="round",
                end_cap="round", dash_pattern=(10.0,))
    scene.push_clip_layer(Affine.identity(), stroke_star, style=st)
    grad = Gradient.linear((250.0, 460.0), (450.0, 660.0),
                           stops(palette.MAGENTA, palette.CYAN))
    scene.fill(Fill.NON_ZERO, Affine.identity(), grad, None,
               stroke_demo_rect)
    scene.pop_layer()

    # nested translated clip-rect block (scale-2 overlay)
    large_bg = rect_path(-1000.0, -1000.0, 2000.0, 2000.0)
    inside = rect_path(11.0, 13.399999999999999, 59.0, 56.6)
    outside = rect_path(12.599999999999998, 12.599999999999998,
                        57.400000000000006, 57.400000000000006)
    clip_rect = rect_path(0.0, 0.0, 74.4, 339.20000000000005)
    s2 = 2.0
    t_main = Affine((s2, 0.0, 0.0, s2, 27.07470703125, 176.40660533027858))
    t_in = Affine((s2, 0.0, 0.0, s2, 29.027636718750003, 182.9755506427786))
    t_out = Affine((s2, 0.0, 0.0, s2, 29.027636718750003,
                    s2 * 559.3583631427786))
    scene.push_layer(BlendMode(Mix.NORMAL, Compose.SRC_OVER), 1.0, t_main,
                     clip_rect)
    scene.fill(Fill.NON_ZERO, t_main, palette.BLUE, None, large_bg)
    scene.fill(Fill.NON_ZERO, t_in, palette.LIME, None, inside)
    scene.fill(Fill.NON_ZERO, t_out, palette.RED, None, outside)
    scene.pop_layer()


# test_scenes.rs: blurred_rounded_rect (time = 0 -> std_dev 50)
def blurred_rounded_rect(scene: Scene, params: SceneParams) -> None:
    from ..kurbo import rounded_rect_path
    params.resolution = (1200.0, 1200.0)
    params.base_color = palette.WHITE
    rect = Rect(-150.0, -120.0, 150.0, 120.0)
    radius = 50.0
    std_dev = math.sin(params.time) * 50.0 + 50.0
    scene.draw_blurred_rounded_rect(
        Affine.translate(300.0, 300.0), rect, palette.BLUE, radius, std_dev)
    skew = Affine((1.0, 0.0, math.tan(math.radians(20.0)), 1.0, 0.0, 0.0))
    scene.draw_blurred_rounded_rect(
        Affine.translate(900.0, 300.0) @ skew, rect, palette.BLACK,
        radius, std_dev)
    scene.draw_blurred_rounded_rect(
        Affine.identity(), Rect(100.0, 800.0, 400.0, 1100.0),
        palette.BLACK, 150.0, std_dev)
    scene.draw_blurred_rounded_rect(
        Affine.identity(), Rect(600.0, 800.0, 900.0, 900.0),
        palette.BLACK, 150.0, std_dev)
    # box-shadow region: inflated rect minus the rounded rect (reversed)
    k = 2.5 * std_dev
    outer = rect_path(rect.x0 - k, rect.y0 - k, rect.x1 + k, rect.y1 + k)
    inner = rounded_rect_path(rect.x0, rect.y0, rect.x1, rect.y1, radius)
    inner_rev = inner.reversed_subpaths()
    shape = BezPath()
    shape.verbs = list(outer.verbs) + list(inner_rev.verbs)
    shape.points = list(outer.points) + list(inner_rev.points)
    scene.draw_blurred_rounded_rect_in(
        shape,
        Affine.translate(600.0, 600.0) @ Affine.scale(2.2, 0.9),
        rect, palette.BLACK, radius, std_dev)


# test_scenes.rs:779-821 (cap = butt)
def _longpathdash(scene: Scene, cap: str) -> None:
    p = BezPath()
    x = 32
    while x < 256:
        a = 0.0
        while a < math.pi * 2.0:
            p0 = (256.0 + math.sin(a) * x, 256.0 + math.cos(a) * x)
            p1 = (256.0 + math.sin(a + math.pi / 3.0) * (x + 64),
                  256.0 + math.cos(a + math.pi / 3.0) * (x + 64))
            p.move_to(*p0)
            i = 0.0
            while i < 1.0:
                p.line_to(p0[0] * (1.0 - i) + p1[0] * i,
                          p0[1] * (1.0 - i) + p1[1] * i)
                i += 0.05
            a += math.pi * 0.01
        x += 16
    scene.stroke(
        Stroke(width=1.0, start_cap=cap, end_cap=cap, join="bevel",
               dash_pattern=(1.0, 1.0)),
        Affine.translate(50.0, 50.0), palette.YELLOW, None, p)


def longpathdash_butt(scene: Scene, params: SceneParams) -> None:
    _longpathdash(scene, "butt")


# test_scenes.rs:108 longpathdash(Cap::Round)
def longpathdash_round(scene: Scene, params: SceneParams) -> None:
    _longpathdash(scene, "round")


def _stroke_styles_with(tf: Affine):
    """stroke_styles under a scene transform (test_scenes.rs:89-90
    stroke_styles_non_uniform / stroke_styles_skew)."""
    def fn(scene: Scene, params: SceneParams) -> None:
        from .test_scenes import stroke_styles
        scene.append(stroke_styles(256.0), tf)
    return fn


stroke_styles_non_uniform = _stroke_styles_with(Affine.scale(1.2, 0.7))
stroke_styles_skew = _stroke_styles_with(Affine.skew(1.0, 0.0))


# test_scenes.rs: luminance_mask
def luminance_mask(scene: Scene, params: SceneParams) -> None:
    params.resolution = (55.0, 55.0)
    scene.fill(Fill.EVEN_ODD, Affine.identity(), palette.WHITE, None,
               rect_path(0.0, 0.0, 60.0, 60.0))
    inner = rect_path(5.0, 5.0, 50.0, 50.0)
    scene.push_layer(BlendMode(Mix.NORMAL, Compose.SRC_OVER), 1.0,
                     Affine.identity(), inner)
    scene.fill(Fill.EVEN_ODD, Affine.identity(), palette.RED, None, inner)
    scene.push_luminance_mask_layer(1.0, Affine.identity(), inner)
    scene.fill(Fill.EVEN_ODD, Affine.identity(),
               Color(0.1, 0.1, 0.1, 0.4), None, inner)
    scene.fill(Fill.EVEN_ODD, Affine.identity(),
               Color(0.9, 0.9, 0.9, 0.6), None, circle_path(0.0, 55.0, 35.0))
    scene.pop_layer()
    scene.pop_layer()


REFERENCE_SCENES: Dict[str, Callable[[Scene, SceneParams], None]] = {
    "funky_paths": funky_paths,
    "fill_types": fill_types,
    "gradient_extend": gradient_extend,
    "deep_blend": deep_blend,
    "many_clips": many_clips,
    "clip_test": clip_test,
    "blurred_rounded_rect": blurred_rounded_rect,
    "longpathdash_butt": longpathdash_butt,
    "longpathdash_round": longpathdash_round,
    "stroke_styles_non_uniform": stroke_styles_non_uniform,
    "stroke_styles_skew": stroke_styles_skew,
    "luminance_mask": luminance_mask,
}


def build_for_golden(name: str, width: int, height: int):
    """Build the named scene the way vello_tests::encode_test_scene does:
    run the scene fn, then scale-to-fit when it reports a resolution
    (vello_tests/src/lib.rs:290-301). Returns (scene, base_color)."""
    inner = Scene()
    params = SceneParams()
    REFERENCE_SCENES[name](inner, params)
    base = params.base_color
    if params.resolution is not None:
        rx, ry = params.resolution
        factor = min(width / rx, height / ry)
        outer = Scene()
        outer.append(inner, Affine.scale(factor))
        return outer, base
    return inner, base


# test_scenes.rs:1045-1170 two_point_radial
def two_point_radial(scene: Scene, params: SceneParams) -> None:
    from ..kurbo import ellipse_path
    colors = stops(palette.RED, palette.YELLOW,
                   Color.from_rgba8(6, 85, 186))

    def make(x0, y0, r0, x1, y1, r1, transform, extend):
        w, h = 400.0, 200.0
        rect = rect_path(0.0, 0.0, w, h)
        scene.fill(Fill.NON_ZERO, transform, palette.WHITE, None, rect)
        g = Gradient.radial((x1, y1), r1, colors, extend,
                            center0=(x0, y0), radius0=r0)
        scene.fill(Fill.NON_ZERO, transform, g, None, rect)
        for cx, cy, r in ((x0, y0, r0 - 1.0), (x1, y1, r1 - 1.0)):
            scene.stroke(Stroke(width=1.0), transform, palette.BLACK,
                         None, ellipse_path(cx, cy, r, r))

    rows = []
    for i in range(3):
        rows.append((140.0, 100.0, 20.0, 280.0, 100.0, 50.0,
                     (i * 420.0 + 20.0, 20.0)))
    for i in range(3):
        rows.append((280.0, 100.0, 50.0, 140.0, 100.0, 20.0,
                     (i * 420.0 + 20.0, 240.0)))
    for i in range(3):
        rows.append((140.0, 100.0, 50.0, 280.0, 100.0, 50.0,
                     (i * 420.0 + 20.0, 460.0)))
    for i in range(3):
        rows.append((140.0, 125.0, 20.0, 190.0, 100.0, 95.0,
                     (i * 420.0 + 20.0, 680.0)))
    for i in range(3):
        x0, y0, r0 = 140.0, 125.0, 20.0
        x1, y1, r1 = 190.0, 100.0, 96.0
        dx, dy = x0 - x1, y0 - y1
        n = math.hypot(dx, dy)
        p0 = (x1 + dx / n * (r1 - r0), y1 + dy / n * (r1 - r0))
        rows.append((p0[0], p0[1], r0, x1, y1, r1,
                     (i * 420.0 + 20.0, 900.0)))
    modes = [Extend.PAD, Extend.REPEAT, Extend.REFLECT]
    for j, (x0, y0, r0, x1, y1, r1, off) in enumerate(rows):
        make(x0, y0, r0, x1, y1, r1, Affine.translate(*off), modes[j % 3])
    params.resolution = (1300.0, 1200.0)


# test_scenes.rs:1444-1530 conflation_artifacts
def conflation_artifacts(scene: Scene, params: SceneParams) -> None:
    N, S = 50.0, 4.0
    scale = Affine.scale(S)
    x = N + 0.5
    y = N
    bg = Color.from_rgba8(255, 194, 19)
    fg = Color.from_rgba8(12, 165, 255)
    tris = _path([
        ("M", 0.0, 0.0), ("L", N, N), ("L", 0.0, N), ("L", 0.0, 0.0),
        ("M", 0.0, 0.0), ("L", N, N), ("L", N, 0.0), ("L", 0.0, 0.0)])
    scene.fill(Fill.NON_ZERO, Affine.translate(x, y) @ scale, fg, None,
               tris)
    y += S * N + 10.0
    rects_opp = _path([
        ("M", 0.0, 0.0), ("L", 0.0, N), ("L", N * 0.5, N),
        ("L", N * 0.5, 0.0),
        ("M", N * 0.5, 0.0), ("L", N, 0.0), ("L", N, N), ("L", N * 0.5, N)])
    scene.fill(Fill.EVEN_ODD, Affine.translate(x, y) @ scale, bg, None,
               rect_path(0.0, 0.0, N, N))
    scene.fill(Fill.EVEN_ODD, Affine.translate(x, y) @ scale, fg, None,
               rects_opp)
    y += S * N + 10.0
    rects_same = _path([
        ("M", 0.0, 0.0), ("L", 0.0, N), ("L", N * 0.5, N),
        ("L", N * 0.5, 0.0),
        ("M", N * 0.5, 0.0), ("L", N * 0.5, N), ("L", N, N), ("L", N, 0.0)])
    scene.fill(Fill.EVEN_ODD, Affine.translate(x, y) @ scale, bg, None,
               rect_path(0.0, 0.0, N, N))
    scene.fill(Fill.EVEN_ODD, Affine.translate(x, y) @ scale, fg, None,
               rects_same)
    params.resolution = (500.0, 700.0)


# test_scenes.rs labyrinth (winding-robustness grid at fractional offset)
_LAB_ROWS = [
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0],
    [0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0],
    [1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    [0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 1],
    [0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]
_LAB_COLS = [
    [1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
    [0, 0, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 0, 1],
    [1, 1, 0, 0, 0, 0, 1, 0, 1, 0],
    [0, 0, 1, 0, 1, 0, 0, 0, 0, 1],
    [0, 0, 1, 1, 1, 0, 0, 0, 1, 0],
    [0, 1, 0, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 0, 1, 1, 1, 0, 1, 0],
    [1, 1, 0, 1, 1, 0, 0, 0, 1, 0],
    [0, 0, 1, 0, 0, 0, 0, 0, 0, 1],
    [0, 0, 1, 1, 0, 0, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, 1],
    [1, 1, 1, 1, 1, 1, 0, 1, 1, 1],
]


def labyrinth(scene: Scene, params: SceneParams) -> None:
    p = BezPath()
    for y, row in enumerate(_LAB_ROWS):
        for x, flag in enumerate(row):
            if flag:
                p.move_to(x - 0.1, y + 0.1)
                p.line_to(x + 1.1, y + 0.1)
                p.line_to(x + 1.1, y - 0.1)
                p.line_to(x - 0.1, y - 0.1)
    for x, col in enumerate(_LAB_COLS):
        for y, flag in enumerate(col):
            if flag:
                p.move_to(x - 0.1, y - 0.1)
                p.line_to(x - 0.1, y + 1.1)
                p.line_to(x + 0.1, y + 1.1)
                p.line_to(x + 0.1, y - 0.1)
    scene.fill(Fill.NON_ZERO,
               Affine.translate(20.5, 20.5) @ Affine.scale(80.0),
               Color.from_rgba8(0x70, 0x80, 0x80), None, p)
    params.resolution = (1000.0, 1000.0)


# test_scenes.rs robust_paths (unclosed/degenerate/sliver subpaths)
def robust_paths(scene: Scene, params: SceneParams) -> None:
    p = _path([
        ("M", 16.0, 16.0), ("L", 32.0, 16.0), ("L", 32.0, 32.0),
        ("L", 16.0, 32.0), ("Z",),
        ("M", 48.0, 18.0), ("L", 64.0, 23.0), ("L", 64.0, 33.0),
        ("L", 48.0, 38.0), ("Z",),
        ("M", 80.0, 18.0), ("L", 82.0, 16.0), ("L", 94.0, 16.0),
        ("L", 96.0, 18.0), ("L", 96.0, 30.0), ("L", 94.0, 32.0),
        ("L", 82.0, 32.0), ("L", 80.0, 30.0), ("Z",),
        ("M", 112.0, 16.0), ("L", 128.0, 16.0), ("L", 128.0, 32.0), ("Z",),
        ("M", 144.0, 16.0), ("L", 160.0, 32.0), ("L", 144.0, 32.0), ("Z",),
        ("M", 168.0, 8.0), ("L", 184.0, 8.0), ("L", 184.0, 24.0), ("Z",),
        ("M", 200.0, 8.0), ("L", 216.0, 24.0), ("L", 200.0, 24.0), ("Z",),
        ("M", 241.0, 17.5), ("L", 255.0, 17.5), ("L", 255.0, 19.5),
        ("L", 241.0, 19.5), ("Z",),
        ("M", 241.0, 22.5), ("L", 256.0, 22.5), ("L", 256.0, 24.5),
        ("L", 241.0, 24.5), ("Z",)])
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.YELLOW, None, p)
    scene.fill(Fill.EVEN_ODD, Affine.translate(300.0, 0.0), palette.LIME,
               None, p)
    p2 = _path([("M", 8.0, 4.0), ("L", 8.0, 40.0), ("L", 260.0, 40.0),
                ("L", 260.0, 4.0), ("Z",)])
    p3 = BezPath()
    p3.verbs = list(p.verbs) + list(p2.verbs)
    p3.points = list(p.points) + list(p2.points)
    scene.fill(Fill.NON_ZERO, Affine.translate(0.0, 100.0), palette.YELLOW,
               None, p3)
    scene.fill(Fill.EVEN_ODD, Affine.translate(300.0, 100.0), palette.LIME,
               None, p3)
    params.resolution = (600.0, 150.0)


# test_scenes.rs:1398-1436 render_blend_square + blend_grid
def _blend_square(scene: Scene, mix: Mix, transform: Affine) -> None:
    from ..kurbo import ellipse_path
    rect = rect_path(0.0, 0.0, 200.0, 200.0)
    linear = Gradient.linear((0.0, 0.0), (200.0, 0.0),
                             stops(palette.BLACK, palette.WHITE))
    scene.fill(Fill.NON_ZERO, transform, linear, None, rect)
    for gx, gy, c in ((150.0, 0.0, Color.from_rgba8(255, 240, 64)),
                      (175.0, 100.0, Color.from_rgba8(255, 96, 240)),
                      (125.0, 200.0, Color.from_rgba8(64, 192, 255))):
        radial = Gradient.radial((gx, gy), 100.0,
                                 stops(c, c.with_alpha(0.0)))
        scene.fill(Fill.NON_ZERO, transform, radial, None, rect)
    colors = [palette.RED, palette.LIME, palette.BLUE]
    scene.push_layer(BlendMode(Mix.NORMAL, Compose.SRC_OVER), 1.0,
                     transform, rect)
    for i, c in enumerate(colors):
        lin = Gradient.linear((0.0, 0.0), (0.0, 200.0),
                              stops(palette.WHITE, c))
        scene.push_layer(BlendMode(mix, Compose.SRC_OVER), 1.0, transform,
                         rect)
        a = (transform @ Affine.translate(100.0, 100.0)
             @ Affine.rotate(math.pi / 3.0 * (i * 2 + 1))
             @ Affine.scale(1.0, 0.357)
             @ Affine.translate(-100.0, -100.0))
        scene.fill(Fill.NON_ZERO, a, lin, None,
                   ellipse_path(100.0, 100.0, 90.0, 90.0))
        scene.pop_layer()
    scene.pop_layer()


def blend_grid(scene: Scene, params: SceneParams) -> None:
    mixes = [Mix.NORMAL, Mix.MULTIPLY, Mix.DARKEN, Mix.SCREEN,
             Mix.LIGHTEN, Mix.OVERLAY, Mix.COLOR_DODGE, Mix.COLOR_BURN,
             Mix.HARD_LIGHT, Mix.SOFT_LIGHT, Mix.DIFFERENCE, Mix.EXCLUSION,
             Mix.HUE, Mix.SATURATION, Mix.COLOR, Mix.LUMINOSITY]
    for ix, m in enumerate(mixes):
        t = Affine.translate((ix % 4) * 225.0, (ix // 4) * 225.0)
        _blend_square(scene, m, t)
    params.resolution = (900.0, 900.0)


# test_scenes.rs:772-777 cardioid_and_friends
def cardioid_and_friends(scene: Scene, params: SceneParams) -> None:
    # render_cardioid (test_scenes.rs:1302-1331)
    n = 601
    dth = math.pi * 2.0 / n
    cx, cy, r = 1024.0, 768.0, 750.0
    p = BezPath()
    for i in range(1, n):
        a0 = i * dth
        a1 = ((i * 2) % n) * dth
        p.move_to(cx + math.cos(a0) * r, cy + math.sin(a0) * r)
        p.line_to(cx + math.cos(a1) * r, cy + math.sin(a1) * r)
    scene.stroke(Stroke(width=2.0, start_cap="butt", end_cap="butt"),
                 Affine.identity(), palette.BLUE, None, p)
    # render_clip_test (test_scenes.rs:1333-1365): 16 nested clip wedges
    N, X0, Y0, X1, Y1 = 16, 50.0, 450.0, 550.0, 950.0
    step = 1.0 / (N + 1)
    for i in range(N):
        t = (i + 1) * step
        clip = _path([("M", X0, Y0), ("L", X1, Y0),
                      ("L", X1, Y0 + t * (Y1 - Y0)),
                      ("L", X1 + t * (X0 - X1), Y1), ("L", X0, Y1), ("Z",)])
        scene.push_clip_layer(Affine.identity(), clip)
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.LIME, None,
               rect_path(X0, Y0, X1, Y1))
    for _ in range(N):
        scene.pop_layer()

    # render_alpha_test (test_scenes.rs:1367-1396)
    def diamond(cx, cy):
        return _path([("M", cx, cy - 50.0), ("L", cx + 50.0, cy),
                      ("L", cx, cy + 50.0), ("L", cx - 50.0, cy), ("Z",)])
    scene.fill(Fill.NON_ZERO, Affine.identity(), palette.RED, None,
               diamond(1024.0, 100.0))
    scene.fill(Fill.NON_ZERO, Affine.identity(),
               palette.LIME.with_alpha(0.5), None, diamond(1024.0, 125.0))
    scene.push_clip_layer(Affine.identity(), diamond(1024.0, 150.0))
    scene.fill(Fill.NON_ZERO, Affine.identity(),
               palette.BLUE.with_alpha(0.5), None, diamond(1024.0, 175.0))
    scene.pop_layer()
    params.resolution = (2048.0, 1536.0)


REFERENCE_SCENES.update({
    "two_point_radial": two_point_radial,
    "conflation_artifacts": conflation_artifacts,
    "labyrinth": labyrinth,
    "robust_paths": robust_paths,
    "blend_grid": blend_grid,
    "cardioid_and_friends": cardioid_and_friends,
})


def _sample_image():
    """2x2 RED/BLUE/CYAN/MAGENTA (test_scenes.rs sample_image_data)."""
    import numpy as np
    from ..peniko import Image, ImageQuality
    px = np.array([[255, 0, 0, 255], [0, 0, 255, 255],
                   [0, 255, 255, 255], [255, 0, 255, 255]],
                  dtype=np.uint8).reshape(2, 2, 4)
    return px


def _bicubic_image():
    import numpy as np
    px = np.zeros((16, 16, 4), dtype=np.uint8)
    for y in range(16):
        for x in range(16):
            c = (0, 0, 0) if ((x // 2) + (y // 2)) % 2 == 0 \
                else (255, 255, 255)
            if x == 8 or y == 8:
                c = (255, 0, 0)
            if x == y or x + y == 15:
                c = (0, 0, 255)
            if (x == 2 and y == 13) or (x == 13 and y == 2):
                c = (0, 255, 0)
            px[y, x] = (*c, 255)
    return px


# test_scenes.rs image_sampling (quality = bilinear default)
def image_sampling(scene: Scene, params: SceneParams) -> None:
    import dataclasses

    from ..peniko import Image, ImageQuality
    params.resolution = (1100.0, 1100.0)
    params.base_color = palette.WHITE
    img = Image(data=_sample_image(), quality=ImageQuality.MEDIUM)
    c = math.cos(math.pi / 4.0)
    sn = math.sin(math.pi / 4.0)
    rot = Affine((c, sn, -sn, c, 0.0, 0.0))
    k = 200.0 / math.sqrt(2.0)
    scene.draw_image(img, Affine.translate(100.0, 100.0)
                     @ Affine.scale(200.0))
    scene.draw_image(img, Affine.translate(100.0, 600.0)
                     @ Affine.scale(k) @ Affine.translate(1.0, 1.0)
                     @ rot @ Affine.translate(-1.0, -1.0))
    scene.draw_image(img, Affine.translate(600.0, 100.0)
                     @ Affine.scale(100.0, 200.0))
    skew = Affine((1.0, 0.25, 0.1, 1.0, 0.0, 0.0))
    scene.draw_image(img, Affine.translate(600.0, 600.0)
                     @ Affine.scale(200.0) @ skew)


def image_sampling_bicubic(scene: Scene, params: SceneParams) -> None:
    from ..peniko import Image, ImageQuality
    params.resolution = (1400.0, 900.0)
    params.base_color = palette.WHITE
    data = _bicubic_image()
    c5 = math.cos(math.pi / 5.0)
    s5 = math.sin(math.pi / 5.0)
    rot5 = Affine((c5, s5, -s5, c5, 0.0, 0.0))
    skew2 = Affine((1.0, -0.15, 0.35, 1.0, 0.0, 0.0))
    t1 = (Affine.translate(250.0, 270.0) @ Affine.scale(18.0, 14.0)
          @ rot5 @ Affine.translate(-8.0, -8.0))
    t2 = (Affine.translate(250.0, 670.0) @ Affine.scale(20.0, 10.0)
          @ skew2 @ Affine.translate(-8.0, -8.0))
    for t in (t1, t2):
        for i, q in enumerate((ImageQuality.LOW, ImageQuality.MEDIUM,
                               ImageQuality.HIGH)):
            img = Image(data=data, quality=q)
            scene.draw_image(img, Affine.translate(i * 420.0, 0.0) @ t)


def _image_extend_modes(quality):
    from ..peniko import Image

    def build(scene: Scene, params: SceneParams) -> None:
        params.resolution = (1500.0, 1500.0)
        params.base_color = palette.WHITE
        data = _sample_image()
        off = Affine.translate(2.0, 2.0)
        rect = rect_path(0.0, 0.0, 6.0, 6.0)
        cases = [
            (Extend.PAD, Extend.PAD, (100.0, 100.0)),
            (Extend.REFLECT, Extend.REFLECT, (100.0, 800.0)),
            (Extend.REPEAT, Extend.REPEAT, (800.0, 100.0)),
            (Extend.REPEAT, Extend.REFLECT, (800.0, 800.0)),
        ]
        for xe, ye, (tx, ty) in cases:
            img = Image(data=data, x_extend=xe, y_extend=ye,
                        quality=quality)
            scene.fill(Fill.NON_ZERO,
                       Affine.translate(tx, ty) @ Affine.scale(100.0),
                       img, off, rect)
    return build


def image_extend_modes_bilinear(scene, params):
    from ..peniko import ImageQuality
    _image_extend_modes(ImageQuality.MEDIUM)(scene, params)


def image_extend_modes_nearest(scene, params):
    from ..peniko import ImageQuality
    _image_extend_modes(ImageQuality.LOW)(scene, params)


REFERENCE_SCENES.update({
    "image_sampling": image_sampling,
    "image_sampling_bicubic": image_sampling_bicubic,
    "image_extend_modes_bilinear": image_extend_modes_bilinear,
    "image_extend_modes_nearest": image_extend_modes_nearest,
})


# test_scenes.rs brush_transform (time = 0)
def brush_transform(scene: Scene, params: SceneParams) -> None:
    th = params.time
    linear = Gradient.linear((0.0, 0.0), (0.0, 200.0),
                             stops(palette.RED, palette.GREEN,
                                   palette.BLUE))
    radial = Gradient.radial((200.0, 200.0), 80.0,
                             stops(palette.RED, palette.GREEN,
                                   palette.BLUE))
    scene.fill(Fill.NON_ZERO,
               Affine.rotate(math.radians(25.0)) @ Affine.scale(2.0, 1.0),
               radial, None, rect_path(100.0, 100.0, 300.0, 300.0))
    around = (Affine.translate(200.0, 100.0) @ Affine.rotate(th)
              @ Affine.translate(-200.0, -100.0))
    scene.fill(Fill.NON_ZERO, Affine.translate(200.0, 600.0), linear,
               around, rect_path(0.0, 0.0, 400.0, 200.0))
    scene.stroke(Stroke(width=40.0), Affine.translate(800.0, 600.0),
                 linear, around, rect_path(0.0, 0.0, 400.0, 200.0))
    params.resolution = (1300.0, 900.0)


# test_scenes.rs many_draw_objects: 90k yellow circles (draw-count scale)
def many_draw_objects(scene: Scene, params: SceneParams) -> None:
    n_wide, n_high = 300, 300
    sw, sh = 2000.0, 1500.0
    params.resolution = (sw, sh)
    for j in range(n_high):
        y = (j + 0.5) * (sh / n_high)
        for i in range(n_wide):
            x = (i + 0.5) * (sw / n_wide)
            scene.fill(Fill.NON_ZERO, Affine.identity(), palette.YELLOW,
                       None, circle_path(x, y, 3.0))


REFERENCE_SCENES.update({
    "brush_transform": brush_transform,
    "many_draw_objects": many_draw_objects,
})
