"""The port's text host modules (``text.py``, ``colr.py``) against the JAX
package's, on the CPU.

Each glyph run is drawn through each package's own ``Scene`` and ``Font``
and resolved; every field of the two ``ResolvedScene``s must be equal, as
in ``test_torch_host.py`` (the copies are the same code). The port's
``text_scene`` frame is also held to the JAX package's golden
``tests/snapshots/text_scene.png`` with the device bars of
``test_snapshots.py``. Fonts: DejaVu Sans from matplotlib (the default
font), and the COLR v0 and variable fonts of ``synth_fonts.py``.
"""

import importlib
import os

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from test_torch_host import _assert_same
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer
from vello_tpu_torch.utils.png import read_png, to_rgba8

pytest.importorskip("fontTools")

SNAPSHOTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "snapshots")


def _text(pkg):
    return importlib.import_module(f"{pkg.__name__}.text")


def _test_scenes(pkg):
    return importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")


def _resolve_both(build, w=128, h=128, aa="area"):
    out = []
    for pkg in (vello_tpu_torch, vello_tpu):
        params = pkg.RenderParams(w, h, antialiasing=aa)
        res = importlib.import_module(f"{pkg.__name__}.encoding.resolve")
        rs = res.resolve(build(pkg).encoding, params)
        out.append((rs, rs.capacities(params).key()))
    (got, got_key), (ref, ref_key) = out
    assert type(got).__module__ == "vello_tpu_torch.encoding.resolve"
    _assert_same(got, ref, "ResolvedScene")
    assert got_key == ref_key
    assert got.n_segs > 0 or len(got.paint_kind) > 0
    return got


def test_text_scene_resolves_equal_and_meets_its_golden():
    """text_scene(128.) through both packages, and the port's CPU frame
    against the golden: RGBA8 mean < 0.002, max < 4.01/255
    (``tests/snapshot.py``, ``test_snapshots.py::test_snapshot_device``)."""
    pytest.importorskip("matplotlib")
    _resolve_both(lambda pkg: _test_scenes(pkg).text_scene(128.0))
    from vello_tpu_torch.scenes.test_scenes import DEVICE_SCENES
    assert DEVICE_SCENES["text_scene"] is \
        _test_scenes(vello_tpu_torch).text_scene
    params = vello_tpu_torch.RenderParams(
        128, 128, base_color=(0.05, 0.05, 0.05, 1.0))
    img = Renderer(device="cpu").render(DEVICE_SCENES["text_scene"](128.0),
                                        params)
    golden = read_png(os.path.join(SNAPSHOTS, "text_scene.png"))
    d = np.abs(golden.astype(np.float64)
               - to_rgba8(img).astype(np.float64)) / 255.0
    assert d.mean() < 0.002, d.mean()
    assert d.max() < 4.01 / 255.0, d.max()


def test_text_heavy_resolves_equal():
    pytest.importorskip("matplotlib")
    rs = _resolve_both(
        lambda pkg: _test_scenes(pkg).text_heavy(256.0, lines=4), 256, 256)
    assert rs.n_paths == 4


def _colr_run(path):
    def build(pkg):
        text = _text(pkg)
        font = text.Font(path)
        gid = font.glyph_id("A")
        assert font.colr_layers(gid) is not None
        s = pkg.Scene()
        # a foreground brush for the palette's 0xFFFF entries, and a
        # stroked run whose color layers are still filled
        (s.draw_glyphs(font).font_size(64).brush(pkg.Color(0, 0, 0, 1))
         .draw(pkg.Fill.NON_ZERO, [text.Glyph(gid, 0, 60)]))
        (s.draw_glyphs(font).font_size(40).brush(pkg.palette.WHITE)
         .transform(pkg.Affine.translate(60, 10))
         .draw(pkg.Stroke(width=2.0), [text.Glyph(gid, 0, 40)]))
        return s
    return build


def test_colr_v0_font_resolves_equal(tmp_path):
    from synth_fonts import build_colr_font
    p = str(tmp_path / "colr.ttf")
    build_colr_font(p)
    rs = _resolve_both(_colr_run(p))
    assert rs.n_paths == 4            # two runs of two color layers


def _build_colr_v1_font(path):
    """synth_fonts' COLR glyph as a COLR v1 paint graph: layers clipped to
    glyph outlines and filled with a linear and a radial gradient (pad and
    reflect), and a multiply composite of a solid over a skewed sweep
    gradient (repeat)."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.ttLib.tables import otTables as ot
    from synth_fonts import _square

    def line(extend, *stops):
        return {"Extend": extend, "ColorStop": [
            {"StopOffset": o, "PaletteIndex": i, "Alpha": a}
            for o, i, a in stops]}

    def glyph(name, paint):
        return {"Format": ot.PaintFormat.PaintGlyph, "Glyph": name,
                "Paint": paint}

    fb = FontBuilder(1000, isTTF=True)
    glyphs = [".notdef", "emoji", "back", "front"]
    fb.setupGlyphOrder(glyphs)
    fb.setupCharacterMap({ord("A"): "emoji"})
    fb.setupGlyf({".notdef": _square(0, 0, 10, 10),
                  "emoji": _square(100, 100, 900, 800),
                  "back": _square(100, 100, 900, 800),
                  "front": _square(300, 300, 700, 600)})
    fb.setupHorizontalMetrics({g: (1000, 0) for g in glyphs})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "ColrV1Test", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    sweep = {"Format": ot.PaintFormat.PaintSweepGradient,
             "ColorLine": line("repeat", (0.0, 0, 1.0), (1.0, 2, 1.0)),
             "centerX": 500, "centerY": 450, "startAngle": 0,
             "endAngle": 270}
    fb.setupCOLR({"emoji": {
        "Format": ot.PaintFormat.PaintColrLayers, "Layers": [
            glyph("back", {
                "Format": ot.PaintFormat.PaintLinearGradient,
                "ColorLine": line("pad", (0.0, 0, 1.0), (1.0, 1, 1.0)),
                "x0": 100, "y0": 100, "x1": 900, "y1": 800, "x2": 100,
                "y2": 800}),
            glyph("front", {
                "Format": ot.PaintFormat.PaintRadialGradient,
                "ColorLine": line("reflect", (0.0, 2, 1.0), (1.0, 0, 0.5)),
                "x0": 500, "y0": 450, "r0": 10, "x1": 500, "y1": 450,
                "r1": 200}),
            {"Format": ot.PaintFormat.PaintComposite,
             "CompositeMode": "multiply",
             "SourcePaint": glyph("front", {
                 "Format": ot.PaintFormat.PaintSolid, "PaletteIndex": 1,
                 "Alpha": 0.8}),
             "BackdropPaint": {
                 "Format": ot.PaintFormat.PaintTransform,
                 "Transform": {"xx": 1, "yx": 0, "xy": 0.2, "yy": 1,
                               "dx": 20, "dy": 0},
                 "Paint": glyph("front", sweep)}}]}}, version=1)
    fb.setupCPAL([[(1.0, 0.2, 0.1, 1.0), (0.1, 0.4, 1.0, 1.0),
                   (0.2, 0.9, 0.3, 1.0)]])
    fb.save(path)


def test_colr_v1_font_resolves_equal_and_renders(tmp_path):
    """The COLR v1 paint graph (``colr.ColrV1``) through both packages:
    the same resolved scene, gradient paints and clip and blend layers;
    the port's CPU frame within the corpus bar of its oracle."""
    p = str(tmp_path / "colr1.ttf")
    _build_colr_v1_font(p)

    def build(pkg):
        text = _text(pkg)
        font = text.Font(p)
        gid = font.glyph_id("A")
        assert font.colr_v1().has_glyph(gid)
        s = pkg.Scene()
        (s.draw_glyphs(font).font_size(64).brush(pkg.Color(0, 0, 0, 1))
         .transform(pkg.Affine.translate(0, 2))
         .draw(pkg.Fill.NON_ZERO, [text.Glyph(gid, 0, 60)]))
        return s
    rs = _resolve_both(build, 64, 64)
    from vello_tpu_torch.encoding.resolve import PAINT_GRADIENT
    assert (rs.paint_kind == PAINT_GRADIENT).sum() == 3 and rs.layers
    from vello_tpu_torch.oracle import OracleRenderer
    params = vello_tpu_torch.RenderParams(64, 64)
    img = Renderer(device="cpu").render_resolved(rs, params)
    assert np.abs(img - OracleRenderer().render_resolved(rs, params)).mean() \
        < 2.5e-3
    assert img[..., 3].max() > 0.99


@pytest.mark.parametrize("wght", [100, 650, 900])
def test_variable_font_resolves_equal(tmp_path, wght):
    from synth_fonts import build_var_font
    p = str(tmp_path / "var.ttf")
    build_var_font(p)

    def build(pkg):
        text = _text(pkg)
        font = text.Font(p, variations={"wght": wght})
        s = pkg.Scene()
        (s.draw_glyphs(font).font_size(80).brush(pkg.palette.YELLOW)
         .draw(pkg.Fill.NON_ZERO,
               text.layout_text(font, 80.0, "BB", (4.0, 90.0))))
        return s
    rs = _resolve_both(build)
    # the wght axis moves the box's right edge: the outline differs
    x = rs.data.reshape(-1, 2)[:, 0]
    assert x.max() > (120.0 if wght > 400 else 110.0)


def _dejavu_run(kind):
    """A DejaVu run drawn one way: hinted (FreeType grid fitting through
    PIL), raster (the glyph atlas, rasterized by the oracle), emboldened,
    or with glyph, brush and run transforms and a gradient brush."""
    def build(pkg):
        text = _text(pkg)
        font = text.default_font()
        s = pkg.Scene()
        glyphs = text.layout_text(font, 14.0, "Hinted gy 0123", (4.0, 0.0))
        run = s.draw_glyphs(font).font_size(14.0).brush(
            pkg.palette.WHITE.with_alpha(0.9))
        if kind == "hinted":
            run.transform(pkg.Affine.translate(3.0, 20.0)).hint(True)
        elif kind == "raster":
            run.transform(pkg.Affine.translate(3.0, 20.0)).raster(True)
        elif kind == "embolden":
            run.transform(pkg.Affine.translate(3.0, 20.0)).embolden(0.6)
        else:
            g = pkg.Gradient.linear((0, 0), (120, 0), pkg.peniko.stops(
                pkg.palette.RED, pkg.palette.BLUE))
            (run.brush(g).transform(pkg.Affine.translate(3.0, 30.0)
                                    @ pkg.Affine.rotate(0.1))
             .glyph_transform(pkg.Affine.skew(0.25, 0.0))
             .brush_transform(pkg.Affine.translate(-20.0, 0.0)))
        run.draw(pkg.Fill.NON_ZERO, glyphs)
        return s
    return build


@pytest.mark.parametrize("kind", ["hinted", "raster", "embolden",
                                  "transforms"])
def test_dejavu_runs_resolve_equal(kind):
    pytest.importorskip("matplotlib")
    if kind == "hinted":
        pytest.importorskip("PIL")
    rs = _resolve_both(_dejavu_run(kind))
    from vello_tpu_torch.encoding.resolve import PAINT_IMAGE
    images = int((rs.paint_kind == PAINT_IMAGE).sum())
    # hinted and raster glyphs are image rects (12 inked glyphs), the
    # others outlines
    assert (images >= 12) == (kind in ("hinted", "raster"))


def test_tiger_needs_its_asset_in_both_packages(tmp_path):
    for pkg in (vello_tpu_torch, vello_tpu):
        with pytest.raises(FileNotFoundError):
            _test_scenes(pkg).tiger(64.0, asset=str(tmp_path / "none.svg"))
    assert os.path.basename(_test_scenes(vello_tpu_torch).TIGER_ASSET) == \
        os.path.basename(_test_scenes(vello_tpu).TIGER_ASSET)
    # the port looks the SVG up in the repository's assets/ only, which do
    # not hold it
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _test_scenes(vello_tpu_torch).TIGER_ASSET == os.path.join(
        repo, "assets", "Ghostscript_Tiger.svg")
    with pytest.raises(FileNotFoundError):
        _test_scenes(vello_tpu_torch).tiger()
