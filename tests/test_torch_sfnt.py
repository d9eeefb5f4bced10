"""The port's own TrueType reader (``vello_tpu_torch/sfnt.py``) against
fontTools, and the port's text path with no font package at all.

The reader: DejaVu Sans (the port's copy in ``vello_tpu_torch/assets/
fonts/``) against fontTools glyph by glyph (best cmap, advances, side
bearings, hhea metrics and every outline, composites included, bit for
bit through a copy of the pen the port's text module used with fontTools),
a synthetic font whose composites carry scales, 2x2 matrices, nesting, a
scaled offset and a point-matched component, and the COLR v0 font of
``synth_fonts.py``. The text path: a subprocess that refuses fontTools,
matplotlib and PIL resolves ``text_heavy`` and the accented ``glyph_runs``
to the JAX package's ResolvedScenes (fontTools' outlines), renders them on
the CPU within 1 u8 level of the JAX package's frames, and raises
ImportError, naming the ROADMAP item, for each feature still on a font
package (variations, hinting), while a COLR v1 font draws.
"""

import hashlib
import os
import pickle
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from vello_tpu import text as jax_text
from vello_tpu.encoding.resolve import resolve as jax_resolve
from test_torch_host import _assert_same
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import text
from vello_tpu_torch.kurbo import BezPath
from vello_tpu_torch.scenes import test_scenes
from vello_tpu_torch.sfnt import (ROUND_XY_TO_GRID, SCALED_COMPONENT_OFFSET,
                                  SfntFont)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT_PACKAGES = ("fontTools", "matplotlib", "PIL")


class _PathPen:
    """The segment pen the port's text module drew fontTools glyphs with
    before it read fonts itself (its ``_PathPen``, kept here as the
    reference): implied on-curve points of a quadratic run at ``(a + b) /
    2.0``, an all-off-curve contour closed on the current point."""

    def __init__(self):
        self.path = BezPath()

    def moveTo(self, p):
        self.path.move_to(p[0], p[1])

    def lineTo(self, p):
        self.path.line_to(p[0], p[1])

    def qCurveTo(self, *points):
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


def _fonttools_outline(glyph_set, name) -> BezPath:
    """A glyph through fontTools as the port drew it: its own pen, then a
    DecomposingRecordingPen replayed into a new one for a composite."""
    from fontTools.pens.recordingPen import DecomposingRecordingPen
    pen = _PathPen()
    try:
        glyph_set[name].draw(pen)
    except _NeedsDecompose:
        rp = DecomposingRecordingPen(glyph_set)
        glyph_set[name].draw(rp)
        pen = _PathPen()
        rp.replay(pen)
    return pen.path


def _sfnt_outline(sf: SfntFont, gid: int) -> BezPath:
    pen = _PathPen()
    sf.draw(gid, pen)
    return pen.path


def _bits(path: BezPath) -> tuple:
    """A path's verbs and the bytes of its f64 coordinates: equal only when
    every value is equal bit for bit (the sign of a zero included)."""
    flat = [v for p in path.points for v in p]
    return tuple(path.verbs), struct.pack(f"<{len(flat)}d", *flat)


@pytest.fixture(scope="module")
def dejavu():
    ttlib = pytest.importorskip("fontTools.ttLib")
    tt = ttlib.TTFont(text.DEFAULT_FONT, lazy=True)
    with open(text.DEFAULT_FONT, "rb") as f:
        return tt, SfntFont(f.read())


def test_dejavu_cmap_and_metrics_equal_fonttools(dejavu):
    tt, sf = dejavu
    order = tt.getGlyphOrder()
    assert len(order) == sf.num_glyphs == 6241
    best = tt.getBestCmap()
    # every mapped code point, in fontTools' order (the hinted path's
    # reverse map depends on it)
    assert list(sf.cmap.items()) == [(cp, tt.getGlyphID(name))
                                     for cp, name in best.items()]
    assert len(sf.cmap) == 5906
    hmtx = tt["hmtx"]
    assert [(sf.advances[i], sf.lsbs[i]) for i in range(len(order))] == \
        [hmtx[name] for name in order]
    assert sf.num_glyphs > tt["hhea"].numberOfHMetrics   # last advance
    hhea = tt["hhea"]
    assert (sf.ascent, sf.descent, sf.line_gap) == \
        (hhea.ascent, hhea.descent, hhea.lineGap)
    assert sf.units_per_em == tt["head"].unitsPerEm == 2048
    font = text.Font(text.DEFAULT_FONT)
    assert font.line_metrics() == (hhea.ascent, hhea.descent, hhea.lineGap)
    assert font.glyph_id("\U0010FFFF") == 0       # unmapped: gid 0
    assert font._tt is None                       # fontTools not opened


@pytest.mark.parametrize("part", range(4))
def test_every_dejavu_outline_equals_fonttools(dejavu, part):
    """All 6241 glyphs in four parts: the same BezPath, bit for bit, as
    fontTools' glyph set draws through the port's old pen; the composites
    decomposed, the empty glyphs (space) empty, and the glyphs whose xMin
    is not their lsb shifted at the top level only."""
    tt, sf = dejavu
    glyph_set = tt.getGlyphSet()
    order = tt.getGlyphOrder()
    for gid in range(part, len(order), 4):
        ref = _fonttools_outline(glyph_set, order[gid])
        assert _bits(_sfnt_outline(sf, gid)) == _bits(ref), (gid, order[gid])


def test_dejavu_composite_and_shifted_totals(dejavu):
    tt, sf = dejavu
    glyf = tt["glyf"]
    names = tt.getGlyphOrder()
    composites = [i for i, n in enumerate(names) if glyf[n].isComposite()]
    assert len(composites) == 2599
    assert all(type(sf.glyph(i)).__name__ == "CompositeGlyph"
               for i in composites)
    shifted = [n for n in names if hasattr(glyf[n], "xMin")
               and tt["hmtx"][n][1] != glyf[n].xMin]
    assert len(shifted) == 5
    assert sf.glyph(tt.getGlyphID("space")) is None


def _build_composite_font(path):
    """Composites of a quadratic glyph and an all-off-curve ring: a
    uniform scale, x/y scales, a 2x2 matrix, a nest of them (with an
    identity component), a scaled offset with ROUND_XY_TO_GRID, and a
    point-matched component."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen
    from fontTools.ttLib.tables._g_l_y_f import GlyphComponent
    from synth_fonts import _square

    def simple(draw):
        pen = TTGlyphPen(None)
        draw(pen)
        return pen.glyph()

    def base(pen):
        pen.moveTo((0, 0))
        pen.qCurveTo((50, 150), (150, 150), (200, 0))
        pen.lineTo((100, -50))
        pen.closePath()

    def ring(pen):
        pen.qCurveTo((0, 100), (100, 200), (200, 100), (100, 0), None)
        pen.closePath()

    def composite(*components):
        pen = TTGlyphPen({"base", "ring", "scaled", "xy", "twobytwo"})
        for name, t in components:
            pen.addComponent(name, t)
        return pen.glyph()

    glyphs = {".notdef": _square(0, 0, 10, 10), "base": simple(base),
              "ring": simple(ring),
              "scaled": composite(("base", (0.5, 0, 0, 0.5, 10, 20))),
              "xy": composite(("ring", (0.75, 0, 0, 1.25, -5, 7))),
              "twobytwo": composite(("base", (0.7, 0.3, -0.2, 0.9, 30, -10))),
              "nested": composite(("scaled", (0.8, -0.1, 0.25, 1.1, 3, 4)),
                                  ("xy", (1, 0, 0, 1, 50, 60)),
                                  ("twobytwo", (1, 0, 0, 1, 0, 0))),
              "apple": composite(("base", (0.5, 0, 0, 0.5, 33, 17))),
              "matched": composite(("base", (1, 0, 0, 1, 0, 0)))}
    glyphs["apple"].components[0].flags |= (SCALED_COMPONENT_OFFSET
                                            | ROUND_XY_TO_GRID)
    c = GlyphComponent()
    c.glyphName, c.firstPt, c.secondPt, c.flags = "ring", 3, 1, 0
    c.transform = [[0.5, 0], [0, 0.5]]
    glyphs["matched"].components.append(c)
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(list(glyphs))
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(glyphs)
                          if n != ".notdef"})
    fb.setupGlyf(glyphs)
    fb.setupHorizontalMetrics({n: (1000, 7) for n in glyphs})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Composites", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    fb.save(path)


def test_composite_transforms_equal_fonttools(tmp_path):
    ttlib = pytest.importorskip("fontTools.ttLib")
    path = str(tmp_path / "composites.ttf")
    _build_composite_font(path)
    tt = ttlib.TTFont(path)
    with open(path, "rb") as f:
        sf = SfntFont(f.read())
    gid = tt.getGlyphID
    assert list(sf.cmap.items()) == [(cp, gid(n)) for cp, n in
                                     tt.getBestCmap().items()]   # format 4
    glyph_set = tt.getGlyphSet()
    for name in ("base", "ring", "scaled", "xy", "twobytwo", "nested"):
        got = _sfnt_outline(sf, gid(name))
        assert not got.is_empty()
        assert _bits(got) == _bits(_fonttools_outline(glyph_set, name)), name
    glyf = tt["glyf"]

    def coords(name):
        return np.array(glyf[name].getCoordinates(glyf)[0], np.float64)
    # the scaled offset: fontTools' getCoordinates scales (33, 17) to
    # (16.5, 8.5); ROUND_XY_TO_GRID rounds it to (17, 9)
    got = np.array(sf.points(gid("apple")), np.float64)
    np.testing.assert_array_equal(got - coords("apple"), 0.5)
    # the point-matched ring: its point 1 on the composite's point 3
    got = np.array(sf.points(gid("matched")), np.float64)
    np.testing.assert_allclose(got, coords("matched"), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[3], got[5 + 1])     # base: 5 points
    path = _sfnt_outline(sf, gid("matched"))
    assert path.verbs.count(4) == 2                  # two closed contours


def test_colr_v0_layers_equal_fonttools(tmp_path):
    ttlib = pytest.importorskip("fontTools.ttLib")
    from synth_fonts import build_colr_font
    path = str(tmp_path / "colr.ttf")
    build_colr_font(path)
    tt = ttlib.TTFont(path)
    with open(path, "rb") as f:
        sf = SfntFont(f.read())
    assert sf.colr_version == 0
    for name, layers in tt["COLR"].ColorLayers.items():
        assert sf.colr_layers(tt.getGlyphID(name)) == [
            (tt.getGlyphID(r.name), r.colorID) for r in layers]
    assert sf.colr_layers(tt.getGlyphID("back")) is None
    assert sf.palettes() == [[(c.red, c.green, c.blue, c.alpha) for c in p]
                             for p in tt["CPAL"].palettes]
    # Font.colr_layers: the same (gid, Color) layers as the JAX package's
    gid = tt.getGlyphID("emoji")
    got = text.Font(path).colr_layers(gid)
    ref = jax_text.Font(path).colr_layers(gid)
    assert [(g, c and (c.r, c.g, c.b, c.a)) for g, c in got] == \
        [(g, c and (c.r, c.g, c.b, c.a)) for g, c in ref]


def test_repo_font_is_matplotlibs_copy():
    matplotlib = pytest.importorskip("matplotlib")
    theirs = os.path.join(matplotlib.get_data_path(), "fonts", "ttf",
                          "DejaVuSans.ttf")

    def sha256(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert sha256(text.DEFAULT_FONT) == sha256(theirs)
    assert os.path.getsize(text.DEFAULT_FONT) == 756072
    assert os.path.isfile(os.path.join(text.FONT_DIR, "LICENSE_DEJAVU"))
    assert text.default_font().path == text.DEFAULT_FONT


def test_missing_default_font_raises_with_its_path(tmp_path, monkeypatch):
    missing = str(tmp_path / "DejaVuSans.ttf")
    monkeypatch.setattr(text, "DEFAULT_FONT", missing)
    text.default_font.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match=re.escape(missing)):
            text.default_font()
    finally:
        text.default_font.cache_clear()


def test_bitmap_strikes_without_pil_raise(monkeypatch):
    """Bitmap strikes draw with PIL and fontTools refused: sfnt.py reads
    CBLC/CBDT and sbix, utils/png.py decodes their PNGs (nothing raises)."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "fontTools", None)
    for name in ("CbdtStrikes.ttf", "SbixStrikes.ttf"):
        font = text.Font(os.path.join(text.FONT_DIR, "test", name))
        assert font.has_bitmaps
        img, _, _, ppem = font.bitmap_glyph(font.glyph_id("\u2764"))
        assert img.data.shape == (48, 48, 4) and ppem == 48.0
        assert img.data[..., 3].max() == 255
        s = vello_tpu_torch.Scene()
        (s.draw_glyphs(font).font_size(48.0).draw(
            vello_tpu_torch.Fill.NON_ZERO,
            text.layout_text(font, 48.0, "\u2764\u2b50", (0.0, 48.0))))
        assert s.encoding.n_paths == 2
        assert font._tt is None


_FONT_IMPORT = re.compile(
    r"^(\s*)(?:import|from) (jax|vello_tpu|fontTools|matplotlib|PIL)"
    r"(\.|\s|$)", re.M)


def test_font_packages_imported_only_inside_queued_features():
    """In the port and chip_smoke.py, a font package is imported only
    inside a function (never at module level), and only in text.py, where
    each such import serves a feature of ``text.FONT_PACKAGE_FEATURES``;
    colr.py imports none."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vello_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    found = []
    for path in paths:
        with open(path) as f:
            for m in _FONT_IMPORT.finditer(f.read()):
                found.append((os.path.relpath(path, REPO), m.group(2),
                              len(m.group(1))))
    assert {(p, pkg) for p, pkg, _ in found} == {
        ("vello_tpu_torch/text.py", "fontTools"),
        ("vello_tpu_torch/text.py", "PIL")}, found
    assert all(indent > 0 for _, _, indent in found), found
    assert set(text.FONT_PACKAGE_FEATURES) == {"variations", "hinting", "cff"}


_BLOCKED = """
import pickle
import sys
for name in {packages!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import vello_tpu_torch as vt
from vello_tpu_torch import text
from vello_tpu_torch.scenes import test_scenes

out, errors = {{}}, {{}}
for name, build, size in {scenes!r}:
    scene = eval(build, {{"test_scenes": test_scenes}})
    params = vt.RenderParams(size, size)
    rs = vt.resolve(scene.encoding, params)
    out[name] = (rs, rs.capacities(params).key(),
                 vt.Renderer(device="cpu").render_u8(scene, params))
font = text.default_font()
glyphs = text.layout_text(font, 14.0, "hinted", (2.0, 0.0))
try:
    (vt.Scene().draw_glyphs(font).font_size(14.0).brush(vt.palette.WHITE)
     .transform(vt.Affine.translate(0.0, 20.0)).hint(True)
     .draw(vt.Fill.NON_ZERO, glyphs))
except ImportError as e:
    errors["hinting"] = str(e)
try:
    text.Font(sys.argv[2], variations={{"wght": 700}})
except ImportError as e:
    errors["variations"] = str(e)
colr1 = text.Font(sys.argv[3])
try:
    (vt.Scene().draw_glyphs(colr1).font_size(64.0)
     .draw(vt.Fill.NON_ZERO, [text.Glyph(colr1.glyph_id("A"), 0.0, 60.0)]))
except ImportError as e:
    errors["colr_v1"] = str(e)
out["errors"] = errors
out["loaded"] = sorted(m for m, v in sys.modules.items() if v is not None
                       and m.split(".")[0] in {foreign!r})
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

# name -> (the scene through the port's test_scenes, its size)
BLOCKED_SCENES = {
    "text_heavy": ("test_scenes.text_heavy(256.0, lines=4)", 256),
    "glyph_runs": ("test_scenes.glyph_runs(256.0)", 256),
    "glyph_raster": ("test_scenes.glyph_runs(256.0, raster=True)", 256),
}


def _jax_scene(name):
    """The JAX package's twin of a BLOCKED_SCENES entry (the port's
    glyph_runs has no JAX counterpart: the same calls through vello_tpu)."""
    from vello_tpu.scenes import test_scenes as jax_scenes
    if name == "text_heavy":
        return jax_scenes.text_heavy(256.0, lines=4)
    vt = vello_tpu
    font = jax_text.default_font()
    s = vt.Scene()
    k = 1.0
    px = 13.0 * k
    glyphs = jax_text.layout_text(font, px, test_scenes.ACCENTED)

    def run(line, color):
        return (s.draw_glyphs(font).font_size(px).brush(color)
                .transform(vt.Affine.translate(6.0 * k,
                                               (40.0 + 50.0 * line) * k)))
    p = vt.palette
    if name == "glyph_raster":
        run(0, p.WHITE).raster(True).draw(vt.Fill.NON_ZERO, glyphs)
        run(1, p.LIME).raster(True).draw(vt.Fill.NON_ZERO, glyphs)
    else:
        run(0, p.WHITE).draw(vt.Fill.NON_ZERO, glyphs)
        run(1, p.YELLOW).draw(vt.Stroke(width=1.5, join="round"), glyphs)
        run(2, p.CYAN).embolden(0.6 * k).draw(vt.Fill.NON_ZERO, glyphs)
    return s


@pytest.fixture(scope="module")
def blocked(tmp_path_factory):
    """The port's text path in a subprocess that refuses fontTools,
    matplotlib and PIL (``sys.modules[name] = None`` before it imports the
    port); the variable and COLR v1 fonts it is asked about are built here
    with fontTools."""
    pytest.importorskip("fontTools")
    from synth_fonts import build_var_font
    from test_torch_text import _build_colr_v1_font
    tmp = tmp_path_factory.mktemp("blocked")
    var, colr1 = str(tmp / "var.ttf"), str(tmp / "colr1.ttf")
    build_var_font(var)
    _build_colr_v1_font(colr1)
    out = str(tmp / "out.pkl")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = _BLOCKED.format(
        packages=FONT_PACKAGES,
        scenes=[(n, b, s) for n, (b, s) in BLOCKED_SCENES.items()],
        foreign=FONT_PACKAGES + ("jax", "jaxlib", "vello_tpu"))
    proc = subprocess.run([sys.executable, "-c", script, out, var, colr1],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", list(BLOCKED_SCENES))
def test_blocked_text_resolves_equal_to_jax(blocked, name):
    pytest.importorskip("matplotlib")
    got, key, _ = blocked[name]
    params = vello_tpu.RenderParams(256, 256)
    ref = jax_resolve(_jax_scene(name).encoding, params)
    assert type(got).__module__ == "vello_tpu_torch.encoding.resolve"
    _assert_same(got, ref, "ResolvedScene")
    assert key == ref.capacities(params).key()
    assert got.n_segs > 0
    if name == "text_heavy":
        assert got.n_paths == 4


@pytest.mark.parametrize("name", ["text_heavy", "glyph_runs"])
def test_blocked_text_frame_near_jax(blocked, name):
    """The port's CPU frame of the blocked run within 1 u8 level of the
    JAX package's Renderer frame (JAX_PLATFORMS=cpu)."""
    pytest.importorskip("matplotlib")
    from vello_tpu.models.renderer import Renderer as JaxRenderer
    _, _, got = blocked[name]
    ref = JaxRenderer().render_u8(_jax_scene(name),
                                  vello_tpu.RenderParams(256, 256))
    assert got.shape == ref.shape == (256, 256, 4)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1, (int(d.max()), int((d > 1).sum()))
    assert got[..., 3].max() == 255


def test_blocked_features_raise_naming_their_item(blocked):
    """Hinting and variable fonts raise, naming their item; a COLR v1 font
    draws (sfnt.py reads its paint graph)."""
    errors = blocked["errors"]
    assert set(errors) == {"hinting", "variations"}, errors
    for feature, item, package in (("hinting", 27, "PIL"),
                                   ("variations", 24, "fontTools")):
        assert f"ROADMAP.md item {item}" in errors[feature], errors[feature]
        assert package in errors[feature], errors[feature]
    # nothing of the three packages, of JAX or of the JAX package loaded
    assert blocked["loaded"] == []


def test_text_through_the_package_api_needs_no_font_package(blocked):
    """What the blocked subprocess drew is what Scene.draw_text draws here
    (fontTools present): the port never reads it for outlines."""
    rs = blocked["text_heavy"][0]
    here = vello_tpu_torch.resolve(test_scenes.text_heavy(256.0, lines=4)
                                   .encoding,
                                   vello_tpu_torch.RenderParams(256, 256))
    _assert_same(here, rs, "ResolvedScene")
    assert text.default_font()._tt is None
