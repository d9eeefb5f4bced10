"""The port's SVG loader, device probe and debug captures (``utils/svg.py``,
``utils/probe.py``, ``utils/debug.py``, copies of the JAX package's) on the
CPU: an SVG document loads to the same resolved scene through both
packages, the probe passes on the port's CPU Renderer, and the debug
captures equal the JAX package's."""

import importlib

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from test_torch_host import _assert_same
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.utils import debug as jax_debug
from vello_tpu.utils import svg as jax_svg
from vello_tpu_torch import Renderer
from vello_tpu_torch.utils import debug, probe, svg

# arcs (both flags, rotated, relative), smooth curves, quads, transforms
# (matrix, rotate about a point, nested translate/scale/skewX), stroke
# styles (caps, joins, miter limit), opacity and fill-opacity, even-odd,
# named, short hex and rgb() colors, basic shapes
SVG = """<svg xmlns="http://www.w3.org/2000/svg" width="160" height="120">
  <g transform="translate(4 6) scale(0.9)" opacity="0.8">
    <path d="M10 10 A 30 20 0 0 1 70 10 a 30 20 30 1 0 -20 40 Z"
          fill="#3af" stroke="navy" stroke-width="3"
          stroke-linejoin="round"/>
    <path d="M90 10 C 100 40 120 -10 140 30 S 150 60 120 70 Q 100 80 90 60
             T 80 40 z" fill="rgb(200, 40, 90)" fill-opacity="0.7"
          fill-rule="evenodd"/>
  </g>
  <g transform="matrix(1 0.1 -0.1 1 10 60)">
    <polyline points="0,0 30,20 60,0 90,20" fill="none" stroke="green"
              stroke-width="5" stroke-linecap="round"
              stroke-linejoin="miter" stroke-miterlimit="2"/>
    <rect x="100" y="0" width="40" height="30" rx="6" fill="yellow"
          stroke="black" stroke-linecap="square"/>
  </g>
  <circle cx="30" cy="100" r="12" fill="red" transform="rotate(20 30 100)"/>
  <ellipse cx="80" cy="100" rx="20" ry="8" fill="white"
           transform="skewX(15)" stroke="#000" stroke-opacity="0.5"/>
  <line x1="110" y1="90" x2="150" y2="115" stroke="blue" stroke-width="2"
        stroke-linecap="butt"/>
</svg>"""


def _resolve(pkg, scene, w=160, h=120):
    res = importlib.import_module(f"{pkg.__name__}.encoding.resolve")
    return res.resolve(scene.encoding, pkg.RenderParams(w, h))


def test_svg_loads_and_resolves_equal():
    ours = _resolve(vello_tpu_torch, svg.load_svg(SVG))
    ref = _resolve(vello_tpu, jax_svg.load_svg(SVG))
    _assert_same(ours, ref, "ResolvedScene")
    assert ours.n_paths >= 9
    # the path data parser and the arc conversion alone
    d = "M10 10 A 30 20 0 0 1 70 10 a 30 20 30 1 0 -20 40 Z"
    got, want = svg.parse_path_data(d), jax_svg.parse_path_data(d)
    assert got.verbs == want.verbs
    np.testing.assert_array_equal(np.asarray(got.points),
                                  np.asarray(want.points))


def test_svg_renders_near_the_oracle():
    from vello_tpu_torch.oracle import OracleRenderer
    scene = svg.load_svg(SVG)
    params = vello_tpu_torch.RenderParams(160, 120)
    img = Renderer(device="cpu").render(scene, params)
    assert np.abs(img - OracleRenderer().render(scene, params)).mean() \
        < 2.5e-3
    assert (img[..., 3] > 0.5).mean() > 0.2


def test_probe_passes_on_the_cpu_renderer():
    assert probe.PROBE_PATH.endswith("assets/probe.png")
    assert probe.run_probe(Renderer(device="cpu"))
    # the probe catches a wrong frame: its scene less the blue square

    class Dropping:
        def render(self, scene, params):
            from vello_tpu_torch.kurbo import circle_path, rect_path
            from vello_tpu_torch.peniko import palette
            a, nz = vello_tpu_torch.Affine.identity(), \
                vello_tpu_torch.Fill.NON_ZERO
            cut = vello_tpu_torch.Scene()
            cut.fill(nz, a, palette.RED, None, rect_path(2, 2, 30, 30))
            cut.fill(nz, a, palette.LIME.with_alpha(0.5), None,
                     circle_path(16, 16, 10))
            return Renderer(device="cpu").render(cut, params)
    assert not probe.run_probe(Dropping())


def test_probe_reference_regenerates_only_where_told(tmp_path):
    from vello_tpu_torch.utils.png import read_png
    with open(probe.PROBE_PATH, "rb") as f:
        stored = f.read()
    out = str(tmp_path / "probe.png")
    probe.regenerate_probe_reference(out)
    # the oracle's probe is the stored reference, which stays as it was
    diff = np.abs(read_png(out).astype(int)
                  - read_png(probe.PROBE_PATH).astype(int))
    assert diff.max() <= 2
    with open(probe.PROBE_PATH, "rb") as f:
        assert f.read() == stored


@pytest.mark.parametrize("name", ["funky_paths", "stroke_styles"])
def test_debug_captures_equal_jax(name, tmp_path):
    def capture(pkg, dbg):
        ts = importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")
        return dbg.capture_stages(getattr(ts, name)(64.0),
                                  pkg.RenderParams(64, 64))

    got, want = capture(vello_tpu_torch, debug), capture(vello_tpu, jax_debug)
    _assert_same(got["resolved"], want["resolved"], "resolved")
    for key in ("lines", "line_path", "path_rect"):
        _assert_same(got[key], want[key], key)
    assert got["n_lines"] == want["n_lines"] > 10
    assert sorted(got["decoded"]) == sorted(want["decoded"])
    for key in want["decoded"]:
        _assert_same(np.asarray(got["decoded"][key]),
                     np.asarray(want["decoded"][key]), key)
    assert debug.validate_line_soup(got["lines"], got["line_path"]) == \
        jax_debug.validate_line_soup(want["lines"], want["line_path"])
    img = np.zeros((64, 64, 4), np.float32)
    np.testing.assert_array_equal(debug.overlay_debug(img, got),
                                  jax_debug.overlay_debug(img, want))
    debug.dump_svg(got, str(tmp_path / "port.svg"), scale=2.0)
    jax_debug.dump_svg(want, str(tmp_path / "jax.svg"), scale=2.0)
    assert (tmp_path / "port.svg").read_text() == \
        (tmp_path / "jax.svg").read_text()
