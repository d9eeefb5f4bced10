"""The port's own host side (its copy of vello_tpu's scene, encoding,
resolve and estimator) against the JAX package's, on the CPU.

Each scene is built twice, once through each package, by the same builder
given the package's ``scenes.test_scenes`` module, and resolved at 256x256.
Every field of the two ``ResolvedScene``s must be equal (arrays with
``np.array_equal`` and the same dtype) and so must the capacity tiers:
the copy is the same code, so the bar is equality.

Each package's ``native.py`` falls back to its numpy code, silently, when
its C++ library fails to build or load, and the C++ and numpy capacity
estimators disagree (``test_stroke_estimators_differ``), so the two
packages are held equal on the same estimator (``same_estimator``)."""

import dataclasses
import importlib
import time

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)

SIZE = 256

SCENES = {
    "funky_paths": lambda ts: ts.funky_paths(),
    "fill_types": lambda ts: ts.fill_types(),
    "stroke_styles": lambda ts: ts.stroke_styles(),
    "gradient_suite": lambda ts: ts.gradient_suite(),
    "blend_grid": lambda ts: ts.blend_grid(),
    "many_clips": lambda ts: ts.many_clips(),
    "filled_mmark": lambda ts: ts.filled_mmark(1, 128.0),
    "mmark": lambda ts: ts.mmark(1, 256.0),
    "layered_mmark": lambda ts: ts.layered_mmark(1, 256.0),
}


def _resolve(pkg, name, aa):
    ts = importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")
    res = importlib.import_module(f"{pkg.__name__}.encoding.resolve")
    params = pkg.RenderParams(SIZE, SIZE, antialiasing=aa)
    rs = res.resolve(SCENES[name](ts).encoding, params)
    return rs, rs.capacities(params).key()


def _assert_same(got, ref, what):
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
        assert np.array_equal(got, ref), what
    elif dataclasses.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, what
        for f in dataclasses.fields(ref):
            _assert_same(getattr(got, f.name), getattr(ref, f.name),
                         f"{what}.{f.name}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{what}[{i}]")
    else:
        assert got == ref, (what, got, ref)


def _native(pkg):
    return importlib.import_module(f"{pkg.__name__}.native")


def _load_native(native, tries: int = 3) -> bool:
    """Load a package's C++ library, clearing its cached failure and
    trying again: the JAX package's loader rebuilds
    native/libvello_native.so in place when the source is newer, so a
    test worker can read a half-written file while another builds it."""
    for i in range(tries):
        if native.available():
            return True
        native._lib = None
        time.sleep(0.2 * i)
    return native.available()


@pytest.fixture
def same_estimator(monkeypatch):
    """Both packages on the C++ estimator, or, when either library still
    fails to load, both on numpy for this test."""
    mods = [_native(vello_tpu), _native(vello_tpu_torch)]
    if not all([_load_native(m) for m in mods]):
        for m in mods:
            monkeypatch.setattr(m, "_lib", False)


@pytest.mark.parametrize("pkg", [vello_tpu, vello_tpu_torch],
                         ids=["jax", "port"])
def test_stroke_estimators_differ(pkg, monkeypatch):
    """A fault of the reference that the port copies: on the stroked
    mmark(1, 256.) the C++ capacity estimator gives 27594 est_touches and
    the numpy fallback 27601 (the same lines, 24185, and the same tier),
    in both packages. The fallback is silent, so a package whose library
    fails to load resolves the scene to other estimates."""
    native = _native(pkg)
    assert _load_native(native)
    cpp, cpp_key = _resolve(pkg, "mmark", "msaa16")
    monkeypatch.setattr(native, "_lib", False)
    npy, npy_key = _resolve(pkg, "mmark", "msaa16")
    assert (cpp.est_touches, npy.est_touches) == (27594, 27601)
    assert cpp.est_lines == npy.est_lines == 24185
    assert cpp_key == npy_key


@pytest.mark.parametrize("aa", ["area", "msaa16"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_resolve_matches_jax(same_estimator, name, aa):
    got, got_key = _resolve(vello_tpu_torch, name, aa)
    ref, ref_key = _resolve(vello_tpu, name, aa)
    assert type(got).__module__ == "vello_tpu_torch.encoding.resolve"
    _assert_same(got, ref, "ResolvedScene")
    assert got_key == ref_key
    assert got.n_segs > 0 and got.est_touches > 0


def test_text_methods_draw():
    """``draw_text`` lays out and draws a run in the default font, and
    ``draw_glyphs`` returns the port's builder; the text scenes are there
    (their resolved scenes against the JAX package's:
    tests/test_torch_text.py)."""
    pytest.importorskip("fontTools")
    pytest.importorskip("matplotlib")
    from vello_tpu_torch import text
    from vello_tpu_torch.scenes import test_scenes

    scene = vello_tpu_torch.Scene()
    scene.draw_text("Hello", 8, 20, 14, vello_tpu_torch.palette.WHITE)
    assert scene.encoding.n_paths == 1
    run = scene.draw_glyphs(text.default_font())
    assert isinstance(run, text.DrawGlyphs) and run.scene is scene
    run.font_size(14).draw(vello_tpu_torch.Fill.NON_ZERO,
                           text.layout_text(run.font, 14.0, "ab", (8, 40)))
    assert scene.encoding.n_paths == 2
    img = vello_tpu_torch.Renderer(device="cpu").render_u8(
        scene, vello_tpu_torch.RenderParams(64, 48))
    assert img[12:22, 8:40, :3].max() > 200        # white ink on black
    for name in ("text_scene", "text_heavy", "tiger"):
        assert callable(getattr(test_scenes, name))
    assert test_scenes.DEVICE_SCENES["text_scene"] is test_scenes.text_scene
