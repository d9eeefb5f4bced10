"""The port's own host side (its copy of vello_tpu's scene, encoding,
resolve and estimator) against the JAX package's, on the CPU.

Each scene is built twice, once through each package, by the same builder
given the package's ``scenes.test_scenes`` module, and resolved at 256x256.
Every field of the two ``ResolvedScene``s must be equal (arrays with
``np.array_equal`` and the same dtype) and so must the capacity tiers:
the copy is the same code, so the bar is equality."""

import dataclasses
import importlib

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


@pytest.mark.parametrize("aa", ["area", "msaa16"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_resolve_matches_jax(name, aa):
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
