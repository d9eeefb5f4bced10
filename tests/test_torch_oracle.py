"""The port's CPU oracle (``vello_tpu_torch.oracle``) against the JAX
package's, on the CPU.

Both are the same numpy code: the port's copy differs in its imports only,
its paint, blend, blur and filter math coming from the numpy copies
``oracle/np_paint.py``, ``np_blend.py``, ``np_blur.py`` and
``np_filters.py``. So the bar is bit equality: each scene, built through
each package's own host side, renders to equal f32 arrays, and each
``np_*`` function returns what its JAX-package counterpart returns when
called with ``xp=numpy``.
"""

import importlib

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from vello_tpu.ops import blend as jax_blend
from vello_tpu.ops import blur as jax_blur
from vello_tpu.ops import filters as jax_filters
from vello_tpu.ops import paint as jax_paint
from vello_tpu.oracle import OracleRenderer as JaxOracle
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch.oracle import (OracleRenderer, np_blend, np_blur,
                                    np_filters, np_paint)

SIZE = 64


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.scenes.{name}")


def _golden_scene(name):
    def build(pkg):
        return _mod(pkg, "reference_scenes").build_for_golden(
            name, SIZE, SIZE)[0]
    return build


# one scene per oracle branch: a paint kind, a layer kind, a fill rule, the
# supersampled msaa branch
SCENES = {
    "gradient": (lambda pkg: _mod(pkg, "test_scenes").gradient_suite(
        float(SIZE)), "area"),
    "image": (_golden_scene("image_sampling_bicubic"), "area"),
    "blurred_rect": (_golden_scene("blurred_rounded_rect"), "area"),
    "blend_layer": (lambda pkg: _mod(pkg, "test_scenes").blend_grid(
        float(SIZE)), "area"),
    "luminance_mask": (lambda pkg: _mod(pkg, "test_scenes").luminance_masks(
        float(SIZE)), "area"),
    "even_odd": (lambda pkg: _mod(pkg, "test_scenes").fill_types(
        float(SIZE)), "area"),
    "layer_filters": (lambda pkg: _mod(pkg, "test_scenes").filter_suite(
        float(SIZE)), "area"),
    "msaa16": (lambda pkg: _mod(pkg, "test_scenes").funky_paths(
        float(SIZE)), "msaa16"),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_oracle_equals_jax_oracle(name):
    build, aa = SCENES[name]
    base = (0.05, 0.05, 0.05, 1.0)
    got = OracleRenderer().render(
        build(vello_tpu_torch),
        vello_tpu_torch.RenderParams(SIZE, SIZE, base_color=base,
                                     antialiasing=aa))
    want = JaxOracle().render(
        build(vello_tpu),
        vello_tpu.RenderParams(SIZE, SIZE, base_color=base, antialiasing=aa))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (SIZE, SIZE, 4)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 4


def test_oracle_reaches_each_np_module(monkeypatch):
    """The scenes above run every numpy copy the oracle calls: each is
    spied on while the scenes render."""
    hit = set()
    targets = [(np_paint, "eval_gradient_static"),
               (np_paint, "sample_image_bicubic"),
               (np_blend, "blend_mix_compose"), (np_blend, "luminance_mask"),
               (np_blend, "src_over"), (np_filters, "apply_filter")]
    for mod, fname in targets:
        original = getattr(mod, fname)

        def spy(*args, _o=original, _n=fname, **kw):
            hit.add(_n)
            return _o(*args, **kw)
        monkeypatch.setattr(mod, fname, spy)
    from vello_tpu_torch.oracle import renderer
    calls = []
    original_blur = renderer.blurred_rounded_rect_coverage
    monkeypatch.setattr(renderer, "blurred_rounded_rect_coverage",
                        lambda *a, **k: calls.append(1) or original_blur(
                            *a, **k))
    for name in ("gradient", "image", "blurred_rect", "luminance_mask",
                 "layer_filters"):
        build, aa = SCENES[name]
        OracleRenderer().render(build(vello_tpu_torch),
                                vello_tpu_torch.RenderParams(16, 16))
    assert hit == {n for _, n in targets} and calls


# ---------------------------------------------------------------------------
# the numpy copies, function by function

def test_np_modules_have_the_jax_functions():
    """Each numpy copy keeps every public name of its JAX-package module,
    less the JAX-only ones (traced blend and filter variants)."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("__")
                and callable(getattr(mod, n))
                and getattr(getattr(mod, n), "__module__", "") == mod.__name__}
    assert public(jax_blend) - public(np_blend) == {"blend_mix_compose_dyn"}
    assert public(jax_blur) == public(np_blur)
    # make_ramp and pack_gradient are the port's ops/paint.py
    assert public(jax_paint) - public(np_paint) == {"make_ramp",
                                                    "pack_gradient"}
    assert np_paint.make_ramp is vello_tpu_torch.ops.paint.make_ramp
    assert all(n.endswith("_dyn") for n in public(jax_filters)
               - public(np_filters))
    for n in ("FILTER_NONE", "FILTER_BLUR", "FILTER_DROP_SHADOW",
              "FILTER_OFFSET", "FILTER_FLOOD"):
        assert getattr(np_filters, n) == getattr(jax_filters, n)


def _premul(rng, shape):
    a = rng.uniform(0.0, 1.0, shape + (1,))
    out = np.concatenate([rng.uniform(0.0, 1.0, shape + (3,)) * a, a],
                         axis=-1)
    out.reshape(-1, 4)[0] = 0.0          # a fully transparent pixel
    return out


def _grid(rng, n=96, lo=-40.0, hi=140.0):
    return rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)


def _ramp(rng):
    return rng.uniform(0.0, 1.0, (512, 4)).astype(np.float32)


def _grad_recs():
    """linear, radial (two-point, and the tangent-circles row), sweep; in
    each extend mode."""
    recs = []
    for ext in (0, 1, 2):
        recs.append([0, ext, 10, 20, 90, 60, 0, 0, 0, 0, 0, 0])
        recs.append([1, ext, 50, 50, 60, 40, 5, 40, 0, 0, 0, 0])
        recs.append([1, ext, 30, 50, 70, 50, 10, 50, 0, 0, 0, 0])
        recs.append([2, ext, 50, 50, 0, 0, 0, 0, 0.3, 4.0, 0, 0])
    return [np.asarray(r, np.float32) for r in recs]


def _image(rng):
    return rng.uniform(0.0, 1.0, (5, 7, 4))


def _blend_cases():
    return [(m, c) for m in range(16) for c in (3, 0, 5, 9, 11, 12)]


# (name, module attribute, args built from an rng; xp=numpy is prepended)
CASES = {
    "mix_rgb": ("blend", "mix_rgb", lambda r: [
        (r.uniform(0, 1, (64, 3)), r.uniform(0, 1, (64, 3)), m)
        for m in range(16)]),
    "blend_mix_compose": ("blend", "blend_mix_compose", lambda r: [
        (_premul(r, (64,)), _premul(r, (64,)), m, c)
        for m, c in _blend_cases()]),
    "svg_luminance": ("blend", "svg_luminance",
                      lambda r: [(r.uniform(0, 1, (64, 3)),)]),
    "luminance_mask": ("blend", "luminance_mask",
                       lambda r: [(_premul(r, (64,)), _premul(r, (64,)))]),
    "alpha_mask": ("blend", "alpha_mask",
                   lambda r: [(_premul(r, (64,)), _premul(r, (64,)))]),
    "src_over": ("blend", "src_over",
                 lambda r: [(_premul(r, (64,)), _premul(r, (64,)))]),
    "apply_extend": ("paint", "apply_extend", lambda r: [
        (r.uniform(-3, 3, 64), m) for m in (0, 1, 2)]),
    "apply_extend_dynamic": ("paint", "apply_extend_dynamic", lambda r: [
        (r.uniform(-3, 3, 64), r.integers(0, 3, 64))]),
    "sample_ramp": ("paint", "sample_ramp", lambda r: [
        (_ramp(r), r.uniform(-0.2, 1.2, 64))]),
    "linear_t": ("paint", "linear_t", lambda r: [
        _grid(r) + (10.0, 20.0, 90.0, 60.0), _grid(r) + (5., 5., 5., 5.)]),
    "radial_t": ("paint", "radial_t", lambda r: [
        _grid(r) + (50.0, 50.0, 60.0, 40.0, 5.0, 40.0),
        _grid(r) + (30.0, 50.0, 70.0, 50.0, 10.0, 50.0),
        _grid(r) + (50.0, 50.0, 50.0, 50.0, 0.0, 30.0)]),
    "sweep_t": ("paint", "sweep_t", lambda r: [
        _grid(r) + (50.0, 50.0, 0.3, 4.0), _grid(r) + (50., 50., 1., 1.)]),
    "eval_gradient_static": ("paint", "eval_gradient_static", lambda r: [
        (rec, _ramp(r)) + _grid(r) for rec in _grad_recs()]),
    "eval_gradient_traced": ("paint", "eval_gradient_traced", lambda r: [
        (rec, _ramp(r)) + _grid(r) for rec in _grad_recs()]),
    "cubic_weights": ("paint", "cubic_weights",
                      lambda r: [(r.uniform(0, 1, 64),)]),
    "sample_image_nearest": ("paint", "sample_image_nearest", lambda r: [
        (_image(r),) + _grid(r, lo=-12, hi=20) + (xe, ye)
        for xe in (0, 1, 2) for ye in (0, 1, 2)]),
    "sample_image_bilinear": ("paint", "sample_image_bilinear", lambda r: [
        (_image(r),) + _grid(r, lo=-12, hi=20) + (xe, ye)
        for xe in (0, 1, 2) for ye in (0, 1, 2)]),
    "sample_image_bicubic": ("paint", "sample_image_bicubic", lambda r: [
        (_image(r),) + _grid(r, lo=-12, hi=20) + (xe, ye)
        for xe in (0, 1, 2) for ye in (0, 1, 2)]),
    "erf": ("blur", "erf", lambda r: [(r.uniform(-4, 4, 64),)]),
    "blurred_rounded_rect_coverage": (
        "blur", "blurred_rounded_rect_coverage", lambda r: [
            _grid(r) + (10.0, 20.0, 90.0, 70.0, c, s)
            for c, s in ((0.0, 2.0), (12.0, 5.0), (80.0, 0.0))]),
    "box_blur_axis": ("filters", "box_blur_axis", lambda r: [
        (_premul(r, (12, 10)), rad, ax) for rad in (0, 1, 4)
        for ax in (0, 1)]),
    "gaussian_blur": ("filters", "gaussian_blur", lambda r: [
        (_premul(r, (12, 10)), s) for s in (0.0, 0.8, 3.0)]),
    "offset_image": ("filters", "offset_image", lambda r: [
        (_premul(r, (12, 10)), dx, dy) for dx, dy in
        ((0, 0), (3, -2), (-4, 5))]),
    "drop_shadow": ("filters", "drop_shadow", lambda r: [
        (_premul(r, (12, 10)), 2, 3, 1.5, (0.1, 0.2, 0.3, 0.8))]),
    "flood": ("filters", "flood", lambda r: [
        (_premul(r, (12, 10)), (0.9, 0.5, 0.1, 0.6))]),
    "apply_filter": ("filters", "apply_filter", lambda r: [
        (_premul(r, (12, 10)), k, (1.2, 2.0, -1.0, 0.3, 0.6, 0.9, 0.7))
        for k in range(5)]),
}

_PORT = {"blend": np_blend, "paint": np_paint, "blur": np_blur,
         "filters": np_filters}
_JAX = {"blend": jax_blend, "paint": jax_paint, "blur": jax_blur,
        "filters": jax_filters}


def _equal(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _equal(g, w, what)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_np_function_equals_jax_with_numpy(case):
    mod, fname, make = CASES[case]
    ours, ref = getattr(_PORT[mod], fname), getattr(_JAX[mod], fname)
    for i, args in enumerate(make(np.random.default_rng(7))):
        _equal(ours(np, *args), ref(np, *args), f"{case}[{i}]")


def test_boxes_for_gauss_equals_jax():
    for sigma in (0.0, 0.3, 1.0, 2.5, 7.0, 40.0):
        for n in (1, 3, 5):
            assert np_filters.boxes_for_gauss(sigma, n) == \
                jax_filters.boxes_for_gauss(sigma, n)
