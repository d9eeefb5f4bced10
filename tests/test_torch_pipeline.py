"""The port's whole frame against the JAX package's, end to end.

``vello_tpu_torch.Renderer(device="cpu")`` (every kernel's plain PyTorch
version) against ``vello_tpu.models.renderer.Renderer`` running its fused
Pallas path in interpret mode, on the same scenes at 128x128, each built
and resolved through its own package. Bars: the same tier, retries and
live cap, and u8 images within 1 level per channel with at least 99% of
the bytes identical."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vello_tpu
import vello_tpu_torch
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import Renderer as JaxRenderer
from vello_tpu.pipeline import render as jax_render
from vello_tpu_torch import Renderer, RenderParams, resolve

SIZE = 128
BASE = (0.1, 0.1, 0.1, 1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch in one thread for the module: the suite runs in several
    pytest-xdist workers on the same cores, where torch's pool threads
    would spin between ops and take cores from the other workers (and
    from this worker's own host code). The port's other CPU test modules
    import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edge_scene(pkg):
    scene = pkg.Scene()
    scene.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), pkg.palette.RED,
               None, pkg.kurbo.circle_path(40, 40, 30))
    scene.fill(pkg.Fill.EVEN_ODD, pkg.Affine.translate(20, 60),
               pkg.palette.BLUE, None, pkg.kurbo.star_path(30, 30, 5, 25, 10))
    scene.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), pkg.palette.GREEN,
               None, pkg.kurbo.circle_path(-20, 64, 30))
    return scene


def evenodd_star(pkg):
    """Even-odd star (a hole in its middle) over an opaque nonzero disc,
    so the occlusion walk and both fill rules run. The colors keep every
    flat region's u8 value away from a half level, where the JAX
    package's log/exp composite (within 2e-5 of exact) would flip whole
    regions by one level."""
    scene = pkg.Scene()
    scene.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(),
               pkg.Color(0.87, 0.79, 0.13, 1.0), None,
               pkg.kurbo.circle_path(64, 64, 60))
    scene.fill(pkg.Fill.EVEN_ODD, pkg.Affine.identity(),
               pkg.Color(0.12, 0.3, 0.9, 0.85), None,
               pkg.kurbo.star_path(64, 64, 7, 58, 20))
    return scene


def _test_scenes(pkg):
    return importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")


def mmark(pkg):
    return _test_scenes(pkg).filled_mmark(1, float(SIZE))


def mixed_paint(pkg):
    """80% solid, 15% linear/radial/sweep gradient, 5% bilinear image."""
    return _test_scenes(pkg).mixed_paint_mmark(1, float(SIZE))


def gradient_suite(pkg):
    return _test_scenes(pkg).gradient_suite(float(SIZE))


def stroked_mmark(pkg):
    """The reference's mmark shape, drawn with device stroke expansion."""
    return _test_scenes(pkg).mmark(1, float(SIZE))


def stroked_mmark_rotated(pkg):
    """stroked_mmark turned by 0.3 rad about the center, so that no stroke
    edge is exactly vertical (see test_stroked_area_frame_near_jax)."""
    c, s_ = np.cos(0.3), np.sin(0.3)
    h = SIZE / 2
    scene = pkg.Scene()
    scene.append(stroked_mmark(pkg),
                 pkg.Affine((c, s_, -s_, c, h - h * c + h * s_,
                             h - h * s_ - h * c)))
    return scene


def image_texture():
    """A 4x4 RGBA texture with two translucent texels."""
    tex = np.random.default_rng(11).integers(0, 256, (4, 4, 4))
    tex[..., 3] = 255
    tex[1, 2, 3] = tex[3, 0, 3] = 160
    return tex.astype(np.uint8)


def image_quality(pkg):
    """Nearest (REPEAT), bilinear (REFLECT) and bicubic (PAD) image fills
    at a brush scale of 5.25. The brush offsets keep every pixel center at
    least 0.05 px from a nearest-sampling texel boundary and from the
    REPEAT wrap, where a one-ulp difference between backends would pick
    another texel."""
    s = pkg.Scene()
    q, e = pkg.peniko.ImageQuality, pkg.Extend
    for i, (qual, ext) in enumerate([(q.LOW, e.REPEAT), (q.MEDIUM, e.REFLECT),
                                     (q.HIGH, e.PAD)]):
        img = pkg.Image(image_texture(), ext, ext, qual, alpha=0.9)
        brush = pkg.Affine((5.25, 0.0, 0.0, 5.25, 10.1 + 42 * i, 6.8))
        s.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), img, brush,
               pkg.kurbo.rect_path(2 + 42 * i, 4, 40 + 42 * i, 124))
    return s


def blurred_rects(pkg):
    """A blurred rounded rect and an inset (inverse) one over a solid
    disc."""
    s = pkg.Scene()
    s.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(),
           pkg.Color(0.87, 0.79, 0.13, 1.0), None,
           pkg.kurbo.circle_path(64, 64, 40))
    s.draw_blurred_rounded_rect(pkg.Affine.identity(),
                                pkg.Rect(16, 20, 80, 70),
                                pkg.Color(0.2, 0.6, 0.9, 0.8), 8.0, 5.0)
    s.draw_blurred_rounded_rect(pkg.Affine.translate(50, 56),
                                pkg.Rect(0, 0, 60, 50),
                                pkg.Color(0.7, 0.2, 0.3, 0.9), 4.0, 3.0,
                                inverse=True)
    return s


# scene builders, each given the package to build through
SCENES = {"mmark": mmark, "edge_circle": edge_scene,
          "evenodd_star": evenodd_star, "mixed_paint": mixed_paint,
          "gradient_suite": gradient_suite, "image_quality": image_quality,
          "blurred_rects": blurred_rects, "stroked_mmark": stroked_mmark,
          "stroked_mmark_rotated": stroked_mmark_rotated}
# scenes with non-solid paints (the src composite, K6) and with device
# strokes (K1's stroke rows)
PAINT_SCENES = ("mixed_paint", "gradient_suite", "image_quality",
                "blurred_rects")
STROKE_SCENES = ("stroked_mmark", "stroked_mmark_rotated")


@pytest.fixture(scope="module")
def jax_interpret():
    """Run the JAX Renderer on its Pallas kernels in interpret mode. Its
    jit caches key on PipelineStatic alone, so they are cleared around
    the switch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELLO_TPU_PALLAS_INTERPRET", "1")
        jax_render._JIT_CACHE.clear()
        jax_render._JIT_B_CACHE.clear()
        yield
        jax_render._JIT_CACHE.clear()
        jax_render._JIT_B_CACHE.clear()


def resolve_both(name, params, shrink=None):
    """The scene built and resolved through each package, with the
    estimates in ``shrink`` scaled (floats) or replaced on both:
    (port ResolvedScene, JAX ResolvedScene, JAX RenderParams)."""
    jparams = vello_tpu.RenderParams(**dataclasses.asdict(params))
    ours = resolve(SCENES[name](vello_tpu_torch).encoding, params)
    ref = jax_resolve(SCENES[name](vello_tpu).encoding, jparams)
    if shrink:
        change = {k: (int(getattr(ref, k) * v) if isinstance(v, float)
                      else v) for k, v in shrink.items()}
        ours = dataclasses.replace(ours, **change)
        ref = dataclasses.replace(ref, **change)
    return ours, ref, jparams


def compare_frames(name, params, shrink=None):
    """Render through both packages and hold the port to the bars above;
    returns the port's image and profile."""
    ours, ref, jparams = resolve_both(name, params, shrink)
    port = Renderer(device="cpu")
    got = port.render_resolved(ours, params, out="rgba8")
    ref_r = JaxRenderer()
    want = ref_r.render_resolved(ref, jparams, out="rgba8")
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99
    for k in ("tier", "retries", "n_live"):
        assert port.last_profile[k] == ref_r.last_profile[k], k
    return got, port.last_profile


@pytest.mark.parametrize("name,aa", [("mmark", "msaa16"),
                                     ("edge_circle", "msaa16"),
                                     ("evenodd_star", "msaa16"),
                                     ("mmark", "msaa8")])
def test_frame_matches_jax(jax_interpret, name, aa):
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    img, prof = compare_frames(name, params)
    assert prof["retries"] == 0
    assert img[..., 3].min() == 255          # opaque base everywhere
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8


def spy_composites(monkeypatch):
    """Count the composite wrappers' calls and the K1 calls given stroke
    rows (a 21-column segment pack)."""
    from vello_tpu_torch.ops import kernels
    calls = {"composite_src": 0, "composite_solid": 0, "stroke_rows": 0}

    def spy(wrapper):
        original = getattr(kernels, wrapper)

        def wrapped(*args, **kwargs):
            calls[wrapper] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(kernels, wrapper, wrapped)

    spy("composite_src")
    spy("composite_solid")
    flatten_lines = kernels.flatten_lines

    def flatten_spy(spack, *args):
        calls["stroke_rows"] += spack.shape[1] == 21
        return flatten_lines(spack, *args)
    monkeypatch.setattr(kernels, "flatten_lines", flatten_spy)
    return calls


# the axis-aligned stroked_mmark in area AA: test_stroked_area_frame_near_jax
PAINT_AND_STROKE_CASES = [
    (name, aa) for name in PAINT_SCENES + STROKE_SCENES
    for aa in ("msaa16", "area") if (name, aa) != ("stroked_mmark", "area")]


@pytest.mark.parametrize("name,aa", PAINT_AND_STROKE_CASES)
def test_paint_and_stroke_frames_match_jax(jax_interpret, monkeypatch, name,
                                           aa):
    """Non-solid paints go through eval_paints and the src composite (K6);
    device strokes through K1's stroke rows and the solid composite (K4).
    The base is 0.12, off the u8 half level 25.5 (see test_torch_area.py).
    In area AA both frames take the two fused multiply-adds that XLA-CPU
    contracts in the area formula (``fine.coverage_delta``)."""
    calls = spy_composites(monkeypatch)

    params = RenderParams(SIZE, SIZE, base_color=(0.12, 0.12, 0.12, 1.0),
                          antialiasing=aa)
    img, prof = compare_frames(name, params)
    assert prof["retries"] == 0
    assert img[..., 3].min() == 255
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8
    stroked = name in STROKE_SCENES
    assert calls == {"composite_src": int(not stroked),
                     "composite_solid": int(stroked),
                     "stroke_rows": int(stroked)}


def test_stroked_area_frame_near_jax(jax_interpret, monkeypatch):
    """stroked_mmark in area AA, the one frame held to looser bars.

    Its strokes are axis-aligned, so many touches are exactly vertical,
    where the area term divides by xmax - xmin = 1e-6 and a one-ulp change
    of an input moves a pixel's coverage by up to ~0.1. The bevel triangle
    of a straight continuation also takes its side from the sign of a dot
    product that is 0 in exact arithmetic. The JAX package's interpret-mode
    geometry kernels contract multiply-adds (XLA-CPU), the port's round
    every op, so their touches differ by ulps there (the area formula takes
    the same two fused multiply-adds in both). Measured: 9 pixels of 16384
    differ, 1 of them by two levels. stroked_mmark_rotated, with no
    vertical edge, meets the full bars in area AA."""
    calls = spy_composites(monkeypatch)
    params = RenderParams(SIZE, SIZE, base_color=(0.12, 0.12, 0.12, 1.0),
                          antialiasing="area")
    ours, ref, jparams = resolve_both("stroked_mmark", params)
    port = Renderer(device="cpu")
    got = port.render_resolved(ours, params, out="rgba8")
    ref_r = JaxRenderer()
    want = ref_r.render_resolved(ref, jparams, out="rgba8")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    assert diff.max() <= 2
    assert (diff > 1).sum() <= 4
    assert (diff == 0).mean() >= 0.99
    for k in ("tier", "retries", "n_live"):
        assert port.last_profile[k] == ref_r.last_profile[k], k
    assert port.last_profile["retries"] == 0
    assert calls == {"composite_src": 0, "composite_solid": 1,
                     "stroke_rows": 1}


@pytest.mark.parametrize("name,shrink", [("mmark", {"est_touches": 0.5}),
                                         ("edge_circle",
                                          {"has_left_edge": False})])
def test_retry_matches_jax(jax_interpret, name, shrink):
    """A deliberately small touch tier (overflow bit 4) and a wrong
    has_left_edge hint (bit 32) both retry once and still match."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="msaa16")
    _, prof = compare_frames(name, params, shrink)
    assert prof["retries"] == 1
    # the retried frame equals the one rendered at the host's own tier
    full, _, _ = resolve_both(name, params)
    small, _, _ = resolve_both(name, params, shrink)
    np.testing.assert_array_equal(
        Renderer(device="cpu").render_resolved(small, params, out="rgba8"),
        Renderer(device="cpu").render_resolved(full, params, out="rgba8"))


def test_render_and_frame_thunk():
    """render() gives premultiplied f32 consistent with render_u8, and the
    frame thunk re-runs the last frame over its cached buffers."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="msaa16")
    scene = SCENES["evenodd_star"](vello_tpu_torch)
    r = Renderer(device="cpu")
    f32 = r.render(scene, params)
    assert f32.dtype == np.float32 and f32.shape == (SIZE, SIZE, 4)
    assert (f32[..., :3] <= f32[..., 3:] + 1e-7).all()
    u8 = r.render_u8(scene, params)
    img, overflow = r.frame_thunk()()
    assert int(overflow) == 0
    np.testing.assert_array_equal(img.numpy(), u8)
    from vello_tpu_torch.utils.png import to_rgba8
    assert np.abs(to_rgba8(f32).astype(int) - u8.astype(int)).max() <= 1
