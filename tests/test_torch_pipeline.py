"""The port's whole frame against the JAX package's, end to end.

``vello_tpu_torch.Renderer(device="cpu")`` (every kernel's plain PyTorch
version) against ``vello_tpu.models.renderer.Renderer`` running its fused
Pallas path in interpret mode, on the same scenes at 128x128, each built
and resolved through its own package. Bars: the same tier, retries and
live cap, and u8 images within 1 level per channel with at least 99% of
the bytes identical."""

import dataclasses
import importlib

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import Renderer as JaxRenderer
from vello_tpu.pipeline import render as jax_render
from vello_tpu_torch import Renderer, RenderParams, resolve

SIZE = 128
BASE = (0.1, 0.1, 0.1, 1.0)


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


def mmark(pkg):
    ts = importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")
    return ts.filled_mmark(1, float(SIZE))


# scene builders, each given the package to build through
SCENES = {"mmark": mmark, "edge_circle": edge_scene,
          "evenodd_star": evenodd_star}


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


def test_unported_features_raise():
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="msaa16")
    pkg = vello_tpu_torch
    scene = pkg.Scene()
    scene.push_clip_layer(pkg.Affine.identity(),
                          pkg.kurbo.circle_path(64, 64, 40))
    scene.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), pkg.palette.RED,
               None, pkg.kurbo.circle_path(64, 64, 30))
    scene.pop_layer()
    with pytest.raises(NotImplementedError, match="K7"):
        Renderer(device="cpu").render_u8(scene, params)
    speed = dataclasses.replace(params, render_mode="speed")
    with pytest.raises(NotImplementedError, match="speed"):
        Renderer(device="cpu").render_u8(mmark(pkg), speed)
