"""render_mode="speed" on the port against the JAX package's ``lowp``
flow, on the CPU.

The JAX package rounds the fine tensors to bf16 in speed mode
(``vello_tpu/pipeline/render.py`` ``prepare_fragments``): solid colors,
and on the other paths the src rows, formed from the bf16 coverage; the
coverage that reaches the occlusion walk and the solid composite stays
f32. Its Pallas composites widen what they read to f32. Held here:

- the composites' plain versions on bf16 inputs (K4 on bf16-rounded
  colors, K6 and K7 on bf16 src) within 2e-5 of the interpret-mode Pallas
  kernels on the same inputs;
- the speed fragment tensors, dtypes and values, against the JAX
  package's ``prepare_fragments`` under ``lowp``, with the clip-chain
  switch of the layered path back to f32 src and the 0.999-alpha solid
  that occludes once rounded;
- whole speed frames of the six chip paths' scenes at 128x128 against
  quality at the JAX package's bar (``tests/test_pipeline.py``
  ``test_render_mode_speed_lowp``: max 2.5/255, mean < 1e-3), and against
  the JAX package's speed frames within 1 u8 level, at least 99.99% of the
  bytes identical (measured: 99.995-100%). The base is 0.12, off the u8
  half level 25.5 (see test_torch_area.py).
"""

import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vello_tpu
import vello_tpu_torch
from test_torch_layers_plan import jax_interpret  # noqa: F401
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import Renderer as JaxRenderer
from vello_tpu.models.renderer import pack_buffers as jax_pack_buffers
from vello_tpu.ops.pallas_kernels import (FINE_CHUNK, NPX,
                                          fine_composite_over,
                                          fine_composite_solid,
                                          fine_composite_solid_cov)
from vello_tpu.pipeline import layered as jax_layered
from vello_tpu.pipeline import render as jax_render
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.ops import fine, kernels
from vello_tpu_torch.pipeline import layered
from vello_tpu_torch.pipeline import render

SIZE = 128
BASE = (0.12, 0.12, 0.12, 1.0)


def _ts(pkg):
    return importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")


def clip_chain(pkg):
    """A clip layer around one fill: a collapsed clip chain, whose clip
    coverage multiplies the src back to f32."""
    scene = pkg.Scene()
    scene.push_clip_layer(pkg.Affine.identity(),
                          pkg.kurbo.circle_path(64, 64, 40))
    scene.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), pkg.palette.RED,
               None, pkg.kurbo.circle_path(64, 64, 30))
    scene.pop_layer()
    return scene


def occluder(pkg):
    """A solid of alpha 0.999 over a disc: bf16 rounds its alpha to 1.0,
    so in speed mode it covers the tiles it fills and the walk skips the
    disc below it."""
    scene = pkg.Scene()
    a = pkg.Affine.identity()
    scene.fill(pkg.Fill.NON_ZERO, a, pkg.Color(0.87, 0.79, 0.13, 1.0),
               None, pkg.kurbo.circle_path(64, 64, 50))
    scene.fill(pkg.Fill.NON_ZERO, a, pkg.Color(0.2, 0.45, 0.8, 0.999),
               None, pkg.kurbo.rect_path(16, 16, 112, 112))
    return scene


# the six chip paths' scenes (chip_smoke.py PATHS) and the two above:
# name -> (builder given the package, antialiasing, unrolled layers)
SCENES = {
    "msaa16": (lambda p: _ts(p).filled_mmark(1, float(SIZE)), "msaa16",
               False),
    "area": (lambda p: _ts(p).filled_mmark(1, float(SIZE)), "area", False),
    "gradient_image": (lambda p: _ts(p).mixed_paint_mmark(1, float(SIZE)),
                       "msaa16", False),
    "stroked": (lambda p: _ts(p).mmark(1, float(SIZE)), "msaa16", False),
    "layered": (lambda p: _ts(p).layered_mmark(1, float(SIZE)), "msaa16",
                False),
    "layered_unrolled": (lambda p: _ts(p).blend_grid(float(SIZE)), "msaa16",
                         True),
    "clip_chain": (clip_chain, "msaa16", False),
    "occluder": (occluder, "area", False),
}


def _params(name, mode="speed"):
    return RenderParams(SIZE, SIZE, base_color=BASE,
                        antialiasing=SCENES[name][1], render_mode=mode)


@pytest.fixture
def formulation(monkeypatch):
    """Select the scene's layered formulation in both packages."""
    def select(name):
        if SCENES[name][2]:
            monkeypatch.setenv("VELLO_TPU_UNROLLED_LAYERS", "1")
        else:
            monkeypatch.delenv("VELLO_TPU_UNROLLED_LAYERS", raising=False)
    return select


# ---------------------------------------------------------------------------
# the composites on bf16 inputs

def _walks(rng, f, g):
    bounds = np.sort(rng.integers(0, f + 1, g + 1)).astype(np.int32)
    return bounds[:-1].copy(), bounds[1:].copy()


def _bf16_src(rng, f):
    """(F, 4, 256) premultiplied src rows rounded to bf16, a fifth of them
    opaque, as torch bf16 and as the same bits in jnp bf16."""
    a = rng.uniform(size=(f, 1, NPX))
    a[rng.uniform(size=f) < 0.2] = 1.0
    src = torch.from_numpy(np.concatenate(
        [rng.uniform(size=(f, 3, NPX)) * a, a], axis=1).astype(np.float32))
    src = src.to(torch.bfloat16)
    return src, jnp.asarray(src.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("kernel", ["composite_solid", "composite_src",
                                    "composite_over"])
def test_plain_composites_on_bf16_match_pallas(kernel):
    """K4 on bf16-rounded colors (the port widens them to f32 before K4,
    the Pallas kernel widens the bf16 colors it reads), K6 and K7 on bf16
    src: the plain versions within 2e-5 of the interpret-mode Pallas
    kernels on the same bf16 values."""
    rng = np.random.default_rng(9)
    f, g = FINE_CHUNK * 3, 37
    los, his = _walks(rng, f, g)
    tl, th = torch.from_numpy(los), torch.from_numpy(his)
    jwalk = (jnp.asarray(los), jnp.asarray(his))
    base = np.array([0.05, 0.1, 0.2, 1.0], np.float32)
    if kernel == "composite_solid":
        cov = rng.uniform(size=(f, NPX)).astype(np.float32)
        a = rng.uniform(size=(f, 1))
        a[rng.uniform(size=f) < 0.3] = 0.999          # rounds to 1.0
        col = torch.from_numpy(np.concatenate(
            [rng.uniform(size=(f, 3)) * a, a], axis=1).astype(np.float32))
        col16 = col.to(torch.bfloat16)
        assert (col16[:, 3] == 1.0).any()
        got = kernels.composite_solid(torch.from_numpy(cov), col16.float(),
                                      torch.from_numpy(base), tl, th)
        want = fine_composite_solid_cov(
            jnp.asarray(cov), jnp.asarray(col16.float().numpy()).astype(
                jnp.bfloat16), jnp.asarray(base), jwalk, g, interpret=True)
    elif kernel == "composite_src":
        src, jsrc = _bf16_src(rng, f)
        got = kernels.composite_src(src, torch.from_numpy(base), tl, th)
        want = fine_composite_solid(jsrc, jnp.asarray(base), jwalk, g,
                                    interpret=True)
        # the plain version widens each row: the same as on f32 rows
        torch.testing.assert_close(
            got, fine.composite_src_plain(src.float(), torch.from_numpy(base),
                                          tl, th), rtol=0, atol=0)
    else:
        src, jsrc = _bf16_src(rng, f)
        his[::5] = los[::5]                         # some empty walks
        th = torch.from_numpy(his)
        jwalk = (jnp.asarray(los), jnp.asarray(his))
        buf = rng.uniform(size=(g, 4, NPX)).astype(np.float32)
        got = kernels.composite_over(src, torch.from_numpy(buf.copy()), tl,
                                     th)
        want = fine_composite_over(jsrc, jnp.asarray(buf), jwalk, g,
                                   interpret=True)
        np.testing.assert_array_equal(got[::5].numpy(), buf[::5])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_composite_wrappers_take_f32_or_bf16_src():
    """K6 and K7 take f32 or bf16 src and raise on any other dtype."""
    src = torch.zeros((4, 4, NPX), dtype=torch.float16)
    walk = torch.zeros(2, dtype=torch.int32)
    base = torch.zeros(4)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.composite_src(src, base, walk, walk)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.composite_over(src, torch.zeros((2, 4, NPX)), walk, walk)


# ---------------------------------------------------------------------------
# the fragment tensors

def _capture(monkeypatch, module):
    """Wrap ``module.prepare_fragments`` to keep its arguments and
    output."""
    got = {}
    original = module.prepare_fragments

    def spy(bufs, static, *args, **kwargs):
        out = original(bufs, static, *args, **kwargs)
        got.update(bufs=bufs, static=static, kwargs=kwargs, out=dict(out))
        return out
    monkeypatch.setattr(module, "prepare_fragments", spy)
    return got


def _port_and_jax_fragments(monkeypatch, name):
    """Render the scene's speed frame on the port, capturing its
    fragments, then run the JAX package's prepare_fragments under lowp on
    the JAX package's buffers of the same scene (same statics)."""
    params = _params(name)
    layered_path = name in ("layered", "clip_chain")
    got = _capture(monkeypatch, layered if layered_path else render)
    ours = resolve(SCENES[name][0](vello_tpu_torch).encoding, params)
    Renderer(device="cpu").render_resolved(ours, params)
    static = got["static"]
    assert static.lowp
    jparams = vello_tpu.RenderParams(**dataclasses.asdict(params))
    ref = jax_resolve(SCENES[name][0](vello_tpu).encoding, jparams)
    paint8 = "col_s" in got["out"]
    jbufs = {k: jnp.asarray(np.asarray(v)) for k, v in jax_pack_buffers(
        ref, ref.capacities(jparams), jparams, slim=True,
        paint8=paint8).items()}
    jstatic = jax_render.PipelineStatic(**{
        k: v for k, v in dataclasses.asdict(static).items()
        if k != "fused_geom"})
    fa = jax.jit(partial(jax_render.prepare_fragments, static=jstatic,
                         keep_clip_paths=layered_path))
    want = dict(fa(jbufs))
    n_loc = static.width_tiles * static.height_tiles
    live = got["out"]["g_s"].numpy() < n_loc
    np.testing.assert_array_equal(got["out"]["g_s"].numpy(),
                                  np.asarray(want["g_s"]))
    np.testing.assert_array_equal(got["out"]["tpath_s"].numpy()[live],
                                  np.asarray(want["tpath_s"])[live])
    return got, want, live, ref


def _assert_bf16_close(ours, ref, share=0.999):
    """bf16 values equal but for a rounding flip on a last-place
    difference of the f32 values before the cast (the paint evaluation
    is within 1e-5 of the JAX package's, not equal): one bf16 ulp at
    most, and at least ``share`` of the values identical."""
    a = ours.float().numpy()
    b = np.asarray(ref.astype(jnp.float32))
    ulp = 2.0 ** -8 * np.maximum(np.abs(a), np.abs(b))
    assert (np.abs(a - b) <= ulp + 1e-30).all()
    assert (a == b).mean() >= share


@pytest.mark.parametrize("name", ["msaa16", "area", "gradient_image"])
def test_speed_fragments_match_jax(jax_interpret, monkeypatch, name):
    """The solid path: coverage f32 (msaa: exact k/16, equal; area:
    within 2e-5 of the JAX package's, whose running cumsum carries about
    an ulp of the running sum, measured 1.5e-5 on this frame), colors
    rounded to bf16 and widened to the f32 values the JAX package's K4
    computes with. The paint path: src rows in bf16, equal but for
    rounding flips (``_assert_bf16_close``)."""
    got, want, live, _ = _port_and_jax_fragments(monkeypatch, name)
    out = got["out"]
    assert out["coverage_s"].dtype == torch.float32
    assert want["coverage_s"].dtype == (jnp.float32 if name == "area"
                                        else jnp.bfloat16)
    np.testing.assert_allclose(
        out["coverage_s"].numpy()[live],
        np.asarray(want["coverage_s"].astype(jnp.float32))[live], rtol=0,
        atol=2e-5 if name == "area" else 0.0)
    if name == "gradient_image":
        assert out["src_s"].dtype == torch.bfloat16
        assert want["src_s"].dtype == jnp.bfloat16
        _assert_bf16_close(out["src_s"][live],
                           want["src_s"][np.flatnonzero(live)])
        np.testing.assert_array_equal(out["opaque_s"].numpy()[live],
                                      np.asarray(want["opaque_s"])[live])
        return
    assert out["col_s"].dtype == torch.float32
    assert want["col_s"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        out["col_s"].numpy()[live],
        np.asarray(want["col_s"].astype(jnp.float32))[live])
    np.testing.assert_array_equal(
        out["opaque_s"].numpy()[live],
        np.asarray(want["col_s"][:, 3] >= 1.0 - 1e-6)[live])


def test_solid_of_alpha_0999_occludes_in_speed_mode(jax_interpret,
                                                    monkeypatch):
    """0.999 rounds to 1.0 in bf16: the speed frame takes the solid as
    opaque, as the JAX package does, so the walks of the tiles it covers
    start at it; in quality mode it is not opaque."""
    got, want, live, _ = _port_and_jax_fragments(monkeypatch, "occluder")
    out = got["out"]
    top = out["tpath_s"] == 1
    assert (out["col_s"][top, 3] == 1.0).all()
    assert out["opaque_s"][top].all()
    assert np.asarray(want["col_s"][:, 3] >= 1.0 - 1e-6)[
        top.numpy() & live].all()
    n_loc = (SIZE // 16) ** 2
    q = torch.arange(n_loc + 1, dtype=out["g_s"].dtype)
    starts = torch.searchsorted(out["g_s"], q, side="left", out_int32=True)
    los, _ = render.occlusion_los(out["g_s"], out["coverage_s"],
                                  out["opaque_s"], n_loc, starts)
    assert int((los > starts[:-1]).sum()) >= 25       # 6x6 covered tiles
    quality = _capture(monkeypatch, render)
    rs = resolve(occluder(vello_tpu_torch).encoding, _params("occluder",
                                                             "quality"))
    Renderer(device="cpu").render_resolved(rs, _params("occluder",
                                                       "quality"))
    assert not quality["out"]["opaque_s"][quality["out"]["tpath_s"]
                                          == 1].any()


@pytest.mark.parametrize("name,src_dtype", [("layered", torch.bfloat16),
                                            ("clip_chain", torch.float32)])
def test_layered_src_dtype_follows_clip_chains(jax_interpret, monkeypatch,
                                               name, src_dtype):
    """Without clip chains the bf16 src rows reach K7; a collapsed clip
    chain multiplies them by its f32 clip coverage, and f32 src rows
    (holding bf16-rounded products) reach K7, as in the JAX package's
    ``_apply_clip_chains``."""
    seen = []
    original = kernels.composite_over

    def spy(src, *args):
        seen.append(src)
        return original(src, *args)
    monkeypatch.setattr(kernels, "composite_over", spy)
    got, want, live, ref = _port_and_jax_fragments(monkeypatch, name)
    plan_static, plan_dyn, key, _ = jax_layered.build_layer_plan(ref)
    assert bool(key.n_clip_levels) == (name == "clip_chain")
    if key.n_clip_levels:
        jax_layered._apply_clip_chains(
            want, {k: jnp.asarray(v) for k, v in plan_dyn.items()},
            key.n_clip_levels)
    assert seen and all(s.dtype == src_dtype for s in seen)
    assert want["src_s"].dtype == (jnp.bfloat16 if src_dtype
                                   == torch.bfloat16 else jnp.float32)
    ours = seen[0][live]
    ref_src = want["src_s"][np.flatnonzero(live)]
    if src_dtype == torch.bfloat16:
        _assert_bf16_close(ours, ref_src)
    else:
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(ref_src), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# whole frames

def _spy_composites(monkeypatch):
    """The src dtypes each composite wrapper was given."""
    calls = {"composite_solid": [], "composite_src": [],
             "composite_over": []}

    def spy(wrapper):
        original = getattr(kernels, wrapper)

        def wrapped(*args):
            calls[wrapper].append(args[1].dtype if wrapper
                                  == "composite_solid" else args[0].dtype)
            return original(*args)
        monkeypatch.setattr(kernels, wrapper, wrapped)

    for name in calls:
        spy(name)
    return calls


@pytest.mark.parametrize("name", ["msaa16", "area", "gradient_image",
                                  "stroked", "layered", "layered_unrolled",
                                  "clip_chain"])
def test_speed_frame(jax_interpret, monkeypatch, formulation, name):
    formulation(name)
    calls = _spy_composites(monkeypatch)
    build = SCENES[name][0]
    port = Renderer(device="cpu")
    quality = port.render(build(vello_tpu_torch), _params(name, "quality"))
    speed = port.render(build(vello_tpu_torch), _params(name))
    d = np.abs(quality - speed)
    assert d.max() <= 2.5 / 255.0 and d.mean() < 1e-3, (d.max(), d.mean())
    got = port.render_u8(build(vello_tpu_torch), _params(name))
    prof = port.last_profile
    jparams = vello_tpu.RenderParams(**dataclasses.asdict(_params(name)))
    ref_r = JaxRenderer()
    want = ref_r.render_u8(build(vello_tpu), jparams)
    for k in ("tier", "retries", "n_live", "layered"):
        assert prof[k] == ref_r.last_profile[k], k
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    assert got[..., 3].min() == 255
    # the speed frames' composites and the src dtype each was given
    # (three frames: quality, speed, speed u8)
    n = len(calls["composite_over"]) // 3
    if name in ("layered", "layered_unrolled", "clip_chain"):
        assert n > 0
        # blend_grid's cells collapse to clip chains too
        want_dt = (torch.bfloat16 if name == "layered" else torch.float32)
        assert calls["composite_over"] == ([torch.float32] * n
                                           + [want_dt] * (2 * n))
    elif name == "gradient_image":
        assert calls["composite_src"] == [torch.float32] + [torch.bfloat16] * 2
    else:
        assert calls["composite_solid"] == [torch.float32] * 3
