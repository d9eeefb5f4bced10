"""The port's layered compositor against the JAX package's, on the CPU:
the plan and the layer math (the whole frames are in
test_torch_layers_frames.py, the unrolled formulation in
test_torch_layers_unrolled.py; all three use this file's scenes).

- the layer plan (``build_layer_plan``) equal field by field;
- ``lookup_sorted`` / ``rank_sorted`` (int64 ``torch.searchsorted``)
  equal to the JAX package's sort merges;
- the blend (all 16 mixes x 14 composes, both masks) within atol 1e-6 of
  ``blend_mix_compose_dyn``, and the layer filters within atol 1e-5 of
  ``apply_filter_dyn``;
- K7's plain version (``composite_over_plain``, the exact sequential
  src-over, in place) within 2e-5 of the interpret-mode Pallas
  ``fine_composite_over`` and of ``fine_xla.composite_srcover_over`` (both
  transmittance products, about 2e-5 off exact), on the per-tile walk
  bounds the port's compositor uses.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vello_tpu
import vello_tpu_torch
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.ops import blend as jax_blend
from vello_tpu.ops import filters as jax_filters
from vello_tpu.ops import fine_xla
from vello_tpu.ops import segmented as jax_segmented
from vello_tpu.ops.pallas_kernels import FINE_CHUNK, NPX, fine_composite_over
from vello_tpu.pipeline import layered as jax_layered
from vello_tpu.pipeline import render as jax_render
from vello_tpu_torch import RenderParams, resolve
from vello_tpu_torch.ops import blend, filters, kernels, segmented
from vello_tpu_torch.pipeline import layered

SIZE = 128
BASE = (0.12, 0.12, 0.12, 1.0)


def _test_scenes(pkg):
    return importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")


def layered_mmark(pkg):
    """24 alpha 0.85 groups of blobs, mixes normal/multiply/screen."""
    return _test_scenes(pkg).layered_mmark(1, float(SIZE))


def clips(pkg):
    """Clips and group opacity over an opaque backdrop: a collapsed clip
    chain (two nested clips around one fill), a pushed clip (a clip layer
    around three draws), a pushed even-odd clip (two draws), nested groups
    with alpha and an opacity chain."""
    s, a, k = pkg.Scene(), pkg.Affine.identity(), pkg.kurbo
    nz = pkg.Fill.NON_ZERO
    s.fill(nz, a, pkg.Color(0.87, 0.79, 0.13, 1.0), None,
           k.rect_path(0, 0, SIZE, SIZE))
    s.push_clip_layer(a, k.circle_path(40, 40, 34))
    s.push_clip_layer(a, k.rect_path(10, 12, 62, 54))
    s.fill(nz, a, pkg.Color(0.2, 0.45, 0.8, 0.9), None,
           k.rect_path(0, 0, SIZE, SIZE))
    s.pop_layer()
    s.pop_layer()
    s.push_clip_layer(a, k.star_path(92, 38, 5, 14, 34))
    s.fill(nz, a, pkg.Color(0.7, 0.15, 0.3, 0.8), None,
           k.circle_path(82, 40, 20))
    s.fill(nz, a, pkg.Color(0.1, 0.6, 0.35, 0.7), None,
           k.circle_path(102, 48, 22))
    s.fill(nz, a, pkg.Gradient.linear(
        (60, 0), (128, 0), pkg.peniko.stops(pkg.palette.NAVY,
                                            pkg.palette.ORANGE)), None,
        k.rect_path(60, 30, 128, 40))
    s.pop_layer()
    s.push_clip_layer(a, k.star_path(64, 94, 7, 12, 31), pkg.Fill.EVEN_ODD)
    s.fill(nz, a, pkg.Color(0.33, 0.2, 0.66, 0.95), None,
           k.rect_path(16, 58, 112, 128))
    s.fill(nz, a, pkg.Color(0.93, 0.62, 0.27, 0.75), None,
           k.circle_path(64, 94, 14))
    s.pop_layer()
    # nested opacity: three groups with alpha and circle clips (the
    # innermost, around one fill, collapses into a chain), then a clipless
    # opacity chain around one fill (its alpha product alone)
    cols = [pkg.Color(0.87, 0.31, 0.13, 1.0), pkg.Color(0.2, 0.7, 0.4, 1.0),
            pkg.Color(0.3, 0.35, 0.9, 1.0)]
    for i, c in enumerate(cols):
        s.push_layer(pkg.Mix.NORMAL, 0.85 - 0.1 * i, a,
                     k.circle_path(40, 92, 30 - 8 * i))
        s.fill(nz, a, c, None, k.rect_path(0, 56, 80, 128))
    for _ in cols:
        s.pop_layer()
    s.push_layer(pkg.Mix.NORMAL, 0.6, a, None)
    s.fill(nz, a, pkg.Color(0.93, 0.83, 0.2, 1.0), None,
           k.star_path(100, 100, 5, 10, 26))
    s.pop_layer()
    return s


def masks(pkg):
    """A luminance mask and an alpha mask, each inside a group over an
    opaque backdrop, then an unbalanced push whose content is discarded."""
    s, a, k, p = pkg.Scene(), pkg.Affine.identity(), pkg.kurbo, pkg.palette
    nz = pkg.Fill.NON_ZERO
    st = pkg.peniko.stops
    s.fill(nz, a, pkg.Gradient.linear((0, 0), (SIZE, SIZE),
                                      st(p.RED, p.BLUE)), None,
           k.rect_path(0, 0, SIZE, SIZE))
    s.push_layer(pkg.Mix.NORMAL, 1.0, a, None)
    s.fill(nz, a, pkg.Color(0.91, 0.83, 0.18, 1.0), None,
           k.rect_path(4, 4, 76, 76))
    s.push_luminance_mask_layer(0.9, a, k.rect_path(0, 0, 80, 80))
    s.fill(nz, a, pkg.Gradient.radial((40, 40), 36, st(p.WHITE, p.BLACK)),
           None, k.circle_path(40, 40, 36))
    s.pop_layer()
    s.pop_layer()
    s.push_layer(pkg.Mix.NORMAL, 1.0, a, None)
    s.fill(nz, a, pkg.Color(0.13, 0.73, 0.58, 1.0), None,
           k.rect_path(52, 52, 124, 124))
    s.push_alpha_mask_layer(0.8, a, k.circle_path(88, 88, 34))
    s.fill(nz, a, pkg.Color(0.5, 0.5, 0.5, 0.6), None,
           k.star_path(88, 88, 6, 12, 40))
    s.pop_layer()
    s.pop_layer()
    s.push_layer(pkg.Mix.MULTIPLY, 0.9, a, None)
    s.fill(nz, a, p.LIME, None, k.circle_path(100, 24, 20))
    return s


def blend_grid(pkg):
    """All 16 mix modes, each a clip-rect layer over a gradient."""
    return _test_scenes(pkg).blend_grid(float(SIZE))


COMPOSES = ("CLEAR", "COPY", "DEST", "DEST_OVER", "SRC_IN", "DEST_IN",
            "SRC_OUT", "DEST_OUT", "SRC_ATOP", "DEST_ATOP", "XOR", "PLUS",
            "PLUS_LIGHTER", "SRC_OVER")


def compose_modes(pkg):
    """The 14 compose operators, each a clip-rect layer (alpha 0.9, mix
    normal, multiply, screen or difference) over a translucent disc."""
    s, k = pkg.Scene(), pkg.kurbo
    nz = pkg.Fill.NON_ZERO
    mixes = (pkg.Mix.NORMAL, pkg.Mix.MULTIPLY, pkg.Mix.SCREEN,
             pkg.Mix.DIFFERENCE)
    for i, name in enumerate(COMPOSES):
        t = pkg.Affine.translate(32 * (i % 4), 32 * (i // 4))
        s.fill(nz, t, pkg.Color(0.87, 0.31, 0.13, 0.8), None,
               k.circle_path(13, 13, 11))
        s.push_layer(pkg.BlendMode(mixes[i % 4], getattr(pkg.Compose, name)),
                     0.9, t, k.rect_path(1, 1, 31, 31))
        s.fill(nz, t, pkg.Color(0.2, 0.45, 0.83, 0.7), None,
               k.rect_path(9, 9, 29, 29))
        s.pop_layer()
    return s


def filters_scene(pkg):
    """Blur, drop shadow, offset and a clipped flood layer."""
    return _test_scenes(pkg).filter_suite(float(SIZE))


def dense_clips(pkg):
    """Ten clip chains around viewport-sized fills: the live estimate
    exceeds the fragment tier, so no live cap applies and the dump rows
    (some with a padded path index) stay in the sorted stream."""
    s, a, k = pkg.Scene(), pkg.Affine.identity(), pkg.kurbo
    for i in range(10):
        s.push_clip_layer(a, k.circle_path(64, 64, 20 + 3 * i))
        s.fill(pkg.Fill.NON_ZERO, a,
               pkg.Color(0.87, 0.011 * i + 0.02, 0.33, 0.35), None,
               k.rect_path(0, 0, SIZE, SIZE))
        s.pop_layer()
    return s


def luminance_masks(pkg):
    """A luminance mask over the whole frame: the result's alpha is the
    mask's, so it runs down to 0."""
    return _test_scenes(pkg).luminance_masks(float(SIZE))


SCENES = {"layered_mmark": layered_mmark, "clips": clips,
          "masks": masks, "blend_grid": blend_grid,
          "compose_modes": compose_modes, "filters": filters_scene,
          "dense_clips": dense_clips, "luminance_masks": luminance_masks}


def _clear_jax_caches():
    jax_render._JIT_CACHE.clear()
    jax_render._JIT_B_CACHE.clear()
    jax_layered._JIT_CACHE.clear()


@pytest.fixture(scope="module")
def jax_interpret():
    """Run the JAX Renderer on its Pallas kernels in interpret mode. Its
    jit caches key on the pipeline's statics alone, so they are cleared
    around the switch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELLO_TPU_PALLAS_INTERPRET", "1")
        _clear_jax_caches()
        yield
        _clear_jax_caches()


def resolve_both(name, params):
    jparams = vello_tpu.RenderParams(**dataclasses.asdict(params))
    ours = resolve(SCENES[name](vello_tpu_torch).encoding, params)
    ref = jax_resolve(SCENES[name](vello_tpu).encoding, jparams)
    return ours, ref, jparams


# ---------------------------------------------------------------------------
# the plan

@pytest.mark.parametrize("name", ["layered_mmark", "clips", "masks",
                                  "blend_grid", "compose_modes", "filters",
                                  "luminance_masks"])
def test_plan_matches_jax(name):
    params = RenderParams(SIZE, SIZE)
    ours, ref, _ = resolve_both(name, params)
    got = layered.build_layer_plan(ours)
    want = jax_layered.build_layer_plan(ref)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert got[3] == want[3]
    assert sorted(got[1]) == sorted(want[1])
    for key, w in want[1].items():
        w = np.asarray(w)
        assert isinstance(got[1][key], np.ndarray), key
        assert got[1][key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[1][key], w, err_msg=key)


def test_plan_shapes():
    """What each scene's plan holds: clip chains collapsed, pushes for the
    rest, and a discarding pop for the unbalanced push."""
    params = RenderParams(SIZE, SIZE)
    plans = {name: layered.build_layer_plan(resolve_both(name, params)[0])
             for name in ("layered_mmark", "clips", "masks")}
    st, dyn, key, _ = plans["layered_mmark"]
    kinds = [op[0] for op in st.ops]
    assert kinds.count(layered.OP_PUSH) == 24 == kinds.count(layered.OP_POP)
    assert layered.nonempty_draws(dyn) == 24 and st.max_depth == 1
    st, dyn, _, _ = plans["clips"]
    # two chains: the two nested clips, and the innermost opacity group;
    # pushes: the star clip, the even-odd clip, the two outer groups
    assert st.n_clip_levels == 2 and st.max_depth == 2
    assert [op[0] for op in st.ops].count(layered.OP_PUSH) == 4
    assert np.isclose(dyn["path_clipalpha"][:, -1].min(), 0.6)
    st, _, _, _ = plans["masks"]
    pops = [op for op in st.ops if op[0] == layered.OP_POP]
    assert [op[1] for op in pops] == [127, 0, 126, 0, -1]


# ---------------------------------------------------------------------------
# lookups, blend, filters

def test_lookup_and_rank_match_jax():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2 ** 29, 3000)).astype(np.int32)
    q = np.concatenate([keys[rng.integers(0, len(keys), 500)],
                        rng.integers(0, 2 ** 29, 500), [-1, -7, 0],
                        [keys[0], keys[-1], 2 ** 29]]).astype(np.int32)
    idx, found = segmented.lookup_sorted(torch.from_numpy(keys).long(),
                                         torch.from_numpy(q).long())
    jidx, jfound = jax_segmented.lookup_sorted(jnp.asarray(keys),
                                               jnp.asarray(q))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(idx.numpy()[found.numpy()],
                                  np.asarray(jidx)[found.numpy()])
    rank = segmented.rank_sorted(torch.from_numpy(keys).long(),
                                 torch.from_numpy(q).long())
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(jax_segmented.rank_sorted(
            jnp.asarray(keys), jnp.asarray(q))))


def _premul_pixels(rng, n):
    """Premultiplied RGBA rows: alphas 0, 1 and between; channels at 0
    and 1 exactly on some rows (the dodge/burn and hue branches)."""
    a = rng.uniform(0, 1, (n, 1))
    a[::17] = 0.0
    a[5::13] = 1.0
    rgb = rng.uniform(0, 1, (n, 3))
    rgb[3::11, 0] = 0.0
    rgb[7::19, 1] = 1.0
    rgb[9::23] = rgb[9::23, :1]                 # grey: no saturation
    return np.concatenate([rgb * a, a], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def blend_inputs():
    rng = np.random.default_rng(7)
    return _premul_pixels(rng, 2048), _premul_pixels(rng, 2048)


_jax_blend = jax.jit(jax_blend.blend_mix_compose_dyn)


@pytest.mark.parametrize("mix,compose",
                         [(m, c) for m in range(16) for c in range(14)]
                         + [("luminance_mask", None), ("alpha_mask", None)])
def test_blend_matches_jax(blend_inputs, mix, compose):
    bd, src = blend_inputs
    if compose is None:
        want = getattr(jax_blend, mix)(jnp, jnp.asarray(bd),
                                       jnp.asarray(src))
        got = getattr(blend, mix)(torch.from_numpy(bd),
                                  torch.from_numpy(src))
    else:
        want = _jax_blend(jnp.asarray(bd), jnp.asarray(src), mix, compose)
        got = blend.blend_mix_compose_dyn(torch.from_numpy(bd),
                                          torch.from_numpy(src), mix,
                                          compose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


_jax_filter = jax.jit(lambda img, kind, params: jax_filters.apply_filter_dyn(
    jnp, jax.lax, img, kind, params))

FILTER_CASES = [
    ("blur", (0.05, 0, 0)), ("blur", (0.8, 0, 0)), ("blur", (2.0, 0, 0)),
    ("blur", (5.5, 0, 0)), ("shadow", (1.5, 3, -2)),
    ("shadow", (0.0, -4, 5)), ("shadow", (3.0, 0, 0)),
    ("offset", (0.0, 5, -3)), ("offset", (0.0, -7, 0)),
    ("offset", (0.0, 0, 9)), ("flood", (0.0, 0, 0)), ("none", (0.0, 0, 0))]


@pytest.mark.parametrize("kind,params", FILTER_CASES)
def test_filter_matches_jax(kind, params):
    """The filters on a 48x80 image (not square: each axis is its own).
    Bar: atol 1e-5; the box blur differences two f32 cumsums along the
    rows, which torch and XLA-CPU may sum in other orders."""
    rng = np.random.default_rng(3)
    img = _premul_pixels(rng, 48 * 80).reshape(48, 80, 4)
    code = {"none": 0, "blur": 1, "shadow": 2, "offset": 3, "flood": 4}[kind]
    row = np.asarray(list(params) + [0.3, 0.6, 0.9, 0.7], np.float32)
    want = np.asarray(_jax_filter(jnp.asarray(img), code, jnp.asarray(row)))
    got = filters.apply_filter_dyn(torch.from_numpy(img), code, row)
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_blur_radii_match_jax():
    """The dynamic radii (wl >= 1, 0 at sigma <= 0.1) for many sigmas."""
    for sigma in np.linspace(0.0, 12.0, 241, dtype=np.float32):
        want = [int(r) for r in jax_filters._box_radii_dyn(
            jnp, jnp.float32(sigma))]
        assert filters._box_radii_dyn(sigma) == want, sigma


# ---------------------------------------------------------------------------
# K7's plain version

def test_composite_over_plain_matches_pallas_and_xla():
    """The layered draws op on the walk bounds of the port's compositor:
    per tile, the ranks of g*(P+1)+lo and g*(P+1)+hi in the (gtile,
    path)-sorted stream. Held to the interpret-mode Pallas walk (given the
    same bounds) and to the masked full-stream XLA composite within 2e-5;
    tiles with an empty walk keep their backdrop bit for bit, and the
    update is in place."""
    rng = np.random.default_rng(3)
    n_frag, n_gtiles, P = FINE_CHUNK * 2, 9, 40
    g = np.sort(rng.integers(0, n_gtiles - 1, n_frag)).astype(np.int32)
    path = rng.integers(0, P, n_frag).astype(np.int32)
    order = np.lexsort((path, g))
    g, path = g[order], path[order]
    cov = rng.uniform(0.0, 1.0, (n_frag, NPX)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (n_frag, 1)).astype(np.float32)
    col = np.concatenate([rng.uniform(0, 1, (n_frag, 3)) * a, a],
                         axis=1).astype(np.float32)
    src = (col[:, :, None] * cov[:, None, :]).astype(np.float32)
    bg = rng.uniform(0, 1, (n_gtiles, 4, NPX)).astype(np.float32)
    skey = torch.from_numpy(g.astype(np.int64) * (P + 1) + path)
    tile_key = torch.arange(n_gtiles, dtype=torch.int64) * (P + 1)
    for lo, hi in [(0, P), (10, 25), (39, 40)]:
        los = segmented.rank_sorted(skey, tile_key + lo)
        his = segmented.rank_sorted(skey, tile_key + hi)
        dst = torch.from_numpy(bg.copy())
        out = kernels.composite_over(torch.from_numpy(src), dst, los, his)
        assert out is dst and kernels.launches["composite_over"] == 0
        m = (path >= lo) & (path < hi)
        ref_xla = fine_xla.composite_srcover_over(
            jnp.asarray(np.where(m[:, None, None], src, 0.0)),
            jnp.asarray(np.where(m[:, None], src[:, 3, :], 0.0)),
            jnp.asarray(g), jnp.asarray(bg))
        refs = [ref_xla]
        if (lo, hi) == (10, 25):                 # interpret mode is slow
            refs.append(fine_composite_over(
                jnp.asarray(src), jnp.asarray(bg),
                (jnp.asarray(los.numpy()), jnp.asarray(his.numpy())),
                n_gtiles, interpret=True))
        for ref in refs:
            np.testing.assert_allclose(dst.numpy(), np.asarray(ref), rtol=0,
                                       atol=2e-5)
        empty = (his <= los).numpy()
        assert empty[-1]                 # the last tile has no fragments
        np.testing.assert_array_equal(dst.numpy()[empty], bg[empty])
        assert (~empty).any()


def test_composite_over_from_zero_equals_src_composite():
    """From a transparent buffer the draws op is K6's walk onto a zero
    base color: the same arithmetic, bit for bit."""
    rng = np.random.default_rng(8)
    f, n_gtiles = 300, 11
    bounds = np.sort(rng.integers(0, f + 1, n_gtiles + 1)).astype(np.int32)
    a = rng.uniform(size=(f, 1, NPX))
    src = torch.from_numpy(np.concatenate(
        [rng.uniform(size=(f, 3, NPX)) * a, a], axis=1).astype(np.float32))
    los = torch.from_numpy(bounds[:-1].copy())
    his = torch.from_numpy(bounds[1:].copy())
    got = kernels.composite_over(src, torch.zeros(n_gtiles, 4, NPX), los,
                                 his)
    assert torch.equal(got, kernels.composite_src(src, torch.zeros(4), los,
                                                  his))
