"""The unfused geometry path (``VELLO_TPU_NO_FUSED_GEOM``) of the port
against the JAX package's, on the CPU.

Stage by stage, each stage given the JAX package's input so that the
comparison sees that stage alone: ``pathtag.pathtag_scan`` and
``decode_and_transform`` on the packed tag and point streams,
``flatten.flatten`` on the decoded slots, and ``tiling.make_touches`` (K2,
here its plain version) on the line soup with the edge region first and
real, against the JAX package's interpret-mode Pallas expansion. Integers
exactly equal, coordinates within rtol 2e-6 / atol 1e-5 (the FMA bar of
``tests/test_fused_touches.py``: XLA-CPU contracts multiply-adds, the port
rounds every op). ``make_touches`` is also held to the JAX package's XLA
expansion by the live-touch multiset (``tests/test_fused_touches.py``).

Then whole frames at 128x128 in area and msaa16, fills and strokes, with
the variable set on both sides, against the JAX Renderer with its Pallas
kernels in interpret mode: the bars of test_torch_pipeline.py (the same
tier, retries and live cap, u8 within 1 level, 99% of the bytes
identical), K1 not launched, K2 once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vello_tpu_torch
from test_torch_layers_plan import _clear_jax_caches
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import jax_interpret  # noqa: F401
from test_torch_pipeline import SCENES, compare_frames, resolve_both
from vello_tpu.encoding.config import TILE_H, TILE_W
from vello_tpu.models.renderer import pack_buffers as jax_pack_buffers
from vello_tpu.ops import flatten as jax_flatten
from vello_tpu.ops import pathtag as jax_pathtag
from vello_tpu.ops import tiling as jax_tiling
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.models.renderer import pack_buffers, to_torch
from vello_tpu_torch.ops import flatten, kernels, pathtag, tiling

SIZE = 128
BASE = (0.12, 0.12, 0.12, 1.0)
RTOL, ATOL = 2e-6, 1e-5


def small_scene(pkg):
    """A disc and an even-odd star at 48x48."""
    s = pkg.Scene()
    a = pkg.Affine.identity()
    s.fill(pkg.Fill.NON_ZERO, a, pkg.palette.RED, None,
           pkg.kurbo.circle_path(20, 22, 15))
    s.fill(pkg.Fill.EVEN_ODD, a, pkg.Color(0.2, 0.5, 0.9, 0.7), None,
           pkg.kurbo.star_path(28, 26, 5, 6, 18))
    return s


@pytest.fixture
def unfused(monkeypatch):
    """VELLO_TPU_NO_FUSED_GEOM for both packages; the JAX package reads it
    when it traces, and its jit caches key on the pipeline's statics
    alone, so they are cleared around the switch."""
    monkeypatch.setenv("VELLO_TPU_NO_FUSED_GEOM", "1")
    _clear_jax_caches()
    yield
    monkeypatch.delenv("VELLO_TPU_NO_FUSED_GEOM", raising=False)
    _clear_jax_caches()


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the stages

def _stage_inputs(name, aa="msaa16"):
    """The port's and the JAX package's non-slim buffers of the scene, the
    statics of the frame, and the JAX package's tile rects."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    ours, ref, jparams = resolve_both(name, params)
    caps = ours.capacities(params)
    assert caps.key() == ref.capacities(jparams).key()
    bufs = to_torch(pack_buffers(ours, caps, params), "cpu")
    jbufs = {k: jnp.asarray(np.asarray(v)) for k, v in jax_pack_buffers(
        ref, caps, jparams).items()}
    wt = (SIZE + TILE_W - 1) // TILE_W + 1
    ht = (SIZE + TILE_H - 1) // TILE_H
    jrects = jax_tiling.tile_alloc(jbufs["path_rect"], wt, ht)
    rects = tiling.tile_alloc(bufs["path_rect"], wt, ht)
    for k, v in jrects.items():
        _equal(rects[k].numpy(), v, k)
    return bufs, jbufs, caps, rects, jrects, float(wt * TILE_W), \
        bool(ours.has_stroke)


def _decode_both(bufs, jbufs, has_stroke):
    got = pathtag.decode_and_transform(
        bufs["tags"], bufs["data"], bufs["transforms"], bufs["styles"],
        style_hw=bufs["style_hw"] if has_stroke else None)
    want = jax_pathtag.decode_and_transform(
        jbufs["tags"], jbufs["data"], jbufs["transforms"], jbufs["styles"],
        style_hw=jbufs["style_hw"] if has_stroke else None)
    return got, want


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["mmark", "edge_circle", "stroked_mmark",
                                  "gradient_suite"])
def test_pathtag_matches_jax(name):
    bufs, jbufs, _, _, _, _, has_stroke = _stage_inputs(name)
    scan = pathtag.pathtag_scan(bufs["tags"])
    jscan = jax_pathtag.pathtag_scan(jbufs["tags"])
    assert set(scan) == set(jscan)
    for k, v in jscan.items():
        assert scan[k].dtype == torch.int32, k
        _equal(scan[k].numpy(), v, k)
    got, want = _decode_both(bufs, jbufs, has_stroke)
    assert set(got) == set(want)
    assert ("hw" in got) == has_stroke
    for k in ("kind", "path_ix", "fill_rule") + (("join",) if has_stroke
                                                 else ()):
        _equal(got[k].numpy(), want[k], k)
    _close(got["points"].numpy(), want["points"], "points")
    if has_stroke:
        _close(got["hw"].numpy(), want["hw"], "hw")
    # the shifted point windows given or built give the same decode
    data4 = torch.stack([torch.roll(bufs["data"], -k, 0) for k in range(4)],
                        dim=1)
    again = pathtag.decode_and_transform(
        bufs["tags"], bufs["data"], bufs["transforms"], bufs["styles"],
        data4=data4)
    torch.testing.assert_close(again["points"], got["points"], rtol=0,
                               atol=0)


def _flatten_both(bufs, jbufs, caps, rects, jrects, width, has_stroke):
    """The port's flatten and the JAX package's, both on the JAX package's
    decoded slots."""
    _, want_dec = _decode_both(bufs, jbufs, has_stroke)
    kw = dict(has_stroke=has_stroke, max_lines=64)
    got = flatten.flatten(_to_torch(want_dec), caps.n_lines, caps.n_edges,
                          width, float(SIZE), rpack=tiling.rect_pack(rects),
                          **kw)
    want = jax_flatten.flatten(want_dec, caps.n_lines, caps.n_edges, width,
                               float(SIZE),
                               rpack=jax_tiling.rect_pack(jrects), **kw)
    return got, want


def _stroke_slot_edges(decoded, n_lines):
    """Edge index 0-6 of each line slot of a stroked segment (e4-e6 are
    the bevel triangle), -1 for a fill or dead slot (the slot layout of
    ``flatten.flatten``)."""
    kind = decoded["kind"]
    cub = flatten.elevate_to_cubic(decoded["points"], kind)
    stroked = (decoded["hw"] > 0) & (kind > 0)
    m = flatten.stroke_mini_counts(cub, decoded["hw"])
    counts = torch.where(stroked, m * flatten.STROKE_SLOTS,
                         flatten.wang_counts(cub, kind)).numpy()
    incl = np.cumsum(counts)
    p = np.arange(n_lines)
    seg = np.minimum(np.searchsorted(incl, p, side="right"), len(incl) - 1)
    sub = p - (incl - counts)[seg]
    ok = (p < incl[-1]) & stroked.numpy()[seg]
    return np.where(ok, sub % flatten.STROKE_SLOTS, -1)


def _exempt_lines(got, want, edges):
    """The stroke lines exempt from equality, as in test_torch_stroke.py's
    ``exempt_lines``: a line of length <= 1e-3 in either package (a
    collapsed slot is live by a one-ulp length), and the long edges e4, e6
    of a bevel triangle whose edge e5 is that short (at a straight
    continuation the triangle's side comes from the sign of a dot product
    that is 0 in exact arithmetic). Such lines carry no winding."""
    def short(lines):
        return np.hypot(lines[:, 2] - lines[:, 0],
                        lines[:, 3] - lines[:, 1]) <= 1e-3

    tiny = short(got) | short(want)
    e5 = np.nonzero((edges == 5) & tiny)[0]
    exempt = tiny & (edges >= 0)
    exempt[e5 - 1] = exempt[e5 + 1] = True
    return exempt


@pytest.mark.parametrize("name", ["mmark", "edge_circle", "stroked_mmark",
                                  "stroked_mmark_rotated"])
def test_flatten_matches_jax(name):
    """Fills, device strokes and geometry crossing the left edge (the
    edge-vertical expansion): the same line and edge slots, flags, paths
    and overflow; coordinates at the FMA bar. Stroke lines that carry no
    winding are exempt (``_exempt_lines``)."""
    inputs = _stage_inputs(name)
    got, want = _flatten_both(*inputs)
    assert set(got) == set(want)
    held = np.ones(got["lines"].shape[0], bool)
    if inputs[-1]:
        _, dec = _decode_both(*inputs[:2], True)
        held = ~_exempt_lines(got["lines"].numpy(), np.asarray(want["lines"]),
                              _stroke_slot_edges(_to_torch(dec),
                                                 held.shape[0]))
        # most exempt slots are zero-length in both packages (the bevel
        # triangles of straight continuations); measured 81% held
        assert held[:int(got["line_real"].sum())].mean() > 0.75
    for k in ("line_real", "edge_path", "edge_valid", "overflow"):
        _equal(got[k].numpy(), want[k], k)
    for k in ("line_path", "line_valid"):
        _equal(got[k].numpy()[held], np.asarray(want[k])[held], k)
    _close(got["lines"].numpy()[held], np.asarray(want["lines"])[held],
           "lines")
    for k in ("edge_lines", "line_rect", "edge_rect"):
        _close(got[k].numpy(), want[k], k)
    assert got["line_valid"].any()
    if name == "edge_circle":
        assert got["edge_valid"].any()


def _soup(fl, lib):
    """The edge region first and real, then the line slots (as both
    packages' prepare_fragments concatenate them)."""
    cat = torch.cat if lib is torch else jnp.concatenate
    ones = (torch.ones_like(fl["edge_valid"]) if lib is torch
            else jnp.ones(fl["edge_valid"].shape[0], bool))
    return (cat([fl["edge_lines"], fl["lines"]]),
            cat([fl["edge_path"], fl["line_path"]]),
            cat([fl["edge_rect"], fl["line_rect"]]),
            cat([ones, fl["line_real"]]))


def _live_rows(ftile, pay):
    """The live touches as sorted rows [ftile, s0x, s0y, s1x, s1y, y_edge,
    backdrop] (float64)."""
    ftile = np.asarray(ftile)
    live = ftile < 2 ** 30
    rows = np.concatenate([ftile[live, None].astype(np.float64),
                           np.asarray(pay).T[live, :6].astype(np.float64)],
                          axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("name", ["mmark", "edge_circle", "stroked_mmark"])
def test_make_touches_matches_jax(jax_interpret, name):
    """K2 (its plain version) on the JAX package's line soup against the
    JAX package's fused Pallas expansion in interpret mode, slot by slot:
    the same touch total and dummies, ftile and backdrop equal, the
    clipped segments and y_edge at the FMA bar. Against its XLA expansion
    (no dummies; ``line_real`` not given) by the live-touch multiset, with
    and without ``line_real`` on the port's side."""
    bufs, jbufs, caps, rects, jrects, width, has_stroke = \
        _stage_inputs(name)
    _, jfl = _flatten_both(bufs, jbufs, caps, rects, jrects, width,
                           has_stroke)
    jlines, jpath, jrect, jreal = _soup(jfl, jnp)
    lines, lpath, lrect, lreal = (torch.from_numpy(np.array(v)) for v in
                                  (jlines, jpath, jrect, jreal))
    kernels.reset_launches()
    got = tiling.make_touches(lines, lpath, rects, caps.n_touches,
                              line_rect=lrect, line_real=lreal)
    want = jax_tiling.make_touches(jlines, jpath, jrects, caps.n_touches,
                                   line_rect=jrect, line_real=jreal)
    assert "pay" in want                  # the Pallas expansion ran
    _equal(got["overflow"].numpy(), want["overflow"], "overflow")
    _equal(got["ftile"].numpy(), want["ftile"], "ftile")
    gp, wp = got["pay"].numpy(), np.asarray(want["pay"])
    assert gp.shape == wp.shape == (8, caps.n_touches)
    _equal(gp[5], wp[5], "backdrop")
    _close(gp[:5], wp[:5], "segments and y_edge")
    # the JAX package's XLA expansion: the same live touches
    xla = jax_tiling.make_touches(jlines, jpath, jrects, caps.n_touches,
                                  line_rect=jrect, line_real=None)
    want_rows = np.concatenate([
        np.asarray(xla["ftile"])[:, None], np.asarray(xla["seg"]),
        np.asarray(xla["y_edge"])[:, None],
        np.asarray(xla["backdrop_val"])[:, None]], axis=1).astype(np.float64)
    want_rows = want_rows[want_rows[:, 0] < 2 ** 30]
    want_rows = want_rows[np.lexsort(want_rows.T[::-1])]
    no_dummies = tiling.make_touches(lines, lpath, rects, caps.n_touches,
                                     line_rect=lrect)
    for t in (got, no_dummies):
        rows = _live_rows(t["ftile"].numpy(), t["pay"].numpy())
        assert rows.shape == want_rows.shape
        _equal(rows[:, 0], want_rows[:, 0], "ftile")
        _equal(rows[:, 6], want_rows[:, 6], "backdrop")
        _close(rows[:, 1:6], want_rows[:, 1:6], "segments and y_edge")
    # every real slot of the port's soup emits a touch, live or a dummy
    assert int((no_dummies["ftile"] < 2 ** 30).sum()) == len(want_rows)


# ---------------------------------------------------------------------------
# whole frames

def spy_geometry(monkeypatch):
    """Count the calls of K1's and K2's wrappers."""
    calls = {"flatten_lines": 0, "expand_touches": 0}

    def spy(wrapper):
        original = getattr(kernels, wrapper)

        def wrapped(*args, **kwargs):
            calls[wrapper] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(kernels, wrapper, wrapped)

    for name in calls:
        spy(name)
    return calls


@pytest.mark.parametrize("name,aa", [
    ("mmark", "msaa16"), ("mmark", "area"), ("edge_circle", "msaa16"),
    ("mixed_paint", "area"), ("stroked_mmark", "msaa16"),
    ("stroked_mmark_rotated", "area")])
def test_unfused_frame_matches_jax(jax_interpret, unfused, monkeypatch, name,
                                   aa):
    """Fills and strokes in both antialiasing modes (the axis-aligned
    stroked_mmark in msaa16 only, see test_stroked_area_frame_near_jax),
    through the tag streams: K1 not called, K2 once; the port's unfused
    frame within 1 level of its fused frame (the unfused path applies the
    transforms on the device, the fused one takes the host's: ulps apart),
    and here equal."""
    calls = spy_geometry(monkeypatch)
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    img, prof = compare_frames(name, params)
    assert prof["retries"] == 0
    assert calls == {"flatten_lines": 0, "expand_touches": 1}
    monkeypatch.delenv("VELLO_TPU_NO_FUSED_GEOM")
    fused = Renderer(device="cpu").render_u8(
        SCENES[name](vello_tpu_torch), params)
    np.testing.assert_array_equal(img, fused)
    assert calls["flatten_lines"] == 1


@pytest.mark.parametrize("aa", ["area", "msaa16"])
def test_every_entry_point_renders_unfused(unfused, monkeypatch, aa):
    """render, render_u8, warmup and render_resolved take the unfused path
    under the variable (each packs the tag streams: slim=False) and give
    the fused path's frame (f32 within 1e-6: the transforms are applied on
    the device, ulps from the host's; u8 equal); the buffer cache tells
    the two packings apart."""
    calls = spy_geometry(monkeypatch)
    params = RenderParams(48, 48, antialiasing=aa)
    pkg = vello_tpu_torch
    r = Renderer(device="cpu")
    rs = resolve(small_scene(pkg).encoding, params)
    f32 = r.render(small_scene(pkg), params)
    u8 = r.render_u8(small_scene(pkg), params)
    assert r.warmup(small_scene(pkg), params) is None
    got = r.render_resolved(rs, params, out="rgba8")
    assert "tags" in getattr(rs, "_torch_bufs")[1]
    assert calls == {"flatten_lines": 0, "expand_touches": 4}
    np.testing.assert_array_equal(got, u8)
    monkeypatch.delenv("VELLO_TPU_NO_FUSED_GEOM")
    np.testing.assert_allclose(r.render(small_scene(pkg), params), f32,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r.render_resolved(rs, params,
                                                    out="rgba8"), u8)
    assert "tags" not in getattr(rs, "_torch_bufs")[1]
    assert calls == {"flatten_lines": 2, "expand_touches": 6}
    assert u8.shape == (48, 48, 4) and u8[..., 3].max() == 255
