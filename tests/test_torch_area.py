"""K5 (the port's area coverage) and the area-AA frame against the JAX
package on the CPU.

- ``coverage_delta`` against ``fine_xla.coverage_delta`` compiled, as the
  JAX Renderer runs it: equal, and so within rtol 2e-6 / atol 1e-5, the
  FMA bar of test_fused_touches.py. XLA-CPU contracts ``startx + t0 * dx``
  and ``d * d - c * c`` into fused multiply-adds, and the port computes
  the same two (``fine.fma``; ``__fmaf_rn`` in kernel K5) and rounds every
  other op.
- K5's plain version against ``coverage_cumsum_pallas`` in interpret mode,
  differenced at the segment starts as ``render.py:412-415`` does, then the
  same backdrop, fill-rule, centers and valid epilogue: atol 1e-5. The JAX
  package's cumsum difference carries about an ulp of the running sum
  (measured max 7.6e-6 on these streams); the port sums each fragment
  directly. With ``centers``, pixels whose unthresholded coverage lies
  within that bar of 0.5 may round either way and are left out.
  Fragments that own an exactly vertical touch (x0 == x1) included: for
  such a touch the area term divides two differences of about 1e-6 (the
  ``- 1e-6`` nudge of ``fine.wgsl``), so one rounding moves it by up to
  0.06, and the port takes the fused multiply-adds that XLA-CPU contracts
  in the interpret-mode kernel and in ``fine_xla`` alike. They are also
  held to the JAX package's other area path (the compiled
  ``fine_xla.coverage_delta`` and ``segment_sum_from_starts``,
  ``render.py:417-418``), which the JAX Renderer on the CPU runs and which
  made the goldens, at the same bar.
- The whole frame at 128x128 through ``Renderer(device="cpu")`` against the
  JAX Renderer with Pallas in interpret mode: the bars of
  test_torch_pipeline.py. The base color is 0.12, not 0.1: 0.1 puts every
  background pixel on the u8 half level 25.5, and the JAX package's cumsum
  leaves ulp-sized coverage residue in pixels that no shape covers, which
  flips about 2% of the bytes of the frame one level there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import jax_interpret  # noqa: F401 (fixture)
from test_torch_pipeline import SIZE, compare_frames, resolve_both
from vello_tpu.ops import fine_xla
from vello_tpu.ops.pallas_kernels import BLK, coverage_cumsum_pallas
from vello_tpu.ops.segmented import segment_sum_from_starts
from vello_tpu_torch import Renderer, RenderParams
from vello_tpu_torch.ops import fine, kernels

BASE = (0.12, 0.12, 0.12, 1.0)
AREA_ATOL = 1e-5


def _stream(seed):
    """Seeded fragment-sorted touch stream: tile-local segments with
    horizontal (dy == 0), vertical (dx == 0) and degenerate (a point)
    rows, a real y_edge on about 30% of the rows, fragments without
    touches, both fill rules and some invalid fragments; padded with dead
    touches (past starts[F]) to a multiple of the Pallas block."""
    rng = np.random.default_rng(seed)
    t, f = 700, 300
    fid = np.sort(rng.integers(0, f, t))
    x0 = rng.uniform(-1, 17, t)
    y0 = rng.uniform(-1, 17, t)
    x1 = x0 + rng.uniform(-6, 6, t)
    y1 = y0 + rng.uniform(-6, 6, t)
    y1[::9] = y0[::9]                        # horizontal
    x1[4::13] = x0[4::13]                    # vertical
    x1[7::29], y1[7::29] = x0[7::29], y0[7::29]   # degenerate
    ye = np.where(rng.uniform(size=t) < 0.3, rng.uniform(0, 16, t), 1e9)
    pad = -t % BLK
    seg = np.zeros((t + pad, 4), np.float32)
    seg[:t] = np.stack([x0, y0, x1, y1], axis=1)
    y_edge = np.full(t + pad, 1e9, np.float32)
    y_edge[:t] = ye
    starts = np.searchsorted(fid, np.arange(f + 1)).astype(np.int32)
    assert (starts[1:] == starts[:-1]).any()            # empty fragments
    return {"seg": seg, "y_edge": y_edge, "starts": starts,
            "backdrop": rng.integers(-2, 3, f).astype(np.float32),
            "rule": rng.integers(0, 2, f).astype(np.int32),
            "valid": rng.uniform(size=f) < 0.9}


# fine_xla.coverage_delta as the JAX Renderer runs it: compiled, where
# XLA-CPU contracts x0 = startx + t0 * dx and d * d - c * c into fused
# multiply-adds (op by op, eagerly, it rounds every op)
_jit_coverage_delta = jax.jit(fine_xla.coverage_delta)


def _jax_area(s, pallas=True):
    """The JAX package's area coverage (render.py:406-430) before the
    centers threshold: the Pallas cumsum differenced at starts (or, with
    ``pallas=False``, the compiled ``fine_xla.coverage_delta`` and
    ``segment_sum_from_starts``), backdrop, fill rule, valid mask."""
    seg, y_edge = jnp.asarray(s["seg"]), jnp.asarray(s["y_edge"])
    st = s["starts"]
    if pallas:
        csum = np.asarray(coverage_cumsum_pallas(seg, y_edge,
                                                 interpret=True))
        at = np.where((st > 0)[:, None], csum[np.maximum(st - 1, 0)], 0.0)
        frag = at[1:] - at[:-1]
    else:
        frag = np.asarray(segment_sum_from_starts(
            _jit_coverage_delta(seg, y_edge), jnp.asarray(st)))
    winding = s["backdrop"][:, None] + frag
    cov = np.asarray(fine_xla.apply_fill_rule(
        jnp.asarray(winding), jnp.asarray(s["rule"][:, None])))
    return np.where(s["valid"][:, None], cov, 0.0)


def _vertical_frags(s):
    """(F,) bool: fragments owning an exactly vertical touch."""
    seg, st = s["seg"], s["starts"]
    t = np.arange(st[-1])
    vert = (seg[t, 0] == seg[t, 2]) & (seg[t, 1] != seg[t, 3])
    out = np.zeros(len(st) - 1, bool)
    out[np.searchsorted(st, t[vert], side="right") - 1] = True
    return out


def _assert_area_close(got, ref, centers, rows):
    """got/ref on fragments ``rows``: atol 1e-5, or with ``centers`` the
    thresholded ref wherever the unthresholded one is clear of 0.5."""
    got, ref = got[rows], ref[rows]
    if not centers:
        np.testing.assert_allclose(got, ref, rtol=0, atol=AREA_ATOL)
        return
    sure = np.abs(ref - 0.5) > AREA_ATOL
    assert sure.mean() > 0.999
    np.testing.assert_array_equal(got[sure],
                                  np.where(ref >= 0.5, 1.0, 0.0)[sure])
    assert set(np.unique(got)) <= {0.0, 1.0}


def _port_area(s, centers):
    trow = np.zeros((len(s["seg"]), 8), np.float32)
    trow[:, :4] = s["seg"]
    trow[:, 4] = s["y_edge"]
    return kernels.coverage_area(
        torch.from_numpy(trow), torch.from_numpy(s["starts"]),
        torch.from_numpy(s["backdrop"]), torch.from_numpy(s["rule"]),
        torch.from_numpy(s["valid"]), centers).numpy()


@pytest.mark.parametrize("centers", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_area_plain_matches_pallas(seed, centers):
    s = _stream(seed)
    ref = _jax_area(s)
    got = _port_area(s, centers)
    assert got.shape == ref.shape == (len(s["backdrop"]), 256)
    assert 0.05 < ref.mean() < 0.95 and (ref == 0).any() and (ref == 1).any()
    assert 0.0 < _vertical_frags(s).mean() < 0.5
    _assert_area_close(got, ref, centers, slice(None))


@pytest.mark.parametrize("centers", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_area_plain_matches_xla_path(seed, centers):
    s = _stream(seed)
    ref = _jax_area(s, pallas=False)
    got = _port_area(s, centers)
    assert _vertical_frags(s).any()
    _assert_area_close(got, ref, centers, slice(None))


def _fma_exact(a, b, c):
    """The f32 nearest a * b + c, ties to even, by exact rational sums."""
    from fractions import Fraction
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    x = np.float32(float(v))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    err = [abs(Fraction(float(y)) - v) for y in cands]
    best = min(err)
    ties = [y for y, e in zip(cands, err) if e == best]
    return min(ties, key=lambda y: int(np.float32(y).view(np.int32)) & 1)


def test_fma_is_correctly_rounded():
    """``fine.fma``, the plain version of ``__fmaf_rn``: one rounding of
    the exact a * b + c, on random operands of many magnitudes, on the
    product's own rounding error (c = -RN(a * b), where a multiply and an
    add give 0), and on the vertical-touch terms d * d - c * c."""
    rng = np.random.default_rng(11)
    n = 3000
    a = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    b = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    c = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-60, 60, n)).astype(
        np.float32)
    c[::3] = -(a[::3] * b[::3])
    x = rng.uniform(0, 1, n).astype(np.float32)
    d = np.maximum(x - np.float32(1e-6), np.float32(0))
    a, b, c = (np.concatenate([a, d]), np.concatenate([b, d]),
               np.concatenate([c, -(x * x)]))
    got = fine.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got[::3][:n // 3] != 0).mean() > 0.9    # the product errors


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coverage_delta_matches_fine_xla(seed):
    s = _stream(seed)
    got = fine.coverage_delta(torch.from_numpy(s["seg"]),
                              torch.from_numpy(s["y_edge"])).numpy()
    ref = np.asarray(_jit_coverage_delta(jnp.asarray(s["seg"]),
                                         jnp.asarray(s["y_edge"])))
    assert np.isfinite(got).all() and (got != 0).mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-5)
    # the same f32 ops with the same two fused multiply-adds: equal
    np.testing.assert_array_equal(got, ref)


def test_area_rows_sum_in_stream_order():
    """A fragment's row is the nonzero rule applied to its touches'
    coverage_delta rows summed one by one in stream order (backdrop 0),
    bit for bit: the order of additions the kernel keeps."""
    s = _stream(4)
    trow = torch.zeros((len(s["seg"]), 8))
    trow[:, :4] = torch.from_numpy(s["seg"])
    trow[:, 4] = torch.from_numpy(s["y_edge"])
    f = len(s["backdrop"])
    zeros = torch.zeros(f)
    cov = kernels.coverage_area(trow, torch.from_numpy(s["starts"]), zeros,
                                torch.zeros(f, dtype=torch.int32),
                                torch.ones(f, dtype=torch.bool), False)
    delta = fine.coverage_delta(trow[:, :4], trow[:, 4])
    for i in range(f):
        lo, hi = int(s["starts"][i]), int(s["starts"][i + 1])
        acc = torch.zeros(256)
        for t in range(lo, hi):
            acc = acc + delta[t]
        assert torch.equal(cov[i], torch.clamp_max(acc.abs(), 1.0)), i


@pytest.mark.parametrize("name,aa", [("mmark", "area"),
                                     ("edge_circle", "area"),
                                     ("evenodd_star", "area"),
                                     ("mmark", "centers")])
def test_area_frame_matches_jax(jax_interpret, name, aa):
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    kernels.reset_launches()
    img, prof = compare_frames(name, params)
    assert prof["retries"] == 0
    assert img[..., 3].min() == 255
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8
    assert all(n == 0 for n in kernels.launches.values())   # CPU: plain


def test_area_is_the_default():
    """RenderParams(w, h) renders with area AA, the same as asking for it."""
    params = RenderParams(SIZE, SIZE, base_color=BASE)
    assert params.antialiasing == "area"
    ours, _, _ = resolve_both("evenodd_star", params)
    area = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="area")
    np.testing.assert_array_equal(
        Renderer(device="cpu").render_resolved(ours, params, out="rgba8"),
        Renderer(device="cpu").render_resolved(ours, area, out="rgba8"))


def test_area_retry_matches_jax(jax_interpret):
    """A touch tier halved below the host's estimate overflows (bit 4),
    retries once and still matches; the retried frame equals the one at
    the host's own tier."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="area")
    shrink = {"est_touches": 0.5}
    _, prof = compare_frames("mmark", params, shrink)
    assert prof["retries"] == 1
    full, _, _ = resolve_both("mmark", params)
    small, _, _ = resolve_both("mmark", params, shrink)
    np.testing.assert_array_equal(
        Renderer(device="cpu").render_resolved(small, params, out="rgba8"),
        Renderer(device="cpu").render_resolved(full, params, out="rgba8"))
