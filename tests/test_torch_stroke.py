"""The port's device stroke expansion (``ops/flatten.py`` stroke branch and
K1's stroke rows, run here through their plain versions) against the JAX
package's ``flatten_fused`` with ``seg_hw``/``seg_join`` and its Pallas
kernels in interpret mode. Each package builds, resolves and packs the
scene itself (the host copies are equal, test_torch_host.py).

Bars: the mini counts m and the line totals exactly equal; the line pack
of every line that is not degenerate (see ``exempt_lines``) with its
orientation, tcount, live and crossing flags exactly equal and its
coordinates within rtol 2e-6 / atol 1e-5 (XLA-CPU contracts a*b+c into a
fused multiply-add, the port rounds every op); the touch payload of the
same line pack through both touch expansions with ftile and backdrop
exactly equal and coordinates at the same bar."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import segment_cases
import vello_tpu
import vello_tpu_torch
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import stroked_mmark
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import pack_buffers as jax_pack_buffers
from vello_tpu.ops import flatten as jax_flatten
from vello_tpu.ops import pallas_kernels as jax_pallas_kernels
from vello_tpu.ops import tiling as jax_tiling
from vello_tpu_torch import RenderParams, resolve
from vello_tpu_torch.encoding.config import TILE_H, TILE_W
from vello_tpu_torch.models.renderer import pack_buffers, to_torch
from vello_tpu_torch.ops import flatten as flatten_ops
from vello_tpu_torch.ops import kernels, tiling
from vello_tpu_torch.scenes.test_scenes import filled_mmark

SIZE = 128
BEVEL = dict(join="bevel", start_cap="butt", end_cap="butt")


def sharp_turns(pkg):
    """test_device_stroke.py's sharp-turn / degenerate pair: right-angle
    turns in both directions, and a path whose first and last segments
    repeat a point (zero-length minis)."""
    zig = [[20, 20], [30, 20], [50, 20], [60, 20], [60, 30], [60, 50],
           [60, 60], [50, 60], [30, 60], [20, 60]]
    dup = [[90, 20], [90, 20], [90, 20], [90, 20], [100, 30], [110, 50],
           [120, 60], [120, 60], [120, 60], [120, 60]]
    pts = np.array([zig, dup], np.float32)
    s = pkg.Scene()
    colors = np.tile(np.array([[1, 0, 0, 1]], np.float32), (2, 1))
    s.stroke_batch(pkg.Stroke(width=1.0, **BEVEL), pkg.Affine.identity(),
                   colors, pts, widths=np.array([8.0, 6.0]), expand="device")
    return s


SCENES = {"stroked_mmark": stroked_mmark, "sharp_turns": sharp_turns}


@pytest.fixture(scope="module", params=sorted(SCENES))
def frame(request):
    params = RenderParams(SIZE, SIZE, base_color=(0, 0, 0, 1),
                          antialiasing="msaa16")
    jparams = vello_tpu.RenderParams(SIZE, SIZE, base_color=(0, 0, 0, 1),
                                     antialiasing="msaa16")
    rs = resolve(SCENES[request.param](vello_tpu_torch).encoding, params)
    jrs = jax_resolve(SCENES[request.param](vello_tpu).encoding, jparams)
    assert rs.has_stroke and jrs.has_stroke
    caps = rs.capacities(params)
    assert caps.key() == jrs.capacities(jparams).key()
    bufs = to_torch(pack_buffers(rs, caps, params, slim=True, paint8=True),
                    "cpu")
    jb = {k: jnp.asarray(v) for k, v in jax_pack_buffers(
        jrs, caps, jparams, slim=True, paint8=True).items()}
    wt = (SIZE + TILE_W - 1) // TILE_W + 1
    ht = (SIZE + TILE_H - 1) // TILE_H
    width, height = float(wt * TILE_W), float(SIZE)
    jr = jax_tiling.tile_alloc(jb["path_rect"], wt, ht)
    jff = jax_flatten.flatten_fused(
        jb["seg_pts"], jb["seg_kind"], jb["seg_path"], jb["n_segs"],
        caps.n_lines, width, height, jax_tiling.rect_pack(jr),
        seg_hw=jb["seg_hw"], seg_join=jb["seg_join"], interpret=True,
        max_lines=jrs.max_lines)
    tr = tiling.tile_alloc(bufs["path_rect"], wt, ht)
    tff = flatten_ops.flatten_fused(
        bufs["seg_pts"], bufs["seg_kind"], bufs["seg_path"], bufs["n_segs"],
        caps.n_lines, width, height, tr,
        seg_hw=bufs["seg_hw"], seg_join=bufs["seg_join"],
        max_lines=rs.max_lines)
    return {"name": request.param, "rs": rs, "caps": caps, "bufs": bufs,
            "jb": jb, "jff": jff, "tff": tff}


def test_stroke_mini_counts_equal(frame):
    b, jb, rs = frame["bufs"], frame["jb"], frame["rs"]
    cub = flatten_ops.elevate_to_cubic(b["seg_pts"], b["seg_kind"])
    jcub = jax_flatten.elevate_to_cubic(jb["seg_pts"], jb["seg_kind"])
    np.testing.assert_array_equal(cub.numpy(), np.asarray(jcub))
    m = flatten_ops.stroke_mini_counts(cub, b["seg_hw"],
                                       max_lines=rs.max_lines)
    jm = jax_flatten.stroke_mini_counts(jcub, jb["seg_hw"],
                                        max_lines=rs.max_lines)
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    stroked = b["seg_hw"].numpy() > 0
    assert stroked.sum() > 0 and (m.numpy()[stroked] >= 1).all()


def slot_edges(frame, n_lines):
    """Edge index 0-6 of each line slot of a stroked segment (e4-e6 are the
    bevel triangle), -1 for a fill or dead slot."""
    b, rs = frame["bufs"], frame["rs"]
    cub = flatten_ops.elevate_to_cubic(b["seg_pts"], b["seg_kind"])
    counts = flatten_ops.wang_counts(cub, b["seg_kind"],
                                     max_lines=rs.max_lines)
    m = flatten_ops.stroke_mini_counts(cub, b["seg_hw"],
                                       max_lines=rs.max_lines)
    stroked = b["seg_hw"] > 0
    counts = torch.where(stroked, m * flatten_ops.STROKE_SLOTS, counts)
    live = torch.arange(counts.shape[0]) < b["n_segs"]
    counts = torch.where(live, counts, 0).numpy()
    incl = np.cumsum(counts)
    p = np.arange(n_lines)
    seg = np.minimum(np.searchsorted(incl, p, side="right"), len(incl) - 1)
    sub = p - (incl - counts)[seg]
    ok = (p < incl[-1]) & stroked.numpy()[seg]
    return np.where(ok, sub % flatten_ops.STROKE_SLOTS, -1)


def exempt_lines(got, ref, edges):
    """Lines whose flags turn on a one-ulp difference, and which carry no
    winding in either package:
    - near-horizontal (|dy| <= 1e-4) or near-zero-length (<= 1e-3) lines:
      an exactly horizontal stroke edge is oriented by the sign of a
      one-ulp y difference, a collapsed slot is live by a one-ulp length;
    - the two long edges (e4, e6) of a zero-area bevel triangle (its edge
      e5 near-zero): at a straight continuation the triangle's side comes
      from the sign of a dot product that is 0 in exact arithmetic, and
      e4 and e6 then run along the same segment in opposite directions.
    Returns (exempt mask, e4/e6 slot pairs of the flat triangles)."""
    def short(lp):
        return np.hypot(lp[2] - lp[0], lp[3] - lp[1]) <= 1e-3

    def flat(lp):
        return np.abs(lp[3] - lp[1]) <= 1e-4

    tiny = short(got) | short(ref)
    e5 = np.nonzero((edges == 5) & tiny)[0]
    exempt = tiny | flat(got) | flat(ref)
    exempt[e5 - 1] = exempt[e5 + 1] = True
    return exempt, (e5 - 1, e5 + 1)


def test_stroke_line_pack_matches_pallas(frame):
    jff, tff = frame["jff"], frame["tff"]
    total = int(tff["total_lines"])
    assert total == int(jff["total_lines"]) > 0
    assert int(tff["overflow"]) == int(jff["overflow"]) == 0
    # the line total is the host estimator's: the tier holds with no retry
    assert total <= frame["caps"].n_lines
    ref = np.asarray(jff["linepack"])
    got = tff["linepack"].numpy()
    assert got.shape == ref.shape
    for row in range(10, 16):
        np.testing.assert_array_equal(got[row], ref[row], err_msg=str(row))
    edges = slot_edges(frame, got.shape[1])
    exempt, (e4, e6) = exempt_lines(got, ref, edges)
    held = ~exempt
    assert held.sum() > 0.25 * total
    for row in (4, 5, 6, 7):
        np.testing.assert_array_equal(got[row, held], ref[row, held],
                                      err_msg=str(row))
    coord = (0, 1, 2, 3, 8, 9)
    np.testing.assert_allclose(got[list(coord)][:, held],
                               ref[list(coord)][:, held], rtol=2e-6,
                               atol=1e-5)
    # a flat triangle's e4 and e6 are one segment, run both ways
    for lp in (got, ref):
        a = np.sort(lp[0:4:2][:, e4], axis=0), np.sort(lp[1:4:2][:, e4], 0)
        b = np.sort(lp[0:4:2][:, e6], axis=0), np.sort(lp[1:4:2][:, e6], 0)
        np.testing.assert_allclose(a, b, atol=1e-3)
    # stroked slots make live lines, 7 per centerline mini
    assert (got[6, edges >= 0] > 0).sum() > 0


@pytest.mark.parametrize("has_edge", [False, True])
def test_stroke_touches_match_pallas(frame, has_edge):
    """Both touch expansions on the JAX package's stroke line pack."""
    caps = frame["caps"]
    jff = frame["jff"]
    lp = np.array(jff["linepack"])
    total = int(jff["total_lines"])
    ref = jax_tiling.make_touches_from_linepack(
        jnp.asarray(lp), jnp.int32(total), caps.n_touches, caps.n_edges,
        interpret=True, has_edge=has_edge)
    got = tiling.make_touches_from_linepack(
        torch.from_numpy(lp), torch.tensor(total, dtype=torch.int32),
        caps.n_touches, caps.n_edges, has_edge=has_edge)
    for k in ("overflow", "overflow_edges"):
        assert int(got[k]) == int(ref[k]) == 0, k
    np.testing.assert_array_equal(got["ftile"].numpy(),
                                  np.asarray(ref["ftile"]))
    rp, gp = np.asarray(ref["pay"]), got["pay"].numpy()
    np.testing.assert_array_equal(gp[5:], rp[5:])    # backdrop, ftile
    np.testing.assert_allclose(gp[:5], rp[:5], rtol=2e-6, atol=1e-5)
    assert (gp[6] < 2 ** 30).sum() > 0


# the segment preparation's cases: the stroke fixtures above, a fill-only
# scene, fills and strokes in one scene, and segment_cases.SYNTHETIC
SEGMENT_SCENES = {"stroked_mmark": lambda: stroked_mmark(vello_tpu_torch),
                  "sharp_turns": lambda: sharp_turns(vello_tpu_torch),
                  "filled_mmark": lambda: filled_mmark(1, float(SIZE)),
                  "mixed": lambda: segment_cases.mixed_scene(1, float(SIZE))}


@pytest.mark.parametrize("name", sorted(SEGMENT_SCENES)
                         + list(segment_cases.SYNTHETIC))
def test_segment_prep_plain_matches_jax(name, monkeypatch):
    """The segment preparation's plain version (what kernels.segment_prep
    runs on the CPU) against the JAX package on the same segment arrays:
    its elevate_to_cubic, wang_counts and stroke_mini_counts, and the
    segment fields its flatten_fused hands to the Pallas flatten. The
    cubic, counts, offsets, scan, rects, half-widths, mini counts and join
    flags exactly equal; the join normals within the coordinate bar
    (XLA-CPU contracts a*b+c into a fused multiply-add)."""
    case = (segment_cases.synthetic_case(name)
            if name in segment_cases.SYNTHETIC
            else segment_cases.scene_case(SEGMENT_SCENES[name](), SIZE))
    stroked = "seg_hw" in case
    assert stroked == (not name.endswith(("_fill", "filled_mmark")))
    keys = ("seg_pts", "seg_kind", "seg_path", "n_segs", "path_rect") + (
        ("seg_hw", "seg_join") if stroked else ())
    t = {k: torch.from_numpy(np.asarray(case[k])) for k in keys}
    j = {k: jnp.asarray(case[k]) for k in keys}
    rects = tiling.tile_alloc(t["path_rect"], case["wt"], case["ht"])
    args = (t["seg_pts"], t["seg_kind"], t["seg_path"], t["n_segs"], rects,
            t.get("seg_hw"), t.get("seg_join"), case["max_lines"])
    kernels.reset_launches()
    spack, incl = kernels.segment_prep(*args)
    assert kernels.launches["segment_prep"] == 0      # CPU: plain
    pspack, pincl = kernels.segment_prep_plain(*args)
    assert torch.equal(spack, pspack) and torch.equal(incl, pincl)
    s = case["seg_kind"].shape[0]
    assert spack.shape == (s, 21 if stroked else 16)
    assert incl.dtype == torch.int32

    captured = {}

    def capture(spackT, s0s, n_lines_cap, *rest, **kw):
        captured["spackT"] = np.asarray(spackT)
        return jnp.zeros((16, n_lines_cap), jnp.float32)

    monkeypatch.setattr(jax_pallas_kernels, "flatten_pallas", capture)
    jr = jax_tiling.tile_alloc(j["path_rect"], case["wt"], case["ht"])
    jax_flatten.flatten_fused(
        j["seg_pts"], j["seg_kind"], j["seg_path"], j["n_segs"], 1024,
        1024.0, 1024.0, jax_tiling.rect_pack(jr), seg_hw=j.get("seg_hw"),
        seg_join=j.get("seg_join"), interpret=True,
        max_lines=case["max_lines"])
    ref = captured["spackT"][:, :s].T                 # (S, 24)
    got = spack.numpy()
    # the JAX rows [cub8, count, offs, incl, rect6, hw, jnx, jny, m, join]
    np.testing.assert_array_equal(got[:, :10], ref[:, :10])
    np.testing.assert_array_equal(incl.numpy(), ref[:, 10])
    np.testing.assert_array_equal(got[:, 10:16], ref[:, 11:17])
    jcub = jax_flatten.elevate_to_cubic(j["seg_pts"], j["seg_kind"])
    np.testing.assert_array_equal(got[:, :8],
                                  np.asarray(jcub).reshape(s, 8))
    live = np.arange(s) < int(case["n_segs"])
    want = np.asarray(jax_flatten.wang_counts(jcub, j["seg_kind"],
                                              max_lines=case["max_lines"]))
    if stroked:
        hw = case["seg_hw"]
        jm = np.asarray(jax_flatten.stroke_mini_counts(
            jcub, j["seg_hw"], max_lines=case["max_lines"]))
        jm = np.where(hw > 0, jm, 0)
        want = np.where(hw > 0, jm * flatten_ops.STROKE_SLOTS, want)
        np.testing.assert_array_equal(got[:, 19], jm)
        np.testing.assert_array_equal(got[:, [16, 19, 20]],
                                      ref[:, [17, 20, 21]])
        np.testing.assert_allclose(got[:, 17:19], ref[:, 18:20], rtol=2e-6,
                                   atol=1e-5)
        joined = got[:, 20] > 0
        assert joined.any() and (got[:, 20] == 0).any()
        if name in segment_cases.SYNTHETIC:
            assert joined[-1]        # the last segment's join wraps to 0
    np.testing.assert_array_equal(got[:, 8], np.where(live, want, 0))
