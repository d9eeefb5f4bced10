"""The port's fused geometry (K1 flatten, K2 touch expansion and the
PyTorch around them) against the JAX package's Pallas kernels in interpret
mode. Each package builds, resolves and packs the scene itself (the
host copies are equal, test_torch_host.py); the kernels of both then run on
buffers of equal content.

Bars: line and touch totals, tcount, live, crossing, orientation, ftile and
backdrop exactly equal; coordinates within rtol 2e-6 / atol 1e-5 (the bar
of test_fused_touches.py: XLA-CPU may contract a*b+c into an FMA, the
port rounds every op)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vello_tpu
import vello_tpu_torch
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import (blurred_rects, edge_scene, image_quality,
                                 mixed_paint, mmark, stroked_mmark)
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import pack_buffers as jax_pack_buffers
from vello_tpu.ops import flatten as jax_flatten
from vello_tpu.ops import tiling as jax_tiling
from vello_tpu_torch import RenderParams, resolve
from vello_tpu_torch.encoding.config import TILE_H, TILE_W
from vello_tpu_torch.models.renderer import pack_buffers, to_torch
from vello_tpu_torch.ops import flatten as flatten_ops
from vello_tpu_torch.ops import tiling

SIZE = 128

# scene builders given the package to build through; edge_circle is
# test_fused_touches.py's scene: its off-screen circle crosses x = 0, so
# the left-edge verticals are live (has_edge True); mixed_paint,
# image_quality and blurred_rects carry gradients, images and blurred
# rects, so paint_pack has all 40 columns and ramps and atlas are filled
SCENES = {"edge_circle": edge_scene, "mmark": mmark,
          "mixed_paint": mixed_paint, "image_quality": image_quality,
          "blurred_rects": blurred_rects}


@pytest.fixture(scope="module", params=sorted(SCENES))
def frame(request):
    params = RenderParams(SIZE, SIZE, base_color=(0, 0, 0, 1),
                          antialiasing="msaa16")
    jparams = vello_tpu.RenderParams(SIZE, SIZE, base_color=(0, 0, 0, 1),
                                     antialiasing="msaa16")
    rs = resolve(SCENES[request.param](vello_tpu_torch).encoding, params)
    jrs = jax_resolve(SCENES[request.param](vello_tpu).encoding, jparams)
    caps = rs.capacities(params)
    assert caps.key() == jrs.capacities(jparams).key()
    assert caps.n_lines % 1024 == 0 and caps.n_touches % 1024 == 0
    bufs = pack_buffers(rs, caps, params, slim=True, paint8=True)
    jbufs = jax_pack_buffers(jrs, caps, jparams, slim=True, paint8=True)
    wt = (SIZE + TILE_W - 1) // TILE_W + 1
    ht = (SIZE + TILE_H - 1) // TILE_H
    fr = {"name": request.param, "rs": rs, "jrs": jrs, "caps": caps,
          "bufs": bufs, "jbufs": jbufs, "wt": wt, "ht": ht,
          "params": params, "jparams": jparams}
    fr["jax_flatten"], fr["torch_flatten"] = _flatten_both(fr)
    return fr


@pytest.mark.parametrize("slim,paint8", [(False, False), (True, False),
                                         (True, True)])
def test_pack_buffers_matches_jax(frame, slim, paint8):
    caps = frame["caps"]
    ours = pack_buffers(frame["rs"], caps, frame["params"], slim=slim,
                        paint8=paint8)
    ref = jax_pack_buffers(frame["jrs"], caps, frame["jparams"], slim=slim,
                           paint8=paint8)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    t = to_torch(ours, "cpu")
    for k in ours:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(ours[k]))


@pytest.mark.parametrize("slim,paint8", [(False, False), (True, True)])
def test_pack_buffers_stroke_fields_match_jax(slim, paint8):
    """A device-stroked scene also packs seg_hw, seg_join and style_hw."""
    params = RenderParams(SIZE, SIZE, antialiasing="msaa16")
    jparams = vello_tpu.RenderParams(SIZE, SIZE, antialiasing="msaa16")
    rs = resolve(stroked_mmark(vello_tpu_torch).encoding, params)
    jrs = jax_resolve(stroked_mmark(vello_tpu).encoding, jparams)
    caps = rs.capacities(params)
    ours = pack_buffers(rs, caps, params, slim=slim, paint8=paint8)
    ref = jax_pack_buffers(jrs, caps, jparams, slim=slim, paint8=paint8)
    assert {"seg_hw", "seg_join", "style_hw"} <= set(ours)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (ours["seg_hw"] > 0).sum() > 0


def _flatten_both(frame):
    caps, bnp, rs = frame["caps"], frame["bufs"], frame["rs"]
    width, height = float(frame["wt"] * TILE_W), float(SIZE)
    jb = {k: jnp.asarray(v) for k, v in frame["jbufs"].items()}
    jr = jax_tiling.tile_alloc(jb["path_rect"], frame["wt"], frame["ht"])
    jff = jax_flatten.flatten_fused(
        jb["seg_pts"], jb["seg_kind"], jb["seg_path"], jb["n_segs"],
        caps.n_lines, width, height, jax_tiling.rect_pack(jr),
        interpret=True, max_lines=frame["jrs"].max_lines)
    tb = to_torch(bnp, "cpu")
    tr = tiling.tile_alloc(tb["path_rect"], frame["wt"], frame["ht"])
    for k in ("tx0", "ty0", "tx1", "ty1", "stride", "base", "areas"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    tff = flatten_ops.flatten_fused(
        tb["seg_pts"], tb["seg_kind"], tb["seg_path"], tb["n_segs"],
        caps.n_lines, width, height, tr,
        max_lines=rs.max_lines)
    return jff, tff


def test_flatten_matches_pallas(frame):
    jff, tff = frame["jax_flatten"], frame["torch_flatten"]
    assert int(tff["total_lines"]) == int(jff["total_lines"]) > 0
    assert int(tff["overflow"]) == int(jff["overflow"]) == 0
    ref = np.asarray(jff["linepack"])
    got = tff["linepack"].numpy()
    assert got.shape == ref.shape
    # down, tcount, live, crossing and the rect rows are exact
    for row in (4, 5, 6, 7) + tuple(range(10, 16)):
        np.testing.assert_array_equal(got[row], ref[row], err_msg=str(row))
    coord = (0, 1, 2, 3, 8, 9)
    np.testing.assert_allclose(got[coord, :], ref[coord, :], rtol=2e-6,
                               atol=1e-5)
    crossing = int(got[7].sum())
    assert (crossing > 0) == (frame["name"] == "edge_circle")


@pytest.mark.parametrize("has_edge", [False, True])
def test_touch_expansion_matches_pallas(frame, has_edge):
    caps = frame["caps"]
    jff = frame["jax_flatten"]
    lp = np.array(jff["linepack"])
    total = int(jff["total_lines"])
    ref = jax_tiling.make_touches_from_linepack(
        jnp.asarray(lp), jnp.int32(total), caps.n_touches, caps.n_edges,
        interpret=True, has_edge=has_edge)
    got = tiling.make_touches_from_linepack(
        torch.from_numpy(lp), torch.tensor(total, dtype=torch.int32),
        caps.n_touches, caps.n_edges, has_edge=has_edge)
    for k in ("overflow", "overflow_edges"):
        assert int(got[k]) == int(ref[k]), k
    # has_edge=False on geometry crossing x = 0 raises the retry flag
    assert (int(got["overflow_edges"]) == 16) == (
        not has_edge and frame["name"] == "edge_circle")
    np.testing.assert_array_equal(got["ftile"].numpy(),
                                  np.asarray(ref["ftile"]))
    rp, gp = np.asarray(ref["pay"]), got["pay"].numpy()
    np.testing.assert_array_equal(gp[5], rp[5])       # backdrop deltas
    np.testing.assert_array_equal(gp[6:], rp[6:])
    np.testing.assert_allclose(gp[:5], rp[:5], rtol=2e-6, atol=1e-5)
    live = gp[6] < 2 ** 30
    assert live.sum() > 0
    assert (gp[5] != 0).sum() > 0
