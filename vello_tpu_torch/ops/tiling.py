"""Device-side tiling: lines -> (line, tile) touches (counterpart of
``vello_tpu/ops/tiling.py``).

Per-line counts and their scan are PyTorch; the per-touch DDA staircase,
backdrop delta and tile clip are kernel K2 in ``ops/kernels.py``, on the
fused path's line pack (``make_touches_from_linepack``) and on the unfused
path's line soup (``make_touches``) alike.
"""

from __future__ import annotations

import torch

from ..encoding.config import TILE_H, TILE_W
from . import kernels
from .flatten import EDGE_EPS, expand_by_counts
from .kernels import _dda_from_q


def tile_alloc(path_rect: torch.Tensor, width_tiles: int,
               height_tiles: int) -> dict:
    """Flat-tile allocation from the host-computed per-path tile rects:
    each path owns a row-major block of ``areas`` tiles at ``base``."""
    tx0 = path_rect[:, 0].clamp(0, width_tiles)
    ty0 = path_rect[:, 1].clamp(0, height_tiles)
    tx1 = torch.maximum(path_rect[:, 2], tx0).clamp_max(width_tiles)
    ty1 = torch.maximum(path_rect[:, 3], ty0).clamp_max(height_tiles)
    w = tx1 - tx0
    h = ty1 - ty0
    areas = w * h
    incl = torch.cumsum(areas, 0, dtype=torch.int32)
    return {
        "tx0": tx0, "ty0": ty0, "tx1": tx1, "ty1": ty1,
        "stride": w, "rows": h, "base": incl - areas, "areas": areas,
        "total_tiles": incl[-1],
    }


def rect_pack(rects: dict) -> torch.Tensor:
    """(P, 6) f32 [tx0, ty0, tx1, ty1, stride, base] per path."""
    return torch.stack([rects[k].to(torch.float32)
                        for k in kernels.RECT_FIELDS], dim=-1)


def _dda_params(lines: torch.Tensor) -> dict:
    """Per-line staircase parameters (downward-oriented); lines (L, 4)."""
    x0, y0, x1, y1 = lines.unbind(1)
    is_down = y1 >= y0
    qx0 = torch.where(is_down, x0, x1)
    qy0 = torch.where(is_down, y0, y1)
    qx1 = torch.where(is_down, x1, x0)
    qy1 = torch.where(is_down, y1, y0)
    p = _dda_from_q(qx0, qy0, qx1, qy1)
    p["is_down"] = is_down
    p["q"] = (qx0, qy0, qx1, qy1)
    return p


def _expand(qrows, liverow, rectrows, tcounts, n_touch_cap: int):
    """K2 on lines with touch counts ``tcounts``: the (16, N) pack
    [qx0, qy0, qx1, qy1, down, offs, incl, live, rect6, 0, 0] from the
    (5, N) rows [q, down], the (1, N) live row and the (6, N) rect rows.
    Returns (ftile (T,) i32, pay (8, T) f32, overflow)."""
    incl = torch.cumsum(tcounts, 0, dtype=torch.int32)
    total = incl[-1]
    n_all = qrows.shape[1]
    lpack = torch.cat([
        qrows, (incl - tcounts).to(torch.float32)[None],
        incl.to(torch.float32)[None], liverow, rectrows,
        torch.zeros((2, n_all), dtype=torch.float32, device=qrows.device)],
        dim=0).contiguous()                               # (16, N)
    pay = kernels.expand_touches(lpack, incl, n_touch_cap)
    return (pay[6].to(torch.int32), pay,
            (total > n_touch_cap).to(torch.int32))


def make_touches(lines: torch.Tensor, line_path: torch.Tensor, rects: dict,
                 n_touch_cap: int, line_rect=None, line_real=None) -> dict:
    """Touch expansion of the unfused line soup (``flatten.flatten``):
    lines (L, 4) f32, line_path (L,) i32 (2**30 for a dead line).

    ``line_rect`` (L, 6), optional: the per-line rect fields carried along
    the flatten expansion (else gathered here by path). ``line_real`` (L,)
    bool, optional: the real line slots; each of them emits at least one
    touch (a dead one a dump-tile dummy, as on the fused path, which the
    host estimator counts). Without it a line emits its live touches only,
    as the JAX package's XLA expansion does. Either way K2 expands the
    lines; its plain version runs on the CPU.

    Returns {"ftile" (T,) i32, "pay" (8, T) f32 [s0x, s0y, s1x, s1y,
    y_edge, backdrop, ftile, 0], "overflow"}."""
    p = _dda_params(lines)
    valid_line = line_path < 2 ** 30
    if line_rect is not None:
        rrow = line_rect
    else:
        pclip = line_path.long().clamp(0, rects["tx0"].shape[0] - 1)
        rrow = rect_pack(rects)[pclip]
    # a vertical exactly on the path's right tile boundary carries winding
    # outside the bbox only (path_count.wgsl: xmin >= bbox.z)
    on_right = torch.minimum(lines[:, 0], lines[:, 2]) / TILE_W >= rrow[:, 2]
    live = valid_line & ~on_right & (rrow[:, 4] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=lines.device)
    counts = torch.where(live, p["count"], zero).to(torch.int32)
    live = live & (p["count"] > 0)
    if line_real is not None:
        counts = torch.where(line_real, counts.clamp_min(1),
                             torch.zeros_like(counts))
    down = torch.where(p["is_down"], 1.0, -1.0)
    ftile, pay, overflow = _expand(
        torch.stack(list(p["q"]) + [down]), live.to(torch.float32)[None],
        rrow.T, counts, n_touch_cap)
    return {"ftile": ftile, "pay": pay, "overflow": overflow}


def make_touches_from_linepack(linepack: torch.Tensor, total_lines,
                               n_touch_cap: int, n_edge_cap: int,
                               has_edge: bool = True) -> dict:
    """Touch expansion from the (16, L) line pack of ``flatten_fused``.

    Every real line slot emits at least one touch (a dead one a dump
    dummy), so the touch totals match the JAX package and the host
    estimator. ``has_edge=True`` also expands the left-edge verticals
    (winding carriers of geometry clipped at x = 0) and puts them FIRST,
    every edge slot emitting >= 1 touch. ``has_edge=False`` skips them and
    reports any crossing it sees as ``overflow_edges`` 16, which the
    renderer's overflow word turns into bit 32 (retry with the edge path).

    Returns {"ftile" (T,) i32, "pay" (8, T) f32 [s0x, s0y, s1x, s1y,
    y_edge, backdrop, ftile, 0], "overflow", "overflow_edges"}."""
    lnum = linepack.shape[1]
    dev = linepack.device
    real_line = torch.arange(lnum, dtype=torch.int32, device=dev) \
        < total_lines
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tc_l = torch.where(real_line, torch.clamp_min(linepack[5], 1.0), zero)
    if not has_edge:
        ecount_seen = torch.where(real_line, linepack[7], zero).sum()
        overflow_edges = 16 * (ecount_seen > 0).to(torch.int32)
        tcounts = tc_l.to(torch.int32)
        qrows = linepack[0:5]
        liverow = linepack[6:7]
        rectrows = linepack[10:16]
    else:
        ecounts = linepack[7].to(torch.int32)
        eix, evalid, etotal = expand_by_counts(ecounts, n_edge_cap)
        overflow_edges = (etotal > n_edge_cap).to(torch.int32)
        erow = linepack[8:16].T[eix.long()]               # (E, 8)
        ey0, ey1 = erow[:, 0], erow[:, 1]
        erect = erow[:, 2:8]
        lof = torch.full_like(ey0, EDGE_EPS)
        pe = _dda_params(torch.stack([lof, ey0, lof, ey1], dim=-1))
        e_on_right = (EDGE_EPS / TILE_W) >= erect[:, 2]
        e_live = evalid & ~e_on_right & (erect[:, 4] > 0) & (pe["count"] > 0)
        etcount = torch.where(e_live, pe["count"], zero)
        tcounts = torch.cat([torch.clamp_min(etcount, 1.0),
                             tc_l]).to(torch.int32)
        down_e = torch.where(pe["is_down"], 1.0, -1.0)
        qrows = torch.cat([torch.stack(list(pe["q"]) + [down_e]),
                           linepack[0:5]], dim=1)          # (5, E+L)
        liverow = torch.cat([e_live.to(torch.float32),
                             linepack[6]])[None]
        rectrows = torch.cat([erect.T, linepack[10:16]], dim=1)
    ftile, pay, overflow = _expand(qrows, liverow, rectrows, tcounts,
                                   n_touch_cap)
    return {"ftile": ftile, "pay": pay, "overflow": overflow,
            "overflow_edges": overflow_edges}
