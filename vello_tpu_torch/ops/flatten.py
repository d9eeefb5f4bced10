"""Device-side flattening: curves -> line soup with viewport clipping
(counterpart of ``vello_tpu/ops/flatten.py``).

Fused path (``flatten_fused``): the segment-scale work (degree elevation,
Wang counts, stroke mini counts and join normals, the count scan, the
segment pack) is ``kernels.segment_prep``; the per-line work (cubic
evaluation at uniform t, stroke slot lines, y trim, x clamp, left-edge
detection, DDA touch counts) is kernel K1, ``kernels.flatten_lines``.
Unfused path (``flatten``, under ``VELLO_TPU_NO_FUSED_GEOM``): the JAX
package's XLA formulation in library PyTorch, from the decoded tag slots
to the line soup and its left-edge verticals. The f32 op order follows
the JAX package so that counts agree bit for bit with it and with the host
estimator; ``rsqrt`` is ``1 / sqrt`` (correctly rounded on both devices,
as XLA lowers it).
"""

from __future__ import annotations

import torch

from ..encoding.config import FLATTEN_TOL, MAX_LINES_PER_SEG
from . import kernels
from .kernels import EDGE_EPS


def elevate_to_cubic(points: torch.Tensor, kind: torch.Tensor
                     ) -> torch.Tensor:
    """points (S, 4, 2), kind (S,) 1=line 2=quad 3=cubic -> (S, 4, 2)."""
    p0 = points[:, 0]
    line_p1 = points[:, 1]
    quad_c, quad_p2 = points[:, 1], points[:, 2]
    k = kind[:, None]
    c1 = torch.where(k == 1, p0 + (line_p1 - p0) / 3.0,
                     torch.where(k == 2, p0 + 2.0 / 3.0 * (quad_c - p0),
                                 points[:, 1]))
    c2 = torch.where(k == 1, p0 + 2.0 / 3.0 * (line_p1 - p0),
                     torch.where(k == 2,
                                 quad_p2 + 2.0 / 3.0 * (quad_c - quad_p2),
                                 points[:, 2]))
    p3 = torch.where(k == 1, line_p1,
                     torch.where(k == 2, quad_p2, points[:, 3]))
    return torch.stack([p0, c1, c2, p3], dim=1)


def _hypot(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula, max * sqrt(1 + (min/max)^2), so that the
    Wang counts round exactly as the JAX package's do (torch.hypot may
    differ in the last ulp)."""
    x1, x2 = x1.abs(), x2.abs()
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    return torch.where(hi == 0, hi, hi * torch.sqrt(1.0 + q * q))


def wang_counts(cubics: torch.Tensor, kind: torch.Tensor,
                tol: float = FLATTEN_TOL,
                max_lines: int = MAX_LINES_PER_SEG) -> torch.Tensor:
    """Lines per segment from Wang's bound, (S,) i32; 0 for kind 0."""
    d1 = cubics[:, 0] - 2 * cubics[:, 1] + cubics[:, 2]
    d2 = cubics[:, 1] - 2 * cubics[:, 2] + cubics[:, 3]
    m = 6.0 * torch.maximum(_hypot(d1[..., 0], d1[..., 1]),
                            _hypot(d2[..., 0], d2[..., 1]))
    n = torch.ceil(torch.sqrt(m.clamp_min(0.0) / (8.0 * tol)))
    n = n.clamp(1, max_lines).to(torch.int32)
    n = torch.where(kind == 1, torch.ones_like(n), n)
    return torch.where(kind == 0, torch.zeros_like(n), n)


def expand_by_counts(counts: torch.Tensor, out_size: int):
    """counts (S,) -> (idx, valid, total): output slot j belongs to source
    element idx[j] (the inverse of a bump allocator); slots at or past the
    total are invalid and point at the last element."""
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    pos = torch.arange(out_size, dtype=torch.int32, device=counts.device)
    idx = torch.searchsorted(incl, pos, side="right", out_int32=True)
    idx = idx.clamp(0, max(counts.shape[0] - 1, 0))
    total = incl[-1]
    return idx, pos < total, total


def _sel7(e, v0, v1, v2, v3, v4, v5, v6):
    """7-way select on integer-valued float e in [0, 6]."""
    lo = torch.where(e < 0.5, v0, torch.where(e < 1.5, v1,
                     torch.where(e < 2.5, v2, v3)))
    hi = torch.where(e < 4.5, v4, torch.where(e < 5.5, v5, v6))
    return torch.where(e < 3.5, lo, hi)


def _rsqrt(x):
    """1 / sqrt(x), both correctly rounded (``jax.lax.rsqrt`` on XLA-CPU;
    ``torch.rsqrt`` and CUDA's ``rsqrtf`` are approximate)."""
    return 1.0 / torch.sqrt(x)


def stroke_slot_line(p0x, p0y, p1x, p1y, p2x, p2y, hw, jnx, jny, join,
                     i, e, m):
    """Device stroke expansion: line endpoints for output slot (mini i,
    edge e) of a stroked segment (the in-frame analog of the reference's
    flatten.wgsl:328-630 stroke path, as a UNION of positively oriented
    pieces so that nonzero winding composes robustly).

    Mini-line i runs P0 -> P1 (uniform-t chords of the centerline cubic);
    each mini emits 7 lines: its offset quad (edges e0-e3: left, end,
    right-reversed, start) and the bevel triangle at the P1 vertex (e4-e6)
    filling the outer notch against the NEXT mini's quad. The next
    direction comes from P2 (chord of mini i+1) inside the segment, or
    from the join normal (jnx, jny), the next segment's first-chord normal,
    at the segment boundary when ``join`` is set. Degenerate slots
    (zero-length minis, segment ends without a join, straight
    continuations) collapse to zero-length lines culled downstream. Kernel
    K1 computes the same in the same f32 op order."""
    dx = p1x - p0x
    dy = p1y - p0y
    l2 = dx * dx + dy * dy
    k = hw * _rsqrt(torch.clamp_min(l2, 1e-24))
    nx = dy * k
    ny = -dx * k
    d2x = p2x - p1x
    d2y = p2y - p1y
    l2b = d2x * d2x + d2y * d2y
    kb = hw * _rsqrt(torch.clamp_min(l2b, 1e-24))
    inner = i < m - 0.5
    n2x = torch.where(inner, d2y * kb, jnx)
    n2y = torch.where(inner, -d2x * kb, jny)
    has_tri = (inner | (join > 0.5)) & (l2 > 1e-24)
    # gap side of the vertex: sign(cross(d, d_next)) == sign(dot(d, n2))
    s = torch.where(dx * n2x + dy * n2y >= 0.0, 1.0, -1.0)
    c1x = p1x + s * nx
    c1y = p1y + s * ny
    c2x = p1x + s * n2x
    c2y = p1y + s * n2y
    # the corner order flips with the turn side, so the triangle winds as
    # the quads do
    pos = s > 0.0
    t1x = torch.where(has_tri, torch.where(pos, c1x, c2x), p1x)
    t1y = torch.where(has_tri, torch.where(pos, c1y, c2y), p1y)
    t2x = torch.where(has_tri, torch.where(pos, c2x, c1x), p1x)
    t2y = torch.where(has_tri, torch.where(pos, c2y, c1y), p1y)
    ax = _sel7(e, p0x + nx, p1x + nx, p1x - nx, p0x - nx, p1x, t1x, t2x)
    ay = _sel7(e, p0y + ny, p1y + ny, p1y - ny, p0y - ny, p1y, t1y, t2y)
    bx = _sel7(e, p1x + nx, p1x - nx, p0x - nx, p0x + nx, t1x, t2x, p1x)
    by = _sel7(e, p1y + ny, p1y - ny, p0y - ny, p0y + ny, t1y, t2y, p1y)
    # zero-length mini: collapse the whole slot group
    dead = l2 <= 1e-24
    return (torch.where(dead, p1x, ax), torch.where(dead, p1y, ay),
            torch.where(dead, p1x, bx), torch.where(dead, p1y, by))


STROKE_SLOTS = 7   # lines per stroke mini: 4 quad edges + 3 triangle edges


def stroke_mini_counts(cub, hw_dev, tol: float = FLATTEN_TOL,
                       max_lines: int = MAX_LINES_PER_SEG) -> torch.Tensor:
    """Subdivision count m per stroked segment, (S,) i32: Wang's bound on
    the centerline (chord sagitta <= tol) combined with a turning-angle
    bound keeping the bevel-corner error of the offset polyline under tol
    (hw * theta^2 / 8 <= tol per vertex; total turning bounded by the
    control-polygon exterior angles)."""
    wang = wang_counts(cub, torch.full(cub.shape[:1], 3, dtype=torch.int32,
                                       device=cub.device), tol, max_lines)
    v0 = cub[:, 1] - cub[:, 0]
    v1 = cub[:, 2] - cub[:, 1]
    v2 = cub[:, 3] - cub[:, 2]

    def ang(u, v):
        cr = torch.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0])
        dt = u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]
        ok = (_hypot(u[:, 0], u[:, 1]) > 1e-12) \
            & (_hypot(v[:, 0], v[:, 1]) > 1e-12)
        return torch.where(ok, torch.arctan2(cr, dt), 0.0)

    dtheta = ang(v0, v1) + ang(v1, v2)
    # a tensor numerator: torch turns scalar / tensor into reciprocal *
    # scalar, which rounds twice; filled on the device, so that no copy
    # from the host waits for the frame in flight
    num = torch.full((), 8.0 * tol, dtype=torch.float32, device=cub.device)
    theta_max = torch.sqrt(num / torch.clamp_min(hw_dev, tol))
    m_turn = torch.ceil(dtheta / theta_max)
    return torch.maximum(wang, m_turn).clamp(1, max_lines).to(torch.int32)


def _stroke_rows(cub, seg_hw, seg_join, max_lines: int, is_stroke=None):
    """(counts of stroked segments, is_stroke, (S, 5) f32 stroke columns
    [hw, jnx, jny, m, join]). The join normal is the NEXT segment's
    first-chord normal, computed here at segment scale so that the
    kernel's bevel corner matches the next quad's. ``is_stroke`` defaults
    to ``seg_hw > 0`` (the host-compacted segments of the fused path)."""
    if is_stroke is None:
        is_stroke = seg_hw > 0.0
    m = stroke_mini_counts(cub, seg_hw, max_lines=max_lines)
    m = torch.where(is_stroke, m, torch.zeros_like(m))
    nxt = torch.roll(cub, -1, dims=0)
    nxt_m = torch.roll(m, -1).clamp_min(1).to(torch.float32)
    tq = (1.0 / nxt_m)[:, None]
    mt = 1.0 - tq
    pn = (mt * mt * mt * nxt[:, 0] + 3 * mt * mt * tq * nxt[:, 1]
          + 3 * mt * tq * tq * nxt[:, 2] + tq * tq * tq * nxt[:, 3])
    ch = pn - nxt[:, 0]
    l2 = ch[:, 0] * ch[:, 0] + ch[:, 1] * ch[:, 1]
    kj = seg_hw * _rsqrt(torch.clamp_min(l2, 1e-24))
    joinf = ((seg_join > 0) & is_stroke & (l2 > 1e-24)).to(torch.float32)
    cols = torch.stack([seg_hw, joinf * ch[:, 1] * kj,
                        -joinf * ch[:, 0] * kj, m.to(torch.float32), joinf],
                       dim=1)
    return m * STROKE_SLOTS, is_stroke, cols


def flatten_fused(seg_pts, seg_kind, seg_path, n_segs, n_lines_cap: int,
                  width: float, height: float, rects, seg_hw=None,
                  seg_join=None, max_lines: int = MAX_LINES_PER_SEG) -> dict:
    """Host-compacted, transform-folded segments -> the (16, L) line pack
    [qx0, qy0, qx1, qy1, down, tcount, live, crossing, ev_y0, ev_y1,
    rect6] (see ``kernels.flatten_lines``). ``rects``: the per-path tile
    rects of ``tiling.tile_alloc``. With ``seg_hw`` (S,) f32 half-widths
    (pre-scaled by the host; 0 for a filled segment) and ``seg_join`` (S,)
    i32 continuation flags, stroked segments emit 7 lines per centerline
    mini (device stroke expansion). Returns {"linepack", "total_lines",
    "overflow"}; overflow is 1 when the lines exceed the cap."""
    spack, incl = kernels.segment_prep(seg_pts, seg_kind, seg_path, n_segs,
                                       rects, seg_hw, seg_join, max_lines)
    total = incl[-1]
    linepack = kernels.flatten_lines(spack, incl, n_lines_cap, width, height)
    return {"linepack": linepack, "total_lines": total,
            "overflow": (total > n_lines_cap).to(torch.int32)}


def _cubic_at(c, t):
    """Points of the cubics c (L, 4, 2) at t (L,), in the JAX package's op
    order (``mt ** 3`` is ``mt * mt * mt`` there too)."""
    t = t[:, None]
    mt = 1.0 - t
    return (mt * mt * mt * c[:, 0] + 3 * mt * mt * t * c[:, 1]
            + 3 * mt * t * t * c[:, 2] + t * t * t * c[:, 3])


def flatten(decoded: dict, n_lines_cap: int, n_edge_cap: int, width: float,
            height: float, rpack=None, has_stroke: bool = False,
            max_lines: int = MAX_LINES_PER_SEG) -> dict:
    """The unfused flatten: ``pathtag.decode_and_transform``'s tag slots
    -> the y-trimmed, x-clamped line soup and its left-edge verticals
    (``vello_tpu/ops/flatten.py`` ``flatten``).

    ``rpack`` (P, 6) f32, optional: per-path tile-rect fields, gathered at
    segment scale and carried along the line expansion (``line_rect``,
    ``edge_rect``). ``has_stroke``: ``decoded`` carries "hw" and "join",
    and stroked segments emit 7 lines per centerline mini
    (``stroke_slot_line``).

    Returns {"lines" (L, 4) f32 (x0, y0, x1, y1), "line_path" (L,) i32
    (2**30 for a dead line), "line_valid" (L,) bool, "line_real" (L,) bool
    (a real slot, even if degenerate), "edge_lines" (E, 4), "edge_path",
    "edge_valid", "overflow" (lines over the cap 1, edges over the cap 2)
    [, "line_rect" (L, 6), "edge_rect" (E, 6)]}."""
    kind = decoded["kind"]
    cub = elevate_to_cubic(decoded["points"], kind)
    counts = wang_counts(cub, kind, max_lines=max_lines)
    s = cub.shape[0]
    path_ix = decoded["path_ix"]
    if has_stroke:
        st_counts, is_stroke, scols = _stroke_rows(
            cub, decoded["hw"], decoded["join"], max_lines,
            is_stroke=(decoded["hw"] > 0.0) & (kind > 0))
        counts = torch.where(is_stroke, st_counts, counts)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    parts = [cub.reshape(s, 8), counts.to(torch.float32)[:, None],
             (incl - counts).to(torch.float32)[:, None],
             path_ix.to(torch.float32)[:, None]]
    if rpack is not None:
        pclip = path_ix.long().clamp(0, rpack.shape[0] - 1)
        parts.append(rpack[pclip])                        # (S, 6)
    if has_stroke:
        parts.append(scols)
    pack = torch.cat(parts, dim=1)                        # (S, 11[+6][+5])
    seg_ix, valid, total = expand_by_counts(counts, n_lines_cap)
    overflow_lines = (total > n_lines_cap).to(torch.int32)

    row = pack[seg_ix.long()]                             # (L, 11+)
    c = row[:, :8].reshape(-1, 4, 2)
    n = torch.clamp_min(row[:, 8], 1.0)
    sub_f = torch.arange(n_lines_cap, dtype=torch.float32,
                         device=cub.device) - row[:, 9]
    t0 = sub_f / n
    t1 = (sub_f + 1.0) / n
    row_path = row[:, 10].to(torch.int32)
    if has_stroke:
        sbase = pack.shape[1] - 5
        mrow = row[:, sbase + 3]
        st = mrow > 0.5
        msafe = torch.clamp_min(mrow, 1.0)
        si = torch.floor((sub_f + 0.5) * (1.0 / STROKE_SLOTS))
        se = sub_f - STROKE_SLOTS * si
        t0 = torch.where(st, si / msafe, t0)
        t1 = torch.where(st, (si + 1.0) / msafe, t1)
    p0 = _cubic_at(c, t0)
    p1 = _cubic_at(c, t1)
    if has_stroke:
        p2 = _cubic_at(c, (si + 2.0) / msafe)
        ax, ay, bx, by = stroke_slot_line(
            p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1],
            row[:, sbase], row[:, sbase + 1], row[:, sbase + 2],
            row[:, sbase + 4], si, se, msafe)
        p0 = torch.stack([torch.where(st, ax, p0[:, 0]),
                          torch.where(st, ay, p0[:, 1])], dim=-1)
        p1 = torch.stack([torch.where(st, bx, p1[:, 0]),
                          torch.where(st, by, p1[:, 1])], dim=-1)

    # y trim (parametric; untrimmed endpoints stay bit-identical)
    zero = torch.zeros((), dtype=torch.float32, device=cub.device)
    one = torch.ones((), dtype=torch.float32, device=cub.device)
    y0, y1 = p0[:, 1], p1[:, 1]
    dy = y1 - y0
    y0c = y0.clamp(0.0, height)
    y1c = y1.clamp(0.0, height)
    nzy = torch.abs(dy) > 1e-12
    inv_dy = torch.where(nzy, 1.0 / torch.where(nzy, dy, one), zero)
    ta = torch.where(nzy, (y0c - y0) * inv_dy, zero)
    tb = torch.where(nzy, (y1c - y0) * inv_dy, one)
    x0 = torch.where(y0c != y0, p0[:, 0] + ta * (p1[:, 0] - p0[:, 0]),
                     p0[:, 0])
    x1 = torch.where(y1c != y1, p0[:, 0] + tb * (p1[:, 0] - p0[:, 0]),
                     p1[:, 0])
    y0, y1 = y0c, y1c
    alive = valid & (torch.abs(y1 - y0) + torch.abs(x1 - x0) > 1e-12)

    # x clamp; the clipped-off winding of a line crossing x = lo becomes a
    # left-edge vertical
    lo = EDGE_EPS
    hi = max(width - EDGE_EPS, lo + 1e-3)
    x0c = x0.clamp(lo, hi)
    x1c = x1.clamp(lo, hi)
    dx = x1 - x0
    nzx = torch.abs(dx) > 1e-12
    inv_dx = torch.where(nzx, 1.0 / torch.where(nzx, dx, one), zero)
    u0 = torch.where(nzx, ((x0c - x0) * inv_dx).clamp(0.0, 1.0), zero)
    u1 = torch.where(nzx, ((x1c - x0) * inv_dx).clamp(0.0, 1.0), one)
    ye0 = y0 + u0 * (y1 - y0)
    ye1 = y0 + u1 * (y1 - y0)
    outside = (torch.maximum(x0, x1) <= lo) | (torch.minimum(x0, x1) >= hi)
    my0 = torch.where(outside | (x0c == x0), y0, ye0)
    my1 = torch.where(outside | (x1c == x1), y1, ye1)
    mid = torch.where(alive[:, None], torch.stack([x0c, my0, x1c, my1],
                                                  dim=-1), 0.0)
    crossing = alive & nzx & (torch.minimum(x0, x1) < lo) \
        & (torch.maximum(x0, x1) > lo)
    need_start = crossing & (x0 < x1)
    ev_y0 = torch.where(need_start, y0, ye1)
    ev_y1 = torch.where(need_start, ye0, y1)
    eparts = [torch.stack([ev_y0, ev_y1, row_path.to(torch.float32)],
                          dim=-1)]
    if rpack is not None:
        eparts.append(row[:, 11:17])
    epack = torch.cat(eparts, dim=1)
    eix, evalid, etotal = expand_by_counts(crossing.to(torch.int32),
                                           n_edge_cap)
    overflow_edges = (etotal > n_edge_cap).to(torch.int32)
    erow = epack[eix.long()]
    lof = torch.full_like(erow[:, 0], lo)
    edge_lines = torch.where(evalid[:, None], torch.stack(
        [lof, erow[:, 0], lof, erow[:, 1]], dim=-1), 0.0)
    dead = torch.full_like(row_path, 2 ** 30)
    out = {
        "lines": mid,
        "line_path": torch.where(alive, row_path, dead),
        "line_valid": alive,
        "line_real": valid,
        "edge_lines": edge_lines,
        "edge_path": torch.where(evalid, erow[:, 2].to(torch.int32),
                                 torch.full_like(eix, 2 ** 30)),
        "edge_valid": evalid,
        "overflow": overflow_lines + 2 * overflow_edges,
    }
    if rpack is not None:
        out["line_rect"] = row[:, 11:17]
        out["edge_rect"] = erow[:, 3:9]
    return out
