"""Host-side (numpy) flatten — shared by the CPU oracle and the capacity
estimator. Exact mirror of the device flatten math (ops/flatten.py)."""

from __future__ import annotations

import numpy as np

from .config import FLATTEN_TOL, MAX_LINES_PER_SEG


def elevate_to_cubic(points: np.ndarray, kind: np.ndarray) -> np.ndarray:
    """Degree-elevate lines/quads to cubics. points (S,4,2), kind (S,)."""
    p0 = points[:, 0]
    out = np.empty_like(points)
    out[:, 0] = p0
    # line: p1 slot holds the end point
    line_p1 = points[:, 1]
    quad_c, quad_p2 = points[:, 1], points[:, 2]
    cub = points
    k = kind[:, None]
    c1 = np.where(k == 1, p0 + (line_p1 - p0) / 3.0,
                  np.where(k == 2, p0 + 2.0 / 3.0 * (quad_c - p0), cub[:, 1]))
    c2 = np.where(k == 1, p0 + 2.0 / 3.0 * (line_p1 - p0),
                  np.where(k == 2, quad_p2 + 2.0 / 3.0 * (quad_c - quad_p2),
                           cub[:, 2]))
    p3 = np.where(k == 1, line_p1, np.where(k == 2, quad_p2, cub[:, 3]))
    out[:, 1] = c1
    out[:, 2] = c2
    out[:, 3] = p3
    return out


def wang_counts(cubics: np.ndarray, kind: np.ndarray, tol: float,
                max_lines: int) -> np.ndarray:
    d1 = cubics[:, 0] - 2 * cubics[:, 1] + cubics[:, 2]
    d2 = cubics[:, 1] - 2 * cubics[:, 2] + cubics[:, 3]
    m = 6.0 * np.maximum(np.hypot(d1[..., 0], d1[..., 1]),
                         np.hypot(d2[..., 0], d2[..., 1]))
    n = np.ceil(np.sqrt(np.maximum(m, 0.0) / (8.0 * tol)))
    n = np.clip(n, 1, max_lines).astype(np.int64)
    return np.where(kind == 1, 1, n)


def transform_points(points: np.ndarray, tmat: np.ndarray) -> np.ndarray:
    x = (points[..., 0] * tmat[:, None, 0] + points[..., 1] * tmat[:, None, 2]
         + tmat[:, None, 4])
    y = (points[..., 0] * tmat[:, None, 1] + points[..., 1] * tmat[:, None, 3]
         + tmat[:, None, 5])
    return np.stack([x, y], axis=-1)


STROKE_SLOTS = 7   # must match ops/flatten.py


def stroke_mini_counts_np(cub, hw_dev, tol, max_lines):
    """numpy mirror of ops/flatten.stroke_mini_counts."""
    wang = wang_counts(cub, np.full(len(cub), 3, np.int32), tol, max_lines)
    v0 = cub[:, 1] - cub[:, 0]
    v1 = cub[:, 2] - cub[:, 1]
    v2 = cub[:, 3] - cub[:, 2]

    def ang(u, v):
        cr = np.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0])
        dt = u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]
        ok = (np.hypot(u[:, 0], u[:, 1]) > 1e-12) \
            & (np.hypot(v[:, 0], v[:, 1]) > 1e-12)
        return np.where(ok, np.arctan2(cr, dt), 0.0)

    dtheta = ang(v0, v1) + ang(v1, v2)
    theta_max = np.sqrt(8.0 * tol / np.maximum(hw_dev, tol))
    m_turn = np.ceil(dtheta / theta_max)
    return np.clip(np.maximum(wang, m_turn), 1, max_lines).astype(np.int64)


def _stroke_lines_np(p0, p1, p2, hw, jn, join, i, e, m):
    """numpy mirror of ops/flatten.stroke_slot_line (f64). Select logic is
    where-chained per coordinate — the candidate-stack + fancy-index
    formulation allocated (L, 7, 2) f64 tensors (~9 s at mmark-30k)."""
    dx = p1[:, 0] - p0[:, 0]
    dy = p1[:, 1] - p0[:, 1]
    l2 = dx * dx + dy * dy
    k = hw / np.sqrt(np.maximum(l2, 1e-24))
    nx = dy * k
    ny = -dx * k
    d2x = p2[:, 0] - p1[:, 0]
    d2y = p2[:, 1] - p1[:, 1]
    l2b = d2x * d2x + d2y * d2y
    kb = hw / np.sqrt(np.maximum(l2b, 1e-24))
    inner = i < m - 0.5
    n2x = np.where(inner, d2y * kb, jn[:, 0])
    n2y = np.where(inner, -d2x * kb, jn[:, 1])
    has_tri = (inner | (join > 0.5)) & (l2 > 1e-24)
    s = np.where(dx * n2x + dy * n2y >= 0.0, 1.0, -1.0)
    c1x = p1[:, 0] + s * nx
    c1y = p1[:, 1] + s * ny
    c2x = p1[:, 0] + s * n2x
    c2y = p1[:, 1] + s * n2y
    pos = s > 0.0
    t1x = np.where(pos, c1x, c2x)
    t1y = np.where(pos, c1y, c2y)
    t2x = np.where(pos, c2x, c1x)
    t2y = np.where(pos, c2y, c1y)
    t1x = np.where(has_tri, t1x, p1[:, 0])
    t1y = np.where(has_tri, t1y, p1[:, 1])
    t2x = np.where(has_tri, t2x, p1[:, 0])
    t2y = np.where(has_tri, t2y, p1[:, 1])

    def sel7(v0, v1, v2, v3, v4, v5, v6):
        lo = np.where(e < 0.5, v0, np.where(e < 1.5, v1,
                      np.where(e < 2.5, v2, v3)))
        hi = np.where(e < 4.5, v4, np.where(e < 5.5, v5, v6))
        return np.where(e < 3.5, lo, hi)

    p0x, p0y = p0[:, 0], p0[:, 1]
    p1x, p1y = p1[:, 0], p1[:, 1]
    ax = sel7(p0x + nx, p1x + nx, p1x - nx, p0x - nx, p1x, t1x, t2x)
    ay = sel7(p0y + ny, p1y + ny, p1y - ny, p0y - ny, p1y, t1y, t2y)
    bx = sel7(p1x + nx, p1x - nx, p0x - nx, p0x + nx, t1x, t2x, p1x)
    by = sel7(p1y + ny, p1y - ny, p0y - ny, p0y + ny, t1y, t2y, p1y)
    dead = l2 <= 1e-24
    ax = np.where(dead, p1x, ax)
    ay = np.where(dead, p1y, ay)
    bx = np.where(dead, p1x, bx)
    by = np.where(dead, p1y, by)
    return (np.stack([ax, ay], -1), np.stack([bx, by], -1))


def max_lines_for_wang_m(m_max: float, tol=FLATTEN_TOL,
                         cap: int = 2048) -> int:
    """Subdivision cap from the largest Wang second-difference magnitude:
    next power of two >= the unclamped Wang count (>= the default
    MAX_LINES_PER_SEG, <= cap)."""
    top = float(np.sqrt(m_max / (8.0 * tol))) if m_max > 0 else 0.0
    need = MAX_LINES_PER_SEG
    while need < top and need < cap:
        need *= 2
    return need


def required_max_lines(cub, kind, tol=FLATTEN_TOL, cap: int = 2048):
    """Per-segment subdivision cap needed to honor the flatten tolerance:
    next power of two >= the largest unclamped Wang count (>= the default
    MAX_LINES_PER_SEG, <= cap). The resolver raises the frame's cap from
    this instead of silently coarsening pathological segments."""
    if len(kind) == 0:
        return MAX_LINES_PER_SEG
    d1 = cub[:, 0] - 2 * cub[:, 1] + cub[:, 2]
    d2 = cub[:, 1] - 2 * cub[:, 2] + cub[:, 3]
    m = 6.0 * np.maximum(np.hypot(d1[:, 0], d1[:, 1]),
                         np.hypot(d2[:, 0], d2[:, 1]))
    m = np.where(kind > 1, m, 0.0)
    return max_lines_for_wang_m(float(m.max()) if len(m) else 0.0, tol,
                                cap)


def flatten_decoded(decoded, tol: float = FLATTEN_TOL,
                    max_lines: int = MAX_LINES_PER_SEG):
    """Flatten decoded segments to lines. Returns (lines (N,4) f32, path_ix).

    Stroked segments (decoded["hw"] > 0, device-space half-widths applied
    by the caller or raw + transform det here) expand with the same
    quad+bevel scheme as the device (ops/flatten.stroke_slot_line)."""
    kind = decoded["kind"]
    if len(kind) == 0:
        return np.zeros((0, 4), np.float32), np.zeros(0, np.int32)
    tmat = decoded["transform"].astype(np.float64)
    pts = transform_points(decoded["points"].astype(np.float64), tmat)
    cub = elevate_to_cubic(pts, kind)
    # auto-raise the per-segment cap for pathological segments (huge single
    # curves): matches the device, whose PipelineStatic.max_lines the
    # resolver raises from the same unclamped Wang bound
    max_lines = max(max_lines, required_max_lines(cub, kind, tol))
    counts = wang_counts(cub, kind, tol, max_lines)
    hw_raw = decoded.get("hw")
    has_stroke = hw_raw is not None and len(hw_raw) and (hw_raw > 0).any()
    if has_stroke:
        det = tmat[:, 0] * tmat[:, 3] - tmat[:, 1] * tmat[:, 2]
        hw_dev = hw_raw.astype(np.float64) * np.sqrt(np.abs(det))
        is_stroke = (hw_dev > 0) & (kind > 0)
        m = stroke_mini_counts_np(cub, hw_dev, tol, max_lines)
        m = np.where(is_stroke, m, 0)
        counts = np.where(is_stroke, m * STROKE_SLOTS, counts)
        # join normal: next segment's first-chord normal
        nxt = np.roll(cub, -1, axis=0)
        nxt_m = np.maximum(np.roll(m, -1), 1).astype(np.float64)
        tq = (1.0 / nxt_m)[:, None]
        mtq = 1.0 - tq
        pn = (mtq ** 3 * nxt[:, 0] + 3 * mtq * mtq * tq * nxt[:, 1]
              + 3 * mtq * tq * tq * nxt[:, 2] + tq ** 3 * nxt[:, 3])
        ch = pn - nxt[:, 0]
        l2j = (ch ** 2).sum(-1)
        kj = hw_dev / np.sqrt(np.maximum(l2j, 1e-24))
        joinf = ((decoded["join"] > 0) & is_stroke & (l2j > 1e-24))
        jn_all = np.stack([ch[:, 1] * kj, -ch[:, 0] * kj], -1) \
            * joinf[:, None]
    offs = np.cumsum(counts) - counts
    total = int(counts.sum())
    # expand: for each line slot, its segment and sub index
    seg_of = np.searchsorted(np.cumsum(counts), np.arange(total), side="right")
    sub = np.arange(total) - offs[seg_of]
    n = counts[seg_of].astype(np.float64)
    t0 = sub / n
    t1 = (sub + 1) / n
    c = cub[seg_of]

    if has_stroke:
        st = is_stroke[seg_of]
        msafe = np.maximum(m[seg_of], 1).astype(np.float64)
        si = np.floor((sub + 0.5) / STROKE_SLOTS)
        se = sub - STROKE_SLOTS * si
        t0 = np.where(st, si / msafe, t0)
        t1 = np.where(st, (si + 1.0) / msafe, t1)

    def ev(t):
        t = t[:, None]
        mt = 1.0 - t
        return (mt ** 3 * c[:, 0] + 3 * mt * mt * t * c[:, 1]
                + 3 * mt * t * t * c[:, 2] + t ** 3 * c[:, 3])

    p0 = ev(t0)
    p1 = ev(t1)
    if has_stroke:
        p2 = ev((si + 2.0) / msafe)
        a, b = _stroke_lines_np(p0, p1, p2, hw_dev[seg_of], jn_all[seg_of],
                                joinf[seg_of].astype(np.float64), si, se,
                                msafe)
        p0 = np.where(st[:, None], a, p0)
        p1 = np.where(st[:, None], b, p1)
    lines = np.concatenate([p0, p1], axis=-1).astype(np.float32)
    return lines, decoded["path_ix"][seg_of]


