"""Fine rasterization, plain PyTorch (counterpart of
``vello_tpu/ops/fine_xla.py``: area and msaa coverage, solid composite).

These are the plain versions of kernels K3 (sample-mask msaa coverage),
K4 (ordered src-over of solid colors) and K5 (exact-area coverage);
``ops/kernels.py`` runs them for tensors on the CPU and holds the CUDA
kernels against them on the GPU.
"""

from __future__ import annotations

import torch

from ..encoding.config import TILE_H, TILE_W

NPX = TILE_H * TILE_W  # 256 pixels per tile

# D3D11 standard sample patterns (the reference builds its half-plane mask
# LUTs from these positions); sample i sits at ((pat[i]+0.5)/n, (i+0.5)/n)
# within the pixel.
MSAA8_PATTERN = (0, 5, 3, 7, 1, 4, 6, 2)
MSAA16_PATTERN = (1, 8, 4, 11, 15, 7, 3, 12, 0, 9, 5, 13, 2, 10, 6, 14)

# output rows per chunk of msaa_coverage_plain: bounds its (touches,
# ns*256) delta tensor to a few hundred MB
_ROWS_PER_CHUNK = 2048


def sample_offsets(ns: int):
    pat = MSAA8_PATTERN if ns == 8 else MSAA16_PATTERN
    return [((pat[i] + 0.5) / ns, (i + 0.5) / ns) for i in range(ns)]


def _sample_xy(ns: int, device):
    """(ns*256,) f32 sample coordinates; column s*256+px is sample s of
    tile pixel px (all values exact in f32)."""
    offs = torch.tensor(sample_offsets(ns), dtype=torch.float64)
    lin = torch.arange(ns * NPX)
    px = (lin % NPX) % TILE_W
    py = (lin % NPX) // TILE_W
    s = lin // NPX
    sx = (px + offs[s, 0]).to(torch.float32)
    sy = (py + offs[s, 1]).to(torch.float32)
    return sx.to(device), sy.to(device)


def apply_fill_rule(winding, rule):
    """rule 0 nonzero, 1 even-odd (broadcast against winding)."""
    nz = torch.clamp_max(torch.abs(winding), 1.0)
    eo = torch.abs(winding - 2.0 * torch.round(0.5 * winding))
    return torch.where(rule == 1, eo, nz)


def _pixel_iota(device):
    """(1, 256) tile-local pixel corner coords (px, py)."""
    lin = torch.arange(NPX, dtype=torch.float32, device=device)[None]
    return torch.remainder(lin, TILE_W), torch.floor(lin / TILE_W)


def coverage_delta(seg, y_edge):
    """Per-pixel winding contribution of tile-local segments: the exact-area
    term of ``fine.wgsl`` ``fill_path`` plus the left-edge y_edge term.
    seg (N, 4) tile-local (x0, y0, x1, y1) in original orientation, y_edge
    (N,) (1e9 if none) -> (N, 256) f32.

    The f32 op order is that of the JAX package's Pallas kernel
    (``pallas_kernels._cov_kernel``), which kernel K5 keeps too. The
    ``dyc != 0`` test selects rather than multiplies: ``a`` can be inf
    where ``dyc`` is 0."""
    px, py = _pixel_iota(seg.device)
    p0x, p0y, p1x, p1y = (seg[:, k:k + 1] for k in range(4))
    dx = p1x - p0x
    dy = p1y - p0y
    y = p0y - py
    y0 = torch.clamp(y, 0.0, 1.0)
    y1 = torch.clamp(y + dy, 0.0, 1.0)
    dyc = y0 - y1
    inv_dy = 1.0 / torch.where(dy == 0.0, torch.ones_like(dy), dy)
    t0 = (y0 - y) * inv_dy
    t1 = (y1 - y) * inv_dy
    startx = p0x - px
    x0 = startx + t0 * dx
    x1 = startx + t1 * dx
    xmin = torch.clamp_max(torch.minimum(x0, x1), 1.0) - 1e-6
    xmax = torch.maximum(x0, x1)
    b = torch.clamp_max(xmax, 1.0)
    c = torch.clamp_min(b, 0.0)
    d = torch.clamp_min(xmin, 0.0)
    a = (b + 0.5 * (d * d - c * c) - xmin) / (xmax - xmin)
    area = torch.where(dyc != 0.0, a * dyc, torch.zeros((), device=seg.device))
    ye = y_edge[:, None]
    return area + torch.sign(dx) * torch.clamp(py - ye + 1.0, 0.0, 1.0)


def coverage_area_plain(trow, starts, backdrop, rule, valid, centers: bool):
    """Plain version of kernel K5: the area coverage of every fragment.

    trow (T, 8) f32 touches sorted by fragment [x0, y0, x1, y1, y_edge,
    ..]; fragment f owns touches [starts[f], starts[f+1]). Per pixel: the
    ``coverage_delta`` rows of those touches summed in stream order, plus
    backdrop[f], then the fill rule (rule[f]: 0 nonzero, 1 even-odd), then
    with ``centers`` the threshold ``>= 0.5 -> 1 else 0``. Invalid
    fragments give 0. Returns (F, 256) f32.

    The JAX package differences a running cumsum over the whole stream
    instead; this direct sum is what that difference approximates."""
    dev = trow.device
    f_all = backdrop.shape[0]
    out = torch.zeros((f_all, NPX), dtype=torch.float32, device=dev)
    for f0 in range(0, f_all, _ROWS_PER_CHUNK):
        f1 = min(f0 + _ROWS_PER_CHUNK, f_all)
        lo = starts[f0:f1].long()
        cnt = starts[f0 + 1:f1 + 1].long() - lo
        t_lo, t_hi = int(starts[f0]), int(starts[f1])
        sums = torch.zeros((f1 - f0, NPX), dtype=torch.float32, device=dev)
        if t_hi > t_lo:
            t = trow[t_lo:t_hi]
            delta = coverage_delta(t[:, :4], t[:, 4])
            # k-th touch of every fragment at once: the same sequential
            # order of additions as the kernel's per-thread loop
            for k in range(int(cnt.max())):
                row = (lo - t_lo + k).clamp_max(t_hi - t_lo - 1)
                sums = sums + torch.where((k < cnt)[:, None], delta[row],
                                          0.0)
        cov = apply_fill_rule(backdrop[f0:f1, None] + sums,
                              rule[f0:f1, None])
        if centers:
            cov = torch.where(cov >= 0.5, 1.0, 0.0)
        out[f0:f1] = torch.where(valid[f0:f1, None], cov, 0.0)
    return out


def coverage_delta_msaa(seg, y_edge, ns: int):
    """Per-sample winding deltas of tile-local segments: the signed count
    of segments crossing each sample's leftward ray (y-range half-open
    [ymin, ymax)) plus the left-edge y_edge term. seg (N, 4), y_edge (N,)
    -> (N, ns*256) f32.

    The crossing x is computed as ``x0 + (sy - y0) * (inv_dy * dx)``, the
    op order of the JAX package's Pallas kernel (``_msaa_block``), which the
    frame's coverage is held to; ``fine_xla.coverage_delta_msaa`` rounds
    ``(sy - y0) * inv_dy`` first."""
    sx, sy = _sample_xy(ns, seg.device)
    sx, sy = sx[None], sy[None]
    x0, y0, x1, y1 = (seg[:, k:k + 1] for k in range(4))
    dx = x1 - x0
    dy = y1 - y0
    ymin = torch.minimum(y0, y1)
    ymax = torch.maximum(y0, y1)
    inv_dy = 1.0 / torch.where(dy == 0.0, torch.ones_like(dy), dy)
    sgn = torch.where(dy > 0.0, -1.0, 1.0)
    sgn_dx = torch.sign(dx)
    a = inv_dy * dx
    xt = x0 + (sy - y0) * a
    crossing = (sy >= ymin) & (sy < ymax)
    zero = torch.zeros((), dtype=torch.float32, device=seg.device)
    return (torch.where(crossing & (xt < sx), sgn, zero)
            + torch.where(sy >= y_edge[:, None], sgn_dx, zero))


def msaa_coverage_plain(trow, starts, fidx, backdrop, rule, valid, ns: int,
                        has_evenodd: bool = True):
    """Plain version of kernel K3: coverage rows for fragments ``fidx``.

    trow (T, 8) f32 touches sorted by fragment [x0, y0, x1, y1, y_edge, ..];
    fragment f owns touches [starts[f], starts[f+1]). Per sample: winding =
    backdrop[f] + the touches' deltas, then the fill rule, then the box
    resolve k/ns. Invalid fragments give 0. Returns (N, 256) f32."""
    dev = trow.device
    n = fidx.shape[0]
    out = torch.zeros((n, NPX), dtype=torch.float32, device=dev)
    for i0 in range(0, n, _ROWS_PER_CHUNK):
        f = fidx[i0:i0 + _ROWS_PER_CHUNK].long()
        m = f.shape[0]
        lo = starts[f].long()
        cnt = starts[f + 1].long() - lo
        sums = torch.zeros((m, ns * NPX), dtype=torch.float32, device=dev)
        total = int(cnt.sum())
        if total:
            row = torch.repeat_interleave(torch.arange(m, device=dev), cnt,
                                          output_size=total)
            first = torch.cumsum(cnt, 0) - cnt
            tix = lo[row] + torch.arange(total, device=dev) - first[row]
            t = trow[tix]
            sums.index_add_(0, row, coverage_delta_msaa(t[:, :4], t[:, 4],
                                                        ns))
        w = sums.reshape(m, ns, NPX) + backdrop[f][:, None, None]
        r = rule[f][:, None, None] if has_evenodd else torch.zeros_like(
            rule[f][:, None, None])
        cov = apply_fill_rule(w, r).sum(1) / ns
        out[i0:i0 + m] = torch.where(valid[f][:, None], cov, 0.0)
    return out


def composite_solid_plain(cov, col, base_premul, los, his):
    """Plain version of kernel K4: per tile g, the ordered src-over of
    fragments [los[g], his[g]) onto the premultiplied base color,
    dst = col * cov + (1 - col.a * cov) * dst (the sequential walk of
    fine.wgsl). cov (F, 256), col (F, 4) premultiplied -> (G, 4, 256)."""
    g = los.shape[0]
    dst = base_premul[None, :, None].expand(g, 4, NPX).clone()
    n = (his - los).clamp_min(0)
    kmax = int(n.max()) if g else 0
    for k in range(kmax):
        j = (los.long() + k).clamp_max(cov.shape[0] - 1)
        c = cov[j][:, None, :]                            # (G, 1, 256)
        cl = col[j][:, :, None]                           # (G, 4, 1)
        upd = cl * c + (1.0 - cl[:, 3:4] * c) * dst
        dst = torch.where((k < n)[:, None, None], upd, dst)
    return dst
