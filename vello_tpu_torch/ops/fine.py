"""Fine rasterization, plain PyTorch (counterpart of
``vello_tpu/ops/fine_xla.py``: area and msaa coverage, paint evaluation,
composites).

These are the plain versions of kernels K3 (sample-mask msaa coverage),
K4 (ordered src-over of solid colors), K5 (exact-area coverage) and K6
(ordered src-over of materialized src rows); ``ops/kernels.py`` runs them
for tensors on the CPU and holds the CUDA kernels against them on the GPU.
``eval_paints`` is library PyTorch on whichever device its tensors are on
(in the JAX package it is XLA, not a Pallas kernel).
"""

from __future__ import annotations

import torch

from ..encoding.config import TILE_H, TILE_W
from ..encoding.resolve import (PAINT_BLUR_RECT, PAINT_GRADIENT,
                                PAINT_IMAGE)
from .blur import blurred_rounded_rect_coverage
from .paint import (apply_extend_dynamic, cubic_weights, linear_t, radial_t,
                    sweep_t)

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


def fma(a, b, c):
    """The correctly rounded f32 ``a * b + c`` (one rounding, as CUDA's
    ``__fmaf_rn``): the f64 product is exact, the f64 sum is rounded to
    odd (its error, exact by TwoSum, moves an inexact even sum one ulp
    towards it), and rounding that to f32 is then correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err != 0) & even, odd, s).float()


def coverage_delta(seg, y_edge):
    """Per-pixel winding contribution of tile-local segments: the exact-area
    term of ``fine.wgsl`` ``fill_path`` plus the left-edge y_edge term.
    seg (N, 4) tile-local (x0, y0, x1, y1) in original orientation, y_edge
    (N,) (1e9 if none) -> (N, 256) f32.

    The f32 op order is that of the JAX package's Pallas kernel
    (``pallas_kernels._cov_kernel``), which kernel K5 keeps too, with the
    two fused multiply-adds that XLA contracts wherever the JAX package
    compiles this formula (``x0 = fma(t0, dx, startx)``, and
    ``d * d - c * c`` as ``fma(d, d, -(c * c))``): for an exactly vertical
    touch the area term divides two differences of about 1e-6, which
    rounding moves by up to 0.06, and the JAX package's frames and
    goldens carry the fused rounding. The ``dyc != 0`` test selects rather
    than multiplies: ``a`` can be inf where ``dyc`` is 0."""
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
    x0 = fma(t0, dx, startx)
    x1 = fma(t1, dx, startx)
    xmin = torch.clamp_max(torch.minimum(x0, x1), 1.0) - 1e-6
    xmax = torch.maximum(x0, x1)
    b = torch.clamp_max(xmax, 1.0)
    c = torch.clamp_min(b, 0.0)
    d = torch.clamp_min(xmin, 0.0)
    a = (b + 0.5 * fma(d, d, -(c * c)) - xmin) / (xmax - xmin)
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


def composite_src_plain(src, base_premul, los, his):
    """Plain version of kernel K6: per tile g, the ordered src-over of the
    premultiplied src rows [los[g], his[g]) onto the premultiplied base
    color, dst = src + (1 - src.a) * dst (the sequential walk of
    fine.wgsl). src (F, 4, 256) f32, or bf16 (render_mode "speed"), each
    row widened to f32 as the Pallas kernel does -> (G, 4, 256) f32."""
    g = los.shape[0]
    dst = base_premul[None, :, None].expand(g, 4, NPX).clone()
    n = (his - los).clamp_min(0)
    kmax = int(n.max()) if g else 0
    for k in range(kmax):
        j = (los.long() + k).clamp_max(src.shape[0] - 1)
        s = src[j].float()                                # (G, 4, 256)
        upd = s + (1.0 - s[:, 3:4]) * dst
        dst = torch.where((k < n)[:, None, None], upd, dst)
    return dst


def composite_over_plain(src, dst, los, his):
    """Plain version of kernel K7: per tile g, the ordered src-over of the
    premultiplied src rows [los[g], his[g]) onto the tile's current value
    in ``dst``, dst = src + (1 - src.a) * dst, IN PLACE (the layered
    draws op; tiles with an empty walk are neither read nor written).
    src (F, 4, 256) f32, or bf16 widened to f32 row by row; dst (G, 4, 256)
    f32. Returns dst."""
    n = (his - los).clamp_min(0)
    tiles = torch.nonzero(n > 0).flatten()
    if tiles.numel() == 0:
        return dst
    d = dst[tiles]
    lo, n = los[tiles].long(), n[tiles]
    for k in range(int(n.max())):
        s = src[(lo + k).clamp_max(src.shape[0] - 1)].float()
        upd = s + (1.0 - s[:, 3:4]) * d
        d = torch.where((k < n)[:, None, None], upd, d)
    dst[tiles] = d
    return dst


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _texels(planes, idx):
    """Texels of a channel-planar (4, M) table at indices idx (N, 256), as
    (N, 4, 256): one 1-D gather per channel. (A row gather of the (M, 4)
    table, as the JAX package writes it, moves 16-byte rows and ran at a
    few percent of memory speed on the H100.)"""
    idx = idx.long()
    return torch.stack([planes[c][idx] for c in range(4)], dim=1)


def eval_paints(tile_px, tile_py, paint_kind, color, grad_rec, paint_inv,
                image_rec, blur_rec, ramps, atlas, kinds_present):
    """Per-fragment paints, channel-planar (``fine_xla.eval_paints``).

    tile_px/tile_py (N,) f32 tile origins in pixels; paint_kind (N,) i32;
    color (N, 4) premultiplied; grad_rec (N, 12), paint_inv (N, 6),
    image_rec (N, 8), blur_rec (N, 8) the paint records; ramps (R, 512, 4)
    straight-alpha LUTs; atlas (H, W, 4) the image atlas. kinds_present
    names the paint kinds that occur, with 10 + quality for each image
    quality (10 nearest, 11 bilinear, 12 bicubic): absent kinds are not
    evaluated. Every present kind is evaluated for every fragment and the
    fragment's own is selected. Returns (N, 4, 256) premultiplied RGBA."""
    n = tile_px.shape[0]
    out = color[:, :, None].expand(n, 4, NPX)
    if not any(k in kinds_present
               for k in (PAINT_GRADIENT, PAINT_IMAGE, PAINT_BLUR_RECT)):
        return out
    px, py = _pixel_iota(tile_px.device)
    gx = tile_px[:, None] + px + 0.5
    gy = tile_py[:, None] + py + 0.5
    inv = paint_inv
    lx = gx * inv[:, 0, None] + gy * inv[:, 2, None] + inv[:, 4, None]
    ly = gx * inv[:, 1, None] + gy * inv[:, 3, None] + inv[:, 5, None]

    if PAINT_GRADIENT in kinds_present:
        g = grad_rec

        def f(k):
            return g[:, k, None]

        kindg = f(0)
        t_lin = linear_t(lx, ly, f(2), f(3), f(4), f(5))
        t_rad, valid_rad = radial_t(lx, ly, f(2), f(3), f(4), f(5), f(6),
                                    f(7))
        t_swp = sweep_t(lx, ly, f(2), f(3), f(8), f(9))
        t = torch.where(kindg == 0, t_lin,
                        torch.where(kindg == 1, t_rad, t_swp))
        valid = valid_rad | (kindg != 1)
        t = apply_extend_dynamic(t, f(1).to(torch.int32))
        rw = ramps.shape[1]
        planes = ramps.reshape(-1, 4).T.contiguous()      # (4, R * 512)
        xg = torch.clip(t, 0.0, 1.0) * (rw - 1)
        i0 = torch.floor(xg).to(torch.int32).clamp(0, rw - 2)
        frac = (xg - i0.to(torch.float32))[:, None]
        base_ix = g[:, 10].to(torch.int32)[:, None] * rw + i0
        cg = (_texels(planes, base_ix) * (1.0 - frac)
              + _texels(planes, base_ix + 1) * frac)      # (N, 4, 256)
        ag = cg[:, 3:4]
        grad_p = torch.cat([cg[:, :3] * ag, ag], dim=1)
        grad_p = torch.where(valid[:, None, :], grad_p, 0.0)
        out = torch.where((paint_kind == PAINT_GRADIENT)[:, None, None],
                          grad_p, out)

    if PAINT_IMAGE in kinds_present:
        r = image_rec
        ax, ay = r[:, 0, None], r[:, 1, None]
        iw, ih = r[:, 2, None], r[:, 3, None]
        xe = r[:, 4, None].to(torch.int32)
        ye = r[:, 5, None].to(torch.int32)
        qual = r[:, 6].to(torch.int32)[:, None, None]
        alpha = r[:, 7][:, None, None]
        sw = torch.clamp_min(iw, 1.0)
        sh = torch.clamp_min(ih, 1.0)
        # the clamps keep a REPEAT image from reading its atlas neighbour
        ux = apply_extend_dynamic((lx - 0.5) / sw, xe) * sw
        uy = apply_extend_dynamic((ly - 0.5) / sh, ye) * sh
        ux = torch.minimum(torch.clamp_min(ux, 0.0), sw - 1e-3)
        uy = torch.minimum(torch.clamp_min(uy, 0.0), sh - 1e-3)
        xf = torch.floor(ux)
        yf = torch.floor(uy)
        fx = (ux - xf)[:, None]
        fy = (uy - yf)[:, None]
        aw = atlas.shape[1]
        planes = atlas.reshape(-1, 4).T.contiguous()      # (4, H * W)
        xmax = (ax + iw - 1).to(torch.int32)
        ymax = (ay + ih - 1).to(torch.int32)
        xmin = ax.to(torch.int32)
        ymin = ay.to(torch.int32)

        def tex(xi, yi):
            xi = _clip(xi, xmin, xmax)
            yi = _clip(yi, ymin, ymax)
            return _texels(planes, yi * aw + xi)          # (N, 4, 256)

        x0i = (ax + xf).to(torch.int32)
        y0i = (ay + yf).to(torch.int32)
        img_rgba = None
        if 11 in kinds_present or not (10 in kinds_present
                                       or 12 in kinds_present):
            c00 = tex(x0i, y0i)
            c01 = tex(x0i + 1, y0i)
            c10 = tex(x0i, y0i + 1)
            c11 = tex(x0i + 1, y0i + 1)
            img_rgba = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
                        + (c10 * (1 - fx) + c11 * fx) * fy)
        if 10 in kinds_present:
            near = tex((ax + torch.floor(ux + 0.5)).to(torch.int32),
                       (ay + torch.floor(uy + 0.5)).to(torch.int32))
            img_rgba = near if img_rgba is None else \
                torch.where(qual == 0, near, img_rgba)
        if 12 in kinds_present:
            wx = cubic_weights(fx)
            wy = cubic_weights(fy)
            acc = 0.0
            for j in range(4):
                row = 0.0
                for i in range(4):
                    row = row + tex(x0i + (i - 1), y0i + (j - 1)) * wx[i]
                acc = acc + row * wy[j]
            cub = torch.clip(acc, 0.0, 1.0)
            img_rgba = cub if img_rgba is None else \
                torch.where(qual == 2, cub, img_rgba)
        img_p = img_rgba * alpha                          # (N, 4, 256)
        out = torch.where((paint_kind == PAINT_IMAGE)[:, None, None],
                          img_p, out)

    if PAINT_BLUR_RECT in kinds_present:
        br = blur_rec

        def fb(k):
            return br[:, k, None]

        cov = blurred_rounded_rect_coverage(lx, ly, fb(0), fb(1), fb(2),
                                            fb(3), fb(4), fb(5))
        cov = torch.where(fb(6) != 0.0, 1.0 - cov, cov)   # inset shadows
        blur_p = color[:, :, None] * cov[:, None, :]
        out = torch.where((paint_kind == PAINT_BLUR_RECT)[:, None, None],
                          blur_p, out)
    return out
