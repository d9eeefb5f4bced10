"""The reference's rasteriser: each path's coverage by point sampling and
its source-over composite in draw order, in float64 plain PyTorch.

It shares no formulation with the port's tile, touch and sort pipeline.
For each line (x0, y0, x1, y1) of a path and each sample row it crosses
(sample s of pixel row r sits at y = r + (s + 0.5) / n, taken half-open
so that a shared vertex counts once), the crossing's direction is added
at the first pixel column whose sample lies right of the crossing. A
cumulative sum along each row of the path's box gives every sample's
winding number, and the fill rule makes it inside or not. A pixel's
coverage is the share of its n samples inside. Sample s sits at
x = c + (pattern[s] + 0.5) / n: the D3D11 standard patterns that msaa8
and msaa16 name.

The composite folds each path's premultiplied color times its coverage
over the base, ``out = src + out * (1 - src_alpha)``, pixel by pixel in
draw order, one layer of overlap at a time. ``dtype`` bfloat16 computes
that fold in bfloat16: the control that the output check has to fail."""

from __future__ import annotations

import numpy as np
import torch

PATTERNS = {8: (0, 5, 3, 7, 1, 4, 6, 2),
            16: (1, 8, 4, 11, 15, 7, 3, 12, 0, 9, 5, 13, 2, 10, 6, 14)}
SAMPLES = {"msaa8": 8, "msaa16": 16}
CHUNK = 1 << 26           # grid cells (sample rows x columns) per chunk


def _crossings(lines, path, n, width, height):
    """(path, global sample row, first column right of it, direction) of
    every crossing of a line with a sample row inside the frame."""
    x0, y0, x1, y1 = lines.unbind(1)
    ylo, yhi = torch.minimum(y0, y1), torch.maximum(y0, y1)
    # sample row g sits at (g + 0.5) / n; rows with ylo <= y < yhi
    g_lo = torch.ceil(ylo * n - 0.5).clamp(0, height * n)
    g_hi = torch.ceil(yhi * n - 0.5).clamp(0, height * n)
    cnt = (g_hi - g_lo).clamp_min(0).long()
    keep = cnt > 0
    idx = torch.repeat_interleave(torch.nonzero(keep)[:, 0], cnt[keep])
    first = torch.cumsum(cnt[keep], 0) - cnt[keep]
    sub = torch.arange(len(idx), device=lines.device) - \
        torch.repeat_interleave(first, cnt[keep])
    g = g_lo[idx].long() + sub
    y = (g.double() + 0.5) / n
    xa, ya, xb, yb = x0[idx], y0[idx], x1[idx], y1[idx]
    xc = xa + (y - ya) * (xb - xa) / (yb - ya)
    pattern = torch.tensor(PATTERNS[n], dtype=torch.float64,
                           device=lines.device)
    ox = (pattern[g % n] + 0.5) / n
    col = torch.floor(xc - ox).long() + 1
    direction = torch.where(yb > ya, 1, -1).to(torch.int32)
    return path[idx], g, col, direction


def _fragments(lines, path, rule, n_paths, n, width, height):
    """(path, pixel, samples inside) of every pixel a path covers."""
    dev = lines.device
    p, g, col, d = _crossings(lines, path, n, width, height)
    big = 1 << 40
    # each path's box: its sample rows and its columns
    g0 = torch.full((n_paths,), big, device=dev).scatter_reduce(
        0, p, g, "amin")
    g1 = torch.full((n_paths,), -1, device=dev).scatter_reduce(
        0, p, g, "amax")
    has = g1 >= 0
    r0 = torch.where(has, torch.div(g0, n, rounding_mode="floor"), 0)
    r1 = torch.where(has, torch.div(g1, n, rounding_mode="floor") + 1, 0)
    cc = col.clamp(0, width)
    c0 = torch.full((n_paths,), big, device=dev).scatter_reduce(
        0, p, cc, "amin")
    c1 = torch.full((n_paths,), -1, device=dev).scatter_reduce(
        0, p, cc, "amax")
    c0 = torch.where(has, c0, 0)
    # a closed path winds 0 left of its first crossing and right of its
    # last: its box spans those columns, and the last is a sink
    bw = torch.where(has, c1 - c0, 0)
    rows = (r1 - r0) * n
    order = torch.argsort(p, stable=True)
    p, g, cc, d = p[order], g[order], cc[order], d[order]
    starts = torch.searchsorted(p, torch.arange(n_paths + 1, device=dev))
    rows_np, bw_np = rows.cpu().numpy(), bw.cpu().numpy()
    out_p, out_q, out_k = [], [], []
    lo = 0
    while lo < n_paths:
        # paths lo..hi-1 share a grid of their sample rows x (widest box
        # + 1) columns
        cum = np.cumsum(rows_np[lo:]) * (np.maximum.accumulate(bw_np[lo:])
                                         + 1)
        hi = lo + max(int(np.searchsorted(cum, CHUNK, side="right")), 1)
        if rows_np[lo:hi].sum() == 0:
            lo = hi
            continue
        sel = slice(int(starts[lo]), int(starts[hi]))
        cw = int(bw_np[lo:hi].max()) + 1
        nr = rows[lo:hi]
        roff = torch.cumsum(nr, 0) - nr
        grid = torch.zeros((int(nr.sum()), cw), dtype=torch.int32,
                           device=dev)
        ps = p[sel]
        gr = roff[ps - lo] + g[sel] - r0[ps] * n
        gc = cc[sel] - c0[ps]
        grid.view(-1).index_put_((gr * cw + gc,), d[sel], accumulate=True)
        wind = torch.cumsum(grid, 1)
        del grid
        prow = torch.repeat_interleave(torch.arange(hi - lo, device=dev), nr)
        inside = torch.where((rule[lo:hi] == 1)[prow][:, None],
                             wind % 2 != 0, wind != 0)
        del wind
        k = inside.view(-1, n, cw).sum(1, dtype=torch.int32)
        del inside
        prow = prow[::n]
        y = r0[lo + prow] + torch.arange(len(prow), device=dev) \
            - torch.div(roff[prow], n, rounding_mode="floor")
        nz = torch.nonzero(k)
        ri, ci = nz[:, 0], nz[:, 1]
        pth = lo + prow[ri]
        x = c0[pth] + ci
        ok = x < width
        out_p.append(pth[ok])
        out_q.append((y[ri] * width + x)[ok])
        out_k.append(k[ri, ci][ok])
        lo = hi
    if not out_p:
        z = torch.zeros(0, dtype=torch.long, device=dev)
        return z, z, z
    return torch.cat(out_p), torch.cat(out_q), torch.cat(out_k)


def composite(frag_p, frag_q, frag_k, color, rank, base, n, width, height,
              dtype=torch.float64):
    """The premultiplied (H, W, 4) frame: each fragment's color times its
    coverage folded source-over onto the base, in the draw order
    ``rank`` (per path) at each pixel."""
    dev = color.device
    n_paths = len(rank)
    key = frag_q * n_paths + rank[frag_p]
    order = torch.argsort(key)
    fq, fp, fk = frag_q[order], frag_p[order], frag_k[order]
    # each fragment's depth among its pixel's fragments
    first = torch.ones_like(fq, dtype=torch.bool)
    first[1:] = fq[1:] != fq[:-1]
    start = torch.cummax(torch.where(
        first, torch.arange(len(fq), device=dev), 0), 0).values
    depth = torch.arange(len(fq), device=dev) - start
    by_depth = torch.argsort(depth, stable=True)
    counts = torch.bincount(depth).tolist()
    out = base.to(dtype).reshape(1, 4).repeat(height * width, 1)
    col = color.to(dtype)
    pos = 0
    for c in counts:
        ix = by_depth[pos:pos + c]
        pos += c
        q = fq[ix]
        src = col[fp[ix]] * (fk[ix].to(dtype) / n)[:, None]
        out[q] = src + out[q] * (1 - src[:, 3:4])
    return out.reshape(height, width, 4)


def to_rgba8(img):
    """Premultiplied (H, W, 4) -> straight-alpha RGBA8: alpha under half
    a level shows as 0, colors divided by alpha, each value rounded half
    up."""
    img = img.double()
    a = img[..., 3:4].clamp(0.0, 1.0)
    vis = a >= 1.0 / 510.0
    rgb = torch.where(vis, (img[..., :3] / torch.where(vis, a, 1.0))
                      .clamp(0.0, 1.0), 0.0)
    return torch.floor(torch.cat([rgb, a], -1) * 255.0 + 0.5).to(torch.uint8)


def render_u8(lines, line_path, fill_rule, color, rank, base, aa, width,
              height, device, dtype=torch.float64):
    """The straight-alpha RGBA8 frame (H, W, 4) on ``device`` of solid
    paths: lines (N, 4) and their path, and per path its fill rule (0
    nonzero, 1 even-odd), premultiplied color and draw rank."""
    n = SAMPLES[aa]
    dev = torch.device(device)
    lines = torch.as_tensor(np.asarray(lines, np.float64), device=dev)
    path = torch.as_tensor(np.asarray(line_path, np.int64), device=dev)
    rule = torch.as_tensor(np.asarray(fill_rule, np.int64), device=dev)
    color = torch.as_tensor(np.asarray(color, np.float64), device=dev)
    rank = torch.as_tensor(np.asarray(rank, np.int64), device=dev)
    base = torch.as_tensor(np.asarray(base, np.float64), device=dev)
    fp, fq, fk = _fragments(lines, path, rule, len(rank), n, width, height)
    img = composite(fp, fq, fk, color, rank, base, n, width, height, dtype)
    return to_rgba8(img)
