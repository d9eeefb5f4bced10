"""CPU oracle renderer — the exact-pixel reference implementation.

Plays the role of ``vello_cpu`` / the CPU shader ports in the reference's test
strategy (SURVEY.md §4.3, ``doc/ARCHITECTURE.md:81-89``): a slow, simple,
*independent* implementation the device pipeline is differentially tested
against.

Deliberately different formulation from the device pipeline: coverage is
computed with the classic signed-area scanline accumulation algorithm
(split edges at integer y then integer x; each sub-pixel piece contributes
``dy*(1-xbar)`` / ``dy*xbar`` to two accumulation cells; prefix-sum along x
gives winding) rather than the device's tile/touch/sort formulation. Both
compute exact-area antialiasing, so agreement is a strong correctness check.

Flattening, paint and blend math are the JAX package's host and numpy
formulas (``np_blend``, ``np_paint``, ``np_blur``, ``np_filters``), so this
oracle equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..encoding.config import FLATTEN_TOL, MAX_LINES_PER_SEG, RenderParams
from ..encoding.host_flatten import (elevate_to_cubic, flatten_decoded,
                                     transform_points, wang_counts)
from ..encoding.encoding import (DRAW_BEGIN_LAYER, DRAW_END_LAYER,
                                 decode_segments)
from ..encoding.resolve import (PAINT_BLUR_RECT, PAINT_COLOR, PAINT_GRADIENT,
                                PAINT_IMAGE, ResolvedScene, resolve)
from ..peniko import Compose, Fill, Mix
from ..scene import Scene
# the numpy halves of the JAX package's ops/blend, paint, blur and filters
# (the port's ops/ modules are torch)
from . import np_blend as blend_ops
from . import np_paint as paint_ops
from .np_blur import blurred_rounded_rect_coverage


# ---------------------------------------------------------------------------
# Shared flatten math (numpy mirror of ops/flatten.py — identical formulas)


# ---------------------------------------------------------------------------
# Scanline accumulation coverage (independent from the device formulation)


def accumulate_winding(lines: np.ndarray, width: int, height: int,
                       ) -> np.ndarray:
    """Exact-area winding grid from line segments (float64, (H, W))."""
    if len(lines) == 0:
        return np.zeros((height, width))
    # Accumulate into guard margins on BOTH sides so clamping compression
    # lands outside the visible area (the clamp preserves winding beyond the
    # boundary exactly, but deforms coverage inside the boundary column).
    out_width = width
    LM = 4
    width = width + LM + 17
    x0, y0, x1, y1 = (lines[:, i].astype(np.float64) for i in range(4))
    x0 = x0 + LM
    x1 = x1 + LM
    # Clamp y to the viewport; x handled by clamping into [0, W] so winding
    # from off-left geometry still lands in column 0.
    y0c = np.clip(y0, 0.0, float(height))
    y1c = np.clip(y1, 0.0, float(height))
    dy = y1 - y0
    nz = np.abs(dy) > 1e-12
    tt0 = np.where(nz, (y0c - y0) / np.where(nz, dy, 1.0), 0.0)
    tt1 = np.where(nz, (y1c - y0) / np.where(nz, dy, 1.0), 0.0)
    xa = x0 + tt0 * (x1 - x0)
    xb = x0 + tt1 * (x1 - x0)
    keep = nz & (np.abs(y1c - y0c) > 1e-12)
    x0, y0, x1, y1 = xa[keep], y0c[keep], xb[keep], y1c[keep]
    if len(x0) == 0:
        return np.zeros((height, out_width))

    # Split at integer y crossings.
    ylo = np.minimum(y0, y1)
    yhi = np.maximum(y0, y1)
    n_rows = (np.ceil(yhi) - np.floor(ylo)).astype(np.int64)
    n_rows = np.maximum(n_rows, 1)
    offs = np.cumsum(n_rows) - n_rows
    total = int(n_rows.sum())
    eix = np.searchsorted(np.cumsum(n_rows), np.arange(total), side="right")
    sub = np.arange(total) - offs[eix]
    ylo_e = ylo[eix]
    row_y0 = np.maximum(np.floor(ylo_e) + sub, ylo_e)
    row_y1 = np.minimum(np.floor(ylo_e) + sub + 1, yhi[eix])
    valid = row_y1 > row_y0 + 1e-14
    # Parametrize by original line to get x at the clip ys.
    X0, Y0, X1, Y1 = x0[eix], y0[eix], x1[eix], y1[eix]
    dyl = Y1 - Y0
    inv = 1.0 / np.where(np.abs(dyl) < 1e-14, 1.0, dyl)
    ta = (row_y0 - Y0) * inv
    tb = (row_y1 - Y0) * inv
    pays = np.sign(dyl)  # +1 if going down
    xa = X0 + ta * (X1 - X0)
    xb = X0 + tb * (X1 - X0)
    # Orient piece downward in y; winding sign = pays.
    py0 = row_y0
    py1 = row_y1
    h = (py1 - py0) * pays  # signed vertical extent (down positive)

    # Split at integer x crossings within the row piece.
    xlo = np.clip(np.minimum(xa, xb), 0.0, float(width))
    xhi = np.clip(np.maximum(xa, xb), 0.0, float(width))
    xa_c = np.clip(xa, 0.0, float(width))
    xb_c = np.clip(xb, 0.0, float(width))
    n_cols = (np.ceil(xhi) - np.floor(xlo)).astype(np.int64)
    n_cols = np.where(valid, np.maximum(n_cols, 1), 0)
    offs2 = np.cumsum(n_cols) - n_cols
    total2 = int(n_cols.sum())
    if total2 == 0:
        return np.zeros((height, out_width))
    pix = np.searchsorted(np.cumsum(n_cols), np.arange(total2), side="right")
    sub2 = np.arange(total2) - offs2[pix]
    xl = xlo[pix]
    col_x0 = np.maximum(np.floor(xl) + sub2, xl)
    col_x1 = np.minimum(np.floor(xl) + sub2 + 1, xhi[pix])
    col_x1 = np.maximum(col_x1, col_x0)
    # y extent of this sub-piece: fraction of the row piece's x-span.
    XA, XB = xa_c[pix], xb_c[pix]
    dx = XB - XA
    invx = 1.0 / np.where(np.abs(dx) < 1e-14, 1.0, dx)
    # t in [0,1] along the row piece for the x clip points
    u0 = np.where(np.abs(dx) < 1e-14, 0.0, (col_x0 - XA) * invx)
    u1 = np.where(np.abs(dx) < 1e-14, 1.0, (col_x1 - XA) * invx)
    ulo = np.clip(np.minimum(u0, u1), 0.0, 1.0)
    uhi = np.clip(np.maximum(u0, u1), 0.0, 1.0)
    frac = uhi - ulo
    frac = np.where(np.abs(dx) < 1e-14, np.where(sub2 == 0, 1.0, 0.0), frac)
    dh = h[pix] * frac
    xbar = 0.5 * (col_x0 + col_x1)
    px = np.floor(np.where(np.abs(dx) < 1e-14, XA, xbar))
    px = np.clip(px, 0.0, width - 1.0).astype(np.int64)
    py = np.floor(0.5 * (py0[pix] + py1[pix])).astype(np.int64)
    py = np.clip(py, 0, height - 1)
    # Area split between cell px and px+1 by the midpoint rule (exact for
    # linear edges): right cell gets (xmid - px) fraction "uncovered".
    xmid = np.where(np.abs(dx) < 1e-14, np.clip(XA, 0.0, width),
                    0.5 * (col_x0 + col_x1))
    right_frac = np.clip(xmid - px, 0.0, 1.0)
    acc = np.zeros((height, width + 1))
    np.add.at(acc, (py, px), dh * (1.0 - right_frac))
    np.add.at(acc, (py, np.minimum(px + 1, width)), dh * right_frac)
    winding = np.cumsum(acc, axis=1)[:, LM:LM + out_width]
    return winding


def apply_fill_rule(winding: np.ndarray, rule: int) -> np.ndarray:
    if rule == int(Fill.EVEN_ODD):
        return np.abs(winding - 2.0 * np.round(0.5 * winding))
    return np.minimum(np.abs(winding), 1.0)


# ---------------------------------------------------------------------------
# Paint evaluation


def _pixel_grid(width, height):
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    return xs + 0.5, ys + 0.5


def eval_paint(rs: ResolvedScene, p: int, width: int, height: int
               ) -> np.ndarray:
    """Premultiplied RGBA (H, W, 4) of path p's paint."""
    kind = int(rs.paint_kind[p])
    if kind == PAINT_COLOR:
        return np.broadcast_to(rs.color[p], (height, width, 4)).copy()
    xs, ys = _pixel_grid(width, height)
    inv = rs.paint_inv[p].astype(np.float64)
    lx = xs * inv[0] + ys * inv[2] + inv[4]
    ly = xs * inv[1] + ys * inv[3] + inv[5]
    if kind == PAINT_GRADIENT:
        rec = rs.grad_rec[p]
        ramp = rs.ramps[int(rec[10])]
        return paint_ops.eval_gradient_static(np, rec, ramp, lx, ly
                                              ).astype(np.float64)
    if kind == PAINT_IMAGE:
        ax, ay, w, h, xe, ye, qual, alpha = rs.image_rec[p]
        sub = rs.atlas[int(ay):int(ay + h), int(ax):int(ax + w)]
        sampler = {0: paint_ops.sample_image_nearest,
                   1: paint_ops.sample_image_bilinear,
                   2: paint_ops.sample_image_bicubic}[int(qual)]
        rgba = sampler(np, sub.astype(np.float64), lx, ly, int(xe), int(ye))
        return rgba * float(alpha)
    if kind == PAINT_BLUR_RECT:
        x0, y0, x1, y1, radius, std = rs.blur_rec[p][:6]
        cov = blurred_rounded_rect_coverage(
            np, lx, ly, float(x0), float(y0), float(x1), float(y1),
            float(radius), float(std))
        if rs.blur_rec[p][6] != 0.0:        # inset shadow: 1 - coverage
            cov = 1.0 - cov
        return rs.color[p][None, None, :] * cov[..., None]
    raise ValueError(f"unknown paint kind {kind}")


# ---------------------------------------------------------------------------
# Renderer


class OracleRenderer:
    """Full-semantics reference renderer (fills, strokes-as-fills, gradients,
    images, blurred rects, nested clip/blend layers)."""

    def render(self, scene: Scene, params: RenderParams) -> np.ndarray:
        if params.antialiasing != "area":
            # msaa8/msaa16 as 3x/4x supersampling (see models/renderer.py).
            from ..encoding.encoding import Encoding
            from ..kurbo import Affine
            k = 3 if params.antialiasing == "msaa8" else 4
            up = Encoding()
            up.append(scene.encoding, Affine.scale(float(k)))
            big = RenderParams(params.width * k, params.height * k,
                               params.base_color, "centers")
            img = self.render_resolved(resolve(up, big), big)
            h, w = params.height, params.width
            return img[:h * k, :w * k].reshape(h, k, w, k, 4).mean(
                axis=(1, 3))
        rs = resolve(scene.encoding, params)
        return self.render_resolved(rs, params)

    def render_resolved(self, rs: ResolvedScene,
                        params: RenderParams) -> np.ndarray:
        W, H = params.width, params.height
        decoded = decode_segments(rs.tags, rs.data, rs.transforms, rs.styles,
                                  style_hw=getattr(rs, "styles_hw", None))
        lines, line_path = flatten_decoded(decoded)

        centers = params.antialiasing == "centers"

        def path_coverage(p: int) -> np.ndarray:
            sel = line_path == p
            w = accumulate_winding(lines[sel], W, H)
            cov = apply_fill_rule(w, int(rs.fill_rule[p]))
            if centers:
                cov = np.where(cov >= 0.5, 1.0, 0.0)
            return cov

        base = np.zeros((H, W, 4))
        bc = np.asarray(params.base_color, dtype=np.float64)
        base[...] = np.array([bc[0] * bc[3], bc[1] * bc[3], bc[2] * bc[3],
                              bc[3]])
        # Layer stack: (buffer, clip_coverage, mix, compose, alpha)
        stack: List[tuple] = [(base, None, int(Mix.NORMAL),
                               int(Compose.SRC_OVER), 1.0, None)]
        layer_iter = iter(rs.layers)
        li = 0
        for d in range(len(rs.draw_kind)):
            k = int(rs.draw_kind[d])
            if k == DRAW_BEGIN_LAYER:
                info = rs.layers[li]
                li += 1
                clip = None
                if info.clip_path_ix >= 0:
                    sel = line_path == info.clip_path_ix
                    wgrid = accumulate_winding(lines[sel], W, H)
                    clip = apply_fill_rule(wgrid, info.fill_rule)
                buf = np.zeros((H, W, 4))
                stack.append((buf, clip, info.mix, info.compose, info.alpha,
                              info.layer_filter))
            elif k == DRAW_END_LAYER:
                li += 1
                if len(stack) <= 1:
                    continue
                buf, clip, mix, compose, alpha, lfilter = stack.pop()
                if lfilter is not None:
                    from .np_filters import apply_filter
                    buf = apply_filter(np, buf, int(lfilter[0]),
                                       lfilter[1:])
                parent = stack[-1][0]
                c = clip[..., None] if clip is not None else \
                    np.ones((H, W, 1))
                if mix in (int(Mix.LUMINANCE_MASK), int(Mix.ALPHA_MASK)):
                    fg = buf * c * alpha
                    mfun = blend_ops.luminance_mask \
                        if mix == int(Mix.LUMINANCE_MASK) \
                        else blend_ops.alpha_mask
                    masked = mfun(np, parent, fg)
                    parent[...] = np.where(c > 0.0, masked, parent)
                else:
                    src = buf * alpha
                    blended = blend_ops.blend_mix_compose(np, parent, src,
                                                          mix, compose)
                    parent[...] = parent * (1.0 - c) + blended * c
            else:
                p = int(rs.draw_path_ix[d])
                if p < 0:
                    continue
                # batch records cover draw_path_n consecutive paths
                nb = int(rs.draw_path_n[d]) if rs.draw_path_n is not None \
                    else 1
                for pp in range(p, p + max(nb, 1)):
                    cov = path_coverage(pp)
                    rgba = eval_paint(rs, pp, W, H)
                    src = rgba * cov[..., None]
                    top = stack[-1][0]
                    top[...] = blend_ops.src_over(np, top, src)
        out = stack[0][0]
        return np.clip(out, 0.0, 1.0).astype(np.float32)


def render_scene(scene: Scene, params: RenderParams) -> np.ndarray:
    return OracleRenderer().render(scene, params)
