"""Paint evaluation: gradients (linear / radial two-circle / sweep), ramp LUTs,
extend modes, and image sampling.

The oracle's numpy copy of ``vello_tpu/ops/paint.py``; its host half
(``make_ramp``, ``pack_gradient``) is the port's ``ops/paint.py``, imported
from there. xp-agnostic (``xp`` = numpy). Covers the roles of
``draw_leaf.wgsl`` gradient setup + ``fine.wgsl`` paint sampling and
``vello_encoding/src/ramp_cache.rs`` in the reference.
"""

from __future__ import annotations

import numpy as np

from ..ops.paint import (GRAD_RECORD_SIZE, RAMP_WIDTH,  # noqa: F401
                         make_ramp, pack_gradient)
from ..peniko import Extend, GradientKind


def apply_extend(xp, t, mode: int):
    m = int(mode)
    if m == Extend.PAD:
        return xp.clip(t, 0.0, 1.0)
    if m == Extend.REPEAT:
        return t - xp.floor(t)
    # REFLECT: triangle wave with period 2.
    u = t - 2.0 * xp.floor(t * 0.5)
    return 1.0 - xp.abs(u - 1.0)


def apply_extend_dynamic(xp, t, mode):
    """Extend with a traced (array) mode selector — for the device pipeline."""
    pad = xp.clip(t, 0.0, 1.0)
    rep = t - xp.floor(t)
    u = t - 2.0 * xp.floor(t * 0.5)
    ref = 1.0 - xp.abs(u - 1.0)
    return xp.where(mode == Extend.PAD, pad,
                    xp.where(mode == Extend.REPEAT, rep, ref))


def sample_ramp(xp, ramp, t):
    """Linearly sample a (W, 4) straight-alpha ramp at t in [0,1]; returns
    premultiplied RGBA with trailing dims of t preserved: t (...,) -> (..., 4).
    """
    w = ramp.shape[0]
    x = xp.clip(t, 0.0, 1.0) * (w - 1)
    i0 = xp.clip(xp.floor(x).astype("int32"), 0, w - 2)
    frac = (x - i0.astype(ramp.dtype))[..., None]
    c = ramp[i0] * (1.0 - frac) + ramp[i0 + 1] * frac
    a = c[..., 3:4]
    return xp.concatenate([c[..., :3] * a, a], axis=-1)


def linear_t(xp, x, y, p0x, p0y, p1x, p1y):
    dx = p1x - p0x
    dy = p1y - p0y
    denom = xp.maximum(dx * dx + dy * dy, 1e-12)
    return ((x - p0x) * dx + (y - p0y) * dy) / denom


def radial_t(xp, x, y, c0x, c0y, c1x, c1y, r0, r1):
    """Two-point conical gradient: find max t with |p - lerp(c0,c1,t)| =
    lerp(r0,r1,t) and radius >= 0. Returns (t, valid_mask).

    Solves the standard quadratic (covers all four 'kinds' the reference
    distinguishes in draw_leaf.wgsl / config.wgsl:60-72).
    """
    cdx = c1x - c0x
    cdy = c1y - c0y
    rd = r1 - r0
    px = x - c0x
    py = y - c0y
    a = cdx * cdx + cdy * cdy - rd * rd
    b = px * cdx + py * cdy + r0 * rd
    c = px * px + py * py - r0 * r0
    # Quadratic a t^2 - 2 b t + c = 0 -> t = (b ± sqrt(b² - a c)) / a.
    # NUMERICALLY STABLE root pair: the naive (b - sq)/a catastrophically
    # cancels near the tangent-circles degeneracy (|cd| ~ |rd| => a -> 0
    # with b > 0) — the well-conditioned-by-region evaluation the
    # reference gets from its focal-form analysis (draw_leaf.wgsl:291-303,
    # vello_common/src/encode.rs FocalData). Compute Q = b + sign(b)*sq
    # (|Q| = |b| + sq, no cancellation); the roots are Q/a and c/Q.
    disc = b * b - a * c
    sq = xp.sqrt(xp.maximum(disc, 0.0))
    scale = cdx * cdx + cdy * cdy + rd * rd + 1e-30
    eps = 1e-7
    lin = xp.abs(a) < eps * scale
    safe_a = xp.where(lin, 1.0, a)
    sgn_b = xp.where(b >= 0.0, 1.0, -1.0)
    q_ = b + sgn_b * sq
    q_tiny = xp.abs(q_) < 1e-30
    safe_q = xp.where(q_tiny, 1.0, q_)
    t_a = q_ / safe_a
    t_b = xp.where(q_tiny, t_a, c / safe_q)
    t_quad_hi = xp.maximum(t_a, t_b)
    t_quad_lo = xp.minimum(t_a, t_b)
    # Pick the larger t whose radius is >= 0.
    r_hi = r0 + t_quad_hi * rd
    t_quad = xp.where(r_hi >= 0.0, t_quad_hi, t_quad_lo)
    r_q = r0 + t_quad * rd
    valid_quad = (disc >= 0.0) & (r_q >= 0.0)
    # Linear case (a ~ 0, tangent circles): 2 b t = c — the parabola
    # formula, exact where the quadratic degenerates.
    eps_b = 1e-12 * scale
    safe_b = xp.where(xp.abs(b) < eps_b, 1.0, b)
    t_lin = c / (2.0 * safe_b)
    r_l = r0 + t_lin * rd
    valid_lin = (xp.abs(b) >= eps_b) & (r_l >= 0.0)
    t = xp.where(lin, t_lin, t_quad)
    valid = xp.where(lin, valid_lin, valid_quad)
    return t, valid


def sweep_t(xp, x, y, cx, cy, a0, a1):
    ang = xp.arctan2(cy - y, x - cx)  # y-down screen coords -> CCW angle
    ang = xp.where(ang < 0.0, ang + 2.0 * np.pi, ang)
    denom = xp.where(xp.abs(a1 - a0) < 1e-12, 1.0, a1 - a0)
    return (ang - a0) / denom


def eval_gradient_static(xp, rec: np.ndarray, ramp, x, y):
    """Evaluate a gradient at pixel coords (oracle path: rec is concrete)."""
    kind = int(rec[0])
    extend = int(rec[1])
    p0x, p0y, p1x, p1y, r0, r1, a0, a1 = (float(v) for v in rec[2:10])
    if kind == GradientKind.LINEAR:
        t = linear_t(xp, x, y, p0x, p0y, p1x, p1y)
        valid = None
    elif kind == GradientKind.RADIAL:
        t, valid = radial_t(xp, x, y, p0x, p0y, p1x, p1y, r0, r1)
    else:
        t = sweep_t(xp, x, y, p0x, p0y, a0, a1)
        valid = None
    t = apply_extend(xp, t, extend)
    rgba = sample_ramp(xp, ramp, t)
    if valid is not None:
        rgba = xp.where(valid[..., None], rgba, xp.zeros_like(rgba))
    return rgba


def eval_gradient_traced(xp, rec, ramp, x, y):
    """Device path: rec is a traced (12,) array — evaluate all kinds, select."""
    kind = rec[0]
    extend = rec[1].astype("int32")
    p0x, p0y, p1x, p1y = rec[2], rec[3], rec[4], rec[5]
    r0, r1, a0, a1 = rec[6], rec[7], rec[8], rec[9]
    t_lin = linear_t(xp, x, y, p0x, p0y, p1x, p1y)
    t_rad, valid_rad = radial_t(xp, x, y, p0x, p0y, p1x, p1y, r0, r1)
    t_swp = sweep_t(xp, x, y, p0x, p0y, a0, a1)
    t = xp.where(kind == GradientKind.LINEAR, t_lin,
                 xp.where(kind == GradientKind.RADIAL, t_rad, t_swp))
    valid = xp.where(kind == GradientKind.RADIAL, valid_rad, True)
    t = apply_extend_dynamic(xp, t, extend)
    rgba = sample_ramp(xp, ramp, t)
    return xp.where(valid[..., None], rgba, xp.zeros_like(rgba))


# ---------------------------------------------------------------------------
# Image sampling


def cubic_weights(xp, f):
    """Catmull-Rom weights for fractional position f (…): returns 4 weights.
    The bicubic kernel of the reference's HIGH image quality
    (fine.wgsl:897-925)."""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


def sample_image_nearest(xp, img, x, y, x_extend: int, y_extend: int):
    h, w = img.shape[0], img.shape[1]

    def wrap(v, n, mode):
        t = apply_extend(xp, v / n, mode) * n
        return xp.clip(t, 0.0, n - 1e-3)

    xi = xp.floor(wrap(x - 0.5, w, x_extend) + 0.5).astype("int32")
    yi = xp.floor(wrap(y - 0.5, h, y_extend) + 0.5).astype("int32")
    return img[xp.clip(yi, 0, h - 1), xp.clip(xi, 0, w - 1)]


def sample_image_bicubic(xp, img, x, y, x_extend: int, y_extend: int):
    """Catmull-Rom bicubic (4x4 taps)."""
    h, w = img.shape[0], img.shape[1]

    def wrap(v, n, mode):
        t = apply_extend(xp, v / n, mode) * n
        return xp.clip(t, 0.0, n - 1e-3)

    xs = wrap(x - 0.5, w, x_extend)
    ys = wrap(y - 0.5, h, y_extend)
    x0 = xp.floor(xs).astype("int32")
    y0 = xp.floor(ys).astype("int32")
    fx = xs - x0
    fy = ys - y0
    wx = cubic_weights(xp, fx)
    wy = cubic_weights(xp, fy)
    out = 0.0
    for j in range(4):
        row = 0.0
        yj = xp.clip(y0 + (j - 1), 0, h - 1)
        for i in range(4):
            xi = xp.clip(x0 + (i - 1), 0, w - 1)
            row = row + img[yj, xi] * wx[i][..., None]
        out = out + row * wy[j][..., None]
    return xp.clip(out, 0.0, 1.0)


def sample_image_bilinear(xp, img, x, y, x_extend: int, y_extend: int):
    """img: (H, W, 4) f32 premultiplied. x/y: pixel coords in image space."""
    h, w = img.shape[0], img.shape[1]

    def wrap(v, n, mode):
        t = apply_extend(xp, v / n, mode) * n
        return xp.clip(t, 0.0, n - 1e-3)

    xs = wrap(x - 0.5, w, x_extend)
    ys = wrap(y - 0.5, h, y_extend)
    x0 = xp.clip(xp.floor(xs).astype("int32"), 0, w - 1)
    y0 = xp.clip(xp.floor(ys).astype("int32"), 0, h - 1)
    x1 = xp.minimum(x0 + 1, w - 1)
    y1 = xp.minimum(y0 + 1, h - 1)
    fx = (xs - x0.astype(img.dtype))[..., None]
    fy = (ys - y0.astype(img.dtype))[..., None]
    c00 = img[y0, x0]
    c01 = img[y0, x1]
    c10 = img[y1, x0]
    c11 = img[y1, x1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
