"""Paint setup and evaluation (counterpart of ``vello_tpu/ops/paint.py``).

The host half (ramp LUTs, gradient records) is numpy; the device half
(extend modes, the linear / two-circle radial / sweep gradient parameter,
the bicubic weights) is PyTorch and runs on whichever device its tensors
are on. ``fine.eval_paints`` calls the device half. The f32 op order is
the JAX package's, so both evaluate a paint to the same rounding wherever
neither contracts a multiply-add.

Covers the roles of ``draw_leaf.wgsl`` gradient setup, ``fine.wgsl`` paint
sampling and ``vello_encoding/src/ramp_cache.rs`` in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..peniko import Extend, Gradient

RAMP_WIDTH = 512  # texels per gradient ramp (ramp_cache.rs:12)


def make_ramp(stops, width: int = RAMP_WIDTH,
              alpha_space: str = "unpremultiplied") -> np.ndarray:
    """Build a (width, 4) f32 straight-alpha LUT from color stops (host
    side). alpha_space follows peniko InterpolationAlphaSpace (reference
    ramp_cache.rs:119-155): "premultiplied" lerps premultiplied components
    and unpremultiplies for the straight-alpha LUT (a == 0 rows stay 0, so
    re-premultiplying at paint eval is exact)."""
    if len(stops) == 0:
        return np.zeros((width, 4), dtype=np.float32)
    offs = np.array([s.offset for s in stops], dtype=np.float64)
    cols = np.array([[s.color.r, s.color.g, s.color.b, s.color.a]
                     for s in stops], dtype=np.float64)
    if alpha_space == "premultiplied":
        cols = cols.copy()
        cols[:, :3] *= cols[:, 3:4]
    t = np.linspace(0.0, 1.0, width)
    out = np.empty((width, 4), dtype=np.float64)
    for ch in range(4):
        out[:, ch] = np.interp(t, offs, cols[:, ch])
    if alpha_space == "premultiplied":
        a = out[:, 3:4]
        out[:, :3] = np.divide(out[:, :3], a, out=np.zeros_like(out[:, :3]),
                               where=a > 1e-12)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Gradient parameter packing. The host packs every gradient into a fixed
# 12-float record; the device evaluates it with gradient_t(). This replaces
# the reference's per-kind transformed-parameter computation in
# draw_leaf.wgsl:291-303 with a uniform two-circle / linear / sweep record.

GRAD_RECORD_SIZE = 12
# layout: [kind, extend, p0x, p0y, p1x, p1y, r0, r1, a0, a1, ramp_row, pad]


def pack_gradient(g: Gradient, ramp_row: int) -> np.ndarray:
    rec = np.zeros(GRAD_RECORD_SIZE, dtype=np.float32)
    rec[0] = float(int(g.kind))
    rec[1] = float(int(g.extend))
    rec[2:4] = g.p0
    rec[4:6] = g.p1
    rec[6] = g.r0
    rec[7] = g.r1
    rec[8] = g.a0
    rec[9] = g.a1
    rec[10] = float(ramp_row)
    return rec


# ---------------------------------------------------------------------------
# Device half: per-pixel gradient parameters and sampling weights. Every
# argument is a tensor (or broadcasts against one); the mode selectors are
# integer tensors.


def apply_extend_dynamic(t, mode):
    """Extend t by a per-element mode (PAD / REPEAT / REFLECT)."""
    pad = torch.clip(t, 0.0, 1.0)
    rep = t - torch.floor(t)
    u = t - 2.0 * torch.floor(t * 0.5)
    ref = 1.0 - torch.abs(u - 1.0)
    return torch.where(mode == Extend.PAD, pad,
                       torch.where(mode == Extend.REPEAT, rep, ref))


def linear_t(x, y, p0x, p0y, p1x, p1y):
    dx = p1x - p0x
    dy = p1y - p0y
    denom = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    return ((x - p0x) * dx + (y - p0y) * dy) / denom


def radial_t(x, y, c0x, c0y, c1x, c1y, r0, r1):
    """Two-point conical gradient: the largest t with |p - lerp(c0, c1, t)|
    = lerp(r0, r1, t) and a radius >= 0. Returns (t, valid mask).

    Solves a t^2 - 2 b t + c = 0 through the stable root pair Q = b +
    sign(b) sqrt(b^2 - a c), roots Q/a and c/Q, and falls back to the
    linear root c / 2b where a vanishes (tangent circles)."""
    cdx = c1x - c0x
    cdy = c1y - c0y
    rd = r1 - r0
    px = x - c0x
    py = y - c0y
    a = cdx * cdx + cdy * cdy - rd * rd
    b = px * cdx + py * cdy + r0 * rd
    c = px * px + py * py - r0 * r0
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    scale = cdx * cdx + cdy * cdy + rd * rd + 1e-30
    lin = torch.abs(a) < 1e-7 * scale
    safe_a = torch.where(lin, 1.0, a)
    sgn_b = torch.where(b >= 0.0, 1.0, -1.0)
    q_ = b + sgn_b * sq
    q_tiny = torch.abs(q_) < 1e-30
    safe_q = torch.where(q_tiny, 1.0, q_)
    t_a = q_ / safe_a
    t_b = torch.where(q_tiny, t_a, c / safe_q)
    t_quad_hi = torch.maximum(t_a, t_b)
    t_quad_lo = torch.minimum(t_a, t_b)
    r_hi = r0 + t_quad_hi * rd
    t_quad = torch.where(r_hi >= 0.0, t_quad_hi, t_quad_lo)
    r_q = r0 + t_quad * rd
    valid_quad = (disc >= 0.0) & (r_q >= 0.0)
    eps_b = 1e-12 * scale
    safe_b = torch.where(torch.abs(b) < eps_b, 1.0, b)
    t_lin = c / (2.0 * safe_b)
    r_l = r0 + t_lin * rd
    valid_lin = (torch.abs(b) >= eps_b) & (r_l >= 0.0)
    return (torch.where(lin, t_lin, t_quad),
            torch.where(lin, valid_lin, valid_quad))


def sweep_t(x, y, cx, cy, a0, a1):
    ang = torch.arctan2(cy - y, x - cx)  # y-down screen coords -> CCW angle
    ang = torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)
    denom = torch.where(torch.abs(a1 - a0) < 1e-12, 1.0, a1 - a0)
    return (ang - a0) / denom


def cubic_weights(f):
    """Catmull-Rom weights for the fractional position f: the bicubic
    kernel of the reference's HIGH image quality (fine.wgsl:897-925)."""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3
