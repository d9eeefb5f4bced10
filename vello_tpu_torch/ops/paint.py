"""Paint setup on the host: ramp LUTs and gradient records (copy of the host
half of ``vello_tpu/ops/paint.py``; the device-side paint evaluation comes
with kernel K6, ROADMAP item 7).

Covers the roles of ``draw_leaf.wgsl`` gradient setup and
``vello_encoding/src/ramp_cache.rs`` in the reference.
"""

from __future__ import annotations

import numpy as np

from ..peniko import Gradient

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
