"""Blurred rounded-rectangle coverage (xp-agnostic).

The role of the erf7-based blurred-rect paint in the reference
(``fine.wgsl:715-722,1180-1200``). We use the standard closed-form-x /
sampled-y Gaussian integration technique (Evan Wallace's "fast rounded
rectangle shadows"), with an Abramowitz-Stegun erf approximation — accurate
to ~1e-3 coverage, well under the 8-bit quantization threshold.
"""

from __future__ import annotations

import math

SQRT_2 = math.sqrt(2.0)
N_SAMPLES = 8


def erf(xp, x):
    """A&S 7.1.26 polynomial erf approximation (vectorized, |err|<1.5e-7)."""
    s = xp.sign(x)
    ax = xp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * xp.exp(-ax * ax))


def _gaussian(xp, x, sigma):
    inv = 1.0 / xp.maximum(sigma, 1e-6)
    return xp.exp(-0.5 * (x * inv) ** 2) * (inv / math.sqrt(2.0 * math.pi))


def _row_halfwidth(xp, y, half_w, half_h, corner):
    """Half-width of the rounded rect at vertical offset y from center."""
    c = corner
    delta = xp.abs(y) - (half_h - c)
    d = xp.clip(delta, 0.0, c)
    w = half_w - c + xp.sqrt(xp.maximum(c * c - d * d, 0.0))
    inside = xp.abs(y) <= half_h
    return xp.where(inside, w, 0.0)


def blurred_rounded_rect_coverage(xp, x, y, x0, y0, x1, y1,
                                  corner: float, sigma: float):
    """Gaussian-blurred coverage of the rounded rect [x0,x1]x[y0,y1] with
    corner radius ``corner`` and blur std-dev ``sigma``, at points (x, y).
    """
    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    half_w = 0.5 * (x1 - x0)
    half_h = 0.5 * (y1 - y0)
    corner = xp.minimum(xp.minimum(corner + 0.0 * half_w, half_w), half_h)
    px = x - cx
    py = y - cy
    sigma = xp.maximum(sigma, 1e-4)
    # Integrate over the y axis: sample the Gaussian against the closed-form
    # erf coverage of each row.
    low = py - half_h
    high = py + half_h
    start = xp.clip(-3.0 * sigma, low, high)
    end = xp.clip(3.0 * sigma, low, high)
    step = (end - start) / N_SAMPLES
    total = 0.0
    inv_s = 1.0 / (sigma * SQRT_2)
    for i in range(N_SAMPLES):
        yy = start + step * (i + 0.5)
        hw = _row_halfwidth(xp, py - yy, half_w, half_h, corner)
        row = 0.5 * (erf(xp, (px + hw) * inv_s) - erf(xp, (px - hw) * inv_s))
        total = total + row * _gaussian(xp, yy, sigma) * step
    return xp.clip(total, 0.0, 1.0)
