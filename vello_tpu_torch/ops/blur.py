"""Blurred rounded-rectangle coverage (copy of ``vello_tpu/ops/blur.py``
in PyTorch).

The role of the erf7-based blurred-rect paint in the reference
(``fine.wgsl:715-722,1180-1200``): the standard closed-form-x / sampled-y
Gaussian integration (Evan Wallace's "fast rounded rectangle shadows"),
with an Abramowitz-Stegun erf approximation accurate to ~1e-3 coverage,
well under the 8-bit quantization threshold. The JAX package writes it
against an ``xp`` namespace; here a maximum or clip against a Python
scalar is ``clamp_min`` / ``clamp``, which round the same.
"""

from __future__ import annotations

import math

import torch

SQRT_2 = math.sqrt(2.0)
N_SAMPLES = 8


def erf(x):
    """A&S 7.1.26 polynomial erf approximation (|err| < 1.5e-7)."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gaussian(x, sigma):
    inv = 1.0 / torch.clamp_min(sigma, 1e-6)
    return torch.exp(-0.5 * (x * inv) ** 2) * (inv / math.sqrt(2.0 * math.pi))


def _row_halfwidth(y, half_w, half_h, corner):
    """Half-width of the rounded rect at vertical offset y from center."""
    c = corner
    delta = torch.abs(y) - (half_h - c)
    d = torch.minimum(torch.clamp_min(delta, 0.0), c)
    w = half_w - c + torch.sqrt(torch.clamp_min(c * c - d * d, 0.0))
    inside = torch.abs(y) <= half_h
    return torch.where(inside, w, 0.0)


def blurred_rounded_rect_coverage(x, y, x0, y0, x1, y1, corner, sigma):
    """Gaussian-blurred coverage of the rounded rect [x0,x1]x[y0,y1] with
    corner radius ``corner`` and blur std-dev ``sigma``, at points (x, y).
    """
    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    half_w = 0.5 * (x1 - x0)
    half_h = 0.5 * (y1 - y0)
    corner = torch.minimum(torch.minimum(corner + 0.0 * half_w, half_w),
                           half_h)
    px = x - cx
    py = y - cy
    sigma = torch.clamp_min(sigma, 1e-4)
    # Integrate over the y axis: sample the Gaussian against the closed-form
    # erf coverage of each row.
    low = py - half_h
    high = py + half_h
    start = torch.clip(-3.0 * sigma, low, high)
    end = torch.clip(3.0 * sigma, low, high)
    step = (end - start) / N_SAMPLES
    total = 0.0
    inv_s = 1.0 / (sigma * SQRT_2)
    for i in range(N_SAMPLES):
        yy = start + step * (i + 0.5)
        hw = _row_halfwidth(py - yy, half_w, half_h, corner)
        row = 0.5 * (erf((px + hw) * inv_s) - erf((px - hw) * inv_s))
        total = total + row * _gaussian(yy, sigma) * step
    return torch.clip(total, 0.0, 1.0)
