"""Layer filters: gaussian blur (3-pass box approximation), drop shadow,
offset, flood (counterpart of ``vello_tpu/ops/filters.py``; the blur is
the 3-box construction of ``vello_cpu/src/filter/gaussian_blur.rs``).

The ``FILTER_*`` kinds are what ``scene.py`` encodes. The filters are the
counterparts of the JAX package's dynamic-parameter variants
(``apply_filter_dyn``), which its layered compositor runs: a 3-box blur
whose radii come from f32 arithmetic on sigma, clamped to ``wl >= 1`` and
zeroed at ``sigma <= 0.1`` (the static ``boxes_for_gauss`` has no such
clamp), and every box pass run even at radius 0. The layer plan is host
data in the port, so the radii, offsets and colors are Python numbers
computed in f32 with numpy. Inputs are premultiplied (H, W, 4) images.
"""

from __future__ import annotations

import numpy as np
import torch

FILTER_NONE = 0
FILTER_BLUR = 1
FILTER_DROP_SHADOW = 2
FILTER_OFFSET = 3
FILTER_FLOOD = 4

_f32 = np.float32


def _box_blur_axis_dyn(img, radius: int, axis: int):
    """Box blur of width 2*radius+1 along ``axis``, edge-extended, as the
    difference of two f32 cumsums (radius 0 gives back the image up to
    that difference's rounding, as in the JAX package)."""
    n = img.shape[axis]
    c = torch.cumsum(img, dim=axis)
    shape1 = [n if a == axis else 1 for a in range(img.ndim)]
    ar = torch.arange(n, device=img.device)

    def take(idx):
        return torch.index_select(c, axis, idx.clamp(0, n - 1))

    hi = take(ar + radius)
    lo = take(ar - radius - 1)
    lo = torch.where((ar - radius - 1 < 0).reshape(shape1), 0.0, lo)
    first = torch.narrow(img, axis, 0, 1)
    last = torch.narrow(img, axis, n - 1, 1)
    n_lo = torch.clamp_min(radius - ar, 0).reshape(shape1)
    n_hi = torch.clamp_min(ar + radius - (n - 1), 0).reshape(shape1)
    total = hi - lo + n_lo * first + n_hi * last
    return total / (2.0 * radius + 1.0)


def _box_radii_dyn(sigma):
    """The three box radii of a gaussian of std dev ``sigma`` (W3C box
    sizes), in the f32 arithmetic of the JAX package's traced version."""
    sigma = _f32(sigma)
    nf = _f32(3.0)
    w_ideal = np.sqrt(_f32(12.0) * sigma * sigma / nf + _f32(1.0))
    wl = np.floor(w_ideal)
    wl = wl - (_f32(1.0) if np.mod(wl, _f32(2.0)) == 0.0 else _f32(0.0))
    wl = np.maximum(wl, _f32(1.0))
    wu = wl + _f32(2.0)
    m = np.round((_f32(12.0) * sigma * sigma - nf * wl * wl
                  - _f32(4.0) * nf * wl - _f32(3.0) * nf)
                 / (_f32(-4.0) * wl - _f32(4.0)))
    rl = int((wl - _f32(1.0)) / _f32(2.0))
    ru = int((wu - _f32(1.0)) / _f32(2.0))
    if sigma <= _f32(0.1):
        return [0, 0, 0]
    return [rl if i < m else ru for i in range(3)]


def gaussian_blur_dyn(img, sigma):
    """3-box gaussian approximation, separable (y then x per box)."""
    for r in _box_radii_dyn(sigma):
        img = _box_blur_axis_dyn(img, r, 0)
        img = _box_blur_axis_dyn(img, r, 1)
    return img


def offset_image_dyn(img, dx: int, dy: int):
    """Integer-pixel shift, zero-filled."""
    h, w = img.shape[0], img.shape[1]
    out = torch.roll(torch.roll(img, dy, dims=0), dx, dims=1)
    ys = torch.arange(h, device=img.device).reshape(h, 1, 1)
    xs = torch.arange(w, device=img.device).reshape(1, w, 1)
    keep_y = (ys >= max(dy, 0)) & (ys < h + min(dy, 0))
    keep_x = (xs >= max(dx, 0)) & (xs < w + min(dx, 0))
    return torch.where(keep_y & keep_x, out, 0.0)


def _premul_color(col):
    """[r*a, g*a, b*a, a] as Python floats holding the f32 products."""
    r, g, b, a = (_f32(v) for v in col)
    return [float(r * a), float(g * a), float(b * a), float(a)]


def apply_filter_dyn(img, kind: int, params):
    """img (H, W, 4) premultiplied; kind (clamped to [0, 4]); params (7,)
    [sigma, dx, dy, r, g, b, a] as the plan's f32 filter row gives them."""
    kind = min(max(int(kind), 0), 4)
    sigma = _f32(params[0])
    dx, dy = int(_f32(params[1])), int(_f32(params[2]))
    if kind == FILTER_BLUR:
        return gaussian_blur_dyn(img, sigma)
    if kind == FILTER_DROP_SHADOW:
        pr, pg, pb, pa = _premul_color(params[3:7])
        sh_a = offset_image_dyn(gaussian_blur_dyn(img[..., 3:4], sigma),
                                dx, dy)
        shadow = torch.cat([pr * sh_a, pg * sh_a, pb * sh_a, pa * sh_a],
                           dim=-1)
        return img + shadow * (1.0 - img[..., 3:4])
    if kind == FILTER_OFFSET:
        return offset_image_dyn(img, dx, dy)
    if kind == FILTER_FLOOD:
        fill = torch.tensor(_premul_color(params[3:7]), dtype=img.dtype,
                            device=img.device)
        return fill.expand(img.shape).clone()
    return img
