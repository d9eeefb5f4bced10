"""The oracle's layer filters (numpy copy of ``vello_tpu/ops/filters.py``,
without its JAX-only traced variants): gaussian blur (3-pass box
approximation), drop shadow, offset, flood — the sparse-strips filter suite
(``vello_common/src/filter*.rs`` + ``vello_cpu/src/filter/``; the blur is
the same 3-box construction as ``vello_cpu/src/filter/gaussian_blur.rs``).

xp-agnostic; box blur is cumsum-based (two prefix sums + a difference per
axis).
Inputs are premultiplied (H, W, 4) images; filters run on whole layer
buffers at pop time.
"""

from __future__ import annotations

import math

# the filter kinds are the port's (ops/filters.py), which scene.py encodes
from ..ops.filters import (FILTER_BLUR, FILTER_DROP_SHADOW, FILTER_FLOOD,
                           FILTER_NONE, FILTER_OFFSET)


def boxes_for_gauss(sigma: float, n: int = 3):
    """W3C/standard box sizes approximating a gaussian with n boxes."""
    w_ideal = math.sqrt((12.0 * sigma * sigma / n) + 1.0)
    wl = int(math.floor(w_ideal))
    if wl % 2 == 0:
        wl -= 1
    wu = wl + 2
    m_ideal = ((12.0 * sigma * sigma - n * wl * wl - 4.0 * n * wl - 3.0 * n)
               / (-4.0 * wl - 4.0))
    m = int(round(m_ideal))
    return [wl if i < m else wu for i in range(n)]


def box_blur_axis(xp, img, radius: int, axis: int):
    """Box blur of width 2*radius+1 along axis, edge-extended, via cumsum."""
    if radius <= 0:
        return img
    n = img.shape[axis]
    c = xp.cumsum(img, axis=axis)

    def take(idx):
        idx = xp.clip(idx, 0, n - 1)
        return xp.take(c, idx, axis=axis)

    ar = xp.arange(n)
    hi = take(ar + radius)
    lo = take(ar - radius - 1)
    lo = xp.where(
        xp.reshape(ar - radius - 1 < 0,
                   [n if a == axis else 1 for a in range(img.ndim)]),
        0.0, lo)
    # edge extension: count of off-edge samples replaced by edge value
    first = xp.take(img, xp.asarray([0]), axis=axis)
    last = xp.take(img, xp.asarray([n - 1]), axis=axis)
    n_lo = xp.reshape(xp.maximum(radius - ar, 0),
                      [n if a == axis else 1 for a in range(img.ndim)])
    n_hi = xp.reshape(xp.maximum(ar + radius - (n - 1), 0),
                      [n if a == axis else 1 for a in range(img.ndim)])
    total = hi - lo + n_lo * first + n_hi * last
    return total / (2.0 * radius + 1.0)


def gaussian_blur(xp, img, sigma: float):
    """3-box gaussian approximation (separable)."""
    if sigma <= 0.1:
        return img
    for w in boxes_for_gauss(sigma):
        r = (w - 1) // 2
        img = box_blur_axis(xp, img, r, 0)
        img = box_blur_axis(xp, img, r, 1)
    return img


def offset_image(xp, img, dx: int, dy: int):
    """Shift by integer pixels, zero-filled."""
    h, w = img.shape[0], img.shape[1]
    out = xp.roll(xp.roll(img, dy, axis=0), dx, axis=1)
    ys = xp.reshape(xp.arange(h), (h, 1, 1))
    xs = xp.reshape(xp.arange(w), (1, w, 1))
    mask = xp.ones_like(out)
    if dy > 0:
        mask = xp.where(ys < dy, 0.0, mask)
    elif dy < 0:
        mask = xp.where(ys >= h + dy, 0.0, mask)
    if dx > 0:
        mask = xp.where(xs < dx, 0.0, mask)
    elif dx < 0:
        mask = xp.where(xs >= w + dx, 0.0, mask)
    return out * mask


def drop_shadow(xp, img, dx: int, dy: int, sigma: float, color):
    """Shadow = blurred+offset alpha tinted by color, composited UNDER the
    content (filter_drop_shadow role)."""
    alpha = img[..., 3:4]
    sh_a = offset_image(xp, gaussian_blur(xp, alpha, sigma), dx, dy)
    shadow = xp.concatenate([
        color[0] * color[3] * sh_a, color[1] * color[3] * sh_a,
        color[2] * color[3] * sh_a, color[3] * sh_a], axis=-1)
    # content over shadow
    return img + shadow * (1.0 - img[..., 3:4])


def flood(xp, img, color):
    """Fill the whole layer with a color (clip applies at composite)."""
    out = xp.ones_like(img)
    return out * xp.asarray([color[0] * color[3], color[1] * color[3],
                             color[2] * color[3], color[3]])


def apply_filter(xp, img, kind: int, params):
    """img: (H, W, 4) premultiplied. params: (sigma, dx, dy, r, g, b, a)."""
    sigma, dx, dy = params[0], int(params[1]), int(params[2])
    color = params[3:7]
    if kind == FILTER_BLUR:
        return gaussian_blur(xp, img, sigma)
    if kind == FILTER_DROP_SHADOW:
        return drop_shadow(xp, img, dx, dy, sigma, color)
    if kind == FILTER_OFFSET:
        return offset_image(xp, img, dx, dy)
    if kind == FILTER_FLOOD:
        return flood(xp, img, color)
    return img
