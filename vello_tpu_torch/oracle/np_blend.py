"""Blend math: 16 mix modes x 14 Porter-Duff compose operators.

The oracle's numpy copy of ``vello_tpu/ops/blend.py``, without its JAX-only
``blend_mix_compose_dyn`` (the port's device blend is ``ops/blend.py``).
Written against the array-module protocol (``xp`` = numpy); the same role as
``vello_shaders/shader/shared/blend.wgsl`` in the reference (the W3C
Compositing-and-Blending-1 spec formulas).

All inputs/outputs are premultiplied RGBA f32 arrays of shape (..., 4).
"""

from __future__ import annotations

from ..peniko import Compose, Mix


def _unpremul(xp, c):
    a = c[..., 3:4]
    safe = xp.where(a > 1e-7, a, 1.0)
    rgb = xp.where(a > 1e-7, c[..., :3] / safe, 0.0)
    return rgb, c[..., 3]


# -- separable mix functions (operate on unpremultiplied rgb in [0,1]) ------

def _screen(xp, cb, cs):
    return cb + cs - cb * cs


# Discontinuity guard for dodge/burn: the spec compares cb/cs against exact
# 0/1, but f32 coverage accumulation leaves ~1e-5 residue around both, which
# flips the discontinuous branch on anti-aliased interiors. 1e-4 keeps the
# branch decision stable across f32 (device) and f64 (oracle).
_EDGE = 1e-4


def _color_dodge(xp, cb, cs):
    return xp.where(
        cb <= _EDGE, 0.0,
        xp.where(cs >= 1.0 - _EDGE, 1.0,
                 xp.minimum(1.0, cb / xp.maximum(1.0 - cs, 1e-12))))


def _color_burn(xp, cb, cs):
    return xp.where(
        cb >= 1.0 - _EDGE, 1.0,
        xp.where(cs <= _EDGE, 0.0,
                 1.0 - xp.minimum(1.0, (1.0 - cb) / xp.maximum(cs, 1e-12))))


def _hard_light(xp, cb, cs):
    return xp.where(cs <= 0.5, cb * 2.0 * cs,
                    _screen(xp, cb, 2.0 * cs - 1.0))


def _soft_light(xp, cb, cs):
    d = xp.where(cb <= 0.25, ((16.0 * cb - 12.0) * cb + 4.0) * cb,
                 xp.sqrt(xp.maximum(cb, 0.0)))
    return xp.where(cs <= 0.5,
                    cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb),
                    cb + (2.0 * cs - 1.0) * (d - cb))


# -- non-separable helpers ---------------------------------------------------

def _lum(xp, c):
    return (0.3 * c[..., 0] + 0.59 * c[..., 1] + 0.11 * c[..., 2])[..., None]


def _clip_color(xp, c):
    l = _lum(xp, c)
    n = xp.min(c, axis=-1, keepdims=True)
    x = xp.max(c, axis=-1, keepdims=True)
    c1 = xp.where(n < 0.0,
                  l + (c - l) * l / xp.maximum(l - n, 1e-12), c)
    c2 = xp.where(x > 1.0,
                  l + (c1 - l) * (1.0 - l) / xp.maximum(x - l, 1e-12), c1)
    return c2


def _set_lum(xp, c, l):
    return _clip_color(xp, c + (l - _lum(xp, c)))


def _sat(xp, c):
    return (xp.max(c, axis=-1, keepdims=True)
            - xp.min(c, axis=-1, keepdims=True))


def _set_sat(xp, c, s):
    # Scale the channels so the max-min distance equals s, keeping order.
    cmin = xp.min(c, axis=-1, keepdims=True)
    cmax = xp.max(c, axis=-1, keepdims=True)
    d = xp.maximum(cmax - cmin, 1e-12)
    scaled = (c - cmin) * s / d
    return xp.where(cmax > cmin, scaled, xp.zeros_like(c))


def mix_rgb(xp, cb, cs, mix: int):
    """Apply a mix mode to unpremultiplied rgb arrays (..., 3)."""
    m = int(mix)
    if m in (Mix.NORMAL, Mix.CLIP):
        return cs
    if m == Mix.MULTIPLY:
        return cb * cs
    if m == Mix.SCREEN:
        return _screen(xp, cb, cs)
    if m == Mix.OVERLAY:
        return _hard_light(xp, cs, cb)
    if m == Mix.DARKEN:
        return xp.minimum(cb, cs)
    if m == Mix.LIGHTEN:
        return xp.maximum(cb, cs)
    if m == Mix.COLOR_DODGE:
        return _color_dodge(xp, cb, cs)
    if m == Mix.COLOR_BURN:
        return _color_burn(xp, cb, cs)
    if m == Mix.HARD_LIGHT:
        return _hard_light(xp, cb, cs)
    if m == Mix.SOFT_LIGHT:
        return _soft_light(xp, cb, cs)
    if m == Mix.DIFFERENCE:
        return xp.abs(cb - cs)
    if m == Mix.EXCLUSION:
        return cb + cs - 2.0 * cb * cs
    if m == Mix.HUE:
        return _set_lum(xp, _set_sat(xp, cs, _sat(xp, cb)), _lum(xp, cb))
    if m == Mix.SATURATION:
        return _set_lum(xp, _set_sat(xp, cb, _sat(xp, cs)), _lum(xp, cb))
    if m == Mix.COLOR:
        return _set_lum(xp, cs, _lum(xp, cb))
    if m == Mix.LUMINOSITY:
        return _set_lum(xp, cb, _lum(xp, cs))
    raise ValueError(f"unknown mix mode {mix}")


_COMPOSE_COEFFS = {
    # compose: (fa, fb) as functions of (ab = backdrop alpha, as = src alpha);
    # out = fa * src_premul + fb * backdrop_premul
    Compose.CLEAR: lambda xp, ab, as_: (0.0 * as_, 0.0 * ab),
    Compose.COPY: lambda xp, ab, as_: (1.0 + 0.0 * as_, 0.0 * ab),
    Compose.DEST: lambda xp, ab, as_: (0.0 * as_, 1.0 + 0.0 * ab),
    Compose.SRC_OVER: lambda xp, ab, as_: (1.0 + 0.0 * as_, 1.0 - as_),
    Compose.DEST_OVER: lambda xp, ab, as_: (1.0 - ab, 1.0 + 0.0 * ab),
    Compose.SRC_IN: lambda xp, ab, as_: (ab, 0.0 * ab),
    Compose.DEST_IN: lambda xp, ab, as_: (0.0 * as_, as_),
    Compose.SRC_OUT: lambda xp, ab, as_: (1.0 - ab, 0.0 * ab),
    Compose.DEST_OUT: lambda xp, ab, as_: (0.0 * as_, 1.0 - as_),
    Compose.SRC_ATOP: lambda xp, ab, as_: (ab, 1.0 - as_),
    Compose.DEST_ATOP: lambda xp, ab, as_: (1.0 - ab, as_),
    Compose.XOR: lambda xp, ab, as_: (1.0 - ab, 1.0 - as_),
    Compose.PLUS: lambda xp, ab, as_: (1.0 + 0.0 * as_, 1.0 + 0.0 * ab),
    # PLUS_LIGHTER is plus with channel clamping (handled in blend_compose).
    Compose.PLUS_LIGHTER: lambda xp, ab, as_: (1.0 + 0.0 * as_, 1.0 + 0.0 * ab),
}


def blend_mix_compose(xp, backdrop, src, mix: int, compose: int):
    """Full blend: mix the colors, then Porter-Duff compose.

    backdrop, src: premultiplied RGBA (..., 4). Returns premultiplied RGBA.
    Matches the semantics of blend_mix_compose in shared/blend.wgsl.
    """
    cb_rgb, ab = _unpremul(xp, backdrop)
    cs_rgb, as_ = _unpremul(xp, src)
    mixed = mix_rgb(xp, cb_rgb, cs_rgb, mix)
    # Interpolate source toward mixed by backdrop alpha (spec: only blend
    # where the backdrop exists).
    cs_eff = (1.0 - ab[..., None]) * cs_rgb + ab[..., None] * mixed
    src_p = xp.concatenate(
        [cs_eff * as_[..., None], as_[..., None]], axis=-1)
    fa, fb = _COMPOSE_COEFFS[Compose(int(compose))](xp, ab, as_)
    out = src_p * fa[..., None] + backdrop * fb[..., None]
    a = xp.clip(out[..., 3:4], 0.0, 1.0)
    rgb = xp.clip(out[..., :3], 0.0, a)
    return xp.concatenate([rgb, a], axis=-1)


def svg_luminance(xp, rgb):
    """SVG luminanceToAlpha coefficients (the reference's svg_lum)."""
    return (0.2125 * rgb[..., 0] + 0.7154 * rgb[..., 1]
            + 0.0721 * rgb[..., 2])


def luminance_mask(xp, backdrop, fg):
    """bg * clamp(lum(unpremul fg) * fg.a, 0, 1) — fine.wgsl:1150-1165."""
    rgb, a = _unpremul(xp, fg)
    lum = xp.clip(svg_luminance(xp, rgb) * a, 0.0, 1.0)
    return backdrop * lum[..., None]


def alpha_mask(xp, backdrop, fg):
    """bg * clamp(fg.a, 0, 1) — the alpha-mask pop (Mask::new_alpha role,
    reference vello_common/src/mask.rs)."""
    return backdrop * xp.clip(fg[..., 3:4], 0.0, 1.0)


def src_over(xp, backdrop, src):
    """Premultiplied source-over (the hot default)."""
    return src + backdrop * (1.0 - src[..., 3:4])


# (a0, a1, b0, b1): fa = a0 + a1*ab, fb = b0 + b1*as  (all Porter-Duff
# coefficient pairs above are linear in the alphas)
COMPOSE_TABLE = [
    (0, 0, 0, 0),    # CLEAR
    (1, 0, 0, 0),    # COPY
    (0, 0, 1, 0),    # DEST
    (1, 0, 1, -1),   # SRC_OVER
    (1, -1, 1, 0),   # DEST_OVER
    (0, 1, 0, 0),    # SRC_IN
    (0, 0, 0, 1),    # DEST_IN
    (1, -1, 0, 0),   # SRC_OUT
    (0, 0, 1, -1),   # DEST_OUT
    (0, 1, 1, -1),   # SRC_ATOP
    (1, -1, 0, 1),   # DEST_ATOP
    (1, -1, 1, -1),  # XOR
    (1, 0, 1, 0),    # PLUS
    (1, 0, 1, 0),    # PLUS_LIGHTER
]
