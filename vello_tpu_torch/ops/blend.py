"""Blend math: 16 mix modes x 14 Porter-Duff compose operators, in torch
(counterpart of ``vello_tpu/ops/blend.py``: the W3C
Compositing-and-Blending-1 formulas of ``shared/blend.wgsl``).

All inputs and outputs are premultiplied RGBA f32 tensors of shape
(..., 4). The JAX package writes these against an array namespace; here
they are torch, with ``jnp.clip`` by tensor bounds spelled as
``minimum(maximum(x, lo), hi)`` and ``min``/``max`` over the channels as
``amin``/``amax``. The layer plan is host data in the port, so mix and
compose are Python ints and the pop's ``lax.switch`` is a plain branch.
"""

from __future__ import annotations

import torch

from ..peniko import Mix


def _unpremul(c):
    a = c[..., 3:4]
    safe = torch.where(a > 1e-7, a, 1.0)
    rgb = torch.where(a > 1e-7, c[..., :3] / safe, 0.0)
    return rgb, c[..., 3]


# -- separable mix functions (operate on unpremultiplied rgb in [0,1]) ------

def _screen(cb, cs):
    return cb + cs - cb * cs


# Discontinuity guard for dodge/burn (the JAX package's _EDGE): f32
# coverage residue around 0 and 1 must not flip the branch.
_EDGE = 1e-4


def _color_dodge(cb, cs):
    return torch.where(
        cb <= _EDGE, 0.0,
        torch.where(cs >= 1.0 - _EDGE, 1.0,
                    torch.clamp_max(cb / torch.clamp_min(1.0 - cs, 1e-12),
                                    1.0)))


def _color_burn(cb, cs):
    return torch.where(
        cb >= 1.0 - _EDGE, 1.0,
        torch.where(cs <= _EDGE, 0.0,
                    1.0 - torch.clamp_max((1.0 - cb)
                                          / torch.clamp_min(cs, 1e-12), 1.0)))


def _hard_light(cb, cs):
    return torch.where(cs <= 0.5, cb * 2.0 * cs, _screen(cb, 2.0 * cs - 1.0))


def _soft_light(cb, cs):
    d = torch.where(cb <= 0.25, ((16.0 * cb - 12.0) * cb + 4.0) * cb,
                    torch.sqrt(torch.clamp_min(cb, 0.0)))
    return torch.where(cs <= 0.5,
                       cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb),
                       cb + (2.0 * cs - 1.0) * (d - cb))


# -- non-separable helpers ---------------------------------------------------

def _lum(c):
    return (0.3 * c[..., 0] + 0.59 * c[..., 1] + 0.11 * c[..., 2])[..., None]


def _clip_color(c):
    l = _lum(c)
    n = torch.amin(c, dim=-1, keepdim=True)
    x = torch.amax(c, dim=-1, keepdim=True)
    c1 = torch.where(n < 0.0,
                     l + (c - l) * l / torch.clamp_min(l - n, 1e-12), c)
    return torch.where(x > 1.0,
                       l + (c1 - l) * (1.0 - l) / torch.clamp_min(x - l,
                                                                  1e-12), c1)


def _set_lum(c, l):
    return _clip_color(c + (l - _lum(c)))


def _sat(c):
    return (torch.amax(c, dim=-1, keepdim=True)
            - torch.amin(c, dim=-1, keepdim=True))


def _set_sat(c, s):
    # scale the channels so the max-min distance equals s, keeping order
    cmin = torch.amin(c, dim=-1, keepdim=True)
    cmax = torch.amax(c, dim=-1, keepdim=True)
    d = torch.clamp_min(cmax - cmin, 1e-12)
    scaled = (c - cmin) * s / d
    return torch.where(cmax > cmin, scaled, torch.zeros_like(c))


def mix_rgb(cb, cs, mix: int):
    """Apply a mix mode to unpremultiplied rgb tensors (..., 3)."""
    m = int(mix)
    if m in (Mix.NORMAL, Mix.CLIP):
        return cs
    if m == Mix.MULTIPLY:
        return cb * cs
    if m == Mix.SCREEN:
        return _screen(cb, cs)
    if m == Mix.OVERLAY:
        return _hard_light(cs, cb)
    if m == Mix.DARKEN:
        return torch.minimum(cb, cs)
    if m == Mix.LIGHTEN:
        return torch.maximum(cb, cs)
    if m == Mix.COLOR_DODGE:
        return _color_dodge(cb, cs)
    if m == Mix.COLOR_BURN:
        return _color_burn(cb, cs)
    if m == Mix.HARD_LIGHT:
        return _hard_light(cb, cs)
    if m == Mix.SOFT_LIGHT:
        return _soft_light(cb, cs)
    if m == Mix.DIFFERENCE:
        return torch.abs(cb - cs)
    if m == Mix.EXCLUSION:
        return cb + cs - 2.0 * cb * cs
    if m == Mix.HUE:
        return _set_lum(_set_sat(cs, _sat(cb)), _lum(cb))
    if m == Mix.SATURATION:
        return _set_lum(_set_sat(cb, _sat(cs)), _lum(cb))
    if m == Mix.COLOR:
        return _set_lum(cs, _lum(cb))
    if m == Mix.LUMINOSITY:
        return _set_lum(cb, _lum(cs))
    raise ValueError(f"unknown mix mode {mix}")


# (a0, a1, b0, b1): fa = a0 + a1*ab, fb = b0 + b1*as (every Porter-Duff
# coefficient pair is linear in the alphas); rows indexed by Compose
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


def blend_mix_compose(backdrop, src, mix: int, compose: int):
    """Full blend: mix the colors, then Porter-Duff compose.

    backdrop, src: premultiplied RGBA (..., 4). Returns premultiplied RGBA,
    clamped to 0 <= rgb <= a <= 1 (``blend_mix_compose`` of
    shared/blend.wgsl)."""
    cb_rgb, ab = _unpremul(backdrop)
    cs_rgb, as_ = _unpremul(src)
    mixed = mix_rgb(cb_rgb, cs_rgb, mix)
    # interpolate the source toward the mix by the backdrop alpha (the
    # spec blends only where the backdrop exists)
    cs_eff = (1.0 - ab[..., None]) * cs_rgb + ab[..., None] * mixed
    src_p = torch.cat([cs_eff * as_[..., None], as_[..., None]], dim=-1)
    a0, a1, b0, b1 = COMPOSE_TABLE[int(compose)]
    fa = a0 + a1 * ab
    fb = b0 + b1 * as_
    out = src_p * fa[..., None] + backdrop * fb[..., None]
    a = out[..., 3:4].clamp(0.0, 1.0)
    rgb = torch.minimum(out[..., :3].clamp_min(0.0), a)
    return torch.cat([rgb, a], dim=-1)


def blend_mix_compose_dyn(backdrop, src, mix: int, compose: int):
    """The counterpart of the JAX package's ``blend_mix_compose_dyn`` (the
    plan-as-data pop op): mix clamped to [0, 15] and compose to [0, 13],
    as its switch index and table row are."""
    return blend_mix_compose(backdrop, src, min(max(int(mix), 0), 15),
                             min(max(int(compose), 0), 13))


def svg_luminance(rgb):
    """SVG luminanceToAlpha coefficients (the reference's svg_lum)."""
    return (0.2125 * rgb[..., 0] + 0.7154 * rgb[..., 1]
            + 0.0721 * rgb[..., 2])


def luminance_mask(backdrop, fg):
    """bg * clamp(lum(unpremul fg) * fg.a, 0, 1) (fine.wgsl:1150-1165)."""
    rgb, a = _unpremul(fg)
    lum = (svg_luminance(rgb) * a).clamp(0.0, 1.0)
    return backdrop * lum[..., None]


def alpha_mask(backdrop, fg):
    """bg * clamp(fg.a, 0, 1): the alpha-mask pop (Mask::new_alpha role,
    reference vello_common/src/mask.rs)."""
    return backdrop * fg[..., 3:4].clamp(0.0, 1.0)
