"""Styling types (the role of the ``peniko`` crate in the reference).

Colors, brushes (solid / gradient / image), gradient stops + extend modes,
blend modes (mix × compose), and image data.

Reference parity: peniko 0.6 subset used by vello
(``vello/src/lib.rs:135-143``); blend-mode enumerations match
``vello_shaders/shader/shared/blend.wgsl`` (the standard PDF/Compositing-1
mix and Porter-Duff compose sets).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Color


@dataclass(frozen=True)
class Color:
    """sRGB color with alpha, components in [0, 1], NOT premultiplied."""

    r: float
    g: float
    b: float
    a: float = 1.0

    @staticmethod
    def from_rgba8(r: int, g: int, b: int, a: int = 255) -> "Color":
        return Color(r / 255.0, g / 255.0, b / 255.0, a / 255.0)

    @staticmethod
    def from_hex(s: str) -> "Color":
        s = s.lstrip("#")
        if len(s) == 6:
            s += "ff"
        v = int(s, 16)
        return Color.from_rgba8((v >> 24) & 255, (v >> 16) & 255,
                                (v >> 8) & 255, v & 255)

    def with_alpha(self, a: float) -> "Color":
        return Color(self.r, self.g, self.b, float(a))

    def multiply_alpha(self, a: float) -> "Color":
        return Color(self.r, self.g, self.b, self.a * float(a))

    def premultiplied(self) -> np.ndarray:
        return np.array([self.r * self.a, self.g * self.a, self.b * self.a,
                         self.a], dtype=np.float32)

    def as_array(self) -> np.ndarray:
        return np.array([self.r, self.g, self.b, self.a], dtype=np.float32)


# Named palette (the subset used by the reference test scenes).
class palette:
    BLACK = Color(0, 0, 0)
    WHITE = Color(1, 1, 1)
    RED = Color(1, 0, 0)
    GREEN = Color(0, 0.5, 0)
    LIME = Color(0, 1, 0)
    BLUE = Color(0, 0, 1)
    YELLOW = Color(1, 1, 0)
    CYAN = Color(0, 1, 1)
    MAGENTA = Color(1, 0, 1)
    TRANSPARENT = Color(0, 0, 0, 0)
    GRAY = Color(0.5, 0.5, 0.5)
    DARK_GRAY = Color(0.25, 0.25, 0.25)
    ORANGE = Color(1.0, 0.647, 0.0)
    PURPLE = Color(0.5, 0.0, 0.5)
    BROWN = Color(0.647, 0.165, 0.165)
    PINK = Color(1.0, 0.753, 0.796)
    NAVY = Color(0.0, 0.0, 0.5)
    TEAL = Color(0.0, 0.5, 0.5)
    OLIVE = Color(0.5, 0.5, 0.0)
    MAROON = Color(0.5, 0.0, 0.0)
    SILVER = Color(0.753, 0.753, 0.753)
    AQUA = Color(0.0, 1.0, 1.0)
    FUCHSIA = Color(1.0, 0.0, 1.0)
    CORNFLOWER_BLUE = Color(0.392, 0.584, 0.929)
    GOLDENROD = Color(0.855, 0.647, 0.125)
    INDIGO = Color(0.294, 0.0, 0.510)
    HOT_PINK = Color(1.0, 0.412, 0.706)
    SEA_GREEN = Color(0.180, 0.545, 0.341)
    TOMATO = Color(1.0, 0.388, 0.278)
    SLATE_BLUE = Color(0.416, 0.353, 0.804)
    ALICE_BLUE = Color(240 / 255, 248 / 255, 1.0)
    REBECCA_PURPLE = Color(102 / 255, 51 / 255, 153 / 255)
    DARK_BLUE = Color(0.0, 0.0, 139 / 255)
    ROYAL_BLUE = Color(65 / 255, 105 / 255, 225 / 255)
    DARK_GREEN = Color(0.0, 100 / 255, 0.0)
    SLATE_GRAY = Color(112 / 255, 128 / 255, 144 / 255)
    LIGHT_GREEN = Color(144 / 255, 238 / 255, 144 / 255)


# ---------------------------------------------------------------------------
# Gradients


class Extend(IntEnum):
    PAD = 0
    REPEAT = 1
    REFLECT = 2


@dataclass(frozen=True)
class ColorStop:
    offset: float
    color: Color


def stops(*pairs) -> Tuple[ColorStop, ...]:
    """Helper: stops((0.0, c0), (1.0, c1)) or stops(c0, c1, c2) (uniform)."""
    if pairs and isinstance(pairs[0], Color):
        n = len(pairs)
        return tuple(ColorStop(i / max(n - 1, 1), c)
                     for i, c in enumerate(pairs))
    return tuple(ColorStop(o, c) for (o, c) in pairs)


class GradientKind(IntEnum):
    LINEAR = 0
    RADIAL = 1
    SWEEP = 2


@dataclass(frozen=True)
class Gradient:
    kind: GradientKind
    stops: Tuple[ColorStop, ...]
    extend: Extend = Extend.PAD
    # linear: p0 -> p1
    p0: Tuple[float, float] = (0.0, 0.0)
    p1: Tuple[float, float] = (1.0, 0.0)
    # radial: two-circle (focal form handles r0 > 0 and offset centers)
    r0: float = 0.0
    r1: float = 1.0
    # sweep: start/end angle (radians) around p0
    a0: float = 0.0
    a1: float = 2.0 * np.pi
    # ColorStop interpolation alpha space (peniko InterpolationAlphaSpace;
    # reference ramp_cache.rs:119-155): "unpremultiplied" lerps straight
    # RGBA; "premultiplied" lerps premultiplied components (the CSS/canvas
    # gradient rule, vello issue #1056)
    alpha_space: str = "unpremultiplied"

    @staticmethod
    def linear(p0, p1, stops, extend: Extend = Extend.PAD) -> "Gradient":
        return Gradient(GradientKind.LINEAR, tuple(stops), extend,
                        tuple(map(float, p0)), tuple(map(float, p1)))

    @staticmethod
    def radial(center, radius, stops, extend: Extend = Extend.PAD,
               center0=None, radius0: float = 0.0) -> "Gradient":
        c0 = tuple(map(float, center0)) if center0 is not None \
            else tuple(map(float, center))
        return Gradient(GradientKind.RADIAL, tuple(stops), extend,
                        c0, tuple(map(float, center)),
                        float(radius0), float(radius))

    @staticmethod
    def sweep(center, start_angle, end_angle, stops,
              extend: Extend = Extend.PAD) -> "Gradient":
        return Gradient(GradientKind.SWEEP, tuple(stops), extend,
                        tuple(map(float, center)), (0.0, 0.0), 0.0, 0.0,
                        float(start_angle), float(end_angle))


# ---------------------------------------------------------------------------
# Images


class ImageQuality(IntEnum):
    LOW = 0      # nearest neighbor
    MEDIUM = 1   # bilinear
    HIGH = 2     # bicubic


@dataclass(frozen=True)
class Image:
    """RGBA8 image data (premultiplied alpha not required; stored straight).

    ``data`` also accepts L8 (H, W), LA8 (H, W, 2) and RGB8 (H, W, 3)
    arrays, expanded to RGBA8 at construction — the format handling of the
    reference's Pixmap::from_png (vello_common/src/pixmap.rs)."""

    data: np.ndarray            # (H, W, 4) uint8 (normalized from L/LA/RGB)
    x_extend: Extend = Extend.PAD
    y_extend: Extend = Extend.PAD
    quality: ImageQuality = ImageQuality.MEDIUM
    alpha: float = 1.0
    # Tint (reference vello_common/src/paint.rs Tint/TintMode): applied to
    # the pixel data at construction — tint is constant per paint, so
    # baking it keeps the device fine path and the oracle unchanged.
    #   "alpha_mask": tint_premul * source.alpha (glyph/monochrome tinting)
    #   "multiply":   source * tint, componentwise
    tint: Optional["Color"] = None
    tint_mode: str = "alpha_mask"

    def __post_init__(self):
        d = np.asarray(self.data)
        if d.ndim == 2:                                   # L8
            d = np.stack([d, d, d, np.full_like(d, 255)], axis=-1)
        elif d.shape[-1] == 2:                            # LA8
            l_, a_ = d[..., 0], d[..., 1]
            d = np.stack([l_, l_, l_, a_], axis=-1)
        elif d.shape[-1] == 3:                            # RGB8
            d = np.concatenate(
                [d, np.full(d.shape[:2] + (1,), 255, d.dtype)], axis=-1)
        d = d.astype(np.uint8, copy=False)
        if self.tint is not None:
            t = self.tint
            f = d.astype(np.float32)
            if self.tint_mode == "multiply":
                scale = np.array([t.r, t.g, t.b, t.a], np.float32)
                d = (f * scale + 0.5).astype(np.uint8)
            else:                                         # alpha_mask
                out = np.empty_like(f)
                out[..., 0] = t.r * 255.0
                out[..., 1] = t.g * 255.0
                out[..., 2] = t.b * 255.0
                out[..., 3] = f[..., 3] * t.a
                d = (out + 0.5).astype(np.uint8)
        object.__setattr__(self, "data", np.ascontiguousarray(d))

    def __hash__(self):
        return hash((id(self.data), self.x_extend, self.y_extend,
                     self.quality, self.alpha))

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


Brush = Union[Color, Gradient, Image]


# ---------------------------------------------------------------------------
# Blend modes


class Mix(IntEnum):
    """Separable + non-separable mix (blend) modes, W3C compositing spec."""

    NORMAL = 0
    MULTIPLY = 1
    SCREEN = 2
    OVERLAY = 3
    DARKEN = 4
    LIGHTEN = 5
    COLOR_DODGE = 6
    COLOR_BURN = 7
    HARD_LIGHT = 8
    SOFT_LIGHT = 9
    DIFFERENCE = 10
    EXCLUSION = 11
    HUE = 12
    SATURATION = 13
    COLOR = 14
    LUMINOSITY = 15
    # 128 in the reference encoding: clip = normal mix, used as marker.
    CLIP = 128
    # Layer whose content becomes a luminance mask over the backdrop
    # (reference LUMINANCE_MASK_LAYER, fine.wgsl:1150-1165).
    LUMINANCE_MASK = 127
    # alpha-mask layer: bg * fg.alpha — the reference's Mask::new_alpha
    # role (vello_common/src/mask.rs) expressed as a mask layer.
    ALPHA_MASK = 126


class Compose(IntEnum):
    """Porter-Duff composition operators."""

    CLEAR = 0
    COPY = 1
    DEST = 2
    SRC_OVER = 3
    DEST_OVER = 4
    SRC_IN = 5
    DEST_IN = 6
    SRC_OUT = 7
    DEST_OUT = 8
    SRC_ATOP = 9
    DEST_ATOP = 10
    XOR = 11
    PLUS = 12
    PLUS_LIGHTER = 13


@dataclass(frozen=True)
class BlendMode:
    mix: Mix = Mix.NORMAL
    compose: Compose = Compose.SRC_OVER

    @staticmethod
    def default() -> "BlendMode":
        return BlendMode()

    def is_default(self) -> bool:
        return (self.mix in (Mix.NORMAL, Mix.CLIP)
                and self.compose == Compose.SRC_OVER)


class Fill(IntEnum):
    NON_ZERO = 0
    EVEN_ODD = 1
