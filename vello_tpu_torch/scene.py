"""Public Scene API — the retained command recorder.

Reference parity: ``vello::Scene`` (``vello/src/scene.rs:45-470``):
fill / stroke / push_layer / push_clip_layer / draw_image / draw_blurred_rect /
append / reset. Strokes are expanded host-side (see stroke.py for the
architecture rationale); dashing is applied host-side exactly as the reference
does CPU-side dashing at ``scene.rs:428-439``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .encoding.encoding import (DRAW_BEGIN_LAYER, DRAW_BLUR_RECT, DRAW_COLOR,
                                DRAW_END_LAYER, DRAW_GRADIENT, DRAW_IMAGE,
                                DrawRecord, Encoding)
from .kurbo import Affine, BezPath, Rect, Stroke, rect_path
from .peniko import (BlendMode, Brush, Color, Compose, Fill, Gradient, Image,
                     Mix)
from .stroke import expand_stroke


def _brush_kind(brush: Brush) -> int:
    if isinstance(brush, Color):
        return DRAW_COLOR
    if isinstance(brush, Gradient):
        return DRAW_GRADIENT
    if isinstance(brush, Image):
        return DRAW_IMAGE
    raise TypeError(f"unsupported brush type {type(brush)}")


class Scene:
    """Records drawing commands into an Encoding."""

    def __init__(self):
        self.encoding = Encoding()
        self._layer_depth = 0

    def reset(self):
        self.encoding.reset()
        self._layer_depth = 0

    # ------------------------------------------------------------------
    def fill(self, style: Union[Fill, int], transform: Affine, brush: Brush,
             brush_transform: Optional[Affine], path: BezPath) -> None:
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill(int(style)))
        if not self.encoding.encode_path(path, is_fill=True):
            return
        self.encoding.encode_draw(DrawRecord(
            kind=_brush_kind(brush), fill_rule=int(style), brush=brush,
            brush_transform=brush_transform))

    def fill_batch(self, style: Union[Fill, int], transform: Affine,
                   colors: np.ndarray, pts: np.ndarray,
                   seg_kind: str = "cubic") -> None:
        """Batched solid-color fills: N closed single-subpath paths with a
        uniform segment kind, one vectorised encode + ONE draw record.

        colors: (N, 4) straight-alpha RGBA in [0, 1].
        pts: (N, 1 + k*s, 2) f32 — moveto + k segments (s = 1 line /
        2 quad / 3 cubic control points each); each path must end at its
        start point. The per-path loop equivalent costs ~75 us/path in
        Python (2.3 s at mmark-30k); this costs ~3 us/path."""
        kind_n = {"line": 1, "quad": 2, "cubic": 3}[seg_kind]
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 4)
        if colors.shape[0] != np.asarray(pts).shape[0]:
            raise ValueError("colors/pts batch size mismatch")
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill(int(style)))
        n = self.encoding.encode_path_batch(pts, kind_n)
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_COLOR, fill_rule=int(style), batch_colors=colors))
        del n

    def stroke_batch(self, style: Stroke, transform: Affine,
                     colors: np.ndarray, pts: np.ndarray,
                     widths=None, expand: str = "auto") -> None:
        """Batched solid-color strokes: N open cubic paths.

        expand="device" (default for bevel joins + butt caps, no dash):
        ONLY the centerline cubics + per-path widths are encoded; the
        device flatten offsets/joins them in-frame (the reference's
        flatten.wgsl:328-630 strategy) — the upload stays at segment
        scale instead of outline scale (~16x for stroke-heavy scenes).
        expand="host": vectorised host outline expansion (any join/cap
        style; ~3 us/path). "auto" picks device when eligible.

        colors: (N, 4) straight-alpha RGBA. pts: (N, 1 + 3k, 2) f32 —
        start point + k cubic segments per path (elevate lines/quads
        exactly: line c1 = p0 + (p1-p0)/3 etc.). widths: optional (N,)
        per-path stroke widths overriding style.width."""
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 4)
        if colors.shape[0] != np.asarray(pts).shape[0]:
            raise ValueError("colors/pts batch size mismatch")
        if style.dash_pattern:
            # dashing needs the per-path host pipeline (Scene.stroke);
            # silently rendering solid would misreport the style.
            raise ValueError("stroke_batch does not support dash_pattern; "
                             "use Scene.stroke per path")
        eligible = (style.join == "bevel" and style.start_cap == "butt"
                    and style.end_cap == "butt")
        if expand == "auto":
            expand = "device" if eligible else "host"
        w = style.width if widths is None else widths
        if expand == "device":
            if not eligible:
                raise ValueError("device stroke expansion supports bevel "
                                 "joins + butt caps; use expand='host'")
            n = np.asarray(pts).shape[0]
            self.encoding.encode_transform(transform)
            self.encoding.encode_stroke_path_batch(
                pts, np.broadcast_to(np.asarray(w, np.float64), (n,)))
            self.encoding.encode_draw(DrawRecord(
                kind=DRAW_COLOR, fill_rule=int(Fill.NON_ZERO),
                batch_colors=colors))
            return
        from .stroke import expand_stroke_batch
        cat, sizes, path_of = expand_stroke_batch(pts, w, style, transform)
        if not len(sizes):
            return
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill.NON_ZERO)
        self.encoding.encode_polygons_flat(cat, sizes)
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_COLOR, fill_rule=int(Fill.NON_ZERO),
            batch_colors=colors[path_of]))

    def stroke(self, style: Stroke, transform: Affine, brush: Brush,
               brush_transform: Optional[Affine], path: BezPath) -> None:
        if style.width <= 0:
            return
        outlines = expand_stroke(path, style, transform)
        if not outlines:
            return
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill.NON_ZERO)
        if not self.encoding.encode_polygons(outlines):
            return
        self.encoding.encode_draw(DrawRecord(
            kind=_brush_kind(brush), fill_rule=int(Fill.NON_ZERO),
            brush=brush, brush_transform=brush_transform))

    # ------------------------------------------------------------------
    def push_layer(self, blend: Union[BlendMode, Mix], alpha: float,
                   transform: Affine, clip_path: Optional[BezPath],
                   fill_rule: Fill = Fill.NON_ZERO,
                   layer_filter: Optional[tuple] = None) -> None:
        if isinstance(blend, Mix):
            blend = BlendMode(blend, Compose.SRC_OVER)
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(fill_rule)
        has_path = clip_path is not None and self.encoding.encode_path(
            clip_path, is_fill=True)
        if clip_path is not None and not has_path:
            # Empty clip shape: encode a degenerate full-viewport-less clip
            # by using an empty rect — nothing inside the layer will show.
            has_path = self.encoding.encode_path(
                rect_path(0.0, 0.0, 0.0, 0.0), is_fill=True)
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_BEGIN_LAYER, blend=blend, alpha=float(alpha),
            has_path=bool(has_path), fill_rule=int(fill_rule),
            layer_filter=layer_filter))
        self.encoding.n_open_layers += 1
        self._layer_depth += 1

    def push_blur_layer(self, std_dev: float, alpha: float = 1.0,
                        transform: Affine = None,
                        clip_path: Optional[BezPath] = None) -> None:
        """Layer whose content is gaussian-blurred at pop (the sparse-strips
        gaussian_blur filter, vello_cpu/src/filter/gaussian_blur.rs)."""
        from .ops.filters import FILTER_BLUR
        self.push_layer(BlendMode(), alpha, transform or Affine.IDENTITY,
                        clip_path,
                        layer_filter=(FILTER_BLUR, float(std_dev), 0, 0,
                                      0.0, 0.0, 0.0, 0.0))

    def push_drop_shadow_layer(self, dx: float, dy: float, std_dev: float,
                               color: Color, alpha: float = 1.0,
                               transform: Affine = None,
                               clip_path: Optional[BezPath] = None) -> None:
        from .ops.filters import FILTER_DROP_SHADOW
        self.push_layer(BlendMode(), alpha, transform or Affine.IDENTITY,
                        clip_path,
                        layer_filter=(FILTER_DROP_SHADOW, float(std_dev),
                                      int(dx), int(dy), color.r, color.g,
                                      color.b, color.a))

    def push_offset_layer(self, dx: float, dy: float, alpha: float = 1.0,
                          transform: Affine = None,
                          clip_path: Optional[BezPath] = None) -> None:
        from .ops.filters import FILTER_OFFSET
        self.push_layer(BlendMode(), alpha, transform or Affine.IDENTITY,
                        clip_path,
                        layer_filter=(FILTER_OFFSET, 0.0, int(dx), int(dy),
                                      0.0, 0.0, 0.0, 0.0))

    def push_flood_layer(self, color: Color, alpha: float = 1.0,
                         transform: Affine = None,
                         clip_path: Optional[BezPath] = None) -> None:
        from .ops.filters import FILTER_FLOOD
        self.push_layer(BlendMode(), alpha, transform or Affine.IDENTITY,
                        clip_path,
                        layer_filter=(FILTER_FLOOD, 0.0, 0, 0, color.r,
                                      color.g, color.b, color.a))

    def push_luminance_mask_layer(self, alpha: float, transform: Affine,
                                  clip_path: Optional[BezPath],
                                  fill_rule: Fill = Fill.NON_ZERO) -> None:
        """Content drawn in this layer becomes a luminance mask over the
        prior content (reference: Scene::push_luminance_mask_layer,
        scene.rs:154-168)."""
        self.push_layer(BlendMode(Mix.LUMINANCE_MASK, Compose.SRC_OVER),
                        alpha, transform, clip_path, fill_rule)

    def push_alpha_mask_layer(self, alpha: float, transform: Affine,
                              clip_path: Optional[BezPath],
                              fill_rule: Fill = Fill.NON_ZERO) -> None:
        """Content drawn in this layer masks the prior content by its
        ALPHA (reference Mask::new_alpha, vello_common/src/mask.rs, as a
        layer; luminance variant above)."""
        self.push_layer(BlendMode(Mix.ALPHA_MASK, Compose.SRC_OVER),
                        alpha, transform, clip_path, fill_rule)

    def push_clip_layer(self, transform: Affine, clip_path: BezPath,
                        fill_rule: Fill = Fill.NON_ZERO,
                        style: Optional[Stroke] = None) -> None:
        """Clip to a filled shape, or — when ``style`` is a Stroke — to the
        stroked outline of the path (reference: Scene::push_clip_layer
        accepts any StyleRef, scene.rs:172-210)."""
        if style is not None:
            outlines = expand_stroke(clip_path, style, transform)
            merged = BezPath()
            for poly in outlines:
                merged.move_to(float(poly[0, 0]), float(poly[0, 1]))
                for px, py in poly[1:]:
                    merged.line_to(float(px), float(py))
                merged.close()
            clip_path = merged
            fill_rule = Fill.NON_ZERO
        self.push_layer(BlendMode(Mix.CLIP, Compose.SRC_OVER), 1.0,
                        transform, clip_path, fill_rule)

    def pop_layer(self) -> None:
        if self._layer_depth == 0:
            return
        self.encoding.encode_draw(DrawRecord(kind=DRAW_END_LAYER,
                                             has_path=False))
        self.encoding.n_open_layers -= 1
        self._layer_depth -= 1

    # ------------------------------------------------------------------
    def draw_image(self, image: Image, transform: Affine) -> None:
        """Draw an image; the unit rect of the image maps through transform
        scaled by the image dimensions (reference: scene.rs draw_image)."""
        w, h = float(image.width), float(image.height)
        self.fill(Fill.NON_ZERO, transform, image, None,
                  rect_path(0.0, 0.0, w, h))

    def draw_blurred_rounded_rect(self, transform: Affine, rect: Rect,
                                  brush: Color, radius: float,
                                  std_dev: float,
                                  inverse: bool = False) -> None:
        """``inverse`` paints 1-coverage (opaque outside the blurred rect,
        fading inside) within the same inflated region — inset box shadows
        (reference vello_cpu/src/render.rs fill_blurred_rounded_rect
        invert)."""
        # Blur extends ~2.5 sigma beyond the rect.
        pad = 2.5 * std_dev
        region = rect_path(rect.x0 - pad, rect.y0 - pad,
                           rect.x1 + pad, rect.y1 + pad)
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill.NON_ZERO)
        if not self.encoding.encode_path(region, is_fill=True):
            return
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_BLUR_RECT, brush=brush,
            blur_rect=(rect.x0, rect.y0, rect.x1, rect.y1),
            blur_radius=float(radius), blur_std_dev=float(std_dev),
            blur_inverse=inverse))

    def draw_blurred_rounded_rect_in(self, shape: BezPath, transform: Affine,
                                     rect: Rect, brush: Color,
                                     radius: float, std_dev: float,
                                     inverse: bool = False) -> None:
        """Blurred rounded rect evaluated only inside an explicit region
        shape (reference: Scene::draw_blurred_rounded_rect_in,
        vello/src/scene.rs)."""
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill.NON_ZERO)
        if not self.encoding.encode_path(shape, is_fill=True):
            return
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_BLUR_RECT, brush=brush,
            blur_rect=(rect.x0, rect.y0, rect.x1, rect.y1),
            blur_radius=float(radius), blur_std_dev=float(std_dev),
            blur_inverse=inverse))

    def append(self, other: "Scene", transform: Optional[Affine] = None):
        self.encoding.append(other.encoding, transform)

    # ------------------------------------------------------------------
    def draw_glyphs(self, font):
        """Glyph-run builder (reference: Scene::draw_glyphs,
        scene.rs:455-470). Returns a DrawGlyphs builder."""
        from .text import DrawGlyphs
        return DrawGlyphs(self, font)

    def draw_text(self, text: str, x: float, y: float, size: float,
                  brush: Brush, transform: Affine = None, font=None) -> None:
        """Convenience: layout (advances-only) + draw."""
        from .text import default_font, layout_text
        font = font or default_font()
        glyphs = layout_text(font, size, text, (x, y))
        (self.draw_glyphs(font).font_size(size).brush(brush)
         .transform(transform or Affine.IDENTITY)
         .draw(Fill.NON_ZERO, glyphs))
