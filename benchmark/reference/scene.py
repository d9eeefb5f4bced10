"""The reference's Scene: a frozen copy of the part of the port's
``Scene`` (``vello_tpu_torch/scene.py``) that the benchmark's scenes
draw with: solid fills and batched solid fills, and batched strokes with
bevel joins and butt caps, whose centerlines and widths are encoded and
expanded by the host flatten (``encoding/host_flatten.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .encoding.encoding import DRAW_COLOR, DrawRecord, Encoding
from .kurbo import Affine, BezPath, Stroke
from .peniko import Color, Fill


class Scene:
    """Records drawing commands into an Encoding."""

    def __init__(self):
        self.encoding = Encoding()

    def fill(self, style: Union[Fill, int], transform: Affine, brush: Color,
             brush_transform: Optional[Affine], path: BezPath) -> None:
        if not isinstance(brush, Color):
            raise TypeError("the reference draws solid colors only")
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill(int(style)))
        if not self.encoding.encode_path(path, is_fill=True):
            return
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_COLOR, fill_rule=int(style), brush=brush,
            brush_transform=brush_transform))

    def fill_batch(self, style: Union[Fill, int], transform: Affine,
                   colors: np.ndarray, pts: np.ndarray,
                   seg_kind: str = "cubic") -> None:
        """N closed single-subpath paths of one segment kind, one draw
        record. colors: (N, 4) straight-alpha RGBA; pts: (N, 1 + k*s, 2),
        moveto + k segments of s points, each path ending at its start."""
        kind_n = {"line": 1, "quad": 2, "cubic": 3}[seg_kind]
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 4)
        if colors.shape[0] != np.asarray(pts).shape[0]:
            raise ValueError("colors/pts batch size mismatch")
        self.encoding.encode_transform(transform)
        self.encoding.encode_fill_style(Fill(int(style)))
        self.encoding.encode_path_batch(pts, kind_n)
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_COLOR, fill_rule=int(style), batch_colors=colors))

    def stroke_batch(self, style: Stroke, transform: Affine,
                     colors: np.ndarray, pts: np.ndarray,
                     widths=None) -> None:
        """N open cubic paths stroked with bevel joins and butt caps: the
        centerlines and per-path widths are encoded. colors: (N, 4)
        straight-alpha RGBA; pts: (N, 1 + 3k, 2), start point + k cubics;
        widths: optional (N,) per-path widths overriding style.width."""
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 4)
        if colors.shape[0] != np.asarray(pts).shape[0]:
            raise ValueError("colors/pts batch size mismatch")
        if (style.dash_pattern or style.join != "bevel"
                or style.start_cap != "butt" or style.end_cap != "butt"):
            raise ValueError("the reference strokes bevel joins and butt "
                             "caps, undashed")
        w = style.width if widths is None else widths
        n = np.asarray(pts).shape[0]
        self.encoding.encode_transform(transform)
        self.encoding.encode_stroke_path_batch(
            pts, np.broadcast_to(np.asarray(w, np.float64), (n,)))
        self.encoding.encode_draw(DrawRecord(
            kind=DRAW_COLOR, fill_rule=int(Fill.NON_ZERO),
            batch_colors=colors))
