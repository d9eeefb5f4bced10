"""Debug layers: pipeline-intermediate dumps, overlays, and CPU validation.

Reference roles: ``vello/src/debug{.rs,/renderer.rs,/validate.rs}`` (bbox /
line-soup overlays + watertightness validation) and ``vello_toy`` (SVG dumps
of flatten/tile intermediates).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..encoding.config import TILE_H, TILE_W, RenderParams
from ..encoding.encoding import decode_segments
from ..encoding.resolve import resolve
from ..oracle.renderer import flatten_decoded
from ..scene import Scene


def capture_stages(scene: Scene, params: RenderParams) -> Dict:
    """Host-side capture of pipeline intermediates (the debug-download path:
    vello/src/debug.rs DebugLayers::VALIDATION)."""
    rs = resolve(scene.encoding, params)
    decoded = decode_segments(rs.tags, rs.data, rs.transforms, rs.styles)
    lines, line_path = flatten_decoded(decoded)
    return {
        "resolved": rs,
        "decoded": decoded,
        "lines": lines,
        "line_path": line_path,
        "n_lines": len(lines),
        "path_rect": rs.path_rect,
    }


def validate_line_soup(lines: np.ndarray, line_path: np.ndarray,
                       tol: float = 1e-3) -> List[str]:
    """Watertightness check (validate.rs validate_line_soup): within each
    path, every line start must match some line's end (closed loops).
    Returns a list of problem descriptions (empty = watertight)."""
    problems = []
    for p in np.unique(line_path):
        sel = line_path == p
        starts = lines[sel][:, :2]
        ends = lines[sel][:, 2:]
        if len(starts) == 0:
            continue
        # quantize and compare as sets
        qs = np.round(starts / tol).astype(np.int64)
        qe = np.round(ends / tol).astype(np.int64)
        set_s = set(map(tuple, qs))
        set_e = set(map(tuple, qe))
        dangling = set_s.symmetric_difference(set_e)
        if dangling:
            problems.append(
                f"path {p}: {len(dangling)} unmatched endpoints "
                f"(of {len(starts)} lines)")
    return problems


def overlay_debug(img: np.ndarray, capture: Dict,
                  show_lines: bool = True,
                  show_bboxes: bool = True) -> np.ndarray:
    """Rasterize LINESOUP_SEGMENTS / BOUNDING_BOXES overlays onto a copy of
    the rendered image (debug/renderer.rs role, CPU-side)."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    if show_lines:
        lines = capture["lines"]
        for x0, y0, x1, y1 in lines:
            n = max(2, int(max(abs(x1 - x0), abs(y1 - y0))))
            ts = np.linspace(0, 1, n)
            xs = np.clip((x0 + ts * (x1 - x0)).astype(int), 0, w - 1)
            ys = np.clip((y0 + ts * (y1 - y0)).astype(int), 0, h - 1)
            out[ys, xs] = [0.0, 1.0, 0.0, 1.0]
    if show_bboxes:
        for (tx0, ty0, tx1, ty1) in capture["path_rect"]:
            x0, y0 = tx0 * TILE_W, ty0 * TILE_H
            x1, y1 = min(tx1 * TILE_W, w) - 1, min(ty1 * TILE_H, h) - 1
            if x1 <= x0 or y1 <= y0:
                continue
            out[y0, x0:x1] = [1.0, 0.0, 1.0, 1.0]
            out[min(y1, h - 1), x0:x1] = [1.0, 0.0, 1.0, 1.0]
            out[y0:y1, x0] = [1.0, 0.0, 1.0, 1.0]
            out[y0:y1, min(x1, w - 1)] = [1.0, 0.0, 1.0, 1.0]
    return out


def dump_svg(capture: Dict, path: str, scale: float = 1.0) -> None:
    """Write pipeline intermediates as an SVG (vello_toy/src/debug.rs role):
    flattened line soup colored per path + tile rects."""
    rs = capture["resolved"]
    lines = capture["lines"]
    lp = capture["line_path"]
    colors = ["#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4",
              "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080"]
    parts = ['<svg xmlns="http://www.w3.org/2000/svg">']
    for (tx0, ty0, tx1, ty1) in rs.path_rect:
        parts.append(
            f'<rect x="{tx0 * TILE_W * scale}" y="{ty0 * TILE_H * scale}" '
            f'width="{(tx1 - tx0) * TILE_W * scale}" '
            f'height="{(ty1 - ty0) * TILE_H * scale}" fill="none" '
            f'stroke="#ddd" stroke-width="0.5"/>')
    for (x0, y0, x1, y1), p in zip(lines, lp):
        c = colors[int(p) % len(colors)]
        parts.append(
            f'<line x1="{x0 * scale:.2f}" y1="{y0 * scale:.2f}" '
            f'x2="{x1 * scale:.2f}" y2="{y1 * scale:.2f}" '
            f'stroke="{c}" stroke-width="0.6"/>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
