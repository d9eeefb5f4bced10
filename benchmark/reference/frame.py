"""A scene's RGBA8 frame from its encoding: the host decode and flatten
(numpy, float64) of the frozen encoder's streams, then ``raster``."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import raster
from .encoding.encoding import DRAW_BEGIN_LAYER, DRAW_END_LAYER, \
    decode_segments
from .encoding.config import FLATTEN_TOL, MAX_LINES_PER_SEG
from .encoding.host_flatten import (elevate_to_cubic, flatten_decoded,
                                    required_max_lines, transform_points)
from .peniko import Color

FLATTEN_THREADS = 8


def solid_paths(encoding):
    """(premultiplied color (P, 4), draw rank (P,)) of a scene of solid
    paths with no layers, in the order they were encoded."""
    colors, n = [], 0
    for rec in encoding.draws:
        if rec.kind in (DRAW_BEGIN_LAYER, DRAW_END_LAYER):
            raise ValueError("the reference renders no layers")
        if rec.batch_colors is not None:
            c = np.asarray(rec.batch_colors, np.float64).copy()
        elif isinstance(rec.brush, Color):
            c = np.asarray([[rec.brush.r, rec.brush.g, rec.brush.b,
                             rec.brush.a]], np.float64)
        else:
            raise ValueError("the reference renders solid colors only")
        c[:, :3] *= c[:, 3:4]
        colors.append(c)
        n += len(c)
    if n != encoding.n_paths:
        raise ValueError("a draw without its path")
    return np.concatenate(colors), np.arange(n)


def flatten(decoded):
    """``flatten_decoded`` in threads over blocks of whole paths (numpy
    releases the interpreter in its array operations): each segment's
    lines depend on it and on the next segment of its path only, and every
    block takes the whole scene's cap of lines per segment."""
    n = len(decoded["kind"])
    pts = transform_points(decoded["points"].astype(np.float64),
                           decoded["transform"].astype(np.float64))
    cap = max(MAX_LINES_PER_SEG, required_max_lines(
        elevate_to_cubic(pts, decoded["kind"]), decoded["kind"],
        FLATTEN_TOL))
    path = decoded["path_ix"]
    cuts = np.searchsorted(path, path[np.linspace(
        0, n, FLATTEN_THREADS + 1).astype(np.int64)[1:-1]])
    bounds = [0, *sorted(set(cuts.tolist()) - {0, n}), n]
    if n == 0 or np.any(np.diff(path) < 0) or len(bounds) < 3:
        return flatten_decoded(decoded, max_lines=cap)
    parts = [{k: v[a:b] if isinstance(v, np.ndarray) else v
              for k, v in decoded.items()}
             for a, b in zip(bounds[:-1], bounds[1:])]
    with ThreadPoolExecutor(len(parts)) as pool:
        out = list(pool.map(lambda d: flatten_decoded(d, max_lines=cap),
                            parts))
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]))


def render_u8(encoding, config: dict, device, dtype=torch.float64):
    """The straight-alpha RGBA8 frame (H, W, 4, torch on ``device``) of the
    configuration's size, antialiasing and base color."""
    color, rank = solid_paths(encoding)
    tags, data, transforms, styles = encoding.packed_streams()
    decoded = decode_segments(tags, data, transforms, styles,
                              style_hw=encoding.style_hw_array())
    rule = np.zeros(len(rank), np.int64)
    uniq, first = np.unique(decoded["path_ix"], return_index=True)
    ok = (uniq >= 0) & (uniq < len(rank))
    rule[uniq[ok]] = decoded["fill_rule"][first[ok]]
    lines, line_path = flatten(decoded)
    r, g, b, a = config["base_color"]
    return raster.render_u8(lines, line_path, rule, color, rank,
                            (r * a, g * a, b * a, a),
                            config["antialiasing"], int(config["width"]),
                            int(config["height"]), device, dtype)
