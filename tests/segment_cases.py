"""Inputs of the fused geometry's segment preparation
(``kernels.segment_prep``), shared by its CPU test against the JAX package
(tests/test_torch_stroke.py) and its test on the card against the plain
version (tests/test_torch_cuda.py). Imports nothing of JAX.

A case is a dict of numpy arrays as ``pack_buffers`` packs them (seg_pts,
seg_kind, seg_path, n_segs, path_rect, and seg_hw and seg_join when the
scene strokes on the device) with the tile grid (wt, ht) and max_lines."""

import numpy as np

from vello_tpu_torch import RenderParams, Scene, resolve
from vello_tpu_torch.encoding.config import (MAX_LINES_PER_SEG, TILE_H,
                                             TILE_W)
from vello_tpu_torch.models.renderer import pack_buffers

# built by hand: every kind at random; the degenerate segments; a padded
# tail past n_segs; each with strokes and fill-only
SYNTHETIC = ("kinds", "degenerate", "padded_tail", "kinds_fill",
             "degenerate_fill")
SIZE = 1600.0
N_PATHS = 200


def mixed_scene(complexity: int, size: float) -> Scene:
    """Filled blobs under device strokes in one scene: fill segments (hw
    0) and stroked ones side by side in the segment arrays."""
    from vello_tpu_torch.scenes.test_scenes import filled_mmark, mmark
    s = Scene()
    s.append(filled_mmark(complexity, size))
    s.append(mmark(complexity, size))
    return s


def scene_case(scene, size: int) -> dict:
    """A scene's segment arrays at size x size in msaa16, packed as the
    Renderer packs them (slim)."""
    params = RenderParams(size, size, antialiasing="msaa16")
    rs = resolve(scene.encoding, params)
    caps = rs.capacities(params)
    bufs = pack_buffers(rs, caps, params, slim=True, paint8=True)
    keys = ["seg_pts", "seg_kind", "seg_path", "n_segs", "path_rect"]
    if rs.has_stroke:
        keys += ["seg_hw", "seg_join"]
    case = {k: bufs[k] for k in keys}
    case.update(wt=(size + TILE_W - 1) // TILE_W + 1,
                ht=(size + TILE_H - 1) // TILE_H, max_lines=rs.max_lines)
    return case


def _points(rng, s):
    """Segments anywhere on and off a SIZE-wide viewport, their controls
    near or far from their ends (Wang counts from 1 to past max_lines)."""
    p0 = rng.uniform(-100.0, SIZE + 100.0, (s, 1, 2))
    reach = rng.choice([1.0, 20.0, 300.0, 3000.0], (s, 1, 1))
    return (p0 + rng.normal(size=(s, 4, 2)) * reach).astype(np.float32)


def _degenerate(rng):
    """(points, kinds, hw, join, path) rows at the edges of the arithmetic:
    zero-length segments of each kind; collinear controls, in order and
    doubling back (turning angles 0 and pi); chords about 1e-12 long (the
    hypot > 1e-12 and l2 > 1e-24 tests); half-widths of 0 with a join
    flag, below the tolerance and huge; kind 0 between live segments;
    path indices below 0 and past the last path."""
    rows = []

    def add(pts, kind, hw, join, path=7):
        rows.append((np.asarray(pts, np.float32).reshape(4, 2), kind, hw,
                     join, path))
    for kind in (1, 2, 3):
        add([[50.0, 60.0]] * 4, kind, 3.0, 1)             # zero-length
        add([[50.0, 60.0]] * 4, kind, 0.0, 1)
    for kind in (2, 3):
        add([[10, 10], [20, 20], [30, 30], [40, 40]], kind, 2.0, 1)
        add([[10, 10], [40, 40], [20, 20], [30, 30]], kind, 2.0, 1)
        add([[10, 10], [40, 10], [0, 10], [20, 10]], kind, 5.0, 1)
    for d in (1e-12, 7e-13, 1.5e-12, 1e-6):
        for kind in (1, 2, 3):
            add([[100.0, 100.0], [100.0 + d, 100.0], [100.0, 100.0 + d],
                 [100.0 + d, 100.0 + d]], kind, 1.5, 1)
            add([[0.0, 0.0], [d, 0.0], [d, d], [0.0, d]], kind, 1.5, 1)
    for hw in (0.0, 1e-3, 0.125, 0.25, 0.2500001, 9e3):
        add([[300, 300], [340, 260], [380, 390], [420, 300]], 3, hw, 1)
    add([[0, 0]] * 4, 0, 0.0, 0)                          # kind 0
    add([[5, 5], [6, 9], [0, 0], [0, 0]], 1, 2.0, 1, path=-5)
    add([[5, 5], [6, 9], [7, 1], [0, 0]], 2, 0.0, 1, path=2 ** 24)
    add([[0, 0]] * 4, 0, 3.0, 1)                          # kind 0, stroked
    add([[8, 8], [9, 9], [0, 0], [0, 0]], 1, 2.0, 1)
    order = rng.permutation(len(rows))
    pts = np.stack([rows[i][0] for i in order])
    kind, hw, join, path = (np.array([rows[i][k] for i in order])
                            for k in range(1, 5))
    return pts, kind, hw, join, path


def synthetic_case(name: str, seed: int = 0) -> dict:
    """One of SYNTHETIC; the stroked cases end with a stroked segment whose
    join flag is set, so that its join normal comes from segment 0."""
    rng = np.random.default_rng(seed)
    s = 3000
    pts = _points(rng, s)
    kind = rng.integers(1, 4, s)
    hw = np.where(rng.uniform(size=s) < 0.5, 0.0,
                  rng.uniform(0.5, 12.0, s))
    join = (rng.uniform(size=s) < 0.6).astype(np.int32)
    path = np.sort(rng.integers(0, N_PATHS, s))
    n_segs = s
    if name.startswith("degenerate"):
        dpts, dkind, dhw, djoin, dpath = _degenerate(rng)
        at = rng.choice(s + 1, len(dkind))
        pts = np.insert(pts, at, dpts, axis=0)
        kind, hw, join, path = (np.insert(a, at, b) for a, b in
                                ((kind, dkind), (hw, dhw), (join, djoin),
                                 (path, dpath)))
        n_segs = len(kind)
    if name == "padded_tail":
        # pack_buffers' padding (kind 0, path 2**24, all else 0), then
        # segments with geometry that n_segs must still zero
        n_segs = len(kind) - 500
        tail = slice(n_segs, n_segs + 250)
        pts[tail], kind[tail], hw[tail], join[tail] = 0.0, 0, 0.0, 0
        path[tail] = 2 ** 24
    hw[-1], join[-1], kind[-1] = 4.0, 1, 3
    rect = rng.integers(0, 90, (N_PATHS, 4)).astype(np.int32)
    rect[:, 2:] += rect[:, :2]
    case = {"seg_pts": pts.astype(np.float32),
            "seg_kind": kind.astype(np.int32),
            "seg_path": path.astype(np.int32),
            "n_segs": np.asarray(n_segs, np.int32), "path_rect": rect,
            "wt": int(SIZE) // TILE_W + 1, "ht": int(SIZE) // TILE_H,
            "max_lines": MAX_LINES_PER_SEG}
    if not name.endswith("_fill"):
        case.update(seg_hw=hw.astype(np.float32),
                    seg_join=join.astype(np.int32))
    return case
