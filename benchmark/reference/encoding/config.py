"""Render configuration, capacity tiers and buffer sizing.

Covers the roles of ``vello_encoding/src/config.rs`` (grid + buffer sizing,
``BumpAllocators`` capacities) and ``estimate.rs`` (``BumpEstimator``) in the
reference. There are no bump allocators: every device stage writes into a
fixed-capacity buffer whose size is a *tier* (power-of-two bucket) chosen
per frame by the host-side estimator, so shapes are static per tier
(SURVEY.md §7 architecture stance).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

TILE_W = 16
TILE_H = 16  # 16x16-px tiles, like the reference (shared/config.wgsl:45).

# Flattening tolerance in device pixels (sparse-strips uses 0.25,
# vello_common/src/flatten.rs:16-19; classic uses 0.01 per-segment scaled).
FLATTEN_TOL = 0.25

# Hard cap on lines emitted per path segment on the device (pathological
# segments beyond this render slightly coarser rather than overflowing).
MAX_LINES_PER_SEG = 64


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def next_tier_size(n: int) -> int:
    """Smallest of {2^k, 1.5*2^k} >= n: halves the worst-case padding waste
    of pure power-of-two tiers at the cost of 2x the compile variants (which
    the persistent compilation cache absorbs)."""
    n = max(int(n), 1)
    p = next_pow2(n)
    if n <= (p >> 1) + (p >> 2):  # n <= 0.75 * p  =>  1.5 * p/2 fits
        return (p >> 1) + (p >> 2)
    return p


def next_size(n: int, align: int = 1024) -> int:
    """Fine capacity quantization: next multiple of max(align, 2^k/16) —
    the worst-case pad waste drops from 33% (1.5x tiers) to ~6%. Every
    device stage's cost scales with the CAPACITY, not the live count (a
    measured 20% of the msaa frame was tier padding), so the big per-touch /
    per-line buffers use this; small host-side buffers keep coarse tiers to
    bound the number of compile variants. next_pow2(n-1+1)... uses the
    power covering n itself so a value just past 2^k keeps ~2^k/16 steps."""
    n = max(int(n), 1)
    step = max(align, next_pow2(n) >> 4)
    return (n + step - 1) // step * step


@dataclass(frozen=True)
class Capacities:
    """Static buffer capacities — the shape signature of the device frame.

    Mirrors the reference's BumpAllocators buffer set (config.rs:398-408):
    lines ~ 2^21, seg_counts (our touches) ~ 2^21, tiles (our path-tiles)
    ~ 2^21 at the top tier.
    """

    n_tags: int = 1 << 12        # path tag stream length
    n_points: int = 1 << 13      # path data points
    n_segs: int = 1 << 12        # path segments
    n_lines: int = 1 << 14       # flattened LineSoup
    n_touches: int = 1 << 16     # (line, tile) touch records
    n_path_tiles: int = 1 << 14  # Σ per-path clamped-bbox tile counts
    n_paths: int = 1 << 10
    n_transforms: int = 1 << 10
    n_styles: int = 1 << 8
    n_ramps: int = 1 << 5
    # Left-edge-vertical slots. EVERY edge slot emits >= 1 touch (dummy if
    # dead) to keep the fused expansion's slot space dense, so this must
    # track the estimator's exact crossing count, not a fraction of
    # n_lines — the dummies bill against n_touches.
    n_edges: int = 256

    def key(self) -> Tuple[int, ...]:
        return (self.n_tags, self.n_points, self.n_segs, self.n_lines,
                self.n_touches, self.n_path_tiles, self.n_paths,
                self.n_transforms, self.n_styles, self.n_ramps,
                self.n_edges)


def tier_for(n_tags: int, n_points: int, n_segs: int, est_lines: int,
             est_touches: int, est_path_tiles: int, n_paths: int,
             n_transforms: int, n_styles: int, n_ramps: int,
             est_edges: int = 0) -> Capacities:
    """Pick the smallest power-of-two tier covering the estimates."""
    def up(n, lo):
        return max(lo, next_tier_size(max(int(n), 1)))

    def up_fine(n, lo, align):
        return max(lo, next_size(max(int(n), 1), align))

    return Capacities(
        n_tags=up(n_tags, 256),
        n_points=up(n_points, 256),
        n_segs=up(n_segs, 256),
        # n_lines: multiple of 4096 keeps BLK_F | n_lines and the edge cap
        # (n_lines/4) BLK-aligned; n_touches: multiple of
        # lcm(BLK_X=1024, CK_M=128) = 1024, so the msaa coverage kernel's
        # grid divides the cap exactly and its pad-concat of the whole
        # (T, 8) stream disappears.
        n_lines=up_fine(est_lines, 1024, 4096),
        n_touches=up_fine(est_touches, 2048, 1024),
        n_path_tiles=up_fine(est_path_tiles, 1024, 1024),
        n_paths=up(n_paths, 64),
        n_transforms=up(n_transforms, 64),
        n_styles=up(n_styles, 16),
        n_ramps=up(n_ramps, 4),
        n_edges=up_fine(est_edges + 64, 256, 256),
    )


@dataclass(frozen=True)
class RenderParams:
    """Per-frame parameters (reference: vello/src/lib.rs:354-369)."""

    width: int
    height: int
    base_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    antialiasing: str = "area"   # "area" | "msaa8" | "msaa16"
    # "quality" = f32 fine stages; "speed" = bf16 coverage/paint tensors
    # (the OptimizeSpeed / u8-lowp analog of vello_cpu fine/lowp.rs —
    # bf16's 8-bit mantissa matches u8 output precision).
    render_mode: str = "quality"

    @property
    def width_tiles(self) -> int:
        return (self.width + TILE_W - 1) // TILE_W

    @property
    def height_tiles(self) -> int:
        return (self.height + TILE_H - 1) // TILE_H
