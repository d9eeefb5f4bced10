"""The end-to-end render pipeline for one frame on one device (counterpart
of ``vello_tpu/pipeline/render.py``: the flat path, with area, centers or
msaa coverage, in render_mode "quality" or "speed";
``pipeline/layered.py`` composites scenes with layers from the same
fragments).

Stage order:
  tile alloc -> flatten, with device strokes (K1; or, unfused, the tag
  scan and decode, then the library flatten) -> touch expansion (K2)
  -> coarse sort of touches by flat tile -> segment starts, backdrop sums
  and row prefix -> [area/centers: area coverage of every fragment (K5)]
  -> live cull and (gtile, path) sort -> [msaa: msaa coverage of the live
  sorted fragments (K3)] -> [non-solid paints: paint evaluation times
  coverage into src rows] -> occlusion walk starts -> solid composite (K4)
  or src composite (K6) -> image.

Everything between the kernels is library PyTorch (sort, searchsorted,
cumsum, cummax, index). Shapes are static per capacity tier and nothing
reads back to the host inside a frame: the overflow word is the one value
the caller reads, at the end.

``lowp`` (render_mode "speed", the JAX package's bf16 fine tensors): the
solid colors are rounded to bf16 (K4 computes with them widened, as the
Pallas kernel does), and the non-solid src rows are formed from the bf16
coverage and stored in bf16 (K6 and K7 read them through their bf16
instantiations). The coverage rows that the occlusion walk and K4 read
stay f32.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import torch

from ..encoding.config import TILE_H, TILE_W, Capacities
from ..ops import fine, kernels, tiling
from ..ops import flatten as flatten_ops
from ..ops import pathtag
from ..ops.segmented import segment_starts, segment_sum_from_starts
from ..utils.profile import stage


@dataclass(frozen=True)
class PipelineStatic:
    """Everything that fixes the frame's shapes and branches."""

    caps_key: Tuple[int, ...]
    width: int
    height: int
    kinds_present: Tuple[int, ...]
    aa: str = "area"          # "area" | "centers" | "msaa8" | "msaa16"
    n_live: int = 0           # live-fragment cap after culling (0 = none)
    has_evenodd: bool = True  # any even-odd fill rule in the scene
    lowp: bool = False        # render_mode "speed": bf16 colors and src
    has_edge: bool = True     # geometry may cross the left viewport edge
    has_stroke: bool = False
    max_lines: int = 64       # per-segment flatten subdivision cap
    fused_geom: bool = True   # K1 on compacted segments, else the unfused
                              # path on the tag streams (wants_fused_geom)

    @property
    def width_tiles(self):
        return (self.width + TILE_W - 1) // TILE_W

    @property
    def height_tiles(self):
        return (self.height + TILE_H - 1) // TILE_H


def solid_only(static: PipelineStatic) -> bool:
    """Only solid paints: the composite forms color x coverage itself (K4)
    and no (F, 4, 256) src tensor is materialized."""
    return not any(k in static.kinds_present for k in (1, 2, 3))


def check_supported(static: PipelineStatic) -> None:
    """Raise ValueError for an antialiasing mode the pipeline has not."""
    if static.aa not in ("area", "centers", "msaa8", "msaa16"):
        raise ValueError(f"unknown antialiasing {static.aa!r}")


def wants_fused_geom() -> bool:
    """The fused geometry path (K1 on the host-compacted segments) unless
    ``VELLO_TPU_NO_FUSED_GEOM`` is set; else the unfused path (the tag
    scan and decode, then the library flatten). The JAX package's rule
    without its TPU alignment conditions, which K1 and K2 do not have."""
    return not os.environ.get("VELLO_TPU_NO_FUSED_GEOM")


def _geometry(bufs, static, caps, rects, W, H):
    """Flatten and touch expansion, fused or unfused
    (``static.fused_geom``): (touches {"ftile", "pay", "overflow"}, the
    geometry overflow bits)."""
    if static.fused_geom:
        with stage("s02_flatten"):
            ff = flatten_ops.flatten_fused(
                bufs["seg_pts"], bufs["seg_kind"], bufs["seg_path"],
                bufs["n_segs"], caps.n_lines, W, H, tiling.rect_pack(rects),
                seg_hw=bufs["seg_hw"] if static.has_stroke else None,
                seg_join=bufs["seg_join"] if static.has_stroke else None,
                max_lines=static.max_lines)
        with stage("s03_touch_expand"):
            touches = tiling.make_touches_from_linepack(
                ff["linepack"], ff["total_lines"], caps.n_touches,
                caps.n_edges, has_edge=static.has_edge)
        return touches, ff["overflow"] + 2 * touches["overflow_edges"]
    with stage("s02_flatten"):
        decoded = pathtag.decode_and_transform(
            bufs["tags"], bufs["data"], bufs["transforms"], bufs["styles"],
            style_hw=bufs["style_hw"] if static.has_stroke else None)
        fl = flatten_ops.flatten(decoded, caps.n_lines, caps.n_edges, W, H,
                                 rpack=tiling.rect_pack(rects),
                                 has_stroke=static.has_stroke,
                                 max_lines=static.max_lines)
    with stage("s03_touch_expand"):
        # the edge region first, every slot of it real: each emits at
        # least one touch, so the touch totals match the fused path's and
        # the host estimator's
        lreal = torch.cat([torch.ones_like(fl["edge_valid"]),
                           fl["line_real"]])
        touches = tiling.make_touches(
            torch.cat([fl["edge_lines"], fl["lines"]]),
            torch.cat([fl["edge_path"], fl["line_path"]]), rects,
            caps.n_touches,
            line_rect=torch.cat([fl["edge_rect"], fl["line_rect"]]),
            line_real=lreal)
    return touches, fl["overflow"]


def prepare_fragments(bufs: dict, static: PipelineStatic,
                      keep_clip_paths: bool = False) -> dict:
    """Geometry + coverage: the live fragments sorted by (gtile, path),
    with their coverage rows and colors, and the overflow word.

    ``keep_clip_paths`` (the layered compositor): clip-path fragments stay
    valid, with their coverage, and the src rows are always materialized,
    zero on clip rows. (The JAX package also carries the src alpha as
    ``alpha_s`` for its transmittance composite; the port's walks read it
    from the src rows.)"""
    check_supported(static)
    caps = Capacities(*static.caps_key)
    dev = bufs["path_rect"].device
    H = float(static.height)
    WT, HT = static.width_tiles, static.height_tiles
    # one extra tile column keeps the x-clamp boundary (which deforms
    # crossing geometry) outside the visible area
    WT_alloc = WT + 1
    W = float(WT_alloc * TILE_W)
    F = caps.n_path_tiles

    with stage("s01_tile_alloc"):
        rects = tiling.tile_alloc(bufs["path_rect"], WT_alloc, HT)
        overflow_tiles = (rects["total_tiles"] > F).to(torch.int32)
    touches, geom_overflow = _geometry(bufs, static, caps, rects, W, H)

    with stage("s04_coarse_sort"):
        # touches by flat tile (order within a tile is immaterial: winding
        # sums commute), then one row gather of the payload
        ftile_s, tix_s = torch.sort(touches["ftile"])
        trow = touches["pay"].T[tix_s].contiguous()        # (T, 8)
    # (the JAX package scopes only the segment starts here; the port's
    # stage also holds the backdrop sums and the per-tile metadata)
    with stage("s05_segment_starts"):
        seg_ids = ftile_s.clamp(0, F)
        starts = segment_starts(seg_ids, F)                # (F+1,)
        bd_sum = segment_sum_from_starts(trow[:, 5], starts)
        # backdrop deltas target ftile+1: shift by one fragment
        bd_delta = torch.cat([torch.zeros(1, dtype=torch.float32,
                                          device=dev), bd_sum[:-1]])

        # per flat tile: owning path and tile coordinates
        t = torch.arange(F, dtype=torch.int32, device=dev)
        incl = rects["base"] + rects["areas"]
        tpath = torch.searchsorted(incl, t, side="right", out_int32=True)
        tpath = tpath.clamp(0, caps.n_paths - 1)
        tp = tpath.long()
        is_clip = bufs["path_kind"][tp] != 0
        base = rects["base"][tp]
        stride = rects["stride"][tp].clamp_min(1)
        tvalid = t < rects["total_tiles"]
        if not keep_clip_paths:
            tvalid = tvalid & ~is_clip
        rel = t - base
        tx = rects["tx0"][tp] + rel % stride
        ty = rects["ty0"][tp] + rel // stride
        rule = bufs["fill_rule"][tp]

        # backdrop = inclusive prefix of the deltas along each tile row
        row_start = (base + (rel // stride) * stride).long()
        cbd = torch.cumsum(bd_delta, 0)
        backdrop = cbd - cbd[row_start] + bd_delta[row_start]

    # s06 holds what the live cull reads: area coverage of every fragment
    # (K5), or for msaa whether a fragment has touches or a visible
    # backdrop fill. The port's K3 computes msaa coverage at the sorted
    # live fragments, so the JAX package's s06 kernel and s08 assembly
    # are one launch, under s08.
    msaa = static.aa in ("msaa8", "msaa16")
    with stage("s06_coverage"):
        if not msaa:
            # exact-area coverage of every fragment, fill rule and centers
            # threshold applied, invalid fragments 0
            coverage = kernels.coverage_area(trow, starts, backdrop, rule,
                                             tvalid, static.aa == "centers")
        if static.n_live:
            if msaa:
                has_t = starts[1:] > starts[:-1]
                cov_empty = fine.apply_fill_rule(backdrop, rule)
                live = has_t | (cov_empty > 1.0 / 512.0)
            else:
                live = torch.amax(coverage, dim=1) > 1.0 / 512.0

    with stage("s07_fragment_sort"):
        # live cull; culled fragments sort past the live cap
        n_loc = WT * HT
        owned = tvalid & (tx < WT) & (ty >= 0) & (ty < HT)
        overflow_live = torch.zeros((), dtype=torch.int32, device=dev)
        if static.n_live:
            owned = owned & live
            overflow_live = 16 * (owned.sum() > static.n_live).to(
                torch.int32)
        gtile = torch.where(owned, ty * WT + tx, n_loc)
        # (gtile, draw order) sort as one int64 key; stable, so the culled
        # fragments' order is deterministic too
        key = gtile.long() * caps.n_paths + tp
        _, order = torch.sort(key, stable=True)
        if static.n_live:
            order = order[:static.n_live]
        g_s = gtile[order]
        tpath_s = tp[order]

    with stage("s08_coverage_assembly"):
        if msaa:
            ns = 8 if static.aa == "msaa8" else 16
            coverage_s = kernels.msaa_coverage(
                trow, starts, order.to(torch.int32), backdrop, rule, tvalid,
                ns, static.has_evenodd)
        else:
            coverage_s = coverage[order]
    overflow = (geom_overflow + 4 * touches["overflow"]
                + 8 * overflow_tiles + overflow_live)
    with stage("s09_paint"):
        prow = bufs["paint_pack"][tpath_s]
        out = {"g_s": g_s, "tpath_s": tpath_s, "coverage_s": coverage_s,
               "overflow": overflow,
               # opaque solid fragments drive the occlusion walk
               "opaque_s": (prow[:, 0] == 0.0) & (prow[:, 4] >= 1.0 - 1e-6)}
        if solid_only(static) and not keep_clip_paths:
            col = prow[:, 1:5]
            if static.lowp:
                # the JAX package's bf16 colors, widened to the f32 values
                # its K4 computes with; opacity is read from the rounded
                # alpha there (0.999 rounds to 1.0 and occludes)
                col = col.to(torch.bfloat16).to(torch.float32)
                out["opaque_s"] = (prow[:, 0] == 0.0) & (col[:, 3]
                                                          >= 1.0 - 1e-6)
            out["col_s"] = col.contiguous()
            return out
        # paint evaluated in sorted order: only per-fragment scalars ride
        # the permutation, and all the paint fields ride one row gather
        txy = torch.stack([tx, ty], dim=1)[order]
        src = fine.eval_paints(
            (txy[:, 0] * TILE_W).to(torch.float32),
            (txy[:, 1] * TILE_H).to(torch.float32),
            prow[:, 0].to(torch.int32), prow[:, 1:5], prow[:, 5:17],
            prow[:, 17:23], prow[:, 23:31], prow[:, 31:39], bufs["ramps"],
            bufs["atlas"], frozenset(static.kinds_present))
        if static.lowp:
            # the paint times the bf16-rounded coverage, in f32, then
            # stored in bf16 (the JAX package's f32 x bf16 promotion)
            coverage_s = coverage_s.to(torch.bfloat16).to(torch.float32)
        if keep_clip_paths:
            # clip rows composite as src = 0: zero their coverage in the
            # product (paint * 0 is the 0 the JAX package writes after it)
            is_clip_s = prow[:, 39] != 0
            out["opaque_s"] = out["opaque_s"] & ~is_clip_s
            coverage_s = torch.where(is_clip_s[:, None], 0.0, coverage_s)
        src = src * coverage_s[:, None, :]
        if static.lowp:
            src = src.to(torch.bfloat16)
        out["src_s"] = src.contiguous()
    return out


def occlusion_los(g_s, coverage_s, opaque, n_loc: int, starts_g):
    """Advance each tile's composite-walk start to its LAST fragment that
    is opaque and fully covers the tile: everything below it is hidden.
    Returns (los, his) i32."""
    full = torch.amin(coverage_s, dim=1) >= 1.0 - 1e-6
    cond = opaque & full & (g_s < n_loc)
    idx = torch.arange(g_s.shape[0], dtype=torch.int32, device=g_s.device)
    m = torch.cummax(torch.where(cond, idx, -1), 0).values
    lo0, hi0 = starts_g[:-1], starts_g[1:]
    cover = m[(hi0 - 1).clamp_min(0).long()]
    los = torch.where(hi0 > lo0,
                      torch.minimum(torch.maximum(cover, lo0), hi0), lo0)
    return los, hi0


def tiles_to_image(tiles, width: int, height: int, u8_out: bool = False):
    """(G, 4, 256) channel-planar premultiplied tiles -> (H, W, 4) image,
    f32 premultiplied, or straight-alpha RGBA8 with ``u8_out``."""
    WT = (width + TILE_W - 1) // TILE_W
    HT = (height + TILE_H - 1) // TILE_H
    # enforce the premultiplied invariant 0 <= rgb <= a <= 1
    a = tiles[:, 3:4].clamp(0.0, 1.0)
    rgb = torch.minimum(tiles[:, :3].clamp_min(0.0), a)
    if u8_out:
        # zero rgb where alpha quantizes to u8 0: unpremultiplying float
        # noise would amplify coverage residue (utils.png.to_rgba8 rule)
        vis = a >= 1.0 / 510.0
        safe = torch.where(vis, a, 1.0)
        rgb = torch.where(vis, (rgb / safe).clamp(0.0, 1.0), 0.0)
        tiles = torch.cat([rgb, a], dim=1)
        tiles = (tiles * 255.0 + 0.5).to(torch.uint8)
    else:
        tiles = torch.cat([rgb, a], dim=1)
    img = tiles.reshape(HT, WT, 4, TILE_H, TILE_W).permute(0, 3, 1, 4, 2)
    return img.reshape(HT * TILE_H, WT * TILE_W, 4)[:height, :width]


def composite_frame(fr: dict, base_color, *, width: int, height: int,
                    u8_out: bool = False):
    """Occlusion + composite (K4 on solid colors, K6 on src rows) + image
    assembly from ``prepare_fragments``' outputs. Returns (image,
    overflow)."""
    n_loc = ((width + TILE_W - 1) // TILE_W) * ((height + TILE_H - 1)
                                                // TILE_H)
    with stage("s09b_occlusion"):
        q = torch.arange(n_loc + 1, dtype=fr["g_s"].dtype,
                         device=fr["g_s"].device)
        starts_g = torch.searchsorted(fr["g_s"], q, side="left",
                                      out_int32=True)
        los, his = occlusion_los(fr["g_s"], fr["coverage_s"],
                                 fr["opaque_s"], n_loc, starts_g)
    # (the port's s10 also holds the image assembly, which the JAX
    # package leaves outside its scopes)
    with stage("s10_composite"):
        base_premul = torch.cat([base_color[:3] * base_color[3],
                                 base_color[3:4]])
        if "col_s" in fr:
            tiles = kernels.composite_solid(fr["coverage_s"], fr["col_s"],
                                            base_premul.contiguous(), los,
                                            his)
        else:
            tiles = kernels.composite_src(fr["src_s"],
                                          base_premul.contiguous(), los, his)
        img = tiles_to_image(tiles, width, height, u8_out)
    return img, fr["overflow"]


def get_pipeline(static: PipelineStatic, u8_out: bool = False):
    """The frame as a function of the packed device buffers:
    run(bufs) -> (image, overflow). ``u8_out`` emits straight-alpha
    RGBA8 (the reference's render-target format)."""
    check_supported(static)

    def run(bufs):
        fr = prepare_fragments(bufs, static)
        return composite_frame(fr, bufs["base_color"], width=static.width,
                               height=static.height, u8_out=u8_out)

    return run
