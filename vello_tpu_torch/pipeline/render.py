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
  coverage into src rows] -> occlusion walk starts (one kernel beside K4)
  -> solid composite (K4) or src composite (K6) -> image.

Everything between the kernels is library PyTorch (sort, searchsorted,
cumsum, index). Shapes are static per capacity tier and nothing
reads back to the host inside a frame: the overflow word is the one value
the caller reads, at the end.

Under ``parallel/mesh.py`` a frame takes two more arguments, as the JAX
package's does: ``stripe`` (first tile row, tile rows) renders one
framebuffer stripe (fragments outside it go to the dump key and the
composite walks the stripe's tiles), and ``geom`` (``GeomShards``) shards
the geometry by tag slices over a process group: each rank flattens and
expands only its slice, at 1/n of the line, touch and edge capacities,
and the partial results are combined by all-reduce (area: the backdrop
sums and the raw coverage sums of K5's raw entry, before the backdrop and
fill rule; msaa: path-aligned slices, so that each fragment's touches and
backdrop lie on one rank, the live mask and the coverage rows after K3).
Fused geometry (K1) is off under ``geom``.

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
from typing import Any, Tuple

import torch
import torch.distributed as dist

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


@dataclass(frozen=True)
class GeomShards:
    """The geometry sharding of a frame (the JAX package's ``geom_axis``
    and ``geom_shards``): the process group of the ranks that share the
    frame's geometry, this rank's index in it, and the shard count."""

    group: Any
    index: int
    shards: int

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the group, in place (every rank gets the
        same values); returns ``t``."""
        dist.all_reduce(t, op=op, group=self.group)
        return t


def shard_capacities(caps: Capacities, n: int):
    """Per-shard (lines, touches, edges) capacities, exactly as the JAX
    package computes them (``vello_tpu/pipeline/render.py:280-286``), so
    that the overflow bits and retries match its: the touch capacity is
    rounded up to 1024."""
    nl = max(caps.n_lines // n, 1024)
    nt = -(-max(caps.n_touches // n, 1024) // 1024) * 1024
    ne = max(caps.n_edges // n, 256)
    return nl, nt, ne


def _shard_slots(decoded, bufs, static, caps, geom):
    """This rank's tag slots of the decoded stream: slot kinds outside its
    span set to 0 (inert). Real slots fill the first ``n_tags_real``, so
    each rank takes a ceil(real / n) span. msaa snaps the span's bounds up
    to path boundaries (``path_tag_bounds``) and masks the full window;
    area slices a window of ceil(n_tags / n) slots holding the span. (The
    JAX package's window is floor(n_tags / n) slots, its
    ``render.py:271-279``: when n does not divide n_tags and the real
    slots nearly fill them, a span is longer than its window and the
    slots past the window are dropped with no overflow bit.)"""
    dev = decoded["kind"].device
    k = geom.index
    n_real = bufs["n_tags_real"].to(torch.int32)
    share = (n_real + geom.shards - 1) // geom.shards
    if static.aa in ("msaa8", "msaa16"):
        lo = k * share
        hi = torch.minimum((k + 1) * share, n_real)
        ptb = bufs["path_tag_bounds"]
        pmax = ptb.shape[0] - 1

        def snap(i):
            j = torch.searchsorted(ptb, i.reshape(1), side="left")
            return ptb[j.clamp_max(pmax)][0]
        lo, hi = snap(lo), snap(hi)
        gidx = torch.arange(caps.n_tags, dtype=torch.int32, device=dev)
    else:
        chunk = -(-caps.n_tags // geom.shards)
        start = torch.clamp_max(k * share, caps.n_tags - chunk)
        gidx = start + torch.arange(chunk, dtype=torch.int32, device=dev)
        decoded = {key: v[gidx.long()] for key, v in decoded.items()}
        lo, hi = k * share, (k + 1) * share
    active = (gidx >= lo) & (gidx < hi)
    decoded["kind"] = torch.where(active, decoded["kind"], 0)
    return decoded


def _geometry(bufs, static, caps, rects, W, H, geom=None):
    """Flatten and touch expansion, fused or unfused
    (``static.fused_geom``; always unfused under ``geom``, on this rank's
    tag slots at its shard's capacities): (touches {"ftile", "pay",
    "overflow"}, the geometry overflow bits)."""
    if static.fused_geom and geom is None:
        with stage("s02_flatten"):
            ff = flatten_ops.flatten_fused(
                bufs["seg_pts"], bufs["seg_kind"], bufs["seg_path"],
                bufs["n_segs"], caps.n_lines, W, H, rects,
                seg_hw=bufs["seg_hw"] if static.has_stroke else None,
                seg_join=bufs["seg_join"] if static.has_stroke else None,
                max_lines=static.max_lines)
        with stage("s03_touch_expand"):
            touches = tiling.make_touches_from_linepack(
                ff["linepack"], ff["total_lines"], caps.n_touches,
                caps.n_edges, has_edge=static.has_edge)
        return touches, ff["overflow"] + 2 * touches["overflow_edges"]
    n_lines, n_touches, n_edges = caps.n_lines, caps.n_touches, caps.n_edges
    with stage("s02_flatten"):
        decoded = pathtag.decode_and_transform(
            bufs["tags"], bufs["data"], bufs["transforms"], bufs["styles"],
            style_hw=bufs["style_hw"] if static.has_stroke else None)
        if geom is not None:
            decoded = _shard_slots(decoded, bufs, static, caps, geom)
            n_lines, n_touches, n_edges = shard_capacities(caps,
                                                           geom.shards)
        fl = flatten_ops.flatten(decoded, n_lines, n_edges, W, H,
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
            n_touches,
            line_rect=torch.cat([fl["edge_rect"], fl["line_rect"]]),
            line_real=lreal)
    return touches, fl["overflow"]


def prepare_fragments(bufs: dict, static: PipelineStatic,
                      keep_clip_paths: bool = False, stripe=None,
                      geom: GeomShards = None) -> dict:
    """Geometry + coverage: the live fragments sorted by (gtile, path),
    with their coverage rows and colors, the overflow word, and the
    stripe's tile count ``n_loc`` and tile rows ``ht_local``.

    ``stripe`` (first tile row, tile rows): gtile is stripe-local and the
    fragments outside the stripe go to the dump key. ``geom``: the
    geometry sharded over its group (see the module docstring).

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
    touches, geom_overflow = _geometry(bufs, static, caps, rects, W, H,
                                       geom)
    msaa = static.aa in ("msaa8", "msaa16")

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
        if geom is not None and not msaa:
            # area: the backdrop deltas are additive across the shards.
            # msaa's never are reduced: its coverage rows are combined
            # after the fill rule, which is exact only where the ranks
            # that do not own a path see zero backdrop
            geom.all_reduce(bd_sum)
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
    with stage("s06_coverage"):
        if not msaa and geom is None:
            # exact-area coverage of every fragment, fill rule and centers
            # threshold applied, invalid fragments 0
            coverage = kernels.coverage_area(trow, starts, backdrop, rule,
                                             tvalid, static.aa == "centers")
        elif not msaa:
            # sharded: the raw sums are additive across the shards; one
            # all-reduce, then what K5 applies (the JAX package's order)
            raw = geom.all_reduce(kernels.coverage_area_raw(trow, starts))
            coverage = fine.apply_fill_rule(backdrop[:, None] + raw,
                                            rule[:, None])
            if static.aa == "centers":
                coverage = torch.where(coverage >= 0.5, 1.0, 0.0)
            coverage = torch.where(tvalid[:, None], coverage, 0.0)
        if static.n_live:
            if msaa:
                has_t = starts[1:] > starts[:-1]
                cov_empty = fine.apply_fill_rule(backdrop, rule)
                live = has_t | (cov_empty > 1.0 / 512.0)
                if geom is not None:
                    # the live mask keys the fragment sort, which must be
                    # the same on every rank for the coverage all-reduce
                    # to align: live on any rank (its owner)
                    live = geom.all_reduce(live.to(torch.int32),
                                           dist.ReduceOp.MAX) > 0
            else:
                live = torch.amax(coverage, dim=1) > 1.0 / 512.0

    ty_lo, ht_local = (0, HT) if stripe is None else stripe
    n_loc = WT * ht_local
    # sharded msaa sums the ranks' coverage rows in sort order, so that
    # order must be the same on every rank of the group, which renders
    # other stripes: each sorts the frame's fragments, and its stripe is
    # then a contiguous run of them (the JAX package sorts per stripe
    # before its coverage psum, and so sums rows of different fragments
    # on its Pallas path). The live cap then holds the frame's live
    # fragments, as on one device.
    frame_order = geom is not None and msaa
    s_lo, s_ht = (0, HT) if frame_order else (ty_lo, ht_local)
    with stage("s07_fragment_sort"):
        # live cull; culled fragments, and those outside the stripe, sort
        # past the live cap
        n_sort = WT * s_ht
        owned = tvalid & (tx < WT) & (ty >= s_lo) & (ty < s_lo + s_ht)
        overflow_live = torch.zeros((), dtype=torch.int32, device=dev)
        if static.n_live:
            owned = owned & live
            overflow_live = 16 * (owned.sum() > static.n_live).to(
                torch.int32)
        gtile = torch.where(owned, (ty - s_lo) * WT + tx, n_sort)
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
            if geom is not None:
                # exact k/ns on the owning rank, 0 on the others
                geom.all_reduce(coverage_s)
        else:
            coverage_s = coverage[order]
        if frame_order and stripe is not None:
            # the stripe's run [a, b) of the frame's order first, then
            # dump rows
            g0 = ty_lo * WT
            ab = torch.searchsorted(g_s, torch.tensor(
                [g0, g0 + n_loc], dtype=g_s.dtype, device=dev))
            run = ab[0] + torch.arange(g_s.shape[0], device=dev)
            idx = run.clamp_max(g_s.shape[0] - 1)
            g_s = torch.where(run < ab[1], g_s[idx] - g0, n_loc)
            tpath_s, coverage_s, order = (tpath_s[idx], coverage_s[idx],
                                          order[idx])
    overflow = (geom_overflow + 4 * touches["overflow"]
                + 8 * overflow_tiles + overflow_live)
    with stage("s09_paint"):
        prow = bufs["paint_pack"][tpath_s]
        out = {"g_s": g_s, "tpath_s": tpath_s, "coverage_s": coverage_s,
               "overflow": overflow, "n_loc": n_loc, "ht_local": ht_local,
               "stripe": stripe,
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
    is opaque and fully covers the tile: everything below it is hidden
    (``kernels.occlusion_los``). starts_g (n_loc + 1,) are the tiles'
    ranges in the sorted ``g_s``, so every fragment in tile t's range has
    g_s == t < n_loc, and the rows past starts_g[n_loc] (g_s >= n_loc:
    culled, or outside a stripe) are never read. Returns (los, his) i32."""
    if starts_g.shape[0] != n_loc + 1:
        raise ValueError(f"starts_g: {starts_g.shape[0]} entries for "
                         f"{n_loc} tiles")
    return kernels.occlusion_los(coverage_s, opaque, starts_g), starts_g[1:]


def tiles_to_image(tiles, width: int, height: int, u8_out: bool = False,
                   crop_h: bool = True):
    """(G, 4, 256) channel-planar premultiplied tiles of G // WT tile rows
    -> (rows * 16, W, 4) image, f32 premultiplied, or straight-alpha RGBA8
    with ``u8_out``; cropped to ``height`` with ``crop_h`` (a stripe is
    not: the JAX package's ``_tiles_to_image``)."""
    WT = (width + TILE_W - 1) // TILE_W
    rows = tiles.shape[0] // WT
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
    img = tiles.reshape(rows, WT, 4, TILE_H, TILE_W).permute(0, 3, 1, 4, 2)
    img = img.reshape(rows * TILE_H, WT * TILE_W, 4)
    return img[:height, :width] if crop_h else img[:, :width]


def composite_frame(fr: dict, base_color, *, width: int, height: int,
                    u8_out: bool = False):
    """Occlusion + composite (K4 on solid colors, K6 on src rows) + image
    assembly from ``prepare_fragments``' outputs, over its ``n_loc``
    tiles (a stripe's, when it rendered one). Returns (image,
    overflow)."""
    n_loc = fr["n_loc"]
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
        img = tiles_to_image(tiles, width, height, u8_out,
                             crop_h=fr["stripe"] is None)
    return img, fr["overflow"]


def render_frame(bufs: dict, static: PipelineStatic, stripe=None,
                 geom: GeomShards = None, u8_out: bool = False):
    """One flat frame, or with ``stripe`` one stripe of it (uncropped
    rows), its geometry sharded with ``geom``: (image, overflow). The
    counterpart of the JAX package's ``render_frame``."""
    check_supported(static)
    fr = prepare_fragments(bufs, static, stripe=stripe, geom=geom)
    return composite_frame(fr, bufs["base_color"], width=static.width,
                           height=static.height, u8_out=u8_out)


def get_pipeline(static: PipelineStatic, u8_out: bool = False):
    """The frame as a function of the packed device buffers:
    run(bufs) -> (image, overflow). ``u8_out`` emits straight-alpha
    RGBA8 (the reference's render-target format)."""
    check_supported(static)

    def run(bufs):
        return render_frame(bufs, static, u8_out=u8_out)

    return run
