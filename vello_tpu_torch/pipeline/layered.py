"""Layered compositor: clip layers, group alpha, full mix/compose blending
and layer filters (counterpart of ``vello_tpu/pipeline/layered.py``).

The host flattens the scene's layer tree into a *plan*: a sequence of
draws / push / pop ops (``build_layer_plan``, a copy of the JAX package's
with numpy arrays). The device runs the plan op by op over a stack of
(G, 4, 256) tile buffers:

  draws(lo, hi): src-over of the fragments whose path index is in
                 [lo, hi) onto the top buffer, in place (kernel K7);
  push:          a new transparent buffer, with the clip path's per-tile
                 coverage and the layer's alpha;
  pop:           [filter the top buffer], then blend it into its parent
                 (mix/compose, luminance or alpha mask), masked by the clip
                 coverage; an unbalanced layer's content is discarded.

Collapsible clip chains (a clip/normal layer around a single draw) become
per-path coverage multipliers instead of push/pop ops
(``_apply_clip_chains``). The plan is host data, so the op loop runs in
Python and each op launches only its own work: a draws op with an empty
path range launches nothing.

In render_mode "speed" the src rows arrive in bf16 and K7 reads them
through its bf16 instantiation; the coverage rows, the clip coverage of
the pushes and the tile buffers stay f32.

Two entry points share the op loop, as in the JAX package, and differ only
in how a clipped push gets its per-tile clip coverage:
``render_frame_layered_scan`` (the default) looks up the clip path's one
row per tile; ``render_frame_layered`` (``VELLO_TPU_UNROLLED_LAYERS=1``)
sums the clip path's rows per tile with ``segment_sum_sorted``, whose
cumsum is kernel K8. Both give the same frame bit for bit where every
prefix of the coverage is exact in f32 (msaa), and within an ulp of a
prefix otherwise (area).

The JAX package's Pallas walk re-sorts the fragment stream by (draws op,
tile) and gathers every src row, so that one grid step reads one span
across 32 tiles. On the GPU one CTA walks one tile, and within a tile the
(gtile, path)-sorted stream is in path order, so a draws op's rows in tile
g are the contiguous run between the ranks of the keys g*(P+1)+lo and
g*(P+1)+hi: no re-sort and no gather. Clip rows inside a range carry
src = 0 and composite as exact no-ops; dump rows (gtile == G) lie past
every tile's range.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..encoding.config import TILE_H, TILE_W
from ..encoding.encoding import DRAW_BEGIN_LAYER, DRAW_END_LAYER
from ..ops import blend as blend_ops
from ..ops import kernels, segmented
from ..ops.filters import FILTER_NONE, apply_filter_dyn
from ..ops.segmented import lookup_sorted, rank_sorted
from ..utils.profile import stage
from .render import (PipelineStatic, check_supported, prepare_fragments,
                     tiles_to_image)

# op kinds
OP_DRAWS = 0
OP_PUSH = 1
OP_POP = 2
OP_NOP = 3   # pad rows of op_tab

NPX = TILE_H * TILE_W


@dataclass(frozen=True)
class LayerPlanScanKey:
    """The JAX package's compile key of the plan-as-data pipeline: only
    bucketed sizes. The port compiles nothing; it keeps the key so that
    its plan can be held equal to the JAX package's."""

    n_ops: int        # bucketed op count
    depth: int        # bucketed max stack depth
    n_clip_levels: int
    has_filter: bool = False
    n_draws: int = 0  # bucketed DRAWS-op count


@dataclass(frozen=True)
class LayerPlanStatic:
    """Static shape of the layer plan: op kinds + per-pop (mix, compose,
    filter) + max stack depth + collapsed clip-chain levels."""

    ops: Tuple[Tuple, ...]  # (kind, mix, compose, filter_tuple) per op
    max_depth: int
    n_clip_levels: int = 0  # K of the collapsed per-path clip-chain table


_MAX_CHAIN = 8


def _build_layer_tree(rs):
    """Pass 1: draw stream -> layer tree. Children are ('draw', path_ix)
    tuples or child layer dicts."""
    root = {"children": [], "info": None, "parent": None, "discard": False}
    cur = root
    li = 0
    for d in range(len(rs.draw_kind)):
        k = int(rs.draw_kind[d])
        if k == DRAW_BEGIN_LAYER:
            info = rs.layers[li]
            li += 1
            node = {"children": [], "info": info, "parent": cur,
                    "discard": False}
            cur["children"].append(node)
            cur = node
        elif k == DRAW_END_LAYER:
            li += 1
            if cur["parent"] is not None:
                cur = cur["parent"]
        else:
            p = int(rs.draw_path_ix[d])
            if p >= 0:
                # batch records cover draw_path_n consecutive paths
                nb = int(rs.draw_path_n[d]) \
                    if getattr(rs, "draw_path_n", None) is not None else 1
                for pp in range(p, p + max(nb, 1)):
                    cur["children"].append(("draw", pp))
    # unbalanced open layers: content is discarded (reference drops them)
    while cur is not root:
        cur["discard"] = True
        cur = cur["parent"]
    return root


def _collect_chain(node):
    """If node is a collapsible clip chain — normal/clip mix, src-over,
    no filter, exactly one child all the way down to a single geometric
    draw — return (clip_slots, alpha_product, draw_path_ix). Masking a
    SINGLE draw by clip coverage and alpha commutes exactly with src-over
    compositing, so such layers need no tile buffers at all."""
    clips = []
    alpha = 1.0
    depth = 0
    while True:
        info = node["info"]
        if (node["discard"] or info.layer_filter is not None
                or int(info.mix) not in (0, 128) or int(info.compose) != 3
                or len(node["children"]) != 1 or depth >= _MAX_CHAIN):
            return None
        if info.clip_path_ix >= 0:
            clips.append(int(info.clip_path_ix))
        alpha *= float(info.alpha)
        child = node["children"][0]
        if isinstance(child, tuple):
            return clips, alpha, child[1]
        node = child
        depth += 1


def build_layer_plan(rs):
    """Host: flatten the draw stream into the plan.

    Collapsible clip chains become per-path clip-chain entries
    (path_clipalpha) instead of push/pop ops. Returns (plan_static,
    plan_dynamic, scan_key, has_filter); dynamic holds numpy arrays: draw
    ranges (n_draws_ops, 2) i32, clip path ix (n_push,) i32, alpha
    (n_push,) f32, and when chains collapsed path_clipalpha (P, K+1) f32
    [clip slots (-1 = none), alpha product]; then the op table op_tab
    (n_ops_bucket, 6) i32 rows [kind, mix, compose, lo, hi, clip_ix],
    op_alpha, op_filter (n_ops_bucket, 8) f32 and draws_los.
    """
    root = _build_layer_tree(rs)

    ops = []
    ranges = []
    clip_ixs = []
    alphas = []
    P = max(int(len(rs.path_kind)), 1)
    path_clips = np.full((P, _MAX_CHAIN), -1, dtype=np.float32)
    path_alpha = np.ones(P, dtype=np.float32)
    max_k = 0
    state = {"run_lo": 0, "hi": 0, "depth": 0, "max_depth": 0}

    def flush():
        ops.append((OP_DRAWS, 0, 0, None))
        ranges.append((state["run_lo"], state["hi"]))
        state["run_lo"] = state["hi"]

    def emit(children):
        nonlocal max_k
        for ch in children:
            if isinstance(ch, tuple):
                state["hi"] = ch[1] + 1
                continue
            chain = _collect_chain(ch)
            if chain is not None:
                clips, alpha, p = chain
                path_clips[p, :len(clips)] = clips
                path_alpha[p] = alpha
                # a clipless opacity chain still needs the clipalpha
                # table (n_levels >= 1) or its alpha product is dropped
                max_k = max(max_k, len(clips), 1 if alpha != 1.0 else 0)
                state["hi"] = p + 1   # range spans the clip slots + draw;
                continue              # clip slots composite as no-ops
            info = ch["info"]
            flush()
            if info.clip_path_ix >= 0:
                state["hi"] = info.clip_path_ix + 1
            state["run_lo"] = state["hi"]
            ops.append((OP_PUSH, 0, 0, None))
            clip_ixs.append(int(info.clip_path_ix))
            alphas.append(float(info.alpha))
            state["depth"] += 1
            state["max_depth"] = max(state["max_depth"], state["depth"])
            emit(ch["children"])
            flush()
            if ch["discard"]:
                ops.append((OP_POP, -1, -1, None))
            else:
                ops.append((OP_POP, int(info.mix), int(info.compose),
                            tuple(info.layer_filter)
                            if info.layer_filter else None))
            state["depth"] -= 1
            state["run_lo"] = state["hi"]

    emit(root["children"])
    flush()
    # bucket K so chain-length changes keep one shape
    k_lv = 0
    for b in (1, 2, 4, _MAX_CHAIN):
        if max_k <= b:
            k_lv = b if max_k else 0
            break
    static = LayerPlanStatic(ops=tuple(ops),
                             max_depth=max(state["max_depth"], 1),
                             n_clip_levels=k_lv)
    dynamic = {
        "ranges": np.asarray(ranges or [(0, 0)], dtype=np.int32),
        "clip_ix": np.asarray(clip_ixs or [0], dtype=np.int32),
        "alpha": np.asarray(alphas or [1.0], dtype=np.float32),
    }
    if k_lv:
        dynamic["path_clipalpha"] = np.concatenate(
            [path_clips[:, :k_lv], path_alpha[:, None]], axis=1)
    # --- plan-as-data encoding ---
    # op_tab rows: [kind, mix, compose, lo, hi, clip_ix]; kind 3 = NOP pad.
    n_ops = len(ops)
    nb = 4
    while nb < n_ops:
        nb *= 2
    tab = np.zeros((nb, 6), dtype=np.int32)
    tab[n_ops:, 0] = OP_NOP
    op_alpha = np.ones(nb, dtype=np.float32)
    op_filter = np.zeros((nb, 8), dtype=np.float32)
    d_i = p_i = 0
    for i, (kind, mix, compose, lf) in enumerate(ops):
        tab[i, 0] = kind
        tab[i, 1] = mix
        tab[i, 2] = compose
        if kind == OP_DRAWS:
            tab[i, 3:5] = ranges[d_i]
            d_i += 1
        elif kind == OP_PUSH:
            tab[i, 5] = clip_ixs[p_i]
            op_alpha[i] = alphas[p_i]
            p_i += 1
        elif kind == OP_POP and lf is not None:
            op_filter[i, :len(lf)] = lf
    dynamic["op_tab"] = tab
    dynamic["op_alpha"] = op_alpha
    dynamic["op_filter"] = op_filter
    # draws-slot partition of path space (the JAX package's Pallas walk
    # re-sorts by it; kept so the plans compare field by field)
    n_draws = max(d_i, 1)
    nd = 4
    while nd < n_draws:
        nd *= 2
    dlos = np.full(nd, 2 ** 29, dtype=np.int32)
    dlos[:len(ranges)] = [r[0] for r in ranges]
    dynamic["draws_los"] = dlos
    db = 2
    while db < static.max_depth:
        db *= 2
    has_filter = any(op[3] is not None for op in ops)
    scan_key = LayerPlanScanKey(n_ops=nb, depth=db, n_clip_levels=k_lv,
                                has_filter=has_filter, n_draws=nd)
    return static, dynamic, scan_key, has_filter


def nonempty_draws(plan_dyn) -> int:
    """The draws ops with a non-empty path range: K7's launches per
    frame."""
    tab = plan_dyn["op_tab"]
    return int(((tab[:, 0] == OP_DRAWS) & (tab[:, 4] > tab[:, 3])).sum())


def clipped_pushes(plan_dyn) -> int:
    """The pushes with a clip path: K8's launches per unrolled frame."""
    tab = plan_dyn["op_tab"]
    return int(((tab[:, 0] == OP_PUSH) & (tab[:, 5] >= 0)).sum())


def _apply_clip_chains(fr, skey, stride: int, pca) -> None:
    """Collapsed clip chains: multiply each fragment's coverage and src
    (its alpha included) by its chain's clip-path coverages AT THE SAME
    TILE and by the chain's alpha product (the JAX package's order of
    multiplication). ``pca`` is the plan's (P, K+1) path_clipalpha.
    The clip fragment of (gtile, clip path) is found by lookup of the key
    gtile * stride + path in the sorted stream's keys ``skey`` — no tile
    buffers."""
    n_levels = pca.shape[1] - 1
    # dump rows past the viewport may carry a padded path index; the JAX
    # package's gather clamps it, and such rows are never walked
    pc_g = pca[fr["tpath_s"].clamp_max(pca.shape[0] - 1)]   # (F, K+1)
    g_key = fr["g_s"].long() * stride
    cov0 = fr["coverage_s"]
    cmul = pc_g[:, n_levels][:, None]                        # alpha product
    for k in range(n_levels):
        cix = pc_g[:, k].to(torch.int64)
        q = torch.where(cix >= 0, g_key + cix, -1)
        idx, found = lookup_sorted(skey, q)
        ck = torch.where((cix >= 0)[:, None],
                         torch.where(found[:, None], cov0[idx], 0.0), 1.0)
        cmul = cmul * ck
    fr["coverage_s"] = cov0 * cmul
    # in render_mode "speed" the bf16 src times the f32 factors is f32
    # (holding bf16-rounded products), as in the JAX package, and K7 then
    # runs its f32 instantiation
    fr["src_s"] = (fr["src_s"] * cmul[:, None, :]).contiguous()


def _tiles_to_canvas(tiles, WT: int, HT: int):
    """(G, 4, 256) tiles -> the (HT*16, WT*16, 4) image of the padded
    tile grid (the filters run over it, edges at the padded edge)."""
    im = tiles.reshape(HT, WT, 4, TILE_H, TILE_W).permute(0, 3, 1, 4, 2)
    return im.reshape(HT * TILE_H, WT * TILE_W, 4)


def _canvas_to_tiles(im, WT: int, HT: int):
    im = im.reshape(HT, TILE_H, WT, TILE_W, 4).permute(0, 2, 4, 1, 3)
    return im.reshape(HT * WT, 4, NPX).contiguous()


def _ch_last(x):
    return x.transpose(1, 2)


def _pop(parent, top, c, alpha: float, mix: int, compose: int):
    """Blend the popped buffer ``top`` (its layer alpha ``alpha``, clip
    coverage ``c`` (G, 1, 256) or None for 1) into ``parent``: the
    luminance mask (127), the alpha mask (126), or mix/compose with the
    clip mix (128) read as normal, then parent * (1 - c) + blended * c.
    With c = 1 the products by c are exact and skipped."""
    if mix in (126, 127):
        fg = (top * c if c is not None else top) * alpha
        mask = blend_ops.luminance_mask if mix == 127 \
            else blend_ops.alpha_mask
        masked = _ch_last(mask(_ch_last(parent), _ch_last(fg)))
        return (masked if c is None
                else torch.where(c > 0.0, masked, parent)).contiguous()
    blended = _ch_last(blend_ops.blend_mix_compose_dyn(
        _ch_last(parent), _ch_last(top * alpha), 0 if mix == 128 else mix,
        compose))
    if c is None:
        return blended.contiguous()
    return (parent * (1.0 - c) + blended * c).contiguous()


def to_rgba8(img):
    """(H, W, 4) premultiplied f32 -> straight-alpha RGBA8 by the JAX
    package's rule for layered frames (``_to_rgba8_device`` of its
    ``models/renderer.py``): unpremultiply down to alpha 1e-6. The flat
    paths zero rgb below alpha 1/510 instead (``tiles_to_image``)."""
    a = img[..., 3:4].clamp(0.0, 1.0)
    safe = torch.where(a > 1e-6, a, 1.0)
    rgb = (img[..., :3] / safe).clamp(0.0, 1.0)
    return (torch.cat([rgb, a], dim=-1) * 255.0 + 0.5).to(torch.uint8)


def _render_layered(bufs: dict, plan_dyn: dict, static: PipelineStatic,
                    u8_out: bool, unrolled: bool):
    """The op loop of both entry points; ``unrolled`` picks how a clipped
    push gets its clip coverage."""
    fr = prepare_fragments(bufs, static, keep_clip_paths=True)
    WT, HT = static.width_tiles, static.height_tiles
    n_loc = WT * HT
    dev = fr["g_s"].device
    tab = plan_dyn["op_tab"]
    op_alpha = plan_dyn["op_alpha"]
    op_filter = plan_dyn["op_filter"]
    # (the port's s19 also holds the clip-chain lookups, which the JAX
    # package runs outside its scopes)
    with stage("s19_rank_bounds"):
        # (gtile, path) key of the sorted stream; P + 1 exceeds every
        # path index, so the key is ascending along the stream
        P = bufs["paint_pack"].shape[0]
        skey = fr["g_s"].long() * (P + 1) + fr["tpath_s"]
        if "path_clipalpha" in plan_dyn:
            _apply_clip_chains(fr, skey, P + 1, plan_dyn["path_clipalpha"])
        src_s, cov_s = fr["src_s"], fr["coverage_s"]
        tile_key = torch.arange(n_loc, dtype=torch.int64,
                                device=dev) * (P + 1)
        # every draws op's per-tile walk bounds from one searchsorted
        draws = [i for i in range(tab.shape[0])
                 if tab[i, 0] == OP_DRAWS and tab[i, 4] > tab[i, 3]]
        walk = {}
        if draws:
            lohi = torch.from_numpy(tab[draws, 3:5].astype(np.int64)).to(dev)
            w = rank_sorted(skey, (tile_key[None, None, :]
                                   + lohi[:, :, None]).reshape(-1))
            w = w.reshape(len(draws), 2, n_loc)
            walk = {i: (w[j, 0], w[j, 1]) for j, i in enumerate(draws)}
        if not unrolled:
            # every clipped push's clip row per tile, from one searchsorted
            pushes = [i for i in range(tab.shape[0])
                      if tab[i, 0] == OP_PUSH and tab[i, 5] >= 0]
            clip_rows = {}
            if pushes:
                cix = torch.from_numpy(tab[pushes, 5].astype(np.int64)).to(
                    dev)
                idx, found = lookup_sorted(skey, (tile_key[None, :]
                                                  + cix[:, None]).reshape(-1))
                idx = idx.reshape(len(pushes), n_loc)
                found = found.reshape(len(pushes), n_loc)
                clip_rows = {i: (idx[j], found[j])
                             for j, i in enumerate(pushes)}
    if unrolled:
        # the clip path's coverage rows, zero elsewhere, summed per tile
        # (the (tile, path) fragment is unique, so the sum selects it)
        def clip_cov(i):
            sel = (fr["tpath_s"] == int(tab[i, 5]))[:, None]
            covs = torch.where(sel, cov_s, 0.0)
            return segmented.segment_sum_sorted(covs, fr["g_s"],
                                                n_loc)[:, None, :]
    else:
        def clip_cov(i):
            idx, found = clip_rows[i]
            return torch.where(found[:, None], cov_s[idx], 0.0)[:, None, :]

    base = bufs["base_color"]
    base_premul = torch.cat([base[:3] * base[3], base[3:4]])
    stack = [base_premul[None, :, None].expand(n_loc, 4, NPX).contiguous()]
    clips, alphas = [None], [1.0]
    for i in range(tab.shape[0]):
        kind = int(tab[i, 0])
        if kind == OP_DRAWS:
            with stage("s20_op_draws"):
                if i in walk:
                    kernels.composite_over(src_s, stack[-1], *walk[i])
        elif kind == OP_PUSH:
            with stage("s21_op_push"):
                stack.append(torch.zeros((n_loc, 4, NPX),
                                         dtype=torch.float32, device=dev))
                clips.append(clip_cov(i) if tab[i, 5] >= 0 else None)
                alphas.append(float(op_alpha[i]))
        elif kind == OP_POP:
            with stage("s22_op_pop"):
                top, c, alpha = stack.pop(), clips.pop(), alphas.pop()
                mix, compose = int(tab[i, 1]), int(tab[i, 2])
                if mix < 0:        # unbalanced layer: content discarded
                    continue
                fkind = int(op_filter[i, 0])
                if fkind != FILTER_NONE:
                    top = _canvas_to_tiles(apply_filter_dyn(
                        _tiles_to_canvas(top, WT, HT), fkind,
                        op_filter[i, 1:]), WT, HT)
                stack[-1] = _pop(stack[-1], top, c, alpha, mix, compose)
    img = tiles_to_image(stack[0], static.width, static.height)
    return (to_rgba8(img) if u8_out else img), fr["overflow"]


def render_frame_layered_scan(bufs: dict, plan_dyn: dict,
                              static: PipelineStatic, u8_out: bool = False):
    """One layered frame: fragments with their clip paths kept, the plan's
    ops over a stack of tile buffers, then the image. A clipped push looks
    up its clip path's one row per tile. Returns (image, overflow).
    ``plan_dyn`` is ``build_layer_plan``'s, with path_clipalpha (when
    present) a tensor on the buffers' device."""
    return _render_layered(bufs, plan_dyn, static, u8_out, unrolled=False)


def render_frame_layered(bufs: dict, plan_dyn: dict, static: PipelineStatic,
                         u8_out: bool = False):
    """The JAX package's unrolled formulation of the same frame: a clipped
    push masks the coverage rows to its clip path's and sums them per tile
    with ``segment_sum_sorted`` (one launch of K8 per clipped push). The
    JAX package also runs that sum for a push without a clip and discards
    it; here such a push has no clip coverage at all, as on the scan path.
    Draws ops run K7 on their walks, as on the scan path (the JAX package's
    unrolled draws op is the same ordered src-over in XLA)."""
    return _render_layered(bufs, plan_dyn, static, u8_out, unrolled=True)


def get_layered_pipeline(static: PipelineStatic, plan_dyn: dict,
                         u8_out: bool = False):
    """The layered frame as a function of the packed device buffers:
    run(bufs) -> (image, overflow). ``VELLO_TPU_UNROLLED_LAYERS`` set
    selects the unrolled formulation (``render_frame_layered``), as in the
    JAX package; otherwise the scan formulation."""
    check_supported(static)
    frame = (render_frame_layered
             if os.environ.get("VELLO_TPU_UNROLLED_LAYERS")
             else render_frame_layered_scan)

    def run(bufs):
        return frame(bufs, plan_dyn, static, u8_out)

    return run
