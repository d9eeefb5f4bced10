"""The yardstick of the kernels' rooflines: a frozen copy of
``chip_smoke.py``'s roofline arithmetic (the operations each kernel's
inputs need, the bytes it has to read and write, ``bound``) against the
published peaks of one NVIDIA H100 SXM, and the capture of one frame's
kernel calls that it is applied to."""

from __future__ import annotations

import inspect

import torch

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): HBM3
# bandwidth and f32 rate outside the tensor cores. The kernels are f32
# scalar code, so the f32 rate is the operations bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the port's kernel wrappers in ``ops/kernels.py`` -> the name ``bound``
# knows them by (K6 and K7 take a ``_bf16`` suffix on bf16 src)
WRAPPERS = {"flatten_lines": "flatten", "expand_touches": "expand_touches",
            "msaa_coverage": "msaa_coverage",
            "composite_solid": "composite_solid",
            "coverage_area": "coverage_area",
            "coverage_area_raw": "coverage_area_raw",
            "composite_src": "composite_src",
            "composite_over": "composite_over", "cumsum0": "cumsum"}
# that name -> the names its CUDA kernels carry in a profiler trace
KERNEL_NAMES = {
    "flatten": ("flatten_kernel",),
    "expand_touches": ("expand_touches_kernel",),
    "msaa_coverage": ("msaa_coverage_kernel",),
    "coverage_area": ("coverage_area_kernel",),
    "coverage_area_raw": ("coverage_area_raw_kernel",),
    "composite_solid": ("composite_solid_kernel",),
    "composite_src": ("composite_src_kernel",),
    "composite_src_bf16": ("composite_src_bf16_kernel",),
    "composite_over": ("composite_over_kernel",),
    "composite_over_bf16": ("composite_over_bf16_kernel",),
    "cumsum": ("cumsum_totals_kernel", "cumsum_carries_kernel",
               "cumsum_rows_kernel"),
}

# f32 operations per unit of work (compares, selects, a divide and integer
# steps count as one each): K4, K6, K7 as counted from their sources; K1,
# K2, K3 and K5 as the function needs them on these inputs, whatever
# computes it (a term is counted once for the inputs it depends on; the
# search for a slot's owner is the kernels' means, not the function's work)
OPS_FILL_SLOT = 181          # K1 per live fill slot: t0, t1 (4), 2 cubic
                             # points (48), y trim (25), alive (8), x clamp
                             # and left edge (47), orientation (5), DDA
                             # count (29), on_right and live (9), outputs (4)
OPS_STROKE_MINI = 142        # K1 per (stroked segment, mini): 3 t (6), 3
                             # cubic points (72), 2 chord normals (21), the
                             # join normal, side and bevel corners (33), the
                             # 7 corner points (8), the collapse (2)
OPS_STROKE_SLOT = 144        # K1 per live stroke slot: mini and edge (7),
                             # the edge's endpoints (10), then a fill slot's
                             # work from the y trim on (127)
OPS_TOUCH_LINE = 69          # K2 per line with a live touch: the DDA setup
                             # (spans, count, a with its correction, b, the
                             # first tile, 1/dxl, 1/dyl)
OPS_PER_TOUCH = 142          # K2 per live touch: z(i-1), z(i), z(i+1), the
                             # tile, ftile, backdrop, the tile clip, the
                             # path_tiling rules, outputs
OPS_MSAA_TOUCH = 10          # K3 per touch: dx, dy, ymin, ymax, the dy == 0
                             # select, 1 / dy, a = inv_dy * dx, two signs
OPS_MSAA_SAMPLE_ROW = 5      # K3 per (touch, tile row, sample): the
                             # crossing test (2 compares, and), the y_edge
                             # compare and add
OPS_MSAA_CROSSING = 7        # K3 per (touch, sample row) it crosses: xt
                             # (3), the step's pixel (subtract, floor,
                             # convert), the step's add
OPS_MSAA_RESOLVE = 5        # K3 per (fragment with touches, pixel,
                             # sample): the step prefix, + backdrop, the
                             # fill rule (2), the sample sum
OPS_AREA_TOUCH = 6           # K5 per touch: dx, dy, the dy == 0 select,
                             # 1 / dy, the sign (2)
OPS_AREA_ROW = 16            # K5 per (touch, tile row): y, y0 (2), y1 (3),
                             # dyc, t0 (2), t1 (2), the y_edge term (5)
OPS_AREA_CROSSED = 21        # K5 per (touch, pixel) of a row the touch
                             # crosses (dyc != 0): startx, x0 and x1 (an
                             # fma each, 2), xmin (3), xmax, b, c, d, the
                             # numerator (6), the denominator, the divide,
                             # * dyc
OPS_AREA_PIXEL = 2           # K5 per (touch, pixel): + edge term, the sum
OPS_AREA_RESOLVE = 4         # K5 per (valid fragment, pixel): + backdrop,
                             # the fill rule (2), the centers threshold
OPS_PER_COMPOSITE = 18       # K4: per fragment and pixel, 4 channels
OPS_PER_SRC_COMPOSITE = 9    # K6: per fragment and pixel, 4 channels
OPS_PER_OVER_COMPOSITE = 9   # K7: per fragment and pixel: 1 - a, then a
                             # multiply and an add per channel



def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def crossed_rows(trow, starts, valid) -> int:
    """The (touch, tile row) pairs of K5's valid fragments with dyc != 0,
    the rows where a pixel's area term is not 0 (the same f32 ops as the
    kernel)."""
    t = trow[:int(starts[-1])]
    own = torch.repeat_interleave(valid, (starts[1:] - starts[:-1]).long(),
                                  output_size=t.shape[0])
    t = t[own]
    rows = torch.arange(16, dtype=torch.float32, device=t.device)
    y = t[:, 1:2] - rows
    dyc = y.clamp(0.0, 1.0) - (y + (t[:, 3:4] - t[:, 1:2])).clamp(0.0, 1.0)
    return int((dyc != 0.0).sum())


def crossed_samples(trow, starts, fidx, valid, ns) -> int:
    """The (touch, sample row) pairs of K3's rows whose crossing test holds,
    ymin <= sy < ymax, over the 16 * ns sample rows sy = y + (s + 0.5) / ns
    of a tile (exact in f32 and ascending, so a touch's count is the
    difference of two searches)."""
    f = fidx.long()
    lo = starts[f].long()
    cnt = ((starts[f + 1] - starts[f]) * valid[f]).long()
    total = int(cnt.sum())
    # the touch index of each (row, touch) pair
    first = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt,
                                    output_size=total)
    t = trow[first + torch.arange(total, device=trow.device)]
    ymin = torch.minimum(t[:, 1], t[:, 3]).contiguous()
    ymax = torch.maximum(t[:, 1], t[:, 3]).contiguous()
    sy = (torch.arange(16, dtype=torch.float32, device=trow.device)[:, None]
          + (torch.arange(ns, dtype=torch.float32, device=trow.device)
             + 0.5) / ns).reshape(-1)
    n = (torch.searchsorted(sy, ymax, side="left")
         - torch.searchsorted(sy, ymin, side="left"))
    return int(n.clamp_min(0).sum())


def _live_slots(incl, n_slots):
    """Per owner of an inclusive count scan, its slots below the live
    total min(incl[-1], n_slots)."""
    incl = incl.long()
    offs = torch.cat([incl.new_zeros(1), incl[:-1]])
    total = min(int(incl[-1]), n_slots)
    return (incl.clamp_max(total) - offs).clamp_min(0)


def _scan_bytes(live) -> int:
    """The bytes of the count scan that finding the owners needs: its
    entries up to the last owner of a live slot, and the last entry (the
    total)."""
    owners = torch.nonzero(live).flatten()
    read = int(owners[-1]) + 1 if owners.numel() else 0
    return 4 * (read + int(read < live.shape[0]))


# K2 reads 13 of a line's 16 fields: not incl (row 6) and the two zero rows
TOUCH_LINE_ROWS = 13


def flatten_units(spack, incl, n_lines) -> dict:
    """K1's live work: fill slots, stroke slots, and the (stroked
    segment, mini) pairs they fall in (7 slots per mini, counted from the
    segment's first slot); and the bytes of its inputs it reads: the
    columns of the segments that own a live slot (16 of a fill-only pack;
    of a 21-column pack, 21 for a stroked segment and for a fill one its
    16 and the stroke flag) and ``_scan_bytes``."""
    live = _live_slots(incl, n_lines)
    stroked = (spack[:, 19] > 0.5 if spack.shape[1] == 21
               else torch.zeros_like(live, dtype=torch.bool))
    st = live[stroked]
    owners = live > 0
    n_st = int((owners & stroked).sum())
    fill_cols = 16 if spack.shape[1] == 16 else 17
    return {"fill_slots": int(live[~stroked].sum()),
            "stroke_slots": int(st.sum()),
            "stroke_minis": int(((st + 6) // 7).sum()),
            "read_bytes": 4 * (21 * n_st + fill_cols
                               * (int(owners.sum()) - n_st))
            + _scan_bytes(live)}


def touch_units(incl, n_touches) -> dict:
    """K2's live work: touches, and the lines they belong to; and the bytes
    of its inputs it reads: ``TOUCH_LINE_ROWS`` fields of each of those
    lines and ``_scan_bytes``."""
    live = _live_slots(incl, n_touches)
    lines = int((live > 0).sum())
    return {"touches": int(live.sum()), "lines": lines,
            "read_bytes": 4 * TOUCH_LINE_ROWS * lines + _scan_bytes(live)}


def bound(name, args, out):
    """(least ms, "bytes" or "operations", the work counted) for one launch
    on these inputs: each input read once (of a composite's fragment rows,
    the ones its walks cover; of K1's and K2's, the rows and scan entries
    of the owners of live slots) and the output written once over the HBM
    rate, against the operations these inputs need over the f32 rate."""
    nbytes = _nbytes(*args, out)
    units = {}
    if name.startswith("flatten"):
        units = flatten_units(*args[:3])
        ops = (units["fill_slots"] * OPS_FILL_SLOT
               + units["stroke_minis"] * OPS_STROKE_MINI
               + units["stroke_slots"] * OPS_STROKE_SLOT)
        nbytes = units["read_bytes"] + _nbytes(out)
    elif name.startswith("expand_touches"):
        units = touch_units(*args[1:3])
        ops = (units["lines"] * OPS_TOUCH_LINE
               + units["touches"] * OPS_PER_TOUCH)
        nbytes = units["read_bytes"] + _nbytes(out)
    elif name.startswith("msaa_coverage"):
        trow, starts, fidx, backdrop, rule, valid, ns = args[:7]
        f = fidx.long()
        cnt = (starts[f + 1] - starts[f]) * valid[f]
        units = {"touches": int(cnt.sum()),
                 "crossings": crossed_samples(trow, starts, fidx, valid, ns),
                 "touched_rows": int((cnt > 0).sum())}
        ops = (units["touches"] * (OPS_MSAA_TOUCH
                                   + 16 * ns * OPS_MSAA_SAMPLE_ROW)
               + units["crossings"] * OPS_MSAA_CROSSING
               + units["touched_rows"] * 256 * ns * OPS_MSAA_RESOLVE)
    elif name.startswith("composite_over"):
        # in place: the walked src rows read (2 bytes a value in bf16),
        # each f32 tile with a non-empty walk read and written once, the
        # bounds read
        src, dst, los, his = args
        walked = int((his - los).clamp_min(0).sum())
        tiles = int((his > los).sum())
        nbytes = (_nbytes(los, his)
                  + walked * src[0].numel() * src.element_size()
                  + 2 * tiles * dst[0].numel() * dst.element_size())
        ops = walked * 256 * OPS_PER_OVER_COMPOSITE
    elif name.startswith("cumsum"):
        ops = args[0].numel()            # one add per element
    elif name.startswith("composite"):
        # a walk reads only its tiles' rows [los, his): the fragments
        # hidden under an opaque full cover, and the rows past the live
        # count, are never read
        rows, los, his = args[:-3], args[-2], args[-1]
        walked = int((his - los).clamp_min(0).sum())
        nbytes = (_nbytes(*args[-3:], out) + walked
                  * sum(r[0].numel() * r.element_size() for r in rows))
        ops = walked * 256 * (OPS_PER_COMPOSITE
                              if name.startswith("composite_solid")
                              else OPS_PER_SRC_COMPOSITE)
    elif name == "coverage_area_raw":
        # every fragment's sums, no backdrop, fill rule or threshold
        trow, starts = args
        valid = torch.ones(starts.shape[0] - 1, dtype=torch.bool,
                           device=trow.device)
        units = {"touches": int(starts[-1] - starts[0]),
                 "crossed_rows": crossed_rows(trow, starts, valid)}
        ops = (units["touches"] * (OPS_AREA_TOUCH + 16 * OPS_AREA_ROW
                                   + 256 * OPS_AREA_PIXEL)
               + units["crossed_rows"] * 16 * OPS_AREA_CROSSED)
    else:
        trow, starts, backdrop, rule, valid = args[:5]
        cnt = (starts[1:] - starts[:-1]) * valid
        units = {"touches": int(cnt.sum()),
                 "crossed_rows": crossed_rows(trow, starts, valid),
                 "valid_fragments": int(valid.sum())}
        ops = (units["touches"] * (OPS_AREA_TOUCH + 16 * OPS_AREA_ROW
                                   + 256 * OPS_AREA_PIXEL)
               + units["crossed_rows"] * 16 * OPS_AREA_CROSSED
               + units["valid_fragments"] * 256 * OPS_AREA_RESOLVE)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            dict(units, ops=ops, bytes=nbytes))



def kernel_of(device_name: str):
    """The ``bound`` name of the port kernel a trace's device event
    belongs to, or None."""
    for name, syms in KERNEL_NAMES.items():
        if any(sym in device_name for sym in syms):
            return name
    return None


def frame_bounds(kernels, frame) -> dict:
    """Run ``frame()`` once with the port's kernel wrappers (module
    ``kernels``) wrapped; returns {bound name: (launches, the sum of their
    bounds in ms)}. Each launch is bounded on its own inputs before it
    runs (K7 updates its buffer in place)."""
    out = {}
    originals = {w: getattr(kernels, w) for w in WRAPPERS
                 if hasattr(kernels, w)}

    def wrap(wname, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            pos = tuple(bound_args.arguments.values())
            name = WRAPPERS[wname]
            if name in ("composite_src", "composite_over") and \
                    pos[0].dtype == torch.bfloat16:
                name += "_bf16"
            if name == "composite_over":
                ms = bound(name, pos, None)[0]
                res = fn(*args, **kwargs)
            else:
                res = fn(*args, **kwargs)
                ms = bound(name, pos, res)[0]
            n, tot = out.get(name, (0, 0.0))
            out[name] = (n + 1, tot + ms)
            return res
        return wrapped

    try:
        for w, fn in originals.items():
            setattr(kernels, w, wrap(w, fn))
        frame()
        torch.cuda.synchronize()
    finally:
        for w, fn in originals.items():
            setattr(kernels, w, fn)
    return out
