"""Device-side path tag scan and segment decode (counterpart of
``vello_tpu/ops/pathtag.py``), the first stage of the unfused geometry
path (``VELLO_TPU_NO_FUSED_GEOM``).

The reference runs a reduce-then-scan over a PathMonoid
(``pathtag_reduce.wgsl`` / ``pathtag_scan.wgsl``). The tag monoid here is a
vector of additive counters, so the scan is one inclusive cumsum per
counter, followed by point gathers that decode each segment's control
points. Tag 0 contributes nothing, so zero-padded streams need no mask.
"""

from __future__ import annotations

import torch


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def pathtag_scan(tags: torch.Tensor) -> dict:
    """tags (T,) i32 -> per-tag-slot scanned fields: kind (0 none, 1 line,
    2 quad, 3 cubic), is_seg, pt_off (the segment's first point),
    path_ix, trans_ix, style_ix."""
    kind = tags & 3
    is_seg = (kind > 0).to(torch.int32)
    end_bit = ((tags >> 2) & 1) * is_seg
    size = kind + end_bit
    pt_off = _cumsum(size) - size             # exclusive: point offset
    tmark = (tags >> 5) & 1
    smark = (tags >> 6) & 1
    pmark = (tags >> 4) & 1
    return {
        "kind": kind,
        "is_seg": is_seg,
        "pt_off": pt_off,
        # a path marker follows its segments; transform and style markers
        # precede theirs (the active one is the count less one)
        "path_ix": _cumsum(pmark) - pmark,
        "trans_ix": (_cumsum(tmark) - 1).clamp_min(0),
        "style_ix": (_cumsum(smark) - 1).clamp_min(0),
    }


def _rows(table: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    return table[ix.clamp(0, max(table.shape[0] - 1, 0)).long()]


def decode_and_transform(tags, data, transforms, styles, data4=None,
                         style_hw=None) -> dict:
    """Decode the segment at every tag slot (kind 0 slots are inert) and
    apply its affine transform.

    data (Pt, 2) f32; transforms (Nt, 6) f32; styles (Ns,) i32. ``data4``
    (Pt, 4, 2), optional: shifted windows, data4[i, k] == data[i + k], so
    that one row gather decodes all four control points (built here by
    four rolls when not given). ``style_hw`` (Ns,) f32, optional: per-style
    stroke half-widths; adds "hw" (device space: scaled by sqrt|det T|)
    and "join" (the segment continues its subpath) per slot.

    Returns {"kind" (T,) i32, "points" (T, 4, 2) f32, "path_ix" (T,) i32,
    "fill_rule" (T,) i32[, "hw" (T,) f32, "join" (T,) i32]}."""
    scan = pathtag_scan(tags)
    kind = scan["kind"]
    is_seg = scan["is_seg"]
    npt = data.shape[0]
    if npt:
        if data4 is None:
            data4 = torch.stack([torch.roll(data, -k, 0) for k in range(4)],
                                dim=1)
        pts = _rows(data4, scan["pt_off"])                 # (T, 4, 2)
        k = torch.arange(4, dtype=kind.dtype, device=kind.device)[None]
        valid = (k <= kind[:, None]) & (is_seg[:, None] == 1)
        pts = torch.where(valid[:, :, None], pts, 0.0)
    else:
        pts = torch.zeros((tags.shape[0], 4, 2), dtype=torch.float32,
                          device=tags.device)
    t = _rows(transforms, scan["trans_ix"])
    x = (pts[..., 0] * t[:, None, 0] + pts[..., 1] * t[:, None, 2]
         + t[:, None, 4])
    y = (pts[..., 0] * t[:, None, 1] + pts[..., 1] * t[:, None, 3]
         + t[:, None, 5])
    tp = torch.where((is_seg == 1)[:, None, None],
                     torch.stack([x, y], dim=-1), 0.0)
    out = {
        "kind": kind * is_seg,
        "points": tp,
        "path_ix": scan["path_ix"],
        "fill_rule": _rows(styles, scan["style_ix"]),
    }
    if style_hw is not None:
        hw = _rows(style_hw, scan["style_ix"])
        det = t[:, 0] * t[:, 3] - t[:, 1] * t[:, 2]
        out["hw"] = hw * torch.sqrt(torch.abs(det))
        out["join"] = (1 - ((tags >> 2) & 1)) * is_seg
    return out
