"""Device-side flattening: curves -> line soup with viewport clipping
(counterpart of ``vello_tpu/ops/flatten.py``, fused path only).

Segment-scale work (degree elevation, Wang counts, the count scan) is
PyTorch; the per-line work (cubic evaluation at uniform t, y trim, x clamp,
left-edge detection, DDA touch counts) is kernel K1 in ``ops/kernels.py``.
The f32 op order follows the JAX package so that counts agree bit for bit
with it and with the host estimator.
"""

from __future__ import annotations

import torch

from ..encoding.config import FLATTEN_TOL, MAX_LINES_PER_SEG
from . import kernels
from .kernels import EDGE_EPS


def elevate_to_cubic(points: torch.Tensor, kind: torch.Tensor
                     ) -> torch.Tensor:
    """points (S, 4, 2), kind (S,) 1=line 2=quad 3=cubic -> (S, 4, 2)."""
    p0 = points[:, 0]
    line_p1 = points[:, 1]
    quad_c, quad_p2 = points[:, 1], points[:, 2]
    k = kind[:, None]
    c1 = torch.where(k == 1, p0 + (line_p1 - p0) / 3.0,
                     torch.where(k == 2, p0 + 2.0 / 3.0 * (quad_c - p0),
                                 points[:, 1]))
    c2 = torch.where(k == 1, p0 + 2.0 / 3.0 * (line_p1 - p0),
                     torch.where(k == 2,
                                 quad_p2 + 2.0 / 3.0 * (quad_c - quad_p2),
                                 points[:, 2]))
    p3 = torch.where(k == 1, line_p1,
                     torch.where(k == 2, quad_p2, points[:, 3]))
    return torch.stack([p0, c1, c2, p3], dim=1)


def _hypot(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula, max * sqrt(1 + (min/max)^2), so that the
    Wang counts round exactly as the JAX package's do (torch.hypot may
    differ in the last ulp)."""
    x1, x2 = x1.abs(), x2.abs()
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    return torch.where(hi == 0, hi, hi * torch.sqrt(1.0 + q * q))


def wang_counts(cubics: torch.Tensor, kind: torch.Tensor,
                tol: float = FLATTEN_TOL,
                max_lines: int = MAX_LINES_PER_SEG) -> torch.Tensor:
    """Lines per segment from Wang's bound, (S,) i32; 0 for kind 0."""
    d1 = cubics[:, 0] - 2 * cubics[:, 1] + cubics[:, 2]
    d2 = cubics[:, 1] - 2 * cubics[:, 2] + cubics[:, 3]
    m = 6.0 * torch.maximum(_hypot(d1[..., 0], d1[..., 1]),
                            _hypot(d2[..., 0], d2[..., 1]))
    n = torch.ceil(torch.sqrt(m.clamp_min(0.0) / (8.0 * tol)))
    n = n.clamp(1, max_lines).to(torch.int32)
    n = torch.where(kind == 1, torch.ones_like(n), n)
    return torch.where(kind == 0, torch.zeros_like(n), n)


def expand_by_counts(counts: torch.Tensor, out_size: int):
    """counts (S,) -> (idx, valid, total): output slot j belongs to source
    element idx[j] (the inverse of a bump allocator); slots at or past the
    total are invalid and point at the last element."""
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    pos = torch.arange(out_size, dtype=torch.int32, device=counts.device)
    idx = torch.searchsorted(incl, pos, side="right", out_int32=True)
    idx = idx.clamp(0, max(counts.shape[0] - 1, 0))
    total = incl[-1]
    return idx, pos < total, total


def flatten_fused(seg_pts, seg_kind, seg_path, n_segs, n_lines_cap: int,
                  width: float, height: float, rpack,
                  max_lines: int = MAX_LINES_PER_SEG) -> dict:
    """Host-compacted, transform-folded segments -> the (16, L) line pack
    [qx0, qy0, qx1, qy1, down, tcount, live, crossing, ev_y0, ev_y1,
    rect6] (see ``kernels.flatten_lines``). Returns {"linepack",
    "total_lines", "overflow"}; overflow is 1 when the lines exceed the
    cap."""
    cub = elevate_to_cubic(seg_pts, seg_kind)
    counts = wang_counts(cub, seg_kind, max_lines=max_lines)
    s = cub.shape[0]
    live_seg = torch.arange(s, dtype=torch.int32, device=cub.device) < n_segs
    counts = torch.where(live_seg, counts, torch.zeros_like(counts))
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    total = incl[-1]
    offs = incl - counts
    pclip = seg_path.long().clamp(0, rpack.shape[0] - 1)
    spack = torch.cat([
        cub.reshape(s, 8),
        counts.to(torch.float32)[:, None],
        offs.to(torch.float32)[:, None],
        rpack[pclip]], dim=1).contiguous()                  # (S, 16)
    linepack = kernels.flatten_lines(spack, incl, n_lines_cap, width, height)
    return {"linepack": linepack, "total_lines": total,
            "overflow": (total > n_lines_cap).to(torch.int32)}
