"""Segmented reductions over sorted ids (counterpart of
``vello_tpu/ops/segmented.py``).

The TPU module replaces ``searchsorted`` with sort merges because a binary
search serializes into dependent gathers there; on the GPU
``torch.searchsorted`` is the direct form, as ``torch.sort`` and
``torch.cummin`` are for the module's other merges.
"""

from __future__ import annotations

import torch

from . import kernels


def segment_starts(sorted_ids: torch.Tensor, num_segments: int
                   ) -> torch.Tensor:
    """starts[s] = first index with id >= s, for s in [0, num_segments].
    starts[s+1] doubles as the END of segment s. (num_segments+1,) i32.
    Ids below 0 fall before starts[0] and are ignored (the JAX package
    clips them into segment 0)."""
    q = torch.arange(num_segments + 1, dtype=sorted_ids.dtype,
                     device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, q, side="left", out_int32=True)


def _cumsum0(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over axis 0: a 2-D f32 tensor goes through kernel
    K8 (``kernels.cumsum0``), anything else to ``torch.cumsum``. The JAX
    package sends only arrays of at least 4096 rows and a width divisible
    by 128 to its Pallas kernel; those are TPU layout rules, and K8 takes
    any shape. The dtype is kept (torch.cumsum would widen int32)."""
    if vals.dim() == 2 and vals.dtype == torch.float32:
        return kernels.cumsum0(vals.contiguous())
    return torch.cumsum(vals, 0, dtype=vals.dtype)


def segment_sum_from_starts(vals: torch.Tensor, starts: torch.Tensor
                            ) -> torch.Tensor:
    """Segment sums of (N, ...) vals over axis 0 via one cumsum and ONE
    gather: out[s] = csum[starts[s+1]-1] - csum[starts[s]-1], a start of 0
    read as 0 (a masked gather instead of prepending a zero row)."""
    c = _cumsum0(vals)
    idx = (starts.long() - 1).clamp_min(0)
    mask = (starts > 0).reshape((-1,) + (1,) * (vals.dim() - 1))
    at = torch.where(mask, c[idx], torch.zeros((), dtype=c.dtype,
                                               device=c.device))
    return at[1:] - at[:-1]


def segment_bounds(sorted_ids: torch.Tensor, num_segments: int):
    """(lo, hi) index ranges of each segment in a sorted id array."""
    starts = segment_starts(sorted_ids, num_segments)
    return starts[:-1], starts[1:]


def segment_sum_from_bounds(vals: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor) -> torch.Tensor:
    """sum(vals[lo[s]:hi[s]]) per segment, over axis 0, by differences of a
    cumsum with a zero row in front."""
    c = torch.cumsum(vals, 0, dtype=vals.dtype)
    cpad = torch.cat([torch.zeros((1,) + tuple(vals.shape[1:]),
                                  dtype=c.dtype, device=c.device), c])
    return cpad[hi.long()] - cpad[lo.long()]


def segment_sum_sorted(vals: torch.Tensor, sorted_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum vals (N, ...) into (num_segments, ...) by ascending sorted_ids.

    Ids >= num_segments are ignored (dump segment). Exact for ints; for f32
    the cumsum difference carries about an ulp of the running sum — exact
    where every prefix is representable (msaa coverages, multiples of
    1/16), within an ulp of the prefix otherwise."""
    return segment_sum_from_starts(vals,
                                   segment_starts(sorted_ids, num_segments))


def segment_ends_sorted(sorted_ids: torch.Tensor) -> torch.Tensor:
    """For each element of a sorted id array, the index of the LAST element
    of its segment (a reverse cummin of the boundary indices), (N,) i32."""
    n = sorted_ids.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=sorted_ids.device)
    is_last = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_last[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    e = torch.where(is_last, torch.arange(n, dtype=torch.int32,
                                          device=sorted_ids.device), n)
    ends = torch.cummin(torch.flip(e, [0]), 0).values
    return torch.flip(ends, [0]).clamp_max(n - 1)


def segment_suffix_sum_sorted(vals: torch.Tensor, sorted_ids: torch.Tensor
                              ) -> torch.Tensor:
    """Per-element sum of the LATER elements of its segment (exclusive
    suffix): s_i = sum_{j > i, id_j == id_i} vals_j."""
    c = _cumsum0(vals)
    return c[segment_ends_sorted(sorted_ids).long()] - c


def row_prefix_sum(vals: torch.Tensor, row_start: torch.Tensor
                   ) -> torch.Tensor:
    """Inclusive prefix sum within rows of a flat array; row_start[i] is the
    flat index where element i's row begins."""
    c = torch.cumsum(vals, 0, dtype=vals.dtype)
    rs = row_start.long()
    return c - c[rs] + vals[rs]


def scatter_sum_via_sort(vals: torch.Tensor, ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Unsorted scatter-add: a stable sort by id, then the segmented sum.
    vals is 1-D (one scalar per record)."""
    ids_s, order = torch.sort(ids, stable=True)
    return segment_sum_sorted(vals[order], ids_s, num_segments)


def lookup_sorted(keys: torch.Tensor, queries: torch.Tensor):
    """For each query, the index of the last element of ascending ``keys``
    equal to it: (idx (Q,) int64 clamped into range, found (Q,) bool).
    Keys and queries are int64, so there is no 2^30 wrap as in the JAX
    package's 3-sort merge; a negative query is never found."""
    idx = torch.searchsorted(keys, queries, side="right") - 1
    idx_c = idx.clamp(0, keys.shape[0] - 1)
    found = (idx >= 0) & (keys[idx_c] == queries)
    return idx_c, found


def rank_sorted(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """#keys strictly less than each query (the side='left' insertion
    index), (Q,) i32, over int64 keys and queries."""
    return torch.searchsorted(keys, queries, side="left", out_int32=True)
