"""Segmented reductions over sorted ids (counterpart of
``vello_tpu/ops/segmented.py``).

The TPU module replaces ``searchsorted`` with sort merges because a binary
search serializes into dependent gathers there; on the GPU
``torch.searchsorted`` is the direct form.
"""

from __future__ import annotations

import torch


def segment_starts(sorted_ids: torch.Tensor, num_segments: int
                   ) -> torch.Tensor:
    """starts[s] = first index with id >= s, for s in [0, num_segments].
    starts[s+1] doubles as the END of segment s. (num_segments+1,) i32."""
    q = torch.arange(num_segments + 1, dtype=sorted_ids.dtype,
                     device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, q, side="left", out_int32=True)


def segment_sum_from_starts(vals: torch.Tensor, starts: torch.Tensor
                            ) -> torch.Tensor:
    """1-D segment sums: out[s] = csum[starts[s+1]-1] - csum[starts[s]-1]
    (a start of 0 reads as 0)."""
    c = torch.cumsum(vals, 0)
    idx = (starts.long() - 1).clamp_min(0)
    at = torch.where(starts > 0, c[idx], torch.zeros((), dtype=c.dtype,
                                                     device=c.device))
    return at[1:] - at[:-1]


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
