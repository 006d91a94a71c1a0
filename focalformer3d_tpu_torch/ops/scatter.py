"""Segment reductions over fixed-size tables (the LSS splat's pooling).

Port of ``focalformer3d_tpu/ops/scatter.py`` (``segment_sum``,
``segment_mean``, ``segment_max``, ``bev_pool``) on plain torch ops:
``index_add_`` and ``scatter_reduce_``. As in XLA's scatter, a segment id
outside ``[0, num_segments)`` is dropped: such rows go to one overflow row
past the table, which is cut off. On a card ``index_add_`` adds in the
order its atomics land, so two runs may differ in the last bits of a sum.
"""
from __future__ import annotations

import torch


def _routed(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids as int64, every out-of-range id sent to the overflow row."""
    ids = segment_ids.reshape(-1).long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (N, C), segment_ids (N,); returns (num_segments, C)."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _routed(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int):
    """(per-segment mean, per-segment row count); an empty segment's mean
    is 0."""
    total = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones((data.shape[0], 1))
    count = segment_sum(ones, segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0), count[:, 0]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum; an empty segment holds the dtype's lowest value
    (-inf for floats), as ``jax.ops.segment_max`` gives."""
    low = (-float("inf") if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), low)
    ids = _routed(segment_ids, num_segments)
    ids = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, ids, data, "amax", include_self=True)
    return out[:num_segments]


def bev_pool(feats: torch.Tensor, bev_index: torch.Tensor,
             num_cells: int) -> torch.Tensor:
    """Sum-pool frustum points (N, C) into BEV cells: (num_cells, C); an
    index ``>= num_cells`` is dropped."""
    return segment_sum(feats, bev_index, num_cells)
