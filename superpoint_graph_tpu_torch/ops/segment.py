"""Masked segment reductions (plain torch).

Port of superpoint_graph_tpu/ops/segment.py. Empty segments yield 0, and
masked-out rows are exact no-ops (reference conv_aggregate_fw / maxpool_fw
zero-fill degree-0 nodes, cuda_kernels.py:75-86, 160-168).
"""
from __future__ import annotations

import torch

_NEG = -3.4e38


def _row_mask(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - 1))


def segment_sum(data, segment_ids, num_segments, mask=None):
    if mask is not None:
        data = torch.where(_row_mask(mask, data), data, 0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_max_raw(data, segment_ids, num_segments):
    """Max per segment with -inf for empty segments (jax.ops.segment_max)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    idx = _row_mask(segment_ids, data).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def segment_max(data, segment_ids, num_segments, mask=None):
    if mask is not None:
        data = torch.where(_row_mask(mask, data), data, _NEG)
    out = segment_max_raw(data, segment_ids, num_segments)
    return torch.where(out <= _NEG / 2, 0.0, out)


def segment_count(segment_ids, num_segments, mask=None):
    ones = torch.ones(segment_ids.shape[0], dtype=torch.int32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data, segment_ids, num_segments, mask=None):
    if mask is not None:
        ones = mask.to(data.dtype)
    else:
        ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    tot = segment_sum(data, segment_ids, num_segments, mask)
    denom = torch.clamp(segment_sum(ones, segment_ids, num_segments), min=1.0)
    return tot / _row_mask(denom, tot)
