"""Graph coarsening pooling (mean, max) over a pooling map (plain torch).

Port of superpoint_graph_tpu/models/pool.py (`graph_pool`, `graph_unpool`;
reference learning/ecc/GraphPoolModule.py + GraphPoolInfo.py, the ECC
library's pooling, which the SPG pipeline does not call, SURVEY.md §2.2).
The map is a flat edge list, child (fine node) -> parent (coarse node),
with a validity mask for padding. Pooling is one masked segment reduction
(ops/segment.py) and autograd gives its backward: the mean scatters evenly,
the max routes to the maximum, as the reference's maxpool_bw/avgpool_bw.
"""
from __future__ import annotations

import torch

from ..ops.segment import segment_max, segment_mean


def graph_pool(h: torch.Tensor, child: torch.Tensor, parent: torch.Tensor,
               n_coarse: int, mask: torch.Tensor | None = None,
               aggr: str = "mean") -> torch.Tensor:
    """h [N, C] fine-node features pooled onto [n_coarse, C] by the map
    entries (child[m] -> parent[m]) whose mask is set (all when None);
    aggr 'mean' or 'max'. Coarse nodes without a child are 0."""
    hc = h[child]
    if aggr == "mean":
        return segment_mean(hc, parent, n_coarse, mask)
    if aggr == "max":
        return segment_max(hc, parent, n_coarse, mask)
    raise ValueError(f"unknown aggr {aggr!r}")


def graph_unpool(h_coarse: torch.Tensor,
                 parent_of: torch.Tensor) -> torch.Tensor:
    """Coarse features broadcast back to the fine nodes (parent_of [N]:
    each fine node's coarse node)."""
    return h_coarse[parent_of]
