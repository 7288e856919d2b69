"""Edge-conditioned convolution over a padded edge list (plain torch).

Port of superpoint_graph_tpu/models/ecc.py::ecc_conv (reference
GraphConvModule.py:34-41,63-93): message W_e h[src] (matrix filters) or
w_e * h[src] (vector filters), averaged over each node's incoming edges;
nodes with no incoming edge get zeros. A kernel written by hand for the
aggregation is ROADMAP queue 2 item 5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.segment import segment_max_raw, segment_sum


def ecc_conv(h: torch.Tensor, weights: torch.Tensor, src: torch.Tensor,
             tgt: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int,
             attention: bool = False, negative_slope: float = 0.2):
    """h [N, C]; weights [E, C] or [E, C, C_out]; src/tgt [E]; edge_mask [E]
    bool. With `attention`, the filters are leaky-relu'd and soft-maxed per
    channel over each target's incoming edges (modules.py:104-116).
    Returns [N, C_out]."""
    if attention:
        w = F.leaky_relu(weights, negative_slope)
        flat = w.reshape(w.shape[0], -1)
        flat = torch.where(edge_mask[:, None], flat, -1e30)
        mx = segment_max_raw(flat, tgt, n_nodes)
        ex = torch.exp(flat - mx[tgt])
        ex = torch.where(edge_mask[:, None], ex, 0.0)
        den = segment_sum(ex, tgt, n_nodes)
        weights = (ex / torch.clamp(den[tgt], min=1e-20)).reshape(w.shape)

    hs = h[src]
    if weights.ndim == 2:
        msg = hs * weights
    else:
        msg = torch.bmm(hs[:, None, :], weights)[:, 0]
    m = edge_mask.to(msg.dtype)
    tot = segment_sum(msg * m[:, None], tgt, n_nodes)
    cnt = segment_sum(m, tgt, n_nodes)
    return tot / torch.clamp(cnt, min=1.0)[:, None]
