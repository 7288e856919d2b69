"""k-nearest-neighbour graphs of one cloud, room scale.

Port of superpoint_graph_tpu/ops/knn.py (`knn`, `_knn_with_adj`,
`compute_graph_nn_2`, `materialize_graph_nn`) for clouds up to
BIGCLOUD_THRESHOLD points. Blocked exact search in plain torch: per query
block one |q|^2 + |p|^2 - 2 q.p distance tile (full f32, coordinates centred
to shrink the cancellation), `topk` of a few spare candidates, then the
self match removed by index (not by column 0), exact (q - p)^2 re-rank and
re-sort. The JAX version selects with the TPU's approximate `approx_min_k`;
this one is exact, so the two agree on ~99% of indices, not all.

Above the threshold the JAX package switches to its sorted-cell search
(`knn_bigcloud`); that path is not ported yet (ROADMAP queue 1, giant-cloud
path) and raises here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import card_unless

BIGCLOUD_THRESHOLD = 300_000  # points (superpoint_graph_tpu/ops/knn.py:963)
_SPARE = 8  # extra candidates re-ranked exactly: covers f32 near-ties


def knn(xyz: torch.Tensor, k: int, *, block_q: int = 2048
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of every point among the other points of the same cloud (the
    point itself excluded, reference graphs.py:30-40).

    Returns (indices [n, k] int64, squared distances [n, k] f32), ascending;
    equal distances keep the lower index first."""
    n = xyz.shape[0]
    if n > BIGCLOUD_THRESHOLD:
        raise NotImplementedError(
            f"{n} points > BIGCLOUD_THRESHOLD={BIGCLOUD_THRESHOLD}: the "
            "giant-cloud kNN is not ported yet (ROADMAP queue 1, giant-cloud "
            "path)"
        )
    n_cand = min(k + 1 + _SPARE, n)
    if n_cand < k + 1:
        raise ValueError(f"k={k} needs more than {n} points")
    pts = xyz - xyz.mean(0)
    sq = (pts * pts).sum(1)
    out_i = torch.empty((n, k), dtype=torch.int64, device=xyz.device)
    out_d = torch.empty((n, k), dtype=torch.float32, device=xyz.device)
    for s in range(0, n, block_q):
        q = pts[s:s + block_q]
        d2 = sq[s:s + block_q, None] + sq[None, :] - 2.0 * (q @ pts.T)
        _, cand = torch.topk(d2, n_cand, dim=1, largest=False)
        # exact distances on the raw coordinates; index order first so the
        # stable sort breaks distance ties by the lower index
        cand, _ = torch.sort(cand, dim=1)
        exact = ((xyz[s:s + block_q, None, :] - xyz[cand]) ** 2).sum(-1)
        self_idx = torch.arange(s, s + len(q), device=xyz.device)[:, None]
        exact = torch.where(cand == self_idx, float("inf"), exact)
        exact, order = torch.sort(exact, dim=1, stable=True)
        out_i[s:s + block_q] = torch.gather(cand, 1, order[:, :k])
        out_d[s:s + block_q] = exact[:, :k]
    return out_i, out_d


def compute_graph_nn_2(xyz: np.ndarray, k_nn_adj: int, k_nn_geof: int,
                       device=None, return_device: bool = False):
    """Adjacency graph + geof neighbour table from ONE search at k_nn_geof
    (reference graphs.py:26-73). Returns (graph dict of numpy
    {is_nn, source u32, target u32, distances f32}, geof neighbours
    [n, k_nn_geof] int64 tensor on `device`, default the card). With
    `return_device`, also the search's tables on `device`, {"idx": [n,
    k_nn_geof] int64, "d2": [n, k_nn_geof] f32}, for the device cut pursuit
    (the JAX version's `dev`, without pad rows)."""
    device = card_unless(device)
    assert k_nn_adj <= k_nn_geof
    n = len(xyz)
    xyz_t = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                            device=device)
    idx, d2 = knn(xyz_t, k_nn_geof)
    idx_adj = idx[:, :k_nn_adj].cpu().numpy()
    dist = np.sqrt(np.maximum(d2[:, :k_nn_adj].cpu().numpy(), 0.0))
    graph = {
        "is_nn": True,
        "source": np.repeat(np.arange(n, dtype=np.uint32), k_nn_adj),
        "target": idx_adj.reshape(-1).astype(np.uint32),
        "distances": dist.reshape(-1).astype(np.float32),
    }
    if return_device:
        return graph, idx, {"idx": idx, "d2": d2}
    return graph, idx
