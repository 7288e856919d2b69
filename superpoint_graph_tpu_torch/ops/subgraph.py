"""Random BFS subgraph sampling for SSP training, host numpy + scipy.

The port's copy of superpoint_graph_tpu/ops/subgraph.py (reference
`libply_c.random_subgraph`, random_subgraph.cpp:22-98): grow a BFS forest
from random seeds drawn from `rng` until `subgraph_size` vertices are
selected; an edge is selected iff both its ends are. The same draws from
the same RandomState give the same masks.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def random_subgraph(n_ver: int, edg_source: np.ndarray,
                    edg_target: np.ndarray, subgraph_size: int,
                    rng: np.random.RandomState | None = None):
    """Returns (selected_edges bool [E], selected_vertices bool [n])."""
    rng = rng or np.random.RandomState()
    if n_ver <= subgraph_size:
        return np.ones(len(edg_source), bool), np.ones(n_ver, bool)
    adj = sp.csr_matrix(
        (np.ones(2 * len(edg_source), np.int8),
         (np.concatenate([edg_source, edg_target]),
          np.concatenate([edg_target, edg_source]))),
        shape=(n_ver, n_ver))
    selected = np.zeros(n_ver, bool)
    n_sel = 0
    while n_sel < subgraph_size:
        seed = rng.randint(n_ver)
        if selected[seed]:
            continue
        # BFS from the seed, level by level, until the budget is filled
        frontier = np.zeros(n_ver, bool)
        frontier[seed] = True
        while frontier.any() and n_sel < subgraph_size:
            idx = np.flatnonzero(frontier & ~selected)
            idx = idx[:subgraph_size - n_sel]
            selected[idx] = True
            n_sel += len(idx)
            frontier = ((adj @ selected) > 0) & ~selected
    return selected[edg_source] & selected[edg_target], selected
