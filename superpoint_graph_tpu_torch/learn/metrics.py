"""Partition-quality metrics, host numpy.

`compute_OOA` carries superpoint_graph_tpu/learn/metrics.py's (reference
metrics.py:102-108), vectorised; `disconnected_labels` the connectivity
audit of tools/partition_quality.py."""
from __future__ import annotations

import numpy as np


def compute_OOA(components, labels) -> float:
    """Optimal attainable overall accuracy of a partition, in percent: every
    component takes its majority label (argmax of each row of `labels`
    [n, n_classes]; ties to the lower class)."""
    hard = np.asarray(labels).argmax(1)
    n_cls = np.asarray(labels).shape[1]
    in_comp = np.empty(len(hard), np.int64)
    for i, comp in enumerate(components):
        in_comp[comp] = i
    counts = np.bincount(in_comp * n_cls + hard,
                         minlength=len(components) * n_cls)
    return 100.0 * counts.reshape(-1, n_cls).max(1).sum() / len(hard)


def disconnected_labels(in_comp, src, tgt) -> int:
    """How many more connected components the graph of the edges (src, tgt)
    inside a label has than there are labels: 0 when every label is one
    connected component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    in_comp = np.asarray(in_comp)
    n = len(in_comp)
    m = in_comp[src] == in_comp[tgt]
    g = coo_matrix((np.ones(int(m.sum()), np.int8), (src[m], tgt[m])),
                   shape=(n, n))
    return int(connected_components(g, directed=False)[0]
               - (int(in_comp.max()) + 1))
