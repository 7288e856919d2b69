"""Superpoint graph of the giant-cloud path, its reductions on the device.

Port of superpoint_graph_tpu/graph/spg_device.py (`compute_sp_graph_device`,
`_cross_mask`, `_sort_support_edges`,
`_superedge_stats`, `_component_stats_device`, `_label_hist_device`): the
contract of `graph/spg.py::compute_sp_graph` with the kNN adjacency as
superedge support (reference graphs.py:75-210), every O(edges) and
O(points) step on the device, only the [n_superedges] and [n_components]
results fetched. The support edges are the kNN edges in both directions
that join two components, deduplicated and grouped by (source component,
target component); the component statistics are taken over each
component's distinct points with np.cov's ddof=1.

The JAX version pads n to a 2^20 bucket and pads the edge and component
buffers to powers of two, for its TPU executables; here the arrays keep
their sizes, and a boolean index compacts where JAX fills a static buffer
(so `_count_cross_edges`, which sizes that buffer, has no counterpart).
Sorts are lexicographic by successive stable sorts; every float sum runs in
a fixed order (`cutpursuit_band._Segments` over sorted rows), in f32 as in
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import card_unless
from ..ops.cutpursuit_band import _Segments
from ..ops.eigen3 import eigvals3x3_cols
from ..utils import tracing


def _lexsort(*keys):
    """Permutation sorting by keys[0], then keys[1], ... (stable)."""
    order = torch.arange(len(keys[0]), device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _cross_mask(idx_adj, in_comp, xyz, d_max: float):
    """Both directions (u, v) of every kNN edge and whether it joins two
    components (and is shorter than d_max when d_max > 0)."""
    n, k = idx_adj.shape
    src = torch.arange(n, device=idx_adj.device).repeat_interleave(k)
    tgt = idx_adj.reshape(-1)
    u, v = torch.cat([src, tgt]), torch.cat([tgt, src])
    ok = in_comp[u] != in_comp[v]
    if d_max > 0:
        d2 = sum((xyz[u, a] - xyz[v, a]) ** 2 for a in range(3))
        ok &= d2 < float(d_max) ** 2
    return u, v, ok


def _sort_support_edges(idx_adj, in_comp, xyz, d_max: float):
    """The cross-component support edges, deduplicated and sorted by
    (source component, target component, u, v). Returns (u, v, cu, cv,
    head): head marks the first edge of each component pair."""
    u, v, ok = _cross_mask(idx_adj, in_comp, xyz, d_max)
    u, v = u[ok], v[ok]
    cu, cv = in_comp[u], in_comp[v]
    n = len(in_comp)
    order = _lexsort(cu, cv, u * n + v)
    u, v, cu, cv = u[order], v[order], cu[order], cv[order]
    # a duplicate (u, v) shares its component pair, so it is adjacent
    first = torch.ones_like(u, dtype=torch.bool)
    first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    u, v, cu, cv = u[first], v[first], cu[first], cv[first]
    head = torch.ones_like(u, dtype=torch.bool)
    head[1:] = (cu[1:] != cu[:-1]) | (cv[1:] != cv[:-1])
    return u, v, cu, cv, head


def _superedge_stats(xyz, u, v, cu, cv, head):
    """Per superedge: source and target component, per-coordinate mean and
    std (ddof 0, E[x^2] - E[x]^2) of the support edges' deltas, their mean
    norm, and the edge count."""
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    n_sedg = int(tracing.to_host(head.sum(), "spg.superedges"))
    by_sedg = _Segments(seg, n_sedg, presorted=True)
    cnt = by_sedg.lengths
    denom = torch.clamp(cnt, min=1).to(torch.float32)
    means, stds, norm2 = [], [], 0.0
    for a in range(3):
        da = xyz[u, a] - xyz[v, a]
        s1 = by_sedg.sum(da)
        s2 = by_sedg.sum(da * da)
        mean = s1 / denom
        var = torch.clamp(s2 / denom - mean * mean, min=0.0)
        means.append(mean)
        stds.append(torch.where(cnt > 1, torch.sqrt(var), 0.0))
        norm2 = norm2 + da * da
    dnorm = by_sedg.sum(torch.sqrt(norm2)) / denom
    return (cu[head], cv[head], torch.stack(means, 1), torch.stack(stds, 1),
            dnorm, cnt)


def _component_stats_device(xyz, in_comp, n_com: int):
    """Per component, over its distinct points: centroid, and from the
    ddof-1 covariance's eigenvalues l0 >= l1 >= l2 length l0, surface
    sqrt(l0 l1), volume sqrt(l0 l1 l2) (+1e-10 inside the roots); one
    point gives zeros, two points length = sqrt(summed ddof-0 variance)
    (graphs.py:158-173)."""
    order = _lexsort(in_comp, xyz[:, 0], xyz[:, 1], xyz[:, 2])
    c_s, p_s = in_comp[order], xyz[order]
    first = torch.ones_like(c_s, dtype=torch.bool)
    first[1:] = (c_s[1:] != c_s[:-1]) | (p_s[1:] != p_s[:-1]).any(1)
    c_s, p_s = c_s[first], p_s[first]
    by_comp = _Segments(c_s, n_com, presorted=True)
    cnt = by_comp.lengths
    denom = torch.clamp(cnt, min=1).to(torch.float32)
    cents = [by_comp.sum(p_s[:, a]) / denom for a in range(3)]
    d = [p_s[:, a] - cents[a][c_s] for a in range(3)]
    ddof = torch.clamp(cnt - 1, min=1).to(torch.float32)

    def cov(a, b):
        return by_comp.sum(d[a] * d[b]) / ddof

    lams = [torch.clamp(x, min=0.0) for x in eigvals3x3_cols(
        cov(0, 0), cov(1, 1), cov(2, 2), cov(0, 1), cov(0, 2), cov(1, 2))]
    length = lams[0]
    surface = torch.sqrt(lams[0] * lams[1] + 1e-10)
    volume = torch.sqrt(lams[0] * lams[1] * lams[2] + 1e-10)
    one, two = cnt <= 1, cnt == 2
    var_tr = sum(by_comp.sum(x * x) for x in d) / denom
    length = torch.where(two, torch.sqrt(var_tr), length)
    length = torch.where(one, 0.0, length)
    surface = torch.where(one | two, 0.0, surface)
    volume = torch.where(one | two, 0.0, volume)
    return torch.stack(cents, 1), length, surface, volume


def _label_hist_device(in_comp, labels, n_com: int, n_cols: int,
                       is_hist: bool):
    """Per-component label histogram: summed rows of a per-point histogram,
    or counts of per-point labels (integer adds: any order)."""
    if is_hist:
        return torch.zeros((n_com, labels.shape[1]), dtype=torch.int64,
                           device=in_comp.device).index_add_(
            0, in_comp, labels.to(torch.int64))
    hist = torch.zeros((n_com, n_cols), dtype=torch.int64,
                       device=in_comp.device)
    return hist.index_put_((in_comp, labels.reshape(-1).to(torch.int64)),
                           torch.ones_like(in_comp), accumulate=True)


def compute_sp_graph_device(xyz, d_max: float, in_component, labels,
                            n_labels: int, idx_adj, device=None) -> dict:
    """`graph/spg.py::compute_sp_graph` with the kNN adjacency, reduced on
    the device: `xyz` [n, 3] and `idx_adj` [n, k] (the kNN table) may lie
    on the device already; otherwise they go to `device` (default: the
    card, or xyz's device when xyz is a tensor). (The JAX version's
    `components` argument, which it never reads, and its `knn_edges`
    stand-in for the table, which no caller passes, are dropped.) Returns the graph dict with the reference's keys, shapes and
    dtypes."""
    if isinstance(xyz, torch.Tensor):
        device = xyz.device
    device = card_unless(device)
    xyz_d = torch.as_tensor(np.asarray(xyz, np.float32)
                            if not isinstance(xyz, torch.Tensor) else xyz,
                            device=device)
    in_comp_h = np.asarray(in_component).astype(np.int64)
    n_com = int(in_comp_h.max()) + 1
    idx = torch.as_tensor(idx_adj, device=device).to(torch.int64)
    in_comp = torch.as_tensor(in_comp_h, device=device)

    with tracing.span("spgt.spg.cross_edges"):
        u, v, cu, cv, head = _sort_support_edges(idx, in_comp, xyz_d, d_max)
    with tracing.span("spgt.spg.superedges"):
        com_src, com_tgt, dmean, dstd, dnorm, _ = _superedge_stats(
            xyz_d, u, v, cu, cv, head)
    with tracing.span("spgt.spg.components"):
        cent, length, surface, volume = _component_stats_device(
            xyz_d, in_comp, n_com)
        has_labels = labels is not None and np.size(labels) > 1
        hist = None
        if has_labels:
            lab = np.asarray(labels)
            is_hist = lab.ndim > 1 and lab.shape[1] > 1
            hist = _label_hist_device(
                in_comp, torch.as_tensor(lab.astype(np.int64), device=device),
                n_com, lab.shape[1] if is_hist else n_labels + 1, is_hist)

    with tracing.span("spgt.spg.fetch"):
        cent, length, surface, volume, cs, ct, dmean, dstd, dnorm = (
            tracing.to_host(t, "spg.fetch").numpy()
            for t in (cent, length, surface, volume, com_src, com_tgt, dmean,
                      dstd, dnorm))
        if has_labels:
            hist = tracing.to_host(hist, "spg.fetch").numpy()
    length = length.astype(np.float64)
    surface = surface.astype(np.float64)
    volume = volume.astype(np.float64)
    counts = np.bincount(in_comp_h, minlength=n_com)
    eps = 1e-6
    return {
        "is_nn": False,
        "sp_centroids": cent.astype(np.float32),
        "sp_length": length.astype(np.float32)[:, None],
        "sp_surface": surface.astype(np.float32)[:, None],
        "sp_volume": volume.astype(np.float32)[:, None],
        "sp_point_count": counts.astype(np.uint64)[:, None],
        "sp_labels": (hist.astype(np.uint32) if has_labels else []),
        "source": cs.astype(np.uint32)[:, None],
        "target": ct.astype(np.uint32)[:, None],
        "se_delta_mean": dmean.astype(np.float32),
        "se_delta_std": dstd.astype(np.float32),
        "se_delta_norm": dnorm.astype(np.float32)[:, None],
        "se_delta_centroid": (cent[cs] - cent[ct]).astype(np.float32),
        "se_length_ratio": (length[cs] / (length[ct] + eps)).astype(
            np.float32)[:, None],
        "se_surface_ratio": (surface[cs] / (surface[ct] + eps)).astype(
            np.float32)[:, None],
        "se_volume_ratio": (volume[cs] / (volume[ct] + eps)).astype(
            np.float32)[:, None],
        "se_point_count_ratio": (counts[cs] / (counts[ct] + eps)).astype(
            np.float32)[:, None],
    }
