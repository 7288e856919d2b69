"""Superpoint-graph construction: superpoint stats + superedge features.

Carried over unchanged in behaviour from superpoint_graph_tpu/graph/spg.py
(`compute_sp_graph` and helpers; reference partition/graphs.py:75-210),
whose module imports jax: host numpy plus scipy's Delaunay. The 'knn'
adjacency without given edges searches with the port's kNN on `device`.
A triangulation can also be made by another thread than the SPG's
(`DelaunayJob`): `compute_sp_graph` then does what needs no edges first
and waits for the tetrahedra where it needs them. Qhull releases the
interpreter lock for the whole triangulation, so the two threads run
side by side.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Future

import numpy as np
import torch
from scipy.spatial import Delaunay

from ..device import card_unless
from ..ops.knn import knn
from ..utils import tracing
from ..utils.tracing import stage


def _cross_edges(src, tgt, in_component) -> np.ndarray:
    """Directed edges whose endpoints lie in different components, both
    directions, unique columns [2, E]."""
    m = in_component[src] != in_component[tgt]
    edges = np.concatenate(
        [np.stack([src[m], tgt[m]]), np.stack([tgt[m], src[m]])], axis=1
    )
    return np.unique(edges, axis=1)


def _triangulate(xyz, times=None) -> np.ndarray:
    """Delaunay(xyz)'s tetrahedra [T, 4], the stage `spgt.spg.delaunay`
    (seconds under times["delaunay"]), counted as `delaunay.simplices`.
    `Delaunay` is looked up in this module at call time."""
    with stage("spgt.spg.delaunay", times, "delaunay"):
        tets = Delaunay(xyz).simplices
    tracing.count("delaunay.simplices", len(tets))
    return tets


@dataclasses.dataclass
class DelaunayJob:
    """A triangulation handed from the thread that makes it to the one
    that uses it: `run(xyz)` triangulates `xyz` (a float32 copy) in the
    calling thread and hands (tetrahedra, seconds), or the error, to
    `result()`, which waits for it."""
    xyz: np.ndarray | None = None
    future: Future = dataclasses.field(default_factory=Future)

    def run(self, xyz):
        self.xyz = np.array(xyz, np.float32)
        own = {}
        try:
            tets = _triangulate(self.xyz, own)
        except Exception as e:
            self.future.set_exception(e)
        else:
            self.future.set_result((tets, own["delaunay"]))

    def result(self):
        return self.future.result()

    def triangulates(self, xyz) -> bool:
        """Whether, once run, this is the triangulation of `xyz`: the same
        float32 values in the same order."""
        return (self.xyz is not None and self.xyz.shape == xyz.shape
                and np.array_equal(self.xyz, xyz))


def _tet_cross_edges(tets, n, in_component) -> np.ndarray:
    """The tetrahedra's edges crossing components (graphs.py:82-109),
    both directions, unique columns [2, E] in (source, target) order, as
    `_cross_edges` gives them; `n` vertices."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    src = np.concatenate([tets[:, a] for a, _ in pairs])
    tgt = np.concatenate([tets[:, b] for _, b in pairs])
    m = in_component[src] != in_component[tgt]
    # _cross_edges' columns, deduplicated as one int64 key (src, tgt) a
    # column: a tetrahedron edge recurs in ~6 tetrahedra, and np.unique's
    # axis=1 sort of millions of columns took seconds a street frame
    n = np.int64(n)
    a, b = src[m].astype(np.int64), tgt[m].astype(np.int64)
    key = np.unique(np.concatenate([a * n + b, b * n + a]))
    return np.stack([key // n, key % n]).astype(tets.dtype)


def _delaunay_cross_edges(xyz, in_component, times=None) -> np.ndarray:
    """All Delaunay tetrahedron edges crossing components, as
    `_tet_cross_edges` gives them; the triangulation's seconds go under
    times["delaunay"] when given."""
    return _tet_cross_edges(_triangulate(xyz, times), len(xyz), in_component)


def _knn_cross_edges(xyz, in_component, device, k: int = 10):
    """kNN edges crossing components (both directions, unique)."""
    idx, _ = knn(torch.tensor(xyz, device=device), k)
    tgt = tracing.to_host(idx, "spg.knn").numpy().reshape(-1)
    src = np.repeat(np.arange(len(xyz)), k)
    return _cross_edges(src, tgt, in_component)


def _component_stats(xyz, in_component, n_com):
    """Per-component centroid/length/surface/volume from the component's
    deduplicated points, np.cov's ddof=1 (graphs.py:158-173)."""
    n = len(xyz)
    keys = np.concatenate(
        [in_component[:, None].astype(np.float64), xyz.astype(np.float64)], 1
    )
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    head = np.ones(n, bool)
    head[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    uniq_idx = order[head]
    ux = xyz[uniq_idx].astype(np.float64)
    uc = in_component[uniq_idx]

    cnt = np.bincount(uc, minlength=n_com).astype(np.float64)
    cent = np.zeros((n_com, 3))
    np.add.at(cent, uc, ux)
    cent /= np.maximum(cnt, 1)[:, None]

    d = ux - cent[uc]
    cov = np.zeros((n_com, 3, 3))
    np.add.at(cov, uc, d[:, :, None] * d[:, None, :])
    cov /= np.maximum(cnt - 1, 1)[:, None, None]
    lams = np.maximum(np.linalg.eigvalsh(cov)[:, ::-1], 0.0)

    length = lams[:, 0]
    surface = np.sqrt(lams[:, 0] * lams[:, 1] + 1e-10)
    volume = np.sqrt(lams[:, 0] * lams[:, 1] * lams[:, 2] + 1e-10)
    # 1 point -> all zero; 2 points -> length = sqrt(sum var), ddof=0
    one = cnt <= 1
    two = cnt == 2
    if two.any():
        var = np.zeros((n_com, 3))
        np.add.at(var, uc, d * d)
        var /= np.maximum(cnt, 1)[:, None]
        length = np.where(two, np.sqrt(var.sum(1)), length)
    length = np.where(one, 0.0, length)
    surface = np.where(one | two, 0.0, surface)
    volume = np.where(one | two, 0.0, volume)
    return cent.astype(np.float32), length, surface, volume


def _support_edges(xyz, d_max, in_component, n_com, adjacency, knn_edges,
                   device, times, delaunay):
    """The superedges' support: cross edges shorter than `d_max` (all
    with 0), sorted by (source component, target component); returns
    (edges [2, E], their components [2, E], the first edge of each
    superedge [E] bool, superedge ids [E], superedges)."""
    with tracing.span("spgt.spg.cross_edges"):
        if knn_edges is not None:
            edges = _cross_edges(np.asarray(knn_edges[0], np.int64),
                                 np.asarray(knn_edges[1], np.int64),
                                 in_component)
        elif adjacency == "delaunay" and delaunay is not None:
            with stage("spgt.spg.delaunay_wait", times, "delaunay_wait"):
                tets, seconds = delaunay.result()
            if delaunay.triangulates(xyz):
                if times is not None:
                    times["delaunay"] = times.get("delaunay", 0.0) + seconds
                edges = _tet_cross_edges(tets, len(xyz), in_component)
            else:  # another array's: triangulate this one here
                edges = _delaunay_cross_edges(xyz, in_component, times)
        elif adjacency == "delaunay":
            edges = _delaunay_cross_edges(xyz, in_component, times)
        elif adjacency == "knn":
            edges = _knn_cross_edges(xyz, in_component, device)
        else:
            raise ValueError(f"unknown adjacency {adjacency!r}")

        if d_max > 0 and edges.shape[1] > 0:
            dist = np.sqrt(((xyz[edges[0]] - xyz[edges[1]]) ** 2).sum(1))
            edges = edges[:, dist < d_max]

        # group support edges into superedges by (source comp, target comp)
        ecomp = in_component[edges].astype(np.int64)
        key = np.int64(n_com) * ecomp[0] + ecomp[1]
        order = np.argsort(key, kind="stable")
        edges = edges[:, order]
        ecomp = ecomp[:, order]
        key = key[order]
        n_edg = edges.shape[1]
        head = np.ones(n_edg, bool)
        if n_edg > 0:
            head[1:] = key[1:] != key[:-1]
            sedge_id = np.cumsum(head) - 1
            n_sedg = int(sedge_id[-1]) + 1
        else:
            sedge_id = np.zeros(0, np.int64)
            n_sedg = 0
    return edges, ecomp, head, sedge_id, n_sedg


def _component_graph(xyz, in_component, n_com, labels, n_labels):
    """(the graph's `is_nn` and `sp_*` entries, centroids, lengths,
    surfaces, volumes, point counts) of the components."""
    has_labels = labels is not None and np.size(labels) > 1
    label_hist = has_labels and np.ndim(labels) > 1 and np.shape(labels)[1] > 1
    with tracing.span("spgt.spg.components"):
        graph = {"is_nn": False}
        cent, length, surface, volume = _component_stats(xyz, in_component,
                                                         n_com)
        graph["sp_centroids"] = cent
        graph["sp_length"] = length.astype(np.float32)[:, None]
        graph["sp_surface"] = surface.astype(np.float32)[:, None]
        graph["sp_volume"] = volume.astype(np.float32)[:, None]
        counts = np.bincount(in_component, minlength=n_com)
        graph["sp_point_count"] = counts.astype(np.uint64)[:, None]

        if has_labels:
            labels = np.asarray(labels)
            hist = np.zeros((n_com, n_labels + 1), np.int64)
            if label_hist:
                np.add.at(hist, in_component, labels.astype(np.int64))
            else:
                np.add.at(hist, (in_component,
                                 labels.astype(np.int64).ravel()), 1)
            graph["sp_labels"] = hist.astype(np.uint32)
        else:
            graph["sp_labels"] = []
    return graph, cent, length, surface, volume, counts


def compute_sp_graph(xyz, d_max, in_component, labels, n_labels,
                     adjacency="delaunay", knn_edges=None, device=None,
                     times=None, delaunay: DelaunayJob | None = None):
    """The superpoint graph dict, with the reference's keys, shapes and
    dtypes (graphs.py:75-210). `knn_edges=(source, target)` reuses existing
    adjacency edges as superedge support; adjacency="knn" searches on
    `device` (default: the card). With `times`, the Delaunay's seconds go
    under times["delaunay"]. `delaunay`, a DelaunayJob that another
    thread runs on these voxels, stands in for the triangulation: the
    component statistics, which run first, run beside it, then the stage
    `spgt.spg.delaunay_wait` (times "delaunay_wait") waits for it; where
    it triangulated another array, the Delaunay is computed here. (The
    JAX version's `components` argument, which it never reads, is
    dropped.)"""
    device = card_unless(device)
    xyz = np.asarray(xyz, np.float32)
    in_component = np.asarray(in_component).astype(np.int64)
    n_com = int(in_component.max()) + 1

    # what needs no edges first: it runs while a started triangulation does
    graph, cent, length, surface, volume, counts = _component_graph(
        xyz, in_component, n_com, labels, n_labels)
    edges, ecomp, head, sedge_id, n_sedg = _support_edges(
        xyz, d_max, in_component, n_com, adjacency, knn_edges, device, times,
        delaunay)
    n_edg = edges.shape[1]

    with tracing.span("spgt.spg.superedges"):
        # superedge features via segment reductions over the support edges
        com_src = np.zeros(n_sedg, np.int64)
        com_tgt = np.zeros(n_sedg, np.int64)
        if n_edg > 0:
            firsts = np.flatnonzero(head)
            com_src = ecomp[0, firsts]
            com_tgt = ecomp[1, firsts]
        delta = xyz[edges[0]] - xyz[edges[1]]
        cnt_e = np.bincount(sedge_id, minlength=n_sedg).astype(np.float64)
        dmean = np.zeros((n_sedg, 3))
        np.add.at(dmean, sedge_id, delta.astype(np.float64))
        dmean /= np.maximum(cnt_e, 1)[:, None]
        dvar = np.zeros((n_sedg, 3))
        np.add.at(dvar, sedge_id, (delta - dmean[sedge_id]) ** 2)
        # np.std is ddof=0 (graphs.py:204)
        dvar /= np.maximum(cnt_e, 1)[:, None]
        dnorm = np.zeros(n_sedg)
        np.add.at(dnorm, sedge_id,
                  np.sqrt((delta.astype(np.float64) ** 2).sum(1)))
        dnorm /= np.maximum(cnt_e, 1)
        dstd = np.where((cnt_e <= 1)[:, None], 0.0, np.sqrt(dvar))

    eps = 1e-6
    graph["source"] = com_src.astype(np.uint32)[:, None]
    graph["target"] = com_tgt.astype(np.uint32)[:, None]
    graph["se_delta_mean"] = dmean.astype(np.float32)
    graph["se_delta_std"] = dstd.astype(np.float32)
    graph["se_delta_norm"] = dnorm.astype(np.float32)[:, None]
    graph["se_delta_centroid"] = (cent[com_src] - cent[com_tgt]).astype(np.float32)
    graph["se_length_ratio"] = (
        length[com_src] / (length[com_tgt] + eps)).astype(np.float32)[:, None]
    graph["se_surface_ratio"] = (
        surface[com_src] / (surface[com_tgt] + eps)).astype(np.float32)[:, None]
    graph["se_volume_ratio"] = (
        volume[com_src] / (volume[com_tgt] + eps)).astype(np.float32)[:, None]
    graph["se_point_count_ratio"] = (
        counts[com_src] / (counts[com_tgt] + eps)).astype(np.float32)[:, None]
    return graph
