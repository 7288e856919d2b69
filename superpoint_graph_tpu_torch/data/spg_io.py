"""Superpoint-graph entries for the model: node targets, edges, edge features.

Port of superpoint_graph_tpu/data/spg_io.py (`spg_edge_features`, the
node-attribute transforms of `spg_reader`, `EdgeFeatScaler`; reference
learning/spg.py:23-103), whose module imports h5py at top level.
`spg_entry` builds the entry from an in-memory superpoint-graph dict;
`spg_reader` reads the same from an SPG h5 file, importing h5py only when
called.
"""
from __future__ import annotations

import os

import numpy as np


def spg_edge_features(edges, node_att, edge_att, edge_attribs: str):
    """Edge-feature columns from the --edge_attribs token DSL: /d difference,
    /ld log-ratio, /r ratio (spg.py:23-49)."""
    columns = []
    for attrib in edge_attribs.split(","):
        parts = attrib.split("/")
        a = parts[0]
        opt = parts[1].lower() if len(parts) == 2 else ""
        if a in ("delta_avg", "delta_std"):
            columns.append(edge_att[a])
        elif a == "constant":
            columns.append(np.ones((edges.shape[0], 1), dtype=np.float32))
        elif a in ("nlength", "surface", "volume", "size", "xyz"):
            attr = node_att[a]
            if opt == "d":
                attr = attr[edges[:, 0], :] - attr[edges[:, 1], :]
            elif opt == "ld":
                attr = np.log(attr + 1e-10)
                attr = attr[edges[:, 0], :] - attr[edges[:, 1], :]
            elif opt == "r":
                attr = attr[edges[:, 0], :] / (attr[edges[:, 1], :] + 1e-10)
            else:
                raise NotImplementedError(f"missing modifier on {attrib}")
            columns.append(attr)
        else:
            raise NotImplementedError(f"unknown edge attribute {a}")
    return np.concatenate(columns, axis=1).astype(np.float32)


def spg_entry(graph: dict, edge_attribs: str, name: str = ""):
    """(node_gt [n,1], node_gt_size [n,C+1], edges [E,2], edge_feats [E,F],
    name) from a superpoint-graph dict (the keys of graph/spg.py, or of an
    SPG h5 file): node GT is the argmax of the labelled histogram columns,
    -100 where a superpoint has no labelled point; surface and volume are
    squared back (spg.py:66-103). The --spg_superedge_cutoff filter waits
    for the training port."""
    sp_labels = np.asarray(graph["sp_labels"])
    count = np.asarray(graph["sp_point_count"])
    if sp_labels.size > 0:
        node_gt_size = sp_labels.astype(np.int64)
        node_gt = np.argmax(node_gt_size[:, 1:], 1)[:, None]
        node_gt[node_gt_size[:, 1:].sum(1) == 0, :] = -100
    else:
        n = count.shape[0]
        node_gt_size = np.concatenate(
            [count.astype(np.int64).reshape(n, 1), np.zeros((n, 8), np.int64)],
            1)
        node_gt = np.zeros((n, 1), dtype=np.int64)
    f32 = lambda k: np.asarray(graph[k], np.float32)  # noqa: E731
    node_att = {
        "xyz": f32("sp_centroids"),
        "nlength": np.maximum(0, f32("sp_length")),
        "volume": np.maximum(0, f32("sp_volume") ** 2),
        "surface": np.maximum(0, f32("sp_surface") ** 2),
        "size": count.astype(np.float32).reshape(-1, 1),
    }
    edges = np.concatenate(
        [np.asarray(graph["source"]), np.asarray(graph["target"])], axis=1
    ).astype(np.int64)
    edge_att = {"delta_avg": f32("se_delta_mean"),
                "delta_std": f32("se_delta_std")}
    edge_feats = spg_edge_features(edges, node_att, edge_att, edge_attribs)
    return node_gt, node_gt_size, edges, edge_feats, name


def spg_reader(fname: str, edge_attribs: str):
    """`spg_entry` of an SPG h5 file (superpoint_graphs/<split>/<name>.h5)."""
    import h5py

    keys = ("sp_labels", "sp_point_count", "sp_centroids", "sp_length",
            "sp_volume", "sp_surface", "source", "target", "se_delta_mean",
            "se_delta_std")
    with h5py.File(fname, "r") as f:
        graph = {k: f[k][:] for k in keys}
    name = os.path.basename(fname)[: -len(".h5")]
    return spg_entry(graph, edge_attribs, name)


class EdgeFeatScaler:
    """StandardScaler over edge features (spg.py:51-64)."""

    def __init__(self, mean=None, scale=None):
        self.mean = mean
        self.scale = scale

    def fit(self, graph_list):
        feats = np.concatenate([g[3] for g in graph_list], 0)
        self.mean = feats.mean(0)
        std = feats.std(0)
        self.scale = np.where(std == 0, 1.0, std)
        return self

    def transform(self, edge_feats):
        return ((edge_feats - self.mean) / self.scale).astype(np.float32)
