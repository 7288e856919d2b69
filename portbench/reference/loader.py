"""The serving loader in plain NumPy, frozen, for the benchmark's checks.

After the reference repository loicland/superpoint_graph
(learning/s3dis_dataset.py and learning/sema3d_dataset.py for the parsed
rows, learning/spg.py for the superpoint samples and the edge features),
in eval mode: `batch` builds, from a partition's voxels (xyz, mean
colour, geometric features), components and superpoint graph, what the
model reads: every superpoint's rows sampled to `ptn_npts` with
RandomState(superpoint id), centred and scaled by its diameter, its
channels selected by `pc_attribs`, and the superedges with their
features. Each step is NumPy on float32 in the order the reference takes
it, so that a sound loader gives the same arrays bit for bit.
"""
from __future__ import annotations

import random

import numpy as np

# parsed rows: x y z, r g b, elevation, l p s v, and (S3DIS) the room's
# normalised X Y Z and the distance to its centre
COL_XYZ, COL_RGB, COL_E = slice(0, 3), slice(3, 6), 6
COL_LPSV, COL_XYZN, COL_D = slice(7, 11), slice(11, 14), 14
MAX_PARSED = 10000


def point_rows(xyz, rgb, geof, style: str) -> np.ndarray:
    """The parsed rows of every voxel; `style` "s3dis" or "sema3d"."""
    xyz = np.asarray(xyz, np.float32)
    rgbn = np.asarray(rgb, np.float32) / 255.0 - 0.5
    e = (xyz[:, 2] / 4.0 - 0.5)[:, None].astype(np.float32)
    lpsv = np.asarray(geof).astype(np.float32) - 0.5
    if style == "sema3d":
        return np.concatenate([xyz, rgbn, e, lpsv], axis=1).astype(np.float32)
    mi, ma = xyz.min(0, keepdims=True), xyz.max(0, keepdims=True)
    centre = xyz[:, :2].mean(0)
    d = np.sqrt(((xyz[:, :2] - centre) ** 2).sum(1))
    return np.concatenate(
        [xyz, rgbn, e, lpsv, (xyz - mi) / (ma - mi + 1e-8),
         ((d - d.mean()) / (d.std() + 1e-10))[:, None]], axis=1
    ).astype(np.float32)


def _channels(P: np.ndarray, pc_attribs: str) -> np.ndarray:
    cols = []
    if "xyz" in pc_attribs:
        cols.append(P[:, COL_XYZ])
    if "rgb" in pc_attribs:
        cols.append(P[:, COL_RGB])
    if "e" in pc_attribs.replace("rgb", "").replace("lpsv", ""):
        cols.append(P[:, COL_E, None])
    if "lpsv" in pc_attribs:
        cols.append(P[:, COL_LPSV])
    if "XYZ" in pc_attribs:
        cols.append(P[:, COL_XYZN])
    if "d" in pc_attribs:
        cols.append(P[:, COL_D, None])
    return np.concatenate(cols, axis=1)


def superpoint_cloud(rows: np.ndarray, sp_id: int, cfg: dict):
    """(points [ptn_npts, C], diameter) of one superpoint, or None below
    ptn_minpts rows."""
    n = rows.shape[0]
    if n < cfg["ptn_minpts"]:
        return None
    P = np.asarray(rows, np.float32)
    rs = np.random.RandomState(seed=sp_id)
    npts = cfg["ptn_npts"]
    if n > npts:
        P = P[rs.choice(n, npts), :]
    elif n < npts:
        P = np.concatenate([P, P[rs.choice(n, npts - n), :]], 0)
    diameter = float(np.max(np.max(P[:, :3], 0) - np.min(P[:, :3], 0)))
    P[:, :3] = ((P[:, :3] - P[:, :3].mean(0, keepdims=True))
                / (diameter + 1e-10))
    return _channels(P, cfg["pc_attribs"]), np.float32(diameter)


def edge_features(graph: dict, edge_attribs: str):
    """(src, tgt, features [E, F]) of the superedges: delta_avg and
    delta_std as they are, node attributes by /d difference and /ld
    log-ratio (surface and volume squared back)."""
    src = np.asarray(graph["source"]).astype(np.int64).ravel()
    tgt = np.asarray(graph["target"]).astype(np.int64).ravel()
    f32 = lambda k: np.asarray(graph[k], np.float32)  # noqa: E731
    node = {"xyz": f32("sp_centroids"),
            "nlength": np.maximum(0, f32("sp_length")),
            "volume": np.maximum(0, f32("sp_volume") ** 2),
            "surface": np.maximum(0, f32("sp_surface") ** 2),
            "size": np.asarray(graph["sp_point_count"]).astype(
                np.float32).reshape(-1, 1)}
    edge = {"delta_avg": f32("se_delta_mean"), "delta_std": f32("se_delta_std")}
    cols = []
    for attrib in edge_attribs.split(","):
        name, _, opt = attrib.partition("/")
        if name in edge:
            cols.append(edge[name])
        elif opt.lower() == "d":
            cols.append(node[name][src, :] - node[name][tgt, :])
        elif opt.lower() == "ld":
            a = np.log(node[name] + 1e-10)
            cols.append(a[src, :] - a[tgt, :])
        else:
            raise ValueError(f"edge attribute {attrib!r}")
    return src, tgt, np.concatenate(cols, axis=1).astype(np.float32)


def batch(xyz, rgb, geof, components, graph: dict, style: str, cfg: dict,
          edge_attribs: str) -> dict:
    """What the model reads of one partitioned cloud: clouds [n, npts, C],
    diameters [n], embeddable [n], src, tgt, edge_feats. `cfg` holds the
    loader's ptn_npts, ptn_minpts and pc_attribs."""
    P = point_rows(xyz, rgb, geof, style)
    rnd = random.Random(0)
    n = len(components)
    n_ch = _channels(P[:1], cfg["pc_attribs"]).shape[1]
    clouds = np.zeros((n, cfg["ptn_npts"], n_ch), np.float32)
    diameters = np.zeros(n, np.float32)
    embeddable = np.zeros(n, bool)
    for c, idx in enumerate(components):
        idx = np.asarray(idx).ravel()
        if idx.size > MAX_PARSED:
            idx = idx[rnd.sample(range(idx.size), k=MAX_PARSED)]
        got = superpoint_cloud(P[idx, :], c, cfg)
        if got is not None:
            clouds[c], diameters[c] = got
            embeddable[c] = True
    src, tgt, feats = edge_features(graph, edge_attribs)
    return {"clouds": clouds, "diameters": diameters,
            "embeddable": embeddable, "src": src, "tgt": tgt,
            "edge_feats": feats}
