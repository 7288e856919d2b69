"""Per-superpoint point sets ("parsed" rows), in memory.

Port of superpoint_graph_tpu/data/parsed.py (`build_point_matrix` for
S3DIS and Semantic3D, the per-component split of `write_parsed`; reference
s3dis_dataset.py:93-162, sema3d_dataset.py), whose module imports h5py at
top level. `parsed_entries` builds the same per-component arrays straight
from a partition, with no h5 round trip; `write_parsed` keeps the file
form, importing h5py only when called. The vKITTI row style and the RANSAC
elevation (sklearn) wait for their readers.

Row layouts: s3dis, 15 columns: [xyz, rgb/255-0.5, elevation, lpsv-0.5,
xyz normalised to the room box, distance to the room centre]; sema3d, 11
columns: the first 11 of those (the loader selects them with
pc_attribs="xyzrgbelpsv").
"""
from __future__ import annotations

import os
import random

import numpy as np


def build_point_matrix(xyz, rgb, geof, style: str = "s3dis") -> np.ndarray:
    """The parsed per-point row matrix of a cloud (column layout in
    data/loader.py), style "s3dis" or "sema3d"; the elevation is the simple
    z/4 - 0.5 (s3dis_dataset.py:135-136)."""
    if style not in ("s3dis", "sema3d"):
        raise ValueError(f"style={style!r}: 's3dis' or 'sema3d'")
    xyz = np.asarray(xyz, np.float32)
    rgbn = np.asarray(rgb, np.float32) / 255.0 - 0.5
    e = (xyz[:, 2] / 4.0 - 0.5)[:, None]
    lpsv = geof.astype(np.float32) - 0.5
    if style == "sema3d":
        return np.concatenate([xyz, rgbn, e, lpsv], axis=1).astype(np.float32)
    room_center = xyz[:, :2].mean(0)
    d = np.sqrt(((xyz[:, :2] - room_center) ** 2).sum(1))
    d = (d - d.mean()) / (d.std() + 1e-10)
    mi, ma = xyz.min(0, keepdims=True), xyz.max(0, keepdims=True)
    xyzn = (xyz - mi) / (ma - mi + 1e-8)
    return np.concatenate([xyz, rgbn, e, lpsv, xyzn, d[:, None]],
                          axis=1).astype(np.float32)


def parsed_entries(P: np.ndarray, components, max_pts: int = 10000,
                   seed: int = 0) -> dict:
    """{str(component id): rows of P}, each trimmed to at most `max_pts`
    rows sampled with random.Random(seed) in component order, as
    `write_parsed` stores them; plus 'centroid'."""
    rnd = random.Random(seed)
    out = {"centroid": P[:, :3].mean(0)}
    for c, idx in enumerate(components):
        idx = np.asarray(idx).ravel()
        if idx.size > max_pts:
            idx = idx[rnd.sample(range(idx.size), k=max_pts)]
        out[str(c)] = P[idx, :]
    return out


def write_parsed(path: str, P: np.ndarray, components, max_pts: int = 10000,
                 seed: int = 0):
    """parsed/<name>.h5: one dataset per component plus 'centroid'."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as hf:
        for key, rows in parsed_entries(P, components, max_pts, seed).items():
            hf.create_dataset(key, data=rows)
