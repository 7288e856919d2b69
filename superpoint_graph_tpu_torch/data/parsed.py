"""Per-superpoint point sets ("parsed" rows) and class counts.

Port of superpoint_graph_tpu/data/parsed.py (`build_point_matrix`,
`write_parsed`, `preprocess_pointclouds`, the class counts and
`class_weights`; reference s3dis_dataset.py:72-162, sema3d_dataset.py,
vkitti_dataset.py, custom_dataset.py), whose module imports h5py at top
level. `parsed_entries` builds the same per-component arrays straight from
a partition, with no h5 round trip; the file functions import h5py only
when called. The plane elevation is the RANSAC fit of utils/ransac.py (the
JAX package's sklearn RANSACRegressor, copied).

Row layouts (`STYLES`): s3dis, 15 columns: [xyz, rgb/255-0.5, elevation,
lpsv-0.5, xyz normalised to the cloud's box, distance to the cloud's
centre]; sema3d, 11 columns: the first 11 of those (the loader selects
them with pc_attribs="xyzrgbelpsv"); vkitti, 14 columns: s3dis's first
14 with the lpsv columns zero; custom_dataset, 14 columns: s3dis's first
14.
"""
from __future__ import annotations

import os
import random

import numpy as np

from ..utils.ransac import plane_elevation as _plane_elevation


STYLES = ("s3dis", "sema3d", "vkitti", "custom_dataset")


def _check_style(style: str):
    if style not in STYLES:
        raise ValueError(f"style={style!r}: one of {STYLES}")


def build_point_matrix(xyz, rgb, geof, style: str = "s3dis",
                       plane_elevation: bool = False,
                       elevation=None) -> np.ndarray:
    """The parsed per-point row matrix of a cloud (column layout in
    data/loader.py) in one of STYLES; the elevation is the one given, else
    with plane_elevation z above the RANSAC ground plane
    (s3dis_dataset.py:127-133), else the simple z/4 - 0.5 (:135-136)."""
    _check_style(style)
    xyz = np.asarray(xyz, np.float32)
    rgbn = np.asarray(rgb, np.float32) / 255.0 - 0.5
    if elevation is None:
        elevation = (_plane_elevation(xyz) if plane_elevation
                     else xyz[:, 2] / 4.0 - 0.5)
    e = np.asarray(elevation)[:, None].astype(np.float32)
    if style == "vkitti":
        lpsv = np.zeros((len(xyz), 4), np.float32)
    else:
        lpsv = geof.astype(np.float32) - 0.5
    if style == "sema3d":
        return np.concatenate([xyz, rgbn, e, lpsv], axis=1).astype(np.float32)
    mi, ma = xyz.min(0, keepdims=True), xyz.max(0, keepdims=True)
    cols = [xyz, rgbn, e, lpsv, (xyz - mi) / (ma - mi + 1e-8)]
    if style == "s3dis":
        room_center = xyz[:, :2].mean(0)
        d = np.sqrt(((xyz[:, :2] - room_center) ** 2).sum(1))
        cols.append(((d - d.mean()) / (d.std() + 1e-10))[:, None])
    return np.concatenate(cols, axis=1).astype(np.float32)


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


def write_class_count(path: str, class_count: np.ndarray):
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("class_count", data=class_count, dtype="int")


def read_class_count(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f["class_count"][:]


def preprocess_pointclouds(root: str, dataset: str = "s3dis",
                           n_classes: int = 13, supervized: bool = False,
                           plane_elevation: bool = False):
    """Every <root>/superpoint_graphs/<folder>/<name>.h5 with its
    features/ (features_supervision/ when supervized) file ->
    parsed/<folder>/<name>.h5, and the per-class point counts of each folder
    -> parsed/class_count.h5 (a column a folder; one vector for a single
    folder). `dataset` is the row style, one of STYLES (JAX
    parsed.py:105-158)."""
    import h5py

    _check_style(dataset)
    spg_root = os.path.join(root, "superpoint_graphs")
    feat_dirname = "features_supervision" if supervized else "features"
    folders = sorted(d for d in os.listdir(spg_root)
                     if os.path.isdir(os.path.join(spg_root, d)))
    n_folds = max(len(folders), 1)
    class_count = np.zeros((n_classes, n_folds), dtype="int64")
    for fi, folder in enumerate(folders):
        out_dir = os.path.join(root, "parsed", folder)
        os.makedirs(out_dir, exist_ok=True)
        for fname in sorted(os.listdir(os.path.join(spg_root, folder))):
            if not fname.endswith(".h5"):
                continue
            with h5py.File(os.path.join(root, feat_dirname, folder, fname),
                           "r") as f:
                xyz = f["xyz"][:]
                rgb = f["rgb"][:].astype(np.float64)
                labels = f["labels"][:]
                geof = f["geof"][:]
                elevation = f["elevation"][:] if supervized else None
            if labels.ndim > 1 and labels.shape[1] > 1:
                hard = np.argmax(labels[:, 1:], 1)
            else:
                # ids, or the one-column histogram of a cloud partitioned
                # without labels (the JAX package's bincount raises on it)
                hard = np.maximum(labels.astype(np.int64).ravel() - 1, 0)
            class_count[:, fi] += np.bincount(
                hard, minlength=n_classes)[:n_classes]
            P = build_point_matrix(xyz, rgb, geof, style=dataset,
                                   plane_elevation=plane_elevation,
                                   elevation=elevation)
            with h5py.File(os.path.join(spg_root, folder, fname), "r") as f:
                numc = len(f["components"].keys())
                comps = [f[f"components/{c}"][:].ravel() for c in range(numc)]
            write_parsed(os.path.join(out_dir, fname), P, comps)
    write_class_count(os.path.join(root, "parsed", "class_count.h5"),
                      class_count if n_folds > 1 else class_count[:, 0])


def class_weights(class_count: np.ndarray, mode: str,
                  fold_cols=None) -> np.ndarray:
    """none / proportional / sqrt class weights (s3dis_dataset.py:72-81):
    mean count over each class's count, over the columns fold_cols of a
    per-folder count."""
    n_classes = class_count.shape[0]
    if mode == "none":
        return np.ones(n_classes, np.float32)
    counts = class_count
    if counts.ndim > 1:
        if fold_cols is not None:
            fold_cols = [c for c in fold_cols if c < counts.shape[1]]
            counts = counts[:, fold_cols]
        counts = counts.sum(1)
    w = counts.mean() / np.maximum(counts, 1)
    if mode == "sqrt":
        w = np.sqrt(w)
    return w.astype(np.float32)
