"""Cloud readers and label up-sampling, through the nn1 kernel.

Port of superpoint_graph_tpu/data/provider.py (`read_s3dis_format`,
`read_semantic3d_format`, `interpolate_labels`, `interpolate_labels_batch`,
`reduced_labels2full`, `S3DIS_LABELS`, `object_name_to_label`; reference
provider.py:185-303, 630-687). The S3DIS text files are parsed with numpy
instead of pandas. All annotation objects go through ONE nn1 call over
their concatenated points; labels and object ids are then written slice by
slice in file order, so a point claimed by two objects keeps the later one,
as the JAX package's per-object loop does. The Semantic3D functions read
in chunks of `ver_batch` rows with pandas (imported when called), as the
JAX package does.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..device import card_unless
from ..ops.nn1 import nn1
from ..ops.voxel import prune

S3DIS_LABELS = {
    "ceiling": 1, "floor": 2, "wall": 3, "column": 4, "beam": 5, "window": 6,
    "door": 7, "table": 8, "chair": 9, "bookcase": 10, "sofa": 11, "board": 12,
    "clutter": 13, "stairs": 0,
}


def object_name_to_label(object_class: str) -> int:
    """S3DIS object-name -> class id (provider.py:229-247); unknown names
    give 0."""
    return S3DIS_LABELS.get(object_class, 0)


def read_rows(path: str) -> np.ndarray:
    """A whitespace-separated numeric text file as a float64 [rows, cols]."""
    with open(path, "rb") as f:
        first = f.readline()
        rest = f.read()
    n_cols = len(first.split())
    vals = np.fromstring((first + rest).decode("ascii"), dtype=np.float64,
                         sep=" ")
    if n_cols == 0 or vals.size % n_cols:
        raise ValueError(f"{path}: ragged rows ({vals.size} values, "
                         f"{n_cols} columns in the first row)")
    return vals.reshape(-1, n_cols)


def _nn1_host(db: np.ndarray, queries: np.ndarray, device) -> np.ndarray:
    return nn1(
        torch.as_tensor(np.ascontiguousarray(db, np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                        device=device),
    ).cpu().numpy()


def read_s3dis_format(raw_path: str, label_out: bool = True, device=None):
    """Room txt + Annotations/*.txt objects re-associated by exact 1-NN on
    `device` (default: the card). Returns (xyz f32, rgb u8[, labels u8,
    objects u32])."""
    device = card_unless(device)
    room = read_rows(raw_path)
    xyz = np.ascontiguousarray(room[:, 0:3], dtype=np.float32)
    if room.shape[1] >= 6:
        rgb = np.ascontiguousarray(room[:, 3:6], dtype=np.uint8)
    else:
        rgb = np.zeros((len(room), 3), dtype=np.uint8)
    if not label_out:
        return xyz, rgb
    labels = np.zeros(len(room), dtype=np.uint8)
    objects = np.zeros(len(room), dtype=np.uint32)
    ann = sorted(glob.glob(os.path.dirname(raw_path) + "/Annotations/*.txt"))
    if not ann:
        return xyz, rgb, labels, objects
    pts = [read_rows(f)[:, 0:3].astype(np.float32) for f in ann]
    idx = _nn1_host(xyz, np.concatenate(pts), device)
    start = 0
    for i_object, (fobj, p) in enumerate(zip(ann, pts), start=1):
        name = os.path.splitext(os.path.basename(fobj))[0]
        sl = idx[start:start + len(p)]
        labels[sl] = object_name_to_label(name.split("_")[0])
        objects[sl] = i_object
        start += len(p)
    return xyz, rgb, labels, objects


def interpolate_labels(xyz_up, xyz, labels, device=None):
    """Labels of the pruned cloud `xyz` spread to the full cloud `xyz_up` by
    exact 1-NN on `device`, default the card (provider.py:681-687)."""
    device = card_unless(device)
    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, 1)
    return labels[_nn1_host(xyz, xyz_up, device)].flatten()


def read_semantic3d_format(data_file: str, n_class: int,
                           file_label_path: str, voxel_width: float,
                           ver_batch: int, device=None):
    """A Semantic3D scan (`x y z intensity r g b` rows, labels one a row in
    `file_label_path`) read in chunks of `ver_batch` rows (all at once when
    ver_batch <= 0), each chunk voxel-pruned on `device` (default: the
    card) as soon as it is read, so the host holds one chunk of raw points
    (reference provider.py:250-303). The chunks' voxels are concatenated,
    not pruned again: a voxel cut by a chunk boundary appears once per
    chunk (the JAX docstring says "pruned once more"; its code, ported
    here, does not). Returns (xyz f32, rgb u8[, label histograms u32
    [m, n_class + 1] when n_class > 0 and a label file is given; the raw
    labels when voxel_width is 0]).
    """
    import pandas as pd

    device = card_unless(device)
    has_labels = n_class > 0 and bool(file_label_path)
    chunk = ver_batch if ver_batch > 0 else None
    reader = pd.read_csv(data_file, sep=" ", header=None, chunksize=chunk)
    chunks = reader if chunk else [reader]
    lab_reader = None
    if has_labels:
        lab_reader = pd.read_csv(file_label_path, header=None,
                                 chunksize=chunk)
        lab_reader = lab_reader if chunk else iter([lab_reader])
    xyz_parts, rgb_parts, lab_parts = [], [], []
    for part in chunks:
        v = part.values
        xyz_c = np.ascontiguousarray(v[:, 0:3], np.float32)
        rgb_c = np.ascontiguousarray(v[:, 4:7], np.uint8)
        lab_c = (next(lab_reader).values.ravel().astype(np.int32)
                 if has_labels else None)
        if voxel_width > 0:
            xyz_c, rgb_c, lab_c, _ = prune(
                xyz_c, voxel_width, rgb_c, lab_c, None,
                n_class if has_labels else 0, 0, device=device)
        xyz_parts.append(xyz_c)
        rgb_parts.append(rgb_c)
        lab_parts.append(lab_c)
    xyz = np.concatenate(xyz_parts)
    rgb = np.concatenate(rgb_parts)
    if has_labels:
        return xyz, rgb, np.concatenate(lab_parts)
    return xyz, rgb


def reduced_labels2full(labels_red, components, n_ver: int) -> np.ndarray:
    """Per-superpoint labels spread to the points of each component
    (provider.py:630-636): uint8 [n_ver], 0 where no component covers."""
    full = np.zeros(n_ver, dtype=np.uint8)
    for c, comp in enumerate(components):
        full[np.asarray(comp, np.int64)] = labels_red[c]
    return full


def interpolate_labels_batch(data_file: str, xyz, labels, ver_batch: int,
                             device=None) -> np.ndarray:
    """Labels of the pruned cloud `xyz` spread to every raw point of
    `data_file`, read in chunks of `ver_batch` rows: one exact nn1 call per
    chunk on `device`, default the card (provider.py:637-679). A label
    histogram [m, c] gives its argmax."""
    import pandas as pd

    device = card_unless(device)
    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, 1)
    db = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                         device=device)
    out = []
    for part in pd.read_csv(data_file, sep=" ", header=None,
                            chunksize=ver_batch if ver_batch > 0 else 10**9):
        q = torch.as_tensor(np.ascontiguousarray(part.values[:, 0:3],
                                                 np.float32), device=device)
        out.append(labels[nn1(db, q).cpu().numpy()].flatten())
    return (np.concatenate(out) if out
            else np.zeros(0, dtype=labels.dtype))
