"""S3DIS room reader and label up-sampling, through the nn1 kernel.

Port of superpoint_graph_tpu/data/provider.py (`read_s3dis_format`,
`interpolate_labels`, `S3DIS_LABELS`, `object_name_to_label`; reference
provider.py:185-247, 681-687). The text
files are parsed with numpy instead of pandas. All annotation objects go
through ONE nn1 call over their concatenated points; labels and object ids
are then written slice by slice in file order, so a point claimed by two
objects keeps the later one, as the JAX package's per-object loop does.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..device import card_unless
from ..ops.nn1 import nn1

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
