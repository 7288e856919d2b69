"""A synthetic S3DIS room written in the raw layout, for smoke runs and profiles.

The room comes from the JAX package's numpy-only generator
(superpoint_graph_tpu/data/synthetic.py), imported rather than copied; it
pulls in neither jax nor h5py.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from superpoint_graph_tpu.data.provider import S3DIS_LABELS
from superpoint_graph_tpu.data.synthetic import synthetic_room

# S3DIS class names the generator's six classes are written under
CLASS_NAMES = ("floor", "ceiling", "wall", "table", "clutter", "beam")


def write_s3dis_room(room_dir: Path, rng: np.random.RandomState,
                     n_points: int) -> tuple[Path, np.ndarray, int]:
    """`room_dir/<name>.txt` plus `room_dir/Annotations/<class>_<id>.txt`,
    one file per object, of a cluttered room with sensor noise.

    Returns (room file, the S3DIS label id of every point, number of
    objects)."""
    xyz, rgb, labels, objects = synthetic_room(
        rng, n_points=n_points, noise=0.008, clutter_blobs=True)
    room_dir = Path(room_dir)
    ann = room_dir / "Annotations"
    ann.mkdir(parents=True)
    rows = np.hstack([xyz, rgb.astype(np.float64)])
    room_file = room_dir / f"{room_dir.name}.txt"
    np.savetxt(room_file, rows, fmt="%.4f")
    order = np.argsort(objects, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(objects[order]) != 0])
    for s, e in zip(starts, np.r_[starts[1:], len(order)]):
        sel = order[s:e]
        name = CLASS_NAMES[int(labels[sel[0]])]
        np.savetxt(ann / f"{name}_{objects[sel[0]] + 1}.txt", rows[sel],
                   fmt="%.4f")
    s3dis = np.array([S3DIS_LABELS[c] for c in CLASS_NAMES])
    return room_file, s3dis[labels], len(starts)
