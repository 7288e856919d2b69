"""A synthetic S3DIS room written in the raw layout, for smoke runs and profiles.

`synthetic_room` is the port's copy of the JAX package's numpy generator
(superpoint_graph_tpu/data/synthetic.py:16-103), with the same behaviour:
the same seed gives the same arrays (tests/test_torch_slice.py holds the two
together).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .provider import S3DIS_LABELS


def synthetic_room(
    rng: np.random.RandomState,
    n_points: int = 20000,
    size=(4.0, 3.0, 2.5),
    noise: float = 0.01,
    clutter_blobs: bool = False,
):
    """Returns (xyz f32 [n,3], rgb u8 [n,3], labels i32 [n], objects i32 [n]):
    floor/ceiling/wall planes, box furniture and clutter. labels are the raw
    class ids 0..5 (floor, ceiling, wall, box, clutter, beam); objects are
    instance ids >= 0."""
    sx, sy, sz = size
    parts = []

    def plane(n, fixed_axis, fixed_val, label, obj):
        p = rng.rand(n, 3)
        p[:, 0] *= sx
        p[:, 1] *= sy
        p[:, 2] *= sz
        p[:, fixed_axis] = fixed_val
        return p, np.full(n, label), np.full(n, obj)

    budget = n_points
    # floor, ceiling, 4 walls
    specs = [
        (0.22, 2, 0.0, 0, 0),
        (0.18, 2, sz, 1, 1),
        (0.1, 0, 0.0, 2, 2),
        (0.1, 0, sx, 2, 3),
        (0.1, 1, 0.0, 2, 4),
        (0.1, 1, sy, 2, 5),
    ]
    obj_id = 6
    for frac, ax, val, lab, obj in specs:
        n = int(n_points * frac)
        parts.append(plane(n, ax, val, lab, obj))
        budget -= n

    # boxes (furniture)
    n_boxes = 3
    for b in range(n_boxes):
        n = budget // (n_boxes + 1)
        cx, cy = rng.rand() * (sx - 1) + 0.5, rng.rand() * (sy - 1) + 0.5
        w, d, h = 0.3 + rng.rand() * 0.5, 0.3 + rng.rand() * 0.5, 0.3 + rng.rand() * 0.8
        p = rng.rand(n, 3) - 0.5
        # project onto box surface: pick a face per point
        face = rng.randint(0, 6, n)
        for f in range(6):
            m = face == f
            p[m, f // 2] = 0.5 * (1 if f % 2 else -1)
        p *= [w, d, h]
        p += [cx, cy, h / 2]
        parts.append((p, np.full(n, 3), np.full(n, obj_id)))
        obj_id += 1
        budget -= n

    # clutter: uniform volumetric fill by default (historic behavior — it
    # interleaves with every surface, capping the per-voxel ASA oracle at
    # ~55%); clutter_blobs=True clusters it into compact instances like real
    # S3DIS clutter, for harnesses that measure partition quality (ASA/BR)
    if clutter_blobs:
        n_blobs = max(1, budget // 150)
        centers = rng.rand(n_blobs, 3) * [sx, sy, sz * 0.5]
        asg = rng.randint(0, n_blobs, budget)
        p = centers[asg] + rng.randn(budget, 3) * 0.08
        parts.append((p, np.full(budget, 4), obj_id + asg))
        obj_id += n_blobs
    else:
        p = rng.rand(budget, 3) * [sx, sy, sz * 0.5]
        parts.append((p, np.full(budget, 4), np.full(budget, obj_id)))

    xyz = np.concatenate([p for p, _, _ in parts]).astype(np.float32)
    labels = np.concatenate([l for _, l, _ in parts]).astype(np.int32)
    objects = np.concatenate([o for _, _, o in parts]).astype(np.int32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * noise
    # colors correlated with labels + noise
    palette = (np.array(
        [[200, 180, 160], [220, 220, 220], [170, 170, 190],
         [140, 100, 60], [90, 140, 90], [120, 120, 200]]
    ))
    rgb = palette[labels] + rng.randn(len(labels), 3) * 12
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    perm = rng.permutation(len(xyz))
    return xyz[perm], rgb[perm], labels[perm], objects[perm]


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
