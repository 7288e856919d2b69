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


def _big_scene_parts(n_points: int, seed: int):
    """The rooms of `big_scene_labeled`, in its order and from the same
    generator draws, with their colours: (xyz, rgb, labels, objects) lists."""
    rng = np.random.RandomState(seed)
    per_room = 250_000
    n_rooms = max(1, n_points // per_room)
    side = int(np.ceil(np.sqrt(n_rooms)))
    parts = ([], [], [], [])
    obj_base = 0
    for r in range(n_rooms):
        xyz, rgb, lab, obj = synthetic_room(
            rng, n_points=min(per_room, n_points - r * per_room))
        off = np.array([(r % side) * 4.5, (r // side) * 3.5, 0.0], np.float32)
        for part, a in zip(parts, (xyz + off, rgb, lab, obj + obj_base)):
            part.append(a)
        obj_base += int(obj.max()) + 1
    return parts


def big_scene_labeled(n_points: int, seed: int = 0):
    """A Semantic3D-scale synthetic scan: a grid of `synthetic_room` tiles
    of 250,000 points, ~n_points in all. Returns (xyz f32, labels i32,
    objects i32, instance ids offset per tile). The port's copy of the JAX
    package's generator (superpoint_graph_tpu/data/synthetic.py:152-185)."""
    xyz, _, lab, obj = _big_scene_parts(n_points, seed)
    return (np.concatenate(xyz).astype(np.float32),
            np.concatenate(lab).astype(np.int32),
            np.concatenate(obj).astype(np.int32))


def big_scene(n_points: int, seed: int = 0) -> np.ndarray:
    """The xyz of `big_scene_labeled`."""
    return big_scene_labeled(n_points, seed)[0]


# Semantic3D class (1..8; 0 is unlabelled) each generator class is written
# under: floor -> man-made terrain, ceiling and wall -> buildings, table ->
# cars, clutter -> low vegetation, beam -> hard scape
SEMANTIC3D_OF_CLASS = np.array([1, 5, 5, 8, 4, 6], np.uint8)


def write_semantic3d_scan(path: Path, n_points: int, seed: int = 0):
    """`path` (`x y z intensity r g b` rows) and its `.labels` sibling (one
    Semantic3D class a row) of the `big_scene_labeled` scan, with the tiles'
    colours and an intensity drawn from a RandomState(seed). Returns
    (labels file, the class of every row)."""
    xyz, rgb, lab, _ = (np.concatenate(p) for p in _big_scene_parts(
        n_points, seed))
    intensity = np.random.RandomState(seed).randint(-2048, 2048, len(xyz))
    cls = SEMANTIC3D_OF_CLASS[lab]
    path = Path(path)
    _write_rows(path, [(xyz, 4, 3), (intensity, 4, 0), (rgb, 3, 0)])
    labels_path = path.with_suffix(".labels")
    _write_rows(labels_path, [(cls, 1, 0)])
    return labels_path, cls


def _fixed_width(a: np.ndarray, int_digits: int, frac_digits: int):
    """The numbers of `a` [n, c] as fixed-width ASCII fields [n, c, width]:
    a sign ('-' or '0'), `int_digits` zero-padded integer digits, and a
    point and `frac_digits` rounded decimals when frac_digits > 0."""
    v = np.rint(np.abs(a.astype(np.float64)) * 10.0 ** frac_digits).astype(
        np.int64)
    if int(v.max(initial=0)) >= 10 ** (int_digits + frac_digits):
        raise ValueError(f"a value needs more than {int_digits} digits")
    digits = []
    for _ in range(int_digits + frac_digits):
        v, d = np.divmod(v, 10)
        digits.append(d)
    chars = [np.where(a < 0, ord("-"), ord("0"))]
    chars += [digits[i] + ord("0") for i in range(int_digits + frac_digits - 1,
                                                   frac_digits - 1, -1)]
    if frac_digits:
        chars.append(np.full(a.shape, ord(".")))
        chars += [digits[i] + ord("0") for i in range(frac_digits - 1, -1, -1)]
    return np.stack(chars, -1).astype(np.uint8)


def _write_rows(path: Path, cols, block: int = 1 << 20):
    """Space-separated text rows of the [n] or [n, c] arrays in `cols`,
    each with its (integer digits, decimals) for `_fixed_width`, written in
    blocks of `block` rows by numpy alone (np.savetxt formats row by row in
    Python, ~1 minute for the smoke's 8e6 rows)."""
    cols = [(np.asarray(a).reshape(len(a), -1), i, f) for a, i, f in cols]
    n = len(cols[0][0])
    with open(path, "wb") as fh:
        for s in range(0, n, block):
            rows = []
            for a, i, f in cols:
                fld = _fixed_width(a[s:s + block], i, f)
                sep = np.full(fld.shape[:2] + (1,), ord(" "), np.uint8)
                rows.append(np.concatenate([fld, sep], 2).reshape(len(fld), -1))
            rows = np.concatenate(rows, 1)
            rows[:, -1] = ord("\n")
            fh.write(rows.tobytes())
