"""The benchmark's input generators, frozen.

Copies of the synthetic S3DIS room and Semantic3D scan generators as they
stood when the benchmark was defined (`superpoint_graph_tpu_torch/data/
synthetic.py`: `synthetic_room`, `write_s3dis_room`, `big_scene_labeled`,
`write_semantic3d_scan` and the fixed-width text writer). The program may
change its own copies; these stay, so that a seed gives the same clouds,
byte for byte, in every later check. tests/test_portbench_inputs.py holds
them to the program's copies at small sizes.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

# the seed the cells' clouds are drawn from: every run of every seed serves
# the same clouds (seed-drawn clouds moved the rate and the peak between
# seeds more than between two runs of one seed), the run's seed drawing
# the weights, the order and the samples
INPUTS_SEED = 1
# the S3DIS class ids of the classes the rooms are written under
# (S3DIS's own numbering: ceiling 1, floor 2, wall 3, beam 5, table 8,
# clutter 13)
CLASS_NAMES = ("floor", "ceiling", "wall", "table", "clutter", "beam")
S3DIS_ID = {"ceiling": 1, "floor": 2, "wall": 3, "beam": 5, "table": 8,
            "clutter": 13}
# Semantic3D class (1..8) each generator class is written under
SEMANTIC3D_OF_CLASS = np.array([1, 5, 5, 8, 4, 6], np.uint8)


def synthetic_room(rng: np.random.RandomState, n_points: int = 20000,
                   size=(4.0, 3.0, 2.5), noise: float = 0.01,
                   clutter_blobs: bool = False):
    """(xyz f32 [n,3], rgb u8 [n,3], labels i32 [n], objects i32 [n]) of a
    room: floor, ceiling and four walls, three boxes, clutter (uniform, or
    in compact blobs), sensor noise, colours by class."""
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
    specs = [(0.22, 2, 0.0, 0, 0), (0.18, 2, sz, 1, 1), (0.1, 0, 0.0, 2, 2),
             (0.1, 0, sx, 2, 3), (0.1, 1, 0.0, 2, 4), (0.1, 1, sy, 2, 5)]
    obj_id = 6
    for frac, ax, val, lab, obj in specs:
        n = int(n_points * frac)
        parts.append(plane(n, ax, val, lab, obj))
        budget -= n

    n_boxes = 3
    for _ in range(n_boxes):
        n = budget // (n_boxes + 1)
        cx, cy = rng.rand() * (sx - 1) + 0.5, rng.rand() * (sy - 1) + 0.5
        w, d, h = (0.3 + rng.rand() * 0.5, 0.3 + rng.rand() * 0.5,
                   0.3 + rng.rand() * 0.8)
        p = rng.rand(n, 3) - 0.5
        face = rng.randint(0, 6, n)
        for f in range(6):
            m = face == f
            p[m, f // 2] = 0.5 * (1 if f % 2 else -1)
        p *= [w, d, h]
        p += [cx, cy, h / 2]
        parts.append((p, np.full(n, 3), np.full(n, obj_id)))
        obj_id += 1
        budget -= n

    if clutter_blobs:
        n_blobs = max(1, budget // 150)
        centers = rng.rand(n_blobs, 3) * [sx, sy, sz * 0.5]
        asg = rng.randint(0, n_blobs, budget)
        p = centers[asg] + rng.randn(budget, 3) * 0.08
        parts.append((p, np.full(budget, 4), obj_id + asg))
    else:
        p = rng.rand(budget, 3) * [sx, sy, sz * 0.5]
        parts.append((p, np.full(budget, 4), np.full(budget, obj_id)))

    xyz = np.concatenate([p for p, _, _ in parts]).astype(np.float32)
    labels = np.concatenate([lab for _, lab, _ in parts]).astype(np.int32)
    objects = np.concatenate([o for _, _, o in parts]).astype(np.int32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * noise
    palette = np.array([[200, 180, 160], [220, 220, 220], [170, 170, 190],
                        [140, 100, 60], [90, 140, 90], [120, 120, 200]])
    rgb = palette[labels] + rng.randn(len(labels), 3) * 12
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    perm = rng.permutation(len(xyz))
    return xyz[perm], rgb[perm], labels[perm], objects[perm]


def write_s3dis_room(room_dir: Path, rng: np.random.RandomState,
                     n_points: int):
    """`room_dir/<name>.txt` (`x y z r g b`, "%.4f") and one
    `Annotations/<class>_<id>.txt` a object, of a room with clutter in
    blobs and 8 mm of sensor noise. Returns (room file, the S3DIS label id
    of every point, number of objects)."""
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
    s3dis = np.array([S3DIS_ID[c] for c in CLASS_NAMES])
    return room_file, s3dis[labels], len(starts)


def big_scene_parts(n_points: int, seed: int):
    """The rooms of a Semantic3D-scale scan: a grid of `synthetic_room`
    tiles of 250,000 points, ~n_points in all, each tile drawn in turn from
    one RandomState(seed). (xyz, rgb, labels, objects) lists."""
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


def semantic3d_scan(n_points: int, seed: int):
    """(xyz f32 [n,3], intensity i64 [n], rgb u8 [n,3], class u8 [n]) of the
    scan `write_semantic3d_scan` writes."""
    xyz, rgb, lab, _ = (np.concatenate(p) for p in big_scene_parts(
        n_points, seed))
    intensity = np.random.RandomState(seed).randint(-2048, 2048, len(xyz))
    return xyz, intensity, rgb, SEMANTIC3D_OF_CLASS[lab]


def write_semantic3d_scan(path: Path, n_points: int, seed: int,
                          labels: bool = True):
    """`path` as `x y z intensity r g b` text rows (x y z with 3 decimals)
    and, with `labels`, its `.labels` sibling. Returns the scan's arrays
    (`semantic3d_scan`)."""
    scan = semantic3d_scan(n_points, seed)
    xyz, intensity, rgb, cls = scan
    path = Path(path)
    write_rows(path, [(xyz, 4, 3), (intensity, 4, 0), (rgb, 3, 0)])
    if labels:
        write_rows(path.with_suffix(".labels"), [(cls, 1, 0)])
    return scan


def fixed_width(a: np.ndarray, int_digits: int, frac_digits: int):
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


def write_rows(path: Path, cols, block: int = 1 << 20):
    """Space-separated text rows of the [n] or [n, c] arrays in `cols`,
    each with its (integer digits, decimals) for `fixed_width`."""
    cols = [(np.asarray(a).reshape(len(a), -1), i, f) for a, i, f in cols]
    n = len(cols[0][0])
    with open(path, "wb") as fh:
        for s in range(0, n, block):
            rows = []
            for a, i, f in cols:
                fld = fixed_width(a[s:s + block], i, f)
                sep = np.full(fld.shape[:2] + (1,), ord(" "), np.uint8)
                rows.append(np.concatenate([fld, sep], 2).reshape(len(fld), -1))
            rows = np.concatenate(rows, 1)
            rows[:, -1] = ord("\n")
            fh.write(rows.tobytes())


def parsed_fixed(a: np.ndarray, frac_digits: int) -> np.ndarray:
    """The float32 a reader gets back from `fixed_width`'s text of `a`: the
    decimal rint(|a| 10^f) / 10^f with a's sign, correctly rounded to
    float64 (an IEEE division of two exact integers is), then to float32."""
    a64 = a.astype(np.float64)
    v = np.rint(np.abs(a64) * 10.0 ** frac_digits) / 10.0 ** frac_digits
    return np.where(a < 0, -v, v).astype(np.float32)
