"""Synthetic clouds written in the datasets' raw layouts, for smoke runs,
profiles and tests: S3DIS rooms, Semantic3D scans, vKITTI3D street frames
and LAS files.

`synthetic_room` is the port's copy of the JAX package's numpy generator
(superpoint_graph_tpu/data/synthetic.py:16-103), with the same behaviour:
the same seed gives the same arrays (tests/test_torch_slice.py holds the two
together). `station_chunk` is the port's copy of the JAX package's
Semantic3D station generator (tools/semantic3d_headline.py:31-89): the same
`default_rng` state gives the same float32 points
(tests/test_torch_headline.py). `synthetic_street` and `write_las` have no
JAX counterpart.
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


STATION_SIDE = 220.0  # metres: a large outdoor station's footprint


def station_chunk(rg: np.random.Generator, n: int) -> np.ndarray:
    """One chunk of n points of a synthetic outdoor station, [n, 3] f32:
    55% ground, 35% the walls of 40 axis-aligned buildings, 10% compact
    clutter blobs (cars, bushes, poles). Returns are surface-dominated like
    real LiDAR, so pruning at 0.1 m keeps ~1/8 of a 1e8-point station as
    Semantic3D's stations keep at 0.05 m. The buildings and blob centres are
    the same in every chunk; every draw is a float32 PCG draw of `rg`."""
    f1 = np.float32
    n_ground = int(n * 0.55)
    n_wall = int(n * 0.35)
    n_scatter = n - n_ground - n_wall
    g = np.empty((n_ground, 3), np.float32)
    g[:, 0] = rg.random(n_ground, dtype=np.float32) * f1(STATION_SIDE)
    g[:, 1] = rg.random(n_ground, dtype=np.float32) * f1(STATION_SIDE)
    g[:, 2] = f1(0.05) * np.sin(g[:, 0] * f1(0.13)) + f1(
        0.02) * rg.standard_normal(n_ground, dtype=np.float32)

    brs = np.random.RandomState(12345)
    bx = (brs.rand(40) * (STATION_SIDE - 30) + 5).astype(np.float32)
    by = (brs.rand(40) * (STATION_SIDE - 30) + 5).astype(np.float32)
    bw = (brs.rand(40) * 18 + 6).astype(np.float32)
    bd = (brs.rand(40) * 18 + 6).astype(np.float32)
    bh = (brs.rand(40) * 12 + 4).astype(np.float32)
    bid = rg.integers(0, 40, n_wall)
    side = rg.integers(0, 4, n_wall, dtype=np.int8)
    t = rg.random(n_wall, dtype=np.float32)
    z = rg.random(n_wall, dtype=np.float32) * bh[bid]
    wx = np.where(side < 2, bx[bid] + t * bw[bid],
                  np.where(side == 2, bx[bid], bx[bid] + bw[bid]))
    wy = np.where(side < 2, np.where(side == 0, by[bid], by[bid] + bd[bid]),
                  by[bid] + t * bd[bid])
    w = np.stack([wx, wy, z], axis=1)
    w += f1(0.01) * rg.standard_normal((n_wall, 3), dtype=np.float32)

    crs = np.random.RandomState(777)
    n_blobs = 3000
    cx = crs.rand(n_blobs, 3).astype(np.float32) * np.array(
        [STATION_SIDE, STATION_SIDE, 0.0], np.float32)
    cr = (crs.rand(n_blobs) * 0.8 + 0.2).astype(np.float32)
    bidx = rg.integers(0, n_blobs, n_scatter)
    s = cx[bidx] + rg.standard_normal(
        (n_scatter, 3), dtype=np.float32) * (cr[bidx][:, None] * f1(0.35))
    s[:, 2] = np.abs(s[:, 2])
    return np.concatenate([g, w, s])


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


# a street frame's parts: (vKITTI class, share of the points); the
# remainder of the budget goes to don't-care points (13)
_STREET_PARTS = ((4, 0.24), (0, 0.12), (3, 0.18), (1, 0.10), (2, 0.06),
                 (5, 0.03), (6, 0.01), (7, 0.01), (8, 0.02), (9, 0.02),
                 (11, 0.08), (12, 0.04), (10, 0.04))
# class colours, vKITTI ids 0..13
_STREET_RGB = np.array(
    [[110, 130, 70], [40, 110, 30], [80, 160, 60], [170, 150, 130],
     [90, 90, 95], [180, 180, 180], [230, 200, 40], [60, 60, 60],
     [130, 130, 130], [150, 80, 160], [200, 60, 50], [40, 60, 200],
     [220, 220, 230], [120, 170, 230]])


def _box_surface(rng, n, center, size):
    """n points on the faces of an axis-aligned box."""
    p = rng.rand(n, 3) - 0.5
    face = rng.randint(0, 6, n)
    p[np.arange(n), face // 2] = np.where(face % 2, 0.5, -0.5)
    return p * size + center


def synthetic_street(rng: np.random.RandomState, n_points: int,
                     length: float = 10.0, noise: float = 0.01):
    """A vKITTI3D-like street frame, `length` m along x: a road (|y| < 4),
    terrain verges, building facades at |y| = 8, guard rails, trees,
    bushes, poles with signs and lights, small objects, cars, vans and
    trucks: surfaces, as a stereo or lidar frame sees them, and
    don't-care points on a backdrop beyond the far end. Returns (xyz f32
    [n, 3], rgb u8 [n, 3], labels int32 [n]: the raw vKITTI class ids
    0..13)."""
    parts = []
    budget = n_points
    for label, share in _STREET_PARTS:
        n = int(share * n_points)
        budget -= n
        u = rng.rand(n, 3)
        x = u[:, 0] * length
        if label == 4:  # road
            p = np.stack([x, (u[:, 1] - 0.5) * 8, 0.005 * u[:, 2]], 1)
        elif label == 0:  # verges, gently sloped
            y = np.where(u[:, 1] < 0.5, -4 - 4 * u[:, 2], 4 + 4 * u[:, 2])
            p = np.stack([x, y, 0.05 * (np.abs(y) - 4)], 1)
        elif label == 3:  # facades
            side = np.where(u[:, 1] < 0.5, -8.0, 8.0)
            p = np.stack([x, side, 6 * u[:, 2]], 1)
        elif label == 5:  # guard rails
            side = np.where(u[:, 1] < 0.5, -4.3, 4.3)
            p = np.stack([x, side, 0.4 + 0.4 * u[:, 2]], 1)
        elif label in (1, 2):  # tree crowns on trunks, bushes
            k = max(1, int(length / (6 if label == 1 else 4)))
            c = np.stack([rng.rand(k) * length,
                          rng.choice([-1, 1], k) * (5 + 2 * rng.rand(k)),
                          np.full(k, 4.0 if label == 1 else 0.5)], 1)
            r = 1.5 if label == 1 else 0.5
            d = rng.randn(n, 3)  # the crowns' and bushes' outer shells
            d *= (r * (0.9 + 0.1 * u[:, :1])) / np.linalg.norm(
                d, axis=1, keepdims=True)
            p = c[rng.randint(0, k, n)] + d
            if label == 1:  # a fifth of the points on the trunks
                t = rng.rand(n) < 0.2
                p[t, 2] = 2.5 * u[t, 2]
                p[t, :2] = c[rng.randint(0, k, int(t.sum())), :2] + \
                    0.15 * rng.randn(int(t.sum()), 2)
        elif label in (6, 7, 8):  # signs, lights, poles at the kerb
            k = max(1, int(length / 10))
            c = np.stack([rng.rand(k) * length, rng.choice([-4.6, 4.6], k)],
                         1)[rng.randint(0, k, n)]
            if label == 8:
                p = np.stack([c[:, 0] + 0.08 * rng.randn(n),
                              c[:, 1] + 0.08 * rng.randn(n), 4 * u[:, 2]], 1)
            else:
                size = [0.05, 0.6, 0.6] if label == 6 else [0.3, 0.3, 0.9]
                p = _box_surface(rng, n, np.zeros(3), size)
                p[:, :2] += c
                p[:, 2] += 2.5 if label == 6 else 4.0
        else:  # cars (11), vans (12), trucks (10), misc (9): boxes
            size = {11: [4.2, 1.8, 1.5], 12: [5.0, 2.0, 2.2],
                    10: [8.0, 2.5, 3.2], 9: [0.6, 0.6, 0.8]}[label]
            k = max(1, int(length / (8 if label == 11 else 15)))
            c = np.stack([rng.rand(k) * length,
                          rng.choice([-2.0, 2.0], k) if label != 9
                          else rng.choice([-7.0, 7.0], k),
                          np.full(k, size[2] / 2)], 1)
            p = _box_surface(rng, n, c[rng.randint(0, k, n)], size)
        parts.append((p, np.full(n, label)))
    u = rng.rand(budget, 3)  # a backdrop across the street's far end
    p = np.stack([length + 2 + 0.5 * u[:, 0], (u[:, 1] - 0.5) * 16,
                  8 * u[:, 2]], 1)
    parts.append((p, np.full(budget, 13)))
    xyz = np.concatenate([q for q, _ in parts]).astype(np.float32)
    labels = np.concatenate([lab for _, lab in parts]).astype(np.int32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * noise
    rgb = _STREET_RGB[labels] + rng.randn(len(labels), 3) * 12
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    perm = rng.permutation(len(xyz))
    return xyz[perm], rgb[perm], labels[perm]


def write_vkitti_frame(path: Path, rng: np.random.RandomState,
                       n_points: int) -> np.ndarray:
    """`path` (.npy) holding a `synthetic_street` frame as vKITTI3D stores
    one, float32 rows [x y z r g b label]; returns the raw labels."""
    xyz, rgb, labels = synthetic_street(rng, n_points)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.hstack([xyz, rgb.astype(np.float32),
                             labels[:, None].astype(np.float32)]))
    return labels


# LAS point record lengths by point format, and header sizes by minor
# version (the public LAS 1.0-1.4 layouts)
LAS_RECORD = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63, 6: 30, 7: 36, 8: 38,
              9: 59, 10: 67}
LAS_HEADER = {0: 227, 1: 227, 2: 227, 3: 235, 4: 375}


def write_las(path, xyz, version=(1, 2), point_format: int = 3,
              scale=(0.001, 0.001, 0.001), offset=None, rgb=None):
    """An uncompressed LAS file of `xyz` at `scale` from `offset` (default:
    the cloud's min corner, rounded down), version 1.0-1.4 and any point
    format. Formats 2, 3, 5, 7, 8 and 10 carry `rgb` (u8, stored x 256)
    when given; every other field is zero. Version 1.4 stores the count in
    its 64-bit field and leaves the legacy one 0. Returns the xyz the file
    holds (float64)."""
    import struct

    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    scale = np.asarray(scale, np.float64)
    offset = (np.floor(xyz.min(0)) if offset is None
              else np.asarray(offset, np.float64))
    rlen, hsize = LAS_RECORD[point_format], LAS_HEADER[version[1]]
    head = bytearray(hsize)
    head[0:4] = b"LASF"
    head[24], head[25] = version
    struct.pack_into("<H", head, 94, hsize)
    struct.pack_into("<I", head, 96, hsize)
    head[104] = point_format
    struct.pack_into("<H", head, 105, rlen)
    struct.pack_into("<I", head, 107, 0 if version[1] >= 4 else n)
    struct.pack_into("<3d", head, 131, *scale)
    struct.pack_into("<3d", head, 155, *offset)
    hi, lo = xyz.max(0), xyz.min(0)
    struct.pack_into("<6d", head, 179, hi[0], lo[0], hi[1], lo[1], hi[2],
                     lo[2])
    if version[1] >= 4:
        struct.pack_into("<Q", head, 247, n)
    ints = np.round((xyz - offset) / scale).astype("<i4")
    rec = np.zeros((n, rlen), np.uint8)
    rec[:, :12] = ints.view(np.uint8).reshape(n, 12)
    rgb_at = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}.get(point_format)
    if rgb is not None and rgb_at is not None:
        rec[:, rgb_at:rgb_at + 6] = (np.asarray(rgb, np.uint16) * 256).astype(
            "<u2").view(np.uint8).reshape(n, 6)
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(rec.tobytes())
    return ints * scale + offset
