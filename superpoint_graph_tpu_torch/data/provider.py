"""Cloud readers, ply writers, colour maps and label up-sampling, the
up-sampling through the nn1 kernel.

Port of superpoint_graph_tpu/data/provider.py (`read_s3dis_format`,
`read_vkitti_format`, `read_semantic3d_format`, `read_ply`, `read_pcd`,
`write_pcd`, `read_las`, the colour maps and `*2ply` writers,
`interpolate_labels`, `interpolate_labels_batch`, `reduced_labels2full`,
`S3DIS_LABELS`, `object_name_to_label`; reference provider.py:28-122,
124-303, 397-514, 630-687). The vKITTI, ply, pcd and las readers and the
writers are host numpy and take no device; their arrays, dtypes and files
are the JAX package's, byte for byte. The S3DIS text files are parsed with
numpy instead of pandas. All annotation objects go through ONE nn1 call over
their concatenated points; labels and object ids are then written slice by
slice in file order, so a point claimed by two objects keeps the later one,
as the JAX package's per-object loop does. The Semantic3D functions read
in chunks of `ver_batch` rows with pandas (imported when called), as the
JAX package does; the reader can hand its chunks' raw `x y z` to the
spread, which then labels them without parsing the text again.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..device import card_unless
from ..ops.nn1 import nn1
from ..ops.voxel import prune
from ..utils import plyio, tracing

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
    return tracing.to_host(nn1(
        torch.as_tensor(np.ascontiguousarray(db, np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                        device=device),
    ), "nn1.result").numpy()


def read_s3dis_format(raw_path: str, label_out: bool = True, device=None):
    """Room txt + Annotations/*.txt objects re-associated by exact 1-NN on
    `device` (default: the card). Returns (xyz f32, rgb u8[, labels u8,
    objects u32])."""
    device = card_unless(device)
    with tracing.span("spgt.read.parse"):
        room = read_rows(raw_path)
    tracing.count("parse.rows", len(room))
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
    # one span for all the annotation files (a room may hold hundreds)
    with tracing.span("spgt.read.parse", files=len(ann)):
        pts = [read_rows(f)[:, 0:3].astype(np.float32) for f in ann]
    tracing.count("parse.rows", sum(len(p) for p in pts))
    with tracing.span("spgt.read.labels"):
        idx = _nn1_host(xyz, np.concatenate(pts), device)
        start = 0
        for i_object, (fobj, p) in enumerate(zip(ann, pts), start=1):
            name = os.path.splitext(os.path.basename(fobj))[0]
            sl = idx[start:start + len(p)]
            labels[sl] = object_name_to_label(name.split("_")[0])
            objects[sl] = i_object
            start += len(p)
    return xyz, rgb, labels, objects


def read_vkitti_format(raw_path: str):
    """A vKITTI3D frame, npy rows [x y z r g b ... label]: (xyz f32, rgb and
    labels in the file's dtype). Labels are shifted by one so that 0 is
    free, and the don't-care class (13, so 14 shifted) becomes 0
    (provider.py:219-227)."""
    data = np.load(raw_path)
    xyz = np.ascontiguousarray(data[:, 0:3], np.float32)
    rgb = np.ascontiguousarray(data[:, 3:6])
    labels = data[:, -1] + 1
    labels[labels == 14] = 0
    return xyz, rgb, labels


def interpolate_labels(xyz_up, xyz, labels, device=None):
    """Labels of the pruned cloud `xyz` spread to the full cloud `xyz_up` by
    exact 1-NN on `device`, default the card (provider.py:681-687)."""
    device = card_unless(device)
    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, 1)
    with tracing.span("spgt.spread.nn1"):
        idx = _nn1_host(xyz, xyz_up, device)
    with tracing.span("spgt.spread.gather"):
        return labels[idx].flatten()


def read_semantic3d_format(data_file: str, n_class: int,
                           file_label_path: str, voxel_width: float,
                           ver_batch: int, device=None,
                           raw_xyz_out: list | None = None):
    """A Semantic3D scan (`x y z intensity r g b` rows, labels one a row in
    `file_label_path`) read in chunks of `ver_batch` rows (all at once when
    ver_batch <= 0), each chunk voxel-pruned on `device` (default: the
    card) as soon as it is read (reference provider.py:250-303). The
    chunks' voxels are concatenated, not pruned again: a voxel cut by a
    chunk boundary appears once per chunk (the JAX docstring says "pruned
    once more"; its code, ported here, does not). Returns (xyz f32, rgb
    u8[, label histograms u32 [m, n_class + 1] when n_class > 0 and a label
    file is given; the raw labels when voxel_width is 0]).

    Without `raw_xyz_out` the host holds one chunk of raw points at a time.
    With it, each chunk's raw `x y z` (float32 [rows, 3], as parsed, before
    the prune) is appended to that list and stays on the host: 12 bytes a
    raw point, for `interpolate_labels_batch(raw_xyz=...)` to label without
    a second parse.
    """
    import pandas as pd

    device = card_unless(device)
    has_labels = n_class > 0 and bool(file_label_path)
    chunk = ver_batch if ver_batch > 0 else None
    # the text is parsed when a chunk reader is iterated (by read_csv
    # itself without chunks)
    with tracing.span("spgt.read.parse"):
        reader = pd.read_csv(data_file, sep=" ", header=None,
                             chunksize=chunk)
        chunks = iter(reader if chunk else [reader])
        lab_reader = None
        if has_labels:
            lab_reader = pd.read_csv(file_label_path, header=None,
                                     chunksize=chunk)
            lab_reader = lab_reader if chunk else iter([lab_reader])
    xyz_parts, rgb_parts, lab_parts = [], [], []
    while True:
        with tracing.span("spgt.read.parse"):
            part = next(chunks, None)
            lab_c = (next(lab_reader).values.ravel().astype(np.int32)
                     if has_labels and part is not None else None)
        if part is None:
            break
        tracing.count("parse.rows", len(part))
        v = part.values
        xyz_c = np.ascontiguousarray(v[:, 0:3], np.float32)
        if raw_xyz_out is not None:
            raw_xyz_out.append(xyz_c)
        rgb_c = np.ascontiguousarray(v[:, 4:7], np.uint8)
        if voxel_width > 0:
            with tracing.span("spgt.read.prune"):
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


def read_ply(filename: str):
    """(xyz f32 [n, 3], rgb u8 [n, 3], labels [n] in the file's dtype) of a
    ply's vertices (provider.py:397-410); rgb zeros without red/green/blue,
    labels an empty float array without a `label` property."""
    props = plyio.read_ply(filename)
    xyz = np.stack([props[k] for k in ("x", "y", "z")], 1).astype(np.float32)
    if all(k in props for k in ("red", "green", "blue")):
        rgb = np.stack([props[k] for k in ("red", "green", "blue")],
                       1).astype(np.uint8)
    else:
        rgb = np.zeros((len(xyz), 3), np.uint8)
    labels = np.asarray(props["label"]) if "label" in props else np.zeros(0)
    return xyz, rgb, labels


_PCD_TYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 1): "<i1",
              ("I", 2): "<i2", ("I", 4): "<i4", ("U", 1): "<u1",
              ("U", 2): "<u2", ("U", 4): "<u4"}


def read_pcd(filename: str):
    """(xyz f32 [n, 3], labels int64 [n], empty without a `label` field) of
    a PCD v0.7 file, DATA ascii or binary, any field layout (the reference's
    read_pcd does not run, provider.py:412-417)."""
    with open(filename, "rb") as f:
        header = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{filename}: no DATA line in the header")
            line = line.decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()
        dtype = np.dtype([
            (name, _PCD_TYPES[(t.upper(), s)]) if c == 1
            else (name, _PCD_TYPES[(t.upper(), s)], (c,))
            for name, t, s, c in zip(fields, header["TYPE"], sizes, counts)])
        if mode == "ascii":
            body = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=n)
            rec = np.zeros(n, dtype=dtype)
            col = 0
            for name, c in zip(fields, counts):
                rec[name] = (body[:, col].astype(dtype[name]) if c == 1
                             else body[:, col:col + c].astype(dtype[name].base))
                col += c
        elif mode == "binary":
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype,
                                count=n)
        else:
            raise ValueError(
                f"unsupported PCD DATA mode {mode!r} (ascii/binary only)")
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float32)
    labels = (np.asarray(rec["label"]).astype(np.int64) if "label" in fields
              else np.zeros(0, np.int64))
    return xyz, labels


def write_pcd(filename: str, xyz, labels=None):
    """An ascii PCD v0.7 of xyz ("%.6g") and, when given, labels (field
    `label`, U 4, "%d"): read_pcd's counterpart."""
    xyz = np.asarray(xyz, np.float32)
    fields = ["x", "y", "z"] + (["label"] if labels is not None else [])
    types = ["F"] * 3 + (["U"] if labels is not None else [])
    n = len(xyz)
    with open(filename, "wb") as f:
        f.write((
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\n"
            f"FIELDS {' '.join(fields)}\n"
            f"SIZE {' '.join(['4'] * len(fields))}\n"
            f"TYPE {' '.join(types)}\n"
            f"COUNT {' '.join(['1'] * len(fields))}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n").encode())
        cols = [np.char.mod("%.6g", xyz[:, i]) for i in range(3)]
        if labels is not None:
            cols.append(np.char.mod("%d", np.asarray(labels, np.int64)))
        lines = cols[0]
        for c in cols[1:]:
            lines = np.char.add(np.char.add(lines, " "), c)
        if n:
            f.write(("\n".join(lines) + "\n").encode())


def read_las(filename: str) -> np.ndarray:
    """xyz f32 [n, 3] of a LAS file (reference provider.py:420-437, which
    needs laspy). Plain .las, versions 1.0-1.4 and any point format, is
    parsed from its public layout: the header gives the offset to the
    points, the record length, the count (the 64-bit one at offset 247 from
    version 1.4 when the legacy count is 0), the scales and offsets, and
    the scaled int32 x, y, z lead every record. A compressed file (.laz,
    the format byte's top bit) needs laspy, imported only then."""
    with open(filename, "rb") as f:
        head = f.read(375)
        if head[:4] != b"LASF":
            raise ValueError(f"{filename}: not a LAS file (bad signature)")
        if head[104] & 0x80:
            try:
                import laspy
            except ImportError as e:
                raise ImportError("compressed .laz needs laspy+lazrs; plain "
                                  ".las does not") from e
            g = laspy.read(filename)
            return np.stack([g.x, g.y, g.z], axis=1).astype(np.float32)
        to_pts = int(np.frombuffer(head[96:100], "<u4")[0])
        rlen = int(np.frombuffer(head[105:107], "<u2")[0])
        n = int(np.frombuffer(head[107:111], "<u4")[0])
        if n == 0 and head[25] >= 4 and len(head) >= 255:
            n = int(np.frombuffer(head[247:255], "<u8")[0])
        scale = np.frombuffer(head[131:155], "<f8")
        offset = np.frombuffer(head[155:179], "<f8")
        f.seek(to_pts)
        raw = f.read(n * rlen)
    rec = np.frombuffer(raw, np.uint8).reshape(n, rlen)
    xyz_i = rec[:, :12].copy().view("<i4")
    return (xyz_i.astype(np.float64) * scale + offset).astype(np.float32)


# class colours (provider.py:124-182); custom_dataset uses S3DIS's
_S3DIS_COLORS = np.array(
    [[0, 0, 0], [233, 229, 107], [95, 156, 196], [179, 116, 81],
     [241, 149, 131], [81, 163, 148], [77, 174, 84], [108, 135, 75],
     [41, 49, 101], [79, 79, 76], [223, 52, 52], [89, 47, 95],
     [81, 109, 114], [233, 233, 229]], dtype=np.uint8)
_SEMA3D_COLORS = np.array(
    [[0, 0, 0], [200, 200, 200], [0, 70, 0], [0, 255, 0], [255, 255, 0],
     [255, 0, 0], [148, 0, 211], [0, 0, 255], [255, 135, 0]], dtype=np.uint8)
_VKITTI_COLORS = np.array(
    [[0, 0, 0], [200, 90, 0], [0, 128, 50], [0, 220, 0], [255, 0, 0],
     [100, 100, 100], [200, 200, 200], [255, 0, 255], [255, 150, 0],
     [255, 240, 150], [0, 0, 100], [0, 0, 255], [255, 255, 0], [50, 50, 50]],
    dtype=np.uint8)
COLORS = {"s3dis": _S3DIS_COLORS, "sema3d": _SEMA3D_COLORS,
          "vkitti": _VKITTI_COLORS, "custom_dataset": _S3DIS_COLORS}


def get_color_from_label(object_label: int, dataset: str) -> np.ndarray:
    """The rgb u8 [3] of one class id, modulo the dataset's table."""
    if dataset not in COLORS:
        raise ValueError(f"unknown dataset {dataset!r}")
    table = COLORS[dataset]
    return table[int(object_label) % len(table)]


def labels_to_colors(labels, dataset: str) -> np.ndarray:
    """The rgb u8 [n, 3] of class ids, modulo the dataset's table."""
    table = COLORS[dataset]
    return table[np.asarray(labels, np.int64) % len(table)]


def _write_ply_xyzrgb(filename: str, xyz, rgb):
    """An ascii ply of x, y, z (f32) and red, green, blue (u8)."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    plyio.write_ply(filename, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})


def partition2ply(filename, xyz, components):
    """A random colour a superpoint, from RandomState(len(components))
    (provider.py:28-39)."""
    rng = np.random.RandomState(len(components))
    palette = (rng.rand(len(components), 3) * 255).astype(np.uint8)
    rgb = np.zeros((len(xyz), 3), np.uint8)
    for c, comp in enumerate(components):
        rgb[np.asarray(comp, np.int64)] = palette[c]
    _write_ply_xyzrgb(filename, xyz, rgb)


def geof2ply(filename, xyz, geof):
    """Linearity, planarity and scattering + verticality as red, green and
    blue, clipped to [0, 1] (provider.py:41-50)."""
    color = np.stack([geof[:, 0], geof[:, 1], geof[:, 2] + geof[:, 3]], 1)
    color = np.clip(color, 0, 1)
    _write_ply_xyzrgb(filename, xyz, (color * 255).astype(np.uint8))


def prediction2ply(filename, xyz, prediction, n_label, dataset):
    """Each point in its class colour; a score matrix gives its argmax
    (provider.py:52-64)."""
    if prediction.ndim > 1 and prediction.shape[1] > 1:
        prediction = prediction.argmax(1)
    _write_ply_xyzrgb(filename, xyz, labels_to_colors(prediction, dataset))


def error2ply(filename, xyz, rgb, labels, prediction):
    """Labelled points whose prediction is wrong in red, the rest greyed
    (provider.py:66-98). Label histograms give their argmax, the
    one-column histogram of an unlabelled cloud too (the JAX package's
    comparison raises on it)."""
    if labels.ndim > 1:
        labels = labels.argmax(1)
    if prediction.ndim > 1 and prediction.shape[1] > 1:
        prediction = prediction.argmax(1)
    err = (labels != prediction) & (labels != 0)
    out = (0.3 * rgb + 0.7 * rgb.mean(1, keepdims=True)).astype(np.uint8)
    out[err] = [255, 0, 0]
    _write_ply_xyzrgb(filename, xyz, out)


def scalar2ply(filename, xyz, scalar):
    """A scalar field as a blue-green-red ramp (provider.py:489-514)."""
    s = (scalar - scalar.min()) / (np.ptp(scalar) + 1e-10)
    rgb = np.stack([s, 1 - np.abs(s - 0.5) * 2, 1 - s], 1)
    _write_ply_xyzrgb(filename, xyz, (rgb * 255).astype(np.uint8))


def embedding2ply(filename, xyz, embeddings):
    """Embeddings as colours: their top 3 principal directions when wider
    than 3, each scaled to [0, 1] (provider.py:440-460)."""
    emb = embeddings - embeddings.mean(0, keepdims=True)
    if emb.shape[1] > 3:
        _, vec = np.linalg.eigh(emb.T @ emb)
        emb = emb @ vec[:, -3:]
    emb = (emb - emb.min(0)) / (np.ptp(emb, 0) + 1e-10)
    _write_ply_xyzrgb(filename, xyz, (emb * 255).astype(np.uint8))


def spg2ply(filename, spg_graph):
    """The SPG as a vertex element (the superpoint centroids) and an edge
    element (vertex1/vertex2 of each superedge) (provider.py:100-122)."""
    cent = np.asarray(spg_graph["sp_centroids"], np.float32)
    src = np.asarray(spg_graph["source"]).ravel().astype(np.int32)
    tgt = np.asarray(spg_graph["target"]).ravel().astype(np.int32)
    plyio.write_ply_elements(filename, {
        "vertex": {"x": cent[:, 0], "y": cent[:, 1], "z": cent[:, 2]},
        "edge": {"vertex1": src, "vertex2": tgt}})


def edge_class2ply2(filename, edg_class, xyz, edg_source, edg_target):
    """Edge midpoints, transitions red and the others green
    (provider.py:462-487)."""
    mid = (xyz[edg_source] + xyz[edg_target]) / 2
    rgb = np.zeros((len(mid), 3), np.uint8)
    rgb[edg_class.astype(bool)] = [255, 0, 0]
    rgb[~edg_class.astype(bool)] = [30, 200, 30]
    _write_ply_xyzrgb(filename, mid.astype(np.float32), rgb)


def reduced_labels2full(labels_red, components, n_ver: int) -> np.ndarray:
    """Per-superpoint labels spread to the points of each component
    (provider.py:630-636): uint8 [n_ver], 0 where no component covers."""
    full = np.zeros(n_ver, dtype=np.uint8)
    for c, comp in enumerate(components):
        full[np.asarray(comp, np.int64)] = labels_red[c]
    return full


def _parsed_xyz(data_file: str, ver_batch: int):
    """The `x y z` columns of each chunk of `ver_batch` rows of a Semantic3D
    text file (all rows at once when ver_batch <= 0), parsed as it is
    iterated."""
    import pandas as pd

    with tracing.span("spgt.spread.parse"):
        chunks = iter(pd.read_csv(
            data_file, sep=" ", header=None,
            chunksize=ver_batch if ver_batch > 0 else 10**9))
    while True:
        # the text is parsed when the chunk reader is iterated
        with tracing.span("spgt.spread.parse"):
            part = next(chunks, None)
        if part is None:
            return
        tracing.count("parse.rows", len(part))
        yield part.values[:, 0:3]


def interpolate_labels_batch(data_file: str, xyz, labels, ver_batch: int,
                             device=None, raw_xyz: list | None = None
                             ) -> np.ndarray:
    """Labels of the pruned cloud `xyz` spread to every raw point of
    `data_file`: one exact nn1 call per chunk of raw points on `device`,
    default the card (provider.py:637-679). The chunks are `raw_xyz` when
    given, the reader's (`read_semantic3d_format(raw_xyz_out=...)`), and
    the file is not read; else the file is parsed in chunks of `ver_batch`
    rows. Both give the same labels for the same chunks. A label histogram
    [m, c] gives its argmax."""
    device = card_unless(device)
    labels = np.asarray(labels)
    if labels.ndim > 1 and labels.shape[1] > 1:
        labels = np.argmax(labels, 1)
    db = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                         device=device)
    chunks = _parsed_xyz(data_file, ver_batch) if raw_xyz is None else raw_xyz
    out = []
    for chunk in chunks:
        if raw_xyz is not None:
            tracing.count("spread.reused_rows", len(chunk))
        with tracing.span("spgt.spread.nn1"):
            q = torch.as_tensor(np.ascontiguousarray(chunk, np.float32),
                                device=device)
            idx = tracing.to_host(nn1(db, q), "spread.nn1").numpy()
        with tracing.span("spgt.spread.gather"):
            out.append(labels[idx].flatten())
    return (np.concatenate(out) if out
            else np.zeros(0, dtype=labels.dtype))
