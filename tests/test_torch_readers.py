"""The port's host readers and ply writers against the JAX package's:
utils/plyio.py, and data/provider.py's read_vkitti_format, read_ply,
read_pcd / write_pcd, read_las, the colour maps and the *2ply writers.
Readers give equal arrays and dtypes on the same seeded files; writers
give byte-identical files for the same arrays."""
import numpy as np
import pytest

from superpoint_graph_tpu.data import provider as pj
from superpoint_graph_tpu.utils import plyio as plyio_j
from superpoint_graph_tpu_torch.data import provider as pt
from superpoint_graph_tpu_torch.data.synthetic import (LAS_RECORD,
                                                       synthetic_room,
                                                       write_las)
from superpoint_graph_tpu_torch.utils import plyio as plyio_t


def assert_same(a, b):
    """Equal nested tuples/dicts of arrays, dtypes included."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _cloud(n=500, seed=0):
    xyz, rgb, labels, _ = synthetic_room(np.random.RandomState(seed), n)
    return xyz, rgb, labels


def _vertex(xyz, rgb, labels=None):
    out = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
           "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}
    if labels is not None:
        out["label"] = labels
    return out


@pytest.mark.parametrize("text", [True, False], ids=["ascii", "binary"])
@pytest.mark.parametrize("label", [None, "u1", "i4", "f4"])
def test_ply_reader_and_writer(tmp_path, text, label):
    """plyio.write_ply of both packages: the same bytes; read_ply of both
    (provider and plyio): equal arrays and dtypes."""
    xyz, rgb, labels = _cloud()
    labels = None if label is None else (labels + 1).astype(label)
    files = {}
    for key, mod in (("t", plyio_t), ("j", plyio_j)):
        files[key] = tmp_path / f"{key}.ply"
        mod.write_ply(str(files[key]), _vertex(xyz, rgb, labels), text=text)
    assert files["t"].read_bytes() == files["j"].read_bytes()
    path = str(files["t"])
    assert_same(pt.read_ply(path), pj.read_ply(path))
    assert_same(plyio_t.read_ply_elements(path),
                plyio_j.read_ply_elements(path))
    got_xyz, got_rgb, got_labels = pt.read_ply(path)
    np.testing.assert_allclose(got_xyz, xyz, atol=0 if not text else 5e-6)
    np.testing.assert_array_equal(got_rgb, rgb)
    assert (got_labels.size == 0 if labels is None
            else np.array_equal(got_labels, labels))


@pytest.mark.parametrize("text", [True, False], ids=["ascii", "binary"])
def test_ply_elements(tmp_path, text):
    """A vertex and an edge element, and an empty element: the same bytes
    from both writers, the same arrays from both readers."""
    rng = np.random.RandomState(2)
    elements = {
        "vertex": {"x": rng.rand(7).astype(np.float32),
                   "w": rng.rand(7), "c": rng.randint(-5, 5, 7).astype("i1")},
        "edge": {"vertex1": rng.randint(0, 7, 11).astype(np.int32),
                 "vertex2": rng.randint(0, 7, 11).astype(np.uint32),
                 "s": rng.randint(0, 9, 11).astype("u2")},
        "face": {"k": np.zeros(0, np.int16)},
    }
    for key, mod in (("t", plyio_t), ("j", plyio_j)):
        mod.write_ply_elements(str(tmp_path / f"{key}.ply"), elements,
                               text=text)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got = plyio_t.read_ply_elements(str(tmp_path / "t.ply"))
    assert_same(got, plyio_j.read_ply_elements(str(tmp_path / "t.ply")))
    assert_same(got["edge"], elements["edge"])


def test_not_a_ply(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"nope\n")
    for mod in (plyio_t, plyio_j):
        with pytest.raises(ValueError, match="not a ply"):
            mod.read_ply(str(path))


def _binary_pcd(path, n, labels, rng):
    """A binary PCD with an intensity field and a 2-wide normal field
    around x, y, z (and u4 labels when `labels`)."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
              ("normal", "<f4", (2,))] + ([("label", "<u4")] if labels else [])
    rec = np.zeros(n, dtype=fields)
    for k in ("x", "y", "z", "intensity"):
        rec[k] = rng.rand(n)
    rec["normal"] = rng.rand(n, 2)
    if labels:
        rec["label"] = rng.randint(0, 9, n)
    names = " ".join(f[0] for f in fields)
    k = len(fields)
    head = (f"# .PCD v0.7\nVERSION 0.7\nFIELDS {names}\nSIZE {' '.join(['4'] * k)}"
            f"\nTYPE F F F F F{' U' if labels else ''}\n"
            f"COUNT 1 1 1 1 2{' 1' if labels else ''}\nWIDTH {n}\nHEIGHT 1\n"
            f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(head.encode() + rec.tobytes())
    return rec


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "no_labels"])
def test_pcd_ascii(tmp_path, labels):
    """write_pcd of both packages: the same bytes; read_pcd of both: equal
    arrays and dtypes, xyz within the "%.6g" format."""
    xyz, _, lab = _cloud(400, 1)
    lab = lab + 1 if labels else None
    for key, mod in (("t", pt), ("j", pj)):
        mod.write_pcd(str(tmp_path / f"{key}.pcd"), xyz, lab)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    got = pt.read_pcd(str(tmp_path / "t.pcd"))
    assert_same(got, pj.read_pcd(str(tmp_path / "t.pcd")))
    np.testing.assert_allclose(got[0], xyz, rtol=1e-5, atol=1e-6)
    assert (got[1].size == 0 if lab is None
            else np.array_equal(got[1], lab))


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "no_labels"])
def test_pcd_binary(tmp_path, labels):
    """A binary PCD with extra fields (one of count 2): both readers give
    the file's x, y, z and labels."""
    rec = _binary_pcd(tmp_path / "b.pcd", 64, labels, np.random.RandomState(3))
    got = pt.read_pcd(str(tmp_path / "b.pcd"))
    assert_same(got, pj.read_pcd(str(tmp_path / "b.pcd")))
    np.testing.assert_array_equal(got[0][:, 2], rec["z"])
    if labels:
        np.testing.assert_array_equal(got[1], rec["label"])


def test_pcd_unsupported_mode(tmp_path):
    path = tmp_path / "c.pcd"
    path.write_bytes(b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                     b"COUNT 1 1 1\nPOINTS 0\nDATA binary_compressed\n")
    for mod in (pt, pj):
        with pytest.raises(ValueError, match="binary_compressed"):
            mod.read_pcd(str(path))


def test_pcd_header_without_data(tmp_path):
    """A header that ends before its DATA line raises in the port (the JAX
    read_pcd reads empty lines for ever there, ROADMAP queue 3)."""
    path = tmp_path / "t.pcd"
    path.write_bytes(b"VERSION 0.7\nFIELDS x y z\nPOINTS 3\n")
    with pytest.raises(ValueError, match="no DATA line"):
        pt.read_pcd(str(path))


# (minor version, point format): every format each version defines; 1.4
# files carry their count in the 64-bit field only
LAS_CASES = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (2, 3),
             (3, 4), (3, 5), (4, 6), (4, 7), (4, 8), (4, 9), (4, 10), (4, 3)]


@pytest.mark.parametrize("version,fmt", LAS_CASES,
                         ids=[f"1.{v}-format{f}" for v, f in LAS_CASES])
def test_las(tmp_path, version, fmt):
    """read_las of both packages on LAS 1.0-1.4 files of every point
    format: equal f32 arrays, within f32 rounding at 4 km (2.4e-4) of the
    xyz the file holds, which is within its 1 mm scale of the cloud."""
    rng = np.random.RandomState(10 * version + fmt)
    xyz = rng.rand(333, 3) * [80, 60, 9] + [4.0e3, -2.0e2, 1.0]
    path = str(tmp_path / "c.las")
    held = write_las(path, xyz, (1, version), fmt,
                     rgb=rng.randint(0, 256, (333, 3)))
    got = pt.read_las(path)
    assert_same(got, pj.read_las(path))
    assert got.dtype == np.float32 and got.shape == (333, 3)
    np.testing.assert_allclose(got, held, rtol=0, atol=5e-4)
    np.testing.assert_allclose(held, xyz, rtol=0, atol=5e-4)
    with open(path, "rb") as f:
        assert len(f.read()) - (227, 227, 227, 235, 375)[version] == \
            333 * LAS_RECORD[fmt]


def test_las_bad_signature_and_laz(tmp_path):
    """A file without the LASF signature raises ValueError in both; a
    compressed one (the format byte's top bit) raises the same error in
    both (ImportError without laspy)."""
    bad = tmp_path / "bad.las"
    bad.write_bytes(b"NOPE" + b"\0" * 400)
    for mod in (pt, pj):
        with pytest.raises(ValueError, match="bad signature"):
            mod.read_las(str(bad))
    laz = tmp_path / "c.laz"
    write_las(str(laz), np.random.RandomState(0).rand(10, 3), (1, 2), 3)
    raw = bytearray(laz.read_bytes())
    raw[104] |= 0x80
    laz.write_bytes(bytes(raw))
    errors = []
    for mod in (pt, pj):
        with pytest.raises(Exception) as e:
            mod.read_las(str(laz))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_vkitti_reader(tmp_path):
    """read_vkitti_format of both packages on float32 rows with every raw
    label 0..13: equal arrays and dtypes; labels + 1 with 14 -> 0."""
    rng = np.random.RandomState(4)
    data = np.hstack([rng.rand(300, 3) * 20, rng.randint(0, 256, (300, 3)),
                      np.arange(300)[:, None] % 14]).astype(np.float32)
    path = str(tmp_path / "0001_00000.npy")
    np.save(path, data)
    got = pt.read_vkitti_format(path)
    assert_same(got, pj.read_vkitti_format(path))
    want = data[:, 6] + 1
    want[want == 14] = 0
    np.testing.assert_array_equal(got[2], want)


def test_colormaps():
    """labels_to_colors and get_color_from_label of both packages agree for
    every dataset, ids past a table wrap; an unknown dataset raises."""
    ids = np.arange(-3, 30)
    for dataset in ("s3dis", "sema3d", "vkitti", "custom_dataset"):
        assert_same(pt.labels_to_colors(ids, dataset),
                    pj.labels_to_colors(ids, dataset))
        for i in (0, 5, 13, 40):
            assert_same(pt.get_color_from_label(i, dataset),
                        pj.get_color_from_label(i, dataset))
    for mod in (pt, pj):
        with pytest.raises(ValueError, match="unknown dataset"):
            mod.get_color_from_label(1, "kitti")


class _Ptp(np.ndarray):
    """An array with the `ptp` method numpy 2 removed, which the JAX
    package's scalar2ply and embedding2ply call (ROADMAP queue 3)."""

    def ptp(self, axis=None):
        return np.ptp(np.asarray(self), axis)


def _writer_cases(rng):
    xyz, rgb, labels = _cloud(600, 5)
    n = len(xyz)
    comps = np.array_split(rng.permutation(n), 37)
    scores = rng.rand(n, 9)
    hist = rng.randint(0, 5, (n, 14))
    emb = rng.randn(n, 8).astype(np.float32)
    src, tgt = rng.randint(0, n, 90), rng.randint(0, n, 90)
    graph = {"sp_centroids": rng.rand(37, 3), "source": src[:40, None] % 37,
             "target": tgt[:40, None] % 37}
    return {
        "partition2ply": lambda m, f: m.partition2ply(f, xyz, comps),
        "geof2ply": lambda m, f: m.geof2ply(f, xyz, rng_geof(n)),
        "prediction2ply_ids": lambda m, f: m.prediction2ply(
            f, xyz, labels + 1, 13, "s3dis"),
        "prediction2ply_scores": lambda m, f: m.prediction2ply(
            f, xyz, scores, 8, "sema3d"),
        "prediction2ply_vkitti": lambda m, f: m.prediction2ply(
            f, xyz, (labels * 2) % 14, 13, "vkitti"),
        "error2ply": lambda m, f: m.error2ply(f, xyz, rgb, hist,
                                              (labels + 1) % 14),
        "scalar2ply": lambda m, f: m.scalar2ply(
            f, xyz, xyz[:, 2].astype(np.float64).view(_Ptp)),
        "embedding2ply_3": lambda m, f: m.embedding2ply(
            f, xyz, emb[:, :3].view(_Ptp)),
        "embedding2ply_8": lambda m, f: m.embedding2ply(f, xyz, emb.view(_Ptp)),
        "spg2ply": lambda m, f: m.spg2ply(f, graph),
        "edge_class2ply2": lambda m, f: m.edge_class2ply2(
            f, src % 2, xyz, src, tgt),
    }


def rng_geof(n):
    g = np.random.RandomState(6).rand(n, 4).astype(np.float32)
    g[:5] = [1.2, -0.1, 0.5, 0.7]  # clipped channels
    return g


WRITERS = list(_writer_cases(np.random.RandomState(0)))


@pytest.mark.parametrize("name", WRITERS)
def test_ply_writers_byte_identical(tmp_path, name):
    """Each *2ply writer of both packages on the same arrays: the same
    bytes."""
    for key, mod in (("t", pt), ("j", pj)):
        _writer_cases(np.random.RandomState(7))[name](
            mod, str(tmp_path / f"{key}.ply"))
    got = (tmp_path / "t.ply").read_bytes()
    assert got == (tmp_path / "j.ply").read_bytes()
    assert got.startswith(b"ply\nformat ascii 1.0\n")
    n_vertex = int(got.split(b"element vertex ")[1].split(b"\n")[0])
    assert n_vertex > 0

