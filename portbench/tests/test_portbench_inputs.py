"""The frozen generators give what the program's generators gave when the
benchmark was defined, byte for byte, at small sizes."""
import numpy as np
import pytest

from portbench.harness import inputs
from superpoint_graph_tpu_torch.data import synthetic


@pytest.mark.parametrize("blobs", [False, True])
def test_synthetic_room(blobs):
    a = inputs.synthetic_room(np.random.RandomState(3), 5000,
                              clutter_blobs=blobs)
    b = synthetic.synthetic_room(np.random.RandomState(3), 5000,
                                 clutter_blobs=blobs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_write_s3dis_room(tmp_path):
    fa, la, na = inputs.write_s3dis_room(tmp_path / "a" / "room_1",
                                         np.random.RandomState(7), 4000)
    fb, lb, nb = synthetic.write_s3dis_room(tmp_path / "b" / "room_1",
                                            np.random.RandomState(7), 4000)
    assert fa.read_bytes() == fb.read_bytes() and na == nb
    np.testing.assert_array_equal(la, lb)
    names_a = sorted(p.name for p in (fa.parent / "Annotations").iterdir())
    names_b = sorted(p.name for p in (fb.parent / "Annotations").iterdir())
    assert names_a == names_b
    for n in names_a:
        assert ((fa.parent / "Annotations" / n).read_bytes()
                == (fb.parent / "Annotations" / n).read_bytes())


def test_semantic3d_scan(tmp_path):
    scan = inputs.write_semantic3d_scan(tmp_path / "a.txt", 260_000, 11)
    synthetic.write_semantic3d_scan(tmp_path / "b.txt", 260_000, 11)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    assert ((tmp_path / "a.labels").read_bytes()
            == (tmp_path / "b.labels").read_bytes())
    xyz, _, _ = synthetic.big_scene_labeled(260_000, 11)
    np.testing.assert_array_equal(scan[0], xyz)


def test_parsed_fixed_is_what_a_reader_gets(tmp_path):
    scan = inputs.write_semantic3d_scan(tmp_path / "s.txt", 250_000, 5,
                                        labels=False)
    rows = np.loadtxt(tmp_path / "s.txt", usecols=(0, 1, 2), max_rows=20000)
    np.testing.assert_array_equal(rows.astype(np.float32),
                                  inputs.parsed_fixed(scan[0][:20000], 3))
