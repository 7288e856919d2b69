"""The vKITTI3D and custom-dataset recipes and the output CLIs, run by the
port (on the CPU) and by the JAX package on the same small trees:
cli/partition (`--cp_backend exact`) on vKITTI npy frames and on ply, pcd
and las clouds, the parsed rows of both styles, cli/visualize and
cli/write_semantic3d. Caches agree dataset by dataset; the output files
are byte-identical."""
import shutil

import h5py
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.cli import partition as partition_j
from superpoint_graph_tpu.cli import visualize as visualize_j
from superpoint_graph_tpu.cli import write_semantic3d as write_j
from superpoint_graph_tpu.data import parsed as parsed_j
from superpoint_graph_tpu_torch.cli import partition as partition_t
from superpoint_graph_tpu_torch.cli import visualize as visualize_t
from superpoint_graph_tpu_torch.cli import write_semantic3d as write_t
from superpoint_graph_tpu_torch.data import parsed as parsed_t
from superpoint_graph_tpu_torch.data import provider
from superpoint_graph_tpu_torch.data.synthetic import (synthetic_room,
                                                       write_las,
                                                       write_vkitti_frame)
from superpoint_graph_tpu_torch.utils import h5io as h5io_t
from superpoint_graph_tpu_torch.utils import plyio

PARTITION = ["--voxel_width", "0.1", "--reg_strength", "0.1",
             "--k_nn_geof", "15", "--k_nn_adj", "5", "--spg_adjacency", "knn",
             "--cp_backend", "exact"]


def h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def same_component_share(a, b) -> float:
    """Share of the points whose component is the same point set in both
    partitions (in_component arrays)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    base = int(b.max()) + 1
    pairs, inv = np.unique(a * base + b, return_inverse=True)
    pa, pb = pairs // base, pairs % base
    alone = (np.bincount(pa)[pa] == 1) & (np.bincount(pb)[pb] == 1)
    return float(alone[inv.ravel()].mean())


def _vertex(xyz, rgb, labels=None):
    out = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
           "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}
    if labels is not None:
        out["label"] = labels
    return out


def write_custom_tree(root):
    """data/train: one room as a binary ply with uint8 labels 1..6, as an
    ascii pcd with labels and as a LAS 1.2 format 3; data/test: another
    room as an ascii ply without labels."""
    xyz, rgb, lab, _ = synthetic_room(np.random.RandomState(40), 2500)
    (root / "data" / "train").mkdir(parents=True)
    (root / "data" / "test").mkdir(parents=True)
    plyio.write_ply(str(root / "data" / "train" / "a.ply"),
                    _vertex(xyz, rgb, (lab + 1).astype(np.uint8)), text=False)
    provider.write_pcd(str(root / "data" / "train" / "b.pcd"), xyz, lab + 1)
    write_las(str(root / "data" / "train" / "c.las"), xyz, rgb=rgb)
    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(41), 2000)
    plyio.write_ply(str(root / "data" / "test" / "d.ply"), _vertex(xyz, rgb))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{dataset: {"t": port tree, "j": JAX tree}}: the same raw clouds
    partitioned by each package's CLI."""
    base = tmp_path_factory.mktemp("datasets")
    raw = {"vkitti": base / "vkitti_raw", "custom_dataset": base / "custom_raw"}
    for i, fold in enumerate(("01", "02", "03")):
        write_vkitti_frame(raw["vkitti"] / "data" / fold / f"0001_0000{i}.npy",
                           np.random.RandomState(50 + i), 2500)
    write_custom_tree(raw["custom_dataset"])
    out = {}
    for dataset, src in raw.items():
        out[dataset] = {}
        for key in ("t", "j"):
            root = out[dataset][key] = base / f"{dataset}_{key}"
            shutil.copytree(src / "data", root / "data")
            argv = ["--ROOT_PATH", str(root), "--dataset", dataset, *PARTITION]
            if key == "t":
                partition_t.main(argv, device="cpu")
            else:
                partition_j.main(argv)
    return out


def _caches(root):
    return sorted(p.relative_to(root) for p in root.rglob("*.h5"))


@pytest.mark.parametrize("dataset", ["vkitti", "custom_dataset"])
def test_partition_caches_match_jax(trees, dataset):
    """Both CLIs write the same files with the same datasets, dtypes and
    shapes. Features: the pruned cloud, its labels and the kNN adjacency
    equal, distances within 2e-7, geof within 1e-5 on >= 99% of the rows
    and 2e-2 (degenerate neighbourhoods) on >= 99.9% (a row of the JAX
    kNN's geof table can miss a near-tie neighbour, ROADMAP queue 3). Superpoint graphs: every one equal where the
    partitions are, which holds for all but one file at most; >= 95% of
    the points in identical components in every file (the exact solver on
    features that differ in such a row)."""
    t, j = trees[dataset]["t"], trees[dataset]["j"]
    files = _caches(t)
    assert files == _caches(j) and len(files) == 2 * (3 if dataset == "vkitti"
                                                      else 4)
    equal_spgs = 0
    for rel in files:
        a, b = h5_tree(t / rel), h5_tree(j / rel)
        assert a.keys() == b.keys(), rel
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, \
                (rel, k)
        if rel.parts[0] == "features":
            for k in ("xyz", "rgb", "labels", "source", "target"):
                if k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a["distances"], b["distances"],
                                       rtol=0, atol=2e-7)
            row_err = np.abs(a["geof"] - b["geof"]).max(1)
            assert (row_err <= 1e-5).mean() >= 0.99, (rel, row_err.max())
            assert (row_err <= 2e-2).mean() >= 0.999, (rel, row_err.max())
            continue
        in_t, in_j = a["in_component"], b["in_component"]
        assert same_component_share(in_t, in_j) >= 0.95, rel
        if np.array_equal(in_t, in_j):
            equal_spgs += 1
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert equal_spgs >= len(files) // 2 - 1


def test_custom_readers_in_partition(trees):
    """The custom_dataset caches: with --n_labels 0 the first labelled file
    (train/a.ply, after the unlabelled test/d.ply) sets the class count to
    its largest label, for it and every later file: label histograms of
    that count + 1 columns, all in column 0 for the las; test/d.ply, read
    first, has a one-column histogram. --n_labels 9 gives 10 columns."""
    t = trees["custom_dataset"]["t"]
    _, _, lab, _ = synthetic_room(np.random.RandomState(40), 2500)
    hists = {}
    for name in ("train/a", "train/b", "train/c", "test/d"):
        _, xyz, _, _, hists[name] = h5io_t.read_features(
            str(t / "features" / f"{name}.h5"))
        assert len(xyz) > 100 and len(hists[name]) == len(xyz)
    width = int(lab.max()) + 2
    assert {k: v.shape[1] for k, v in hists.items()} == {
        "train/a": width, "train/b": width, "train/c": width, "test/d": 1}
    np.testing.assert_array_equal(hists["train/a"], hists["train/b"])
    assert not hists["train/c"][:, 1:].any() and not hists["test/d"].any()
    args = partition_t.parse_args(["--ROOT_PATH", str(t), "--dataset",
                                   "custom_dataset", "--n_labels", "9",
                                   *PARTITION])
    res = partition_t.partition_file(str(t / "data" / "train" / "b.pcd"),
                                     args, "cpu")
    assert res.labels.shape[1] == 10


def test_custom_split_reads(trees):
    """get_datasets of custom_dataset on the port's tree: train/ (a, b, c)
    and test/ (d). The labelled clouds' node GT is the JAX spg_reader's;
    the las, a histogram with no labelled point, is all -100, and so is
    test/d, whose one-column histogram the JAX spg_reader's argmax raises
    on (ROADMAP queue 3)."""
    from superpoint_graph_tpu.data.spg_io import spg_reader as reader_j
    from superpoint_graph_tpu_torch.data.datasets import get_datasets
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS

    root = trees["custom_dataset"]["t"]
    train, test, _, _ = get_datasets("custom_dataset", str(root),
                                     EDGE_ATTRIBS, spg_attribs01=False)
    assert [e[4] for e in train] == ["train/a", "train/b", "train/c"]
    assert [e[4] for e in test] == ["test/d"]
    for entry in train:
        want = reader_j(str(root / "superpoint_graphs" / f"{entry[4]}.h5"),
                        EDGE_ATTRIBS, incl_dir_in_name=True)
        for a, b in zip(entry[:4], want[:4]):
            np.testing.assert_array_equal(a, b)
    assert (train[2][0] == -100).all() and (train[0][0] >= 0).all()
    gt, gt_size = test[0][:2]
    assert (gt == -100).all() and gt_size.shape == (len(gt), 1)
    with pytest.raises(ValueError):
        reader_j(str(root / "superpoint_graphs" / "test" / "d.h5"),
                 EDGE_ATTRIBS)


@pytest.mark.parametrize("style", ["vkitti", "custom_dataset"])
@pytest.mark.parametrize("elevation", ["simple", "plane", "given"])
def test_parsed_rows_match_jax(style, elevation):
    """build_point_matrix of both packages: vkitti 14 columns (zero lpsv),
    custom_dataset 14 (no distance column); equal with the simple or a
    given elevation, 1e-5 with the RANSAC plane (the port's numpy copy of
    sklearn's fit)."""
    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(3), 2000)
    geof = np.random.RandomState(4).rand(len(xyz), 4).astype(np.float32)
    kw = {"simple": {}, "plane": {"plane_elevation": True},
          "given": {"elevation": xyz[:, 2] * 0.5}}[elevation]
    got = parsed_t.build_point_matrix(xyz, rgb, geof, style, **kw)
    want = parsed_j.build_point_matrix(xyz, rgb, geof, style, **kw)
    assert got.shape == want.shape == (len(xyz), 14)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if elevation == "plane" else 0)
    if style == "vkitti":
        assert not got[:, 7:11].any()
    with pytest.raises(ValueError, match="style"):
        parsed_t.build_point_matrix(xyz, rgb, geof, "kitti")


@pytest.mark.parametrize("dataset", ["vkitti", "custom_dataset"])
def test_preprocess_matches_jax(trees, dataset, tmp_path):
    """preprocess_pointclouds of both packages on the port's caches: the
    same parsed/ files and class counts. The JAX package's raises on the
    custom tree's unlabelled test/d (its one-column label histogram,
    ROADMAP queue 3), so there the two are compared without it and the
    port's run on the whole tree gives the same files for the rest."""
    src = trees[dataset]["t"]
    roots = {k: tmp_path / k for k in ("t", "j", "t_all")}
    for key, root in roots.items():
        for sub in ("features", "superpoint_graphs"):
            shutil.copytree(src / sub, root / sub)
            if dataset == "custom_dataset" and key != "t_all":
                shutil.rmtree(root / sub / "test")
    if dataset == "custom_dataset":
        with pytest.raises(ValueError):
            parsed_j.preprocess_pointclouds(str(roots["t_all"]), dataset, 13)
    parsed_t.preprocess_pointclouds(str(roots["t"]), dataset, 13)
    parsed_j.preprocess_pointclouds(str(roots["j"]), dataset, 13)
    parsed_t.preprocess_pointclouds(str(roots["t_all"]), dataset, 13)
    files = [_caches(r / "parsed") for r in roots.values()]
    assert files[0] == files[1] and len(files[0]) > 2
    assert set(files[0]) <= set(files[2])
    for rel in files[0]:
        a = h5_tree(roots["t"] / "parsed" / rel)
        b = h5_tree(roots["j"] / "parsed" / rel)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel}/{k}")
            if rel.name != "class_count.h5":
                np.testing.assert_array_equal(
                    h5_tree(roots["t_all"] / "parsed" / rel)[k], a[k])


def _predictions(root, names, path, seed):
    """A predictions file (a class 0..12 a superpoint) for `names`."""
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for name in names:
            _, comps, _ = h5io_t.read_spg(
                str(root / "superpoint_graphs" / f"{name}.h5"))
            f.create_dataset(name.replace("/", "__"),
                             data=rng.randint(0, 13, len(comps)).astype(np.int32))


@pytest.mark.parametrize("dataset,name", [
    ("custom_dataset", "train/a"), ("custom_dataset", "test/d"),
    ("vkitti", "02/0001_00001")])
def test_visualize_matches_jax(trees, tmp_path, dataset, name):
    """cli/visualize of both packages, every output type (igfprse), on the
    same caches and predictions: byte-identical plys, the rgb one read
    back as the arrays given. The JAX error ply raises on test/d's
    one-column label histogram (ROADMAP queue 3): there the JAX CLI writes
    the other six, and the port's error ply holds no error."""
    root = tmp_path / "tree"
    for sub in ("features", "superpoint_graphs"):
        shutil.copytree(trees[dataset]["t"] / sub, root / sub)
    res = tmp_path / "predictions_test"
    _predictions(root, [name], str(res) + ".h5", 5)
    argv = ["--dataset", dataset, "--ROOT_PATH", str(root), "--file_path",
            name, "--res_file", str(res), "--output_type", "igfprse"]
    if name == "test/d":
        with pytest.raises(IndexError):
            visualize_j.main(argv)
        argv[-1] = "igfprs"
    visualize_j.main(argv)
    clouds = root / "clouds"
    shutil.move(clouds, tmp_path / "clouds_j")
    argv[-1] = "igfprse"
    written = visualize_t.main(argv)
    assert len(written) == 7
    made = sorted(p.name for p in clouds.rglob("*.ply"))
    want = sorted(p.name for p in (tmp_path / "clouds_j").rglob("*.ply"))
    assert made == sorted(want + (["d_err.ply"] if name == "test/d" else []))
    _, xyz, rgb, _, _ = h5io_t.read_features(
        str(root / "features" / f"{name}.h5"))
    for path in clouds.rglob("*.ply"):
        other = tmp_path / "clouds_j" / path.relative_to(clouds)
        if other.exists():
            assert path.read_bytes() == other.read_bytes(), path.name
        else:
            grey = (0.3 * rgb + 0.7 * rgb.mean(1, keepdims=True)).astype(
                np.uint8)
            np.testing.assert_array_equal(plyio.read_ply(str(path))["red"],
                                          grey[:, 0])
    back = plyio.read_ply(str(clouds / f"{name}_rgb.ply"))
    np.testing.assert_allclose(np.stack([back[k] for k in "xyz"], 1), xyz,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(back["green"], rgb[:, 1])


@pytest.fixture(scope="module")
def sema3d_tree(tmp_path_factory):
    """A Semantic3D test_reduced station of 3,000 raw points partitioned
    by the port's CLI, with a prediction a superpoint."""
    root = tmp_path_factory.mktemp("sema3d")
    (root / "data" / "test_reduced").mkdir(parents=True)
    rng = np.random.RandomState(7)
    xyz, rgb, _, _ = synthetic_room(rng, 3000)
    rows = np.hstack([xyz, rng.randint(0, 255, (3000, 1)),
                      rgb.astype(np.float64)])
    np.savetxt(root / "data" / "test_reduced" / "stationA.txt", rows,
               fmt="%.4f %.4f %.4f %d %d %d %d")
    partition_t.main(["--ROOT_PATH", str(root), "--dataset", "sema3d",
                      "--voxel_width", "0.1", "--reg_strength", "0.1",
                      "--k_nn_geof", "15", "--k_nn_adj", "5",
                      "--spg_adjacency", "knn", "--cp_backend", "exact",
                      "--ver_batch", "1200"], device="cpu")
    odir = root / "results"
    odir.mkdir()
    _predictions(root, ["test_reduced/stationA"],
                 str(odir / "predictions_testred.h5"), 8)
    return root, odir


def test_write_semantic3d_matches_jax(sema3d_tree, tmp_path):
    """cli/write_semantic3d of both packages: byte-identical .labels, a
    class 1..13 on every raw row; the array function gives the same
    labels and file."""
    root, odir = sema3d_tree
    argv = ["--SEMA3D_PATH", str(root), "--db_test_name", "testred",
            "--ver_batch", "1500"]
    write_j.main([*argv, "--odir", str(odir)])
    shutil.move(odir / "submission", tmp_path / "submission_j")
    write_t.main([*argv, "--odir", str(odir)], device="cpu")
    got = (odir / "submission" / "stationA.labels").read_bytes()
    assert got == (tmp_path / "submission_j" / "stationA.labels").read_bytes()
    labels = np.loadtxt(odir / "submission" / "stationA.labels", dtype=int)
    assert labels.shape == (3000,) and 1 <= labels.min() <= labels.max() <= 13
    graph, comps, _ = h5io_t.read_spg(
        str(root / "superpoint_graphs" / "test_reduced" / "stationA.h5"))
    _, xyz, _, _, _ = h5io_t.read_features(
        str(root / "features" / "test_reduced" / "stationA.h5"))
    with h5py.File(odir / "predictions_testred.h5", "r") as f:
        pred = f["test_reduced__stationA"][:]
    out = tmp_path / "a.labels"
    full = write_t.write_submission(
        str(out), str(root / "data" / "test_reduced" / "stationA.txt"), xyz,
        comps, pred, 1000, device="cpu")
    np.testing.assert_array_equal(full, labels)
    assert out.read_bytes() == got
    write_t.write_labels(str(tmp_path / "empty.labels"), [])
    np.savetxt(tmp_path / "np.labels", np.zeros(0, np.int64), fmt="%d")
    assert (tmp_path / "empty.labels").read_bytes() == \
        (tmp_path / "np.labels").read_bytes()


def test_output_clis_need_a_device(sema3d_tree, tmp_path):
    """write_semantic3d runs on the card unless told otherwise; visualize
    touches no tensor and runs on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, odir = sema3d_tree
    with pytest.raises(RuntimeError, match="CUDA"):
        write_t.main(["--SEMA3D_PATH", str(root), "--odir", str(odir)])
    with pytest.raises(RuntimeError, match="CUDA"):
        write_t.write_submission(str(tmp_path / "x.labels"), "scan.txt",
                                 np.zeros((1, 3)), [[0]], [0], 10)


@pytest.mark.parametrize("dataset", ["vkitti", "custom_dataset"])
def test_train_cli_runs(trees, dataset, tmp_path):
    """cli/train.py on the port's caches of each dataset (parsed/ built by
    preprocess_pointclouds; vkitti at cvfold 1, custom_dataset by its
    train/ and test/ folders), small widths: one finite epoch, the
    checkpoint and the test predictions written."""
    import json

    from superpoint_graph_tpu_torch.cli import train as train_t

    root = tmp_path / "tree"
    for sub in ("features", "superpoint_graphs"):
        shutil.copytree(trees[dataset]["t"] / sub, root / sub)
    parsed_t.preprocess_pointclouds(str(root), dataset, 13)
    odir = root / "results"
    path_flag = {"vkitti": "--VKITTI_PATH",
                 "custom_dataset": "--CUSTOM_SET_PATH"}[dataset]
    train_t.main([
        "--dataset", dataset, path_flag, str(root), "--cvfold", "1",
        "--odir", str(odir), "--epochs", "1", "--model_config", "gru_2,f_13",
        "--ptn_widths", "[[16,32],[32,16]]",
        "--ptn_widths_stn", "[[8,16],[16,8]]", "--fnet_widths", "[16,16]",
        "--ptn_minpts", "6", "--ptn_npts", "32", "--spg_augm_nneigh", "20",
        "--spg_augm_hardcutoff", "64", "--test_multisamp_n", "1"],
        device="cpu")
    log = json.loads((odir / "trainlog.json").read_text())
    assert len(log) == 1 and np.isfinite(log[0]["loss"])
    with h5py.File(odir / "predictions_test.h5", "r") as f:
        assert list(f) == (["01__0001_00000"] if dataset == "vkitti"
                           else ["test__d"])
    assert (odir / "model.ckpt").is_file()
