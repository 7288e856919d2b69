"""The port's training chain on a small synthetic S3DIS tree, on the CPU:
cli/partition -> data/parsed.preprocess_pointclouds -> cli/train ->
cli/evaluate. The caches are held to the JAX package's: its readers read
the port's files, both packages' writers give the same datasets, names and
dtypes, and both preprocess_pointclouds give the same parsed/ files."""
import os
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.cli import evaluate as evaluate_j
from superpoint_graph_tpu.data import parsed as parsed_j
from superpoint_graph_tpu.utils import h5io as h5io_j
from superpoint_graph_tpu_torch.cli import evaluate as evaluate_t
from superpoint_graph_tpu_torch.cli import partition as partition_t
from superpoint_graph_tpu_torch.cli import train as train_t
from superpoint_graph_tpu_torch.data import parsed as parsed_t
from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
from superpoint_graph_tpu_torch.utils import h5io as h5io_t

ROOMS = (("Area_1", "office_1"), ("Area_1", "room_1"), ("Area_2", "room_0"))
PARTITION = ["--voxel_width", "0.07", "--reg_strength", "0.05",
             "--k_nn_geof", "20", "--k_nn_adj", "5", "--spg_adjacency", "knn"]
# the JAX recipe's small widths (.claude/skills/verify/SKILL.md)
SMALL_TRAIN = ["--dataset", "s3dis", "--cvfold", "2",
               "--model_config", "gru_2,f_13",
               "--ptn_widths", "[[16,32],[32,16]]",
               "--ptn_widths_stn", "[[8,16],[16,8]]", "--fnet_widths", "[16,16]",
               "--ptn_minpts", "6", "--ptn_npts", "32",
               "--spg_augm_nneigh", "20", "--spg_augm_hardcutoff", "64",
               "--test_multisamp_n", "2", "--loss_weights", "proportional",
               "--use_val_set", "1"]


def h5_tree(path):
    """{dataset path: array} of every dataset in an h5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def assert_h5_equal(a, b):
    ta, tb = h5_tree(a), h5_tree(b)
    assert ta.keys() == tb.keys(), (a, b)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, (k, ta[k].dtype, tb[k].dtype)
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Raw rooms partitioned by the port's CLI and preprocessed by its
    preprocess_pointclouds."""
    root = tmp_path_factory.mktemp("s3dis")
    for i, (area, room) in enumerate(ROOMS):
        write_s3dis_room(root / "data" / area / room,
                         np.random.RandomState(i), 3000)
    partition_t.main(["--ROOT_PATH", str(root), *PARTITION], device="cpu")
    parsed_t.preprocess_pointclouds(str(root), "s3dis", 13)
    return root


def test_partition_cli_files_read_by_jax(tree):
    """Every cache the port wrote reads in the JAX package as in the port,
    and holds partition_file's result for its room."""
    for area, room in ROOMS:
        fea = str(tree / "features" / area / f"{room}.h5")
        spg = str(tree / "superpoint_graphs" / area / f"{room}.h5")
        for got, want in ((h5io_t.read_features(fea),
                           h5io_j.read_features(fea)),
                          (h5io_t.read_spg(spg), h5io_j.read_spg(spg))):
            for g, w in zip(got, want):
                if isinstance(w, dict):
                    assert g.keys() == w.keys()
                    g, w = [g[k] for k in w], [w[k] for k in w]
                for gi, wi in zip(g if isinstance(g, list) else [g],
                                  w if isinstance(w, list) else [w]):
                    np.testing.assert_array_equal(gi, wi)
    args = partition_t.parse_args(["--ROOT_PATH", str(tree), *PARTITION])
    res = partition_t.partition_file(
        str(tree / "data" / "Area_2" / "room_0" / "room_0.txt"), args, "cpu")
    graph, comps, in_comp = h5io_j.read_spg(
        str(tree / "superpoint_graphs" / "Area_2" / "room_0.h5"))
    np.testing.assert_array_equal(in_comp, res.in_component)
    assert len(comps) == len(res.components) > 5
    np.testing.assert_array_equal(graph["source"].ravel(),
                                  np.asarray(res.graph_sp["source"]).ravel())
    geof, xyz, _, _, labels = h5io_j.read_features(
        str(tree / "features" / "Area_2" / "room_0.h5"))
    np.testing.assert_array_equal(xyz, res.xyz)
    assert labels.shape == (len(xyz), 14) and labels.dtype == np.uint32


def test_partition_cli_skips_and_refuses(tree, capsys):
    """Existing caches are skipped; an unknown dataset raises (vkitti and
    custom_dataset are partitioned since their readers were ported,
    tests/test_torch_datasets_cli.py); without a card the default device
    raises."""
    partition_t.main(["--ROOT_PATH", str(tree), *PARTITION], device="cpu")
    assert capsys.readouterr().out.count("already computed") == len(ROOMS)
    with pytest.raises(ValueError, match="unknown dataset"):
        partition_t.main(["--ROOT_PATH", str(tree), "--dataset", "kitti"],
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            partition_t.main(["--ROOT_PATH", str(tree)])


@pytest.mark.parametrize("labels", ["histograms", "ids", "none"])
def test_h5_writers_equal(tmp_path, labels):
    """write_features and write_spg of both packages on the same arrays:
    equal datasets, names and dtypes."""
    rng = np.random.RandomState(1)
    n, e, n_sp = 50, 120, 6
    lab = {"histograms": rng.randint(0, 9, (n, 14)),
           "ids": rng.randint(0, 14, n), "none": None}[labels]
    graph_nn = {"source": rng.randint(0, n, e), "target": rng.randint(0, n, e),
                "distances": rng.rand(e)}
    args = (rng.rand(n, 4), rng.randn(n, 3), rng.randint(0, 255, (n, 3)),
            graph_nn, lab)
    graph_sp = {k: rng.rand(n_sp, 3) for k in h5io_t.SPG_KEYS_F32}
    graph_sp.update(sp_labels=rng.randint(0, 9, (n_sp, 14)),
                    sp_point_count=rng.randint(1, 99, n_sp),
                    source=rng.randint(0, n_sp, (9, 1)),
                    target=rng.randint(0, n_sp, (9, 1)))
    comps = np.array_split(np.arange(n), n_sp)
    in_comp = np.repeat(np.arange(n_sp), [len(c) for c in comps])
    for pkg, out in ((h5io_t, tmp_path / "t"), (h5io_j, tmp_path / "j")):
        out.mkdir()
        pkg.write_features(str(out / "f.h5"), *args)
        pkg.write_spg(str(out / "s.h5"), graph_sp, comps, in_comp)
    for name in ("f.h5", "s.h5"):
        assert_h5_equal(tmp_path / "t" / name, tmp_path / "j" / name)


def test_preprocess_matches_jax(tree, tmp_path):
    """The JAX preprocess_pointclouds on the same caches writes the same
    parsed/ files and class counts as the port's."""
    other = tmp_path / "jax"
    for sub in ("features", "superpoint_graphs"):
        shutil.copytree(tree / sub, other / sub)
    parsed_j.preprocess_pointclouds(str(other), "s3dis", 13)
    got = sorted(p.relative_to(tree / "parsed")
                 for p in (tree / "parsed").rglob("*.h5"))
    want = sorted(p.relative_to(other / "parsed")
                  for p in (other / "parsed").rglob("*.h5"))
    assert got == want and len(got) == len(ROOMS) + 1
    for rel in got:
        assert_h5_equal(tree / "parsed" / rel, other / "parsed" / rel)
    with pytest.raises(ValueError, match="style"):
        parsed_t.preprocess_pointclouds(str(tree), "kitti", 13)


@pytest.fixture(scope="module")
def trained(tree):
    """One epoch of the train CLI at small widths, then a resume to two."""
    odir = tree / "results" / "cv2"
    argv = [*SMALL_TRAIN, "--S3DIS_PATH", str(tree), "--odir", str(odir)]
    train_t.main([*argv, "--epochs", "1"], device="cpu")
    first = (odir / "trainlog.json").read_text()
    train_t.main([*argv, "--epochs", "2", "--resume", "RESUME"], device="cpu")
    return odir, first


def test_train_cli_outputs_and_resume(trained):
    """Every output of the CLI; the resumed run continues at epoch 1 from
    the checkpoint of epoch 1 and saves the checkpoint of epoch 2."""
    import json

    from superpoint_graph_tpu_torch.learn.checkpoint import load_checkpoint

    odir, first = trained
    for name in ("cmdline.txt", "trainlog.json", "model.ckpt",
                 "model_best.ckpt", "predictions_test.h5", "scores_test.json",
                 "pointwise_cm.npy"):
        assert (odir / name).is_file(), name
    assert [e["epoch"] for e in json.loads(first)] == [0]
    log = json.loads((odir / "trainlog.json").read_text())
    assert [e["epoch"] for e in log] == [0, 1]
    assert all(np.isfinite(e["loss"]) and "val_oacc" in e and "oacc" in e
               for e in log)
    _, epoch, args, scaler = load_checkpoint(str(odir / "model.ckpt"))
    assert epoch == 2 and args["model_config"] == "gru_2,f_13"
    assert scaler["mean"].shape == (13,)
    with h5py.File(odir / "predictions_test.h5", "r") as f:
        assert list(f) == ["Area_2__room_0"]
        assert f["Area_2__room_0"].dtype == np.int32
    scores = json.loads((odir / "scores_test.json").read_text())
    assert 0 <= scores["oacc"] <= 1 and len(scores["per_class_iou"]) == 13
    cm = np.load(odir / "pointwise_cm.npy")
    assert cm.shape == (13, 13) and cm.sum() > 0


def test_evaluate_cli_matches_jax(trained, capsys):
    """cli/evaluate reads the fold's confusion matrix and prints what the
    JAX CLI prints for it."""
    odir, _ = trained
    argv = ["--odir", str(odir.parent), "--cvfold", "12"]
    cm = evaluate_t.main(argv)
    got = capsys.readouterr().out
    evaluate_j.main(argv)
    assert got == capsys.readouterr().out
    assert "fold 1: missing" in got and "fold 2: OA" in got
    np.testing.assert_array_equal(cm.confusion_matrix,
                                  np.load(odir / "pointwise_cm.npy"))


def test_train_cli_needs_a_device(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_t.main([*SMALL_TRAIN, "--S3DIS_PATH", str(tree), "--odir",
                      os.fspath(Path(tree) / "results" / "nocard")])


def test_run_epoch_thread_pool(tree):
    """run_epoch with loader threads (nworkers 2) trains on every training
    cloud, as without them; the shared RandomState makes its draws depend
    on thread order, so only the counts are compared."""
    from superpoint_graph_tpu_torch.data import datasets

    args = train_t.parse_args([*SMALL_TRAIN, "--S3DIS_PATH", str(tree)])
    dbinfo = datasets.get_info("s3dis", str(tree), args.edge_attribs,
                               args.pc_attribs)
    trainlist, _, _, _ = datasets.get_datasets(
        "s3dis", str(tree), args.edge_attribs, cvfold=2)
    names = [e[4] for e in trainlist]
    rows = {}
    for n in names:
        with h5py.File(tree / "parsed" / f"{n}.h5", "r") as f:
            rows[n] = {k: f[k][:] for k in f}
    infos = []
    for nworkers in (0, 2):
        _, trainer, loader_cfg, n_ch = train_t.build(args, dbinfo, "cpu")
        loss, cm, info = train_t.run_epoch(
            trainer, trainlist, names, rows.__getitem__, loader_cfg, n_ch,
            dbinfo, True, np.random.RandomState(0), 1, nworkers=nworkers)
        assert np.isfinite(loss) and cm.confusion_matrix.sum() > 0
        infos.append(info)
    assert infos[0]["batches"] == infos[1]["batches"] == len(trainlist) == 2
