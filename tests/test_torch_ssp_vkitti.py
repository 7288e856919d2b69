"""The supervised partition's vKITTI3D recipe, run by the port (on the CPU)
and by the JAX package on the same tiny tree of three npy frames:
ssp_preprocess --dataset vkitti (the npy reader, the prune's label
histograms, transitions where the hard label changes, objects as the
components of constant label) and one ssp_train epoch, the port given the
JAX CLI's in-loop partitions from the JAX CLI's initial weights, as
tests/test_torch_ssp_cli.py does for S3DIS."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from superpoint_graph_tpu.cli import ssp_preprocess as preprocess_j
from superpoint_graph_tpu.cli import ssp_train as train_j
from superpoint_graph_tpu.ssp import embed as embed_j
from superpoint_graph_tpu.ssp import graph_processing as gp_j
from superpoint_graph_tpu_torch.cli import ssp_preprocess as preprocess_t
from superpoint_graph_tpu_torch.cli import ssp_train as train_t
from superpoint_graph_tpu_torch.data import provider
from superpoint_graph_tpu_torch.data.synthetic import write_vkitti_frame
from superpoint_graph_tpu_torch.ssp import graph_processing as gp_t

FRAMES = (("01", "0001_00000"), ("02", "0001_00001"), ("03", "0002_00000"))
PREPROCESS = ["--dataset", "vkitti", "--voxel_width", "0.1", "--k_nn_adj",
              "5", "--k_nn_local", "10", "--plane_model", "1"]
# the vKITTI recipe (docs/DATASETS.md:46-57) at small widths
SMALL_TRAIN = ["--dataset", "vkitti", "--cvfold", "1", "--epochs", "1",
               "--batch_size", "2", "--reg_strength", "0.5",
               "--spatial_emb", "0.2", "--ptn_widths", "[[16,32],[18,16,4]]",
               "--ptn_widths_stn", "[[8,16],[16,8]]", "--k_nn_local", "10",
               "--max_ver_train", "400", "--CP_cutoff", "5",
               "--cp_backend", "exact"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"t": port tree, "j": JAX tree} of the same frames, each
    preprocessed by its own package; "labels": each frame's raw labels."""
    base = tmp_path_factory.mktemp("ssp_vkitti")
    out = {"labels": {}}
    for i, (fold, name) in enumerate(FRAMES):
        out["labels"][name] = write_vkitti_frame(
            base / "raw" / "data" / fold / f"{name}.npy",
            np.random.RandomState(60 + i), 2500)
    for key in ("t", "j"):
        out[key] = base / key
        shutil.copytree(base / "raw" / "data", out[key] / "data")
    preprocess_t.main(["--ROOT_PATH", str(out["t"]), *PREPROCESS],
                      device="cpu")
    preprocess_j.main(["--ROOT_PATH", str(out["j"]), *PREPROCESS])
    return out


def test_reader_labels(trees):
    """read_vkitti_format gives the generator's labels + 1, the don't-care
    class 13 as 0."""
    for fold, name in FRAMES:
        _, _, labels = provider.read_vkitti_format(
            str(trees["t"] / "data" / fold / f"{name}.npy"))
        raw = trees["labels"][name]
        assert (raw == 13).any()
        np.testing.assert_array_equal(labels, np.where(raw == 13, 0, raw + 1))


def test_structures_match_jax(trees):
    """Each package reads the other's structures as its own; the pruned
    cloud, rgb, label histograms (14 columns) and objects equal; kNN
    tables and transitions >= 0.99 (the JAX kNN's near-tie misses, ROADMAP
    queue 3); elevation within 1e-5; geof within 1e-5 on >= 99% of the
    rows."""
    for fold, name in FRAMES:
        paths = {k: trees[k] / "features_supervision" / fold / f"{name}.h5"
                 for k in ("t", "j")}
        for path in paths.values():
            for a, b in zip(gp_t.read_structure(str(path)),
                            gp_j.read_structure(str(path))):
                np.testing.assert_array_equal(a, b)
        s_t = gp_t.read_structure(str(paths["t"]))
        s_j = gp_j.read_structure(str(paths["j"]))
        for i in (0, 1, 6, 7):  # xyz, rgb, labels, objects
            np.testing.assert_array_equal(s_t[i], s_j[i])
        assert s_t[6].shape[1] == 14
        for i in (3, 4, 5):  # targets, transitions, local neighbours
            assert (s_t[i] == s_j[i]).mean() >= 0.99
        assert 0 < s_t[4].mean() < 0.5
        np.testing.assert_allclose(s_t[8], s_j[8], atol=1e-5)
        geof = [gp_t.read_structure(str(p), read_geof=True)[5]
                for p in paths.values()]
        err = np.abs(geof[0] - geof[1]).max(1)
        assert (err <= 1e-5).mean() >= 0.99


@pytest.fixture(scope="module")
def trained(trees, tmp_path_factory):
    """The JAX CLI trains one epoch (cvfold 1: one step on frames 02 and
    03) recording its initial weights and the step's loss weights; the
    port's CLI resumes from those weights on a copy of the JAX structures
    twice, "t" with its own in-loop partition, "t_part" given the JAX
    step's. Returns {key: odir}, and the two steps' partitions."""
    from superpoint_graph_tpu_torch.learn.checkpoint import save_checkpoint
    from superpoint_graph_tpu_torch.learn.convert_jax import (
        convert_local_embedder, flax_to_state_dict)
    from superpoint_graph_tpu_torch.ssp.embed import SspTrainer

    base = tmp_path_factory.mktemp("ssp_vkitti_train")
    out = {"j": trees["j"] / "results"}
    states, weights_j = [], []
    orig_init, orig_weights = (embed_j.SspTrainer.init,
                               embed_j.compute_weight_loss)

    def init(self, *args, **kwargs):
        states.append(orig_init(self, *args, **kwargs))
        return states[-1]

    def weight_loss(*args, **kwargs):
        weights_j.append(orig_weights(*args, **kwargs))
        return weights_j[-1]

    embed_j.SspTrainer.init, embed_j.compute_weight_loss = init, weight_loss
    try:
        train_j.main(["--ROOT_PATH", str(trees["j"]), "--odir", str(out["j"]),
                      *SMALL_TRAIN])
    finally:
        embed_j.SspTrainer.init = orig_init
        embed_j.compute_weight_loss = orig_weights
    args = train_t.parse_args(SMALL_TRAIN)
    model_cfg, loss_cfg, _ = train_t.configs(vars(args))
    own = []
    orig_host = SspTrainer.host_weights

    def host_weights(self, emb, batch):
        own.append(orig_host(self, emb, batch)[2])
        return weights_j[len(own) - 1]

    for key in ("t", "t_part"):
        root = base / key
        shutil.copytree(trees["j"] / "features_supervision",
                        root / "features_supervision")
        fresh = SspTrainer(model_cfg, loss_cfg, device="cpu")
        fresh.model.load_state_dict(flax_to_state_dict(
            {"params": states[0]["params"],
             "batch_stats": states[0]["batch_stats"]},
            fresh.model, convert_local_embedder))
        path = str(root / "jax_weights.ckpt")
        save_checkpoint(path, fresh.state_dict(), 0, vars(args), None)
        out[key] = root / "results"
        argv = ["--ROOT_PATH", str(root), "--odir", str(out[key]),
                *SMALL_TRAIN, "--resume", path]
        if key == "t":
            train_t.main(argv, device="cpu")
            continue
        SspTrainer.host_weights = host_weights
        try:
            train_t.main(argv, device="cpu")
        finally:
            SspTrainer.host_weights = orig_host
    out["partitions"] = {"j": [w[2] for w in weights_j], "t_part": own}
    return out


def test_train_epoch_matches_jax(trained):
    """The epoch's one step from the JAX CLI's initial weights: on the JAX
    step's partition the loss within 1e-4 and the same component size; the
    port's own in-loop partition is the JAX one, so its CLI's loss is too;
    each package writes the test frame's superpoint graph."""
    logs = {k: json.loads((trained[k] / "cv1" / "trainlog.json").read_text())
            for k in ("t", "t_part", "j")}
    assert [len(v) for v in logs.values()] == [1, 1, 1]
    for k in ("t", "t_part"):
        assert logs[k][0]["epoch"] == logs["j"][0]["epoch"] == 0
        assert logs[k][0]["avg_comp_size"] == logs["j"][0]["avg_comp_size"]
        np.testing.assert_allclose(logs[k][0]["loss"], logs["j"][0]["loss"],
                                   rtol=1e-4)
    parts = trained["partitions"]
    assert len(parts["t_part"]) == len(parts["j"]) == 1
    np.testing.assert_array_equal(parts["t_part"][0], parts["j"][0])
    for key in ("t", "j"):
        root = trained[key].parent
        assert (root / "superpoint_graphs" / "01" / "0001_00000.h5").is_file()
