"""The supervised partition's CLI chain, ssp_preprocess -> ssp_train ->
ssp_generate -> ssp_evaluate, run by the port (on the CPU) and by the JAX
package on the same tiny S3DIS tree: each package reads the other's
structures and superpoint graphs. From the JAX CLI's weights (carried
into port checkpoints that the port's CLI resumes from) the first
training step's loss agrees within 1e-4, both epochs' losses do when the
port is given the JAX CLI's in-loop partitions, and the final
evaluation, the res.h5 matrices and the generated partitions are
equal."""
from __future__ import annotations

import json
import shutil

import h5py
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.cli import ssp_evaluate as evaluate_j
from superpoint_graph_tpu.cli import ssp_generate as generate_j
from superpoint_graph_tpu.cli import ssp_preprocess as preprocess_j
from superpoint_graph_tpu.cli import ssp_train as train_j
from superpoint_graph_tpu.ssp import embed as embed_j
from superpoint_graph_tpu.ssp import graph_processing as gp_j
from superpoint_graph_tpu.utils import h5io as h5io_j
from superpoint_graph_tpu_torch.cli import ssp_evaluate as evaluate_t
from superpoint_graph_tpu_torch.cli import ssp_generate as generate_t
from superpoint_graph_tpu_torch.cli import ssp_preprocess as preprocess_t
from superpoint_graph_tpu_torch.cli import ssp_train as train_t
from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
from superpoint_graph_tpu_torch.ssp import graph_processing as gp_t
from superpoint_graph_tpu_torch.utils import h5io as h5io_t

ROOMS = (("Area_1", "room_0"), ("Area_2", "room_0"), ("Area_2", "room_1"))
PREPROCESS = ["--voxel_width", "0.08", "--k_nn_adj", "5", "--k_nn_local",
              "10", "--plane_model", "1"]
SMALL_TRAIN = ["--dataset", "s3dis", "--cvfold", "1", "--epochs", "2",
               "--batch_size", "2", "--ptn_widths", "[[16,32],[18,16,4]]",
               "--ptn_widths_stn", "[[8,16],[16,8]]", "--k_nn_local", "10",
               "--max_ver_train", "400", "--CP_cutoff", "5",
               "--cp_backend", "exact"]


def h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"t": port tree, "j": JAX tree}: the same raw rooms, each
    preprocessed by its own package."""
    base = tmp_path_factory.mktemp("ssp_cli")
    raw = base / "raw"
    for i, (area, room) in enumerate(ROOMS):
        write_s3dis_room(raw / "data" / area / room,
                         np.random.RandomState(30 + i), 2500)
    out = {}
    for key in ("t", "j"):
        out[key] = base / key
        shutil.copytree(raw / "data", out[key] / "data")
    preprocess_t.main(["--ROOT_PATH", str(out["t"]), *PREPROCESS],
                      device="cpu")
    preprocess_j.main(["--ROOT_PATH", str(out["j"]), *PREPROCESS])
    return out


def assert_spg_equal(a, b):
    """Two read_spg results (graph, components, in_component) equal."""
    assert a[0].keys() == b[0].keys()
    for k in b[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[2], b[2])


def _structures(root):
    return sorted((root / "features_supervision").rglob("*.h5"))


def test_preprocess_structures_cross_read(trees):
    """Every structure of either package reads the same in both packages;
    the two packages' structures agree (pruned cloud, objects, labels and
    rgb equal, kNN tables and transitions >= 0.99, elevation 1e-5)."""
    files = {k: _structures(trees[k]) for k in trees}
    assert [p.relative_to(trees["t"]) for p in files["t"]] == \
        [p.relative_to(trees["j"]) for p in files["j"]]
    assert len(files["t"]) == len(ROOMS)
    for f_t, f_j in zip(files["t"], files["j"]):
        for path in (f_t, f_j):
            for a, b in zip(gp_t.read_structure(str(path)),
                            gp_j.read_structure(str(path))):
                np.testing.assert_array_equal(a, b)
        s_t, s_j = gp_t.read_structure(str(f_t)), gp_j.read_structure(str(f_j))
        for i in (0, 1, 6, 7):  # xyz, rgb, labels, objects
            np.testing.assert_array_equal(s_t[i], s_j[i])
        for i in (3, 4, 5):  # targets, transitions, local neighbours
            assert (s_t[i] == s_j[i]).mean() >= 0.99
        np.testing.assert_allclose(s_t[8], s_j[8], atol=1e-5)
        assert set(h5_tree(f_t)) == set(h5_tree(f_j))


def test_preprocess_skips_and_refuses(trees, capsys):
    """Existing structures are skipped; an unknown dataset raises (vkitti
    is preprocessed since its reader was ported,
    tests/test_torch_ssp_vkitti.py)."""
    preprocess_t.main(["--ROOT_PATH", str(trees["t"]), *PREPROCESS],
                      device="cpu")
    assert capsys.readouterr().out.count("already computed") == len(ROOMS)
    with pytest.raises(ValueError, match="unknown dataset"):
        preprocess_t.main(["--ROOT_PATH", str(trees["t"]), "--dataset",
                           "kitti"], device="cpu")


@pytest.fixture(scope="module")
def trained(trees, tmp_path_factory):
    """The JAX CLI trained 2 epochs on its structures; the port's CLI on a
    copy of them three times: "t" resumes from the JAX CLI's initial
    weights and trains 2 epochs; "t_part" does the same with each step's
    in-loop partition and loss weights those of the JAX CLI's step (its
    own partition recorded beside them); "t_final" resumes from the JAX
    CLI's final weights at epoch 2 (so it trains no step) and runs the
    final evaluation. The JAX weights are recorded as the JAX CLI makes
    and saves them, carried by the bridge into port checkpoints. Returns
    {key: (root, odir)} and, under "partitions", {"j": the JAX steps'
    in_component, "t_part": the port's own in "t_part"}."""
    import superpoint_graph_tpu.learn.checkpoint as ckpt_j
    from superpoint_graph_tpu_torch.learn.checkpoint import save_checkpoint
    from superpoint_graph_tpu_torch.learn.convert_jax import (
        convert_local_embedder, flax_to_state_dict)
    from superpoint_graph_tpu_torch.ssp.embed import SspTrainer

    base = tmp_path_factory.mktemp("ssp_train")
    out = {"j": (trees["j"], trees["j"] / "results")}
    for key in ("t", "t_part", "t_final"):
        out[key] = (base / key, base / key / "results")
        shutil.copytree(trees["j"] / "features_supervision",
                        out[key][0] / "features_supervision")
    states, weights_j = [], []
    orig_init, orig_save = embed_j.SspTrainer.init, ckpt_j.save_checkpoint
    orig_weights = embed_j.compute_weight_loss

    def init(self, *args, **kwargs):
        states.append(orig_init(self, *args, **kwargs))
        return states[-1]

    def save(path, state, *args, **kwargs):
        states.append(state)
        return orig_save(path, state, *args, **kwargs)

    def weight_loss(*args, **kwargs):
        weights_j.append(orig_weights(*args, **kwargs))
        return weights_j[-1]

    embed_j.SspTrainer.init, ckpt_j.save_checkpoint = init, save
    embed_j.compute_weight_loss = weight_loss
    try:
        train_j.main(["--ROOT_PATH", str(out["j"][0]), "--odir",
                      str(out["j"][1]), *SMALL_TRAIN])
    finally:
        embed_j.SspTrainer.init, ckpt_j.save_checkpoint = orig_init, orig_save
        embed_j.compute_weight_loss = orig_weights
    args = train_t.parse_args(SMALL_TRAIN)
    model_cfg, loss_cfg, _ = train_t.configs(vars(args))
    own = []
    orig_host = SspTrainer.host_weights

    def host_weights(self, emb, batch):
        own.append(orig_host(self, emb, batch)[2])
        return weights_j[len(own) - 1]

    for key, state, epoch in (("t", states[0], 0), ("t_part", states[0], 0),
                              ("t_final", states[1], 2)):
        fresh = SspTrainer(model_cfg, loss_cfg, device="cpu")
        fresh.model.load_state_dict(flax_to_state_dict(
            {"params": state["params"], "batch_stats": state["batch_stats"]},
            fresh.model, convert_local_embedder))
        path = str(out[key][0] / "jax_weights.ckpt")
        save_checkpoint(path, fresh.state_dict(), epoch, vars(args), None)
        argv = ["--ROOT_PATH", str(out[key][0]), "--odir", str(out[key][1]),
                *SMALL_TRAIN, "--resume", path]
        if key != "t_part":
            train_t.main(argv, device="cpu")
            continue
        SspTrainer.host_weights = host_weights
        try:
            train_t.main(argv, device="cpu")
        finally:
            SspTrainer.host_weights = orig_host
    out["partitions"] = {"j": [w[2] for w in weights_j], "t_part": own}
    return out


def test_train_cli_first_step_matches_jax(trained):
    """From the same weights on the same batch (the epoch's one step): the
    same in-loop partition (component size) and the loss within 1e-4.
    The second epoch's loss is held in the next test, on the JAX CLI's
    partition: Adam's first step lr g / (|g| + 1e-8) turns the rounding
    noise of gradients that are zero by construction into steps of up to
    lr either way (tests/test_torch_ssp.py::test_train_step_matches_jax),
    some of those weights stop being inert at the next step, and the
    embeddings that move by a few 1e-3 flip the in-loop partition of a
    few edges (ROADMAP queue 3)."""
    logs = {k: json.loads((trained[k][1] / "cv1" / "trainlog.json")
                          .read_text()) for k in ("t", "j")}
    assert [e["epoch"] for e in logs["t"]] == [e["epoch"] for e in logs["j"]]
    assert len(logs["t"]) == 2
    np.testing.assert_allclose(logs["t"][0]["loss"], logs["j"][0]["loss"],
                               rtol=1e-4)
    assert logs["t"][0]["avg_comp_size"] == logs["j"][0]["avg_comp_size"]
    assert all(np.isfinite(e["loss"]) for e in logs["t"])
    for k in ("t", "t_final"):
        assert (trained[k][1] / "cv1" / "model.ckpt").is_file()
        assert (trained[k][1] / "cv1" / "cmdline.txt").is_file()


def test_train_cli_epochs_match_jax_on_its_partitions(trained):
    """The port's CLI given each step's in-loop partition and loss weights
    of the JAX CLI's step: both epochs' trainlog losses within 1e-4 (the
    second epoch's parts by 9.1e-5 here: the weights Adam moved by noise,
    above). Its own partition is the JAX CLI's in the first step."""
    logs = {k: json.loads((trained[k][1] / "cv1" / "trainlog.json")
                          .read_text()) for k in ("t_part", "j")}
    assert len(logs["t_part"]) == len(logs["j"]) == 2
    for got, want in zip(logs["t_part"], logs["j"]):
        assert got["epoch"] == want["epoch"]
        assert got["avg_comp_size"] == want["avg_comp_size"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    parts = trained["partitions"]
    assert len(parts["t_part"]) == len(parts["j"]) == 2
    np.testing.assert_array_equal(parts["t_part"][0], parts["j"][0])


def test_train_cli_evaluation_matches_jax(trained):
    """The port's CLI resumed at the JAX CLI's final weights: res.h5 equal
    to the JAX CLI's (datasets, values, dtypes) and aggregated alike by
    both packages, and the test room's superpoint graph equal to the JAX
    one, each readable by both packages."""
    res = {k: h5_tree(trained[k][1] / "cv1" / "res.h5")
           for k in ("t_final", "j")}
    assert res["t_final"].keys() == res["j"].keys()
    for k in res["j"]:
        np.testing.assert_array_equal(res["t_final"][k], res["j"][k],
                                      err_msg=k)
        assert res["t_final"][k].dtype == res["j"][k].dtype
    from superpoint_graph_tpu.ssp.evaluate import aggregate_results as agg_j
    from superpoint_graph_tpu_torch.ssp.evaluate import (
        aggregate_results as agg_t)

    paths = [str(trained[k][1] / "cv1" / "res.h5") for k in ("t_final", "j")]
    assert agg_t(paths) == agg_j(paths)
    spg = {k: trained[k][0] / "superpoint_graphs" / "Area_1" / "room_0.h5"
           for k in ("t_final", "j")}
    for path in spg.values():
        assert_spg_equal(h5io_t.read_spg(str(path)),
                         h5io_j.read_spg(str(path)))
    assert_spg_equal(h5io_t.read_spg(str(spg["t_final"])),
                     h5io_j.read_spg(str(spg["j"])))


def test_generate_and_evaluate_cli_match_jax(trained, capsys):
    """ssp_generate (model args from each package's checkpoint, the same
    weights) writes the same superpoint graph of every room in both
    packages, each readable by the other; ssp_evaluate prints the same
    table."""
    for k, gen in (("t_final", generate_t), ("j", generate_j)):
        root, odir = trained[k]
        argv = ["--ROOT_PATH", str(root), "--model_path",
                str(odir / "cv1" / "model.ckpt"), "--overwrite", "1",
                "--cp_backend", "exact"]
        gen.main(argv, device="cpu") if k != "j" else gen.main(argv)
    out = capsys.readouterr().out
    assert out.count("superpoints") == 2 * len(ROOMS)
    for area, room in ROOMS:
        paths = [trained[k][0] / "superpoint_graphs" / area / f"{room}.h5"
                 for k in ("t_final", "j")]
        want = h5io_j.read_spg(str(paths[1]))
        assert_spg_equal(h5io_j.read_spg(str(paths[0])), want)
        assert_spg_equal(h5io_t.read_spg(str(paths[1])), want)
    tables = []
    for k, ev in (("t_final", evaluate_t), ("j", evaluate_j)):
        odir = trained[k][1]
        argv = ["--odir", str(odir), "--cvfold", "12"]
        ev.main(argv, device="cpu") if k != "j" else ev.main(argv)
        tables.append(capsys.readouterr().out.replace(str(odir), "ODIR"))
        assert (odir / "results.txt").is_file()
    assert tables[0] == tables[1]
    assert "fold 2: missing" in tables[0] and "overall" in tables[0]


def test_geof_passthrough_matches_jax(trained):
    """--ver_value geof: the handcrafted features are the embeddings (no
    training); res.h5 equal to the JAX CLI's."""
    argv = ["--dataset", "s3dis", "--cvfold", "1", "--ver_value", "geof",
            "--CP_cutoff", "5", "--reg_strength", "0.1", "--spatial_emb", "0",
            "--cp_backend", "exact", "--spg_out", "0"]
    res = {}
    for k, cli in (("t", train_t), ("j", train_j)):
        root, odir = trained[k]
        full = ["--ROOT_PATH", str(root), "--odir", str(odir / "geof"), *argv]
        cli.main(full, device="cpu") if k == "t" else cli.main(full)
        res[k] = h5_tree(odir / "geof" / "cv1" / "res.h5")
    for k in res["j"]:
        np.testing.assert_array_equal(res["t"][k], res["j"][k], err_msg=k)


def test_dead_flags_and_cutoff_rule_match_jax():
    """The flags parse as the JAX CLI's (the adaptive CP_cutoff rule;
    --lr_decay, --lr_steps, --test_nth_epoch and --nworkers parsed and
    never used, as there); the port maps --cp_backend tpu to its device
    solver."""
    for argv in ([], ["--CP_cutoff", "-20", "--reg_strength", "0.3"],
                 ["--CP_cutoff", "-20", "--reg_strength", "0.8"]):
        got, want = vars(train_t.parse_args(argv)), vars(train_j.parse_args(argv))
        assert got == want
    args = vars(train_t.parse_args(["--lr_steps", "[1]", "--lr_decay", "0.1"]))
    _, loss_cfg, _ = train_t.configs(args)
    assert loss_cfg.cp_backend == "device"


def test_ssp_clis_need_a_device(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, odir = trained["t"]
    for call in (
            lambda: preprocess_t.main(["--ROOT_PATH", str(root)]),
            lambda: train_t.main(["--ROOT_PATH", str(root), "--odir",
                                  str(odir / "nocard")]),
            lambda: generate_t.main(["--ROOT_PATH", str(root), "--model_path",
                                     str(odir / "cv1" / "model.ckpt")]),
            lambda: evaluate_t.main(["--odir", str(odir)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
