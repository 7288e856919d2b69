"""The port's multi-rank input pipeline and training CLI
(superpoint_graph_tpu_torch/parallel/multihost.py, cli/train.py) on gloo
ranks, against the JAX package's multihost functions.

Ranks are processes running this file as their worker (`python
tests/test_torch_multihost.py mode rank world dir`), which import only the
port and meet through a `file://` rendezvous in the test's directory
(tests/test_torch_dp.py::run_ranks); a run not finished in its time is
killed and fails. The scaler's moments and np.std round differently, so
scalers are held to 1e-5 relative (the JAX package's own test), a mean
near 0 to 1e-5 of its column's scale."""
import builtins
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests.test_torch_dp import join_group, run_ranks  # noqa: E402

# tests/test_torch_cli_train.py's small tree and widths, without the
# validation split so that the two training rooms go one to each rank
ROOMS = (("Area_1", "office_1"), ("Area_1", "room_1"), ("Area_2", "room_0"))
PARTITION = ["--voxel_width", "0.07", "--reg_strength", "0.05",
             "--k_nn_geof", "20", "--k_nn_adj", "5", "--spg_adjacency", "knn"]
TRAIN = ["--dataset", "s3dis", "--cvfold", "2", "--model_config", "gru_2,f_13",
         "--ptn_widths", "[[16,32],[32,16]]",
         "--ptn_widths_stn", "[[8,16],[16,8]]", "--fnet_widths", "[16,16]",
         "--ptn_minpts", "6", "--ptn_npts", "32", "--spg_augm_nneigh", "20",
         "--spg_augm_hardcutoff", "64", "--test_multisamp_n", "2",
         "--loss_weights", "proportional", "--epochs", "2"]


def _scaler_entries(seed: int, n_graphs: int = 6):
    rng = np.random.RandomState(seed)
    return [(None, None, None, rng.randn(20, 5).astype(np.float32) * 3 + 1,
             None) for _ in range(n_graphs)]


def _no_writes_under(odir: str) -> None:
    """Make every write into odir raise (files, h5 files, directories)."""
    import h5py

    def inside(path) -> bool:
        return os.path.abspath(os.fspath(path)).startswith(
            os.path.abspath(odir))

    real_open, real_h5, real_makedirs = builtins.open, h5py.File, os.makedirs

    def guarded_open(file, mode="r", *a, **k):
        if isinstance(file, (str, os.PathLike)) and inside(file) and any(
                c in mode for c in "wax+"):
            raise PermissionError(f"rank wrote {file}")
        return real_open(file, mode, *a, **k)

    def guarded_h5(name, mode="r", *a, **k):
        if inside(name) and mode != "r":
            raise PermissionError(f"rank wrote {name}")
        return real_h5(name, mode, *a, **k)

    def guarded_makedirs(name, *a, **k):
        if inside(name):
            raise PermissionError(f"rank made {name}")
        return real_makedirs(name, *a, **k)

    builtins.open, h5py.File, os.makedirs = (guarded_open, guarded_h5,
                                             guarded_makedirs)


# ---------------------------------------------------------------- worker
def _worker(mode: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from superpoint_graph_tpu_torch.parallel import multihost

    join_group(rank, world, workdir)
    inp = torch.load(f"{workdir}/in.pt", weights_only=False)
    if mode == "scaler":
        shard = multihost.shard_files_by_process(inp["entries"])
        s = multihost.global_edge_scaler(shard)
        out = {"mean": s.mean, "scale": s.scale}
    else:  # one run of the training CLI, the trainer kept for the test
        from superpoint_graph_tpu_torch.cli import train as cli_train

        built = []
        build = cli_train.build

        def keep(*a, **k):
            built.append(build(*a, **k))
            return built[-1]

        cli_train.build = keep
        if rank:
            _no_writes_under(inp["argv"][inp["argv"].index("--odir") + 1])
        cli_train.main(inp["argv"], device="cpu")
        out = {"state": built[0][1].model.state_dict()}
    torch.save(out, f"{workdir}/out_{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------- tests
def test_shard_files_matches_jax():
    """The same slices as the JAX package's, for list lengths 0-13 and
    1-5 ranks: equal lengths a rank, every file covered."""
    from superpoint_graph_tpu.parallel import multihost as mj
    from superpoint_graph_tpu_torch.parallel import multihost as mt

    for n in range(14):
        files = [f"Area_{i % 3}/room_{i}" for i in range(n)]
        for count in range(1, 6):
            shards = [mt.shard_files_by_process(files, i, count)
                      for i in range(count)]
            assert shards == [mj.shard_files_by_process(files, i, count)
                              for i in range(count)]
            if n:
                assert {len(s) for s in shards} == {-(-n // count)}
                assert set().union(*shards) == set(files)
    assert mt.shard_files_by_process(["a", "b"]) == ["a", "b"]


def test_global_scaler_two_ranks_matches_jax(tmp_path):
    """Two gloo ranks, each fitting on its round-robin shard: both get the
    JAX package's scaler of the union (process_count=1) and the port's
    EdgeFeatScaler.fit on it."""
    from superpoint_graph_tpu.parallel.multihost import global_edge_scaler
    from superpoint_graph_tpu_torch.data.spg_io import EdgeFeatScaler

    entries = _scaler_entries(0)
    torch.save({"entries": entries}, tmp_path / "in.pt")
    outs = run_ranks(__file__, "scaler", 2, tmp_path)
    want = global_edge_scaler(entries, process_count=1)
    fit = EdgeFeatScaler().fit(entries)
    for out in outs:
        np.testing.assert_array_equal(out["mean"], outs[0]["mean"])
        np.testing.assert_array_equal(out["scale"], outs[0]["scale"])
        for ref in (want, fit):
            np.testing.assert_allclose(out["mean"], ref.mean, rtol=1e-5)
            np.testing.assert_allclose(out["scale"], ref.scale, rtol=1e-5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/test_torch_cli_train.py's small tree: raw rooms through the
    port's partition CLI and preprocess_pointclouds."""
    from superpoint_graph_tpu_torch.cli import partition as partition_t
    from superpoint_graph_tpu_torch.data import parsed as parsed_t
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room

    root = tmp_path_factory.mktemp("s3dis")
    for i, (area, room) in enumerate(ROOMS):
        write_s3dis_room(root / "data" / area / room,
                         np.random.RandomState(i), 3000)
    partition_t.main(["--ROOT_PATH", str(root), *PARTITION], device="cpu")
    parsed_t.preprocess_pointclouds(str(root), "s3dis", 13)
    return root


def test_train_cli_two_ranks(tree, tmp_path):
    """cli/train.main on two gloo ranks, one training room each, 2 epochs:
    both ranks end with the same parameters and statistics bit for bit,
    only rank 0 writes into odir (rank 1's writes there raise), and the
    checkpoint's scaler is the single-process CLI's, fitted on both
    rooms."""
    from superpoint_graph_tpu_torch.cli.train import parse_args
    from superpoint_graph_tpu_torch.data import datasets as ds
    from superpoint_graph_tpu_torch.learn.checkpoint import load_checkpoint

    odir = tmp_path / "results"
    argv = [*TRAIN, "--S3DIS_PATH", str(tree), "--odir", str(odir)]
    torch.save({"argv": argv}, tmp_path / "in.pt")
    outs = run_ranks(__file__, "train", 2, tmp_path)
    for k, v in outs[0]["state"].items():
        assert torch.equal(v, outs[1]["state"][k]), k
    assert sorted(os.listdir(odir)) == [
        "cmdline.txt", "model.ckpt", "pointwise_cm.npy", "predictions_test.h5",
        "scores_test.json", "trainlog.json"]
    state, epoch, _, scaler = load_checkpoint(str(odir / "model.ckpt"))
    assert epoch == 2
    for k, v in state["model"].items():
        assert torch.equal(v, outs[0]["state"][k]), k
    args = parse_args(argv)
    *_, single = ds.get_datasets(args.dataset, str(tree), args.edge_attribs,
                                 cvfold=args.cvfold)
    # means near 0 (the symmetric columns) by their scale
    assert (np.abs(scaler["mean"] - single.mean) <= 1e-5 * single.scale).all()
    np.testing.assert_allclose(scaler["scale"], single.scale, rtol=1e-5)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
