"""The port's whole slice against the JAX package on the CPU, and the port's
import and entry-point contracts.

A 2,500-point room written in the raw S3DIS layout goes through both
packages: read_s3dis_format -> partition_cloud(cp_backend="exact",
spg_adjacency="knn") -> superpoint batch -> SpgModel (flax weights carried
by the bridge) -> labels spread to the raw points. The default cut pursuit
(the device solver; the JAX package's "tpu") is held to the JAX one on the
same room by quality: energy, component count and OOA."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_cli import write_s3dis_room

ROOT = Path(__file__).resolve().parents[1]
SMALL_MODEL = dict(
    model_config="gru_2_0,f_13",
    ptn_widths=((16, 32), (32, 24, 16)), ptn_widths_stn=((8, 16), (16, 8)),
    ptn_nfeat_stn=11, fnet_widths=(13, 16, 24), fnet_llbias=False,
    fnet_bnidx=1,
)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3dis")
    write_s3dis_room(str(root), "Area_1", "room_0", np.random.RandomState(21))
    return str(root / "data" / "Area_1" / "room_0" / "room_0.txt")


@pytest.fixture(scope="module")
def partitions(room):
    """(port result, JAX result, raw xyz) of the same room, CLI defaults
    but the exact solver."""
    from superpoint_graph_tpu.data.provider import read_s3dis_format as rj
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu.pipeline import partition_cloud as pj
    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format as rt
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig as CT
    from superpoint_graph_tpu_torch.pipeline import partition_cloud as pt

    raw_t, raw_j = rt(room, device="cpu"), rj(room)
    got = pt(*raw_t, n_labels=13, cfg=CT(cp_backend="exact",
                                         spg_adjacency="knn"), device="cpu")
    want = pj(*raw_j, n_labels=13,
              cfg=CJ(cp_backend="exact", spg_adjacency="knn"))
    return got, want, raw_t[0]


def test_slice_partition_matches_jax(partitions):
    """Pruned cloud and labels identical; geof within atol 1e-5 wherever the
    two kNN tables hold the same neighbour set; the same components up to
    relabelling (in fact the same ids: both number them in first-occurrence
    order); identical superpoint graphs.

    The JAX kNN selects with the expanded |q|^2 + |p|^2 - 2 q.p form and
    can miss a true neighbour at a near-tie for the last place (on this
    room: one row of 2,469); the port re-ranks spare candidates exactly.
    Such rows are at most 1%, and there the port's farthest neighbour is
    no farther than the JAX one's."""
    from superpoint_graph_tpu.ops.knn import knn as knn_j
    from superpoint_graph_tpu_torch.ops.knn import knn as knn_t

    got, want, _ = partitions
    for key in ("xyz", "rgb", "labels"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    idx_t, d2_t = knn_t(torch.from_numpy(got.xyz), 45)
    idx_j, d2_j = (np.asarray(a) for a in knn_j(got.xyz, 45))
    same = np.sort(idx_t.numpy(), 1) == np.sort(idx_j, 1)
    same = same.all(1)
    assert same.mean() >= 0.99
    assert (d2_t.numpy()[~same, -1] <= d2_j[~same, -1]).all()
    np.testing.assert_allclose(got.geof[same], want.geof[same], atol=1e-5)
    assert (got.graph_nn["target"] == want.graph_nn["target"]).mean() >= 0.99
    # same partition up to relabelling: the (port, JAX) id pairs are a
    # bijection; on failure, name the voxels where they split
    pairs = np.unique(np.stack([got.in_component, want.in_component]), axis=1)
    split = [v for v in np.unique(pairs[0]) if (pairs[0] == v).sum() > 1]
    assert len(pairs[0]) == len(np.unique(pairs[0])) == len(np.unique(pairs[1])), (
        f"components differ; port components split by JAX: {split[:10]}")
    np.testing.assert_array_equal(got.in_component, want.in_component)
    assert got.graph_sp.keys() == want.graph_sp.keys()
    for key, val in want.graph_sp.items():
        np.testing.assert_array_equal(np.asarray(got.graph_sp[key]),
                                      np.asarray(val), err_msg=key)


def test_slice_logits_and_labels_match_jax(room, partitions, tmp_path):
    """label_room on the CPU vs the JAX package's chain through its h5
    files (write_spg -> spg_reader -> EdgeFeatScaler, write_parsed ->
    load_spg_sample -> collate_spg -> flax SpgModel) with the same bridged
    weights and each package's scaler fitted on the room: logits within
    atol/rtol 1e-4; spread labels identical."""
    from superpoint_graph_tpu.data import loader as lj
    from superpoint_graph_tpu.data import parsed as parsed_j
    from superpoint_graph_tpu.data.provider import interpolate_labels
    from superpoint_graph_tpu.data.spg_io import EdgeFeatScaler as ScalerJ
    from superpoint_graph_tpu.data.spg_io import spg_reader
    from superpoint_graph_tpu.models import SpgModel as FlaxSpgModel
    from superpoint_graph_tpu.utils.h5io import write_spg
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig
    from superpoint_graph_tpu_torch.data.spg_io import EdgeFeatScaler, spg_entry
    from superpoint_graph_tpu_torch.learn.convert_jax import flax_to_state_dict
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS, label_room
    from tests.test_torch_models import _randomize

    got_part, want, raw_xyz = partitions
    # JAX side, through the package's own files
    spg_path = str(tmp_path / "spg.h5")
    parsed_path = str(tmp_path / "parsed.h5")
    write_spg(spg_path, want.graph_sp, want.components, want.in_component)
    P = parsed_j.build_point_matrix(want.xyz, want.rgb.astype(np.float64),
                                    want.geof)
    parsed_j.write_parsed(parsed_path, P, want.components)
    cfg_j = lj.LoaderConfig(ptn_npts=32, ptn_minpts=10)
    entry = spg_reader(spg_path, EDGE_ATTRIBS)
    scaler_j = ScalerJ().fit([entry])
    entry = entry[:3] + (scaler_j.transform(entry[3]), entry[4])
    sample = lj.load_spg_sample(entry, parsed_path, cfg_j, train=False)
    batch_j = lj.collate_spg([sample], cfg_j, 13, 14)
    fmodel = FlaxSpgModel(n_classes=13, ptn_nfeat=14, **SMALL_MODEL)
    shapes = jax.eval_shape(lambda b: fmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch_j)
    rng = np.random.RandomState(5)
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats")}
    n_sp = len(want.components)
    logits_j = np.asarray(jax.jit(lambda v, b: fmodel.apply(v, b, train=False))(
        variables, batch_j))[:n_sp]

    # port side, in memory
    tmodel = SpgModel(13, ptn_nfeat=14, **SMALL_MODEL)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    scaler = EdgeFeatScaler().fit([spg_entry(got_part.graph_sp, EDGE_ATTRIBS)])
    np.testing.assert_array_equal(scaler.mean, scaler_j.mean)
    np.testing.assert_array_equal(scaler.scale, scaler_j.scale)
    got = label_room(room, tmodel.eval(), "cpu",
                     cfg=PartitionConfig(cp_backend="exact",
                                         spg_adjacency="knn"),
                     loader_cfg=LoaderConfig(ptn_npts=32, ptn_minpts=10),
                     scaler=scaler)
    assert got.counts["superpoints"] == n_sp
    assert got.counts["embedded_superpoints"] == int(batch_j.cloud_mask.sum())
    np.testing.assert_allclose(got.logits, logits_j, atol=1e-4, rtol=1e-4)
    pred_j = interpolate_labels(raw_xyz, want.xyz,
                                logits_j.argmax(1)[want.in_component])
    np.testing.assert_array_equal(got.labels, pred_j)


def test_loader_matches_jax(partitions, tmp_path):
    """The in-memory superpoint rows, SPG entry and collated batch equal
    the JAX package's h5 path (exact)."""
    from superpoint_graph_tpu.data import loader as lj
    from superpoint_graph_tpu.data import parsed as parsed_j
    from superpoint_graph_tpu.data.spg_io import spg_reader
    from superpoint_graph_tpu.utils.h5io import write_spg
    from superpoint_graph_tpu_torch.data import loader as lt
    from superpoint_graph_tpu_torch.data.parsed import (build_point_matrix,
                                                       parsed_entries,
                                                       write_parsed)
    from superpoint_graph_tpu_torch.data.spg_io import spg_entry
    from superpoint_graph_tpu_torch.data.spg_io import spg_reader as spg_reader_t
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS

    got, want, _ = partitions
    spg_path = str(tmp_path / "spg.h5")
    write_spg(spg_path, want.graph_sp, want.components, want.in_component)
    entry_j = spg_reader(spg_path, EDGE_ATTRIBS)
    entry_t = spg_entry(got.graph_sp, EDGE_ATTRIBS, name="spg")
    for a, b in zip(entry_t[:4] + spg_reader_t(spg_path, EDGE_ATTRIBS)[:4],
                    entry_j[:4] * 2):
        np.testing.assert_array_equal(a, b)
    P_j = parsed_j.build_point_matrix(want.xyz, want.rgb, want.geof)
    np.testing.assert_array_equal(
        build_point_matrix(want.xyz, want.rgb, want.geof), P_j)
    parsed_path = str(tmp_path / "parsed.h5")
    # the same rows (the JAX package's) through both loaders
    parsed_j.write_parsed(parsed_path, P_j, want.components, max_pts=50)
    rows = parsed_entries(P_j, want.components, max_pts=50)
    write_parsed(str(tmp_path / "parsed_t.h5"), P_j, want.components,
                 max_pts=50)
    cfg_t = lt.LoaderConfig(ptn_npts=32, ptn_minpts=10, n_sp_bucket=64)
    cfg_j = lj.LoaderConfig(ptn_npts=32, ptn_minpts=10, n_sp_bucket=64)
    s_j = lj.load_spg_sample(entry_j, parsed_path, cfg_j, train=False)
    s_t = lt.load_spg_sample(entry_j, rows, cfg_t)
    import h5py

    with h5py.File(str(tmp_path / "parsed_t.h5"), "r") as f:
        s_f = lt.load_spg_sample(entry_j, f, cfg_t)
    for key in ("clouds", "clouds_global", "cloud_flag"):
        np.testing.assert_array_equal(s_t[key], s_j[key])
        np.testing.assert_array_equal(s_f[key], s_j[key])
    b_t = lt.collate_spg([s_t], cfg_t, 13, 14, device="cpu")
    b_j = lj.collate_spg([s_j], cfg_j, 13, 14)
    for key, val in vars(b_t).items():
        ref = getattr(b_j, key)
        assert (val is None) == (ref is None), key
        if val is not None:
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref),
                                          err_msg=key)


@pytest.fixture(scope="module")
def device_partitions(room):
    """(port result with the default config, JAX result with its device
    solver "tpu") of the same room. At 2,469 voxels the JAX package feeds its
    solver from host arrays (cutpursuit_band, host Morton order); the port
    takes its one device path (device Morton order), with the same pad-row
    count (4,096 rows)."""
    from superpoint_graph_tpu.data.provider import read_s3dis_format as rj
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu.pipeline import partition_cloud as pj
    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format as rt
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig as CT
    from superpoint_graph_tpu_torch.pipeline import partition_cloud as pt

    got = pt(*rt(room, device="cpu"), n_labels=13,
             cfg=CT(spg_adjacency="knn"), device="cpu")
    want = pj(*rj(room), n_labels=13,
              cfg=CJ(cp_backend="tpu", spg_adjacency="knn"))
    return got, want


def test_slice_device_solver_matches_jax(device_partitions):
    """The default cut pursuit against the JAX package's device solver on
    the same room: energy within 3%, component count within 15%, OOA
    against the voxels' labels within 1 point, every component one
    connected piece of the kNN graph. Both energies on the JAX features and
    graph."""
    from superpoint_graph_tpu.learn.metrics import compute_OOA
    from superpoint_graph_tpu.pipeline import (PartitionConfig,
                                               assemble_partition_features,
                                               edge_weights)
    from superpoint_graph_tpu_torch.learn.metrics import disconnected_labels
    from tests.test_cutpursuit import partition_energy

    got, want = device_partitions
    np.testing.assert_array_equal(got.xyz, want.xyz)
    cfg = PartitionConfig()
    feats = assemble_partition_features(want.geof, want.rgb, cfg)
    w = edge_weights(want.graph_nn["distances"], cfg.lambda_edge_weight)
    src = want.graph_nn["source"].astype(np.int64)
    tgt = want.graph_nn["target"].astype(np.int64)
    e_t, e_j = (partition_energy(feats, r.in_component, src, tgt, w,
                                 cfg.reg_strength) for r in (got, want))
    assert abs(e_t / e_j - 1.0) <= 0.03, (e_t, e_j)
    n_t, n_j = len(got.components), len(want.components)
    assert abs(n_t / n_j - 1.0) <= 0.15, (n_t, n_j)
    ooa_t, ooa_j = (compute_OOA(r.components, r.labels[:, 1:])
                    for r in (got, want))
    assert abs(ooa_t - ooa_j) <= 1.0, (ooa_t, ooa_j)
    assert disconnected_labels(got.in_component,
                               got.graph_nn["source"].astype(np.int64),
                               got.graph_nn["target"].astype(np.int64)) == 0


def test_label_room_default_config_cpu(room, device_partitions):
    """label_room with its default config on the CPU runs the device cut
    pursuit (its solve and merge timed apart): the partition of
    device_partitions, finite logits, one label a raw point."""
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.room import label_room

    got, _ = device_partitions
    model = SpgModel(13, ptn_nfeat=14, **SMALL_MODEL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    r = label_room(room, model.eval(), "cpu",
                   loader_cfg=LoaderConfig(ptn_npts=32, ptn_minpts=10))
    np.testing.assert_array_equal(r.partition.in_component, got.in_component)
    assert r.counts["superpoints"] == len(got.components)
    assert r.logits.shape == (len(got.components), 13)
    assert np.isfinite(r.logits).all()
    assert r.labels.shape == r.raw_labels.shape
    assert {"partition_cloud.partition.solve",
            "partition_cloud.partition.merge"} <= set(r.times)


@pytest.mark.parametrize("case", ["unknown backend", "giant cloud"])
def test_partition_rejects_unported_backends(case, monkeypatch):
    """An unknown cp_backend raises ValueError; with the device solver, a
    cloud above CHUNKED_CP_THRESHOLD voxels is no longer refused: it goes
    through the chunked giant-cloud path (`pipeline_big`), whose stats
    then stand in the result's times (tests/test_torch_pipeline_big.py
    holds that path to the JAX one)."""
    from superpoint_graph_tpu_torch import pipeline
    from superpoint_graph_tpu_torch.pipeline import (PartitionConfig,
                                                     partition_cloud)

    if case == "unknown backend":
        for backend in ("tpu", "bogus"):
            with pytest.raises(ValueError, match="cp_backend"):
                partition_cloud(np.zeros((10, 3), np.float32),
                                cfg=PartitionConfig(cp_backend=backend))
        return
    monkeypatch.setattr(pipeline, "CHUNKED_CP_THRESHOLD", 500)
    xyz = np.random.RandomState(0).rand(600, 3).astype(np.float32)
    res = partition_cloud(xyz, device="cpu", cfg=PartitionConfig(
        voxel_width=0.0, k_nn_geof=10, k_nn_adj=5, spg_adjacency="knn"))
    assert res.times["cp_info"]["n"] == 600
    assert res.in_component.shape == (600,)
    assert len(res.components) == res.in_component.max() + 1


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_room_copy_matches_jax(seed):
    """The port's synthetic_room gives the JAX package's arrays, dtype and
    value, for the default room and the smoke's noisy, cluttered one."""
    from superpoint_graph_tpu.data.synthetic import synthetic_room as sj
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room as st

    for kw in ({}, dict(n_points=7000, noise=0.008, clutter_blobs=True)):
        got = st(np.random.RandomState(seed), **kw)
        want = sj(np.random.RandomState(seed), **kw)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_s3dis_labels_copy_matches_jax():
    from superpoint_graph_tpu.data import provider as pj
    from superpoint_graph_tpu_torch.data import provider as pt

    assert pt.S3DIS_LABELS == pj.S3DIS_LABELS
    for name in [*pj.S3DIS_LABELS, "unknown", ""]:
        assert pt.object_name_to_label(name) == pj.object_name_to_label(name)


def _entry_point_calls():
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig, collate_spg
    from superpoint_graph_tpu_torch.data.provider import (interpolate_labels,
                                                         read_s3dis_format)
    from superpoint_graph_tpu_torch.graph.spg import compute_sp_graph
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import cutpursuit_band
    from superpoint_graph_tpu_torch.ops.knn import compute_graph_nn_2
    from superpoint_graph_tpu_torch.ops.voxel import prune
    from superpoint_graph_tpu_torch.pipeline import (PartitionConfig,
                                                     partition_cloud,
                                                     partition_clouds,
                                                     partition_features)
    from superpoint_graph_tpu_torch.room import label_room
    from superpoint_graph_tpu_torch import pipeline_big, scan
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.graph.spg_device import (
        compute_sp_graph_device)
    from superpoint_graph_tpu_torch.cli import (partition, ssp_evaluate,
                                                ssp_generate, ssp_preprocess,
                                                ssp_train, write_semantic3d)
    from superpoint_graph_tpu_torch.ssp import graph_processing as gp
    from superpoint_graph_tpu_torch.ssp.embed import SspModelConfig, SspTrainer
    from superpoint_graph_tpu_torch.ssp.losses import (SspLossConfig,
                                                       compute_partition)
    from superpoint_graph_tpu_torch.parallel import (multihost,
                                                     partition_big_shard,
                                                     partition_shard)
    from superpoint_graph_tpu_torch.parallel.mesh import make_mesh
    from superpoint_graph_tpu_torch.ops.cutpursuit_dense import (
        cutpursuit_dense)

    spec = importlib.util.spec_from_file_location(
        "headline", ROOT / "tools" / "torch_semantic3d_headline.py")
    headline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(headline)
    xyz = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    edges = np.arange(49), np.arange(1, 50)
    return {
        "read_s3dis_format": lambda: read_s3dis_format("room.txt"),
        "interpolate_labels": lambda: interpolate_labels(xyz, xyz,
                                                         np.zeros(50, int)),
        "prune": lambda: prune(xyz, 0.1, np.zeros((50, 3), np.uint8), None,
                               None, 0, 0),
        "compute_graph_nn_2": lambda: compute_graph_nn_2(xyz, 2, 4),
        "compute_sp_graph": lambda: compute_sp_graph(
            xyz, 0.0, np.zeros(50, int), None, 0, adjacency="knn"),
        "partition_features": lambda: partition_features(xyz,
                                                         PartitionConfig()),
        "partition_cloud": lambda: partition_cloud(xyz),
        "partition_clouds": lambda: partition_clouds([(xyz, None, None,
                                                       None)]),
        "cutpursuit_band": lambda: cutpursuit_band(xyz, *edges,
                                                   np.ones(49), 0.1),
        "collate_spg": lambda: collate_spg([], LoaderConfig(), 13, 14),
        "label_room": lambda: label_room("room.txt", None),
        "read_semantic3d_format": lambda: provider.read_semantic3d_format(
            "scan.txt", 8, "scan.labels", 0.05, 1000),
        "interpolate_labels_batch": lambda: provider.interpolate_labels_batch(
            "scan.txt", xyz, np.zeros(50, int), 1000),
        "compute_sp_graph_device": lambda: compute_sp_graph_device(
            xyz, 0.0, np.zeros(50, int), None, 0, np.zeros((50, 2), int)),
        "partition_cloud_big": lambda: pipeline_big.partition_cloud_big(xyz),
        "chunked_cutpursuit": lambda: pipeline_big.chunked_cutpursuit(
            xyz, xyz, *edges, np.ones(49), 0.1),
        "scan_batch": lambda: scan.scan_batch(None, 8),
        "label_scan": lambda: scan.label_scan("scan.txt", None),
        "build_supervision_structure": lambda: gp.build_supervision_structure(
            xyz, np.zeros((50, 3)), np.zeros(50, int), np.ones(50, int),
            gp.SspPreprocessConfig(), 13),
        "preprocess_file": lambda: ssp_preprocess.preprocess_file(
            "room.txt", ssp_preprocess.parse_args([])),
        "SspTrainer": lambda: SspTrainer(SspModelConfig(), SspLossConfig()),
        "compute_partition": lambda: compute_partition(
            SspLossConfig(cp_backend="device"), xyz, *edges, np.ones(49)),
        "ssp_preprocess.main": lambda: ssp_preprocess.main([]),
        "ssp_train.main": lambda: ssp_train.main([]),
        "ssp_generate.main": lambda: ssp_generate.main([]),
        "ssp_evaluate.main": lambda: ssp_evaluate.main([]),
        "partition_file[vkitti]": lambda: partition.partition_file(
            "frame.npy", partition.parse_args(["--dataset", "vkitti"])),
        "partition_file[custom_dataset]": lambda: partition.partition_file(
            "cloud.ply", partition.parse_args(["--dataset",
                                               "custom_dataset"])),
        "preprocess_file[vkitti]": lambda: ssp_preprocess.preprocess_file(
            "frame.npy", ssp_preprocess.parse_args(["--dataset", "vkitti"])),
        "write_submission": lambda: write_semantic3d.write_submission(
            "scan.labels", "scan.txt", xyz, [np.arange(50)], [0], 1000),
        "write_semantic3d.main": lambda: write_semantic3d.main([]),
        "make_mesh": make_mesh,
        "partition_cloud_sharded": lambda: (
            partition_shard.partition_cloud_sharded(xyz, None,
                                                    PartitionConfig())),
        "partition_big_sharded": lambda: (
            partition_big_shard.partition_big_sharded(xyz, None,
                                                      PartitionConfig())),
        "sharded_knn_geof": lambda: partition_shard.sharded_knn_geof(xyz, 2,
                                                                     4),
        "multihost.initialize": lambda: multihost.initialize(
            "tcp://127.0.0.1:1", 1, 0),
        "cutpursuit_dense": lambda: cutpursuit_dense(
            xyz, *edges, np.ones(49), 0.1),
        "run_chain": lambda: headline.run_chain(1_000, 500, 0.5),
    }


@pytest.mark.parametrize("name", [
    "read_s3dis_format", "interpolate_labels", "prune", "compute_graph_nn_2",
    "compute_sp_graph", "partition_features", "partition_cloud",
    "partition_clouds", "cutpursuit_band", "collate_spg", "label_room",
    "read_semantic3d_format", "interpolate_labels_batch",
    "compute_sp_graph_device", "partition_cloud_big", "chunked_cutpursuit",
    "scan_batch", "label_scan", "build_supervision_structure",
    "preprocess_file", "SspTrainer", "compute_partition",
    "ssp_preprocess.main", "ssp_train.main", "ssp_generate.main",
    "ssp_evaluate.main", "partition_file[vkitti]",
    "partition_file[custom_dataset]", "preprocess_file[vkitti]",
    "write_submission", "write_semantic3d.main", "make_mesh",
    "partition_cloud_sharded", "partition_big_sharded", "sharded_knn_geof",
    "multihost.initialize", "cutpursuit_dense", "run_chain"])
def test_entry_points_default_to_card(name):
    """Called without `device`, every entry point asks for the card, and
    raises where there is none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_point_calls()[name]()


def test_port_imports_no_jax():
    """Every module of the port (cli/, ssp/ and the readers and ply
    writers included), chip_smoke.py, tools/torch_semantic3d_headline.py
    and tools/torch_knn_time.py import without jax, flax, h5py, pandas, sklearn, laspy or any module of
    the JAX package (a fresh interpreter), and the host library the port
    loads is its own build, not the JAX package's native/ one."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import superpoint_graph_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "assert {'superpoint_graph_tpu_torch.ops.cutpursuit_band',\n"
        "        'superpoint_graph_tpu_torch.ops.merge_device',\n"
        "        'superpoint_graph_tpu_torch.graph.spg_device',\n"
        "        'superpoint_graph_tpu_torch.pipeline_big',\n"
        "        'superpoint_graph_tpu_torch.scan',\n"
        "        'superpoint_graph_tpu_torch.learn.train',\n"
        "        'superpoint_graph_tpu_torch.learn.train_check',\n"
        "        'superpoint_graph_tpu_torch.learn.checkpoint',\n"
        "        'superpoint_graph_tpu_torch.data.datasets',\n"
        "        'superpoint_graph_tpu_torch.utils.h5io',\n"
        "        'superpoint_graph_tpu_torch.cli.partition',\n"
        "        'superpoint_graph_tpu_torch.cli.train',\n"
        "        'superpoint_graph_tpu_torch.cli.evaluate',\n"
        "        'superpoint_graph_tpu_torch.ssp.graph_processing',\n"
        "        'superpoint_graph_tpu_torch.ssp.losses',\n"
        "        'superpoint_graph_tpu_torch.ssp.embed',\n"
        "        'superpoint_graph_tpu_torch.ssp.evaluate',\n"
        "        'superpoint_graph_tpu_torch.utils.ransac',\n"
        "        'superpoint_graph_tpu_torch.ops.subgraph',\n"
        "        'superpoint_graph_tpu_torch.cli.ssp_preprocess',\n"
        "        'superpoint_graph_tpu_torch.cli.ssp_train',\n"
        "        'superpoint_graph_tpu_torch.cli.ssp_generate',\n"
        "        'superpoint_graph_tpu_torch.cli.ssp_evaluate',\n"
        "        'superpoint_graph_tpu_torch.cli.visualize',\n"
        "        'superpoint_graph_tpu_torch.cli.write_semantic3d',\n"
        "        'superpoint_graph_tpu_torch.utils.plyio',\n"
        "        'superpoint_graph_tpu_torch.data.provider',\n"
        "        'superpoint_graph_tpu_torch.data.synthetic',\n"
        "        'superpoint_graph_tpu_torch.parallel.mesh',\n"
        "        'superpoint_graph_tpu_torch.parallel.multihost',\n"
        "        'superpoint_graph_tpu_torch.parallel.dp',\n"
        "        'superpoint_graph_tpu_torch.parallel.partition_shard',\n"
        "        'superpoint_graph_tpu_torch.parallel.partition_big_shard',\n"
        "        'superpoint_graph_tpu_torch.native',\n"
        "        'superpoint_graph_tpu_torch.models.pool',\n"
        "        'superpoint_graph_tpu_torch.utils.tracing',\n"
        "        'superpoint_graph_tpu_torch.ops.cutpursuit_dense'}"
        " <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for mod, path in (('chip_smoke', 'chip_smoke.py'),\n"
        "                  ('headline', 'tools/torch_semantic3d_headline.py'),\n"
        "                  ('knn_time', 'tools/torch_knn_time.py')):\n"
        "    spec = importlib.util.spec_from_file_location(mod, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import superpoint_graph_tpu_torch.native as nat\n"
        "nat.greedy_matching([0], [1], 2)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'spgt_native' in maps and '/native/libspgt_native' not in "
        "maps\n"
        "bad = [m for m in ('jax', 'flax', 'h5py', 'pandas', 'sklearn',\n"
        "                   'laspy')\n"
        "       if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m == 'superpoint_graph_tpu'\n"
        "        or m.startswith('superpoint_graph_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(list(pkgutil.walk_packages(p.__path__))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and when it stands alone outside a checkout."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [_run_smoke(tmp_path, alone)]
    if not torch.cuda.is_available():
        runs.append(_run_smoke(ROOT, ROOT / "chip_smoke.py"))
    for res in runs:
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
