"""The port's Semantic3D serving path (superpoint_graph_tpu_torch/scan.py
and its reader, writer and spread) against the JAX package on the CPU: a
12,000-point synthetic scan, chunks of 5,000 raw rows, the giant path from
1,000 voxels on. Bounds as in test_torch_pipeline_big.py."""
import dataclasses

import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch import pipeline_big as big_t
from superpoint_graph_tpu_torch.learn.metrics import compute_OOA
from tests.test_torch_pipeline_big import _assert_within, _energy


@pytest.fixture(scope="module")
def scan_file(tmp_path_factory):
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan

    path = tmp_path_factory.mktemp("sema3d") / "station.txt"
    _, cls = write_semantic3d_scan(path, 12_000, seed=3)
    return str(path), cls


@pytest.mark.parametrize("n_points,seed", [(300_000, 0), (520_000, 1)])
def test_big_scene_copy_matches_jax(n_points, seed):
    """The port's big_scene_labeled and big_scene give the JAX package's
    arrays, dtype and value (one tile; two tiles and a remainder the
    generator drops)."""
    from superpoint_graph_tpu.data import synthetic as sj
    from superpoint_graph_tpu_torch.data import synthetic as st

    got = st.big_scene_labeled(n_points, seed)
    want = sj.big_scene_labeled(n_points, seed)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.big_scene(n_points, seed), want[0])


def test_write_semantic3d_scan(scan_file):
    """The written scan holds big_scene_labeled's points (to the 1e-3 m
    the text keeps) and a class 1..8 for each."""
    import pandas as pd

    from superpoint_graph_tpu_torch.data.synthetic import big_scene_labeled

    path, cls = scan_file
    rows = pd.read_csv(path, sep=" ", header=None).values
    xyz, _, _ = big_scene_labeled(12_000, seed=3)
    assert rows.shape == (len(xyz), 7)
    np.testing.assert_allclose(rows[:, :3], xyz, atol=5.01e-4)
    lab = pd.read_csv(path[:-4] + ".labels", header=None).values.ravel()
    np.testing.assert_array_equal(lab, cls)
    assert set(np.unique(cls)) <= set(range(1, 9))


@pytest.mark.parametrize("ver_batch", [5000, 0])
def test_read_semantic3d_matches_jax(scan_file, ver_batch):
    """read_semantic3d_format: the same voxels, colours and label
    histograms as the JAX reader, chunked (each chunk pruned alone) and in
    one read; and interpolate_labels_batch the same labels."""
    from superpoint_graph_tpu.data import provider as pj
    from superpoint_graph_tpu_torch.data import provider as pt

    path, _ = scan_file
    lab_path = path[:-4] + ".labels"
    got = pt.read_semantic3d_format(path, 8, lab_path, 0.1, ver_batch,
                                    device="cpu")
    want = pj.read_semantic3d_format(path, 8, lab_path, 0.1, ver_batch)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nolab = pt.read_semantic3d_format(path, 0, "", 0.1, ver_batch,
                                      device="cpu")
    np.testing.assert_array_equal(nolab[0], got[0])
    vox_lab = got[2]
    up_t = pt.interpolate_labels_batch(path, got[0], vox_lab, ver_batch or 7000,
                                       device="cpu")
    up_j = pj.interpolate_labels_batch(path, want[0], want[2],
                                       ver_batch or 7000)
    np.testing.assert_array_equal(up_t, up_j)


SCAN_MODEL = dict(ptn_widths=((16, 32), (32, 24, 16)),
                  ptn_widths_stn=((8, 16), (16, 8)), fnet_widths=(13, 16, 24),
                  fnet_llbias=False, fnet_bnidx=1)


@pytest.fixture(scope="module")
def scan_run(scan_file):
    """label_scan on the CPU at 0.1 m voxels, chunks of 5,000 raw rows,
    the giant path from 1,000 voxels on (windows of 2,000)."""
    from superpoint_graph_tpu_torch import pipeline, scan
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel

    path, _ = scan_file
    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "CHUNKED_CP_THRESHOLD", 1000)
    mp.setattr(big_t, "CHUNK_POINTS", 2000)
    model = SpgModel(8, model_config="gru_2,f_8", ptn_nfeat=11,
                     ptn_nfeat_stn=11, **SCAN_MODEL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    loader = LoaderConfig(pc_attribs="xyzrgbelpsv", ptn_npts=32,
                          ptn_minpts=10)
    cfg = dataclasses.replace(scan.SEMA3D_CONFIG, voxel_width=0.1,
                              reg_strength=0.05)
    try:
        r = scan.label_scan(path, model.eval(), "cpu", cfg=cfg,
                            ver_batch=5000, loader_cfg=loader)
    finally:
        mp.undo()
    return r, cfg, loader, model


@pytest.fixture(scope="module")
def jax_scan(scan_file, scan_run):
    """The JAX reader's voxels of the scan and the JAX partition_cloud_big
    of them at label_scan's settings: (xyz, label histograms, result)."""
    from superpoint_graph_tpu.data import provider as pj
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu.pipeline_big import partition_cloud_big as big_j

    _, cfg, _, _ = scan_run
    path, _ = scan_file
    xyz, rgb, hist = pj.read_semantic3d_format(path, 8, path[:-4] + ".labels",
                                               0.1, 5000)
    want = big_j(xyz, rgb, hist, None, 8, cfg=CJ(**dataclasses.asdict(
        dataclasses.replace(cfg, voxel_width=0.0, cp_backend="tpu"))),
        chunk_points=2000)
    return xyz, hist, want


def test_label_scan_partition_within_jax_bounds(scan_file, scan_run,
                                                jax_scan):
    """label_scan's partition (the giant path, several windows) against
    the JAX partition_cloud_big of the JAX reader's voxels, same settings:
    energy, components and OOA within BOUNDS; one class 1..8 a raw point,
    the stages timed."""
    r, cfg, _, _ = scan_run
    _, cls = scan_file
    xyz, hist, want = jax_scan
    got = r.partition
    np.testing.assert_array_equal(got.xyz, xyz)
    assert r.counts["chunks"] > 1 and r.counts["voxels"] == len(xyz)
    feats = got.geof * np.array([1, 1, 1, 2], np.float32)
    src = got.graph_nn["source"].astype(np.int64)
    tgt = got.graph_nn["target"].astype(np.int64)
    d = got.graph_nn["distances"]
    w = 1.0 / (1.0 + d / d.mean())

    def quality(p):
        return (_energy(feats, p.in_component, src, tgt, w, cfg.reg_strength),
                len(p.components), compute_OOA(p.components, hist[:, 1:]))

    _assert_within(quality(got), quality(want))
    assert r.labels.shape == cls.shape
    assert 1 <= r.labels.min() and r.labels.max() <= 8
    assert {"read_semantic3d", "partition_cloud", "superpoint_batch",
            "model", "voxel_labels", "interpolate_labels_batch"} <= set(r.times)


def test_label_scan_logits_match_flax(scan_run, jax_scan, tmp_path):
    """The JAX partition of the scan fed through the port's batch
    (`scan_batch`) and model gives the flax model's logits on the JAX
    package's own batch of it (write_parsed sema3d rows -> spg_reader ->
    load_spg_sample -> collate_spg), same bridged weights: atol/rtol 1e-4."""
    import jax

    from superpoint_graph_tpu.data import loader as lj
    from superpoint_graph_tpu.data import parsed as parsed_j
    from superpoint_graph_tpu.data.spg_io import spg_reader
    from superpoint_graph_tpu.models import SpgModel as FlaxSpgModel
    from superpoint_graph_tpu.utils.h5io import write_spg
    from superpoint_graph_tpu_torch.learn.convert_jax import flax_to_state_dict
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS
    from superpoint_graph_tpu_torch.scan import scan_batch
    from tests.test_torch_models import _randomize

    _, _, loader, _ = scan_run
    want = jax_scan[2]
    spg_path, parsed_path = str(tmp_path / "spg.h5"), str(tmp_path / "p.h5")
    write_spg(spg_path, want.graph_sp, want.components, want.in_component)
    parsed_j.write_parsed(parsed_path, parsed_j.build_point_matrix(
        want.xyz, want.rgb.astype(np.float64), want.geof, style="sema3d"),
        want.components)
    cfg_j = lj.LoaderConfig(ptn_npts=32, ptn_minpts=10,
                            pc_attribs="xyzrgbelpsv")
    sample = lj.load_spg_sample(spg_reader(spg_path, EDGE_ATTRIBS),
                                parsed_path, cfg_j, train=False)
    batch_j = lj.collate_spg([sample], cfg_j, 8, 11)
    fmodel = FlaxSpgModel(n_classes=8, model_config="gru_2,f_8", ptn_nfeat=11,
                          ptn_nfeat_stn=11, **SCAN_MODEL)
    shapes = jax.eval_shape(lambda b: fmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch_j)
    rng = np.random.RandomState(5)
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats")}
    n_sp = len(want.components)
    logits_j = np.asarray(fmodel.apply(variables, batch_j, train=False))[:n_sp]

    tmodel = SpgModel(8, model_config="gru_2,f_8", ptn_nfeat=11,
                      ptn_nfeat_stn=11, **SCAN_MODEL)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    batch_t = scan_batch(want, 8, loader, device="cpu")
    with torch.no_grad():
        logits_t = tmodel.eval()(batch_t)[:n_sp].numpy()
    np.testing.assert_allclose(logits_t, logits_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ver_batch", [5000, 0])
def test_spread_of_the_readers_chunks_equals_the_parsed_spread(scan_file,
                                                                ver_batch):
    """interpolate_labels_batch fed the reader's raw chunks gives, label for
    label, what it gives parsing the file again: same voxels, same labels,
    same chunks (three of 5,000 rows or fewer; one with ver_batch 0)."""
    from superpoint_graph_tpu_torch.data import provider as pt

    path, _ = scan_file
    raw = []
    xyz, _, hist = pt.read_semantic3d_format(path, 8, path[:-4] + ".labels",
                                             0.1, ver_batch, device="cpu",
                                             raw_xyz_out=raw)
    assert [len(c) for c in raw] == ([5000, 5000, 2000] if ver_batch
                                     else [12_000])
    assert all(c.dtype == np.float32 and c.shape[1] == 3 for c in raw)
    parsed = pt.interpolate_labels_batch(path, xyz, hist, ver_batch,
                                         device="cpu")
    reused = pt.interpolate_labels_batch(path, xyz, hist, ver_batch,
                                         device="cpu", raw_xyz=raw)
    assert reused.dtype == parsed.dtype
    np.testing.assert_array_equal(reused, parsed)


def test_label_scan_parses_the_text_once(tmp_path, monkeypatch):
    """With tracing on, a scan's raw rows are parsed once, by the reader:
    the spread opens no parse span and labels the reader's chunks
    (`spread.reused_rows`), which hold the file's float32 x y z unchanged
    by the prune that shared their memory on the CPU, and are released
    once the spread has returned."""
    import pandas as pd

    from superpoint_graph_tpu_torch import scan
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.utils import tracing

    path = tmp_path / "station.txt"
    write_semantic3d_scan(path, 3_000, seed=4)
    want = pd.read_csv(path, sep=" ", header=None).values[:, 0:3].astype(
        np.float32)
    handed = []
    spread = scan.interpolate_labels_batch

    def recorded(*args, raw_xyz, **kwargs):
        handed.append((raw_xyz, [c.copy() for c in raw_xyz]))
        return spread(*args, raw_xyz=raw_xyz, **kwargs)

    monkeypatch.setattr(scan, "interpolate_labels_batch", recorded)
    model = SpgModel(8, model_config="gru_2,f_8", ptn_nfeat=11,
                     ptn_nfeat_stn=11, **SCAN_MODEL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    cfg = dataclasses.replace(scan.SEMA3D_CONFIG, voxel_width=0.1,
                              reg_strength=0.05)
    tracing.collect()
    tracing.enable()
    try:
        r = scan.label_scan(str(path), model.eval(), "cpu", cfg=cfg,
                            ver_batch=1_000,
                            loader_cfg=LoaderConfig(pc_attribs="xyzrgbelpsv",
                                                    ptn_npts=32,
                                                    ptn_minpts=10))
    finally:
        tracing.disable()
        (root,) = tracing.collect()
    summary = tracing.summary(root)
    assert "spgt.spread.parse" not in summary["spans"]
    assert summary["spans"]["spgt.spread.nn1"]["count"] == 3
    assert summary["counters"]["parse.rows"] == len(want)
    assert summary["counters"]["spread.reused_rows"] == len(want)
    ((held, at_spread),) = handed
    assert held == []
    assert [len(c) for c in at_spread] == [1000, 1000, 1000]
    np.testing.assert_array_equal(np.concatenate(at_spread), want)
    assert r.labels.shape == (len(want),)
