"""The Semantic3D chain of tools/torch_semantic3d_headline.py against the
JAX package's (tools/semantic3d_headline.py: `station_chunk`, then
`native.prune` per chunk and once more, then `partition_cloud_big`), on
the CPU at 300,000 raw points, with windows of 4,096 rows (the JAX chain's
2^19 cut down as the JAX tests cut it) and a 2.5 m grid so that the JAX
partition stays near half a minute here.

`station_chunk` must give the JAX tool's float32 points bit for bit, the
prunes the JAX library's voxels bit for bit, and the partition must lie
within the smoke's SCAN_BOUNDS of the JAX one (energy ratio at most 1.10
either way, OOA at most 1 point below) on the port's features and graph;
OOA on label histograms of the generator's three parts (ground, walls,
clutter).
"""
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from superpoint_graph_tpu import native as native_j
from superpoint_graph_tpu_torch import pipeline_big as big_t
from superpoint_graph_tpu_torch.data.synthetic import station_chunk

ROOT = Path(__file__).resolve().parents[1]
RAW, VER_BATCH, VOXEL = 300_000, 100_000, 2.5
K_GEOF, K_ADJ, REG, WINDOW = 12, 5, 0.8, 4096
SCAN_BOUNDS = {"energy_ratio": 1.10, "ooa_drop": 1.0}

pytestmark = pytest.mark.skipif(
    not native_j.available(), reason="the JAX package's library not built")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    """tools/semantic3d_headline.py, imported with its compile-cache
    module stubbed (it would enable a persistent XLA cache)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "bigcloud_knn", types.SimpleNamespace(
        enable_compile_cache=lambda: None))
    yield _load(ROOT / "tools" / "semantic3d_headline.py",
                "_semantic3d_headline_jax")
    mp.undo()


@pytest.fixture(scope="module")
def tool():
    return _load(ROOT / "tools" / "torch_semantic3d_headline.py",
                 "_torch_semantic3d_headline")


def test_station_chunk_matches_jax_tool(jax_tool):
    for seed, sizes in ((0, (5_000, 77_777, 1)), (3, (100_000,))):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for n in sizes:
            got, want = station_chunk(ra, n), jax_tool.station_chunk(rb, n)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def _jax_chain(cfg_kw):
    """The JAX tool's chain at the test's settings: (pruned xyz, rows after
    the chunk prunes, label histograms of the pruned voxels, result)."""
    from superpoint_graph_tpu.pipeline import PartitionConfig
    from superpoint_graph_tpu.pipeline_big import partition_cloud_big

    rs = np.random.default_rng(0)
    parts, major = [], []
    for _ in range(RAW // VER_BATCH):
        xyz_c = station_chunk(rs, VER_BATCH)
        n_g, n_w = int(VER_BATCH * 0.55), int(VER_BATCH * 0.35)
        part = np.r_[np.full(n_g, 1), np.full(n_w, 2),
                     np.full(VER_BATCH - n_g - n_w, 3)]
        xyz_p, _, hist, _ = native_j.prune(
            xyz_c, VOXEL, np.zeros((VER_BATCH, 3), np.uint8), part, None, 3,
            0)
        parts.append(xyz_p)
        major.append(hist.argmax(1))
    rows = np.concatenate(parts)
    xyz, rgb, hist, _ = native_j.prune(rows, VOXEL,
                                       np.zeros((len(rows), 3), np.uint8),
                                       np.concatenate(major), None, 3, 0)
    res = partition_cloud_big(xyz, rgb, cfg=PartitionConfig(**cfg_kw),
                              host_outputs=False, chunk_points=WINDOW)
    return xyz, rows, hist, res


@pytest.fixture(scope="module")
def chains(tool):
    mp = pytest.MonkeyPatch()
    mp.setattr(big_t, "CHUNK_POINTS", WINDOW)
    split, extra = tool.run_chain(RAW, VER_BATCH, VOXEL, K_GEOF, K_ADJ, REG,
                                  warm_repeat=True, device="cpu")
    mp.undo()
    cfg_kw = dict(voxel_width=0.0, k_nn_geof=K_GEOF, k_nn_adj=K_ADJ,
                  reg_strength=REG, spg_adjacency="knn")
    return split, extra, _jax_chain(cfg_kw)


def test_chain_prune_equals_jax(chains):
    split, extra, (xyz_j, rows_j, _, _) = chains
    np.testing.assert_array_equal(extra["rows_after_chunks"], rows_j)
    np.testing.assert_array_equal(extra["xyz"], xyz_j)
    assert split["raw_points"] == RAW and split["chunks"] == 3
    assert split["after_chunk_prune"] == len(rows_j)
    assert split["pruned_points"] == len(xyz_j)


def test_chain_partition_within_scan_bounds_of_jax(chains):
    from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                          disconnected_labels)
    from superpoint_graph_tpu_torch.ops.components import group_components
    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy
    from superpoint_graph_tpu_torch.ops.geof import compute_geof
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud
    from superpoint_graph_tpu_torch.pipeline import edge_weights

    split, extra, (_, _, hist, res_j) = chains
    cold, warm = extra["results"]
    assert split["windows"] == cold.times["cp_info"]["n_chunks"] >= 3
    assert cold.times["cp_info"]["cc_capped"] == 0
    np.testing.assert_array_equal(cold.in_component, warm.in_component)
    assert split["n_superpoints"] == len(cold.components)

    xyz = torch.from_numpy(extra["xyz"])
    n = len(xyz)
    bi, bd2, _ = knn_bigcloud(xyz, K_GEOF)
    geof = compute_geof(xyz, bi).numpy()
    feats = np.concatenate([geof * [1, 1, 1, 2], np.zeros((n, 3))], 1)
    src = np.repeat(np.arange(n), K_ADJ)
    tgt = bi[:, :K_ADJ].reshape(-1).numpy()
    w = edge_weights(np.sqrt(bd2[:, :K_ADJ].reshape(-1).numpy()), 1.0)

    def quality(ic):
        ic = np.asarray(ic, np.int64)
        return (_energy(feats, np.ones(n), ic, src, tgt, w.astype(np.float64),
                        REG)[0],
                compute_OOA(group_components(ic), hist[:, 1:]),
                disconnected_labels(ic, src, tgt))

    e_t, ooa_t, disc_t = quality(cold.in_component)
    e_j, ooa_j, _ = quality(res_j.in_component)
    assert disc_t == 0
    assert max(e_t / e_j, e_j / e_t) <= SCAN_BOUNDS["energy_ratio"]
    assert ooa_j - ooa_t <= SCAN_BOUNDS["ooa_drop"]


def test_chain_split_keys(chains):
    split, _, _ = chains
    for key in ("gen_seconds", "chunk_prune_seconds", "chunks_wall_seconds",
                "global_prune_seconds", "prune_seconds",
                "partition_seconds_cold",
                "partition_seconds_warm", "raw_mpts_per_sec_cold",
                "n_superedges", "times_cold", "times_warm"):
        assert key in split
    assert {"features", "partition", "spg", "cp_info", "knn_info"} <= set(
        split["times_cold"])
    # every second of pruning is in the rate's base: the pool's wall time
    # (all chunk prunes inside it, drawing before it) and the global prune
    assert split["prune_seconds"] == (split["chunks_wall_seconds"]
                                      + split["global_prune_seconds"])
    assert split["end_to_end_seconds_cold"] == (
        split["prune_seconds"] + split["partition_seconds_cold"])
