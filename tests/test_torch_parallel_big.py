"""The port's sharded kNN, geof and giant-cloud partition
(superpoint_graph_tpu_torch/parallel/partition_shard.py::sharded_knn_geof,
partition_big_shard.py) on the CPU, a mesh of D shards on the "cpu"
device, against the port's single-device functions and the JAX package's
sharded ones on its virtual 8-device mesh (helpers and tolerances:
test_torch_parallel.py). The sharded kNN is exact: equal to the port's
brute force, and to the JAX one at >= 0.99 index agreement, geof within
1e-5 on >= 99% of the rows (tests/test_torch_bigcloud.py)."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
from superpoint_graph_tpu_torch.parallel import partition_big_shard as pbs
from superpoint_graph_tpu_torch.parallel import partition_shard as ps
from tests.test_torch_parallel import (CFG, assert_matches_jax, cpu_mesh,
                                       energy, knn_host)


# ---------------------------------------------------------------- kNN
def _outlier_room(n_points=6000):
    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(0),
                                    n_points=n_points)
    xyz = np.concatenate([xyz, [[40.0, 40.0, 40.0]]]).astype(np.float32)
    return xyz, np.concatenate([rgb, [[0, 0, 0]]]).astype(rgb.dtype)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_knn_geof_exact(n_shards):
    """sharded_knn_geof equal to the port's brute-force knn and
    compute_geof (indices, distances, geof), with an outlier point whose
    certificate fails, so that it reaches the exact fallback."""
    from superpoint_graph_tpu_torch.ops.geof import compute_geof
    from superpoint_graph_tpu_torch.ops.knn import knn

    xyz, _ = _outlier_room()
    g, geof, idx = ps.sharded_knn_geof(xyz, 5, 12, cpu_mesh(n_shards))
    want_i, want_d = knn(torch.from_numpy(xyz), 12)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(
        g["distances"], np.sqrt(want_d[:, :5].numpy()).reshape(-1))
    np.testing.assert_array_equal(g["target"],
                                  want_i[:, :5].reshape(-1).numpy())
    np.testing.assert_allclose(
        geof, compute_geof(torch.from_numpy(xyz), want_i).numpy(), atol=1e-5)
    st = ps.LAST_SHARD_STATS["knn"]
    assert st["n_fallback"] >= 1
    assert len(st["buffer_rows"]) == n_shards


def test_sharded_knn_slabs_hold_their_rows():
    """Each shard's slab buffer is its core rows and the halo, no more: on a
    60,000-point room over 4 shards, rows = core + halo on each inner side,
    the halo under a third of a core, every buffer under half the cloud."""
    xyz, _, _, _ = synthetic_room(np.random.RandomState(1), n_points=60000)
    ps.sharded_knn_geof(xyz, 5, 10, cpu_mesh(4))
    st = ps.LAST_SHARD_STATS["knn"]
    core, rows, halo = st["core_rows"], st["buffer_rows"], st["halo"]
    assert sum(core) == len(xyz) and 0 < halo < min(core) / 3
    starts = np.cumsum([0] + core[:-1])
    for s, (c, r) in enumerate(zip(core, rows)):
        lo, hi = starts[s], starts[s] + c
        assert r == min(len(xyz), hi + halo) - max(0, lo - halo)
        assert r < len(xyz) // 2, (s, r, halo)


def test_sharded_knn_geof_matches_jax():
    """Against the JAX sharded_knn_geof on make_mesh(8): index agreement
    >= 0.99 (neighbour sets), geof within 1e-5 on >= 99% of the rows."""
    from superpoint_graph_tpu.parallel.mesh import make_mesh
    from superpoint_graph_tpu.parallel.partition_shard import (
        sharded_knn_geof as knn_geof_j)

    xyz, _ = _outlier_room()
    _, geof_t, idx_t = ps.sharded_knn_geof(xyz, 5, 12, cpu_mesh(8))
    _, geof_j, idx_j = knn_geof_j(xyz, 5, 12, make_mesh(8))
    agree = np.mean([len(np.intersect1d(a, b)) / 12
                     for a, b in zip(idx_t, np.asarray(idx_j))])
    assert agree >= 0.99, agree
    close = (np.abs(geof_t - np.asarray(geof_j)) <= 1e-5).all(1)
    assert close.mean() >= 0.99, close.mean()


# ---------------------------------------------------------------- giant
def _chunk_inputs(n_points=6000, seed=0):
    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(seed),
                                    n_points=n_points)
    feats = np.concatenate([xyz, rgb.astype(np.float32) / 255.0],
                           1).astype(np.float32)
    idx, d2 = knn_host(xyz, 5)
    return xyz, feats, idx, d2


def test_chunked_sharded_matches_single_device():
    """chunked_cutpursuit_sharded (4 shards) against the port's
    chunked_cutpursuit_device on the same room and windows: energy at
    most x1.1 (the JAX package's bar); edges beyond the halo exist and are
    healed; no CC call capped."""
    from superpoint_graph_tpu_torch.pipeline_big import (
        chunked_cutpursuit_device)

    xyz, feats, idx, d2 = _chunk_inputs()
    comps_s, ic_s = pbs.chunked_cutpursuit_sharded(
        feats, xyz, idx, d2, 0.1, cpu_mesh(4), chunk_points=1024)
    st = dict(pbs.LAST_SHARDED_CP_STATS)
    comps_d, ic_d = chunked_cutpursuit_device(
        torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(d2),
        torch.from_numpy(xyz), 0.1, chunk_points=1024)
    src, tgt = np.repeat(np.arange(len(xyz)), 5), idx.reshape(-1)
    d0 = np.sqrt(d2).reshape(-1)
    w = 1.0 / (1.0 + d0 / d0.mean())
    assert ic_s.shape == ic_d.shape
    assert energy(feats, ic_s, src, tgt, w, 0.1) <= 1.1 * energy(
        feats, ic_d, src, tgt, w, 0.1)
    assert st["beyond_halo_edges"] > 0 and st["cc_capped"] == 0
    assert st["windows"] == -(-len(xyz) // (1024 - 2 * 128))
    assert max(st["buffer_rows"]) <= st["rounds"] * (1024 - 256) + 256


def test_chunked_sharded_heal_merges_plane():
    """A flat plane of constant features cut into windows over 8 shards
    heals into at most 3 regions (tests/test_parallel.py:283-300)."""
    rng = np.random.RandomState(0)
    n = 4000
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.rand(n) * 10
    xyz[:, 1] = rng.rand(n) * 10
    feats = np.full((n, 2), 0.5, np.float32)
    idx, d2 = knn_host(xyz, 5)
    comps, _ = pbs.chunked_cutpursuit_sharded(feats, xyz, idx, d2, 0.05,
                                              cpu_mesh(8), chunk_points=512)
    assert len(comps) <= 3, len(comps)


def test_chunked_sharded_heal_pair_weights(monkeypatch):
    """The heal's pair weights (the shards' pairs within the halo and the
    host's beyond it) equal the brute-force sums of the directed cross
    edges' weights: the two passes are disjoint and complete
    (tests/test_parallel.py::TestShardedHealAccounting)."""
    from superpoint_graph_tpu_torch.ops import components as comp_mod
    from superpoint_graph_tpu_torch.ops.cutpursuit import (
        _densify_first_occurrence)

    xyz, feats, idx, d2 = _chunk_inputs(4000, seed=0)
    captured = {}

    def spy(S, m, pa, pb, pw, n_comp, reg, **kw):
        captured.update(pa=np.asarray(pa), pb=np.asarray(pb),
                        pw=np.asarray(pw))
        return np.arange(n_comp)  # the pre-heal labels, kept

    def no_split(n_ver, s, t, ic, cutoff=0):
        dense = _densify_first_occurrence(np.asarray(ic, np.int64))
        return comp_mod.group_components(dense), dense.astype(np.int32)

    monkeypatch.setattr(pbs, "merge_rounds", spy)
    monkeypatch.setattr(pbs, "relabel_connected", no_split)
    _, ic = pbs.chunked_cutpursuit_sharded(feats, xyz, idx, d2, 0.1,
                                           cpu_mesh(8), chunk_points=512)
    assert pbs.LAST_SHARDED_CP_STATS["beyond_halo_edges"] > 0
    src, tgt = np.repeat(np.arange(len(xyz)), 5), idx.reshape(-1)
    d0 = np.sqrt(d2).reshape(-1)
    w = 1.0 / (1.0 + d0 / d0.mean())
    ca, cb = ic[src], ic[tgt]
    cross = ca != cb
    key = (np.minimum(ca, cb)[cross].astype(np.int64) * (ic.max() + 1)
           + np.maximum(ca, cb)[cross])
    uk, kinv = np.unique(key, return_inverse=True)
    want = np.zeros(len(uk))
    np.add.at(want, kinv, w[cross])
    assert len(captured["pw"]) == len(uk)
    np.testing.assert_allclose(np.sort(captured["pw"]), np.sort(want),
                               rtol=2e-4)


def test_partition_big_sharded_matches_jax():
    """partition_big_sharded on 8 shards (windows of 1,024 rows) against
    the JAX function on make_mesh(8), on the dry run's 4,000-point room
    (__graft_entry__.py:115-128): assert_matches_jax."""
    from superpoint_graph_tpu.parallel.mesh import make_mesh
    from superpoint_graph_tpu.parallel.partition_big_shard import (
        partition_big_sharded as big_j)
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig as CT

    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(1), n_points=4000)
    assert_matches_jax(
        pbs.partition_big_sharded(xyz, rgb, CT(**CFG), cpu_mesh(8),
                                  chunk_points=1024),
        big_j(xyz, rgb, CJ(**CFG), make_mesh(8), chunk_points=1024), xyz,
        rgb)
