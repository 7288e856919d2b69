"""The port's `pipeline_big.partition_cloud_big` and the dispatch to it
from `pipeline.partition_cloud` / `partition_clouds`, against the JAX
package's partition_cloud_big on the CPU, at 5,000 points with the windows
and geof launches lowered as the JAX tests lower them. Bounds as in
test_torch_pipeline_big.py."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch import pipeline_big as big_t
from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                      disconnected_labels)
from tests.test_torch_pipeline_big import _assert_within, _energy


@pytest.fixture(scope="module")
def small_chunks():
    """Windows of 2,000 rows and geof launches of 1,500 (the JAX test's
    settings), for the module's partition_cloud_big runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(big_t, "CHUNK_POINTS", 2000)
    mp.setattr(big_t, "GEOF_CHUNK", 1500)
    yield
    mp.undo()


BIG_CFG = dict(voxel_width=0.0, k_nn_geof=12, k_nn_adj=5, reg_strength=0.1,
               spg_adjacency="knn")


@pytest.fixture(scope="module")
def big_results(small_chunks):
    """partition_cloud_big of both packages on a 5,000-point room."""
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu.pipeline_big import partition_cloud_big as pj
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig as CT

    xyz, rgb, labels, objects = synthetic_room(np.random.RandomState(7),
                                               n_points=5000)
    got = big_t.partition_cloud_big(xyz, rgb, labels, objects, n_labels=13,
                                    cfg=CT(**BIG_CFG), device="cpu")
    want = pj(xyz, rgb, labels, objects, n_labels=13, cfg=CJ(**BIG_CFG),
              chunk_points=2000, geof_chunk=1500)
    return got, want, labels, (xyz, rgb, labels, objects)


def test_partition_cloud_big_matches_jax(big_results):
    """The result contract of partition_cloud_big (shapes, the times'
    keys, the graph_nn of the kNN), geof equal to the unchunked op on the
    same kNN (1e-5), and the partition within BOUNDS of the JAX one."""
    from superpoint_graph_tpu_torch.ops.geof import compute_geof
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud

    got, want, labels, _ = big_results
    n = len(got.xyz)
    assert got.in_component.shape == (n,) and got.geof.shape == (n, 4)
    assert len(got.components) == got.in_component.max() + 1
    assert got.graph_sp["sp_centroids"].shape[0] == len(got.components)
    assert got.graph_sp.keys() == want.graph_sp.keys()
    assert {"features", "features_info", "partition", "cp_info", "spg",
            "knn_info"} <= set(got.times)
    xyz_t = torch.from_numpy(got.xyz)
    bi, _, _ = knn_bigcloud(xyz_t, 12)
    np.testing.assert_allclose(got.geof, compute_geof(xyz_t, bi).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.graph_nn["target"],
                                  bi[:, :5].reshape(-1).numpy())
    feats = np.concatenate([got.geof * [1, 1, 1, 2], got.rgb / 255.0], 1)
    hist = np.eye(6)[labels]
    src = got.graph_nn["source"].astype(np.int64)
    tgt = got.graph_nn["target"].astype(np.int64)
    w = (1.0 / (1.0 + got.graph_nn["distances"]
                / got.graph_nn["distances"].mean()))

    def quality(r):
        return (_energy(feats, r.in_component, src, tgt, w, 0.1),
                len(r.components), compute_OOA(r.components, hist))

    _assert_within(quality(got), quality(want))
    assert disconnected_labels(got.in_component, src, tgt) == 0


def test_partition_cloud_big_device_outputs(big_results, small_chunks):
    """host_outputs=False keeps the [n, k] tables and geof on the device:
    the same partition and graph, geof None, graph_nn only is_nn."""
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig

    got, _, _, cloud = big_results
    res = big_t.partition_cloud_big(*cloud, n_labels=13,
                                    cfg=PartitionConfig(**BIG_CFG),
                                    host_outputs=False, device="cpu")
    assert res.geof is None and res.graph_nn == {"is_nn": True}
    np.testing.assert_array_equal(res.in_component, got.in_component)
    np.testing.assert_array_equal(res.graph_sp["source"],
                                  got.graph_sp["source"])


@pytest.mark.parametrize("case", ["partition_cloud", "partition_clouds"])
def test_partition_dispatches_giant_cloud(big_results, small_chunks, case,
                                          monkeypatch):
    """With the device solver, a cloud above CHUNKED_CP_THRESHOLD pruned
    voxels goes through partition_cloud_big (its stats in the times), from
    partition_cloud and from partition_clouds, with the pruned cloud and
    voxel_width 0, and gives its partition."""
    from superpoint_graph_tpu_torch import pipeline
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig

    got_big = big_results[0]
    monkeypatch.setattr(pipeline, "CHUNKED_CP_THRESHOLD", 1000)
    real, seen = big_t.partition_cloud_big, []

    def spy(xyz, *a, **kw):
        seen.append(a[4].voxel_width)
        return real(xyz, *a, **kw)

    monkeypatch.setattr(big_t, "partition_cloud_big", spy)
    xyz, rgb, labels, objects = synthetic_room(np.random.RandomState(7),
                                               n_points=5000)
    cfg = PartitionConfig(voxel_width=0.0, k_nn_geof=12, k_nn_adj=5,
                          reg_strength=0.1, spg_adjacency="knn")
    if case == "partition_cloud":
        res = pipeline.partition_cloud(xyz, rgb, labels, objects, 13, cfg,
                                       device="cpu")
    else:
        res, = pipeline.partition_clouds([(xyz, rgb, labels, objects)], cfg,
                                         13, device="cpu")
    assert seen == [0.0] and "cp_info" in res.times
    np.testing.assert_array_equal(res.in_component, got_big.in_component)
