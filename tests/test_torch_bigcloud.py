"""The port's sorted-cell kNN of the giant-cloud path (superpoint_graph_
tpu_torch/ops/knn.py::knn_bigcloud) against brute force and the JAX
package, on the CPU. Inputs come from seeds with numpy; JAX runs on the CPU
as its own tests run it, the port with device="cpu" or CPU tensors. The
merge reduction and the device SPG are in test_torch_merge_spg.py.

The port's kNN is exact; the JAX one selects with approx_min_k at recall
0.95. So the port is held to brute force exactly (distances to 1e-6
relative, indices equal wherever the distance has no tie) and to JAX at
>= 0.99 index agreement."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
from superpoint_graph_tpu_torch.ops import knn as knn_t


def _brute(xyz, k):
    """Exact kNN in numpy f32 (the port's (q - p)^2 sum), lower index first
    on equal distances, the point itself excluded."""
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, axis=1)


def _assert_exact(got_i, got_d, xyz, k):
    """Distances equal to brute force to 1e-6 relative; indices equal
    except where the brute-force distance repeats (a tie may order either
    way), and there the port's neighbour lies at that distance."""
    want_i, want_d = _brute(xyz, k)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=1e-12)
    diff = got_i != want_i
    if diff.any():
        rows, cols = np.nonzero(diff)
        tie = np.zeros(len(rows), bool)
        for j, (r, c) in enumerate(zip(rows, cols)):
            tie[j] = (want_d[r] == want_d[r, c]).sum() > 1
        assert tie.all(), f"{(~tie).sum()} non-tied indices differ"
    assert not (got_i == np.arange(len(xyz))[:, None]).any()


def _cloud(case, rng):
    xyz, _, _, _ = synthetic_room(rng, n_points=5000 if case == "surface"
                                  else 3000)
    if case in ("outliers", "sliced"):
        n_out = 20 if case == "outliers" else 40
        out = rng.rand(n_out, 3).astype(np.float32) * 50.0 + 10.0
        xyz = np.concatenate([xyz, out])
    if case == "duplicates":
        base = rng.rand(500, 3).astype(np.float32)
        xyz = np.concatenate([base, base[:50]])
    return np.ascontiguousarray(xyz, np.float32)


@pytest.mark.parametrize("case,k", [("surface", 8), ("surface", 45),
                                    ("outliers", 6), ("sliced", 6),
                                    ("duplicates", 4)])
def test_knn_bigcloud_equals_brute_force(case, k, monkeypatch):
    """Surface cloud; sparse outliers that fail the level-0 certificate and
    reach the brute-force fallback; the fallback in slices of 16 queries;
    duplicated points (distance 0, never the point itself)."""
    if case == "sliced":
        monkeypatch.setattr(knn_t, "FALLBACK_QUERY_CHUNK", 16)
    xyz = _cloud(case, np.random.RandomState(7))
    idx, d2, info = knn_t.knn_bigcloud(torch.from_numpy(xyz), k)
    _assert_exact(idx.numpy(), d2.numpy(), xyz, k)
    if case in ("outliers", "sliced"):
        assert info["levels"][0]["bad"] > 0
    if case == "sliced":
        assert info["n_fallback"] > 16


def test_knn_bigcloud_every_level_exact(monkeypatch):
    """With the brute-force cut forced off, the outliers climb the ladder
    of cell sizes (in the small-block, wide-window form after level 0)
    until every query is certified, none left to brute force; the result
    is still exact."""
    monkeypatch.setattr(knn_t, "LEVEL_MIN_WORK", 0.0)
    xyz = _cloud("outliers", np.random.RandomState(3))
    idx, d2, info = knn_t.knn_bigcloud(torch.from_numpy(xyz), 6)
    assert len(info["levels"]) >= 2 and info["n_fallback"] == 0
    _assert_exact(idx.numpy(), d2.numpy(), xyz, 6)


def test_knn_bigcloud_small_windows_exact(monkeypatch):
    """Windows capped at 256 rows truncate dense blocks: those are marked
    and re-solved, the result stays exact."""
    xyz = _cloud("surface", np.random.RandomState(5))
    monkeypatch.setattr(knn_t, "TILE_ELEMS", 1 << 16)  # many launches
    monkeypatch.setattr(knn_t, "BLOCK_Q", 256)
    monkeypatch.setattr(knn_t, "WINDOW_CAP", 256)
    idx, d2, info = knn_t.knn_bigcloud(torch.from_numpy(xyz), 45)
    assert info["levels"][0]["bad"] > 0
    _assert_exact(idx.numpy(), d2.numpy(), xyz, 45)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_knn_bigcloud_exact_far_from_block_start(seed):
    """Two jittered 8^3 grids of 1 m pitch, one 300 m above the other: the
    sorted-cell blocks that run from the lower grid's top into the upper
    grid's bottom put candidates ~300 m from the block's first query. An
    expanded |q|^2 + |c|^2 - 2 q.c tile about that query is ~eps * 300^2
    off there, which reorders the near-equal shells of a grid across the
    spare candidates (the miss of a 220 m station's 12.8M voxels); the
    direct form keeps the search exact."""
    rs = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    low = grid + rs.uniform(-1e-3, 1e-3, grid.shape)
    high = grid + rs.uniform(-1e-3, 1e-3, grid.shape) + [0.0, 0.0, 300.0]
    xyz = np.ascontiguousarray(np.concatenate([low[7:], high]), np.float32)
    idx, d2, _ = knn_t.knn_bigcloud(torch.from_numpy(xyz), 45)
    _assert_exact(idx.numpy(), d2.numpy(), xyz, 45)


@pytest.mark.parametrize("k", [8, 45])
def test_knn_bigcloud_agrees_with_jax(k):
    """Index agreement with the JAX search (approximate selection) >= 0.99
    as neighbour sets; the port's k-th distance is never above JAX's."""
    from superpoint_graph_tpu.ops.knn import knn_bigcloud as knn_j

    xyz = _cloud("surface", np.random.RandomState(11))[:4000]
    got_i, got_d, _ = knn_t.knn_bigcloud(torch.from_numpy(xyz), k)
    want_i, want_d, _ = knn_j(xyz, k)
    got_i, want_i = got_i.numpy(), np.asarray(want_i)
    agree = np.mean([len(np.intersect1d(a, b)) / k
                     for a, b in zip(got_i, want_i)])
    assert agree >= 0.99, agree
    assert (got_d.numpy()[:, -1] <= np.asarray(want_d)[:, -1] * (1 + 1e-6)
            + 1e-12).all()


def test_compute_graph_nn_2_bigcloud_dispatch(monkeypatch):
    """Above BIGCLOUD_THRESHOLD compute_graph_nn_2 searches with
    knn_bigcloud, and its graph and tables equal the brute-force path's
    (both exact)."""
    xyz = _cloud("surface", np.random.RandomState(2))[:3000]
    g_ref, t_ref, dev_ref = knn_t.compute_graph_nn_2(xyz, 5, 12, device="cpu",
                                                     return_device=True)
    calls = []
    real = knn_t.knn_bigcloud
    monkeypatch.setattr(knn_t, "knn_bigcloud",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(knn_t, "BIGCLOUD_THRESHOLD", 100)
    g_big, t_big, dev_big = knn_t.compute_graph_nn_2(xyz, 5, 12, device="cpu",
                                                     return_device=True)
    assert calls == [1]
    for key in ("source", "target", "distances"):
        assert g_big[key].dtype == g_ref[key].dtype
        np.testing.assert_array_equal(g_big[key], g_ref[key])
    assert torch.equal(t_big, t_ref)
    assert torch.equal(dev_big["d2"], dev_ref["d2"])
