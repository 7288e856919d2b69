"""Parity of the port's ops (superpoint_graph_tpu_torch) with the JAX package
on the CPU: the same numpy inputs from a seed go through both. Each test
states its tolerance. The CUDA kernels' checks on the card are in
test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import superpoint_graph_tpu_torch.ops.knn as knn_t
from superpoint_graph_tpu.ops import geof as geof_j
from superpoint_graph_tpu.ops import knn as knn_j
from superpoint_graph_tpu.ops import voxel as voxel_j
from superpoint_graph_tpu.ops.nn1_pallas import nn1 as nn1_j
from superpoint_graph_tpu_torch.ops import geof as geof_t
from superpoint_graph_tpu_torch.ops import voxel as voxel_t
from superpoint_graph_tpu_torch.ops.nn1 import nn1, nn1_plain

T = torch.from_numpy


# ---------------------------------------------------------------- nn1
@pytest.mark.parametrize("n_db,n_q", [(700, 900), (300, 77)])
def test_nn1_matches_jax(rng, n_db, n_q):
    """Plain torch nn1 vs the Pallas kernel in interpret mode: recomputed
    distances within rtol 1e-4, atol 1e-6 (test_pallas.py); >= 99% of
    indices equal (ties may differ)."""
    db = rng.rand(n_db, 3).astype(np.float32)
    q = rng.rand(n_q, 3).astype(np.float32)
    want = nn1_j(db, q, block_q=128, tile=256)
    got = nn1(T(db), T(q)).numpy()
    assert got.shape == want.shape == (n_q,)
    d_got = ((q - db[got]) ** 2).sum(1)
    d_want = ((q - db[want]) ** 2).sum(1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-6)
    assert (got == want).mean() >= 0.99


def test_nn1_empty():
    z = torch.zeros((0, 3))
    assert nn1(z, torch.zeros((5, 3))).shape == (0,)
    assert nn1(torch.zeros((5, 3)), z).shape == (0,)
    assert nn1_j(np.zeros((0, 3)), np.zeros((5, 3))).shape == (0,)


def test_nn1_ties_lowest_index(rng):
    """Duplicated db points: every query on a duplicate gets the LOWEST
    index, in the port (across db blocks too) and in the JAX kernel."""
    base = rng.rand(40, 3).astype(np.float32)
    db = np.concatenate([base, base[::-1], base])  # each point 3 times
    q = base[rng.permutation(40)]
    want_idx = np.array([np.flatnonzero((db == p).all(1)).min() for p in q])
    np.testing.assert_array_equal(nn1(T(db), T(q)).numpy(), want_idx)
    np.testing.assert_array_equal(
        nn1_plain(T(db), T(q), block_q=7, block_db=16).numpy(), want_idx)
    np.testing.assert_array_equal(nn1_j(db, q, block_q=128, tile=256),
                                  want_idx)


def test_nn1_plain_blocking_invariant(rng):
    """Query and db blocking do not change the result (exact equality)."""
    db = rng.rand(500, 3).astype(np.float32)
    q = rng.rand(333, 3).astype(np.float32)
    one = nn1_plain(T(db), T(q))
    many = nn1_plain(T(db), T(q), block_q=50, block_db=64)
    np.testing.assert_array_equal(one.numpy(), many.numpy())


def test_nn1_rejects_bad_input():
    with pytest.raises(ValueError):
        nn1(torch.zeros((4, 2)), torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        nn1(torch.zeros((4, 3), dtype=torch.float64), torch.zeros((4, 3)))


# ---------------------------------------------------------------- reader
def test_read_s3dis_format_matches_jax(tmp_path):
    """Identical xyz, rgb, labels and objects on a written room."""
    from superpoint_graph_tpu.data.provider import read_s3dis_format as rj
    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format as rt
    from tests.test_cli import write_s3dis_room

    write_s3dis_room(str(tmp_path), "Area_1", "room_0",
                     np.random.RandomState(3))
    path = str(tmp_path / "data" / "Area_1" / "room_0" / "room_0.txt")
    for a, b in zip(rt(path, device="cpu"), rj(path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    xyz, rgb = rt(path, label_out=False, device="cpu")
    assert xyz.shape == rgb.shape == (2500, 3)


def test_synthetic_room_writer_reads_back(tmp_path):
    """The smoke's noisy, cluttered room: both readers give identical
    outputs, and the labels equal the generator's on >= 99.9% of points
    (a point whose rounded coordinates repeat in two objects keeps the
    later object)."""
    from superpoint_graph_tpu.data.provider import read_s3dis_format as rj
    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format as rt
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room

    path, want, n_objects = write_s3dis_room(
        tmp_path / "Area_1" / "room_0", np.random.RandomState(4), 3000)
    got = rt(str(path), device="cpu")
    for a, b in zip(got, rj(str(path))):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(got[3])) == n_objects
    assert (got[2] == want).mean() >= 0.999


def test_interpolate_labels_matches_jax(rng):
    """Identical up-sampled labels from a one-hot histogram (exact)."""
    from superpoint_graph_tpu.data.provider import interpolate_labels as ij
    from superpoint_graph_tpu_torch.data.provider import (
        interpolate_labels as it)

    xyz = rng.rand(300, 3).astype(np.float32)
    xyz_up = rng.rand(1000, 3).astype(np.float32)
    hist = rng.randint(0, 5, (300, 4))
    np.testing.assert_array_equal(it(xyz_up, xyz, hist, device="cpu"),
                                  ij(xyz_up, xyz, hist))


# ---------------------------------------------------------------- prune
@pytest.mark.parametrize("with_labels", [True, False])
def test_prune_matches_jax(rng, with_labels):
    """Identical outputs (first-occurrence order, f32 means, truncated rgb,
    histograms)."""
    xyz = (rng.rand(3000, 3) * [2.0, 1.5, 1.0]).astype(np.float32)
    rgb = rng.randint(0, 256, (3000, 3)).astype(np.uint8)
    labels = rng.randint(0, 6, 3000) if with_labels else None
    objects = rng.randint(0, 9, 3000) if with_labels else None
    n_lab, n_obj = (5, 8) if with_labels else (0, 0)
    got = voxel_t.prune(xyz, 0.1, rgb, labels, objects, n_lab, n_obj,
                        device="cpu")
    want = voxel_j.prune(xyz, 0.1, rgb, labels, objects, n_lab, n_obj)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- kNN
def test_knn_exact_and_agrees_with_jax(rng):
    """Squared distances equal sklearn's exact search (rtol 1e-5); >= 99%
    index agreement with the JAX op (approximate on the TPU)."""
    from sklearn.neighbors import NearestNeighbors

    xyz = rng.rand(1500, 3).astype(np.float32)
    k = 12
    idx, d2 = knn_t.knn(T(xyz), k, block_q=256)
    ref_d, _ = NearestNeighbors(n_neighbors=k + 1).fit(xyz).kneighbors(xyz)
    np.testing.assert_allclose(d2.numpy(), ref_d[:, 1:] ** 2, rtol=1e-5,
                               atol=1e-9)
    idx_j, _ = knn_j.knn(xyz, k)
    assert (idx.numpy() == np.asarray(idx_j)).mean() >= 0.99
    assert not (idx.numpy() == np.arange(1500)[:, None]).any()


def test_knn_duplicate_points_self_excluded(rng):
    """With exact duplicates the self index, not column 0, is removed; the
    duplicate comes first at distance 0."""
    base = rng.rand(200, 3).astype(np.float32)
    xyz = np.concatenate([base, base])
    idx, d2 = knn_t.knn(T(xyz), 4)
    idx = idx.numpy()
    assert not (idx == np.arange(400)[:, None]).any()
    np.testing.assert_array_equal(idx[:200, 0], np.arange(200, 400))
    np.testing.assert_array_equal(idx[200:, 0], np.arange(200))
    assert (d2.numpy()[:, 0] == 0).all()


def test_compute_graph_nn_2_matches_jax(rng):
    """Adjacency graph: same keys and dtypes, >= 99% equal targets,
    distances within rtol 1e-5; the geof table has k_geof columns."""
    xyz = rng.rand(800, 3).astype(np.float32)
    g_t, nb_t = knn_t.compute_graph_nn_2(xyz, 5, 15, device="cpu")
    g_j, nb_j = knn_j.compute_graph_nn_2(xyz, 5, 15)
    assert nb_t.shape == (800, 15)
    for key in ("source", "target", "distances"):
        assert g_t[key].dtype == g_j[key].dtype
    np.testing.assert_array_equal(g_t["source"], g_j["source"])
    assert (g_t["target"] == g_j["target"]).mean() >= 0.99
    np.testing.assert_allclose(np.sort(g_t["distances"]),
                               np.sort(g_j["distances"]), rtol=1e-5)
    assert (nb_t.numpy() == np.asarray(nb_j)).mean() >= 0.99


def test_knn_above_threshold_raises(monkeypatch):
    """The brute-force knn refuses clouds above BIGCLOUD_THRESHOLD (O(n^2));
    compute_graph_nn_2 takes them through knn_bigcloud instead, with the
    same exact graph."""
    monkeypatch.setattr(knn_t, "BIGCLOUD_THRESHOLD", 10)
    xyz = torch.rand(20, 3)
    with pytest.raises(ValueError, match="knn_bigcloud"):
        knn_t.knn(xyz, 3)
    graph, nb = knn_t.compute_graph_nn_2(xyz.numpy(), 2, 3, device="cpu")
    want_i, want_d = knn_t.knn_vs_db(xyz, torch.arange(20), 3)
    assert torch.equal(nb, want_i)
    np.testing.assert_array_equal(graph["target"],
                                  want_i[:, :2].reshape(-1).numpy())


# ---------------------------------------------------------------- geof
def _geof_cloud(rng):
    """Random points plus degenerate neighbourhoods: a line, a plane and a
    cluster of identical points."""
    xyz = rng.rand(400, 3).astype(np.float32)
    line = np.outer(np.linspace(0, 1, 30), [1.0, 0.5, 0.2]) + 5
    plane = np.c_[rng.rand(30, 2), np.zeros(30)] + 7
    same = np.full((20, 3), 9.0)
    return np.concatenate([xyz, line, plane, same]).astype(np.float32)


def test_geof_matches_jax_and_numpy(rng):
    """Regular neighbourhoods: the f32 port vs JAX compute_geof within atol
    1e-5, and the port in float64 vs the numpy oracle (f64 LAPACK) within
    atol 1e-5.

    Degenerate neighbourhoods (exact line, plane, identical points): their
    vanishing eigenvalues are rounding noise, which the square roots
    amplify (arccos near +-1 turns an f32 rounding of r into ~sqrt(eps) in
    the angle), so both f32 implementations agree only to atol 2e-2 (the
    JAX package holds itself to 1e-2 against its oracle,
    test_ops_geometry.py) and the analytic
    method in f64 meets LAPACK to atol 1e-3. On an exactly zero covariance
    (identical points, whose mean the port computes exactly) the _EPS
    placements give [1, 0, 0, 0]."""
    xyz = _geof_cloud(rng)
    reg = slice(0, 400)
    nbrs, _ = knn_t.knn(T(xyz), 10)
    got = geof_t.compute_geof(T(xyz), nbrs).numpy()
    want = np.asarray(geof_j.compute_geof(xyz, nbrs.numpy().astype(np.int32)))
    np.testing.assert_allclose(got[reg], want[reg], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-2)
    got64 = geof_t.compute_geof(T(xyz.astype(np.float64)), nbrs).numpy()
    oracle = geof_j.compute_geof_numpy(xyz.astype(np.float64), nbrs.numpy())
    np.testing.assert_allclose(got64[reg], oracle[reg], atol=1e-5)
    np.testing.assert_allclose(got64[:460], oracle[:460], atol=1e-3)
    np.testing.assert_array_equal(got[460:], np.tile([1, 0, 0, 0], (20, 1)))
    # chunking is row-wise: identical results
    np.testing.assert_array_equal(
        geof_t.compute_geof(T(xyz), nbrs, chunk=37).numpy(), got)


def test_eigh3x3_matches_jax(rng):
    """Eigenpairs of random symmetric matrices: eigenvalues within atol
    1e-5 of JAX, |A v - l v| < 1e-4."""
    from superpoint_graph_tpu.ops.eigen3 import eigh3x3 as ej
    from superpoint_graph_tpu_torch.ops.eigen3 import eigh3x3 as et

    a = rng.randn(64, 3, 3).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    lt, vt = et(T(cov))
    lj, _ = ej(cov)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)
    resid = cov @ vt.numpy() - vt.numpy() * lt.numpy()[:, None, :]
    assert np.abs(resid).max() < 1e-4 * np.abs(cov).max()


# ---------------------------------------------------------------- cut pursuit
@pytest.fixture(scope="module")
def room_graph():
    """A pruned synthetic room's partition inputs, built by the JAX
    package so both solvers see the same arrays."""
    from superpoint_graph_tpu.data.synthetic import synthetic_room
    from superpoint_graph_tpu.pipeline import (
        PartitionConfig, assemble_partition_features, edge_weights,
        partition_features)

    xyz, rgb, labels, _ = synthetic_room(np.random.RandomState(1), 3000)
    xyz, rgb, hist, _ = voxel_j.prune(xyz, 0.05, rgb, labels, None, 6, 0)
    cfg = PartitionConfig(cp_backend="exact", k_nn_geof=20, k_nn_adj=5)
    graph_nn, geof = partition_features(xyz, cfg)
    feats = assemble_partition_features(geof, rgb, cfg)
    w = edge_weights(graph_nn["distances"], cfg.lambda_edge_weight)
    return xyz, hist, graph_nn, feats, w


@pytest.mark.parametrize("cutoff", [0, 10])
def test_cutpursuit_matches_jax(room_graph, cutoff):
    """Identical labels and components from the exact solver."""
    from superpoint_graph_tpu.ops.cutpursuit import cutpursuit as cp_j
    from superpoint_graph_tpu_torch.ops.cutpursuit import cutpursuit as cp_t

    _, _, g, feats, w = room_graph
    comp_t, lab_t = cp_t(feats, g["source"], g["target"], w, 0.05,
                         cutoff=cutoff)
    comp_j, lab_j = cp_j(feats, g["source"], g["target"], w, 0.05,
                         cutoff=cutoff)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert len(comp_t) == len(comp_j) > 1
    for a, b in zip(comp_t, comp_j):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- SPG
@pytest.mark.parametrize("mode", ["delaunay", "knn", "knn_edges"])
def test_compute_sp_graph_matches_jax(room_graph, mode):
    """Identical SPG dicts (keys, dtypes, values) in each adjacency mode."""
    from superpoint_graph_tpu.graph.spg import compute_sp_graph as sj
    from superpoint_graph_tpu.ops.cutpursuit import cutpursuit as cp_j
    from superpoint_graph_tpu_torch.graph.spg import compute_sp_graph as st

    xyz, hist, g, feats, w = room_graph
    comps, in_comp = cp_j(feats, g["source"], g["target"], w, 0.05)
    kw = {"adjacency": "knn" if mode != "delaunay" else "delaunay"}
    if mode == "knn_edges":
        kw["knn_edges"] = (g["source"], g["target"])
    got = st(xyz, 0.0, in_comp, hist, 6, device="cpu", **kw)
    want = sj(xyz, 0.0, in_comp, comps, hist, 6, **kw)
    assert got.keys() == want.keys()
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


# ---------------------------------------------------------------- segment ops
def test_segment_ops_match_jax(rng):
    """sum/mean/max/count with a mask, within 1e-6 (max: exact)."""
    import jax.numpy as jnp

    from superpoint_graph_tpu.ops import segment as sj
    from superpoint_graph_tpu_torch.ops import segment as st

    data = rng.randn(200, 5).astype(np.float32)
    ids = rng.randint(0, 30, 200)  # some segments empty
    mask = rng.rand(200) > 0.3
    for name in ("segment_sum", "segment_mean", "segment_max"):
        got = getattr(st, name)(T(data), T(ids), 33, T(mask)).numpy()
        want = np.asarray(getattr(sj, name)(jnp.asarray(data), jnp.asarray(ids),
                                            33, jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(
        st.segment_count(T(ids), 33, T(mask)).numpy(),
        np.asarray(sj.segment_count(jnp.asarray(ids), 33, jnp.asarray(mask))))


@pytest.mark.parametrize("mode", ["vector", "matrix", "attention"])
def test_ecc_conv_matches_jax(rng, mode):
    """ecc_conv in vector, matrix and attention modes within atol/rtol
    1e-5, padding edges masked."""
    import jax.numpy as jnp

    from superpoint_graph_tpu.models.ecc import ecc_conv as ej
    from superpoint_graph_tpu_torch.models.ecc import ecc_conv as et

    n, e, c = 25, 90, 6
    h = rng.randn(n, c).astype(np.float32)
    shape = (e, c) if mode == "vector" else (e, c, 4)
    w = rng.randn(*shape).astype(np.float32)
    src = rng.randint(0, n, e)
    tgt = rng.randint(0, n - 3, e)  # the last nodes have no incoming edge
    mask = rng.rand(e) > 0.2
    att = mode == "attention"
    got = et(T(h), T(w), T(src), T(tgt), T(mask), n, attention=att).numpy()
    want = np.asarray(ej(jnp.asarray(h), jnp.asarray(w), jnp.asarray(src),
                         jnp.asarray(tgt), jnp.asarray(mask), n, attention=att))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
