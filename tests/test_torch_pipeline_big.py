"""The port's chunked cut pursuit (superpoint_graph_tpu_torch/
pipeline_big.py: window geometry, the device-fed and host-fed chunked
solvers, the heal, the cutoff) against the JAX package, on the CPU, at a
few thousand points with `chunk_points` lowered as the JAX tests lower it.
`partition_cloud_big` is in test_torch_partition_big.py, the Semantic3D
path in test_torch_scan.py.

The chunk solver keeps its weights in f32 where JAX stores bf16, and the CC
cap is the port's, so partitions are compared label for label only on
planted clusters; elsewhere by energy (within 3%), component count (within
15%) and OOA (within 1 point), the bounds of tools/cp_room_quality.py."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch import pipeline_big as big_t
from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                      disconnected_labels)

BOUNDS = {"energy": 0.03, "n_comp": 0.15, "ooa": 1.0}


def _knn(xyz, k):
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, axis=1).astype(np.float32)


def _edges(idx, d2):
    src = np.repeat(np.arange(len(idx)), idx.shape[1])
    dist = np.sqrt(d2.reshape(-1))
    return src, idx.reshape(-1), (1.0 / (1.0 + dist / dist.mean())).astype(
        np.float32)


def _energy(f, ic, src, tgt, w, reg):
    ic = np.asarray(ic, np.int64)
    nc = ic.max() + 1
    S = np.zeros((nc, f.shape[1]))
    np.add.at(S, ic, f.astype(np.float64))
    m = np.bincount(ic, minlength=nc).astype(np.float64)
    return ((f.astype(np.float64) ** 2).sum() - ((S ** 2).sum(1) / m).sum()
            + reg * w[ic[src] != ic[tgt]].sum())


@pytest.fixture(scope="module")
def room():
    """A 6,000-point room: features xyz + rgb/255, 5-NN graph, the
    generator's labels as a one-hot histogram."""
    xyz, rgb, labels, _ = synthetic_room(np.random.RandomState(7),
                                         n_points=6000)
    idx, d2 = _knn(xyz, 5)
    feats = np.concatenate([xyz, rgb / 255.0], 1).astype(np.float32)
    return xyz, feats, idx, d2, np.eye(6)[labels]


def _jax_device_args(feats, idx, d2):
    import jax.numpy as jnp

    return (jnp.asarray(feats), jnp.asarray(idx.astype(np.int32)),
            jnp.asarray(d2))


def _quality(f, ic, comps, idx, d2, hist, reg):
    src, tgt, w = _edges(idx, d2)
    return (_energy(f, ic, src, tgt, w, reg), len(comps),
            compute_OOA(comps, hist))


def _assert_within(got, want):
    (e_t, n_t, ooa_t), (e_j, n_j, ooa_j) = got, want
    assert abs(e_t / e_j - 1) <= BOUNDS["energy"], (got, want)
    assert abs(n_t / n_j - 1) <= BOUNDS["n_comp"], (got, want)
    assert abs(ooa_t - ooa_j) <= BOUNDS["ooa"], (got, want)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("n,chunk_points", [(6000, 2000), (6000, 1000),
                                            (1500, 600)])
def test_chunk_geometry_and_pad_rows_match_jax(room, n, chunk_points,
                                               monkeypatch):
    """The windows (start, rows) the JAX device path prepares, read off its
    `_prep_band_chunk` calls, equal the port's, and the port's solve gets
    pad_rows = chunk_pad - rows, the JAX window's pad rows (features 0,
    node weight 0). The first window's pad is the halo."""
    import superpoint_graph_tpu.pipeline_big as big_j

    xyz, feats, idx, d2, _ = room
    xyz, feats, idx, d2 = xyz[:n], feats[:n], idx[:n], d2[:n]
    idx = np.where(idx < n, idx, 0)
    seen_j, seen_t = [], []
    real_prep = big_j._prep_band_chunk

    def spy_prep(*a, **kw):
        seen_j.append((int(a[5]), int(a[6]), kw["chunk_pad"]))
        return real_prep(*a, **kw)

    monkeypatch.setattr(big_j, "_prep_band_chunk", spy_prep)
    big_j.chunked_cutpursuit_device(*_jax_device_args(feats, idx, d2), xyz,
                                    0.1, chunk_points=chunk_points)
    real_solve = big_t.solve

    def spy_solve(f, *a, pad_rows, **kw):
        seen_t.append((len(f), pad_rows))
        return real_solve(f, *a, pad_rows=pad_rows, **kw)

    monkeypatch.setattr(big_t, "solve", spy_solve)
    big_t.chunked_cutpursuit_device(torch.from_numpy(feats),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(d2),
                                    torch.from_numpy(xyz), 0.1,
                                    chunk_points=chunk_points)
    chunk_pad, halo, _, windows = big_t.chunk_geometry(n, chunk_points)
    assert [(x0, x1 - x0, chunk_pad) for _, _, x0, x1 in windows] == seen_j
    assert seen_t == [(rows, pad - rows) for _, rows, pad in seen_j]
    assert seen_t[0][1] == halo
    assert big_t.LAST_CP_STATS["n_chunks"] == len(seen_j) > 1


# ---------------------------------------------------------------- solver
@pytest.mark.parametrize("morton", ["host", "device"])
def test_chunked_planted_identical_to_jax(morton):
    """Four planted regions on a 4,096-point plane (features constant per
    quadrant, unit-scale noise 1e-3) cut into 1,024-row windows: the port's
    labels are the JAX chunked solver's, label for label, with the JAX
    Morton order taken from host xyz and from the device array, and
    recover the quadrants (with a few islands of the kNN graph)."""
    import jax.numpy as jnp

    import superpoint_graph_tpu.pipeline_big as big_j

    rng = np.random.RandomState(1)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[:, :2] = rng.rand(4096, 2) * 8
    quad = (xyz[:, 0] > 4).astype(int) * 2 + (xyz[:, 1] > 4)
    feats = (np.eye(4, dtype=np.float32)[quad]
             + rng.randn(4096, 4).astype(np.float32) * 1e-3)
    idx, d2 = _knn(xyz, 5)
    kw = dict(chunk_points=1024)
    if morton == "device":
        comps_j, ic_j = big_j.chunked_cutpursuit_device(
            *_jax_device_args(feats, idx, d2), xyz, 0.5,
            xyz_dev=jnp.asarray(xyz), **kw)
    else:
        comps_j, ic_j = big_j.chunked_cutpursuit_device(
            *_jax_device_args(feats, idx, d2), xyz, 0.5, **kw)
    comps_t, ic_t = big_t.chunked_cutpursuit_device(
        torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(d2),
        torch.from_numpy(xyz), 0.5, **kw)
    np.testing.assert_array_equal(ic_t, ic_j)
    # each component inside one quadrant; the four largest hold all but
    # the few points the 5-NN graph leaves in islands
    pairs = np.unique(np.stack([ic_t, quad]), axis=1)
    assert len(pairs[0]) == len(comps_t)
    assert np.sort([len(c) for c in comps_t])[-4:].sum() >= 0.99 * 4096


@pytest.mark.parametrize("chunk_points", [2000, 1000])
def test_chunked_device_matches_jax_on_room(room, chunk_points):
    """The port's chunked device solver against the JAX one on the room:
    energy, component count and OOA within BOUNDS; every label connected,
    no CC call capped, the stats' keys filled."""
    import superpoint_graph_tpu.pipeline_big as big_j

    xyz, feats, idx, d2, hist = room
    comps_j, ic_j = big_j.chunked_cutpursuit_device(
        *_jax_device_args(feats, idx, d2), xyz, 0.1,
        chunk_points=chunk_points)
    comps_t, ic_t = big_t.chunked_cutpursuit_device(
        torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(d2),
        torch.from_numpy(xyz), 0.1, chunk_points=chunk_points)
    _assert_within(_quality(feats, ic_t, comps_t, idx, d2, hist, 0.1),
                   _quality(feats, ic_j, comps_j, idx, d2, hist, 0.1))
    src, tgt, _ = _edges(idx, d2)
    assert disconnected_labels(ic_t, src, tgt) == 0
    st = big_t.LAST_CP_STATS
    assert st["cc_capped"] == 0 and st["host_syncs"] > 0
    assert len(st["solve_iters"]) == st["n_chunks"] > 1
    assert st["heal_regions_out"] <= st["heal_regions_in"]


def test_chunked_host_fed_matches_jax(room):
    """The host-fed chunked solver against the JAX one (same windows, the
    JAX host-array pad rows): energy, components and OOA within BOUNDS,
    labels connected."""
    import superpoint_graph_tpu.pipeline_big as big_j

    xyz, feats, idx, d2, hist = room
    src, tgt, w = _edges(idx, d2)
    comps_j, ic_j = big_j.chunked_cutpursuit(feats, xyz, src, tgt, w, 0.1,
                                             chunk_points=2000)
    comps_t, ic_t = big_t.chunked_cutpursuit(feats, xyz, src, tgt, w, 0.1,
                                             chunk_points=2000, device="cpu")
    _assert_within(_quality(feats, ic_t, comps_t, idx, d2, hist, 0.1),
                   _quality(feats, ic_j, comps_j, idx, d2, hist, 0.1))
    assert disconnected_labels(ic_t, src, tgt) == 0


def test_chunked_within_monolithic_energy(room):
    """Chunked solve and heal against the port's single solve of the whole
    room (same region-accept settings, then the merge step): energy at most
    x1.10 (the JAX test's bound), OOA at most 1 point lower."""
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import (
        cutpursuit_band_device)
    from superpoint_graph_tpu_torch.ops.components import group_components
    from superpoint_graph_tpu_torch.ops.cutpursuit import merge_regions

    xyz, feats, idx, d2, hist = room
    t = torch.from_numpy
    comps_c, ic_c = big_t.chunked_cutpursuit_device(
        t(feats), t(idx), t(d2), t(xyz), 0.1, chunk_points=2000)
    ic_m = cutpursuit_band_device(t(feats), t(idx), t(d2), xyz, len(xyz),
                                  0.1, accept="region", max_iter=16,
                                  stop_tol=1e-3, cc_jumps=1)
    src, tgt, w = _edges(idx, d2)
    ic_m = merge_regions(feats, np.ones(len(xyz)), ic_m, src, tgt, w, 0.1)
    e_c, _, ooa_c = _quality(feats, ic_c, comps_c, idx, d2, hist, 0.1)
    e_m, _, ooa_m = _quality(feats, ic_m, group_components(ic_m), idx, d2,
                             hist, 0.1)
    assert e_c <= 1.10 * e_m, (e_c, e_m)
    assert ooa_c >= ooa_m - 1.0, (ooa_c, ooa_m)


def test_heal_merges_plane_across_chunks():
    """A flat plane of constant features cut into 8 windows comes back as
    at most 3 regions (the heal's job), as in the JAX test."""
    rng = np.random.RandomState(7)
    xyz = np.zeros((4000, 3), np.float32)
    xyz[:, :2] = rng.rand(4000, 2) * 10
    feats = np.full((4000, 2), 0.5, np.float32)
    idx, d2 = _knn(xyz, 5)
    comps, _ = big_t.chunked_cutpursuit_device(
        torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(d2),
        torch.from_numpy(xyz), 0.05, chunk_points=512)
    assert len(comps) <= 3
    assert big_t.LAST_CP_STATS["n_chunks"] >= 8


@pytest.mark.parametrize("fed", ["device", "host"])
def test_cutoff_applies(fed):
    """Components smaller than the cutoff are fused (both chunked paths)."""
    rng = np.random.RandomState(7)
    xyz = rng.rand(1500, 3).astype(np.float32)
    feats = rng.rand(1500, 4).astype(np.float32)
    idx, d2 = _knn(xyz, 4)
    if fed == "device":
        comps, ic = big_t.chunked_cutpursuit_device(
            torch.from_numpy(feats), torch.from_numpy(idx),
            torch.from_numpy(d2), torch.from_numpy(xyz), 0.5, cutoff=5,
            chunk_points=600)
    else:
        src, tgt, w = _edges(idx, d2)
        comps, ic = big_t.chunked_cutpursuit(feats, xyz, src, tgt, w, 0.5,
                                             cutoff=5, chunk_points=600,
                                             device="cpu")
    sizes = np.bincount(ic)
    assert sizes[sizes > 0].min() >= 5 or len(comps) == 1
