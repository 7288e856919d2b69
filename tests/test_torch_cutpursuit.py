"""The port's device cut-pursuit solver (superpoint_graph_tpu_torch/ops/
cutpursuit_band.py) against the JAX package's band solver and the exact
max-flow solver, on the CPU. Inputs come from seeds with numpy; JAX runs on
the CPU as its own tests run it, the port with device="cpu".

The JAX solver keeps its weights in bf16, the port in f32 (both add the
JAX pad rows' term to the first covariance). So labels are compared only
where the weights are exact in bf16 and the clusters planted, and otherwise
energy, component count and OOA, each with its tolerance."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.ops import cutpursuit as cp_exact
from superpoint_graph_tpu.ops import cutpursuit_band as band_j
from superpoint_graph_tpu_torch.ops import cutpursuit_band as band_t
from tests.test_cutpursuit import grid_graph, partition_energy

ACCEPTS = {"global": {}, "region": {"max_iter": 16}}


# ---------------------------------------------------------------- Morton
@pytest.mark.parametrize("n,extent", [(500, 1.0), (20_000, 50.0)])
def test_morton_order_matches_jax(n, extent):
    """The host permutation equals the JAX one (same uint64 arithmetic)."""
    xyz = (np.random.RandomState(n).rand(n, 3) * extent).astype(np.float32)
    np.testing.assert_array_equal(band_t.morton_order(xyz),
                                  band_j.morton_order(xyz))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_morton_perm_device_matches_jax(seed):
    """The device permutation (f32 quantisation, one int64 key, stable
    sort) equals the JAX one (two int32 halves, 2-key sort), on a cloud with
    duplicated points, so equal codes keep their index order in both."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(5000, 3) * [4.0, 3.0, 2.5] + 100.0).astype(np.float32)
    xyz[4000:] = xyz[rng.randint(0, 4000, 1000)]
    got = band_t.morton_perm_device(torch.from_numpy(xyz)).numpy()
    want = np.asarray(band_j.morton_perm_device(xyz))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- planted
@pytest.mark.parametrize("morton", [False, True])
@pytest.mark.parametrize("accept", sorted(ACCEPTS))
def test_planted_clusters_identical_to_jax(accept, morton):
    """Two planted clusters on an 8 x 12 grid, weights 1 (exact in bf16):
    the port's in_component is the JAX solver's, label for label, in input
    order and in Morton order (grid coordinates as xyz), and both recover
    the clusters."""
    h, w = 8, 12
    src, tgt = grid_graph(h, w)
    ew = np.ones(len(src))
    rng = np.random.RandomState(0)
    f = np.zeros((h * w, 2), np.float32)
    gt = (np.arange(h * w).reshape(h, w) % w >= w // 2).ravel()
    f[gt] = [1.0, 0.5]
    f += rng.randn(h * w, 2).astype(np.float32) * 0.02
    kw = dict(ACCEPTS[accept], accept=accept)
    if morton:
        ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
        kw["xyz"] = np.c_[ij.reshape(2, -1).T, np.zeros(h * w)].astype(
            np.float32)
    comps, got = band_t.cutpursuit_band(f, src, tgt, ew, 0.1, device="cpu",
                                        **kw)
    _, want = band_j.cutpursuit_band(f, src, tgt, ew, 0.1, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(comps) == 2
    assert np.array_equal(got == got[np.flatnonzero(gt)[0]], gt)


# ---------------------------------------------------------------- fields
def _field(kind, seed):
    """The random piecewise fields of tests/test_cutpursuit_tpu.py:
    'energy_close' of TestCutPursuitBand.test_energy_close_to_exact,
    'region' of TestRegionAccept.test_region_not_worse_than_global."""
    if kind == "energy_close":
        h = w = 10
        rng = np.random.RandomState(seed)
        width = w // 3 + 1
    else:
        h = w = 14
        rng = np.random.RandomState(100 + seed)
        width = 4
    src, tgt = grid_graph(h, w)
    f = rng.rand(h * w, 4).astype(np.float32)
    band = ((np.arange(h * w).reshape(h, w) % w) // width).ravel()
    f += np.stack([band == i for i in range(4)], 1).astype(np.float32) * 1.5
    return f, src, tgt, np.ones(len(src), np.float32), 0.3


FIELDS = ["energy_close", "region"]
SEEDS = range(5)


@pytest.mark.parametrize("kind", FIELDS)
@pytest.mark.parametrize("accept", sorted(ACCEPTS))
def test_energy_matches_jax_and_exact(kind, accept):
    """Full solve (merge included), 5 seeds: port/JAX energy within 1 ±
    0.05 on each seed and 1 ± 0.02 on the mean; port/exact < 1.10 on the
    mean (the JAX package's own bound)."""
    to_jax, to_exact = [], []
    for seed in SEEDS:
        f, src, tgt, ew, reg = _field(kind, seed)
        kw = dict(ACCEPTS[accept], accept=accept)
        _, got = band_t.cutpursuit_band(f, src, tgt, ew, reg, device="cpu",
                                        **kw)
        _, want = band_j.cutpursuit_band(f, src, tgt, ew, reg, **kw)
        _, exact = cp_exact.cutpursuit(f, src, tgt, ew, reg)
        e = partition_energy(f, got, src, tgt, ew, reg)
        to_jax.append(e / partition_energy(f, want, src, tgt, ew, reg))
        to_exact.append(e / partition_energy(f, exact, src, tgt, ew, reg))
    assert max(abs(r - 1.0) for r in to_jax) <= 0.05, to_jax
    assert abs(np.mean(to_jax) - 1.0) <= 0.02, to_jax
    assert np.mean(to_exact) < 1.10, to_exact


def _solve(f, src, tgt, ew, reg, accept, **kw):
    _, ic = band_t.cutpursuit_band(f, src, tgt, ew, reg, merge=False,
                                   accept=accept, device="cpu", **kw)
    return ic, band_t.LAST_SOLVE_STATS["energy"]


@pytest.mark.parametrize("kind", FIELDS)
def test_region_not_worse_than_global(kind):
    """Region accept (max_iter 16) is never worse than global by more than
    5%, on 5 seeds (no merge step)."""
    ratios = []
    for seed in SEEDS:
        f, src, tgt, ew, reg = _field(kind, seed)
        ic_r, _ = _solve(f, src, tgt, ew, reg, "region", max_iter=16)
        ic_g, _ = _solve(f, src, tgt, ew, reg, "global")
        ratios.append(partition_energy(f, ic_r, src, tgt, ew, reg)
                      / partition_energy(f, ic_g, src, tgt, ew, reg))
    assert max(ratios) < 1.05, ratios


@pytest.mark.parametrize("kind", FIELDS)
@pytest.mark.parametrize("accept", sorted(ACCEPTS))
def test_tracked_energy_matches_recomputed(kind, accept):
    """The solver's energy (the global accept's recomputed one, the region
    accept's running sum) is within 2% of the returned labels' energy."""
    for seed in SEEDS:
        f, src, tgt, ew, reg = _field(kind, seed)
        ic, e_tracked = _solve(f, src, tgt, ew, reg, accept, **ACCEPTS[accept])
        e_true = partition_energy(f, ic, src, tgt, ew, reg)
        assert abs(e_tracked - e_true) <= 0.02 * e_true + 1e-4, (
            seed, e_tracked, e_true)


@pytest.mark.parametrize("kind", FIELDS)
def test_stop_tol_zero_matches_default(kind):
    """stop_tol=0 continues exactly while any region was accepted: labels
    and energy identical to the default."""
    for seed in SEEDS:
        f, src, tgt, ew, reg = _field(kind, seed)
        ic_a, e_a = _solve(f, src, tgt, ew, reg, "region", max_iter=16)
        ic_b, e_b = _solve(f, src, tgt, ew, reg, "region", max_iter=16,
                           stop_tol=0.0)
        np.testing.assert_array_equal(ic_a, ic_b)
        assert e_a == e_b


# ---------------------------------------------------------------- CC
def _scipy_min_labels(n, src, tgt):
    """Each vertex's least vertex id in its component (scipy)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(src)), (src, tgt)), shape=(n, n))
    _, lab = connected_components(g, directed=False)
    least = np.full(lab.max() + 1, n)
    np.minimum.at(least, lab, np.arange(n))
    return least[lab]


def _cc(key, src, tgt, **kw):
    s, t = np.r_[src, tgt], np.r_[tgt, src]
    return band_t.cc_labels(torch.from_numpy(key), torch.from_numpy(s),
                            torch.from_numpy(t), torch.ones(len(s)), **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cc_labels_match_scipy(seed):
    """On random graphs with random keys, the CC labels are scipy's
    components of the same-key edges, each labelled by its least vertex."""
    rng = np.random.RandomState(seed)
    n = 3000
    src, tgt = rng.randint(0, n, (2, 2500))
    key = rng.randint(0, 3, n).astype(np.int64)
    lab, rounds, capped = _cc(key, src, tgt)
    same = key[src] == key[tgt]
    np.testing.assert_array_equal(
        lab.numpy(), _scipy_min_labels(n, src[same], tgt[same]))
    assert not capped and rounds < 24


def _random_path(n=5000):
    order = np.random.RandomState(7).permutation(n)
    return order[:-1], order[1:]


def test_cc_labels_long_path():
    """A 5,000-vertex path laid out in random order, the worst case of label
    propagation (428 rounds here, more than the cap CC_ROUNDS): one
    component labelled by its least vertex once the cap allows; with
    cc_rounds=1 the cap binds and is reported."""
    src, tgt = _random_path()
    key = np.zeros(5000, np.int64)
    lab, rounds, capped = _cc(key, src, tgt, cc_rounds=1000)
    np.testing.assert_array_equal(lab.numpy(), np.zeros(5000))
    assert not capped and rounds > band_t.CC_ROUNDS
    lab, rounds, capped = _cc(key, src, tgt, cc_rounds=1)
    assert capped and rounds == 1 and lab.numpy().any()


def test_solver_counts_capped_cc():
    """A binding cc_rounds shows in LAST_SOLVE_STATS['cc_capped'], and
    cc_rounds_max reports the longest CC call."""
    src, tgt = _random_path()
    f = np.zeros((5000, 3), np.float32)
    f[:, 0] = np.arange(5000) >= 2500
    ew = np.ones(len(src), np.float32)
    band_t.cutpursuit_band(f, src, tgt, ew, 0.1, device="cpu", cc_rounds=1)
    assert band_t.LAST_SOLVE_STATS["cc_capped"] > 0
    band_t.cutpursuit_band(f, src, tgt, ew, 0.1, device="cpu",
                           cc_rounds=1000)
    stats = band_t.LAST_SOLVE_STATS
    assert stats["cc_capped"] == 0
    assert stats["cc_rounds_max"] > 1 and stats["iters"] >= 1


# ---------------------------------------------------------------- room
@pytest.fixture(scope="module")
def pruned_room():
    """A pruned synthetic room of 1,948 voxels (the JAX device path pads it
    to 2,048 rows, within its square band geometry)."""
    from superpoint_graph_tpu.data.synthetic import synthetic_room
    from superpoint_graph_tpu.ops.voxel import prune

    xyz, rgb, labels, objects = synthetic_room(
        np.random.RandomState(3), 4000, noise=0.008, clutter_blobs=True)
    xyz, rgb, hist, _ = prune(xyz, 0.15, rgb, labels, objects, 6,
                              int(objects.max()) + 1)
    return xyz, rgb, hist


def test_device_path_matches_jax(pruned_room):
    """`_cutpursuit_device_path` (device solve over the kNN tables, host
    merge) against the JAX one on the same pruned room: energy within 3%,
    component count within 15%, OOA against the voxels' labels within 1
    point. Both energies on the JAX package's features and graph."""
    from superpoint_graph_tpu import pipeline as pj
    from superpoint_graph_tpu.learn.metrics import compute_OOA
    from superpoint_graph_tpu_torch import pipeline as pt

    xyz, rgb, hist = pruned_room
    cfg_j = pj.PartitionConfig()
    g_j, geof_j, dev_j = pj.partition_features(xyz, cfg_j, return_device=True)
    assert dev_j["n_pad"] == 2048
    comps_j, ic_j = pj._cutpursuit_device_path(xyz, rgb, g_j, dev_j, cfg_j)
    g_t, _, dev_t = pt.partition_features(xyz, pt.PartitionConfig(),
                                          device="cpu", return_device=True)
    comps_t, ic_t, times = pt._cutpursuit_device_path(
        xyz, rgb, g_t, dev_t, pt.PartitionConfig())
    assert set(times) == {"solve", "merge"}
    assert band_t.LAST_SOLVE_STATS["cc_capped"] == 0

    feats = pj.assemble_partition_features(geof_j, rgb, cfg_j)
    w = pj.edge_weights(g_j["distances"], cfg_j.lambda_edge_weight)
    src = g_j["source"].astype(np.int64)
    tgt = g_j["target"].astype(np.int64)
    e_t, e_j = (partition_energy(feats, ic, src, tgt, w, cfg_j.reg_strength)
                for ic in (ic_t, ic_j))
    assert abs(e_t / e_j - 1.0) <= 0.03, (e_t, e_j)
    assert abs(len(comps_t) / len(comps_j) - 1.0) <= 0.15, (
        len(comps_t), len(comps_j))
    ooa_t, ooa_j = (compute_OOA(c, hist[:, 1:]) for c in (comps_t, comps_j))
    assert abs(ooa_t - ooa_j) <= 1.0, (ooa_t, ooa_j)


# ---------------------------------------------------------------- metrics
def test_quality_metrics_match_jax(pruned_room):
    """The port's OOA equals the JAX package's; disconnected_labels counts
    the labels split in two by the graph."""
    from superpoint_graph_tpu.learn.metrics import compute_OOA as ooa_j
    from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                          disconnected_labels)
    from superpoint_graph_tpu_torch.ops.components import group_components

    _, _, hist = pruned_room
    rng = np.random.RandomState(0)
    in_comp = rng.randint(0, 40, len(hist))
    comps = group_components(in_comp)
    assert compute_OOA(comps, hist[:, 1:]) == pytest.approx(
        ooa_j(comps, hist[:, 1:]), abs=1e-12)
    src, tgt = grid_graph(4, 4)
    assert disconnected_labels(np.zeros(16, int), src, tgt) == 0
    split = (np.arange(16) % 4 == 0).astype(int)  # column 0 vs the rest
    assert disconnected_labels(split, src, tgt) == 0
    split[15] = 1  # a lone corner vertex in label 1
    assert disconnected_labels(split, src, tgt) == 1


def test_seg_sum_independent_of_order():
    """The solver's segment sums add each segment's rows in their input
    order (sorted by segment, no atomics): the same bits from a presorted
    input, and the float64 sums within f32 rounding of each segment, small
    segments among a large one included; an empty segment sums to zero."""
    rng = np.random.RandomState(0)
    n_rows, n_seg = 5000, 300
    data = (rng.randn(n_rows, 7) * np.exp(rng.randn(n_rows, 1) * 3)).astype(
        np.float32)
    seg = rng.randint(1, n_seg, n_rows)  # segment 0 stays empty
    seg[:3000] = 7  # one large segment among small ones
    data[:3000] *= 1e4
    want = np.zeros((n_seg, 7))
    np.add.at(want, seg, data.astype(np.float64))
    scale = np.zeros((n_seg, 7))
    np.add.at(scale, seg, np.abs(data).astype(np.float64))
    got = band_t._Segments(torch.from_numpy(seg), n_seg).sum(
        torch.from_numpy(data)).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    np.testing.assert_array_equal(got[0], np.zeros(7))
    order = np.argsort(seg, kind="stable")
    presorted = band_t._Segments(torch.from_numpy(seg[order]), n_seg,
                                 presorted=True)
    np.testing.assert_array_equal(
        presorted.sum(torch.from_numpy(data[order])).numpy(), got)


def test_jax_pad_rows_match_jax_callers():
    """The pad-row counts are the JAX callers' n_pad less n: the device
    path's kNN bucketing, and the host-array path's band blocks."""
    from superpoint_graph_tpu.ops.knn import compute_graph_nn_2

    for n in (1500, 2469):
        xyz = np.random.RandomState(n).rand(n, 3).astype(np.float32)
        *_, dev = compute_graph_nn_2(xyz, 2, 4, return_device=True)
        assert n + band_t.jax_pad_rows(n) == dev["n_pad"]
    f = np.random.RandomState(1).rand(3000, 2).astype(np.float32)
    src, tgt = np.arange(2999), np.arange(1, 3000)
    for n in (700, 3000):
        band_j.cutpursuit_band(f[:n], src[:n - 1], tgt[:n - 1],
                               np.ones(n - 1), 0.1)
        assert (n + band_t.jax_pad_rows(n, host_arrays=True)
                == band_j.LAST_SOLVE_STATS["n_pad"])
    assert band_t.jax_pad_rows(202_962) == 262_144 - 202_962
    assert band_t.jax_pad_rows(200_000, host_arrays=True) == 262_144 - 200_000
