"""The port's giant-cloud merge and graph blocks against the JAX package,
on the CPU: the merge step's device reduction (superpoint_graph_tpu_torch/
ops/merge_device.py), the device superpoint graph (graph/spg_device.py)
and `relabel_connected` (ops/components.py). Inputs come from seeds with
numpy; JAX runs on the CPU as its own tests run it, the port with
device="cpu" or CPU tensors. Tolerances are stated in each test."""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.data.synthetic import synthetic_room


# ---------------------------------------------------------------- merge
def _dyadic_regions(seed, n=3000, n_comp=400, n_edges=20_000):
    """Features, weights and a labelling with values k/8 and k/4: every sum
    in any order is exact in f32."""
    rng = np.random.RandomState(seed)
    f = (rng.randint(0, 8, (n, 3)) / 8).astype(np.float32)
    comp = rng.randint(0, n_comp, n)
    src = rng.randint(0, n, n_edges)
    tgt = rng.randint(0, n, n_edges)
    w = (rng.randint(1, 8, n_edges) / 4).astype(np.float32)
    return f, comp, src, tgt, w, n_comp


@pytest.mark.parametrize("jax_compact", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_regions_device_matches_jax(seed, jax_compact, monkeypatch):
    """On dyadic features and weights (exact sums) the port's region roots
    equal the JAX merge_regions_device's, by either of its two reductions
    (the cross-edge compaction and the full sort; the port always
    compacts), and the relabelled partition the host merge_regions'."""
    import jax.numpy as jnp

    from superpoint_graph_tpu.ops import merge_device as md_j
    from superpoint_graph_tpu_torch.ops import merge_device as md_t
    from superpoint_graph_tpu_torch.ops.cutpursuit import (
        _densify_first_occurrence, merge_regions)

    if jax_compact:
        monkeypatch.setattr(md_j, "COMPACT_THRESHOLD", 10)
    f, comp, src, tgt, w, n_comp = _dyadic_regions(seed)
    t = torch.from_numpy
    got = md_t.merge_regions_device(t(f), torch.ones(len(f)), t(comp),
                                    t(src), t(tgt), t(w), n_comp, 0.3)
    want = md_j.merge_regions_device(
        jnp.asarray(f), jnp.ones(len(f)), jnp.asarray(comp.astype(np.int32)),
        jnp.asarray(src.astype(np.int32)), jnp.asarray(tgt.astype(np.int32)),
        jnp.asarray(w), n_comp, 0.3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        _densify_first_occurrence(got[comp]),
        merge_regions(f, np.ones(len(f)), comp, src, tgt, w, 0.3))


def test_pair_stats_match_jax():
    """Region sums, masses and deduplicated pairs with summed weights equal
    the JAX reduction's (dyadic values: exact)."""
    import jax.numpy as jnp

    from superpoint_graph_tpu.ops.merge_device import pair_stats as ps_j
    from superpoint_graph_tpu_torch.ops.merge_device import pair_stats as ps_t

    f, comp, src, tgt, w, n_comp = _dyadic_regions(4)
    nw = (np.random.RandomState(4).randint(0, 3, len(f))).astype(np.float32)
    t = torch.from_numpy
    got = ps_t(t(f), t(nw), t(comp), t(src), t(tgt), t(w), n_comp)
    want = ps_j(jnp.asarray(f), jnp.asarray(nw),
                jnp.asarray(comp.astype(np.int32)),
                jnp.asarray(src.astype(np.int32)),
                jnp.asarray(tgt.astype(np.int32)), jnp.asarray(w), n_comp)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- SPG
def _spg_inputs(seed):
    """A room, its 6-NN table, components from a coarse xy grid (walls and
    floor cut into cells), label ids and their one-hot histograms."""
    rng = np.random.RandomState(seed)
    xyz, _, lab, _ = synthetic_room(rng, n_points=3000)
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, 1, kind="stable")[:, :6]
    cell = np.floor(xyz[:, 0] * 2) + 10 * np.floor(xyz[:, 1] * 2)
    in_comp = np.unique(cell, return_inverse=True)[1].ravel()
    return xyz, idx, in_comp, lab


# Float keys are held at rtol 1e-5 plus an atol of 1e-5 of the key's
# largest value, but for the keys made by f32 cancellation: the superedge
# std (E[x^2] - E[x]^2) and the surface and volume (the analytic
# eigenvalues' small ones), and ratios of those. There JAX and the port
# each differ from the f64 host graph by a few percent relative (a few
# 1e-4 of the key's largest value), in different places, so they are held
# at an atol of 5e-3 of the largest value.
_CANCEL_KEYS = ("sp_surface", "sp_volume", "se_delta_std",
                "se_surface_ratio", "se_volume_ratio")


def _assert_graphs_close(got, want):
    assert got.keys() == want.keys()
    for key, val in want.items():
        a, b = np.asarray(got[key]), np.asarray(val)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype.kind in "ui":
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key != "is_nn":
            scale = float(np.abs(b).max(initial=0.0))
            frac = 5e-3 if key in _CANCEL_KEYS else 1e-5
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=frac * scale,
                                       err_msg=key)


@pytest.mark.parametrize("d_max", [0.0, 0.15])
@pytest.mark.parametrize("hist", [False, True])
def test_sp_graph_device_matches_jax(d_max, hist):
    """compute_sp_graph_device against the JAX one key by key: same keys,
    shapes and dtypes; integer keys equal; float keys within 1e-5 (see
    _CANCEL_KEYS)."""
    import jax.numpy as jnp

    from superpoint_graph_tpu.graph.spg_device import (
        compute_sp_graph_device as spg_j)
    from superpoint_graph_tpu_torch.graph.spg_device import (
        compute_sp_graph_device as spg_t)

    xyz, idx, in_comp, lab = _spg_inputs(3)
    labels = np.eye(6, dtype=np.uint32)[lab] if hist else lab
    got = spg_t(xyz, d_max, in_comp, labels, 5, idx_adj=idx, device="cpu")
    want = spg_j(xyz, d_max, in_comp, None, labels, 5,
                 idx_adj=jnp.asarray(idx.astype(np.int32)))
    _assert_graphs_close(got, want)


def test_sp_graph_device_matches_host_graph():
    """The device graph equals the port's host compute_sp_graph on the same
    kNN support edges (keys, superedge order, counts; floats as above,
    against the host graph's f64 sums)."""
    from superpoint_graph_tpu_torch.graph.spg import compute_sp_graph
    from superpoint_graph_tpu_torch.graph.spg_device import (
        compute_sp_graph_device)

    xyz, idx, in_comp, lab = _spg_inputs(8)
    got = compute_sp_graph_device(xyz, 0.0, in_comp, lab, 5, idx_adj=idx,
                                  device="cpu")
    want = compute_sp_graph(xyz, 0.0, in_comp, lab, 5, knn_edges=(
        np.repeat(np.arange(len(xyz)), 6), idx.ravel()), device="cpu")
    _assert_graphs_close(got, want)


def test_relabel_connected_matches_jax():
    """A label on two pieces of a path graph splits in two; with cutoff 3
    the 2-vertex pieces fuse and stay connected; both equal the JAX
    function's output."""
    from superpoint_graph_tpu.ops.components import relabel_connected as rj
    from superpoint_graph_tpu_torch.ops.components import (
        relabel_connected as rt)

    src = np.arange(5, dtype=np.int64)
    tgt = np.arange(1, 6, dtype=np.int64)
    ic = np.array([0, 0, 1, 1, 0, 0])
    for cutoff in (0, 3):
        comps_t, out_t = rt(6, src, tgt, ic, cutoff)
        comps_j, out_j = rj(6, src, tgt, ic, cutoff)
        np.testing.assert_array_equal(out_t, out_j)
        assert [c.tolist() for c in comps_t] == [c.tolist() for c in comps_j]
    _, out = rt(6, src, tgt, ic, 0)
    assert out.max() == 2 and out[0] == out[1] != out[4] == out[5]
