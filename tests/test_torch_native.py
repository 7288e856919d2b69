"""The port's host library (csrc/spgt_native.cpp via
superpoint_graph_tpu_torch/native.py) against the JAX package's library
(native/, superpoint_graph_tpu.native) and against its plain versions, on
the same seeded inputs; and the port's call sites of the library.

Integer outputs (voxel order, histograms, components, subgraphs, matchings,
cut-pursuit labels) must be equal; float outputs (voxel means, geof) within
2 ulp of the JAX library's. The plain versions: `prune_plain` (bit-equal),
`relabel_connected_plain` (equal at cutoff 0; above it the library fuses in
renumbered rounds and is compared library to library),
`greedy_matching_plain` (equal), the port's torch geof (within 1e-4 on
neighbourhoods that are not degenerate) and the exact scipy solver (energy
within 5%, the JAX native test's bound).
"""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu import native as native_j
from superpoint_graph_tpu_torch import native as native_t
from superpoint_graph_tpu_torch.ops import _build

pytestmark = pytest.mark.skipif(
    not native_j.available(), reason="the JAX package's library not built")


def _ulp(a, b):
    """Units in the last place between two float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return np.abs(ia - ib)


def _fuse_graph(n):
    """The seeded recipe of the cutoff-fuse check: n vertices, 5n random
    edges, labels of ~40 vertices each."""
    rs = np.random.RandomState(0)
    src = rs.randint(0, n, 5 * n)
    tgt = rs.randint(0, n, 5 * n)
    labels = rs.randint(0, n // 40, n)
    return src, tgt, labels


def _fuse_stage_jax(monkeypatch, n, src, tgt, in_comp, cutoff):
    """The JAX room path's fuse stage (pipeline.py:137-147, inside
    `_cutpursuit_device_path`) on `in_comp`: the device solve and the merge
    step are replaced by `in_comp` itself."""
    import jax.numpy as jnp

    from superpoint_graph_tpu import pipeline as pj
    from superpoint_graph_tpu.ops import cutpursuit as cpj
    from superpoint_graph_tpu.ops import cutpursuit_band as cbj

    monkeypatch.setattr(cbj, "cutpursuit_band_device",
                        lambda *a, **k: in_comp.copy())
    monkeypatch.setattr(cpj, "merge_regions", lambda f, nw, ic, *a: ic)
    dev = {"n_pad": n, "geof": jnp.zeros((n, 4), jnp.float32),
           "idx": jnp.zeros((n, 5), jnp.int32),
           "d2": jnp.ones((n, 5), jnp.float32)}
    graph_nn = {"source": src, "target": tgt,
                "distances": np.ones(len(src), np.float32)}
    cfg = pj.PartitionConfig(dataset="sema3d", cp_cutoff=cutoff)
    _, ic = pj._cutpursuit_device_path(np.zeros((n, 3), np.float32), None,
                                       graph_nn, dev, cfg)
    return ic


def _fuse_stage_port(monkeypatch, n, src, tgt, in_comp, cutoff):
    """The port's room fuse stage (pipeline.py, `_cutpursuit_device_path`)
    on `in_comp`, the solve and the merge replaced as in the JAX one."""
    from superpoint_graph_tpu_torch import pipeline as pt

    monkeypatch.setattr(pt, "cutpursuit_band_device",
                        lambda *a, **k: in_comp.copy())
    monkeypatch.setattr(pt, "merge_regions", lambda f, nw, ic, *a: ic)
    dev = {"geof": torch.zeros((n, 4)),
           "idx": torch.zeros((n, 5), dtype=torch.int64),
           "d2": torch.ones((n, 5))}
    graph_nn = {"source": src, "target": tgt,
                "distances": np.ones(len(src), np.float32)}
    cfg = pt.PartitionConfig(dataset="sema3d", cp_cutoff=cutoff)
    _, ic, _ = pt._cutpursuit_device_path(np.zeros((n, 3), np.float32), None,
                                          graph_nn, dev, cfg)
    return ic


@pytest.mark.parametrize("n,cutoff", [(5_000, 25), (200_000, 25),
                                      (5_000, 0), (200_000, 0)])
def test_cutoff_fuse_matches_jax(monkeypatch, n, cutoff):
    """relabel_connected and the room's cp_cutoff fuse give the JAX
    package's components (its library's sequential-round fuse), not the
    vectorised `_fuse_small`'s: equal in_component arrays."""
    from superpoint_graph_tpu.ops.components import relabel_connected as rj
    from superpoint_graph_tpu_torch.ops.components import (
        relabel_connected as rt)

    src, tgt, labels = _fuse_graph(n)
    want = rj(n, src, tgt, labels, cutoff)[1]
    np.testing.assert_array_equal(rt(n, src, tgt, labels, cutoff)[1], want)
    active = labels[src] == labels[tgt]
    np.testing.assert_array_equal(
        native_t.connected_comp(n, src, tgt, active, cutoff)[1],
        native_j.connected_comp(n, src, tgt, active, cutoff)[1])
    in_comp = rj(n, src, tgt, labels, 0)[1].astype(np.int64)
    np.testing.assert_array_equal(
        _fuse_stage_port(monkeypatch, n, src, tgt, in_comp, cutoff),
        _fuse_stage_jax(monkeypatch, n, src, tgt, in_comp, cutoff))


@pytest.mark.parametrize("voxel,n_labels,n_objects,seed",
                         [(0.25, 12, 49, 0), (0.1, 0, 0, 1),
                          (0.5, 7, 0, 2), (0.03, 5, 3, 3)])
def test_prune_matches_jax_library_and_plain(voxel, n_labels, n_objects,
                                             seed):
    from superpoint_graph_tpu_torch.ops.voxel import prune_plain

    rs = np.random.RandomState(seed)
    n = 50_000
    xyz = (rs.rand(n, 3) * [10, 6, 3] - [5, 0, 1]).astype(np.float32)
    rgb = rs.randint(0, 256, (n, 3)).astype(np.uint8)
    labels = rs.randint(0, n_labels + 1, n) if n_labels else None
    objects = rs.randint(0, n_objects + 1, n) if n_objects else None
    got = native_t.prune(xyz, voxel, rgb, labels, objects, n_labels,
                         n_objects)
    want = native_j.prune(xyz, voxel, rgb, labels, objects, n_labels,
                          n_objects)
    plain = prune_plain(xyz, voxel, rgb, labels, objects, n_labels,
                        n_objects)
    assert _ulp(got[0], want[0]).max() <= 2
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, p)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_prune_plain_keeps_prune_host_contract():
    """prune_plain against the JAX package's prune_host on points away
    from every voxel face (where f32 and float64 keys agree): the same
    voxels in the same order, equal histograms, means within f32 rounding."""
    from superpoint_graph_tpu.ops.voxel import prune_host
    from superpoint_graph_tpu_torch.ops.voxel import prune_plain

    rs = np.random.RandomState(4)
    n, voxel = 30_000, 0.25
    cells = rs.randint(0, 40, (n, 3))
    xyz = ((cells + 0.25 + 0.5 * rs.rand(n, 3)) * voxel).astype(np.float32)
    rgb = rs.randint(0, 256, (n, 3)).astype(np.uint8)
    labels = rs.randint(0, 9, n)
    got = prune_plain(xyz, voxel, rgb, labels, None, 8, 0)
    want = prune_host(xyz, voxel, rgb, labels, None, 8, 0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert np.abs(got[1].astype(int) - want[1].astype(int)).max() <= 1
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


def test_compute_geof_matches_jax_library_and_plain():
    from superpoint_graph_tpu_torch.ops.geof import compute_geof

    rs = np.random.RandomState(5)
    n, k = 2_000, 15
    xyz = rs.randn(n, 3).astype(np.float32) * [3.0, 1.0, 0.3]
    xyz = xyz.astype(np.float32)
    nbrs = np.stack([rs.choice(np.delete(np.arange(n), i), k, replace=False)
                     for i in range(n)]).astype(np.uint32)
    got = native_t.compute_geof(xyz, nbrs, k)
    want = native_j.compute_geof(xyz, nbrs, k)
    assert _ulp(got, want).max() <= 2
    plain = compute_geof(torch.from_numpy(xyz),
                         torch.from_numpy(nbrs.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_connected_comp_matches_jax_library_and_plain(seed):
    from superpoint_graph_tpu_torch.ops.components import (
        relabel_connected, relabel_connected_plain)

    rs = np.random.RandomState(seed)
    n = 3_000 + 1_000 * seed
    src = rs.randint(0, n, 3 * n)
    tgt = rs.randint(0, n, 3 * n)
    labels = rs.randint(0, n // (10 + 10 * seed), n)
    for cutoff in (0, 3, 12):
        active = labels[src] == labels[tgt]
        got = native_t.connected_comp(n, src, tgt, active, cutoff)
        want = native_j.connected_comp(n, src, tgt, active, cutoff)
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) == len(want[0])
    np.testing.assert_array_equal(
        relabel_connected(n, src, tgt, labels, 0)[1],
        relabel_connected_plain(n, src, tgt, labels, 0)[1])


@pytest.mark.parametrize("size,seed", [(100, 1), (1_000, 2), (5_000, 3)])
def test_random_subgraph_matches_jax_library(size, seed):
    rs = np.random.RandomState(seed)
    n = 6_000
    src = rs.randint(0, n, 18_000)
    tgt = rs.randint(0, n, 18_000)
    got = native_t.random_subgraph(n, src, tgt, size, seed=seed)
    want = native_j.random_subgraph(n, src, tgt, size, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    esel, vsel = got
    assert vsel.sum() == size and (esel == (vsel[src] & vsel[tgt])).all()


@pytest.mark.parametrize("seed,cutoff", [(0, 0), (1, 0), (2, 4)])
def test_cutpursuit_matches_jax_library_and_exact(seed, cutoff):
    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy, cutpursuit
    from tests.test_cutpursuit import grid_graph

    h, w = 12, 14
    src, tgt = grid_graph(h, w)
    rs = np.random.RandomState(seed)
    ew = (0.5 + rs.rand(len(src))).astype(np.float32)
    f = rs.rand(h * w, 4).astype(np.float32)
    band = ((np.arange(h * w).reshape(h, w) % w) // 4).ravel()
    f += np.eye(4, dtype=np.float32)[np.minimum(band, 3)] * 1.5
    got = native_t.cutpursuit(f, src, tgt, ew, 0.3, cutoff=cutoff)[1]
    want = native_j.cutpursuit(f, src, tgt, ew, 0.3, cutoff=cutoff)[1]
    np.testing.assert_array_equal(got, want)

    def energy(ic):
        return _energy(f.astype(np.float64), np.ones(h * w),
                       ic.astype(np.int64), src, tgt, ew.astype(np.float64),
                       0.3)[0]

    exact = cutpursuit(f, src, tgt, ew, 0.3, cutoff=cutoff)[1]
    assert energy(got) <= energy(exact) * 1.05


@pytest.mark.parametrize("p,n_comp,seed", [(0, 4, 0), (1_000, 300, 1),
                                           (50_000, 20_000, 2)])
def test_greedy_matching_matches_jax_library_and_plain(p, n_comp, seed):
    from superpoint_graph_tpu_torch.ops.cutpursuit import (
        greedy_matching_plain)

    rs = np.random.RandomState(seed)
    a = rs.randint(0, n_comp, p)
    b = (a + 1 + rs.randint(0, n_comp - 1, p)) % n_comp
    got = native_t.greedy_matching(a, b, n_comp)
    np.testing.assert_array_equal(got,
                                  native_j.greedy_matching(a, b, n_comp))
    np.testing.assert_array_equal(got, greedy_matching_plain(a, b, n_comp))


def test_call_sites_go_through_the_library(monkeypatch):
    """The merge rounds, relabel_connected and a prune above
    PRUNE_DEVICE_MAX rows call the library (its call counts rise), and
    give what the plain versions give."""
    from superpoint_graph_tpu_torch.ops import voxel
    from superpoint_graph_tpu_torch.ops.components import (
        relabel_connected, relabel_connected_plain)
    from superpoint_graph_tpu_torch.ops.cutpursuit import merge_regions

    rs = np.random.RandomState(6)
    n = 4_000
    xyz = rs.rand(n, 3).astype(np.float32)
    monkeypatch.setattr(voxel, "PRUNE_DEVICE_MAX", n - 1)
    calls = native_t.prune.calls
    got = voxel.prune(xyz, 0.05, None, None, None, 0, 0, device="cpu")
    assert native_t.prune.calls == calls + 1
    for g, w in zip(got, voxel.prune_plain(xyz, 0.05, None, None, None, 0,
                                           0)):
        np.testing.assert_array_equal(g, w)

    src = np.repeat(np.arange(n), 4)
    tgt = rs.randint(0, n, 4 * n)
    ic = rs.randint(0, 200, n)
    calls = native_t.connected_comp.calls
    np.testing.assert_array_equal(relabel_connected(n, src, tgt, ic)[1],
                                  relabel_connected_plain(n, src, tgt, ic)[1])
    assert native_t.connected_comp.calls == calls + 1

    calls = native_t.greedy_matching.calls
    merge_regions(rs.rand(n, 3), np.ones(n), ic, src, tgt,
                  np.ones(len(src)), 0.01)
    assert native_t.greedy_matching.calls > calls


def test_host_build_is_keyed_by_compiler_and_machine(monkeypatch, tmp_path):
    """The library's name hashes the source, the flags, g++'s version and
    the machine: another machine name gives another library; a source g++
    refuses raises with g++'s output."""
    src = _build.CSRC_DIR / "spgt_native.cpp"
    gxx = _build.gxx_path()
    digest = _build._host_digest(src, gxx)
    monkeypatch.setattr(_build.platform, "machine", lambda: "other-arch")
    assert _build._host_digest(src, gxx) != digest
    monkeypatch.undo()
    assert _build._host_digest(src, gxx) == digest

    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.build_host("broken")
    assert not list((tmp_path / "_build").glob("*.so"))
