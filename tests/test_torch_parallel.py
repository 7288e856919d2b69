"""The port's collectives and sharded room partition (superpoint_graph_tpu_
torch/parallel/mesh.py, partition_shard.py's solver) on the CPU, a mesh of
D shards on the "cpu" device, against the port's single-device functions
and the JAX package's sharded ones on its virtual 8-device mesh; the
sharded kNN and giant-cloud partition are in test_torch_parallel_big.py.

A sum split into per-shard partial sums rounds in another order than one
sum, so a threshold decision of the solver can flip between shard counts:
across counts the sharded solve is held to the single-device one at a
label agreement above 0.999 and component counts within 2 (the JAX
package's bar, tests/test_parallel.py:123-127); one shard count repeats
bit for bit. Against the JAX solver: energy within 3% and component count
within 15% (tests/test_torch_cutpursuit.py::test_device_path_matches_jax)."""
import threading

import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
from superpoint_graph_tpu_torch.ops.cutpursuit import _energy
from superpoint_graph_tpu_torch.parallel import mesh as mesh_t
from superpoint_graph_tpu_torch.parallel import partition_shard as ps


def cpu_mesh(n: int):
    return mesh_t.make_mesh(devices=["cpu"] * n)


def energy(f, in_comp, src, tgt, w, reg):
    return _energy(np.asarray(f, np.float64), np.ones(len(f)),
                   np.asarray(in_comp, np.int64), np.asarray(src, np.int64),
                   np.asarray(tgt, np.int64), np.asarray(w, np.float64),
                   reg)[0]


def knn_host(xyz, k):
    """Exact kNN as numpy (the port's brute force: lower index first on
    ties, the point itself excluded): (idx int64, squared distances)."""
    from superpoint_graph_tpu_torch.ops.knn import knn

    idx, d2 = knn(torch.from_numpy(np.ascontiguousarray(xyz, np.float32)), k)
    return idx.numpy(), d2.numpy()


@pytest.fixture(scope="module")
def room_graph():
    """tests/test_parallel.py's 6,000-point room, k = 5 graph and
    features."""
    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(0), n_points=6000)
    idx, d2 = knn_host(xyz, 5)
    src = np.repeat(np.arange(len(xyz)), 5)
    tgt = idx.reshape(-1)
    dist = np.sqrt(d2.reshape(-1))
    w = (1.0 / (1.0 + dist / dist.mean())).astype(np.float32)
    feats = np.concatenate([xyz, rgb.astype(np.float32) / 255.0],
                           1).astype(np.float32)
    return xyz, feats, src, tgt, w


# ---------------------------------------------------------------- mesh
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_collectives(n_shards):
    """psum and pmin in shard order, all_gather in shard order, on plain
    lists and inside run_shards; each shard gets its own copy; a shard that
    raises stops the others at their next collective and its error comes
    out."""
    mesh = cpu_mesh(n_shards)
    assert mesh.size == n_shards and mesh.axis == "dp"
    rng = np.random.RandomState(n_shards)
    parts = [torch.as_tensor(rng.randn(5, 3).astype(np.float32))
             for _ in range(n_shards)]
    want_sum = parts[0].clone()
    for p in parts[1:]:
        want_sum = want_sum + p
    want_min = torch.stack(parts).min(0).values
    for got in mesh_t.psum(parts):
        assert torch.equal(got, want_sum)
    for got in mesh_t.pmin(parts):
        assert torch.equal(got, want_min)
    for got in mesh_t.all_gather(parts):
        assert torch.equal(got, torch.cat(parts))

    def body(shard, part):
        s = shard.psum(part.clone())
        s += 1.0  # a shard's own copy: the others must not see this
        return (s, shard.pmin(part), shard.all_gather(part[:shard.index + 1]),
                threading.get_ident())

    outs = mesh_t.run_shards(body, mesh, [(p,) for p in parts])
    assert len({o[3] for o in outs}) == n_shards
    for s, m, g, _ in outs:
        assert torch.equal(s, want_sum + 1.0)
        assert torch.equal(m, want_min)
        assert torch.equal(g, torch.cat([p[:i + 1]
                                         for i, p in enumerate(parts)]))

    def failing(shard, part):
        if shard.index == n_shards - 1:
            raise ValueError("shard failed")
        return shard.psum(part)

    with pytest.raises(ValueError, match="shard failed"):
        mesh_t.run_shards(failing, mesh, [(p,) for p in parts], timeout=60)


# ---------------------------------------------------------------- solver
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_solve_matches_single_device(room_graph, n_shards):
    """cutpursuit_band_sharded against the port's cutpursuit_band (the same
    pad rows) on the room: label agreement > 0.999, component counts within
    2; a second sharded run equal bit for bit; each shard holds its rows
    and the edges leaving them."""
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import cutpursuit_band

    xyz, feats, src, tgt, w = room_graph
    pad = ps.sharded_pad_rows(len(xyz), n_shards)
    comps_1, ic_1 = cutpursuit_band(feats, src, tgt, w, 0.1, xyz=xyz,
                                    max_iter=3, pad_rows=pad, device="cpu")
    runs = [ps.cutpursuit_band_sharded(feats, src, tgt, w, 0.1,
                                       cpu_mesh(n_shards), xyz=xyz,
                                       max_iter=3) for _ in range(2)]
    (comps_s, ic_s), (_, ic_s2) = runs
    assert (ic_1 == ic_s).mean() > 0.999
    assert abs(len(comps_1) - len(comps_s)) <= 2
    np.testing.assert_array_equal(ic_s, ic_s2)
    rows = ps.LAST_SHARD_STATS["solve_rows"]
    assert sum(rows) == len(xyz) and max(rows) <= -(-len(xyz) // n_shards)
    assert sum(ps.LAST_SHARD_STATS["solve_edges"]) == 2 * len(src)


def test_sharded_solve_one_shard_is_single_device(room_graph):
    """On one shard every collective is the identity: the labels are
    cutpursuit_band's with the same pad rows, bit for bit."""
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import cutpursuit_band

    xyz, feats, src, tgt, w = room_graph
    for accept in ("global", "region"):
        _, ic_1 = cutpursuit_band(feats, src, tgt, w, 0.1, xyz=xyz,
                                  accept=accept, max_iter=4,
                                  pad_rows=ps.sharded_pad_rows(len(xyz), 1),
                                  device="cpu")
        _, ic_s = ps.cutpursuit_band_sharded(feats, src, tgt, w, 0.1,
                                             cpu_mesh(1), xyz=xyz,
                                             accept=accept, max_iter=4)
        np.testing.assert_array_equal(ic_1, ic_s)


def test_sharded_solve_cutoff_and_node_weights():
    """tests/test_parallel.py's two-block cloud with node weights and a
    cutoff of 10: the sharded solve on 8 shards against the single-device
    one, the same bar."""
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import cutpursuit_band

    rng = np.random.RandomState(0)
    n = 2000
    xyz = rng.rand(n, 3).astype(np.float32)
    xyz[: n // 2, 0] += 3.0
    idx, _ = knn_host(xyz, 4)
    src, tgt = np.repeat(np.arange(n), 4), idx.reshape(-1)
    w = np.ones(len(src), np.float32)
    nw = rng.rand(n).astype(np.float32) + 0.5
    kw = dict(cutoff=10, node_weight=nw, xyz=xyz, max_iter=2)
    comps_1, ic_1 = cutpursuit_band(xyz, src, tgt, w, 0.2, device="cpu",
                                    pad_rows=ps.sharded_pad_rows(n, 8), **kw)
    comps_8, ic_8 = ps.cutpursuit_band_sharded(xyz, src, tgt, w, 0.2,
                                               cpu_mesh(8), **kw)
    assert (ic_1 == ic_8).mean() > 0.999
    assert abs(len(comps_1) - len(comps_8)) <= 2
    assert min(len(c) for c in comps_8) >= 10 or len(comps_8) == 1


def test_sharded_solve_matches_jax(room_graph):
    """The port's sharded solve (8 shards) against the JAX
    cutpursuit_band_sharded on make_mesh(8), the same room and settings:
    energy within 3%, component count within 15%."""
    from superpoint_graph_tpu.parallel.mesh import make_mesh
    from superpoint_graph_tpu.parallel.partition_shard import (
        cutpursuit_band_sharded as sharded_j)

    xyz, feats, src, tgt, w = room_graph
    comps_j, ic_j = sharded_j(feats, src, tgt, w, 0.1, make_mesh(8), xyz=xyz,
                              max_iter=3)
    comps_t, ic_t = ps.cutpursuit_band_sharded(feats, src, tgt, w, 0.1,
                                               cpu_mesh(8), xyz=xyz,
                                               max_iter=3)
    e_t, e_j = (energy(feats, ic, src, tgt, w, 0.1) for ic in (ic_t, ic_j))
    assert abs(e_t / e_j - 1.0) <= 0.03, (e_t, e_j)
    assert abs(len(comps_t) / len(comps_j) - 1.0) <= 0.15, (
        len(comps_t), len(comps_j))


# ---------------------------------------------------------------- e2e
CFG = dict(voxel_width=0.0, k_nn_geof=10, k_nn_adj=5, reg_strength=0.1,
           spg_adjacency="knn")


def assert_matches_jax(got, want, xyz, rgb):
    """A sharded partition (graph_nn, geof, components, in_component)
    against the JAX package's on the same cloud: the same kNN graph,
    energy within 3% and components within 15% on the JAX package's
    features and graph, each label one connected piece, more than 4
    superpoints."""
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu.pipeline import (assemble_partition_features,
                                               edge_weights)
    from superpoint_graph_tpu_torch.learn.metrics import disconnected_labels

    (g_t, _, comps_t, ic_t), (g_j, geof_j, comps_j, ic_j) = got, want
    assert ic_t.shape == (len(xyz),) and len(comps_t) > 4
    assert (g_t["target"] == g_j["target"]).mean() >= 0.99
    feats = assemble_partition_features(geof_j, rgb, CJ(**CFG))
    w = edge_weights(g_j["distances"], 1.0)
    src, tgt = (g_j[k].astype(np.int64) for k in ("source", "target"))
    e_t, e_j = (energy(feats, ic, src, tgt, w, 0.1) for ic in (ic_t, ic_j))
    assert abs(e_t / e_j - 1.0) <= 0.03, (e_t, e_j)
    assert abs(len(comps_t) / len(comps_j) - 1.0) <= 0.15, (
        len(comps_t), len(comps_j))
    assert disconnected_labels(ic_t, src, tgt) == 0


def test_partition_cloud_sharded_matches_jax():
    """partition_cloud_sharded on 8 shards against the JAX function on
    make_mesh(8), on the dry run's 3,000-point room
    (__graft_entry__.py:104-113): assert_matches_jax."""
    from superpoint_graph_tpu.parallel.mesh import make_mesh
    from superpoint_graph_tpu.parallel.partition_shard import (
        partition_cloud_sharded as room_j)
    from superpoint_graph_tpu.pipeline import PartitionConfig as CJ
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig as CT

    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(0), n_points=3000)
    assert_matches_jax(
        ps.partition_cloud_sharded(xyz, rgb, CT(**CFG), cpu_mesh(8)),
        room_j(xyz, rgb, CJ(**CFG), make_mesh(8)), xyz, rgb)
