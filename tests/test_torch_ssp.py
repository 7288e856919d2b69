"""The port's supervised partition (superpoint_graph_tpu_torch/ssp/, with
utils/ransac.py, ops/subgraph.py, ops/cutpursuit.cutpursuit2 and the
boundary metrics) against the JAX package on the CPU, on the same seeded
inputs: exact where the work is host numpy, within stated tolerances
where it is float arithmetic on tensors."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.data.synthetic import synthetic_room
from superpoint_graph_tpu.ssp import embed as embed_j
from superpoint_graph_tpu.ssp import graph_processing as gp_j
from superpoint_graph_tpu.ssp import losses as losses_j
from superpoint_graph_tpu_torch.learn.convert_jax import (
    convert_local_embedder, flax_to_state_dict)
from superpoint_graph_tpu_torch.learn.train_check import bn_fed_biases
from superpoint_graph_tpu_torch.ssp import embed as embed_t
from superpoint_graph_tpu_torch.ssp import graph_processing as gp_t
from superpoint_graph_tpu_torch.ssp import losses as losses_t

N_LABELS = 13
SMALL_J = dict(ptn_widths=((16, 32), (18, 16, 4)),
               ptn_widths_stn=((8, 16), (16, 8)))


def _cloud(seed, n=3000):
    """A synthetic room with S3DIS-style labels and objects (1-based)."""
    xyz, rgb, labels, objects = synthetic_room(np.random.RandomState(seed),
                                               n_points=n)
    return xyz, rgb, labels + 1, objects + 1


@pytest.fixture(scope="module")
def structures():
    """The same room through both packages' build_supervision_structure,
    RANSAC plane on (port on the CPU)."""
    xyz, rgb, labels, objects = _cloud(3)
    cfg_j = gp_j.SspPreprocessConfig(voxel_width=0.06, plane_model=True)
    cfg_t = gp_t.SspPreprocessConfig(voxel_width=0.06, plane_model=True)
    want = gp_j.build_supervision_structure(xyz, rgb, labels, objects, cfg_j,
                                            N_LABELS)
    got = gp_t.build_supervision_structure(xyz, rgb, labels, objects, cfg_t,
                                           N_LABELS, device="cpu")
    return got, want


@pytest.fixture(scope="module")
def structure_file(structures, tmp_path_factory):
    """The JAX structure written by the JAX package."""
    path = str(tmp_path_factory.mktemp("ssp") / "cloud.h5")
    gp_j.write_structure(path, structures[1])
    return path


# ------------------------------------------------------------ RANSAC
@pytest.mark.parametrize("seed,n,outliers", [(0, 2000, 0.0), (1, 5000, 0.2),
                                             (2, 250, 0.05)])
def test_ransac_matches_sklearn(seed, n, outliers):
    """utils/ransac.py against RANSACRegressor(random_state=0) on a noisy
    tilted plane with a share of outliers above it (250 points: the
    permutation sampler, else tracking selection): elevation within 1e-5."""
    from sklearn.linear_model import RANSACRegressor

    from superpoint_graph_tpu_torch.utils.ransac import ransac_plane

    rs = np.random.RandomState(seed)
    xy = (rs.rand(n, 2) * 6).astype(np.float32)
    z = (0.03 * xy[:, 0] - 0.02 * xy[:, 1] + 0.1
         + 0.004 * rs.randn(n)).astype(np.float32)
    out = rs.rand(n) < outliers
    z[out] += (0.1 + rs.rand(out.sum()) * 0.4).astype(np.float32)
    want = RANSACRegressor(random_state=0).fit(xy, z).predict(xy)
    got = ransac_plane(xy, z).predict(xy)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(z - got, z - want, atol=1e-5)


@pytest.mark.parametrize("style", ["s3dis", "sema3d"])
def test_plane_elevation_rows_match_jax(style):
    """data/parsed.build_point_matrix with plane_elevation (the RANSAC
    raise lifted) against the JAX package's (sklearn): 1e-5; an unknown
    style raises (vkitti and custom_dataset rows:
    tests/test_torch_datasets_cli.py)."""
    from superpoint_graph_tpu.data import parsed as parsed_j
    from superpoint_graph_tpu_torch.data import parsed as parsed_t

    xyz, rgb, _, _ = _cloud(4, 2000)
    geof = np.random.RandomState(0).rand(len(xyz), 4).astype(np.float32)
    want = parsed_j.build_point_matrix(xyz, rgb, geof, style,
                                       plane_elevation=True)
    got = parsed_t.build_point_matrix(xyz, rgb, geof, style,
                                      plane_elevation=True)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="style"):
        parsed_t.build_point_matrix(xyz, rgb, geof, "kitti")


# ------------------------------------------------------------ host parts
def test_random_subgraph_equal():
    """ops/subgraph.random_subgraph: the same masks from the same
    RandomState, and the same state after."""
    from superpoint_graph_tpu.ops.subgraph import random_subgraph as rj
    from superpoint_graph_tpu_torch.ops.subgraph import random_subgraph as rt

    rng = np.random.RandomState(0)
    n = 3000
    src = np.repeat(np.arange(n), 4)
    tgt = rng.randint(0, n, len(src))
    for size in (50, 700, 2999, 5000):
        a, b = np.random.RandomState(size), np.random.RandomState(size)
        for got, want in zip(rt(n, src, tgt, size, a), rj(n, src, tgt, size, b)):
            np.testing.assert_array_equal(got, want)
        assert a.randint(1 << 30) == b.randint(1 << 30)


def test_cutpursuit2_equal():
    """ops/cutpursuit.cutpursuit2 (node weights; the Semantic3D
    inpainting): the same regularised values and regions as the JAX one."""
    from superpoint_graph_tpu.ops.cutpursuit import cutpursuit2 as cj
    from superpoint_graph_tpu_torch.ops.cutpursuit import cutpursuit2 as ct

    rng = np.random.RandomState(1)
    n = 400
    src = np.repeat(np.arange(n), 5)
    tgt = (src + rng.randint(1, 30, len(src))) % n
    values = (np.arange(n) // 80 + 1).astype(np.float32)
    values[rng.rand(n) < 0.1] = 0
    nw = (values > 0).astype(np.float32)
    for v in (values, np.stack([values, values * 0.5], 1)):
        got = ct(v, src, tgt, np.ones(len(src), np.float32), nw, 0.01)
        want = cj(v, src, tgt, np.ones(len(src), np.float32), nw, 0.01)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _graph(rng, n=500, k=5):
    src = np.repeat(np.arange(n), k).astype(np.uint32)
    tgt = ((src.astype(np.int64) + rng.randint(1, 40, len(src))) % n
           ).astype(np.uint32)
    return {"source": src, "target": tgt}


@pytest.mark.parametrize("dataset", ["s3dis", "sema3d", "vkitti"])
def test_compute_transitions_equal(dataset):
    """compute_transitions: the same transition edges and objects (sema3d
    through cutpursuit2, vkitti through connected components)."""
    rng = np.random.RandomState(2)
    n = 500
    graph = _graph(rng, n)
    objects = (np.arange(n) // 60 + 1).astype(np.int64)
    if dataset == "sema3d":
        labels = np.zeros((n, 9), np.uint32)
        labels[np.arange(n), np.arange(n) // 70 + 1] = 3
        labels[rng.rand(n) < 0.1] = 0  # unlabelled points
    else:
        labels = np.eye(13, dtype=np.uint32)[np.arange(n) // 50 % 13]
    got = gp_t.compute_transitions(dataset, objects, labels, graph, n)
    want = gp_j.compute_transitions(dataset, objects, labels, graph, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _partition_case(rng, n=600):
    es = np.repeat(np.arange(n), 5)
    et = (es + rng.randint(1, 25, len(es))) % n
    objects = np.arange(n) // 75
    is_tr = (objects[es] != objects[et]).astype(np.int32)
    in_comp = (np.arange(n) + rng.randint(0, 30, n)) // 50
    in_comp = np.unique(in_comp, return_inverse=True)[1].astype(np.int32)
    comps = [np.flatnonzero(in_comp == c).astype(np.uint32)
             for c in range(in_comp.max() + 1)]
    return es, et, objects, is_tr, comps, in_comp


@pytest.mark.parametrize("weighting", ["SEAL", "XPART", "proportional"])
def test_loss_weights_equal(weighting):
    """The SEAL, cross-partition and proportional weights of one partition:
    equal to the JAX package's."""
    rng = np.random.RandomState(3)
    es, et, objects, is_tr, comps, in_comp = _partition_case(rng)
    if weighting == "proportional":
        cfg_j = losses_j.SspLossConfig(loss_weight="proportional")
        cfg_t = losses_t.SspLossConfig(loss_weight="proportional")
        args = (None, objects, es, et, is_tr, None, False)
        got = losses_t.compute_weight_loss(cfg_t, *args)
        want = losses_j.compute_weight_loss(cfg_j, *args)
    else:
        name = f"compute_weights_{weighting}"
        args = (comps, in_comp, objects, es, et, is_tr, 50.0)
        got = getattr(losses_t, name)(*args)
        want = getattr(losses_j, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 1).any()


def test_relax_and_boundary_metrics_equal():
    """relax_edge_binary at tolerances 0-2, the predicted transitions,
    boundary recall and precision, mode and perfect_prediction: equal."""
    from superpoint_graph_tpu.learn import metrics as mj
    from superpoint_graph_tpu_torch.learn import metrics as mt

    rng = np.random.RandomState(4)
    es, et, objects, is_tr, comps, in_comp = _partition_case(rng)
    n = len(in_comp)
    pred = mt.compute_predicted_transitions(in_comp, es, et)
    np.testing.assert_array_equal(
        pred, mj.compute_predicted_transitions(in_comp, es, et))
    for tol in (0, 1, 2):
        got = losses_t.relax_edge_binary(pred, es, et, n, tol)
        np.testing.assert_array_equal(
            got, losses_j.relax_edge_binary(pred, es, et, n, tol))
    tr = is_tr.astype(bool)
    relaxed = losses_t.relax_edge_binary(pred, es, et, n, 1)
    assert (mt.compute_boundary_recall(tr, relaxed)
            == mj.compute_boundary_recall(tr, relaxed))
    assert (mt.compute_boundary_precision(tr, pred)
            == mj.compute_boundary_precision(tr, pred))
    assert mt.mode(objects[:200]) == mj.mode(objects[:200])
    assert mt.mode(objects, True) == mj.mode(objects, True)
    hist = rng.randint(0, 5, (n, 14))
    np.testing.assert_array_equal(mt.perfect_prediction(comps, hist),
                                  mj.perfect_prediction(comps, hist))


# ------------------------------------------------------------ structure
def test_structure_matches_jax(structures):
    """build_supervision_structure with the RANSAC plane: the pruned cloud,
    rgb, labels and objects equal; kNN index agreement >= 0.99; transitions
    equal on the edges whose targets agree; elevation within 1e-5; geof
    within 1e-5 on rows whose neighbour sets agree (2e-2 on exactly
    degenerate neighbourhoods, ROADMAP queue 3)."""
    got, want = structures
    for key in ("xyz", "rgb", "labels", "objects", "xyn"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    np.testing.assert_allclose(got["elevation"], want["elevation"], atol=1e-5)
    nb_t = got["target_local_geometry"]
    nb_j = np.asarray(want["target_local_geometry"])
    assert nb_t.dtype == nb_j.dtype == np.uint32
    assert (nb_t == nb_j).mean() >= 0.99
    np.testing.assert_array_equal(got["graph_nn"]["source"],
                                  want["graph_nn"]["source"])
    same_e = got["graph_nn"]["target"] == want["graph_nn"]["target"]
    assert same_e.mean() >= 0.99
    np.testing.assert_array_equal(got["is_transition"][same_e],
                                  want["is_transition"][same_e])
    rows = (np.sort(nb_t, 1) == np.sort(nb_j, 1)).all(1)
    err = np.abs(got["geof"] - want["geof"])[rows]
    assert err.max() <= 2e-2
    assert (err.max(1) <= 1e-5).mean() >= 0.99
    assert 0 < got["is_transition"].sum() < len(got["is_transition"])


def test_structure_voronoi_edges_match_jax():
    """use_voronoi > 0: the Delaunay edges joined to the kNN edges, as the
    JAX compute_graph_nn_2 joins them."""
    xyz, rgb, labels, objects = _cloud(5, 1500)
    kw = dict(voxel_width=0.1, plane_model=False, compute_geof=False,
              use_voronoi=0.3)
    want = gp_j.build_supervision_structure(
        xyz, rgb, labels, objects, gp_j.SspPreprocessConfig(**kw), N_LABELS)
    got = gp_t.build_supervision_structure(
        xyz, rgb, labels, objects, gp_t.SspPreprocessConfig(**kw), N_LABELS,
        device="cpu")
    n = len(got["xyz"])
    assert len(got["graph_nn"]["source"]) > 6 * n
    pairs = [set(zip(s["graph_nn"]["source"].tolist(),
                     s["graph_nn"]["target"].tolist())) for s in (got, want)]
    assert len(pairs[0] ^ pairs[1]) <= 0.01 * len(pairs[1])


def test_structure_io_and_loader_equal(structures, structure_file, tmp_path):
    """A structure written by either package reads the same in both; the
    port's in-memory dict loads as its file; graph_loader (train and test)
    and graph_collate give equal samples from the same RandomState."""
    got, _ = structures
    port_file = str(tmp_path / "port.h5")
    gp_t.write_structure(port_file, got)
    for path in (structure_file, port_file):
        for read_geof in (False, True):
            for a, b in zip(gp_t.read_structure(path, read_geof),
                            gp_j.read_structure(path, read_geof)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    for a, b in zip(gp_t.structure_arrays(got), gp_t.read_structure(port_file)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    cfg_t = gp_t.SspLoaderConfig(max_ver_train=300)
    cfg_j = gp_j.SspLoaderConfig(max_ver_train=300)
    for train in (True, False):
        samples = []
        for seed in (0, 1):
            t_file = gp_t.graph_loader(structure_file, train, cfg_t,
                                       np.random.RandomState(seed))
            t_dict = gp_t.graph_loader(_dict_of(structure_file), train,
                                       cfg_t, np.random.RandomState(seed))
            j = gp_j.graph_loader(structure_file, train, cfg_j,
                                  np.random.RandomState(seed))
            for k in j:
                np.testing.assert_array_equal(t_file[k], j[k], err_msg=k)
                np.testing.assert_array_equal(t_dict[k], j[k], err_msg=k)
            samples.append((t_file, j))
        got_c = gp_t.graph_collate([s[0] for s in samples])
        want_c = gp_j.graph_collate([s[1] for s in samples])
        assert got_c.keys() == want_c.keys()
        for k in want_c:
            np.testing.assert_array_equal(got_c[k], want_c[k], err_msg=k)
        if train:
            assert len(got_c["xyz"]) == 600


def _dict_of(path):
    """A structure dict holding the arrays of a structure file."""
    import h5py

    with h5py.File(path, "r") as f:
        s = {k: f[k][()] for k in f}
    s["graph_nn"] = {"source": s.pop("source"), "target": s.pop("target")}
    return s


# ------------------------------------------------------------ losses
def _emb_case(seed=5, n=300, d=4, n_e=1500):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    es = rng.randint(0, n, n_e)
    et = (es + rng.randint(1, n, n_e)) % n  # no self-loop, as in a kNN graph
    is_tr = (rng.rand(n_e) < 0.3).astype(np.int32)
    w = (rng.rand(n_e) * 3 + 0.5).astype(np.float32)
    return emb, es, et, is_tr, w


@pytest.mark.parametrize("dist_type", ["euclidian", "intrinsic", "scalar"])
def test_compute_dist_matches_jax(dist_type):
    """compute_dist: values and the gradient of their weighted sum within
    1e-5 of JAX's."""
    emb, es, et, _, w = _emb_case()

    def f_j(e):
        return jnp.sum(losses_j.compute_dist(e, es, et, dist_type) * w)

    want, want_g = jax.value_and_grad(f_j)(jnp.asarray(emb))
    e_t = torch.tensor(emb, requires_grad=True)
    d_t = losses_t.compute_dist(e_t, torch.as_tensor(es), torch.as_tensor(et),
                                dist_type)
    np.testing.assert_allclose(
        d_t.detach().numpy(),
        np.asarray(losses_j.compute_dist(jnp.asarray(emb), es, et, dist_type)),
        rtol=1e-5, atol=1e-5)
    (d_t * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist_type", ["euclidian", "intrinsic"])
@pytest.mark.parametrize("loss", ["TVH_zhang", "tv_zhang", "laplacian_zhang",
                                  "TVH_TVminus", "tv_TVminus"])
def test_compute_loss_matches_jax(loss, dist_type):
    """compute_loss over compute_dist, (intra + inter) / E: the value and
    its gradient with respect to the embeddings within 1e-5 of jax.grad."""
    emb, es, et, is_tr, w = _emb_case()
    cfg_j = losses_j.SspLossConfig(loss=loss, dist_type=dist_type)
    cfg_t = losses_t.SspLossConfig(loss=loss, dist_type=dist_type)

    def f_j(e):
        d = losses_j.compute_dist(e, es, et, dist_type)
        l1, l2 = losses_j.compute_loss(cfg_j, d, jnp.asarray(is_tr),
                                       jnp.asarray(w))
        return (l1 + l2) / len(w)

    want, want_g = jax.value_and_grad(f_j)(jnp.asarray(emb))
    e_t = torch.tensor(emb, requires_grad=True)
    d_t = losses_t.compute_dist(e_t, torch.as_tensor(es), torch.as_tensor(et),
                                dist_type)
    l1, l2 = losses_t.compute_loss(cfg_t, d_t, torch.as_tensor(is_tr),
                                   torch.as_tensor(w))
    got = (l1 + l2) / len(w)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ partition
@pytest.fixture(scope="module")
def partition_case(structures):
    """Embeddings of the room (its geof and rgb, L2-normalised), the
    per-edge distances, xyz, edges."""
    got, _ = structures
    emb = np.hstack([got["geof"], got["rgb"] / 255.0]).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    es = got["graph_nn"]["source"].astype(np.int64)
    et = got["graph_nn"]["target"].astype(np.int64)
    diff = ((emb[es] - emb[et]) ** 2).sum(1)
    return emb, es, et, diff, got["xyz"]


def test_compute_partition_exact_equal(partition_case):
    """The "exact" backend (host max-flow) gives the JAX partition."""
    emb, es, et, diff, xyz = partition_case
    cfg = dict(cp_backend="exact", CP_cutoff=10)
    got = losses_t.compute_partition(losses_t.SspLossConfig(**cfg), emb, es,
                                     et, diff, xyz)
    want = losses_j.compute_partition(losses_j.SspLossConfig(**cfg), emb, es,
                                      et, diff, xyz)
    np.testing.assert_array_equal(got[1], want[1])
    assert 5 < len(got[0]) == len(want[0])


def test_compute_partition_device_near_jax_tpu(partition_case):
    """The device backend (the port's band solver, here on CPU tensors)
    against the JAX "tpu" backend: energy within 3%, component count
    within 15%, both measured by the exact solver's energy."""
    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy

    emb, es, et, diff, xyz = partition_case
    cfg_t = losses_t.SspLossConfig(cp_backend="device", CP_cutoff=10)
    cfg_j = losses_j.SspLossConfig(cp_backend="tpu", CP_cutoff=10)
    got = losses_t.compute_partition(cfg_t, emb, es, et, diff, xyz,
                                     device="cpu")
    want = losses_j.compute_partition(cfg_j, emb, es, et, diff, xyz)
    f = np.hstack([emb, 0.2 * xyz]).astype(np.float64)
    w = np.exp(diff * -0.5) / np.exp(-0.5)
    reg = 0.8 / (4 * 5)
    e_t, e_j = (_energy(f, np.ones(len(f)), np.asarray(r[1], np.int64), es, et,
                        w, reg)[0] for r in (got, want))
    assert abs(e_t / e_j - 1) <= 0.03, (e_t, e_j)
    assert abs(len(got[0]) / len(want[0]) - 1) <= 0.15
    with pytest.raises(ValueError, match="cp_backend"):
        losses_t.compute_partition(
            dataclasses.replace(cfg_t, cp_backend="tpu"), emb, es, et, diff)


# ------------------------------------------------------------ embedder
def _embedder_case(norm, seed=0, n=120):
    from tests.test_torch_models import _randomize

    cfg_j = embed_j.SspModelConfig(**SMALL_J, ptn_norm=norm)
    cfg_t = embed_t.SspModelConfig(**SMALL_J, ptn_norm=norm)
    rng = np.random.RandomState(seed)
    clouds = rng.randn(n, 20, 6).astype(np.float32)
    glob = rng.rand(n, cfg_j.nfeat_global - 4).astype(np.float32)
    model_j = embed_j.LocalEmbedder(cfg_j)
    shapes = model_j.init(jax.random.PRNGKey(0), clouds, glob, train=False)
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats") if c in shapes}
    variables.setdefault("batch_stats", {})
    model_t = embed_t.LocalEmbedder(cfg_t)
    model_t.load_state_dict(flax_to_state_dict(variables, model_t,
                                               convert_local_embedder))
    return model_j, variables, model_t, clouds, glob


@pytest.mark.parametrize("norm", ["batch", "layer"])
def test_local_embedder_matches_jax(norm):
    """LocalEmbedder with the JAX weights carried by the bridge: the
    embeddings within 1e-5 in eval and in training mode, and the running
    statistics of the training forward within 1e-5."""
    model_j, variables, model_t, clouds, glob = _embedder_case(norm)
    want = model_j.apply(variables, clouds, glob, train=False)
    got = model_t.eval()(torch.as_tensor(clouds), torch.as_tensor(glob))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    want, mut = model_j.apply(variables, clouds, glob, train=True,
                              mutable=["batch_stats"])
    got = model_t.train()(torch.as_tensor(clouds), torch.as_tensor(glob))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    if norm == "batch":
        stats = flax_to_state_dict(
            {"params": variables["params"], "batch_stats": mut["batch_stats"]},
            model_t, convert_local_embedder)
        for k, v in model_t.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=1e-5, err_msg=k)
    else:
        assert not any("running" in k for k in model_t.state_dict())


def test_embed_chunked_matches_whole():
    """embed_chunked equals embed (eval mode: rows are independent)."""
    cfg = embed_t.SspModelConfig(**SMALL_J)
    trainer = embed_t.SspTrainer(cfg, losses_t.SspLossConfig(), device="cpu")
    rng = np.random.RandomState(1)
    clouds = rng.randn(300, 20, 6).astype(np.float32)
    glob = rng.rand(300, cfg.nfeat_global - 4).astype(np.float32)
    whole = trainer.embed(clouds, glob).numpy()
    np.testing.assert_allclose(trainer.embed_chunked(clouds, glob, chunk=128),
                               whole, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(whole, axis=1), 1.0, atol=1e-5)


# ------------------------------------------------------------ trainer
def _jax_step(tj, state, batch):
    """The JAX SspTrainer.train_step, step by step as it runs them (its
    forward, the host weights and partition, the loss and the vjp, then
    its optax chain): (gradients before the clip, new params, new batch
    statistics, loss, in_component)."""
    import optax

    es, et = batch["edg_source"], batch["edg_target"]

    def fwd(p):
        emb, mut = tj.model.apply(
            {"params": p, "batch_stats": state["batch_stats"]},
            jnp.asarray(batch["clouds"]), jnp.asarray(batch["clouds_global"]),
            None, train=True, mutable=["batch_stats"])
        return emb, mut["batch_stats"]

    (emb, new_bs), vjp_fn = jax.vjp(fwd, state["params"])
    weights, _, in_comp = losses_j.compute_weight_loss(
        tj.loss_cfg, np.asarray(emb), batch["objects"], es, et,
        batch["is_transition"],
        np.asarray(losses_j.compute_dist(emb, es, et, "euclidian")), True,
        batch["xyz"])
    loss, de = tj._emb_grad(emb, jnp.asarray(es), jnp.asarray(et),
                            jnp.asarray(batch["is_transition"]),
                            jnp.asarray(weights, jnp.float32))
    (grads,) = vjp_fn((de, jax.tree.map(jnp.zeros_like, new_bs)))
    updates, _ = tj.tx.update(grads, state["opt_state"], state["params"])
    return (grads, optax.apply_updates(state["params"], updates), new_bs,
            float(loss), in_comp)


def test_train_step_matches_jax(structure_file):
    """One SspTrainer.train_step ("exact" in-loop partition) from the JAX
    trainer's initial weights on the same batch: the same in-loop
    partition; the loss within 1e-5 relative; the gradients (clamped at
    grad_clip, as both steps clamp them) under learn/train_check.py's
    rules: each within 1e-4 of its tensor's largest, a bias feeding a
    batch norm (zero by construction) within 1e-4 of the model's largest,
    each channel of the batch-norm bias before a max-pool within 1e-6 of
    its cancelled sum (pool_residue_scales); the running statistics within
    1e-5; every updated parameter within 1e-5 where its gradient is above
    that bound or 0 on both sides. Below it, where the check does not fix
    the gradient's sign, Adam's first step lr g / (|g| + 1e-8) turns the
    rounding noise into a step of up to lr either way: 136 of the 2,692
    elements here, 135 of them zero by construction (the biases feeding a
    batch norm, 18 pooled channels positive on every row, the 36 weights
    of the STN's constant diagonal in the first Linear after the pool) and
    one weight of that Linear below 1e-4 of its largest gradient."""
    from superpoint_graph_tpu_torch.learn.train_check import (
        TRAIN_TOL, branches, pool_residue_scales)

    lcfg = gp_j.SspLoaderConfig(max_ver_train=600)
    batch = gp_j.graph_collate([gp_j.graph_loader(
        structure_file, True, lcfg, np.random.RandomState(0))])
    mcfg_j = embed_j.SspModelConfig(**SMALL_J)
    loss_kw = dict(CP_cutoff=5, cp_backend="exact")
    tj = embed_j.SspTrainer(mcfg_j, losses_j.SspLossConfig(**loss_kw))
    state = tj.init(jax.random.PRNGKey(0), jnp.asarray(batch["clouds"]),
                    jnp.asarray(batch["clouds_global"]))
    tt = embed_t.SspTrainer(embed_t.SspModelConfig(**SMALL_J),
                            losses_t.SspLossConfig(**loss_kw), device="cpu")

    def to_port(params, batch_stats):
        return flax_to_state_dict({"params": params,
                                   "batch_stats": batch_stats},
                                  tt.model, convert_local_embedder)

    tt.model.load_state_dict(to_port(state["params"], state["batch_stats"]))
    grads_j, params_j, stats_j, loss_j, in_comp_j = _jax_step(tj, state,
                                                              batch)
    grads_j = to_port(grads_j, state["batch_stats"])
    with branches(tt.model) as rec:
        loss_t, _, in_comp_t = tt.train_step(batch)
    np.testing.assert_array_equal(in_comp_t, in_comp_j)
    assert abs(loss_t / loss_j - 1) <= 1e-5, (loss_t, loss_j)
    zero = bn_fed_biases(tt.model)
    scales = pool_residue_scales(tt.model, rec["pooled_grads"])
    assert len(scales) == 2
    grads = {k: p.grad.numpy() for k, p in tt.model.named_parameters()}
    top = max(float(np.abs(g).max()) for g in grads.values())
    want = to_port(params_j, stats_j)
    for k, v in tt.model.state_dict().items():
        if k not in grads:  # a running statistic
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=k)
            continue
        g, g_j = grads[k], np.clip(grads_j[k].numpy(), -1.0, 1.0)
        if k in zero:
            bound = TRAIN_TOL["grad"] * top
        elif k in scales:
            bound = TRAIN_TOL["residue"] * scales[k]
        else:
            bound = TRAIN_TOL["grad"] * float(np.abs(g_j).max())
        assert (np.abs(g - g_j) <= bound).all(), k
        held = (np.abs(g) > bound) | ((g == 0) & (g_j == 0))
        np.testing.assert_allclose(v.numpy()[held], want[k].numpy()[held],
                                   atol=1e-5, err_msg=k)
    assert tt.step == 1 and np.isfinite(loss_t)
