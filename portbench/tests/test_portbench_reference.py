"""The plain reference agrees with the program at small widths on the CPU:
the model's eval logits, the prune, the kNN distances and the features,
and the partition's energy and solver. The program is imported here, in
the test only, to hold the reference to it."""
import numpy as np
import pytest
import torch

from portbench.harness.weights import draw_weights
from portbench.reference import cloud, model, partition

CFGS = {
    "matrix": {"n_classes": 5, "model_config": "gru_3_0,f_5",
               "ptn_widths": [[8, 16], [16, 8]],
               "ptn_widths_stn": [[8], [8]], "ptn_nfeat": 6,
               "ptn_nfeat_stn": 6, "ptn_prelast_do": 0.0,
               "fnet_widths": [4, 8, 16], "fnet_llbias": False,
               "fnet_bnidx": 1},
    "vector": {"n_classes": 4, "model_config": "gru_2,f_4",
               "ptn_widths": [[8, 16], [16, 8]],
               "ptn_widths_stn": [[8], [8]], "ptn_nfeat": 6,
               "ptn_nfeat_stn": 5, "ptn_prelast_do": 0.0,
               "fnet_widths": [4, 8, 16], "fnet_llbias": True,
               "fnet_bnidx": 1}}


def program_model(cfg, weights):
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel

    kw = {k: (tuple(map(tuple, v)) if k.startswith("ptn_widths")
              else tuple(v) if k == "fnet_widths" else v)
          for k, v in cfg.items() if k != "n_classes"}
    m = SpgModel(cfg["n_classes"], **kw)
    m.load_state_dict(weights, strict=True)
    return m


def batch(cfg, n=12, p=9, e=30, seed=0):
    from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch

    g = torch.Generator().manual_seed(seed)
    pad_n, pad_e = n + 4, e + 6
    cm = torch.zeros(pad_n, dtype=torch.bool)
    cm[:n] = torch.rand(n, generator=g) > 0.2
    nm = torch.zeros(pad_n, dtype=torch.bool)
    nm[:n] = True
    em = torch.zeros(pad_e, dtype=torch.bool)
    em[:e] = True
    targets = torch.full((pad_n,), -100)
    targets[:n] = torch.randint(0, cfg["n_classes"], (n,), generator=g)
    return SpgBatch(
        clouds=torch.randn(pad_n, p, cfg["ptn_nfeat"], generator=g),
        clouds_global=torch.rand(pad_n, 1, generator=g), cloud_mask=cm,
        node_mask=nm, targets=targets,
        target_size=torch.zeros(pad_n, cfg["n_classes"] + 1, dtype=torch.int64),
        src=torch.randint(0, n, (pad_e,), generator=g),
        tgt=torch.randint(0, n, (pad_e,), generator=g),
        edge_feats=torch.randn(pad_e, cfg["fnet_widths"][0], generator=g),
        edge_mask=em)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_eval_logits(kind):
    from portbench.harness.serve import graph_of

    cfg = CFGS[kind]
    w = draw_weights(cfg, 123, "cpu")
    b = batch(cfg)
    with torch.no_grad():
        got = program_model(cfg, w).eval()(b)[:12]
    want = model.forward(w, cfg, graph_of(b))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prune_matches_the_program():
    from superpoint_graph_tpu_torch.ops.voxel import prune

    rng = np.random.RandomState(2)
    xyz = (rng.rand(20000, 3) * [3, 2, 1]).astype(np.float32)
    rgb = rng.randint(0, 256, (20000, 3)).astype(np.uint8)
    lab = rng.randint(0, 5, 20000)
    px, prgb, phist, _ = prune(xyz, 0.05, rgb, lab, None, 4, 0, device="cpu")
    ref = cloud.prune(xyz, 0.05, rgb, lab, 4)
    np.testing.assert_allclose(px, ref["xyz"], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(prgb, ref["rgb"])
    np.testing.assert_array_equal(phist, ref["hist"])


def test_knn_and_geof_match_the_program():
    from superpoint_graph_tpu_torch.ops.geof import compute_geof
    from superpoint_graph_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(5)
    xyz = (rng.rand(6000, 3) * [2, 2, 0.3]).astype(np.float32)
    t = torch.as_tensor(xyz)
    idx, d2 = knn(t, 12)
    blocks = cloud.cluster_blocks(xyz, 8, 16, np.random.RandomState(0), "cpu")
    rows = np.concatenate(blocks)
    want = cloud.knn_distances(xyz, blocks, 12, "cpu")
    got = np.sqrt(np.maximum(d2.numpy()[rows], 0))
    np.testing.assert_allclose(np.sort(got, 1), want, atol=1e-5)
    g_prog = compute_geof(t, idx).numpy()[rows]
    g_ref, usable, _, _ = cloud.geof_rows(xyz, rows, 12, "cpu")
    assert usable[:, :3].mean() > 0.9
    np.testing.assert_allclose(g_prog[usable], g_ref[usable], atol=1e-4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0 + 2 ** -12, -1.5])
    r = model.round_tf32(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0, -1.5]


def test_energy_by_hand():
    # a path 0-1-2-3, features 0, 0, 1, 1; edges both ways, weight 1
    g = {"f": np.array([[0.0], [0.0], [1.0], [1.0]]),
         "src": np.array([0, 1, 1, 2, 2, 3]),
         "tgt": np.array([1, 0, 2, 1, 3, 2]), "w": np.ones(6)}
    assert partition.energy(g, [0, 0, 1, 1], 0.3) == pytest.approx(0.6)
    assert partition.energy(g, [0, 0, 0, 0], 0.3) == pytest.approx(1.0)
    assert partition.energy(g, [0, 1, 2, 3], 0.3) == pytest.approx(1.8)
    assert partition.greedy(g, 0.3, "cpu").tolist() == [0, 0, 2, 2]
    assert len(set(partition.greedy(g, 2.0, "cpu").tolist())) == 1


def test_graph_and_greedy_against_the_programs_exact_solver():
    from superpoint_graph_tpu_torch import pipeline
    from superpoint_graph_tpu_torch.ops.cutpursuit import cutpursuit

    from portbench.harness import inputs

    xyz, rgb, _, _ = inputs.synthetic_room(np.random.RandomState(4),
                                           n_points=8000, noise=0.008,
                                           clutter_blobs=True)
    cfg = pipeline.PartitionConfig(dataset="s3dis", voxel_width=0.05)
    vox = cloud.prune(xyz, cfg.voxel_width, rgb, None, 0)
    g = partition.graph(vox["xyz"], vox["rgb"], cfg, "cpu")
    graph_nn, geof = pipeline.partition_features(
        vox["xyz"].astype(np.float32), cfg, device="cpu")[:2]
    f = pipeline.assemble_partition_features(geof, vox["rgb"], cfg)
    np.testing.assert_allclose(np.median(np.abs(f - g["f"]), 0), 0,
                               atol=1e-4)
    _, exact = cutpursuit(f, graph_nn["source"], graph_nn["target"],
                          pipeline.edge_weights(graph_nn["distances"], 1.0),
                          cfg.reg_strength)
    e_exact = partition.energy(g, exact, cfg.reg_strength)
    e_greedy = partition.energy(g, partition.greedy(g, cfg.reg_strength,
                                                    "cpu"), cfg.reg_strength)
    one = partition.energy(g, np.zeros(len(f)), cfg.reg_strength)
    assert e_greedy < 0.5 * one
    assert abs(e_greedy / e_exact - 1) < 0.25


@pytest.mark.parametrize("style", ["s3dis", "sema3d"])
def test_loader_matches_the_program(style):
    from superpoint_graph_tpu_torch import pipeline
    from superpoint_graph_tpu_torch.data.loader import (
        LoaderConfig, collate_spg, load_spg_sample, pc_attrib_dims)
    from superpoint_graph_tpu_torch.data.parsed import (build_point_matrix,
                                                         parsed_entries)
    from superpoint_graph_tpu_torch.data.spg_io import spg_entry

    from portbench.harness import compare, inputs
    from portbench.harness.serve import graph_of
    from portbench.reference import loader

    xyz, rgb, _, _ = inputs.synthetic_room(np.random.RandomState(6),
                                           n_points=12000, noise=0.008,
                                           clutter_blobs=True)
    part = pipeline.partition_cloud(
        xyz, rgb, None, None, 0,
        pipeline.PartitionConfig(voxel_width=0.03, spg_adjacency="knn"),
        device="cpu")
    attribs = {"s3dis": "xyzrgbelpsvXYZ", "sema3d": "xyzrgbelpsv"}[style]
    cfg = {"pc_attribs": attribs, "ptn_npts": 128, "ptn_minpts": 40}
    edge_attribs = "delta_avg,delta_std,nlength/ld,surface/ld,volume/ld," \
        "size/ld,xyz/d"
    lcfg = LoaderConfig(**cfg)
    sample = load_spg_sample(
        spg_entry(part.graph_sp, edge_attribs),
        parsed_entries(build_point_matrix(part.xyz, part.rgb, part.geof,
                                          style=style), part.components),
        lcfg)
    got = collate_spg([sample], lcfg, 13, pc_attrib_dims(attribs), "cpu")
    want = loader.batch(part.xyz, part.rgb, part.geof, part.components,
                        part.graph_sp, style, cfg, edge_attribs)
    assert want["embeddable"].sum() > 10
    assert compare.batch_off(graph_of(got), want) == 0
    want["clouds"][want["embeddable"].argmax(), 0, 3] += 1e-3
    assert compare.batch_off(graph_of(got), want) == 1
