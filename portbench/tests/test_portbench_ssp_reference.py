"""The vKITTI3D frame cell's pieces on the CPU: the reference of the learned
partition (reference/ssp.py) against the program where both compute the
same thing, the frozen frame generator, the embedder's weights and
operation count, and runs of the cell at a small size with a fault
planted."""
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import frames
from portbench.harness.flops import _mlp
from portbench.reference import partition as ref_partition
from portbench.reference import ssp as ref_ssp
from superpoint_graph_tpu_torch.data import provider, synthetic
from superpoint_graph_tpu_torch.graph import spg
from superpoint_graph_tpu_torch.ssp.embed import LocalEmbedder, SspModelConfig

EMBEDDER = {"ptn_widths": [[32, 128], [34, 32, 32, 4]],
            "ptn_widths_stn": [[16, 64], [32, 16]], "ptn_nfeat_stn": 2,
            "use_rgb": True, "global_feat": "eXYrgb", "stn_as_global": True,
            "ptn_norm": "batch", "ptn_prelast_do": 0.0}
FRAME = {"frames": 1, "points": 8000, "sample_rows": 256}


def program_embedder(weights):
    cfg = dict(EMBEDDER, ptn_widths=((32, 128), (34, 32, 32, 4)),
               ptn_widths_stn=((16, 64), (32, 16)))
    m = LocalEmbedder(SspModelConfig(**cfg))
    m.load_state_dict(weights, strict=True)
    return m.eval()


def inputs(n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    clouds = torch.randn(n, 20, 6, generator=g)
    globals_ = torch.rand(n, ref_ssp.n_global(EMBEDDER), generator=g)
    return clouds, globals_


def test_specs_are_the_program_embedders_layout():
    specs = ref_ssp.embedder_specs(EMBEDDER)
    state = program_embedder(frames.draw_embedder(EMBEDDER, 3, "cpu"))
    assert [(n, tuple(s)) for n, s, _ in specs] == [
        (k, tuple(v.shape)) for k, v in state.state_dict().items()]


def test_embed_matches_the_program_embedder():
    """The same float32 layers: within 1e-5 of a unit vector's
    coordinates; in TF32 (the control) the reference moves by more."""
    w = frames.draw_embedder(EMBEDDER, 5, "cpu")
    clouds, globals_ = inputs()
    with torch.no_grad():
        got = program_embedder(w)(clouds, globals_)
    want = ref_ssp.embed(w, EMBEDDER, clouds, globals_, block=128)
    assert (got - want).abs().max() < 1e-5
    assert torch.allclose(want.norm(dim=1), torch.ones(len(want)))
    tf32 = ref_ssp.embed(w, EMBEDDER, clouds, globals_, tf32=True)
    assert (tf32 - want).abs().max() > 1e-4


def test_embedder_weights_depend_on_the_seed_only():
    a = frames.draw_embedder(EMBEDDER, 7, "cpu")
    b = frames.draw_embedder(EMBEDDER, 7, "cpu")
    c = frames.draw_embedder(EMBEDDER, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ptn.fcs.9.weight"], c["ptn.fcs.9.weight"])
    assert a["stn.proj.weight"].abs().max() < 0.2  # near the identity


def test_embedder_flops_by_hand():
    per_point = (2 * (2 * 16 + 16 * 64) + 8 + 2 * (6 * 32 + 32 * 128))
    per_voxel = (2 * (64 * 32 + 32 * 16) + 2 * 16 * 4
                 + 2 * (139 * 34 + 34 * 32 + 32 * 32 + 32 * 4))
    assert frames.embedder_flops(EMBEDDER, 1000, 20) == \
        1000 * (20 * per_point + per_voxel)
    assert _mlp([2, 16, 64]) == 2 * (2 * 16 + 16 * 64)


def test_frozen_street_is_the_programs(tmp_path):
    a = frames.synthetic_street(np.random.RandomState(3), 6000)
    b = synthetic.synthetic_street(np.random.RandomState(3), 6000)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    frames.write_vkitti_frame(tmp_path / "a.npy", np.random.RandomState(9),
                              5000)
    synthetic.write_vkitti_frame(tmp_path / "b.npy",
                                 np.random.RandomState(9), 5000)
    assert (tmp_path / "a.npy").read_bytes() == \
        (tmp_path / "b.npy").read_bytes()


def test_read_frame_is_the_programs_reader(tmp_path):
    frames.write_vkitti_frame(tmp_path / "f.npy", np.random.RandomState(2),
                              4000)
    for want, got in zip(ref_ssp.read_frame(str(tmp_path / "f.npy")),
                         provider.read_vkitti_format(
                             str(tmp_path / "f.npy"))):
        np.testing.assert_array_equal(got, want)


def test_partition_graph_weights():
    emb = np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    xyz = np.zeros((3, 3))
    g = ref_ssp.partition_graph(emb, xyz, np.array([[1], [2], [0]]), 0.2)
    # exp(-0.5 d) / exp(-0.5): e^0.5 for equal embeddings, 1 at squared
    # distance 1, e^-0.5 at 2
    np.testing.assert_allclose(g["w"], [np.exp(0.5), np.exp(-0.5),
                                        np.exp(-0.5)])
    assert g["f"].shape == (3, 7)


def test_delaunay_edges_are_the_programs_support():
    xyz = np.random.RandomState(1).rand(500, 3).astype(np.float32)
    src, tgt = ref_ssp.delaunay_edges(xyz, 100.0)
    want = np.unique(np.stack([src, tgt]), axis=1)
    got = spg._delaunay_cross_edges(xyz, np.arange(500))
    np.testing.assert_array_equal(got, want)
    short = ref_ssp.delaunay_edges(xyz, 0.1)
    assert 0 < len(short[0]) < len(src)


def test_local_clouds_are_the_loaders():
    """The reference's local clouds of the program's voxels: those of the
    program's sample where no two neighbours tie."""
    from superpoint_graph_tpu_torch import frame

    rng = np.random.RandomState(4)
    xyz, rgb, labels = frames.synthetic_street(rng, 6000)
    labels = np.where(labels == 13, 0, labels + 1).astype(np.int32)
    s = frame.serving_structure(xyz, rgb.astype(np.float32), labels,
                                frame.PREPROCESS, 13, "cpu")
    from superpoint_graph_tpu_torch.ssp.graph_processing import (
        SspLoaderConfig, graph_loader)

    sample = graph_loader(s, False, SspLoaderConfig())
    clouds, globals_, _, _ = ref_ssp.local_clouds(
        s["xyz"].astype(np.float64), s["rgb"], s["elevation"], EMBEDDER, 20)
    same = np.abs(np.sort(clouds, 1) - np.sort(sample["clouds"], 1)).max(
        (1, 2)) < 1e-4
    assert same.mean() > 0.99
    np.testing.assert_allclose(globals_[same], sample["clouds_global"][same],
                               atol=1e-5)


def test_plane_elevation_is_the_ransac_plane():
    """The reference's RANSAC is sklearn's RANSACRegressor(random_state=0)
    draw for draw (where sklearn is installed), and the program's plane to
    float32 rounding."""
    from superpoint_graph_tpu_torch.utils.ransac import plane_elevation

    xyz, _, _ = frames.synthetic_street(np.random.RandomState(6), 20000)
    got = ref_ssp.plane_elevation(xyz.astype(np.float64))
    assert np.abs(got - plane_elevation(xyz)).max() < 1e-5
    # the lowest point's height is no elevation: the check's fault
    assert np.abs(got - (xyz[:, 2] - xyz[:, 2].min())).max() > 0.01
    sklearn = pytest.importorskip("sklearn.linear_model")
    low = xyz[xyz[:, 2] - xyz[:, 2].min() < 0.5]
    plane = sklearn.RANSACRegressor(random_state=0).fit(low[:, :2],
                                                        low[:, 2])
    np.testing.assert_array_equal(got, xyz[:, 2] - plane.predict(xyz[:, :2]))


def test_cutoff_fuse_leaves_no_small_component_with_a_neighbour():
    """Every component under the cutoff is merged into a neighbour; the
    fused components are unions of the given ones, each merge the pair
    of least change of E first."""
    rng = np.random.RandomState(2)
    xyz = rng.rand(600, 3)
    nbr, _ = ref_partition.neighbours(xyz, 5)
    emb = rng.randn(600, 4)
    g = ref_ssp.partition_graph(emb / np.linalg.norm(emb, axis=1,
                                                     keepdims=True),
                                xyz, nbr, 0.2)
    comp = ref_partition.greedy(g, 0.02, "cpu")
    fused = ref_ssp.cutoff_fuse(g, comp, 0.02, 25)
    sizes = np.bincount(fused)
    assert len(sizes) < len(np.unique(comp)) and sizes.min() >= 25
    # each given component lies in one fused component
    pairs = np.unique(np.stack([comp, fused], 1), axis=0)
    assert len(np.unique(pairs[:, 0])) == len(pairs)
    # two components of 3 and 30 on a chain: the small one goes
    chain = {"f": np.r_[np.zeros((3, 1)), np.ones((30, 1))],
             "src": np.arange(32), "tgt": np.arange(1, 33),
             "w": np.ones(32)}
    two = np.r_[np.zeros(3, int), np.ones(30, int)]
    assert len(np.unique(ref_ssp.cutoff_fuse(chain, two, 1.0, 25))) == 1
    assert len(np.unique(ref_ssp.cutoff_fuse(chain, two, 1.0, 3))) == 2


def run_small(tmp_path):
    return run.run_cell("vkitti-frame-serve", 2**31 + 977, 0.01, False,
                        device="cpu", traffic_override=FRAME,
                        t_start=time.perf_counter(), workdir=str(tmp_path))


@pytest.mark.parametrize("fault", ["logits", "embeddings", "clouds",
                                   "elevation"])
def test_frame_fault_is_not_correct(fault, monkeypatch, tmp_path):
    """A fault planted in the program reads over its number's limit: the
    logits, the embeddings, the local clouds scaled by half their diameter
    (the embedder, fed them, agrees with the reference's), the elevation
    over the lowest voxel instead of the RANSAC plane."""
    from superpoint_graph_tpu_torch import frame
    from superpoint_graph_tpu_torch.ssp import generate

    if fault == "logits":
        orig = frame.eval_step

        def eval_step(model, batch, *a, **kw):
            loss, logits = orig(model, batch, *a, **kw)
            logits = logits.clone()
            logits[0, 0] += 1.0
            return loss, logits

        monkeypatch.setattr(frame, "eval_step", eval_step)
        number = "logit_err"
    elif fault == "clouds":
        orig = generate.graph_loader

        def graph_loader(*a, **kw):
            sample = orig(*a, **kw)
            sample["clouds"][..., :3] *= 2.0
            return sample

        monkeypatch.setattr(generate, "graph_loader", graph_loader)
        number = "clouds_err"
    elif fault == "elevation":
        orig = frame.serving_structure

        def serving_structure(*a, **kw):
            s = orig(*a, **kw)
            z = s["xyz"][:, 2]
            return dict(s, elevation=z - z.min())

        monkeypatch.setattr(frame, "serving_structure", serving_structure)
        number = "elev_err"
    else:
        orig = generate.embed_cloud

        def embed_cloud(*a, **kw):
            emb, diff = orig(*a, **kw)
            emb = emb.copy()
            emb[0] = -emb[0]
            return emb, diff

        monkeypatch.setattr(generate, "embed_cloud", embed_cloud)
        number = "emb_err"
    out = run_small(tmp_path)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("metric", ["embed_s", "delaunay_s"])
def test_frame_readers_find_nothing_in_a_room_or_scan_record(metric):
    from portbench.harness import manifest

    read = manifest.reader(metric)
    room = {"clouds": [{"times": {"read_s3dis": 2.0, "partition_cloud.spg":
                                  0.7}}], "trace": None}
    assert read(room) is None
    frame = {"clouds": [{"times": {"ssp_embed": 1.1, "delaunay": 9.0}}],
             "trace": None}
    assert read(frame) in (1.1, 9.0)
