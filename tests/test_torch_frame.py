"""frame.label_frame (the learned partition, then the SPG, on a raw vKITTI3D
frame) against the benchmark's plain reference (portbench/reference/ssp.py
for the embedder, the partition's energy and the Delaunay superedges,
portbench/reference/model.py for the SPG model), on seeded random weights,
at a small frame on the CPU."""
import numpy as np
import pytest
import torch

from portbench.harness import compare, frames
from portbench.harness.serve import graph_of
from portbench.harness.weights import draw_weights
from portbench.reference import cloud as ref_cloud
from portbench.reference import model as ref_model
from portbench.reference import partition as ref_partition
from portbench.reference import ssp as ref_ssp
from superpoint_graph_tpu_torch import frame
from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
from superpoint_graph_tpu_torch.ops import cutpursuit_band
from superpoint_graph_tpu_torch.ssp.embed import LocalEmbedder, SspModelConfig
from superpoint_graph_tpu_torch.utils import tracing

EMBEDDER = {"ptn_widths": [[32, 128], [34, 32, 32, 4]],
            "ptn_widths_stn": [[16, 64], [32, 16]], "ptn_nfeat_stn": 2,
            "use_rgb": True, "global_feat": "eXYrgb", "stn_as_global": True,
            "ptn_norm": "batch", "ptn_prelast_do": 0.0}
MODEL = {"n_classes": 13, "model_config": "gru_3_1_1_1_0,f_13",
         "ptn_widths": [[16, 16, 32], [16, 16]],
         "ptn_widths_stn": [[8, 16], [16]], "ptn_nfeat": 9,
         "ptn_nfeat_stn": 9, "ptn_prelast_do": 0.0,
         "fnet_widths": [13, 16], "fnet_llbias": False, "fnet_bnidx": -1}
POINTS = 8000
REG = frame.LOSS.reg_strength / (4 * frame.LOSS.k_nn_adj)
# E_prog / E_ref - 1 at this size (test_partition_energy_and_count_...)
CP_GAP_BOUND = 3.0


def embedder(weights):
    cfg = dict(EMBEDDER, ptn_widths=((32, 128), (34, 32, 32, 4)),
               ptn_widths_stn=((16, 64), (32, 16)))
    m = LocalEmbedder(SspModelConfig(**cfg))
    m.load_state_dict(weights, strict=True)
    return m.eval()


def spg_model(weights):
    kw = {k: (tuple(map(tuple, v)) if k.startswith("ptn_widths")
              else tuple(v) if k == "fnet_widths" else v)
          for k, v in MODEL.items() if k != "n_classes"}
    m = SpgModel(MODEL["n_classes"], **kw)
    m.load_state_dict(weights, strict=True)
    return m.eval()


def label(path, emb_w, model_w):
    """(the frame's labels, its one root span as `tracing.collect` gives
    it)."""
    tracing.collect()
    tracing.enable()
    try:
        out = frame.label_frame(str(path), embedder(emb_w),
                                spg_model(model_w), "cpu")
    finally:
        tracing.disable()
    (root,) = tracing.collect()
    return out, root


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = tmp_path_factory.mktemp("frame") / "frame.npy"
    frames.write_vkitti_frame(path, np.random.RandomState(4), POINTS)
    emb_w = frames.draw_embedder(EMBEDDER, 11, "cpu")
    model_w = draw_weights(MODEL, 12, "cpu")
    out, root = label(path, emb_w, model_w)
    return {"path": path, "out": out, "root": root,
            "summary": tracing.summary(root), "emb_w": emb_w,
            "model_w": model_w, "raw": ref_ssp.read_frame(str(path))}


def reference_graph(served):
    """The reference's own graph of the frame: its voxels, its float64 kNN
    local clouds (its elevation over its RANSAC plane) and embeddings."""
    xyz, rgb, labels = served["raw"]
    vox = ref_cloud.prune(xyz, frame.PREPROCESS.voxel_width, rgb, labels, 13)
    clouds, globals_, nbr, _ = ref_ssp.local_clouds(
        vox["xyz"], vox["rgb"], ref_ssp.plane_elevation(vox["xyz"]),
        EMBEDDER, 20)
    emb = ref_ssp.embed(served["emb_w"], EMBEDDER, torch.as_tensor(clouds),
                        torch.as_tensor(globals_)).numpy()
    return vox, ref_ssp.partition_graph(emb, vox["xyz"], nbr[:, :5], 0.2)


def reference_solve(g):
    """The reference's greedy solve with the cutoff fuse."""
    return ref_ssp.cutoff_fuse(g, ref_partition.greedy(g, REG, "cpu"), REG,
                               frame.LOSS.CP_cutoff)


def test_reads_and_prunes_as_the_reference(served):
    out = served["out"]
    xyz, rgb, labels = served["raw"]
    vox = ref_cloud.prune(xyz, frame.PREPROCESS.voxel_width, rgb, labels, 13)
    assert compare.prune_off(out.partition, vox) == 0
    np.testing.assert_array_equal(out.raw_labels, labels)


def test_embeddings_match_the_reference(served):
    """Same float32 products in another order and blocking: within 1e-5
    of a unit vector's coordinates."""
    s = served["out"].embedding
    want = ref_ssp.embed(served["emb_w"], EMBEDDER,
                         torch.as_tensor(s.sample["clouds"]),
                         torch.as_tensor(s.sample["clouds_global"])).numpy()
    assert compare.max_abs(s.embeddings, want) < 1e-5


def test_local_clouds_and_elevation_match_the_reference(served):
    """The local clouds and global features against the reference's from
    its float64 search and its own RANSAC plane: the same neighbourhoods
    but where two neighbours tie, within float32 rounding of coordinates
    scaled by a local diameter (1e-4); the elevation within 1e-5 m."""
    s = served["out"].embedding.sample
    xyz, rgb, labels = served["raw"]
    vox = ref_cloud.prune(xyz, frame.PREPROCESS.voxel_width, rgb, labels, 13)
    elevation = ref_ssp.plane_elevation(vox["xyz"])
    clouds, globals_, _, gap = ref_ssp.local_clouds(
        vox["xyz"], vox["rgb"], elevation, EMBEDDER, 20)
    assert compare.max_abs(s["clouds_global"][:, 1], elevation) < 1e-5
    keep = gap > 5e-5
    assert keep.mean() > 0.95
    close = np.abs(np.sort(clouds, 1) - np.sort(s["clouds"], 1)).max((1, 2))
    assert close[keep].max() < 1e-4
    assert compare.max_abs(s["clouds_global"][keep], globals_[keep]) < 1e-4


def test_logits_match_the_reference(served):
    """The SPG model's float32 sums in another order: 1e-4 of the largest
    logit (the benchmark's cells read 1e-6 to 1e-5 at full widths)."""
    out = served["out"]
    want = ref_model.forward(served["model_w"], MODEL,
                             graph_of(out.batch)).numpy()
    assert compare.logit_err(out.logits, want) < 1e-4


def test_partition_energy_and_count_against_the_greedy_reference(served):
    """The learned partition's l0 energy on the reference's graph, over the
    greedy reference solve's with the cutoff fuse. The device solver, its
    merge and its cutoff fuse read 0.46-0.59 over it on two frames of this
    size, with about 0.8 of its components; one component a voxel reads
    4.0-4.1, a solver stopped after its first iteration 17.6-18.0 (test
    below). So the bound is 3. The count is at most the reference's."""
    _, g = reference_graph(served)
    comp = reference_solve(g)
    e_ref = ref_partition.energy(g, comp, REG)
    part = served["out"].partition
    gap = ref_partition.energy(g, part.in_component, REG) / e_ref - 1
    assert gap < CP_GAP_BOUND
    assert len(part.components) <= len(np.unique(comp))
    single = ref_partition.energy(g, np.arange(len(comp)), REG) / e_ref - 1
    assert single > CP_GAP_BOUND


def test_stopped_solver_reads_above_the_bound(served, monkeypatch):
    orig = cutpursuit_band.solve
    monkeypatch.setattr(cutpursuit_band, "solve",
                        lambda *a, **kw: orig(*a, **dict(kw, max_iter=1)))
    out, _ = label(served["path"], served["emb_w"], served["model_w"])
    _, g = reference_graph(served)
    e_ref = ref_partition.energy(g, reference_solve(g), REG)
    gap = ref_partition.energy(g, out.partition.in_component, REG) / e_ref - 1
    assert gap > CP_GAP_BOUND


def test_delaunay_superedges_match_the_reference(served):
    """The same Delaunay of the same float32 voxels, so the same superedge
    set; the features' float64 sums over float32 or float64 voxels: 1e-5
    relative."""
    part = served["out"].partition
    src, tgt = ref_ssp.delaunay_edges(part.xyz, 100.0)
    want = ref_cloud.superedges(part.xyz.astype(np.float64),
                                part.in_component, src, tgt)
    off, err = compare.superedge_diff(
        compare.program_superedges(part.graph_sp), want)
    assert off == 0 and err < 1e-5


def test_spread_gives_each_raw_point_a_nearest_voxel_class(served):
    out = served["out"]
    xyz = served["raw"][0]
    rows = np.random.RandomState(0).choice(len(xyz), 512, replace=False)
    cls = np.zeros(len(out.partition.xyz), np.int64)
    for c, comp in enumerate(out.partition.components):
        cls[np.asarray(comp, np.int64)] = out.logits[c].argmax()
    near = ref_cloud.nearest(out.partition.xyz, xyz[rows], "cpu")
    assert all(out.labels[r] in set(cls[t].tolist())
               for r, t in zip(rows, near))


def test_spans_counters_counts_and_times(served):
    out, s = served["out"], served["summary"]
    for name in ("spgt.cloud", "spgt.read", "spgt.features", "spgt.ssp.embed",
                 "spgt.ssp.local_clouds", "spgt.cp", "spgt.spg",
                 "spgt.spg.delaunay", "spgt.spg.delaunay_wait", "spgt.batch",
                 "spgt.model", "spgt.spread"):
        assert name in s["spans"], name
    c = s["counters"]
    n = len(out.partition.xyz)
    assert c["ssp.vertices"] == n
    assert c["ssp.local_points"] == 20 * n
    assert c["ssp.edges"] == 5 * n
    assert c["delaunay.simplices"] > n
    assert out.counts["raw_points"] == POINTS
    assert out.counts["voxels"] == n
    assert out.counts["superpoints"] == len(out.partition.components)
    for key in ("read_vkitti", "partition_cloud.features", "ssp_embed",
                "partition_cloud.partition", "delaunay", "delaunay_wait",
                "partition_cloud.spg", "superpoint_batch", "model",
                "interpolate_labels"):
        assert isinstance(out.times[key], float), key


def test_embeddings_in_blocks_equal_the_whole(served, monkeypatch):
    """The embedder takes EMBED_ROWS rows at a time; in eval mode the rows
    are independent, so blocks of any size give the whole cloud's
    embeddings (float32 products of other shapes: 1e-6)."""
    from superpoint_graph_tpu_torch.ssp import embed, generate

    s = served["out"].embedding
    monkeypatch.setattr(embed, "EMBED_ROWS", 1000)
    emb, diff = generate.embed_cloud(embedder(served["emb_w"]), s.sample,
                                     "euclidian", "cpu")
    assert compare.max_abs(emb, s.embeddings) < 1e-6
    assert compare.max_abs(diff, s.diff) < 1e-5


def test_delaunay_cross_edges_equal_the_column_unique(served):
    """The frame's Delaunay cross edges, deduplicated as int64 keys, are
    `_cross_edges`' columns (np.unique over axis 1) of the same
    tetrahedra, in the same order and dtype."""
    from scipy.spatial import Delaunay

    from superpoint_graph_tpu_torch.graph import spg

    part = served["out"].partition
    comp = np.asarray(part.in_component).astype(np.int64)
    tets = Delaunay(part.xyz).simplices
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    src = np.concatenate([tets[:, a] for a, _ in pairs])
    tgt = np.concatenate([tets[:, b] for _, b in pairs])
    want = spg._cross_edges(src, tgt, comp)
    got = spg._delaunay_cross_edges(part.xyz, comp)
    assert got.dtype == want.dtype and want.shape[1] > 0
    np.testing.assert_array_equal(got, want)


def test_serving_knn_in_fixed_tiles_equals_row_blocks(served, monkeypatch):
    """The serving structure's kNN takes TILE_ELEMS // n query rows a
    block (here a few hundred, TILE_ELEMS lowered) instead of 2048: every
    row's neighbours are picked and re-ranked on their own, so the graph
    and the local neighbours are the same."""
    from superpoint_graph_tpu_torch.ops import knn

    xyz = served["out"].partition.xyz
    want_g, want_l = knn.compute_graph_nn_2(xyz, 5, 20, device="cpu")
    monkeypatch.setattr(knn, "TILE_ELEMS", 300 * len(xyz))
    got_g, got_l = knn.compute_graph_nn_2(xyz, 5, 20, device="cpu",
                                          block_q=None)
    for key in ("source", "target", "distances"):
        np.testing.assert_array_equal(got_g[key], want_g[key])
    assert torch.equal(got_l, want_l)


def sp_graph_input(served):
    """compute_sp_graph's arguments on the frame: the SPG's voxels, the
    learned components and the voxels' label histograms."""
    emb = served["out"].embedding
    return (emb.sample["xyz"], 100.0, emb.in_component,
            emb.sample["labels"], 13)


def test_a_delaunay_job_gives_the_inline_graph(served):
    """The SPG of a triangulation run by another thread (DelaunayJob)
    equals, key for key and bit for bit, the one triangulated in line;
    the job adds the wait to the times, and both give the triangulation's
    own seconds under "delaunay"."""
    import threading

    from superpoint_graph_tpu_torch.graph import spg

    args = sp_graph_input(served)
    inline_t, job_t = {}, {}
    want = spg.compute_sp_graph(*args, device="cpu", times=inline_t)
    job = spg.DelaunayJob()
    other = threading.Thread(target=job.run, args=(args[0],))
    other.start()
    got = spg.compute_sp_graph(*args, device="cpu", times=job_t,
                               delaunay=job)
    other.join(timeout=60)
    assert not other.is_alive()
    assert set(got) == set(want) and len(want["source"]) > 0
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    assert set(inline_t) == {"delaunay"}
    assert set(job_t) == {"delaunay", "delaunay_wait"}
    assert all(v >= 0 for v in job_t.values())


def test_a_delaunay_job_of_other_voxels_is_not_used(served):
    """A job that triangulated another array (the voxels reversed) is
    waited for and set aside, and the Delaunay computed in line: the
    in-line graph."""
    from superpoint_graph_tpu_torch.graph import spg

    args = sp_graph_input(served)
    want = spg.compute_sp_graph(*args, device="cpu")
    job = spg.DelaunayJob()
    job.run(args[0][::-1])
    times = {}
    got = spg.compute_sp_graph(*args, device="cpu", times=times,
                               delaunay=job)
    for key in ("source", "target", "se_delta_mean", "sp_centroids"):
        np.testing.assert_array_equal(got[key], want[key])
    assert set(times) == {"delaunay", "delaunay_wait"}


def test_an_error_in_the_delaunay_job_surfaces(served, monkeypatch):
    from superpoint_graph_tpu_torch.graph import spg

    def fails(xyz):
        raise RuntimeError("QH6154 qhull precision error")

    monkeypatch.setattr(spg, "Delaunay", fails)
    args = sp_graph_input(served)
    job = spg.DelaunayJob()
    job.run(args[0])
    with pytest.raises(RuntimeError, match="QH6154"):
        spg.compute_sp_graph(*args, device="cpu", delaunay=job)


def test_label_frame_triangulates_once_in_the_calling_thread(
        served, monkeypatch):
    """The benchmark's traced run names idle time by replacing
    `spg.Delaunay` with a wrapper: a frame still runs what the module
    holds, once, in the calling thread, while its SPG runs on another."""
    import threading

    from scipy.spatial import Delaunay

    from superpoint_graph_tpu_torch.graph import spg
    from superpoint_graph_tpu_torch.ssp import generate

    threads = {"Delaunay": [], "compute_sp_graph": []}

    def counted(xyz):
        threads["Delaunay"].append(threading.get_ident())
        return Delaunay(xyz)

    orig = generate.compute_sp_graph

    def sp_graph(*a, **kw):
        threads["compute_sp_graph"].append(threading.get_ident())
        return orig(*a, **kw)

    monkeypatch.setattr(spg, "Delaunay", counted)
    monkeypatch.setattr(generate, "compute_sp_graph", sp_graph)
    out = frame.label_frame(str(served["path"]), embedder(served["emb_w"]),
                            spg_model(served["model_w"]), "cpu")
    me = threading.get_ident()
    assert threads["Delaunay"] == [me]
    assert len(threads["compute_sp_graph"]) == 1
    assert threads["compute_sp_graph"][0] != me
    np.testing.assert_array_equal(out.partition.graph_sp["source"],
                                  served["out"].partition.graph_sp["source"])
    assert "delaunay_wait" in out.times


def test_an_error_in_the_frame_stages_surfaces(served, monkeypatch):
    """A stage that fails on the worker thread, after or before the
    voxels are handed over, fails the call; nothing waits forever."""
    from superpoint_graph_tpu_torch.ssp import generate

    def embed_fails(*a, **kw):
        raise RuntimeError("the embedder failed")

    def prune_fails(*a, **kw):
        raise RuntimeError("the prune failed")

    args = (str(served["path"]), embedder(served["emb_w"]),
            spg_model(served["model_w"]), "cpu")
    monkeypatch.setattr(generate, "embed_cloud", embed_fails)
    with pytest.raises(RuntimeError, match="embedder failed"):
        frame.label_frame(*args)
    monkeypatch.setattr(frame, "serving_structure", prune_fails)
    with pytest.raises(RuntimeError, match="prune failed"):
        frame.label_frame(*args)


def test_a_structure_that_hands_over_no_voxels_triangulates_in_line(
        served, monkeypatch):
    """A `serving_structure` that never calls `on_voxels` leaves the SPG
    to triangulate in line, with the same superedges."""
    orig = frame.serving_structure

    def silent(*a, on_voxels=None, **kw):
        return orig(*a, **kw)

    monkeypatch.setattr(frame, "serving_structure", silent)
    out = frame.label_frame(str(served["path"]), embedder(served["emb_w"]),
                            spg_model(served["model_w"]), "cpu")
    assert "delaunay" in out.times and "delaunay_wait" not in out.times
    np.testing.assert_array_equal(out.partition.graph_sp["source"],
                                  served["out"].partition.graph_sp["source"])


def test_the_frame_triangulation_traces_under_the_frame_root(served):
    """One root, `spgt.cloud`, a frame. The calling thread's
    `spgt.spg.delaunay` is its child, begun after the worker's
    `spgt.features` began (the prune hands the voxels over) and before
    its `spgt.spg`, and ended before the wait inside `spgt.spg` ended;
    the simplices are counted on the root. The root's self time is its
    seconds less all its children's, the overlapped triangulation among
    them, so it can read below zero; the serve-trace tool prints such a
    self time as "overlapped"."""
    import importlib.util
    from pathlib import Path

    root, summary = served["root"], served["summary"]
    assert root["name"] == "spgt.cloud" and root["parent"] is None
    by_name = {}
    for rec in root["spans"]:
        by_name.setdefault(rec["name"], []).append(rec)
    (tri,) = by_name["spgt.spg.delaunay"]
    (wait,) = by_name["spgt.spg.delaunay_wait"]
    (features,) = by_name["spgt.features"]
    (spg_stage,) = by_name["spgt.spg"]
    assert tri["parent"] == root["id"] == features["parent"]
    assert features["start_ns"] <= tri["start_ns"] <= spg_stage["start_ns"]
    assert (spg_stage["start_ns"] <= wait["start_ns"]
            and wait["end_ns"] <= spg_stage["end_ns"])
    assert tri["end_ns"] <= wait["end_ns"]
    assert summary["counters"]["delaunay.simplices"] > 0
    children = sum(r["end_ns"] - r["start_ns"] for r in root["spans"]
                   if r["parent"] == root["id"])
    assert root["self_ns"] == root["end_ns"] - root["start_ns"] - children

    tool = Path(__file__).resolve().parents[1] / "tools/torch_serve_trace.py"
    spec = importlib.util.spec_from_file_location("torch_serve_trace", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shown = mod.overlapped(summary["spans"])
    for name, e in summary["spans"].items():
        assert shown[name]["self_s"] == (
            "overlapped" if e["self_s"] < 0 else e["self_s"]), name
    assert mod.overlapped({"spgt.cloud": {"seconds": 1.0, "self_s": -0.5,
                                          "count": 1}})[
        "spgt.cloud"]["self_s"] == "overlapped"


def test_idle_of_a_profiled_frame_is_named_by_the_worker_spans(served):
    """Under torch.profiler, started by the calling thread, the frame's
    idle time is named from the tracer's records of both threads: the
    worker's stages (the embedder, the wait for the tetrahedra) as well
    as the calling thread's triangulation."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    tracing.collect()
    tracing.enable()
    try:
        with prof:
            frame.label_frame(str(served["path"]), embedder(served["emb_w"]),
                              spg_model(served["model_w"]), "cpu")
    finally:
        tracing.disable()
    (root,) = tracing.collect()
    named = tracing.name_idle(prof.events(), program=root)
    # no kernels on the CPU: the whole frame is idle
    assert named["idle_s"] == pytest.approx(
        (root["end_ns"] - root["start_ns"]) * 1e-9, rel=1e-3)
    assert sum(named["by_span"].values()) == pytest.approx(named["idle_s"])
    for worker in ("spgt.features", "spgt.ssp.embed", "spgt.spg.components"):
        assert any(k.startswith(worker) for k in named["by_span"]), worker
    assert {"spgt.spg.delaunay", "spgt.spg.delaunay_wait"} & set(
        named["by_span"])
