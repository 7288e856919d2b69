"""The port's tracer (superpoint_graph_tpu_torch/utils/tracing.py): spans,
stages, counters, counted device-to-host reads, their place on the
profiler's clock, and the serving path's stages and spans (CPU)."""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.utils import tracing

SMALL_MODEL = dict(
    model_config="gru_2_0,f_13",
    ptn_widths=((16, 32), (32, 24, 16)), ptn_widths_stn=((8, 16), (16, 8)),
    ptn_nfeat=14, ptn_nfeat_stn=11, fnet_widths=(13, 16, 24),
    fnet_llbias=False, fnet_bnidx=1,
)
ROOM_TIMES = {"read_s3dis", "partition_cloud", "partition_cloud.features",
              "partition_cloud.partition", "partition_cloud.partition.solve",
              "partition_cloud.partition.merge", "partition_cloud.spg",
              "superpoint_batch", "model", "interpolate_labels"}
# the span of each stage of the room's path, by its key in `times`
ROOM_SPANS = {"read_s3dis": "spgt.read", "partition_cloud": "spgt.partition",
              "partition_cloud.features": "spgt.features",
              "partition_cloud.partition": "spgt.cp",
              "partition_cloud.partition.solve": "spgt.cp.solve",
              "partition_cloud.partition.merge": "spgt.cp.merge",
              "partition_cloud.spg": "spgt.spg",
              "superpoint_batch": "spgt.batch", "model": "spgt.model",
              "interpolate_labels": "spgt.spread"}


@pytest.fixture
def traced():
    """Tracing on within the test; whatever it left uncollected dropped."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room

    path, _, _ = write_s3dis_room(tmp_path_factory.mktemp("s3dis") / "room_0",
                                  np.random.RandomState(3), 1_000)
    return str(path)


@pytest.fixture(scope="module")
def model():
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel

    m = SpgModel(13, **SMALL_MODEL)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.eval()


def label(room, model):
    from superpoint_graph_tpu_torch.data.loader import LoaderConfig
    from superpoint_graph_tpu_torch.room import label_room

    return label_room(room, model, "cpu",
                      loader_cfg=LoaderConfig(ptn_npts=32, ptn_minpts=10))


def by_id(root):
    return {s["id"]: s for s in root["spans"]}


def ancestors(span, ids):
    while span["parent"] is not None:
        span = ids[span["parent"]]
        yield span


def test_off_records_nothing_and_returns_the_shared_noop():
    tracing.collect()
    assert tracing.span("spgt.a") is tracing.NULL
    assert tracing.span("spgt.b", x=1) is tracing.NULL
    assert tracing.detached("spgt.c") is tracing.NULL
    times = {}
    with tracing.span("spgt.a") as s:
        s.set(y=2)
        with tracing.stage("spgt.st", times, "st"):
            out = tracing.to_host(torch.ones(3), "test")
            tracing.count("c")
    assert out.tolist() == [1.0, 1.0, 1.0]
    assert set(times) == {"st"} and times["st"] >= 0.0
    assert tracing.collect() == []


def test_spans_nest_with_parent_and_cloud_ids(traced):
    with tracing.span("spgt.cloud", path="test") as root:
        with tracing.span("spgt.a"):
            with tracing.span("spgt.b", i=1):
                pass
        root.set(raw_points=7)
    with tracing.span("spgt.cloud", path="other"):
        pass
    first, second = tracing.collect()
    assert tracing.collect() == []
    assert first["name"] == "spgt.cloud" and first["parent"] is None
    assert first["attrs"] == {"path": "test", "raw_points": 7}
    ids = by_id(first)
    a = next(s for s in first["spans"] if s["name"] == "spgt.a")
    b = next(s for s in first["spans"] if s["name"] == "spgt.b")
    assert b["parent"] == a["id"] and a["parent"] == first["id"]
    assert {s["cloud"] for s in ids.values()} == {first["id"]}
    assert b["attrs"] == {"i": 1}
    assert second["id"] != first["id"] and len(second["spans"]) == 1


def test_self_time_is_duration_less_children(traced):
    with tracing.span("spgt.cloud"):
        with tracing.span("spgt.a"):
            time.sleep(0.002)
            for _ in range(3):
                with tracing.span("spgt.b"):
                    time.sleep(0.001)
    (root,) = tracing.collect()
    ids = by_id(root)
    for s in ids.values():
        kids = [c for c in ids.values() if c["parent"] == s["id"]]
        dur = s["end_ns"] - s["start_ns"]
        assert s["self_ns"] == dur - sum(c["end_ns"] - c["start_ns"]
                                         for c in kids)
    summ = tracing.summary(root)["spans"]
    assert summ["spgt.b"]["count"] == 3
    assert summ["spgt.a"]["self_s"] >= 0.002
    assert summ["spgt.a"]["seconds"] == pytest.approx(
        summ["spgt.a"]["self_s"] + summ["spgt.b"]["seconds"])
    # stages: self time less the stages inside, whether tracing is on or off
    for on in (True, False):
        (tracing.enable if on else tracing.disable)()
        times = {}
        with tracing.stage("spgt.outer", times, "outer") as outer:
            with tracing.stage("spgt.inner", times, "inner"):
                time.sleep(0.002)
            with tracing.stage(None, times, "inner"):
                time.sleep(0.001)
        assert times["inner"] >= 0.003
        assert outer.self_s == pytest.approx(outer.seconds - times["inner"])
        assert times["outer"] == outer.seconds


def test_counters_and_to_host_count_reads_and_bytes(traced):
    with tracing.span("spgt.cloud"):
        a = tracing.to_host(torch.arange(10, dtype=torch.float32), "x")
        b = tracing.to_host(torch.zeros((2, 3), dtype=torch.int64), "y")
        tracing.count("rows", 5)
        tracing.count("rows")
    tracing.count("outside")   # no root: not counted anywhere
    (root,) = tracing.collect()
    assert a.tolist() == list(range(10)) and b.shape == (2, 3)
    assert root["counters"] == {"d2h.reads": 2, "d2h.bytes": 40 + 48,
                                "rows": 6}
    d2h = [s for s in root["spans"] if s["name"] == "spgt.d2h"]
    assert [s["attrs"] for s in d2h] == [{"site": "x", "bytes": 40},
                                         {"site": "y", "bytes": 48}]
    assert root["dropped"] == 0


def test_threads_count_and_nest_into_one_root_without_lost_updates(traced):
    """Many threads under one root (`within`), switching often: no count
    and no child's time is lost."""
    import sys

    n_threads, n_each = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        root = tracing.detached("spgt.cloud")

        def work():
            with tracing.within(root):
                for _ in range(n_each):
                    with tracing.span("spgt.step"):
                        tracing.count("steps")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        root.close()
    finally:
        sys.setswitchinterval(switch)
    (got,) = tracing.collect()
    steps = [s for s in got["spans"] if s["name"] == "spgt.step"]
    assert got["counters"] == {"steps": n_threads * n_each}
    assert len(steps) == n_threads * n_each
    assert got["self_ns"] == (got["end_ns"] - got["start_ns"]
                              - sum(s["end_ns"] - s["start_ns"]
                                    for s in steps))


def test_buffer_is_bounded(traced, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 4)
    with tracing.span("spgt.cloud"):
        for _ in range(10):
            with tracing.span("spgt.a"):
                pass
    (root,) = tracing.collect()
    assert len(root["spans"]) <= 5 and root["dropped"] >= 6
    assert len(root["spans"]) + root["dropped"] == 11


def test_spans_appear_in_the_profiler_with_their_durations(traced):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("spgt.cloud"):
            for i in range(3):
                with tracing.span("spgt.step", i=i):
                    time.sleep(0.002 * (i + 1))
                    tracing.to_host(torch.ones(1000).cumsum(0), "t")
    (root,) = tracing.collect()
    events = {}
    for e in prof.events():
        if e.name.startswith("spgt."):
            events.setdefault(e.name, []).append(e)
    spans = {}
    for s in root["spans"]:
        spans.setdefault(s["name"], []).append(s)
    assert set(spans) == set(events) == {"spgt.cloud", "spgt.step",
                                         "spgt.d2h"}
    for name, recs in spans.items():
        evs = sorted(events[name], key=lambda e: e.time_range.start)
        recs = sorted(recs, key=lambda s: s["start_ns"])
        assert len(evs) == len(recs)
        for e, s in zip(evs, recs):
            ours = (s["end_ns"] - s["start_ns"]) * 1e-3
            theirs = e.time_range.end - e.time_range.start
            assert abs(ours - theirs) < 500.0, (name, ours, theirs)


def test_partition_clouds_worker_spans_nest_under_their_cloud(traced,
                                                              monkeypatch):
    from superpoint_graph_tpu_torch import pipeline
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig

    threads = []
    features = pipeline._features_stage

    def spy(*args):
        threads.append(threading.get_ident())
        return features(*args)

    monkeypatch.setattr(pipeline, "_features_stage", spy)
    rng = np.random.RandomState(0)
    clouds = [(rng.rand(400, 3).astype(np.float32),
               rng.randint(0, 255, (400, 3)).astype(np.uint8), None, None)
              for _ in range(2)]
    res = pipeline.partition_clouds(clouds, PartitionConfig(
        voxel_width=0.05, k_nn_geof=10, k_nn_adj=5, spg_adjacency="knn"),
        device="cpu")
    assert len(res) == 2 and threading.get_ident() not in threads
    roots = tracing.collect()
    assert [r["attrs"]["index"] for r in roots] == [0, 1]
    for root in roots:
        ids = by_id(root)
        names = {s["name"] for s in ids.values()}
        assert {"spgt.features.prune", "spgt.features.knn", "spgt.cp",
                "spgt.cp.solve", "spgt.spg"} <= names
        for s in ids.values():
            assert s["cloud"] == root["id"]
            assert s["id"] == root["id"] or root["id"] in [
                a["id"] for a in ancestors(s, ids)]


def test_label_room_keeps_its_times_and_each_stage_has_its_span(room, model):
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import (
        LAST_SOLVE_STATS)

    tracing.collect()
    tracing.enable()
    try:
        on = label(room, model)
    finally:
        tracing.disable()
    (root,) = tracing.collect()
    assert set(on.times) == ROOM_TIMES
    assert root["name"] == "spgt.cloud"
    assert root["attrs"] == {"path": "room", "raw_points": len(on.labels)}
    summ = tracing.summary(root)
    for key, name in ROOM_SPANS.items():
        got = summ["spans"][name]["seconds"]
        assert 0.0 <= got - on.times[key] < 0.005, (key, name)
    assert {"spgt.read.parse", "spgt.read.labels", "spgt.features.prune",
            "spgt.features.knn", "spgt.features.geof", "spgt.features.fetch",
            "spgt.spg.cross_edges", "spgt.spg.components",
            "spgt.spg.superedges", "spgt.batch.parsed_entries",
            "spgt.batch.spg_entry", "spgt.batch.sample",
            "spgt.batch.collate", "spgt.spread.nn1", "spgt.spread.gather",
            "spgt.nn1", "spgt.d2h"} <= set(summ["spans"])
    c = summ["counters"]
    assert c["nn1.calls"] == 2 and c["parse.rows"] > len(on.labels)
    assert c["cp.solve_iters"] == LAST_SOLVE_STATS["iters"]
    assert c["d2h.reads"] == summ["spans"]["spgt.d2h"]["count"]
    assert c["d2h.reads"] >= LAST_SOLVE_STATS["host_syncs"]

    # the reads inside the device solve: the solver's own (its
    # LAST_SOLVE_STATS["host_syncs"]: one a CC round, one an outer
    # iteration, the final energy), and one more, the labels' fetch after
    # the solve (cutpursuit_band_device), which host_syncs does not count
    ids = by_id(root)
    solve = next(s for s in ids.values() if s["name"] == "spgt.cp.solve")
    sites = [s["attrs"]["site"] for s in ids.values()
             if s["name"] == "spgt.d2h"
             and solve["id"] in [a["id"] for a in ancestors(s, ids)]]
    assert len(sites) == LAST_SOLVE_STATS["host_syncs"] + 1
    assert sites.count("cp.solve.labels") == 1
    assert (sites.count("cp.solve.loop") + sites.count("cp.solve.energy")
            == LAST_SOLVE_STATS["host_syncs"])


CP_KEYS = {"n", "n_chunks", "morton", "solve_iters", "prep", "solve",
           "chunk_merge", "heal", "group", "host_edges", "merge_reduce",
           "merge_rounds", "heal_reduce", "heal_rounds", "heal_regions_in",
           "heal_regions_out", "host_syncs", "host_syncs_per_chunk",
           "cc_capped", "cc_rounds_max", "other"}


def test_chunked_solve_stats_are_its_stages_and_spans(traced):
    """The giant-cloud solver's LAST_CP_STATS keeps its keys; its seconds
    are its stages' (the windows' merges and the heal's apart), "other"
    the call's time outside them; each window is a span, its solver's reads
    are LAST_CP_STATS["host_syncs"]."""
    from superpoint_graph_tpu_torch import pipeline_big
    from superpoint_graph_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(1)
    xyz = torch.from_numpy(rng.rand(800, 3).astype(np.float32))
    idx, d2 = knn(xyz, 5)
    f = torch.from_numpy(rng.rand(800, 4).astype(np.float32))
    with tracing.span("spgt.cloud"):
        pipeline_big.chunked_cutpursuit_device(f, idx, d2, xyz, 0.05,
                                               chunk_points=400)
    st = pipeline_big.LAST_CP_STATS
    assert set(st) == CP_KEYS and st["n_chunks"] > 1
    (root,) = tracing.collect()
    summ = tracing.summary(root)
    spans, c = summ["spans"], summ["counters"]
    assert spans["spgt.cp.window"]["count"] == c["cp.windows"] == \
        st["n_chunks"]
    assert c["cp.solve_iters"] == sum(st["solve_iters"])
    for key, name in (("morton", "spgt.cp.morton"), ("prep", "spgt.cp.prep"),
                      ("solve", "spgt.cp.solve"),
                      ("chunk_merge", "spgt.cp.window_merge"),
                      ("heal", "spgt.cp.heal"), ("group", "spgt.cp.relabel"),
                      ("host_edges", "spgt.cp.relabel.edges"),
                      ("merge_reduce", "spgt.cp.merge.reduce"),
                      ("merge_rounds", "spgt.cp.merge.rounds")):
        assert 0.0 <= spans[name]["seconds"] - st[key] < 0.005, key
    ids = by_id(root)
    heal = next(s for s in ids.values() if s["name"] == "spgt.cp.heal")
    in_heal = [s for s in ids.values() if heal["id"] in
               [a["id"] for a in ancestors(s, ids)]]
    heal_reduce = sum(s["end_ns"] - s["start_ns"] for s in in_heal
                      if s["name"] == "spgt.cp.merge.reduce") * 1e-9
    assert 0.0 <= heal_reduce - st["heal_reduce"] < 0.005
    timed = sum(st[k] for k in ("morton", "prep", "solve", "chunk_merge",
                                "heal", "group"))
    assert st["other"] >= 0.0
    whole = sum(s["end_ns"] - s["start_ns"] for s in ids.values()
                if s["name"] == "spgt.cloud") * 1e-9
    assert timed + st["other"] <= whole
    reads = [s["attrs"]["site"] for s in ids.values()
             if s["name"] == "spgt.d2h"]
    assert (reads.count("cp.solve.loop") + reads.count("cp.solve.energy")
            == st["host_syncs"])
    assert reads.count("cp.window.labels") == st["n_chunks"]


def _evt(name, start, end, device=False, annotation=False):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_name_idle_names_gaps_by_the_innermost_program_span():
    events = [
        _evt("spgt.cloud", 0.0, 100.0),
        _evt("spgt.read", 0.0, 12.0),
        _evt("spgt.read.parse", 0.0, 9.0),
        _evt("spgt.spg", 20.0, 45.0),
        _evt("kernel_a", 10.0, 20.0, device=True),
        _evt("kernel_b", 50.0, 60.0, device=True),
        # the device-side echo of a span is not work
        _evt("spgt.spg", 20.0, 45.0, device=True, annotation=True),
        # a kernel outside the profiled cloud is cut away
        _evt("kernel_c", 120.0, 130.0, device=True),
    ]
    got = tracing.name_idle(events)
    assert got["idle_s"] == pytest.approx((10 + 30 + 40) * 1e-6)
    # [45, 50] and [60, 100] lie in spgt.cloud alone: not named
    assert got["named_s"] == pytest.approx((9 + 1 + 25) * 1e-6)
    assert got["by_span"] == pytest.approx({
        "not named": 45e-6, "spgt.spg": 25e-6, "spgt.read.parse": 9e-6,
        "spgt.read": 1e-6})
    # each stretch after the innermost span at its middle
    assert [g[0] for g in got["gaps"]] == ["not named", "spgt.spg",
                                           "spgt.read.parse"]
    assert tracing.name_idle(events[1:]) == {
        "idle_s": 0.0, "named_s": 0.0, "by_span": {}, "gaps": []}


def test_name_idle_names_by_every_threads_program_spans():
    """The profiler holds the calling thread's spans only; with `program`
    (the root from `collect()`) the tracer's records of every thread name
    the idle time, moved onto the profiler's clock by the root's start,
    the shorter span where two threads' spans overlap."""
    events = [
        _evt("spgt.cloud", 1000.0, 1100.0),
        _evt("spgt.spg.delaunay", 1010.0, 1090.0),
        _evt("kernel_a", 1020.0, 1030.0, device=True),
        _evt("kernel_b", 1060.0, 1070.0, device=True),
    ]
    alone = tracing.name_idle(events)
    assert alone["by_span"] == pytest.approx({
        "spgt.spg.delaunay": 60e-6, "not named": 20e-6})

    def rec(name, start_us, end_us):
        return {"name": name, "start_ns": int(start_us * 1000),
                "end_ns": int(end_us * 1000)}

    # the tracer's clock runs 4,000 us ahead; embed and the wait ran on a
    # worker thread, the triangulation on the calling one
    program = dict(rec("spgt.cloud", 5000, 5100), spans=[
        rec("spgt.cloud", 5000, 5100),
        rec("spgt.spg.delaunay", 5010, 5090),
        rec("spgt.ssp.embed", 5005, 5040),
        rec("spgt.spg.delaunay_wait", 5045, 5095)])
    got = tracing.name_idle(events, program=program)
    assert got["idle_s"] == pytest.approx(80e-6)
    assert got["named_s"] == pytest.approx(70e-6)
    assert got["by_span"] == pytest.approx({
        "spgt.spg.delaunay_wait": 40e-6, "spgt.ssp.embed": 25e-6,
        "not named": 10e-6, "spgt.spg.delaunay": 5e-6})
    assert got["gaps"] == [["spgt.spg.delaunay_wait", pytest.approx(30e-6)],
                           ["spgt.spg.delaunay_wait", pytest.approx(30e-6)],
                           ["spgt.ssp.embed", pytest.approx(20e-6)]]
    # a profile without the root names nothing, program or not
    assert tracing.name_idle(events[1:], program=program)["idle_s"] == 0.0
