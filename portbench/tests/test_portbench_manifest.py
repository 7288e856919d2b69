"""BENCHMARK.json against the benchmark's contract, and every file it names
resolving by name."""
import json
import re

import pytest

from portbench.harness import manifest

BENCH = manifest.load()
NAME = manifest.NAME
UNIT = manifest.UNIT
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_entry_keys(group):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[group]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and group != "end_to_end" and group != "per_layer":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if group == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert 1 <= len(e["layer"]) <= 200
        if group == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25


def test_every_cell_resolves_by_name():
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        used.add(w["config"])
        cfg = manifest.config(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        traffic = manifest.traffic(w["traffic"])
        assert isinstance(manifest.loop(traffic["loop"]), type)
        assert manifest.limits(w["name"])
        for traced in (False, True):
            group = manifest.metrics_of(BENCH, w["name"], traced)
            assert group, (w["name"], traced)
            for m in group:
                assert callable(manifest.reader(m["name"]))
        e2e = {m["name"] for m in manifest.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for name in ("mfu.serve",):
        assert name in {m["name"] for m in BENCH["per_layer"]}


def test_config_files_state_their_reductions():
    for c in BENCH["configs"]:
        cfg = manifest.read_json(manifest.BENCH_DIR.parent / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")


def test_files_under_paths_are_named_from_name_characters():
    for path in manifest.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        rel = path.relative_to(manifest.BENCH_DIR.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
