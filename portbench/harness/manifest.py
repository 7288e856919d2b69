"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is `configs/<config>.json`, the mix's
`traffic/<traffic>.json`, the loop its `"loop"` names `loops/<loop>.py`,
each metric's reader `metrics/<metric>.py` and each cell's limits
`limits/<cell>.json`, all under portbench/. Adding a cell, a loop kind, a
configuration or a metric adds files and entries; no code here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path | None = None) -> dict:
    root = Path(root) if root else BENCH_DIR.parent
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(BENCH_DIR.parent / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries a run of `cell_name` reports: its end-to-end
    metrics, or with `traced` its per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _module(folder: str, name: str):
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric_name: str):
    """The `read(record) -> float | None` of metrics/<name>.py."""
    return _module("metrics", metric_name).read


def loop(loop_name: str):
    """The class `Loop` of loops/<name>.py: built with (config, traffic,
    seed, device, work directory), it has setup(), window(seconds,
    traced) -> record, release() and check(tf32) -> {number: value}."""
    return _module("loops", loop_name).Loop
