#!/usr/bin/env python3
"""The port's tracer on a benchmark cell's clouds, on one NVIDIA GPU.

Sets up the cell as `portbench/run.py` does (the same inputs, weights and
warm-up from --seed), then:

- cost: labels --pairs pairs of clouds, each pair the same cloud once with
  the tracer off and once on (alternating which goes first), and gives the
  median cloud wall of each and their ratio; and, since a cloud's wall
  spreads more than the tracer can cost, the cost of one span and of one
  counted read on this host, times the spans and reads of a cloud;
- the tracer's readings over the traced clouds, median a cloud: parse_s
  (self seconds of `spgt.read.parse` and `spgt.spread.parse`), d2h_syncs
  (`d2h.reads`), d2h_wait_s (`spgt.d2h` seconds), d2h_mib (`d2h.bytes` /
  2^20), cp_heal_s (`spgt.cp.heal` plus `spgt.cp.relabel`, where the cloud
  has them), parse_rows (`parse.rows`: a scan's raw rows once when the
  spread labels the reader's chunks), spread_reused_rows
  (`spread.reused_rows`, where the cloud has it); on a frame
  (`frame.label_frame`) embed_s (`spgt.ssp.embed`), delaunay_s
  (`spgt.spg.delaunay`), delaunay_wait_s (`spgt.spg.delaunay_wait`) and
  the counters ssp_vertices, ssp_local_points, ssp_edges and
  delaunay_simplices; and every span's total and self seconds and count,
  a self time below zero given as "overlapped" (a frame's root: its
  triangulation runs in the calling thread beside the stages a worker
  thread runs, and the tracer takes every child's seconds from the
  parent's);
- one more cloud traced under torch.profiler with the benchmark's own spans
  too: its idle time by the innermost `spgt.` span of any thread
  (`tracing.name_idle` on the tracer's records), its gaps named by the
  program (the span at each gap's middle) beside the benchmark's naming
  (`portbench/harness/trace.summarize`, which sees the spans of the
  profiling thread only: on a frame, not the worker's), idle_named_pct
  (the share of the idle time inside a span below `spgt.cloud`), the idle
  share of the cloud's own span, and its reads of the device by site.

Prints one JSON object and writes it to --out. From the repository root:

    python3 tools/torch_serve_trace.py --workload s3dis-room-serve --seed 7

(`--workload vkitti-frame-serve` for a vKITTI3D frame).

`--device cpu --traffic '{"points": 20000}'` runs it small on the CPU
(the traffic's keys replaced), to try it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_record(root: dict) -> dict:
    """What a traced cloud's record holds of the program: per span name
    its seconds, self seconds and count, and the counters."""
    from superpoint_graph_tpu_torch.utils import tracing

    return tracing.summary(root)


def overlapped(spans: dict) -> dict:
    """`spans` ({name: {"seconds", "self_s", "count"}}) with each self
    time below zero given as "overlapped": a child ran in another thread
    beside the span's other children."""
    return {name: dict(e, self_s="overlapped") if e["self_s"] < 0 else e
            for name, e in spans.items()}


def readings(program: dict) -> dict:
    """One traced cloud's readings of the tracer (see the docstring)."""
    spans, c = program["spans"], program["counters"]

    def sec(name, key="seconds"):
        return spans.get(name, {}).get(key, 0.0)

    out = {"parse_s": sec("spgt.read.parse", "self_s")
           + sec("spgt.spread.parse", "self_s"),
           "d2h_syncs": c.get("d2h.reads", 0),
           "d2h_wait_s": sec("spgt.d2h"),
           "d2h_mib": c.get("d2h.bytes", 0) / 2**20,
           "parse_rows": c.get("parse.rows", 0)}
    if "spread.reused_rows" in c:
        out["spread_reused_rows"] = c["spread.reused_rows"]
    if "spgt.cp.heal" in spans:
        out["cp_heal_s"] = sec("spgt.cp.heal") + sec("spgt.cp.relabel")
    if "spgt.ssp.embed" in spans:
        out["embed_s"] = sec("spgt.ssp.embed")
        out["delaunay_s"] = sec("spgt.spg.delaunay")
        out["delaunay_wait_s"] = sec("spgt.spg.delaunay_wait")
        for k in ("ssp.vertices", "ssp.local_points", "ssp.edges",
                  "delaunay.simplices"):
            out[k.replace(".", "_")] = c.get(k, 0)
    return out


def d2h_sites(root: dict) -> dict:
    """{site: {"reads", "seconds", "mib"}} of one traced cloud's reads."""
    out = {}
    for s in root["spans"]:
        if s["name"] == "spgt.d2h":
            e = out.setdefault(s["attrs"]["site"],
                               {"reads": 0, "seconds": 0.0, "mib": 0.0})
            e["reads"] += 1
            e["seconds"] += (s["end_ns"] - s["start_ns"]) * 1e-9
            e["mib"] += s["attrs"]["bytes"] / 2**20
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["seconds"]))


def unit_costs(dev, n: int = 20_000) -> dict:
    """Microseconds a span costs on (`spgt.x` inside a root), and a read
    of a 4-byte tensor with the tracer on and off."""
    import torch

    from superpoint_graph_tpu_torch.utils import tracing

    x = torch.zeros(1, device=dev)
    tracing.to_host(x, "warm")
    out = {}
    tracing.enable()
    with tracing.span("spgt.cloud"):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("spgt.x"):
                pass
        out["span_us"] = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for _ in range(n // 10):
            tracing.to_host(x, "x")
        out["read_on_us"] = (time.perf_counter() - t0) / (n // 10) * 1e6
    tracing.disable()
    tracing.collect()
    t0 = time.perf_counter()
    for _ in range(n // 10):
        tracing.to_host(x, "x")
    out["read_off_us"] = (time.perf_counter() - t0) / (n // 10) * 1e6
    return out


def median_of(rows: list) -> dict:
    keys = sorted({k for r in rows for k in r})
    return {k: statistics.median(r.get(k, 0) for r in rows) for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="{}",
                    help="JSON object of traffic keys to replace")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.harness import manifest, trace
    from superpoint_graph_tpu_torch import pipeline_big
    from superpoint_graph_tpu_torch.ops import cutpursuit_band
    from superpoint_graph_tpu_torch.utils import tracing

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]),
                   **json.loads(args.traffic))
    dev = torch.device("cuda:0" if args.device == "cuda" else args.device)
    out = {"workload": args.workload, "seed": args.seed,
           "torch": torch.__version__, "traffic": traffic}
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(loop, i, on):
        (tracing.enable if on else tracing.disable)()
        sync()
        t0 = time.perf_counter()
        loop.call(i)
        sync()
        wall = time.perf_counter() - t0
        tracing.disable()
        return wall

    with tempfile.TemporaryDirectory() as tmp:
        loop = manifest.loop(traffic["loop"])(config, traffic, args.seed,
                                              dev, tmp)
        loop.setup()
        tracing.collect()
        walls = {"off": [], "on": []}
        for p in range(args.pairs):
            for on in ((False, True) if p % 2 == 0 else (True, False)):
                walls["on" if on else "off"].append(timed(loop, p, on))
        roots = tracing.collect()
        clouds = [program_record(r) for r in roots]

        names = {n for _, n in loop.span_patches()}
        prof = trace.profiler()
        cutpursuit_band.LAST_SOLVE_STATS.clear()
        pipeline_big.LAST_CP_STATS.clear()
        tracing.enable()
        with trace.spans(loop.span_patches()):
            sync()
            t0 = time.perf_counter()
            prof.start()
            loop.call(args.pairs)
            sync()
            prof.stop()
            wall = time.perf_counter() - t0
        tracing.disable()
        (profiled,) = tracing.collect()
        host_syncs = {
            "band": cutpursuit_band.LAST_SOLVE_STATS.get("host_syncs"),
            "windows": pipeline_big.LAST_CP_STATS.get("host_syncs")}
        loop.release()

    events = prof.events()
    bench_view = trace.summarize(prof, names, wall)
    named = tracing.name_idle(events, program=profiled)
    med = {k: statistics.median(v) for k, v in walls.items()}
    unit = unit_costs(dev)
    n_spans = statistics.median(
        sum(e["count"] for e in c["spans"].values()) for c in clouds)
    n_reads = statistics.median(c["counters"].get("d2h.reads", 0)
                                for c in clouds)
    added_s = ((n_spans - n_reads) * unit["span_us"] + n_reads
               * (unit["read_on_us"] - unit["read_off_us"])) * 1e-6
    out["cost"] = {"walls_s": walls, "median_off_s": med["off"],
                   "median_on_s": med["on"],
                   "on_over_off": med["on"] / med["off"] - 1.0,
                   "unit_us": unit, "spans": n_spans, "reads": n_reads,
                   "added_s": added_s, "added_pct": 100.0 * added_s
                   / med["off"]}
    cloud_s = (profiled["end_ns"] - profiled["start_ns"]) * 1e-9
    out["readings"] = dict(median_of([readings(c) for c in clouds]),
                           idle_named_pct=100.0 * named["named_s"]
                           / max(named["idle_s"], 1e-12))
    out["readings_per_cloud"] = [readings(c) for c in clouds]
    spans = {}
    for c in clouds:
        for name, e in c["spans"].items():
            spans.setdefault(name, []).append(e)
    out["spans_median"] = overlapped({
        name: {k: statistics.median(e[k] for e in es)
               for k in ("seconds", "self_s", "count")}
        for name, es in sorted(spans.items())})
    out["counters_median"] = median_of([c["counters"] for c in clouds])
    out["d2h_sites_first_cloud"] = d2h_sites(roots[0])
    program = program_record(profiled)
    program["spans"] = overlapped(program["spans"])
    out["profiled"] = {
        "wall_s": wall, "busy_s": bench_view["busy_s"],
        "idle_pct": 100.0 * (1.0 - bench_view["busy_s"] / wall),
        "cloud_s": cloud_s, "cloud_idle_pct": 100.0 * named["idle_s"]
        / cloud_s,
        "solver_host_syncs": host_syncs,
        "program": program,
        "idle_s": named["idle_s"], "named_s": named["named_s"],
        "idle_by_span": dict(list(named["by_span"].items())[:25]),
        "gaps_by_program": named["gaps"][:25],
        "d2h_sites": d2h_sites(profiled),
        "gaps_by_benchmark": bench_view["gaps"][:10],
        "device_ops": sorted(bench_view["kernels"].items(),
                             key=lambda kv: -kv[1])[:10],
        "program_spans_among_device_ops": sorted(
            k for k in bench_view["kernels"] if k.startswith("spgt."))}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
