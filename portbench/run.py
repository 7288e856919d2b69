"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Reads the cell from BENCHMARK.json, its
configuration, traffic mix, limits and metric readers from files of their
own under portbench/ (harness/manifest.py), makes the inputs and weights
from --seed, sets up and warms up (setup_s: process start to the window's
start), measures for --seconds, then checks what the timed path produced
against the plain reference (portbench/reference/) and prints, last on
standard output, one JSON line: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones), device,
(with --trace 1) breakdown, and last the compared numbers beside their
limits, which also close standard error. Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell asks for), when the
program cannot be imported, or when jax, jaxlib, flax or the JAX package
were loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "superpoint_graph_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def toolchain(device) -> dict:
    import subprocess

    import torch

    info = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda}
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    try:
        out = subprocess.run([str(nvcc), "--version"], capture_output=True,
                             text=True, timeout=30).stdout
        info["nvcc"] = out.strip().splitlines()[-1] if out else None
    except (OSError, subprocess.SubprocessError):
        info["nvcc"] = None
    if device.type == "cuda":
        info["card"] = torch.cuda.get_device_name(device)
        try:
            q = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()
            info["power_limit"] = q[device.index or 0].split(",")[-1].strip()
        except (OSError, subprocess.SubprocessError, IndexError):
            info["power_limit"] = None
    return info


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device=None, traffic_override: dict | None = None,
             t_start: float = T_START, workdir: str | None = None,
             control: bool = False) -> dict:
    """Set up, measure and check one run; returns the result line's dict.
    `device` None means the card; the tests pass "cpu" with a smaller
    traffic (`traffic_override`). With `control`, the dict also holds the
    compared numbers of the control (the reference in TF32 in the
    program's place) under "control". "notes" holds what the checks
    noted besides their numbers (standard error, not the result line)."""
    import torch

    from portbench.harness import compare, manifest, trace

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, workload)
    config = manifest.config(bench, cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]), **(traffic_override or {}))
    if device is None:
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        loop = manifest.loop(traffic["loop"])(config, traffic, seed, device,
                                              tmp)
        loop.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t_window = time.perf_counter()
        rec = loop.window(seconds, traced)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        rec.update(setup_s=t_window - t_start, peak_bytes=peak)
        if rec.get("trace") is not None:
            t = rec["trace"]
            rec["trace"] = trace.summarize(t["prof"], t["names"], t["wall"])
        t_check = time.perf_counter()
        loop.release()
        numbers = loop.check()
        control_numbers = loop.check(tf32=True) if control else None
        print(f"portbench: {workload} seed {seed}: set-up "
              f"{t_window - t_start:.1f} s, window {rec['window_s']:.1f} s "
              f"(closed {t_check - t_window:.1f} s after it opened), checks "
              f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr,
              flush=True)
    correct, checks = compare.verdict(numbers, manifest.limits(workload))
    group = manifest.metrics_of(bench, workload, traced)
    metrics = {}
    for m in group:
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = rec["attempted"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": dev}
    if traced and rec.get("trace") is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = trace.breakdown(rec["trace"])
    if control:
        out["control"] = control_numbers
    out["notes"] = loop.notes
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import manifest

    chips = int(manifest.cell(manifest.load(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print("portbench toolchain: " + json.dumps(
        toolchain(torch.device("cuda", 0))), flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules the port must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    print("portbench: notes " + json.dumps(result.pop("notes")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
