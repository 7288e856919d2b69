#!/usr/bin/env python3
"""Stage and device-time breakdown of the port's Semantic3D serving path
(`superpoint_graph_tpu_torch.scan.label_scan`) on one NVIDIA GPU.

Writes chip_smoke.py's synthetic station (8,000,000 raw points, seed 0),
warms the card up with one label_scan of a 1,000,000-point station, then
labels the full station once under torch.profiler: wall and device kernel
seconds (the busy share), the stage split, the chunked solver's stats and
the longest device ops. Prints one JSON object. Run from the repository
root:

    python3 tools/torch_scan_profile.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan
    from superpoint_graph_tpu_torch.device import cuda_device
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.scan import SEMA3D_MODEL, label_scan
    from tools.torch_room_profile import device_events

    dev = cuda_device(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = SpgModel(8, **dict(smoke.FLAGSHIP, **SEMA3D_MODEL))
    model.reset_parameters(torch.Generator().manual_seed(smoke.SEED))
    model = model.to(dev).eval()
    out = {"card": card, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        warm = Path(tmp) / "warm.txt"
        write_semantic3d_scan(warm, 1_000_000, seed=1)
        label_scan(str(warm), model, dev)
        path = Path(tmp) / "station1.txt"
        write_semantic3d_scan(path, smoke.N_SCAN, smoke.SEED)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r = label_scan(str(path), model, dev)
            wall = time.perf_counter() - t0
    events = device_events(prof)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    out.update({
        "counts": r.counts,
        "stage_seconds": r.times,
        "wall_seconds": wall,
        "raw_points_per_second": r.counts["raw_points"] / wall,
        "device_kernel_seconds": device_s,
        "device_busy_share": device_s / wall,
        "device_launches": sum(e.count for e in events),
        "top_device_ops": [
            {"name": e.key[:80], "seconds": e.self_device_time_total / 1e6,
             "calls": e.count} for e in events[:15]],
    })
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
