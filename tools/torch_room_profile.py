#!/usr/bin/env python3
"""Stage and device-time breakdown of the PyTorch port's serving path on one
NVIDIA GPU.

Labels the synthetic 1,000,000-point S3DIS room of chip_smoke.py once with
`superpoint_graph_tpu_torch.room.label_room` and its default config (the
device cut-pursuit solver) under torch.profiler, after a warm-up on a small
room; then profiles one device solve alone on the room's voxels (kernel
launches, device time, host syncs), and times the nn1 kernel against its
plain torch version at the serving path's two full shapes (room x
annotation points; voxels x raw points) with CUDA events. Prints one JSON
object. Run from the repository root:

    python3 tools/torch_room_profile.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def device_events(prof):
    """Device-side profiler entries (the CPU ops' device time would count
    twice), longest first."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda e: -e.self_device_time_total)


def profile_solve(part, cfg, dev):
    """One warm device solve on the room's voxels under torch.profiler:
    wall and device seconds, kernel launches and copies, host syncs, the
    top device ops."""
    import torch

    from superpoint_graph_tpu_torch.ops import cutpursuit_band as cb
    from superpoint_graph_tpu_torch.pipeline import (_assemble_features_device,
                                                     partition_features)

    _, _, tabs = partition_features(part.xyz, cfg, device=dev,
                                    return_device=True)
    k = cfg.k_nn_adj
    f_dev = _assemble_features_device(tabs["geof"],
                                      torch.as_tensor(part.rgb, device=dev))

    def solve():
        return cb.cutpursuit_band_device(
            f_dev, tabs["idx"][:, :k], tabs["d2"][:, :k], part.xyz,
            len(part.xyz), cfg.reg_strength,
            lambda_edge_weight=cfg.lambda_edge_weight)

    solve()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    return {
        "wall_seconds": wall, "device_seconds": device_s,
        "device_busy_share": device_s / wall,
        "device_launches": sum(e.count for e in events),
        "stats": dict(cb.LAST_SOLVE_STATS),
        "top_device_ops": [
            {"name": e.key[:80], "seconds": e.self_device_time_total / 1e6,
             "calls": e.count} for e in events[:10]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from superpoint_graph_tpu_torch.data.provider import read_rows
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.device import cuda_device
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.ops import cutpursuit_band as cb
    from superpoint_graph_tpu_torch.ops.nn1 import nn1_cuda, nn1_plain
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig
    from superpoint_graph_tpu_torch.room import label_room

    dev = cuda_device(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = SpgModel(13, **smoke.FLAGSHIP)
    model.reset_parameters(torch.Generator().manual_seed(smoke.SEED))
    model = model.to(dev).eval()
    cfg = PartitionConfig(spg_adjacency="knn")
    out = {"card": card, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        warm_path, _, _ = write_s3dis_room(Path(tmp) / "warm" / "room_0",
                                           np.random.RandomState(1), 20_000)
        label_room(str(warm_path), model, dev, cfg=cfg)
        raw_path, _, _ = write_s3dis_room(Path(tmp) / "Area_1" / "room_0",
                                          np.random.RandomState(smoke.SEED),
                                          smoke.N_POINTS)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r = label_room(str(raw_path), model, dev, cfg=cfg)
            wall = time.perf_counter() - t0
        solve_stats = dict(cb.LAST_SOLVE_STATS)
        room = torch.as_tensor(read_rows(str(raw_path))[:, :3],
                               dtype=torch.float32, device=dev)
    events = device_events(prof)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    out.update({
        "counts": r.counts,
        "device_solve_stats": solve_stats,
        "stage_seconds": r.times,
        "wall_seconds": wall,
        "device_kernel_seconds": device_s,
        "device_busy_share": device_s / wall,
        "top_device_ops": [
            {"name": e.key[:80], "seconds": e.self_device_time_total / 1e6,
             "calls": e.count} for e in events[:12]],
    })

    out["device_solve_alone"] = profile_solve(r.partition, cfg, dev)

    # nn1 at the serving path's full shapes; annotation points are copies
    # of the room's points, so the room itself stands for them
    vox = torch.as_tensor(r.partition.xyz, device=dev)
    perm = torch.randperm(len(room), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    shapes = {"read (room x annotations)": (room, room[perm]),
              "interpolate (voxels x raw)": (vox, room)}
    out["nn1_full_shapes"] = {}
    for name, (db, q) in shapes.items():
        ms = smoke.cuda_ms(lambda: nn1_cuda(db, q), reps=3)
        plain_ms = smoke.cuda_ms(lambda: nn1_plain(db, q), reps=1)
        out["nn1_full_shapes"][name] = {
            "db": len(db), "queries": len(q), "kernel_ms": ms,
            "plain_ms": plain_ms, "pairs_per_s": len(db) * len(q) / ms * 1e3}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
