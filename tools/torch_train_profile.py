#!/usr/bin/env python3
"""Device-time breakdown of the port's training step on one NVIDIA GPU.

Partitions chip_smoke.py's three 300,000-point training rooms with the
partition CLI's per-file function, builds the flagship at the S3DIS
recipe's flags (cli/train.build), draws four training batches of 2 clouds
as the smoke does, and after 3 warm-up steps runs 10 `train_step`s under
torch.profiler: wall and device seconds, the device's busy share, kernel
launches a step, the top device ops; then the same 10 steps with the
memory monger off, timed with CUDA events, for its cost. Prints one JSON
object. Run from the repository root:

    python3 tools/torch_train_profile.py
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STEPS, WARM = 10, 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from superpoint_graph_tpu_torch.cli import partition as cli_partition
    from superpoint_graph_tpu_torch.cli import train as cli_train
    from superpoint_graph_tpu_torch.data.datasets import get_info
    from superpoint_graph_tpu_torch.data.spg_io import scaler01
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.device import cuda_device
    from superpoint_graph_tpu_torch.learn.train_check import (
        draw_batches, trainer_factory, training_rooms)
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS

    dev = cuda_device(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        p_args = cli_partition.parse_args(["--ROOT_PATH", tmp])
        for i in range(1, smoke.TRAIN_ROOMS + 1):
            raw, _, _ = write_s3dis_room(
                Path(tmp) / "data" / "Area_1" / f"room_{i}",
                np.random.RandomState(smoke.SEED + i), smoke.TRAIN_ROOM_POINTS)
            parts[f"Area_1/room_{i}"] = cli_partition.partition_file(
                str(raw), p_args, dev)
    entries, rows = training_rooms(parts, EDGE_ATTRIBS)
    names = list(entries)
    trainlist, _, _, _ = scaler01([entries[n] for n in names], [])
    args = cli_train.parse_args(smoke.TRAIN_RECIPE)
    dbinfo = get_info("s3dis", "", EDGE_ATTRIBS, args.pc_attribs)
    _, trainer, loader_cfg, n_ch = cli_train.build(args, dbinfo, dev)
    batches, load_s = draw_batches(
        trainlist, names, rows, loader_cfg, dbinfo, n_ch,
        np.random.RandomState(smoke.SEED), args.batch_size, dev)
    state = copy.deepcopy(trainer.model.state_dict())

    def run(t):
        for i in range(STEPS):
            t.train_step(batches[i % len(batches)])
        torch.cuda.synchronize(dev)

    for i in range(WARM):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(trainer)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    monger_ms = {}
    for monger in (True, False):
        t = trainer_factory(args, dbinfo, state)(dev, monger)
        for i in range(WARM):
            t.train_step(batches[i % len(batches)])
        torch.cuda.reset_peak_memory_stats(dev)
        _, ms = smoke.timed(lambda: run(t))
        monger_ms["on" if monger else "off"] = {
            "step_ms": ms / STEPS,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated(dev) / 2**30}
    print(json.dumps({
        "card": card, "torch": torch.__version__,
        "superpoints_per_batch": [int(b.node_mask.sum()) for b in batches],
        "edges_per_batch": [int(b.edge_mask.sum()) for b in batches],
        "host_load_collate_s": load_s,
        "profiled_steps": STEPS, "wall_s_per_step": wall / STEPS,
        "device_s_per_step": device_s / STEPS,
        "device_busy_share": device_s / wall,
        "device_launches_per_step": sum(e.count for e in events) / STEPS,
        "top_device_ops": [
            {"name": e.key[:80], "s_per_step": e.self_device_time_total
             / 1e6 / STEPS, "calls_per_step": e.count / STEPS}
            for e in events[:15]],
        "memory_monger": monger_ms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
