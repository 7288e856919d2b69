#!/usr/bin/env python3
"""chip_smoke.py's training phase (phase 9) on this machine's CPU, at the
flagship's full width, with smaller rooms: the readers' plain nn1 costs
minutes a room on the CPU at the smoke's 300,000 points. It runs the same
checks (finite losses, checkpoint reload, CPU against CPU in place of the
card, memory monger on against off, 30 steps on one batch below
OVERFIT_RATIO of the first loss), so the bounds hold here before a card
run. Steps/s is wall clock; there is no device memory to report. Prints
the phase's JSON object. Run from the repository root:

    python3 tools/torch_train_phase_cpu.py [--points 100000]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--points", type=int, default=100_000,
                   help="raw points of each synthetic room")
    points = p.parse_args().points
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import torch

    from superpoint_graph_tpu_torch.cli import partition
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room

    with tempfile.TemporaryDirectory() as tmp:
        # the room phase's room: its seed, the room phase's knn adjacency
        raw, _, _ = write_s3dis_room(Path(tmp) / "Area_2" / "room_0",
                                     np.random.RandomState(smoke.SEED), points)
        room = partition.partition_file(
            str(raw), partition.parse_args(["--spg_adjacency", "knn"]), "cpu")
        _, _, out, _ = smoke.train_phase(torch.device("cpu"),
                                         tmp + "/train", room, points)
    print(json.dumps(dict(out, points=points)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
