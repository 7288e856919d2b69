#!/usr/bin/env python3
"""chip_smoke.py's supervised-partition phase (phase 11) on this machine's
CPU, at the recipe's full width, with smaller rooms: the readers' plain
nn1 costs minutes a room on the CPU at the smoke's 300,000 points. It runs
the same path and checks (the structure and the step held CPU against CPU
in place of card against CPU), so the bounds hold here before a card run.
Times are wall clock; there is no device memory to report. Prints the
phase's JSON object. Run from the repository root:

    python3 tools/torch_ssp_phase_cpu.py [--points 30000]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--points", type=int, default=30_000,
                   help="raw points of each synthetic room")
    points = p.parse_args().points
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        _, _, out = smoke.ssp_phase(torch.device("cpu"), tmp, points)
    print(json.dumps(dict(out, points=points)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
