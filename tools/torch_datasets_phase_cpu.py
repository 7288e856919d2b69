#!/usr/bin/env python3
"""chip_smoke.py's custom-dataset and vKITTI3D phases (phases 13 and 14) on
the CPU, at the recipes' full widths, with smaller clouds: the
same path and checks, the structure held CPU against CPU in place of card
against CPU. Times are wall clock; there is no device memory to report.
Prints one JSON object with both phases' numbers. Run from the repository
root:

    python3 tools/torch_datasets_phase_cpu.py [--points 20000]
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
    p.add_argument("--points", type=int, default=20_000,
                   help="raw points of each synthetic room and frame")
    points = p.parse_args().points
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import torch

    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        custom = smoke.custom_phase(cpu, tmp, points)
    with tempfile.TemporaryDirectory() as tmp:
        vkitti = smoke.vkitti_phase(cpu, tmp, (points,) * 6)
    print(json.dumps({"points": points, "custom": custom, "vkitti": vkitti}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
