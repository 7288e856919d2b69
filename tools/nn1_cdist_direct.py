#!/usr/bin/env python3
"""The direct-form PyTorch yardstick for the nn1 kernel, on one NVIDIA GPU.

Times `torch.cdist(q, db, compute_mode="donot_use_mm_for_euclid_dist")
.argmin(1)` over all queries in chunks of ~2**30 distances (CUDA events,
after a one-chunk warm-up) at nn1's room shapes: the check shape (the
smoke room's 1,000,000 points x 65,536 queries), the spread shape (a
202,962-point db x 1,000,000 queries) and, with --full, 1M x 1M (~21
minutes). The port never calls it; chip_smoke.py times the faster
matrix-product mode instead. Synthetic room points from the smoke's
generator stand in for the clouds. Prints one JSON object. Run from the
repository root:

    python3 tools/nn1_cdist_direct.py [--full]
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, timed
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
    from superpoint_graph_tpu_torch.device import cuda_device

    dev = cuda_device(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    xyz, _, _, _ = synthetic_room(np.random.RandomState(SEED), 1_000_000,
                                  noise=0.008, clutter_blobs=True)
    room = torch.as_tensor(xyz, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes = {"check": (room, room[torch.randint(0, len(room), (65_536,),
                                                 device=dev, generator=g)]),
              "spread": (room[:202_962], room)}
    if "--full" in sys.argv:
        shapes["read"] = (room, room)
    out = {"card": card, "torch": torch.__version__}
    for name, (db, q) in shapes.items():
        chunk = max(1, 2**30 // len(db))

        def run(queries):
            return [torch.cdist(queries[i:i + chunk], db,
                                compute_mode="donot_use_mm_for_euclid_dist"
                                ).argmin(1)
                    for i in range(0, len(queries), chunk)]

        run(q[:chunk])
        out[name] = {"db": len(db), "queries": len(q),
                     "library_direct_ms": timed(lambda: run(q))[1]}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
