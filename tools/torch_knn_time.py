"""Seconds of the sorted-cell kNN (`ops.knn.knn_bigcloud`) on the voxels
of the scan phase's station, for comparing two trees of the port on one
card.

--prepare DIR writes the station (chip_smoke.py's scan: 8e6 raw points of
`write_semantic3d_scan` at its seed, as text) and reads it with the
scan's reader (`read_semantic3d_format`: chunks of 5e6 rows pruned at
0.05 m on the card), then saves the voxels as DIR/voxels.npy.
--voxels FILE [--root TREE] imports superpoint_graph_tpu_torch from TREE
(default: this checkout) and times knn_bigcloud at the scan's k (45) on
those voxels: one cold call, then --repeats warm ones, each synchronised
with the card. Prints one JSON object: the tree, the seconds, the warm
calls' stage split and levels, and a digest of the index table (equal
digests: equal tables).

Usage, on a machine with a card, from the repository root:
    python3 tools/torch_knn_time.py --prepare DIR
    python3 tools/torch_knn_time.py --voxels DIR/voxels.npy [--root TREE]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_SCAN, SEED, K = 8_000_000, 0, 45


def prepare(out_dir: Path) -> dict:
    from superpoint_graph_tpu_torch.data.provider import read_semantic3d_format
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan
    from superpoint_graph_tpu_torch.scan import SEMA3D_CONFIG, VER_BATCH

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "station1.txt"
    write_semantic3d_scan(path, N_SCAN, SEED)
    xyz = read_semantic3d_format(str(path), 0, "", SEMA3D_CONFIG.voxel_width,
                                 VER_BATCH)[0]
    np.save(out_dir / "voxels.npy", xyz)
    path.unlink()
    return {"voxels": len(xyz), "file": str(out_dir / "voxels.npy")}


def time_knn(voxels: Path, repeats: int) -> dict:
    import torch

    from superpoint_graph_tpu_torch.device import cuda_device
    from superpoint_graph_tpu_torch.ops import knn as knn_mod

    dev = cuda_device(0)
    xyz = torch.as_tensor(np.load(voxels), device=dev)
    seconds, info = [], None
    for _ in range(1 + repeats):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        idx, _, info = knn_mod.knn_bigcloud(xyz, K)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    digest = hashlib.sha1(idx.cpu().numpy().tobytes()).hexdigest()
    return {"module": str(Path(knn_mod.__file__).resolve()),
            "voxels": len(xyz), "k": K, "cold_s": seconds[0],
            "warm_s": seconds[1:], "stage_seconds": info["stage_seconds"],
            "levels": info["levels"], "n_fallback": info["n_fallback"],
            "index_sha1": digest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prepare", type=Path)
    ap.add_argument("--voxels", type=Path)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.prepare:
        out = prepare(args.prepare)
    else:
        out = time_knn(args.voxels, args.repeats)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
