"""A/B timing of two sources of the nn1 kernel on one NVIDIA GPU.

Builds each source (a .cu with csrc/nn1.cu's C interface) with the
package's flags, then times `nn1_cuda` through each at chip_smoke.py's
three nn1 shapes, on the same synthetic 1,000,000-point room (seed 0,
coordinates rounded to 0.1 mm as the room's text files hold them):

    read    room x annotation points (the room's points, object order)
    spread  voxels (0.03 m prune on the card) x room
    check   room x 65,536 queries (half exact copies, half moved ~1 cm)

in the order A, B, B, A at every shape (CUDA events, mean of `--reps`
calls after a warm-up, per round). Both sources' indices must equal
nn1_plain's at every shape. Prints one JSON object. From the
repository root:

    python3 -m superpoint_graph_tpu_torch.nn1_ab A.cu B.cu [--reps 5]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N_POINTS = 1_000_000
N_CHECK = 65_536
SEED = 0


def _cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events), after
    one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from .data.synthetic import synthetic_room
    from .device import cuda_device
    from .ops import _build
    from .ops import nn1 as nn1_mod
    from .ops.voxel import prune

    dev = cuda_device(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs, out = {}, {"card": card, "torch": torch.__version__, "sources": {}}
    for key, src in (("A", args.a), ("B", args.b)):
        path, build_s, ptxas = _build.build("nn1", src.resolve())
        libs[key] = nn1_mod.bind(ctypes.CDLL(str(path)))
        out["sources"][key] = {"source": str(src), "build_s": build_s,
                               "ptxas": [line for line in ptxas.splitlines()
                                         if "Used" in line]}

    xyz, rgb, _, objects = synthetic_room(
        np.random.RandomState(SEED), n_points=N_POINTS, noise=0.008,
        clutter_blobs=True)
    xyz = np.round(xyz.astype(np.float64), 4).astype(np.float32)
    vox, _, _, _ = prune(xyz, 0.03, rgb, None, None, 0, 0, device=dev)
    room = torch.as_tensor(xyz, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q_sub = room[torch.randint(0, len(room), (N_CHECK,), device=dev,
                               generator=g)].clone()
    q_sub[N_CHECK // 2:] += 0.01 * torch.randn(
        (N_CHECK - N_CHECK // 2, 3), device=dev, generator=g)
    shapes = {
        "read": (room, room[torch.as_tensor(
            np.argsort(objects, kind="stable"), device=dev)]),
        "spread": (torch.as_tensor(vox, device=dev), room),
        "check": (room, q_sub),
    }
    out["shapes"] = {}
    for name, (db, q) in shapes.items():
        want = nn1_mod.nn1_plain(db, q)
        rounds = {"A": [], "B": []}
        for key in ("A", "B", "B", "A"):
            nn1_mod._lib = lambda lib=libs[key]: lib
            if not torch.equal(nn1_mod.nn1_cuda(db, q), want):
                raise AssertionError(f"source {key} disagrees with nn1_plain "
                                     f"at the {name} shape")
            rounds[key].append(
                _cuda_ms(lambda: nn1_mod.nn1_cuda(db, q), args.reps))
        mean = {k: sum(v) / len(v) for k, v in rounds.items()}
        out["shapes"][name] = {
            "db": len(db), "queries": len(q),
            "splits": nn1_mod.nn1_plan(len(q), len(db))[0],
            "ms_rounds": rounds, "ms": mean, "b_over_a": mean["B"] / mean["A"]}
        print(f"[ab] {name}: {json.dumps(out['shapes'][name])}", flush=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
