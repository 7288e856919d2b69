"""The Semantic3D chain at a real station's scale on one card: 1e8 raw
points -> chunked voxel prune -> one global prune -> the giant-cloud
partition, with the port (superpoint_graph_tpu_torch).

The port's counterpart of tools/semantic3d_headline.py, with its flags and
defaults: the station is synthesised chunk by chunk (`station_chunk`, no
dataset in the repository), each chunk of --ver_batch rows pruned by the
host library (`native.prune`) as `read_semantic3d_format` prunes its chunks,
the concatenation pruned once more for one grid, and the pruned cloud
partitioned by `pipeline_big.partition_cloud_big` on the card (sorted-cell
kNN, chunked geof, Morton windows of the device cut pursuit with the heal
and `relabel_connected`, device SPG) with host_outputs=False. The chunks
are drawn in order (so the cloud is the JAX tool's), then pruned in a pool
of threads. As in the JAX tool, the raw rate is the raw points over the
prune and partition seconds, drawing excluded.

Usage, on a machine with a card (chip_smoke.py's phase 17 imports
`run_chain`):
    python3 tools/torch_semantic3d_headline.py [--raw_points 100000000]
        [--warm_repeat]
Prints one JSON object: counts, the stage split and seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the JAX tool's defaults: raw points, rows a chunk, grid pitch
RAW_POINTS, VER_BATCH, VOXEL_WIDTH = 100_000_000, 5_000_000, 0.1


def synthesize_and_prune(raw_points: int, ver_batch: int, voxel_width: float):
    """The station's raw points drawn in chunks of ver_batch rows from
    default_rng(0), then the chunks pruned by the host library in a pool of
    threads (up to 8 at once; the library releases the interpreter lock),
    then their concatenation pruned once more. Returns (xyz after the
    global prune, rows after the chunk prunes, their split: gen_seconds
    (drawing, before any prune), chunk_prune_seconds (the chunks' prunes,
    summed over the threads), chunks_wall_seconds (the pool's wall time,
    every chunk prune inside it), global_prune_seconds, prune_seconds (the
    pool's wall plus the global prune: all the pruning over all its time,
    drawing excluded as in the JAX tool))."""
    from superpoint_graph_tpu_torch import native
    from superpoint_graph_tpu_torch.data.synthetic import station_chunk

    def prune_chunk(xyz):
        t0 = time.perf_counter()
        out = native.prune(xyz, voxel_width, None, None, None, 0, 0)[0]
        return out, time.perf_counter() - t0

    rs = np.random.default_rng(0)
    chunks, raw_total = [], 0
    t0 = time.perf_counter()
    while raw_total < raw_points:
        n_c = min(ver_batch, raw_points - raw_total)
        chunks.append(station_chunk(rs, n_c))
        raw_total += n_c
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(prune_chunk, chunks))
    t_chunks = time.perf_counter() - t0
    del chunks
    rows = np.concatenate([p for p, _ in parts])
    t0 = time.perf_counter()
    xyz = native.prune(rows, voxel_width, None, None, None, 0, 0)[0]
    t_global = time.perf_counter() - t0
    split = {
        "raw_points": raw_total, "chunks": len(parts),
        "after_chunk_prune": len(rows), "pruned_points": len(xyz),
        "gen_seconds": t_gen,
        "chunk_prune_seconds": sum(s for _, s in parts),
        "chunks_wall_seconds": t_chunks,
        "global_prune_seconds": t_global,
        "prune_seconds": t_chunks + t_global,
    }
    return xyz, rows, split


def run_chain(raw_points: int = RAW_POINTS, ver_batch: int = VER_BATCH,
              voxel_width: float = VOXEL_WIDTH, k_nn_geof: int = 45,
              k_nn_adj: int = 10, reg_strength: float = 0.8,
              warm_repeat: bool = False, device=None):
    """The chain on `device` (default: the card): synthesise and prune
    (`synthesize_and_prune`), then `partition_cloud_big` of the pruned
    cloud at the JAX tool's settings (voxel_width 0 there, zero colours,
    the "s3dis" features, kNN adjacency, host_outputs=False), once cold
    and, with warm_repeat, again. Returns (the stage split, {"xyz",
    "rows_after_chunks", "results": [PartitionResult of each run]})."""
    import torch

    from superpoint_graph_tpu_torch.device import card_unless
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig
    from superpoint_graph_tpu_torch.pipeline_big import partition_cloud_big

    device = card_unless(device)
    on_card = device.type == "cuda"
    xyz, rows, split = synthesize_and_prune(raw_points, ver_batch,
                                            voxel_width)
    rgb = np.zeros((len(xyz), 3), np.uint8)
    cfg = PartitionConfig(voxel_width=0.0, k_nn_geof=k_nn_geof,
                          k_nn_adj=k_nn_adj, reg_strength=reg_strength,
                          spg_adjacency="knn")
    split["voxel_width"] = voxel_width
    results = []
    for name in ("cold", "warm") if warm_repeat else ("cold",):
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = partition_cloud_big(xyz, rgb, cfg=cfg, host_outputs=False,
                                  device=device)
        if on_card:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        results.append(res)
        split[f"partition_seconds_{name}"] = seconds
        split[f"end_to_end_seconds_{name}"] = split["prune_seconds"] + seconds
        split[f"raw_mpts_per_sec_{name}"] = (
            raw_points / (split["prune_seconds"] + seconds) / 1e6)
        split[f"times_{name}"] = res.times
        if on_card:
            split[f"peak_gib_{name}"] = (
                torch.cuda.max_memory_allocated(device) / 2**30)
    res = results[0]
    split["n_superpoints"] = len(res.components)
    split["n_superedges"] = int(res.graph_sp["source"].shape[0])
    split["windows"] = res.times["cp_info"]["n_chunks"]
    return split, {"xyz": xyz, "rows_after_chunks": rows, "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--raw_points", type=int, default=RAW_POINTS)
    ap.add_argument("--ver_batch", type=int, default=VER_BATCH)
    ap.add_argument("--voxel_width", type=float, default=VOXEL_WIDTH)
    ap.add_argument("--k_nn_geof", type=int, default=45)
    ap.add_argument("--k_nn_adj", type=int, default=10)
    ap.add_argument("--reg_strength", type=float, default=0.8)
    ap.add_argument("--warm_repeat", action="store_true",
                    help="partition a second time in the same process, for "
                         "the warm number beside the cold one")
    args = ap.parse_args(argv)
    import torch

    split, _ = run_chain(args.raw_points, args.ver_batch, args.voxel_width,
                         args.k_nn_geof, args.k_nn_adj, args.reg_strength,
                         args.warm_repeat)
    split["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(split, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
