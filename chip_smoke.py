#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (superpoint_graph_tpu_torch) on
one NVIDIA GPU.

1. Header: torch / CUDA / nvcc versions, the card's name and power limit,
   which optional file-I/O packages are present.
2. Build: every CUDA kernel of the serving paths, from this checkout, with
   ptxas's registers, shared memory and spills for each; and the host
   library (csrc/spgt_native.cpp, g++), which the merge rounds,
   relabel_connected, the cutoff fuse and the prune above
   PRUNE_DEVICE_MAX rows call.
3. Quick kernel check: nn1 against its plain torch version on the card,
   the room's 1,000,000 points as db and 65,536 queries.
4. Adversarial nn1 check (ops/nn1_cases.py): clouds at 1e3 m, near-ties
   a few ulps apart at both scales, duplicated db points, queries equal to
   db points, one repeated point; sizes off every multiple of the kernel's
   tile, block and chunk; the split path at 65,536 queries and below, and
   the unsplit path.
5. Room path: one synthetic S3DIS room of 1,000,000 raw points written in
   the raw layout, then `label_room` with its default config:
   read_s3dis_format (nn1) -> partition_cloud (prune, kNN, geof, the device
   cut-pursuit solver and the host merge step, SPG) -> superpoint batch ->
   the flagship ECC-GRU SpgModel (random weights from a seed) -> labels
   spread to the raw points (nn1). Stage times, counts, the solver's
   statistics and the kernel launches of this run alone are printed.
6. Checks: finite logits of the right shape, reader labels against the
   generator's, the kernel against its plain version at the path's two
   full shapes (room x annotation points, voxels x raw points), spread
   labels against the plain nn1's, and the card's logits against the same
   model on the CPU. Every nn1 check asks for the plain version's indices
   exactly (agreement 1.0, squared-distance error 0).
7. Quality: the host exact solver on the room's features and kNN graph.
   Both solvers' seconds, energy, component count and OOA; the run fails
   unless the device solver is within QUALITY_BOUNDS of the exact one,
   every label is one connected piece of the graph and no CC call stopped
   at its cap. Then the dense device solver (ops/cutpursuit_dense.py, the
   JAX package's cutpursuit_tpu below 16,384 vertices) on a crop of the
   room's voxels (DENSE_CROP_ROWS of least x) with their kNN edges, on the
   card, on the CPU and against the exact solver on the same crop: seconds,
   energy, components; the card's energy must lie within
   DENSE_ENERGY_RTOL of the CPU's.
8. Run to run: the room read again, pruned twice, its features built twice
   and the device solve run twice; each stage's output must be
   bit-identical (voxels, kNN, geof, the solver's labels, in_component, and
   equal to the slice's). The warm solve's time, and the region accept's
   quality for reference.
9. Training path: three more synthetic S3DIS rooms of 300,000 raw points
   (RandomState(SEED + i)) through the partition CLI's per-file function
   at its defaults (reader with nn1, prune, kNN, geof, the device cut
   pursuit, Delaunay SPG), the room phase's partition as the fourth; SPG
   entries and parsed rows in memory (no h5py on the card's machine); a
   cvfold of 3 training rooms and 1 test room; the flagship built by the
   training CLI's `build` at the S3DIS recipe's flags; 2 training epochs,
   1 test epoch and `eval_final` (2 samplings) through its `run_epoch`;
   model.ckpt saved and reloaded. Checks: each training room's reader
   labels (from its partition_file run) against the generator's, and nn1
   at that room's read shape against nn1_plain on 65,536 sampled queries;
   (a) finite losses; the reloaded model's eval logits equal (index_add in
   its deterministic mode); (b) one step's loss, gradients and running
   statistics on the card against the CPU, memory monger on, within
   learn/train_check.py's TRAIN_TOL (where a ReLU or a PointNet max-pool
   takes another branch on the CPU than on the card, each such element
   must be a near-tie, and the CPU's step is run again on the card's
   branches; printed); (c) the monger on against off on the card, the
   same, running statistics equal; (d) 30 steps on one batch bring the
   loss below OVERFIT_RATIO of its first. Printed: train steps/s at batch
   2 (CUDA events, 20 steps after 3 warm-ups), the host's load + collate
   seconds a batch, superpoints a batch, the phase's peak allocated
   memory; all under "train" in the JSON line.
10. Scan path: a synthetic Semantic3D station of 8,000,000 raw points
   (`big_scene_labeled`, x y z intensity r g b + .labels) written as text
   (its time printed apart), then `scan.label_scan` cold and warm:
   read_semantic3d_format (chunks of 5e6 rows pruned at 0.05 m) ->
   partition_cloud, which past 2^19 voxels runs the giant-cloud path
   (knn_bigcloud, chunked device cut pursuit with its heal, device SPG) ->
   superpoint batch -> the Semantic3D SpgModel gru_10,f_8 -> classes spread
   to every raw point by interpolate_labels_batch (nn1 per chunk). Counts,
   stage times, the chunked solver's stats and the kNN's levels; the nn1
   launches of the cold run alone. Checks: labels and logits well formed;
   the partition bit-identical between the two runs; the chunked partition
   within SCAN_BOUNDS of the port's monolithic solve on the same voxels
   (energy, OOA on the reader's label histograms), no disconnected label,
   no capped CC call; the kNN table equal to a direct-form brute-force
   search on 65,536 sampled rows; nn1 at each of the spread stage's shapes
   (the voxels against each 5e6-row chunk of raw points, the launch plan
   the path uses) equal to nn1_plain on 65,536 sampled rows of the chunk,
   and the path's labels of those rows equal to the voxel classes the
   plain nn1 picks.
11. Supervised partition (SSP): five more synthetic rooms of 300,000 raw
   points (RandomState(SEED + 20 + i); Area_1/room_0 the test room at
   cvfold 1, four training rooms) through cli/ssp_preprocess's
   preprocess_file at the recipe's flags (reader with nn1, prune, kNN,
   geof, transitions, the RANSAC plane), the LocalEmbedder trained 2 epochs
   by cli/ssp_train's run_epoch (batch 4 at max_ver_train 10,000, the
   device cut pursuit in every step), the test room's final evaluation,
   model.ckpt, then cli/ssp_generate's partition and SPG of all five
   rooms; structures and SPGs in memory. Printed: each room's voxels,
   edges, transitions, RANSAC plane and seconds, each step's loss, mean
   component size and solver statistics, ASA/BR/BP of the test room (random
   init on synthetic rooms: not a quality figure), superpoints. Checks:
   reader labels against the generator's, nn1 at the test room's read
   shape against nn1_plain; no capped in-loop CC call; two generate runs
   bit-equal; each SPG readable (read_spg, or in memory without h5py); the
   structure on the card against the CPU (prune, elevation, xyn equal;
   kNN, transitions equal and geof within 1e-5 on 8,192 sampled voxels);
   one step on the card against the CPU's in float64 given the card's
   loss weights (learn/train_check.py, TRAIN_TOL; each channel of a
   batch-norm bias before a max-pool to its cancelled sum); the in-loop
   device partition of the trained embeddings against the host exact
   solver (QUALITY_BOUNDS energy and components); 30 steps on one fixed
   batch end below the first loss. Printed: each float32 step's (card,
   CPU; on the float64 step's branches) largest gradient error from the
   float64 one, the step split by CUDA events (embed / host weights, of
   which the solve / loss + backward + Adam), peak memory; under "ssp" in
   the JSON line.
12. Submission writer (Semantic3D), in the scan phase's directory: its
   array function (cli/write_semantic3d.write_submission) on the cold
   scan's voxels, partition and predicted classes: reduced_labels2full,
   interpolate_labels_batch (nn1 per chunk of 5e6 raw rows), one class a
   line. Check: the .labels file equal, line for line, to label_scan's
   class of every raw point. Printed: its seconds, the nn1 calls' share
   (CUDA events), its own nn1 launches ("submission" in the kernel line).
13. Custom dataset: one synthetic room of 300,000 points under data/train/
   as a binary ply with labels, an ascii pcd with labels and a LAS 1.2
   point format 3, another under data/test/ as an ascii ply without
   labels; each reader's seconds and arrays (xyz within the format's
   precision), cli/partition.partition_file at the CLI's defaults
   (--n_labels 13, custom_dataset's classes) on each, the ply's
   partition equal bit for bit to partition_cloud on the same arrays,
   parsed rows in memory (custom_dataset style) and one training and one
   test epoch of the flagship on the split (finite losses).
14. vKITTI3D, SSP then SPG: six synthetic street frames
   (data/synthetic.py::synthetic_street, 300,000-400,000 points, labels
   0..13 with the don't-care 13) as npy, one a fold 01..06, through
   cli/ssp_preprocess.preprocess_file (voxel 0.05), one cli/ssp_train
   epoch at cvfold 1 (reg_strength 0.5, spatial_emb 0.2, CP_cutoff 25,
   the device cut pursuit in every step), ssp_generate on all six,
   ssp_evaluate on the test frame, then parsed rows in the vkitti style
   and one SPG training and test epoch of the flagship on the learned
   graphs. Checks: reader labels equal to the generator's after the
   remap; the test frame's structure against the CPU's; the in-loop
   device partition against the exact solver (QUALITY_BOUNDS, no capped
   CC); generate bit-equal twice; finite losses. Printed: each frame's
   voxels, transition share, preprocess and generate seconds, each step's
   split (embed / host weights, of which the solve / the rest).
15. Visualize: cli/visualize.write_clouds on the room phase's result, all
   seven output types (igfprse); each ply read back with
   read_ply_elements equals the arrays written.
16. Parallel (parallel/): the room's 1,000,000 raw points read again
   (read_s3dis_format, nn1: "parallel" in the kernel line) and pruned, then
   partition_shard.partition_cloud_sharded on PARALLEL_SHARDS shards of
   the card, twice: the kNN table against compute_graph_nn_2's (distances
   equal, indices but at exact ties), geof within 1e-5, the partition
   against the single-card solve of the same voxels and graph
   (SHARD_BOUNDS: same-component share, energy, components) and the
   quality phase's exact solve (QUALITY_BOUNDS), every label connected, no
   capped CC call, the two runs bit-identical; the slab rows and stage
   seconds printed. partition_big_shard.partition_big_sharded on the scan
   phase's voxels at windows of 2^19 rows against that phase's partition
   (SCAN_BOUNDS energy and OOA, connected labels, no capped CC; seconds,
   rounds, edges beyond the halo, peak memory). Then an NCCL group of one
   rank (multihost.initialize at 127.0.0.1 and a free port): DP_STEPS
   steps of parallel/dp.py's step and of Trainer.train_step from the
   training phase's weights on its batches, losses, parameters and running
   statistics bit for bit; the dp eval step equal to eval_step;
   global_edge_scaler within 1e-5 of a float64 fit (its distance from
   EdgeFeatScaler.fit printed); both steps/s and the all-reduce's share of
   a step (CUDA events).
17. The JAX package's Semantic3D chain at its own scale
   (tools/torch_semantic3d_headline.py::run_chain at the JAX tool's
   defaults): 1e8 raw points of `station_chunk` drawn in chunks of 5e6
   rows, each pruned at 0.1 m by the host library, the concatenation
   pruned once more, then partition_cloud_big (k 45/10, reg 0.8, kNN
   adjacency, host_outputs=False) cold and warm. Printed: voxels after the
   chunks and after the global prune, windows, superpoints, superedges,
   the drawing, prune and partition seconds with the stage split
   (features, knn_info, cp_info with relabel_connected and the heal, spg),
   raw Mpts/s, peak device memory, the host library's calls, and the device
   prune's seconds on the global re-prune's rows beside the library's.
   Checks: (a) the cold and warm partitions bit-identical; (b) no label
   disconnected in the kNN adjacency, no CC call at its cap; (c) the kNN
   table equal to a direct-form brute force on 65,536 sampled rows; (d)
   the library's prune equal to prune_plain on the first chunk (voxels,
   order, histograms; xyz within 4 ulp); (e) the library's
   relabel_connected equal to relabel_connected_plain on the scan phase's
   station (cutoff 0); (f) the library's greedy matching equal to
   greedy_matching_plain on the heal's own candidates (each plain version
   timed beside the library).
18. Timing at the nn1 shapes, with CUDA events: the kernel (mean of 3
   calls after a warm-up), the plain version (one call on the queries it
   was checked on: all of them, or the sampled rows), one PyTorch call of
   the same function (torch.cdist in its matrix-product mode + argmin, in
   query chunks) and the bound (6 FP32
   flops a pair, the 3 FMAs of the expanded form, at 67 TFLOP/s, or the
   bytes at 3.35 TB/s if larger). The direct-mode torch.cdist yardstick
   (~21 minutes at 1M x 1M) lives in tools/nn1_cdist_direct.py.
19. One JSON line with the kernel table (top-level numbers at the read
   shape, 1M x 1M; every shape under "shapes"; launches of each path,
   the submission writer's and the parallel phase's included) and the
   training, SSP, custom, vKITTI, output, parallel, Semantic3D chain
   ("headline") and dense-solver ("dense_crop") phases' numbers, the card
   line, and last
   {"ok": true, "device": {...}}.

Exits non-zero on any failure, when no CUDA device is visible, or when run
outside a checkout of the repository. Usage, from the repository root:
    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_POINTS = 1_000_000
N_CHECK = 65_536
SEED = 0
FLAGSHIP = dict(
    model_config="gru_10_0,f_13",
    ptn_widths=((64, 64, 128, 128, 256), (256, 64, 32)),
    ptn_widths_stn=((64, 64, 128), (128, 64)),
    ptn_nfeat=14, ptn_nfeat_stn=11,
    fnet_widths=(13, 32, 128, 64), fnet_llbias=False, fnet_bnidx=2,
)
# (db points, queries) of the adversarial phase: split at 65,536 queries
# and below, unsplit (a db of one 1024-point tile)
ADVERSARIAL_SIZES = ((300_007, 65_536), (100_003, 10_007), (1_000, 100_003))
FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
HBM_BYTES = 3.35e12
# the least arithmetic a pair needs: the expanded form's 3 FMAs (the
# kernel's filter), not the direct form's 3 sub, 3 mul, 2 add
FLOPS_PER_PAIR = 6
# The device solver against the exact one on the slice's room: energy ratio
# at most, component-count ratio range, OOA points below at most. The OOA
# bound is the JAX package's grid tests' (3 points); their energy (1.10) and
# component (0.5-1.5) bounds are missed on this room by the JAX package's own
# band solver, x1.284 and 0.318x (the same features and graph on the CPU,
# tools/cp_room_quality.py, which also holds the port to it), so those two
# are set just outside that reference.
QUALITY_BOUNDS = {"energy_ratio": 1.30, "n_comp_ratio": (0.25, 1.5),
                  "ooa_drop": 3.0}
# the scan: raw points of the synthetic station, and the chunked partition
# against the port's monolithic solve of the same voxels with the same
# region-accept settings: energy ratio at most (the JAX chunked test's
# bound, tests/test_pipeline_big.py:56), OOA points below at most
N_SCAN = 8_000_000
MIN_SCAN_VOXELS = 1_500_000
SCAN_BOUNDS = {"energy_ratio": 1.10, "ooa_drop": 1.0}
# the dense device solver's crop of the room (below its band threshold,
# 16,384 vertices), and how far the card's energy may lie from the CPU's
DENSE_CROP_ROWS, DENSE_ENERGY_RTOL = 12_000, 1e-4


def cuda_ms(fn, reps):
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


def nn1_bound_ms(m, n):
    """(least milliseconds the card needs for nn1 at m db points x n
    queries, what bounds it): the larger of the pairs' FP32 flops over the
    FP32 peak and the bytes (both clouds read once, the int64 indices
    written once) over the memory rate."""
    ops_ms = FLOPS_PER_PAIR * m * n / FP32_FLOPS * 1e3
    bytes_ms = (12 * (m + n) + 8 * n) / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def timed(fn):
    """(fn(), milliseconds it took on the card by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def library_nn1_ms(db, q):
    """Milliseconds of torch.cdist (matrix-product mode, the fastest single
    PyTorch call for it) + argmin over all queries in chunks of ~2**30
    distances, CUDA events, after a one-chunk warm-up. A yardstick only;
    the port never calls it."""
    import torch

    chunk = max(1, 2**30 // len(db))

    def run(queries):
        return [torch.cdist(queries[i:i + chunk], db,
                            compute_mode="use_mm_for_euclid_dist").argmin(1)
                for i in range(0, len(queries), chunk)]

    run(q[:chunk])
    return timed(lambda: run(q))[1]


def compare_nn1(db, q, label, rows=None):
    """nn1 kernel vs its plain version on the card: the kernel on every
    query of `q` (so at that shape's launch plan), the plain version on the
    queries `rows` of it (all when None). Returns the check's numbers (the
    plain call timed with CUDA events) and the plain version's indices, and
    raises unless the indices are equal on every query compared."""
    import torch

    from superpoint_graph_tpu_torch.ops.nn1 import nn1_cuda, nn1_plain

    got = nn1_cuda(db, q)
    out = {"shape": f"db {len(db)} x queries {len(q)}"}
    if rows is not None:
        q, got = q[rows], got[rows]
        out["plain_rows"] = len(rows)
    want, plain_ms = timed(lambda: nn1_plain(db, q))
    d_got = ((q - db[got]) ** 2).sum(1)
    d_want = ((q - db[want]) ** 2).sum(1)
    out.update(max_abs_err=float((d_got - d_want).abs().max()),
               index_agreement=float((got == want).double().mean()),
               plain_ms=plain_ms)
    print(f"[check] nn1 {label}: {json.dumps(out)}", flush=True)
    if not torch.equal(got, want):
        raise AssertionError(f"nn1 kernel disagrees with its plain version "
                             f"({label}): {out}")
    return out, want


def partition_quality(part, cfg, in_comp, components, seconds):
    """Energy (the exact solver's `_energy`), component count, OOA against
    the voxels' labels and seconds of a partition of `part`'s room, on its
    features and kNN graph; and how many labels are not one connected piece
    of that graph."""
    from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                          disconnected_labels)
    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy
    from superpoint_graph_tpu_torch.pipeline import (
        assemble_partition_features, edge_weights)

    feats = assemble_partition_features(part.geof, part.rgb, cfg)
    src = part.graph_nn["source"].astype(np.int64)
    tgt = part.graph_nn["target"].astype(np.int64)
    w = edge_weights(part.graph_nn["distances"], cfg.lambda_edge_weight)
    energy, _ = _energy(feats.astype(np.float64), np.ones(len(feats)),
                        np.asarray(in_comp, np.int64), src, tgt,
                        w.astype(np.float64), cfg.reg_strength)
    return {"seconds": seconds, "energy": energy,
            "n_comp": len(components),
            "OOA": compute_OOA(components, part.labels[:, 1:]),
            "disconnected_labels": disconnected_labels(in_comp, src, tgt)}


def quality_phase(r, cfg, solve_stats):
    """The host exact solver on the slice's features and graph against the
    device solver's partition; raises outside QUALITY_BOUNDS. Returns the
    exact solver's numbers."""
    from superpoint_graph_tpu_torch.ops.cutpursuit import cutpursuit
    from superpoint_graph_tpu_torch.pipeline import (
        assemble_partition_features, edge_weights)

    part = r.partition
    t0 = time.perf_counter()
    comps, in_comp = cutpursuit(
        assemble_partition_features(part.geof, part.rgb, cfg),
        part.graph_nn["source"], part.graph_nn["target"],
        edge_weights(part.graph_nn["distances"], cfg.lambda_edge_weight),
        cfg.reg_strength)
    exact = partition_quality(part, cfg, in_comp, comps,
                              time.perf_counter() - t0)
    device = partition_quality(part, cfg, part.in_component, part.components,
                               r.times["partition_cloud.partition"])
    ratios = {"energy_ratio": device["energy"] / exact["energy"],
              "n_comp_ratio": device["n_comp"] / exact["n_comp"],
              "ooa_drop": exact["OOA"] - device["OOA"]}
    print(f"[quality] device solver (partition stage): {json.dumps(device)}")
    print(f"[quality] exact solver (host): {json.dumps(exact)}")
    print(f"[quality] {json.dumps(ratios)}; bounds "
          f"{json.dumps(QUALITY_BOUNDS)}; host syncs of the device solve "
          f"{solve_stats['host_syncs']}, CC calls capped "
          f"{solve_stats['cc_capped']}", flush=True)
    lo, hi = QUALITY_BOUNDS["n_comp_ratio"]
    if not (ratios["energy_ratio"] <= QUALITY_BOUNDS["energy_ratio"]
            and lo <= ratios["n_comp_ratio"] <= hi
            and ratios["ooa_drop"] <= QUALITY_BOUNDS["ooa_drop"]):
        raise AssertionError(f"device solver outside its bounds: {ratios}")
    if device["disconnected_labels"] or solve_stats["cc_capped"]:
        raise AssertionError("a label is not one connected piece, or a CC "
                             f"call stopped at its cap: {device}, "
                             f"{solve_stats}")
    return exact


def dense_crop_phase(part, cfg, rows=DENSE_CROP_ROWS):
    """The dense device cut pursuit (ops/cutpursuit_dense.py, the JAX
    package's cutpursuit_tpu below its band threshold) on a crop of the
    room's voxels (the `rows` of least x) with the kNN edges inside it: on
    the card and on the CPU, and the host exact solver on the same crop.
    Raises unless the card's energy is within DENSE_ENERGY_RTOL of the
    CPU's. Returns the numbers printed."""
    import torch

    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy, cutpursuit
    from superpoint_graph_tpu_torch.ops.cutpursuit_dense import (
        cutpursuit_dense)
    from superpoint_graph_tpu_torch.pipeline import (
        assemble_partition_features, edge_weights)

    crop = np.sort(np.argsort(part.xyz[:, 0], kind="stable")[:rows])
    local = np.full(len(part.xyz), -1, np.int64)
    local[crop] = np.arange(len(crop))
    src = local[part.graph_nn["source"].astype(np.int64)]
    tgt = local[part.graph_nn["target"].astype(np.int64)]
    keep = (src >= 0) & (tgt >= 0)
    src, tgt = src[keep], tgt[keep]
    w = edge_weights(part.graph_nn["distances"], cfg.lambda_edge_weight)[keep]
    feats = assemble_partition_features(part.geof, part.rgb, cfg)[crop]

    def run(name, fn):
        if name == "card":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ic = fn()
        if name == "card":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        e, _ = _energy(feats.astype(np.float64), np.ones(len(crop)),
                       np.asarray(ic, np.int64), src, tgt,
                       w.astype(np.float64), cfg.reg_strength)
        return {"seconds": seconds, "energy": e, "n_comp": int(ic.max()) + 1}

    out = {"rows": len(crop), "edges": len(src)}
    for name, dev in (("card", torch.device("cuda", 0)), ("cpu", "cpu")):
        out[name] = run(name, lambda: cutpursuit_dense(
            feats, src, tgt, w, cfg.reg_strength, xyz=part.xyz[crop],
            device=dev))
    out["exact"] = run("exact", lambda: cutpursuit(feats, src, tgt, w,
                                                   cfg.reg_strength))
    out["card_vs_cpu_energy"] = abs(out["card"]["energy"] / out["cpu"]["energy"]
                                    - 1.0)
    out["card_vs_exact_energy"] = out["card"]["energy"] / out["exact"]["energy"]
    print(f"[quality] dense solver on a crop of the room: {json.dumps(out)}",
          flush=True)
    if not out["card_vs_cpu_energy"] <= DENSE_ENERGY_RTOL:
        raise AssertionError("the dense solver's energy on the card is not "
                             f"within {DENSE_ENERGY_RTOL} of the CPU's: {out}")
    return out


def same_component_share(a, b) -> float:
    """Share of the points whose component is the same point set in the
    partitions `a` and `b` (labels [n] each)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    base = int(b.max()) + 1
    pairs, inv = np.unique(a * base + b, return_inverse=True)
    pa, pb = pairs // base, pairs % base
    alone = (np.bincount(pa)[pa] == 1) & (np.bincount(pb)[pb] == 1)
    return float(alone[inv.ravel()].mean())


def run_to_run_phase(r, cfg, raw, dev):
    """The room's raw arrays pruned twice, features built twice, the device
    solve and the whole device path run twice: prints whether each stage's
    output is bit-identical, and raises unless every one is (and equal to
    the slice's). Then the region accept's quality on the same inputs, for
    reference."""
    import torch

    from superpoint_graph_tpu_torch.ops import cutpursuit_band as cb
    from superpoint_graph_tpu_torch.ops.components import group_components
    from superpoint_graph_tpu_torch.ops.cutpursuit import merge_regions
    from superpoint_graph_tpu_torch.ops.voxel import prune
    from superpoint_graph_tpu_torch.pipeline import (
        _assemble_features_device, _cutpursuit_device_path,
        assemble_partition_features, edge_weights, partition_features)

    xyz, rgb, labels, objects = raw
    pr = [prune(xyz, cfg.voxel_width, rgb, labels, objects, 13,
                int(objects.max()) + 1, device=dev) for _ in range(2)]
    fe = [partition_features(pr[0][0], cfg, device=dev, return_device=True)
          for _ in range(2)]
    tabs = [t for _, _, t in fe]
    same = {
        "voxels": all(np.array_equal(a, b) for a, b in zip(*pr)),
        "voxels = slice's": np.array_equal(pr[0][0], r.partition.xyz),
        "knn": all(torch.equal(tabs[0][k], tabs[1][k]) for k in ("idx", "d2")),
        "geof": np.array_equal(fe[0][1], fe[1][1]),
    }
    k = cfg.k_nn_adj
    xyz_v, rgb_v = pr[0][0], pr[0][1]
    f_dev = _assemble_features_device(tabs[0]["geof"],
                                      torch.as_tensor(rgb_v, device=dev))

    def solve(**kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ic = cb.cutpursuit_band_device(
            f_dev, tabs[0]["idx"][:, :k], tabs[0]["d2"][:, :k], xyz_v,
            len(xyz_v), cfg.reg_strength,
            lambda_edge_weight=cfg.lambda_edge_weight, **kw)
        return ic, time.perf_counter() - t0, dict(cb.LAST_SOLVE_STATS)

    solves = [solve() for _ in range(2)]
    paths = [_cutpursuit_device_path(xyz_v, rgb_v, fe[0][0], tabs[0], cfg)
             for _ in range(2)]
    same["solve (before merge)"] = np.array_equal(solves[0][0], solves[1][0])
    same["in_component"] = np.array_equal(paths[0][1], paths[1][1])
    same["in_component = slice's"] = np.array_equal(paths[0][1],
                                                    r.partition.in_component)
    print(f"[run-to-run] bit-identical: {json.dumps(same)}")
    print("[run-to-run] share of voxels in a superpoint found by both calls: "
          f"solve {same_component_share(solves[0][0], solves[1][0]):.6f}, "
          f"path {same_component_share(paths[0][1], paths[1][1]):.6f}")
    print(f"[run-to-run] warm device solve {solves[1][1]:.4f} s "
          f"(cold {solves[0][1]:.4f} s), superpoints "
          f"{[len(p[0]) for p in paths]}, merge "
          f"{[round(p[2]['merge'], 4) for p in paths]} s; "
          f"{json.dumps(solves[1][2])}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"a stage is not bit-identical: {same}")

    ic, seconds, stats = solve(accept="region", max_iter=16)
    g = fe[0][0]
    ic = merge_regions(
        assemble_partition_features(fe[0][1], rgb_v, cfg), np.ones(len(ic)),
        ic, g["source"].astype(np.int64), g["target"].astype(np.int64),
        edge_weights(g["distances"], cfg.lambda_edge_weight),
        cfg.reg_strength)
    region = partition_quality(r.partition, cfg, ic, group_components(ic),
                               seconds)
    print(f"[run-to-run] region accept (max_iter 16), for reference: "
          f"{json.dumps(region)}; {json.dumps(stats)}", flush=True)


def brute_knn_rows(xyz, ids, k, chunk=128):
    """Exact kNN of the points `ids` of xyz among all others by a direct-form
    brute force: every (dx^2 + dy^2) + dz^2 distance (the port's exact
    form), the point itself excluded, the k nearest by (distance, index).
    Returns (indices, squared distances)."""
    import torch

    out_i, out_d = [], []
    for s in range(0, len(ids), chunk):
        q = ids[s:s + chunk]
        dx, dy, dz = (xyz[q, a][:, None] - xyz[None, :, a] for a in range(3))
        d2 = (dx * dx + dy * dy) + dz * dz
        del dx, dy, dz
        d2[torch.arange(len(q), device=xyz.device), q] = float("inf")
        _, cand = torch.topk(d2, k + 8, dim=1, largest=False)
        cand, _ = torch.sort(cand, dim=1)
        dc, order = torch.sort(torch.gather(d2, 1, cand), dim=1, stable=True)
        out_i.append(torch.gather(cand, 1, order[:, :k]))
        out_d.append(dc[:, :k])
    return torch.cat(out_i), torch.cat(out_d)


def chunked_vs_monolithic(r, cfg, dev):
    """The scan's chunked partition against the port's single solve of the
    same voxels (region accept, max_iter 16, stop_tol 1e-3, cc_jumps 1,
    then the merge step over the full kNN list), both measured by the exact
    solver's energy and by OOA on the reader's label histograms. Also the
    kNN table recomputed (equal to the path's) for the brute-force check.
    Returns (numbers, the kNN tables)."""
    import torch

    from superpoint_graph_tpu_torch.learn.metrics import (compute_OOA,
                                                          disconnected_labels)
    from superpoint_graph_tpu_torch.ops.components import group_components
    from superpoint_graph_tpu_torch.ops.cutpursuit import (
        _densify_first_occurrence, _energy)
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import (
        LAST_SOLVE_STATS, cutpursuit_band_device, edge_weights_device)
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud
    from superpoint_graph_tpu_torch.ops.merge_device import (
        merge_regions_device)
    from superpoint_graph_tpu_torch.pipeline import assemble_partition_features

    part = r.partition
    n, k = len(part.xyz), cfg.k_nn_adj
    xyz = torch.as_tensor(part.xyz, device=dev)
    bi, bd2, _ = knn_bigcloud(xyz, cfg.k_nn_geof)
    same_knn = np.array_equal(bi[:, :k].reshape(-1).cpu().numpy(),
                              part.graph_nn["target"].astype(np.int64))
    feats = assemble_partition_features(part.geof, None, cfg)
    f_dev = torch.as_tensor(feats, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ic = cutpursuit_band_device(
        f_dev, bi[:, :k], bd2[:, :k], xyz, n, cfg.reg_strength,
        lambda_edge_weight=cfg.lambda_edge_weight, accept="region",
        max_iter=16, stop_tol=1e-3, cc_jumps=1)
    stats = dict(LAST_SOLVE_STATS)
    src = torch.arange(n, device=dev).repeat_interleave(k)
    w = edge_weights_device(bd2[:, :k].reshape(-1), cfg.lambda_edge_weight)
    label = merge_regions_device(
        f_dev, torch.ones(n, device=dev), torch.as_tensor(ic, device=dev),
        src, bi[:, :k].reshape(-1), w, int(ic.max()) + 1, cfg.reg_strength)
    ic = _densify_first_occurrence(label[ic])
    mono_s = time.perf_counter() - t0
    src_h = part.graph_nn["source"].astype(np.int64)
    tgt_h = part.graph_nn["target"].astype(np.int64)
    w_h = w.double().cpu().numpy()
    hist = part.labels[:, 1:]

    def measure(in_comp, comps):
        e, _ = _energy(feats.astype(np.float64), np.ones(n),
                       np.asarray(in_comp, np.int64), src_h, tgt_h, w_h,
                       cfg.reg_strength)
        return {"energy": e, "n_comp": len(comps),
                "OOA": compute_OOA(comps, hist),
                "disconnected_labels": disconnected_labels(in_comp, src_h,
                                                           tgt_h)}

    chunked = measure(part.in_component, part.components)
    mono = measure(ic, group_components(ic))
    mono.update(seconds=mono_s, solve=stats)
    return {"chunked": chunked, "monolithic": mono,
            "energy_ratio": chunked["energy"] / mono["energy"],
            "ooa_drop": mono["OOA"] - chunked["OOA"],
            "knn_equal_to_path": same_knn}, (xyz, bi, bd2)


def scan_phase(dev, tmp):
    """The Semantic3D serving path on a synthetic station (phase 10).
    Returns (nn1 launches of the cold run, the nn1 checks of the spread
    stage's chunks, (the scan's voxels, its raw chunks) on the card for
    the timing phase, the cold run's ScanLabels, the scan's path)."""
    import pandas as pd
    import torch

    from superpoint_graph_tpu_torch.data.provider import reduced_labels2full
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.ops.nn1 import nn1
    from superpoint_graph_tpu_torch.scan import (SEMA3D_CONFIG, SEMA3D_MODEL,
                                                 VER_BATCH, label_scan)

    path = Path(tmp) / "station1.txt"
    t0 = time.perf_counter()
    write_semantic3d_scan(path, N_SCAN, SEED)
    print(f"[scan] wrote {N_SCAN} raw points and their labels as text in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    model = SpgModel(8, **dict(FLAGSHIP, **SEMA3D_MODEL))
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    runs = []
    for name in ("cold", "warm"):
        nn1.launches = 0
        t0 = time.perf_counter()
        r = label_scan(str(path), model, dev)
        total = time.perf_counter() - t0
        runs.append((r, total, nn1.launches))
        print(f"[scan] {name}: total {total:.3f} s, "
              f"{r.counts['raw_points'] / total:.1f} raw points/s, nn1 "
              f"launches {nn1.launches}; counts {json.dumps(r.counts)}")
        print(f"[scan] {name} stages: " + json.dumps(
            {k: v for k, v in r.times.items()
             if k not in ("partition_cloud.cp_info",
                          "partition_cloud.knn_levels")}))
        print(f"[scan] {name} chunked cut pursuit: "
              f"{json.dumps(r.times.get('partition_cloud.cp_info'))}")
        print(f"[scan] {name} knn: "
              f"{json.dumps(r.times.get('partition_cloud.knn_levels'))}",
              flush=True)
    (r, _, launches), (r2, _, _) = runs
    n_sp = r.counts["superpoints"]
    if launches < 2:
        raise AssertionError(f"nn1 launched {launches} times on the scan")
    if "partition_cloud.cp_info" not in r.times or r.counts["chunks"] < 4:
        raise AssertionError("the scan did not go through the chunked path "
                             f"with >= 4 chunks: {r.counts}")
    if r.counts["voxels"] < MIN_SCAN_VOXELS:
        raise AssertionError(f"{r.counts['voxels']} voxels < "
                             f"{MIN_SCAN_VOXELS}")
    if r.logits.shape != (n_sp, 8) or not np.isfinite(r.logits).all():
        raise AssertionError(f"logits {r.logits.shape} not finite [n_sp, 8]")
    if (r.labels.shape != (N_SCAN,) or r.labels.min() < 1
            or r.labels.max() > 8):
        raise AssertionError("scan labels out of shape or of 1..8")
    repeat = (np.array_equal(r.partition.xyz, r2.partition.xyz)
              and np.array_equal(r.partition.in_component,
                                 r2.partition.in_component)
              and np.array_equal(r.labels, r2.labels))
    print(f"[scan] cold and warm runs bit-identical (voxels, partition, "
          f"labels): {repeat}")
    if not repeat:
        raise AssertionError("the scan's partition differs between runs")

    t0 = time.perf_counter()
    cmp, (xyz, bi, bd2) = chunked_vs_monolithic(r, SEMA3D_CONFIG, dev)
    print(f"[scan] chunked against monolithic ({time.perf_counter() - t0:.1f}"
          f" s): {json.dumps(cmp)}; bounds {json.dumps(SCAN_BOUNDS)}",
          flush=True)
    if not (cmp["energy_ratio"] <= SCAN_BOUNDS["energy_ratio"]
            and cmp["ooa_drop"] <= SCAN_BOUNDS["ooa_drop"]
            and cmp["chunked"]["disconnected_labels"] == 0
            and r.times["partition_cloud.cp_info"]["cc_capped"] == 0
            and cmp["knn_equal_to_path"]):
        raise AssertionError(f"chunked partition outside its bounds: {cmp}")

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randperm(len(xyz), device=dev, generator=g)[:N_CHECK]
    want_i, want_d = brute_knn_rows(xyz, rows, SEMA3D_CONFIG.k_nn_geof)
    knn_ok = torch.equal(bi[rows], want_i) and torch.equal(bd2[rows], want_d)
    print(f"[scan] knn_bigcloud equal to brute force on {N_CHECK} rows: "
          f"{knn_ok}", flush=True)
    if not knn_ok:
        raise AssertionError("knn_bigcloud differs from brute force")

    # the kernel at each of the spread stage's shapes (the voxels against
    # each ver_batch chunk of raw rows, as interpolate_labels_batch reads
    # them), held to the plain version on N_CHECK sampled rows; the path's
    # labels of those rows must be the voxel classes the plain nn1 picks
    raw = pd.read_csv(path, sep=" ", header=None, usecols=[0, 1, 2]).values
    raw = torch.as_tensor(np.ascontiguousarray(raw, np.float32), device=dev)
    voxel_cls = reduced_labels2full(r.logits.argmax(1).astype(np.uint8) + 1,
                                    r.partition.components, len(xyz))
    checks, chunks = [], []
    for c, o in enumerate(range(0, len(raw), VER_BATCH)):
        q = raw[o:o + VER_BATCH]
        rows = torch.randperm(len(q), device=dev, generator=g)[:N_CHECK]
        check, want = compare_nn1(xyz, q, f"scan spread, chunk {c}", rows)
        rows_h = rows.cpu().numpy()
        lab_ok = np.array_equal(r.labels[o + rows_h],
                                voxel_cls[want.cpu().numpy()])
        print(f"[scan] chunk {c}: labels of the {N_CHECK} sampled raw points "
              f"equal to the plain nn1's voxel classes: {lab_ok}", flush=True)
        if not lab_ok:
            raise AssertionError(f"scan labels of chunk {c} disagree with the "
                                 "plain nn1")
        checks.append(check)
        chunks.append(q)
    return launches, checks, (xyz, chunks), r, path


# the training phase: three more synthetic rooms partitioned by the
# partition CLI's per-file function at its defaults, the flagship trained by
# the training CLI's functions at the S3DIS recipe's flags (docs/DATASETS.md);
# checks (b) and (c) by learn/train_check.py, within its TRAIN_TOL
TRAIN_ROOMS, TRAIN_ROOM_POINTS = 3, 300_000
TRAIN_RECIPE = ["--dataset", "s3dis", "--model_config", "gru_10_0,f_13",
                "--ptn_nfeat_stn", "14", "--pc_attribs", "xyzrgbelpsvXYZ",
                "--lr_steps", "[275,320]", "--seed", str(SEED)]
# steps on one fixed batch, and the share of the first loss the last must
# fall below; steps timed for steps/s after the warm-ups
OVERFIT_STEPS, OVERFIT_RATIO = 30, 0.5
TIMED_STEPS, WARM_STEPS = 20, 3


@contextlib.contextmanager
def recorded(module, name, sync=None):
    """Within: `module.<name>` runs as it is and appends each call's
    (result, host seconds) to the yielded list; with `sync` (a CUDA
    device) the seconds end after the device has finished the call."""
    import torch

    calls, orig = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        if sync is not None:
            torch.cuda.synchronize(sync)
        calls.append((out, time.perf_counter() - t0))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def overfit(trainer, batch, steps=OVERFIT_STEPS):
    """Losses of `steps` train_steps on one batch."""
    return [float(trainer.train_step(batch)[0]) for _ in range(steps)]


def train_phase(dev, tmp, room_part, points=TRAIN_ROOM_POINTS):
    """The training path on `dev` (phase 9; tools/torch_train_phase_cpu.py
    runs it on the CPU with smaller rooms) on TRAIN_ROOMS rooms of `points`
    raw points: returns (nn1 launches of the partition CLI's runs, the nn1
    checks at its rooms' read shapes, the phase's numbers, and for the
    parallel phase {"fresh": a trainer factory of the trained weights,
    "batches": its drawn batches, "train_entries": the training rooms' SPG
    entries before scaling})."""
    import torch

    from superpoint_graph_tpu_torch.cli import partition as cli_partition
    from superpoint_graph_tpu_torch.cli import train as cli_train
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.data.datasets import get_info
    from superpoint_graph_tpu_torch.data.loader import (collate_spg,
                                                        load_spg_sample)
    from superpoint_graph_tpu_torch.data.spg_io import scaler01
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.learn import checkpoint as ckpt
    from superpoint_graph_tpu_torch.learn.train_check import (
        bn_fed_biases, card_vs_cpu, compare_steps, draw_batches, step_record,
        trainer_factory, training_rooms)
    from superpoint_graph_tpu_torch.ops.nn1 import nn1
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    root = Path(tmp)
    paths, want_labels = {}, {}
    for i in range(1, TRAIN_ROOMS + 1):
        name = f"Area_1/room_{i}"
        paths[name], want_labels[name], _ = write_s3dis_room(
            root / "data" / "Area_1" / f"room_{i}",
            np.random.RandomState(SEED + i), points)
    p_args = cli_partition.parse_args(["--ROOT_PATH", str(root)])
    parts, part_s = {}, {}
    nn1.launches = 0
    with recorded(provider, "read_s3dis_format") as reads:
        for name, path in paths.items():
            t0 = time.perf_counter()
            parts[name] = cli_partition.partition_file(str(path), p_args, dev)
            part_s[name] = time.perf_counter() - t0
    launches = nn1.launches
    parts["Area_2/room_0"] = room_part
    for name, p in parts.items():
        print(f"[train] {name}: {len(p.xyz)} voxels, {len(p.components)} "
              f"superpoints, {len(p.graph_sp['source'])} superedges"
              + (f", partition_file {part_s[name]:.3f} s" if name in part_s
                 else " (the room phase's partition)"), flush=True)
    print(f"[train] nn1 launches in partition_file: {launches}", flush=True)
    # the reader's output in each partition_file run: its labels against
    # the generator's, and the kernel at that room's read shape (the room's
    # points against its annotation points) against the plain version on
    # N_CHECK sampled queries
    if len(reads) != len(paths):
        raise AssertionError(f"{len(reads)} reader calls for {len(paths)} "
                             "rooms")
    checks, read_agree = [], {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for (name, path), ((xyz, _, labels, _), _) in zip(paths.items(), reads):
        agree = read_agree[name] = float((labels == want_labels[name]).mean())
        print(f"[check] {name}: reader labels equal to the generator's: "
              f"{agree:.6f}", flush=True)
        if agree < 0.9999:
            raise AssertionError(f"{name}: read_s3dis_format labels disagree "
                                 "with the room")
        if not on_card:
            continue
        ann = torch.as_tensor(np.concatenate([
            provider.read_rows(str(f))[:, :3]
            for f in sorted(path.parent.glob("Annotations/*.txt"))
        ]).astype(np.float32), device=dev)
        pick = torch.randint(0, len(ann), (N_CHECK,), device=dev, generator=g)
        checks.append(compare_nn1(torch.as_tensor(xyz, device=dev), ann,
                                  f"{name} read shape", rows=pick)[0])

    entries, rows = training_rooms(parts, EDGE_ATTRIBS)
    train_names = [n for n in entries if n.startswith("Area_1")]
    test_names = ["Area_2/room_0"]
    trainlist, testlist, _, scaler = scaler01(
        [entries[n] for n in train_names], [entries[n] for n in test_names])
    args = cli_train.parse_args(TRAIN_RECIPE)
    args.test_multisamp_n = 2
    dbinfo = get_info("s3dis", str(root), EDGE_ATTRIBS, args.pc_attribs)
    _, trainer, loader_cfg, n_ch = cli_train.build(args, dbinfo, dev)
    rng = np.random.RandomState(SEED)
    epochs = []
    for epoch in range(2):
        trainer.set_epoch_lr(epoch)
        loss, cm, info = cli_train.run_epoch(
            trainer, trainlist, train_names, rows.__getitem__, loader_cfg,
            n_ch, dbinfo, True, rng, args.batch_size)
        epochs.append({"epoch": epoch, "loss": loss,
                       "acc": 100 * cm.get_overall_accuracy(), **info})
    te_loss, te_cm, te_info = cli_train.run_epoch(
        trainer, testlist, test_names, rows.__getitem__, loader_cfg, n_ch,
        dbinfo, False, rng, 1)
    epochs.append({"test_loss": te_loss,
                   "oacc": 100 * te_cm.get_overall_accuracy(), **te_info})
    preds, final_cm = cli_train.eval_final(
        args, trainer, testlist, test_names, rows.__getitem__, loader_cfg,
        n_ch, dbinfo)
    for e in epochs:
        print(f"[train] epoch {json.dumps(e)}", flush=True)
    final = {"oacc": final_cm.get_overall_accuracy(),
             "miou": final_cm.get_average_intersection_union(),
             "superpoints": len(preds["Area_2/room_0"])}
    print(f"[train] eval_final (test_multisamp_n 2): {json.dumps(final)}")
    # (a) every loss finite
    losses = [e.get("loss", e.get("test_loss")) for e in epochs]
    if not np.isfinite(losses).all():
        raise AssertionError(f"a training loss is not finite: {losses}")

    # model.ckpt saved and reloaded: the architecture from its own args,
    # eval logits equal (index_add in its deterministic mode for both)
    ck = str(root / "model.ckpt")
    ckpt.save_checkpoint(ck, trainer.state_dict(), 2,
                         vars(args) | {"lr_steps": list(args.lr_steps)},
                         scaler.state_dict())
    b_args = cli_train.parse_args(TRAIN_RECIPE)
    for k in cli_train.ARCH_KEYS:
        setattr(b_args, k, ckpt.read_checkpoint_args(ck)[k])
    _, reloaded, _, _ = cli_train.build(b_args, dbinfo, dev)
    state, ck_epoch, _, _ = ckpt.load_checkpoint(ck, map_location=dev)
    reloaded.load_state_dict(state)
    test_batch = collate_spg(
        [load_spg_sample(testlist[0], rows[test_names[0]], loader_cfg)],
        loader_cfg, dbinfo.classes, n_ch, dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            same_logits = torch.equal(trainer.eval_step(test_batch)[1],
                                      reloaded.eval_step(test_batch)[1])
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[train] model.ckpt reloaded (epoch {ck_epoch}): eval logits "
          f"equal {same_logits}", flush=True)
    if not same_logits or ck_epoch != 2:
        raise AssertionError("the reloaded checkpoint's logits differ")

    batches, load_s = draw_batches(trainlist, train_names, rows, loader_cfg,
                                   dbinfo, n_ch, rng, args.batch_size, dev)
    n_sp = [int(b.node_mask.sum()) for b in batches]

    # (b) card against CPU, one step's forward and backward from the same
    # weights, memory monger on
    zero = bn_fed_biases(trainer.model)
    fresh = trainer_factory(args, dbinfo, trainer.model.state_dict())
    check_b = card_vs_cpu(fresh, batches[0], zero)
    # (c) memory monger on against off, on the card
    on_dev = step_record(fresh(dev), batches[0])
    off_dev = step_record(fresh(dev, monger=False), batches[0])
    check_c = compare_steps(on_dev, off_dev, "(c) monger on vs off, card",
                            zero, exact_stats=True)
    # (d) 30 steps on one batch
    fit = overfit(fresh(dev), batches[0])
    ratio = fit[-1] / fit[0]
    print(f"[train] (d) {OVERFIT_STEPS} steps on one batch: loss "
          f"{fit[0]:.4f} -> {fit[-1]:.4f} (x{ratio:.4f}, bound "
          f"x{OVERFIT_RATIO})", flush=True)
    if not (np.isfinite(fit).all() and ratio < OVERFIT_RATIO):
        raise AssertionError(f"30 steps on one batch: loss x{ratio:.4f}")

    # steps/s at batch 2: CUDA events over TIMED_STEPS after WARM_STEPS
    timer = fresh(dev)
    for i in range(WARM_STEPS):
        timer.train_step(batches[i % len(batches)])
    steps = lambda: [timer.train_step(batches[i % len(batches)])  # noqa: E731
                     for i in range(TIMED_STEPS)]
    if on_card:
        _, ms = timed(steps)
    else:  # the CPU check of tools/torch_train_phase_cpu.py: wall clock
        t0 = time.perf_counter()
        [float(loss) for loss, _ in steps()]
        ms = (time.perf_counter() - t0) * 1e3
    out = {
        "train_steps_per_s": TIMED_STEPS / (ms / 1e3),
        "step_ms": ms / TIMED_STEPS,
        "batch_size": args.batch_size,
        "host_load_collate_s_per_batch": float(np.mean(load_s)),
        "superpoints_per_batch": float(np.mean(n_sp)),
        "superpoints_per_batch_epochs": [e["superpoints_per_batch"]
                                         for e in epochs[:2]],
        "max_memory_allocated_gib": (
            torch.cuda.max_memory_allocated(dev) / 2**30 if on_card
            else None),
        "epochs": epochs, "eval_final": final, "nn1_launches": launches,
        "rooms": {n: {"voxels": len(p.xyz), "superpoints": len(p.components),
                      "superedges": int(len(p.graph_sp["source"]))}
                  for n, p in parts.items()},
        "partition_file_s": part_s, "reader_label_agreement": read_agree,
        "overfit_losses": [fit[0], fit[-1]],
        "overfit_ratio": ratio, "card_vs_cpu": check_b,
        "monger_on_vs_off": check_c,
        "phase_s": time.perf_counter() - t_phase,
    }
    for k in ("train_steps_per_s", "step_ms", "host_load_collate_s_per_batch",
              "superpoints_per_batch", "max_memory_allocated_gib", "phase_s"):
        print(f"[train] {k}: {out[k]}")
    sys.stdout.flush()
    ctx = {"fresh": fresh, "batches": batches,
           "train_entries": [entries[n] for n in train_names]}
    return launches, checks, out, ctx


# the supervised partition (SSP): five more synthetic rooms through
# cli/ssp_preprocess.preprocess_file at its defaults (the S3DIS recipe:
# voxel 0.03, k_nn_adj 5, k_nn_local 20, the RANSAC plane), the embedder
# trained by cli/ssp_train's loop at its defaults (batch 4, max_ver_train
# 10000, Adam 1e-2, clip 1, TVH_zhang, crosspartition, reg 0.8, spatial_emb
# 0.2, CP_cutoff 25, --cp_backend tpu: the device solver in every step),
# partitions by cli/ssp_generate; structures and SPGs in memory (no h5py on
# the card's machine). Area_1/room_0 is the test room at cvfold 1.
SSP_ROOMS = ("Area_1/room_0",) + tuple(f"Area_2/room_{i}" for i in range(1, 5))
SSP_ROOM_POINTS = 300_000
SSP_OVERFIT_STEPS = 30
# sampled rows of the structure's card-against-CPU kNN, geof and transitions
SSP_CHECK_ROWS = 8192


def structure_vs_cpu(raw, s, dev, rows=SSP_CHECK_ROWS, dataset="s3dis",
                     voxel=0.03, tag="ssp"):
    """The card's supervision structure `s` of a cloud against the CPU's
    from the reader's arrays `raw`: the prune on the CPU (voxels, rgb,
    label histograms, elevation, xyn bit-equal; S3DIS's objects too), then
    on `rows` sampled voxels the CPU's exact kNN (the card's adjacency and
    local tables' rows equal), geof (1e-5, 2e-2 on degenerate
    neighbourhoods, the port's tolerance) and transitions (equal: where
    the object (s3dis) or the hard label (vkitti) changes). Raises outside
    them."""
    import torch

    from superpoint_graph_tpu_torch.ops.geof import compute_geof_rows
    from superpoint_graph_tpu_torch.ops.knn import knn_vs_db
    from superpoint_graph_tpu_torch.ops.voxel import prune
    from superpoint_graph_tpu_torch.utils.ransac import plane_elevation

    t0 = time.perf_counter()
    xyz, rgb, labels = raw[:3]
    objects = raw[3] if dataset == "s3dis" else None
    vx, vrgb, vlab, vobj = prune(
        np.asarray(xyz, np.float32), voxel, rgb, np.asarray(labels, np.int32),
        None if objects is None else np.asarray(objects, np.int32), 13,
        0 if objects is None else int(objects.max()) + 1, device="cpu")
    ma, mi = vx[:, :2].max(0, keepdims=True), vx[:, :2].min(0, keepdims=True)
    equal = {
        "voxels": np.array_equal(vx, s["xyz"]),
        "rgb": np.array_equal(vrgb.astype(np.float32), s["rgb"]),
        "labels": np.array_equal(vlab, s["labels"]),
        "elevation": np.array_equal(plane_elevation(vx).astype(np.float32),
                                    s["elevation"]),
        "xyn": np.array_equal(((vx[:, :2] - mi) / (ma - mi + 1e-8))
                              .astype(np.float32), s["xyn"]),
    }
    if dataset == "s3dis":
        key = vobj[:, 1:].argmax(1) + 1
        equal["objects"] = np.array_equal(key, s["objects"])
    else:
        key = vlab.argmax(1)
    n, k = len(vx), s["target_local_geometry"].shape[1]
    k_adj = len(s["graph_nn"]["source"]) // n
    rows = min(rows, n)
    pick = np.sort(np.random.RandomState(SEED).choice(n, rows, replace=False))
    x = torch.as_tensor(vx)
    idx, _ = knn_vs_db(x, torch.as_tensor(pick), k)
    idx = idx.numpy()
    equal["knn_rows"] = np.array_equal(
        idx, s["target_local_geometry"][pick].astype(np.int64))
    equal["adjacency_rows"] = np.array_equal(
        idx[:, :k_adj],
        s["graph_nn"]["target"].reshape(n, k_adj)[pick].astype(np.int64))
    equal["transition_rows"] = np.array_equal(
        (key[pick][:, None] != key[idx[:, :k_adj]]).astype(np.uint8),
        s["is_transition"].reshape(n, k_adj)[pick])
    geof = compute_geof_rows(x, x[pick], torch.as_tensor(idx)).numpy()
    geof[:, 3] *= 2.0
    err = np.abs(geof - s["geof"][pick])
    out = {"rows": rows, "equal": equal, "geof_max_abs": float(err.max()),
           "geof_rows_within_1e-5": float((err.max(1) <= 1e-5).mean()),
           "seconds": time.perf_counter() - t0}
    print(f"[{tag}] structure card vs CPU: {json.dumps(out)}", flush=True)
    if not (all(equal.values()) and out["geof_max_abs"] <= 2e-2
            and out["geof_rows_within_1e-5"] >= 0.99):
        raise AssertionError(f"the SSP structure differs on the CPU: {out}")
    return out


def inloop_vs_exact(trainer, loss_cfg, batch, dev, tag="ssp"):
    """The in-loop partition of `trainer`'s training-mode embeddings of
    `batch`: the device solver against the host exact one on the same
    energy (QUALITY_BOUNDS energy and components, no capped CC call;
    raises outside them). Returns the numbers."""
    import dataclasses

    import torch

    from superpoint_graph_tpu_torch.ops import cutpursuit_band
    from superpoint_graph_tpu_torch.ops.cutpursuit import _energy
    from superpoint_graph_tpu_torch.ssp import losses

    with torch.no_grad():
        emb = trainer.embed_train(batch)
        diff = losses.compute_dist(emb, torch.as_tensor(batch["edg_source"],
                                                        device=dev),
                                   torch.as_tensor(batch["edg_target"],
                                                   device=dev),
                                   loss_cfg.dist_type).cpu().numpy()
    emb = emb.cpu().numpy()
    es, et = batch["edg_source"], batch["edg_target"]
    f = np.hstack([emb, loss_cfg.spatial_emb * batch["xyz"]]).astype(np.float64)
    w = (np.exp(diff * loss_cfg.edge_weight_threshold)
         / np.exp(loss_cfg.edge_weight_threshold)).astype(np.float64)
    reg = loss_cfg.reg_strength / (4 * loss_cfg.k_nn_adj)
    quality = {}
    for backend in ("device", "exact"):
        t0 = time.perf_counter()
        comps, in_comp = losses.compute_partition(
            dataclasses.replace(loss_cfg, cp_backend=backend), emb, es, et,
            diff, batch["xyz"], dev)
        quality[backend] = {
            "seconds": time.perf_counter() - t0, "n_comp": len(comps),
            "energy": _energy(f, np.ones(len(f)), in_comp.astype(np.int64),
                              es, et, w, reg)[0]}
        if backend == "device":
            quality["device"]["solve"] = dict(cutpursuit_band.LAST_SOLVE_STATS)
    quality["energy_ratio"] = (quality["device"]["energy"]
                               / quality["exact"]["energy"])
    quality["n_comp_ratio"] = (quality["device"]["n_comp"]
                               / quality["exact"]["n_comp"])
    print(f"[{tag}] in-loop partition, device vs exact: {json.dumps(quality)}"
          f"; bounds energy x{QUALITY_BOUNDS['energy_ratio']}, components "
          f"{QUALITY_BOUNDS['n_comp_ratio']}", flush=True)
    lo, hi = QUALITY_BOUNDS["n_comp_ratio"]
    if not (quality["energy_ratio"] <= QUALITY_BOUNDS["energy_ratio"]
            and lo <= quality["n_comp_ratio"] <= hi
            and quality["device"]["solve"]["cc_capped"] == 0):
        raise AssertionError(f"the in-loop device solve is outside its "
                             f"bounds: {quality}")
    return quality


def spg_readable(graph_sp, comps, in_comp, tmp) -> str:
    """An SPG of ssp_generate through utils/h5io.write_spg and read_spg
    (the same graph back), or where h5py is absent the in-memory SPG
    checked against what write_spg stores: every dataset present, one row
    a superpoint, the point counts those of in_component. Returns which
    check ran; raises on a mismatch."""
    from superpoint_graph_tpu_torch.utils import h5io

    n_sp = len(comps)
    if importlib.util.find_spec("h5py"):
        path = Path(tmp) / "spg_check.h5"
        h5io.write_spg(str(path), graph_sp, comps, in_comp)
        graph, comps_r, in_comp_r = h5io.read_spg(str(path))
        ok = (np.array_equal(in_comp_r, in_comp) and len(comps_r) == n_sp
              and all(np.array_equal(graph[k], np.asarray(
                  graph_sp[k], graph[k].dtype)) for k in graph if k != "is_nn"))
        how = "read_spg"
    else:
        keys = set(h5io.SPG_KEYS_F32) | {"sp_labels", "sp_point_count",
                                         "source", "target"}
        counts = np.bincount(np.asarray(in_comp), minlength=n_sp)
        ok = (keys <= set(graph_sp)
              and all(len(graph_sp[k]) == n_sp for k in (
                  "sp_centroids", "sp_length", "sp_labels", "sp_point_count"))
              and np.array_equal(np.ravel(graph_sp["sp_point_count"]), counts)
              and all(np.array_equal(np.flatnonzero(in_comp == i), c)
                      for i, c in enumerate(comps)))
        how = "in memory (no h5py)"
    if not ok:
        raise AssertionError(f"an SSP superpoint graph is not readable ({how})")
    return how


def ssp_phase(dev, tmp, points=SSP_ROOM_POINTS):
    """The supervised partition's path on `dev` (tools/torch_ssp_phase_cpu.py
    runs it on the CPU with smaller rooms): returns (nn1 launches of the
    path, the nn1 check at a room's read shape, the phase's numbers)."""
    import torch

    from superpoint_graph_tpu_torch.cli import (ssp_evaluate, ssp_generate,
                                                ssp_preprocess, ssp_train)
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.learn.checkpoint import save_checkpoint
    from superpoint_graph_tpu_torch.learn.train_check import (
        bn_fed_biases, branches, card_vs_cpu, pooling_nets, ssp_step_record,
        ssp_trainer_factory)
    from superpoint_graph_tpu_torch.ops import cutpursuit_band
    from superpoint_graph_tpu_torch.ops.nn1 import nn1
    from superpoint_graph_tpu_torch.ssp import losses
    from superpoint_graph_tpu_torch.ssp.embed import SspTrainer
    from superpoint_graph_tpu_torch.ssp.evaluate import aggregate_matrices
    from superpoint_graph_tpu_torch.ssp.graph_processing import (
        graph_collate, graph_loader)
    from superpoint_graph_tpu_torch.utils.ransac import ransac_plane

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    root = Path(tmp)
    paths, want_labels = {}, {}
    t0 = time.perf_counter()
    for i, name in enumerate(SSP_ROOMS):
        paths[name], want_labels[name], _ = write_s3dis_room(
            root / "data" / name, np.random.RandomState(SEED + 20 + i), points)
    write_s = time.perf_counter() - t0
    print(f"[ssp] wrote {len(SSP_ROOMS)} rooms of {points} raw points in "
          f"{write_s:.2f} s", flush=True)
    p_args = ssp_preprocess.parse_args(["--ROOT_PATH", str(root)])
    t_args = ssp_train.parse_args(["--seed", str(SEED)])
    model_cfg, loss_cfg, loader_cfg = ssp_train.configs(vars(t_args))
    n_classes = ssp_train.N_CLASSES["s3dis"]
    train_names = SSP_ROOMS[1:]

    # ---- the main path; only its nn1 launches are counted
    nn1.launches = 0
    structures, rooms = {}, {}
    with recorded(provider, "read_s3dis_format") as reads:
        for name, path in paths.items():
            t0 = time.perf_counter()
            structures[name] = ssp_preprocess.preprocess_file(str(path),
                                                              p_args, dev)
            rooms[name] = {"preprocess_s": time.perf_counter() - t0}
    trainer = SspTrainer(model_cfg, loss_cfg, lr=t_args.lr,
                         grad_clip=t_args.grad_clip, seed=SEED, device=dev)
    rs = np.random.RandomState(SEED)
    steps, epochs = [], []

    def on_step(loss, comps, batch):
        steps.append({"loss": loss, "vertices": len(batch["xyz"]),
                      "components": len(comps),
                      "mean_component_size": len(batch["xyz"]) / len(comps),
                      "solve": dict(cutpursuit_band.LAST_SOLVE_STATS)})
        print(f"[ssp] step {len(steps)}: {json.dumps(steps[-1])}", flush=True)

    for epoch in range(2):
        t0 = time.perf_counter()
        entry = ssp_train.run_epoch(trainer, [structures[n] for n in train_names],
                                    loader_cfg, t_args.batch_size, rs, on_step)
        epochs.append({"epoch": epoch, **entry,
                       "seconds": time.perf_counter() - t0})
        print(f"[ssp] epoch {json.dumps(epochs[-1])}", flush=True)
    ev = ssp_train.evaluate_clouds(trainer, loss_cfg, loader_cfg,
                                   [structures[SSP_ROOMS[0]]], n_classes,
                                   t_args.BR_tolerance, dev)
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, trainer.state_dict(), 2, vars(t_args), None)
    g_trainer, g_loss, g_loader = ssp_generate.load_model(ckpt, "tpu", dev)
    spgs = {}
    for name in SSP_ROOMS:
        t0 = time.perf_counter()
        spgs[name] = ssp_generate.generate_cloud(
            g_trainer, g_loss, g_loader, structures[name], n_classes, dev)
        rooms[name]["generate_s"] = time.perf_counter() - t0
    launches = nn1.launches
    summary = aggregate_matrices([ev.matrices()])
    print("[ssp] ssp_evaluate (the test room, cvfold 1; random-init "
          "training on synthetic rooms, not a quality figure):\n"
          + ssp_evaluate.summary([("Area_1 (cv1)", ev.matrices())]),
          flush=True)
    print(f"[ssp] nn1 launches on the SSP path: {launches}", flush=True)
    if on_card and launches < 2 * len(SSP_ROOMS):
        raise AssertionError(f"nn1 launched {launches} times on the SSP path")

    for (name, s), ((xyz, _, labels, _), _) in zip(structures.items(), reads):
        low = np.flatnonzero(s["xyz"][:, 2] - s["xyz"][:, 2].min() < 0.5)
        plane = ransac_plane(s["xyz"][low, :2], s["xyz"][low, 2])
        rooms[name].update(
            voxels=len(s["xyz"]), edges=len(s["graph_nn"]["source"]),
            transitions=int(s["is_transition"].sum()),
            plane=[*map(float, plane.coef), float(plane.intercept)],
            superpoints=len(spgs[name][1]),
            reader_label_agreement=float((labels == want_labels[name]).mean()))
        print(f"[ssp] {name}: {json.dumps(rooms[name])}", flush=True)
        if rooms[name]["reader_label_agreement"] < 0.9999:
            raise AssertionError(f"{name}: read_s3dis_format labels disagree "
                                 "with the room")
    if len(reads) != len(SSP_ROOMS):
        raise AssertionError(f"{len(reads)} reader calls for "
                             f"{len(SSP_ROOMS)} rooms")
    checks = []
    if on_card:
        # nn1 at the test room's read shape against the plain version on
        # N_CHECK sampled queries
        path = paths[SSP_ROOMS[0]]
        ann = torch.as_tensor(np.concatenate([
            provider.read_rows(str(f))[:, :3]
            for f in sorted(path.parent.glob("Annotations/*.txt"))
        ]).astype(np.float32), device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        pick = torch.randint(0, len(ann), (N_CHECK,), device=dev, generator=g)
        checks.append(compare_nn1(torch.as_tensor(reads[0][0][0], device=dev),
                                  ann, f"SSP {SSP_ROOMS[0]} read shape",
                                  rows=pick)[0])
    for step in steps:
        if step["solve"]["cc_capped"]:
            raise AssertionError(f"an in-loop CC call stopped at its cap: "
                                 f"{step}")
    if not np.isfinite([e["loss"] for e in epochs]).all():
        raise AssertionError(f"an SSP loss is not finite: {epochs}")
    repeat = True
    for name in SSP_ROOMS:
        _, _, in_comp = ssp_generate.generate_partition(
            g_trainer, g_loss, g_loader, structures[name], dev)
        repeat &= np.array_equal(in_comp, spgs[name][2])
    print(f"[ssp] two ssp_generate runs give bit-equal partitions: {repeat}",
          flush=True)
    if not repeat:
        raise AssertionError("ssp_generate's partitions differ between runs")
    readable = {spg_readable(*spgs[n], tmp) for n in SSP_ROOMS}
    structure = structure_vs_cpu(reads[0][0], structures[SSP_ROOMS[0]], dev)

    # one fixed batch of the 4 training rooms, no augmentation
    fixed = dataclasses.replace(loader_cfg, pc_augm_rot=False,
                                pc_augm_jitter=False)
    rs_fixed = np.random.RandomState(SEED)
    batch = graph_collate([graph_loader(structures[n], True, fixed, rs_fixed)
                           for n in train_names])
    fresh = ssp_trainer_factory(model_cfg, loss_cfg, trainer.model.state_dict())
    # card against CPU: one step, the CPU given the card's loss weights
    w_t = fresh(dev)
    emb = w_t.embed_train(batch)
    weights, _, _ = w_t.host_weights(emb, batch)
    del w_t, emb
    check_cpu = card_vs_cpu(fresh, batch, bn_fed_biases(trainer.model),
                            "(ssp) one step, card vs CPU",
                            record=ssp_step_record(weights), device=dev)
    # why the CPU's side is float64: each float32 step, on the float64
    # step's branches, its largest gradient error from it over the
    # tensor's largest (the biases zero by construction and those before a
    # pool aside)
    step = ssp_step_record(weights)
    ref = fresh("cpu")
    with branches(ref.model) as on_f64:
        f64 = step(ref, batch)[1]
    aside = bn_fed_biases(trainer.model) | {
        f"{p}convs.{len(n.convs) - 2}.bias"
        for p, n in pooling_nets(trainer.model)}
    f32_vs_f64 = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        t32 = fresh(d, torch.float32)
        with branches(t32.model, follow=on_f64):
            g32 = step(t32, batch)[1]
        f32_vs_f64[side] = max(
            (float(np.abs(g32[k] - g).max() / np.abs(g).max()), k)
            for k, g in f64.items() if k not in aside and np.abs(g).max())
    print(f"[ssp] float32 steps on the CPU's float64 step's branches: "
          f"largest gradient error from it over its tensor's largest "
          f"{json.dumps(f32_vs_f64)}", flush=True)
    # the in-loop partition of the trained embedder's training-mode
    # embeddings: the device solver against the host exact one
    quality = inloop_vs_exact(fresh(dev), loss_cfg, batch, dev)

    # SSP_OVERFIT_STEPS steps on the fixed batch, each split by CUDA events
    # into embed / host weights (the in-loop solve timed apart on the host
    # clock) / loss + backward + Adam
    fit = fresh(dev)

    def stamp():
        if not on_card:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(a, b):
        return a.elapsed_time(b) if on_card else (b - a) * 1e3

    fit_losses, split = [], []
    with recorded(losses, "compute_partition") as solves:
        for _ in range(SSP_OVERFIT_STEPS):
            e0 = stamp()
            emb = fit.embed_train(batch)
            e1 = stamp()
            weights, _, _ = fit.host_weights(emb, batch)
            e2 = stamp()
            fit_losses.append(float(fit.loss_and_grads(emb, batch, weights)))
            fit.apply_grads()
            e3 = stamp()
            if on_card:
                torch.cuda.synchronize(dev)
            split.append([ms(e0, e1), ms(e1, e2), ms(e2, e3)])
    warm = np.array(split[3:])
    step_ms = {"embed": float(warm[:, 0].mean()),
               "host_weights": float(warm[:, 1].mean()),
               "of_which_solve": float(
                   np.mean([sec for _, sec in solves[3:]]) * 1e3),
               "loss_backward_adam": float(warm[:, 2].mean()),
               "total": float(warm.sum(1).mean()),
               "steps_timed": len(warm), "vertices": len(batch["xyz"]),
               "edges": len(batch["edg_source"])}
    ratio = fit_losses[-1] / fit_losses[0]
    print(f"[ssp] {SSP_OVERFIT_STEPS} steps on one batch: loss "
          f"{fit_losses[0]:.4f} -> {fit_losses[-1]:.4f} (x{ratio:.4f}); step "
          f"ms {json.dumps(step_ms)}", flush=True)
    if not (np.isfinite(fit_losses).all() and fit_losses[-1] < fit_losses[0]):
        raise AssertionError(f"{SSP_OVERFIT_STEPS} steps on one batch: loss "
                             f"x{ratio:.4f}")
    out = {
        "rooms": rooms, "write_s": write_s, "nn1_launches": launches,
        "epochs": epochs, "steps": steps, "evaluate_test_room": summary,
        "generate_repeat_equal": repeat, "spg_check": sorted(readable),
        "structure_vs_cpu": structure, "card_vs_cpu": check_cpu,
        "f32_vs_f64": f32_vs_f64,
        "inloop_quality": quality,
        "overfit": {"first": fit_losses[0], "last": fit_losses[-1],
                    "ratio": ratio},
        "step_ms": step_ms,
        "max_memory_allocated_gib": (
            torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None),
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"[ssp] phase {out['phase_s']:.1f} s, peak "
          f"{out['max_memory_allocated_gib']} GiB", flush=True)
    return launches, checks, out


# the custom-dataset recipe (docs/DATASETS.md:59-63): one synthetic room
# under data/train/ as a binary ply with labels 1..6, an ascii pcd with
# labels and a LAS 1.2 point format 3, another under data/test/ as an
# ascii ply without labels; --n_labels is custom_dataset's 13 classes
# (data/datasets.py::get_info), so the las and the test ply carry label
# histograms without a labelled point, which the loss ignores
CUSTOM_POINTS, CUSTOM_N_LABELS = 300_000, 13
CUSTOM_FILES = ("train/a.ply", "train/b.pcd", "train/c.las", "test/d.ply")


def _vertex(xyz, rgb, labels=None):
    out = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
           "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]}
    if labels is not None:
        out["label"] = labels
    return out


def spg_epoch(dev, dataset, root, entries, rows, train_names, test_names):
    """One training epoch of the flagship at full width and one test epoch
    on the SPG entries and parsed rows in memory, at the S3DIS recipe's
    flags for `dataset` (docs/DATASETS.md: the SPG stage "exactly as for
    S3DIS"); returns their numbers and raises unless both losses are
    finite."""
    from superpoint_graph_tpu_torch.cli import train as cli_train
    from superpoint_graph_tpu_torch.data.datasets import get_info
    from superpoint_graph_tpu_torch.data.spg_io import scaler01
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS

    trainlist, testlist, _, _ = scaler01(
        [entries[n] for n in train_names], [entries[n] for n in test_names])
    args = cli_train.parse_args(["--dataset", dataset, *TRAIN_RECIPE[2:]])
    dbinfo = get_info(dataset, str(root), EDGE_ATTRIBS, args.pc_attribs)
    _, trainer, loader_cfg, n_ch = cli_train.build(args, dbinfo, dev)
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    loss, cm, info = cli_train.run_epoch(
        trainer, trainlist, train_names, rows.__getitem__, loader_cfg, n_ch,
        dbinfo, True, rng, args.batch_size)
    te_loss, _, te_info = cli_train.run_epoch(
        trainer, testlist, test_names, rows.__getitem__, loader_cfg, n_ch,
        dbinfo, False, rng, 1)
    out = {"loss": loss, "acc": 100 * cm.get_overall_accuracy(),
           "test_loss": te_loss, "seconds": time.perf_counter() - t0,
           "train": info, "test": te_info}
    if not np.isfinite([loss, te_loss]).all():
        raise AssertionError(f"a {dataset} training loss is not finite: {out}")
    return out


def custom_phase(dev, tmp, points=CUSTOM_POINTS):
    """The custom-dataset recipe on `dev` (tools/torch_datasets_phase_cpu.py
    runs it on the CPU with smaller rooms): each file written and read
    back (the arrays written, xyz within the format's precision), the
    partition CLI's per-file function on each, the ply's partition against
    partition_cloud on the same arrays (bit for bit), parsed rows in memory
    and one training epoch of the flagship on the split. Returns the
    phase's numbers."""
    from superpoint_graph_tpu_torch.cli import partition as cli_partition
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.data.synthetic import (synthetic_room,
                                                           write_las)
    from superpoint_graph_tpu_torch.learn.train_check import training_rooms
    from superpoint_graph_tpu_torch.pipeline import partition_cloud
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS
    from superpoint_graph_tpu_torch.utils import plyio

    t_phase = time.perf_counter()
    root = Path(tmp)
    for split in ("train", "test"):
        (root / "data" / split).mkdir(parents=True)
    path = {f: root / "data" / f for f in CUSTOM_FILES}
    xyz, rgb, lab, _ = synthetic_room(np.random.RandomState(SEED + 40), points)
    labels = (lab + 1).astype(np.uint8)
    t_xyz, t_rgb, _, _ = synthetic_room(np.random.RandomState(SEED + 41),
                                        points)
    writers = {
        "train/a.ply": lambda p: plyio.write_ply(
            p, _vertex(xyz, rgb, labels), text=False),
        "train/b.pcd": lambda p: provider.write_pcd(p, xyz, labels),
        "train/c.las": lambda p: write_las(p, xyz, (1, 2), 3, rgb=rgb),
        "test/d.ply": lambda p: plyio.write_ply(p, _vertex(t_xyz, t_rgb)),
    }
    files, held = {}, {}
    for f, write in writers.items():
        t0 = time.perf_counter()
        held[f] = write(str(path[f]))
        files[f] = {"write_s": time.perf_counter() - t0,
                    "bytes": path[f].stat().st_size}
    readers = {
        "train/a.ply": provider.read_ply, "train/b.pcd": provider.read_pcd,
        "train/c.las": provider.read_las, "test/d.ply": provider.read_ply}
    back = {}
    for f, read in readers.items():
        t0 = time.perf_counter()
        back[f] = read(str(path[f]))
        files[f]["read_s"] = time.perf_counter() - t0
    text_close = lambda a, b: np.allclose(a, b, rtol=1e-5, atol=1e-6)  # noqa: E731
    read_ok = {
        "train/a.ply": (np.array_equal(back["train/a.ply"][0], xyz)
                        and np.array_equal(back["train/a.ply"][1], rgb)
                        and np.array_equal(back["train/a.ply"][2], labels)),
        "train/b.pcd": (text_close(back["train/b.pcd"][0], xyz)
                        and np.array_equal(back["train/b.pcd"][1], labels)),
        "train/c.las": (float(np.abs(held["train/c.las"] - xyz).max()) <= 5e-4
                        and np.allclose(back["train/c.las"],
                                        held["train/c.las"], rtol=0,
                                        atol=1e-6)),
        "test/d.ply": (text_close(back["test/d.ply"][0], t_xyz)
                       and np.array_equal(back["test/d.ply"][1], t_rgb)
                       and back["test/d.ply"][2].size == 0),
    }
    print(f"[custom] readers give the arrays written: {json.dumps(read_ok)}",
          flush=True)
    if not all(read_ok.values()):
        raise AssertionError(f"a custom-dataset reader disagrees: {read_ok}")

    # ---- the main path: the partition CLI's per-file function
    args = cli_partition.parse_args([
        "--ROOT_PATH", str(root), "--dataset", "custom_dataset",
        "--n_labels", str(CUSTOM_N_LABELS)])
    parts = {}
    for f in CUSTOM_FILES:
        t0 = time.perf_counter()
        p = parts[f.rsplit(".", 1)[0]] = cli_partition.partition_file(
            str(path[f]), args, dev)
        files[f].update(partition_file_s=time.perf_counter() - t0,
                        voxels=len(p.xyz), superpoints=len(p.components),
                        superedges=int(len(p.graph_sp["source"])))
    direct = partition_cloud(xyz, rgb, labels, None, CUSTOM_N_LABELS,
                             cli_partition.partition_config(args), device=dev)
    ply = parts["train/a"]
    same = (np.array_equal(ply.xyz, direct.xyz)
            and np.array_equal(ply.labels, direct.labels)
            and np.array_equal(ply.in_component, direct.in_component)
            and all(np.array_equal(np.asarray(ply.graph_sp[k]),
                                   np.asarray(direct.graph_sp[k]))
                    for k in direct.graph_sp))
    print(f"[custom] partition_file of the ply equal bit for bit to "
          f"partition_cloud on its arrays: {same}", flush=True)
    if not same:
        raise AssertionError("partition_file of the ply differs from "
                             "partition_cloud")
    entries, rows = training_rooms(parts, EDGE_ATTRIBS, "custom_dataset")
    epoch = spg_epoch(dev, "custom_dataset", root, entries, rows,
                      ["train/a", "train/b", "train/c"], ["test/d"])
    out = {"files": files, "epoch": epoch,
           "phase_s": time.perf_counter() - t_phase}
    for f, v in files.items():
        print(f"[custom] {f}: {json.dumps(v)}", flush=True)
    print(f"[custom] epoch {json.dumps(epoch)}; phase {out['phase_s']:.1f} s",
          flush=True)
    return out


# the vKITTI3D recipe (docs/DATASETS.md:42-57): six synthetic street
# frames, one a fold 01..06, through ssp_preprocess (voxel 0.05), one
# ssp_train epoch at cvfold 1 (reg_strength 0.5, spatial_emb 0.2, CP_cutoff
# 25, the S3DIS phase's embedder widths: the CLI's defaults), ssp_generate
# and ssp_evaluate, then parsed rows in the vkitti style and one SPG
# training epoch on the learned graphs
VKITTI_FRAMES = tuple((f"0{i}", f"0001_{100 * i:05d}") for i in range(1, 7))
VKITTI_POINTS = tuple(300_000 + 20_000 * i for i in range(6))


def vkitti_phase(dev, tmp, points=VKITTI_POINTS):
    """The vKITTI3D recipe on `dev` (tools/torch_datasets_phase_cpu.py runs
    it on the CPU with smaller frames): returns the phase's numbers."""
    import torch

    from superpoint_graph_tpu_torch.cli import (ssp_evaluate, ssp_generate,
                                                ssp_preprocess, ssp_train)
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.data.parsed import (build_point_matrix,
                                                        parsed_entries)
    from superpoint_graph_tpu_torch.data.spg_io import spg_entry
    from superpoint_graph_tpu_torch.data.synthetic import write_vkitti_frame
    from superpoint_graph_tpu_torch.learn.checkpoint import save_checkpoint
    from superpoint_graph_tpu_torch.ops import cutpursuit_band
    from superpoint_graph_tpu_torch.room import EDGE_ATTRIBS
    from superpoint_graph_tpu_torch.ssp import losses
    from superpoint_graph_tpu_torch.ssp.embed import SspTrainer
    from superpoint_graph_tpu_torch.ssp.evaluate import aggregate_matrices
    from superpoint_graph_tpu_torch.ssp.graph_processing import (
        graph_collate, graph_loader)

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    root = Path(tmp)
    names = [f"{fold}/{name}" for fold, name in VKITTI_FRAMES]
    paths, raw_labels = {}, {}
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        paths[name] = root / "data" / f"{name}.npy"
        raw_labels[name] = write_vkitti_frame(
            paths[name], np.random.RandomState(SEED + 60 + i), points[i])
    write_s = time.perf_counter() - t0
    p_args = ssp_preprocess.parse_args(["--ROOT_PATH", str(root), "--dataset",
                                        "vkitti", "--voxel_width", "0.05"])
    t_args = ssp_train.parse_args([
        "--dataset", "vkitti", "--cvfold", "1", "--reg_strength", "0.5",
        "--spatial_emb", "0.2", "--CP_cutoff", "25", "--seed", str(SEED)])
    model_cfg, loss_cfg, loader_cfg = ssp_train.configs(vars(t_args))
    n_classes = ssp_train.N_CLASSES["vkitti"]
    test_name, train_names = names[0], names[1:]

    # ---- the main path
    structures, frames = {}, {}
    with recorded(provider, "read_vkitti_format") as reads:
        for name in names:
            t0 = time.perf_counter()
            structures[name] = ssp_preprocess.preprocess_file(
                str(paths[name]), p_args, dev)
            frames[name] = {"raw_points": len(raw_labels[name]),
                            "preprocess_s": time.perf_counter() - t0}
    trainer = SspTrainer(model_cfg, loss_cfg, lr=t_args.lr,
                         grad_clip=t_args.grad_clip, seed=SEED, device=dev)
    steps = []

    def on_step(loss, comps, batch):
        steps.append({"loss": loss, "vertices": len(batch["xyz"]),
                      "components": len(comps),
                      "solve": dict(cutpursuit_band.LAST_SOLVE_STATS)})
        print(f"[vkitti] step {len(steps)}: {json.dumps(steps[-1])}",
              flush=True)

    # each step split on the host clock, synchronised with the card: embed
    # / host weights (of which the in-loop solve) / the rest (loss,
    # backward, Adam)
    sync = dev if on_card else None
    t0 = time.perf_counter()
    with recorded(trainer, "train_step", sync) as whole, \
            recorded(trainer, "embed_train", sync) as embeds, \
            recorded(trainer, "host_weights", sync) as weights, \
            recorded(losses, "compute_partition", sync) as solves:
        epoch = ssp_train.run_epoch(
            trainer, [structures[n] for n in train_names], loader_cfg,
            t_args.batch_size, np.random.RandomState(SEED), on_step)
    epoch["seconds"] = time.perf_counter() - t0
    epoch["step_split_s"] = [
        {"total": a[1], "embed": b[1], "host_weights": c[1],
         "of_which_solve": d[1], "loss_backward_adam": a[1] - b[1] - c[1]}
        for a, b, c, d in zip(whole, embeds, weights, solves)]
    ev = ssp_train.evaluate_clouds(trainer, loss_cfg, loader_cfg,
                                   [structures[test_name]], n_classes,
                                   t_args.BR_tolerance, dev)
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, trainer.state_dict(), 1, vars(t_args), None)
    g_trainer, g_loss, g_loader = ssp_generate.load_model(ckpt, "tpu", dev)
    spgs = {}
    for name in names:
        t0 = time.perf_counter()
        spgs[name] = ssp_generate.generate_cloud(
            g_trainer, g_loss, g_loader, structures[name], n_classes, dev)
        frames[name]["generate_s"] = time.perf_counter() - t0
    summary = aggregate_matrices([ev.matrices()])
    print("[vkitti] ssp_evaluate (the test frame, cvfold 1; one epoch from "
          "random init on synthetic frames, not a quality figure):\n"
          + ssp_evaluate.summary([("01 (cv1)", ev.matrices())]), flush=True)

    # ---- checks
    if len(reads) != len(names):
        raise AssertionError(f"{len(reads)} reader calls for {len(names)} "
                             "frames")
    for name, ((_, _, labels), _) in zip(names, reads):
        raw = raw_labels[name]
        s = structures[name]
        frames[name].update(
            voxels=len(s["xyz"]), edges=len(s["graph_nn"]["source"]),
            transitions=int(s["is_transition"].sum()),
            transition_share=float(s["is_transition"].mean()),
            superpoints=len(spgs[name][1]),
            reader_labels_equal=bool(np.array_equal(
                labels, np.where(raw == 13, 0, raw + 1))))
        print(f"[vkitti] {name}: {json.dumps(frames[name])}", flush=True)
        if not frames[name]["reader_labels_equal"]:
            raise AssertionError(f"{name}: read_vkitti_format labels differ "
                                 "from the generator's after the remap")
    if not np.isfinite(epoch["loss"]) or not steps:
        raise AssertionError(f"the vKITTI SSP epoch: {epoch}")
    for step in steps:
        if step["solve"]["cc_capped"]:
            raise AssertionError(f"an in-loop CC call stopped at its cap: "
                                 f"{step}")
    repeat = True
    for name in names:
        _, _, in_comp = ssp_generate.generate_partition(
            g_trainer, g_loss, g_loader, structures[name], dev)
        repeat &= np.array_equal(in_comp, spgs[name][2])
    print(f"[vkitti] two ssp_generate runs give bit-equal partitions: "
          f"{repeat}", flush=True)
    if not repeat:
        raise AssertionError("ssp_generate's vKITTI partitions differ "
                             "between runs")
    structure = structure_vs_cpu(reads[0][0], structures[test_name], dev,
                                 dataset="vkitti", voxel=0.05, tag="vkitti")
    fixed = dataclasses.replace(loader_cfg, pc_augm_rot=False,
                                pc_augm_jitter=False)
    rs_fixed = np.random.RandomState(SEED)
    batch = graph_collate([graph_loader(structures[n], True, fixed, rs_fixed)
                           for n in train_names[:t_args.batch_size]])
    quality = inloop_vs_exact(trainer, loss_cfg, batch, dev, tag="vkitti")

    # ---- the SPG stage on the learned graphs: parsed rows in the vkitti
    # style from the structures (preprocess_pointclouds(supervized=True))
    entries, rows = {}, {}
    for name in names:
        s, (graph_sp, comps, _) = structures[name], spgs[name]
        entries[name] = spg_entry(graph_sp, EDGE_ATTRIBS, name)
        rows[name] = parsed_entries(build_point_matrix(
            s["xyz"], s["rgb"], s["geof"], "vkitti",
            elevation=s["elevation"]), comps)
    spg = spg_epoch(dev, "vkitti", root, entries, rows, train_names,
                    [test_name])
    out = {"frames": frames, "write_s": write_s, "epoch": epoch,
           "steps": steps, "evaluate_test_frame": summary,
           "generate_repeat_equal": repeat, "structure_vs_cpu": structure,
           "inloop_quality": quality, "spg_epoch": spg,
           "max_memory_allocated_gib": (
               torch.cuda.max_memory_allocated(dev) / 2**30 if on_card
               else None),
           "phase_s": time.perf_counter() - t_phase}
    print(f"[vkitti] epoch {json.dumps(epoch)}", flush=True)
    print(f"[vkitti] SPG epoch {json.dumps(spg)}; phase {out['phase_s']:.1f} "
          f"s, peak {out['max_memory_allocated_gib']} GiB", flush=True)
    return out


def submission_phase(dev, tmp, scan, raw_path):
    """The Semantic3D submission writer's array function on the scan
    phase's partition and predictions: its `.labels` must equal, line for
    line, label_scan's class of every raw point. Returns (nn1 launches of
    the writer, its numbers: seconds, the nn1 calls' share by CUDA
    events)."""
    import torch

    from superpoint_graph_tpu_torch.cli.write_semantic3d import (
        write_submission)
    from superpoint_graph_tpu_torch.data import provider
    from superpoint_graph_tpu_torch.ops.nn1 import nn1
    from superpoint_graph_tpu_torch.scan import VER_BATCH

    on_card = dev.type == "cuda"
    events, orig = [], provider.nn1

    def stamp():
        if not on_card:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_nn1(db, q):
        start = stamp()
        idx = orig(db, q)
        events.append((start, stamp()))
        return idx

    out_path = Path(tmp) / "station1.labels.submission"
    provider.nn1 = timed_nn1
    try:
        if on_card:
            torch.cuda.synchronize(dev)
        nn1.launches = 0
        t0 = time.perf_counter()
        full = write_submission(str(out_path), str(raw_path),
                                scan.partition.xyz, scan.partition.components,
                                scan.logits.argmax(1), VER_BATCH, dev)
        seconds = time.perf_counter() - t0
        launches = nn1.launches
    finally:
        provider.nn1 = orig
    nn1_s = sum(a.elapsed_time(b) / 1e3 if on_card else b - a
                for a, b in events)
    want = ("\n".join(map(str, scan.labels.tolist())) + "\n").encode()
    same = (np.array_equal(full, scan.labels)
            and out_path.read_bytes() == want)
    out = {"seconds": seconds, "nn1_s": nn1_s, "nn1_share": nn1_s / seconds,
           "nn1_calls": len(events), "nn1_launches": launches,
           "raw_points": len(full), "bytes": out_path.stat().st_size,
           "labels_equal_label_scan": same}
    print(f"[submission] {json.dumps(out)}", flush=True)
    if not same or (on_card and launches < 2):
        raise AssertionError(f"the submission's labels differ from "
                             f"label_scan's, or nn1 did not run: {out}")
    return launches, out


def visualize_phase(tmp, r):
    """cli/visualize's writer on the room phase's result, every output
    type (igfprse): each ply read back with read_ply_elements equals the
    arrays the writers wrote (integers exactly, floats within the ascii
    format's "%.6g"). Returns its numbers."""
    from superpoint_graph_tpu_torch.cli.visualize import write_clouds
    from superpoint_graph_tpu_torch.utils import plyio

    part = r.partition
    written, orig = {}, plyio.write_ply_elements

    def keep(filename, elements, text=True):
        written[filename] = elements
        return orig(filename, elements, text)

    plyio.write_ply_elements = keep
    try:
        t0 = time.perf_counter()
        paths = write_clouds(str(Path(tmp) / "Area_1_room_0"), "igfprse",
                             "s3dis", part.xyz, part.rgb, part.labels,
                             part.geof, part.graph_sp, part.components,
                             r.logits.argmax(1))
        write_s = time.perf_counter() - t0
    finally:
        plyio.write_ply_elements = orig
    kinds, t0 = {}, time.perf_counter()
    for path in paths:
        got = plyio.read_ply_elements(path)
        ok = got.keys() == written[path].keys()
        for el, props in written[path].items():
            for k, want in props.items():
                want = np.asarray(want)
                a = got[el][k]
                ok &= a.dtype == want.dtype and (
                    np.allclose(a, want, rtol=1e-5, atol=0)
                    if want.dtype.kind == "f" else np.array_equal(a, want))
        kinds[Path(path).stem.rsplit("_", 1)[1]] = bool(ok)
    out = {"plys": kinds, "write_s": write_s,
           "read_s": time.perf_counter() - t0,
           "bytes": sum(Path(p).stat().st_size for p in paths),
           "points": len(part.xyz)}
    print(f"[visualize] {json.dumps(out)}", flush=True)
    if len(kinds) != 7 or not all(kinds.values()):
        raise AssertionError(f"a visualize ply does not read back: {out}")
    return out


# the parallel phase: the room's and the station's partitions with their
# tables over PARALLEL_SHARDS shards of the card, then data-parallel steps
# of the flagship in an NCCL group of one rank. The sharded room against
# the single-card solve of the same voxels, graph and pad rows: the share
# of voxels in a superpoint found by both at least, energy ratio within,
# component counts apart at most (the JAX package's bar for a sharded
# solve, tests/test_parallel.py:123-127; the energy within 0.1%)
PARALLEL_SHARDS = 4
SHARD_BOUNDS = {"same_component": 0.999, "energy_ratio": 1.001,
                "n_comp_diff": 2}
DP_STEPS = 20


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_room(dev, tmp, room, cfg, exact):
    """partition_cloud_sharded on PARALLEL_SHARDS shards of `dev`, twice,
    on the room read again (read_s3dis_format, its nn1 launches counted)
    and pruned. Checks against the single-device path on the same voxels:
    the kNN table equal to compute_graph_nn_2's (distances equal, indices
    but at exact ties), geof within 1e-5, the partition within
    SHARD_BOUNDS of the single-card solve and QUALITY_BOUNDS of `exact`
    (the quality phase's exact solve of the room), every label one
    connected piece, no capped CC call, the two runs bit-identical.
    Returns (nn1 launches of the read, numbers)."""
    import torch

    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.ops import cutpursuit_band as cb
    from superpoint_graph_tpu_torch.ops.knn import sqdist
    from superpoint_graph_tpu_torch.ops.nn1 import nn1
    from superpoint_graph_tpu_torch.ops.voxel import prune
    from superpoint_graph_tpu_torch.parallel import partition_shard as ps
    from superpoint_graph_tpu_torch.parallel.mesh import make_mesh
    from superpoint_graph_tpu_torch.pipeline import (
        assemble_partition_features, edge_weights, partition_features)

    raw_path, _, _ = write_s3dis_room(Path(tmp) / "Area_1" / "room_0",
                                      np.random.RandomState(SEED), N_POINTS)
    nn1.launches = 0
    xyz, rgb, labels, objects = read_s3dis_format(str(raw_path), device=dev)
    launches = nn1.launches
    vox, vrgb, vlab, _ = prune(xyz, cfg.voxel_width, rgb, labels, objects,
                               13, int(objects.max()) + 1, device=dev)
    if not np.array_equal(vox, room.xyz):
        raise AssertionError("the room's voxels differ from the room phase's")
    mesh = make_mesh(devices=[dev] * PARALLEL_SHARDS)
    runs = []
    for _ in range(2):
        with recorded(ps, "sharded_knn_geof", sync=dev) as knn_calls, \
                recorded(ps, "cutpursuit_band_sharded", sync=dev) as cp_calls:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = ps.partition_cloud_sharded(vox, vrgb, cfg, mesh)
            seconds = time.perf_counter() - t0
        runs.append({"out": out, "idx": knn_calls[0][0][2],
                     "seconds": {"total": seconds, "knn_geof": knn_calls[0][1],
                                 "cut_pursuit": cp_calls[0][1]},
                     "layout": copy.deepcopy(ps.LAST_SHARD_STATS),
                     "solve": dict(cb.LAST_SOLVE_STATS)})
    g_s, geof_s, comps_s, ic_s = runs[0]["out"]
    same_runs = (np.array_equal(ic_s, runs[1]["out"][3])
                 and np.array_equal(runs[0]["idx"], runs[1]["idx"])
                 and np.array_equal(geof_s, runs[1]["out"][1]))

    # the single-device path on the same voxels
    g_1, geof_1, tabs = partition_features(vox, cfg, device=dev,
                                           return_device=True)
    vox_t = torch.as_tensor(vox, device=dev)
    idx_s = torch.as_tensor(runs[0]["idx"], device=dev)
    d2_s = sqdist(vox_t[:, None, :], vox_t[idx_s])
    d2_equal = torch.equal(d2_s, tabs["d2"])
    idx_differ = int((idx_s != tabs["idx"]).sum())
    # a differing index must sit at a distance its row holds twice (a tie)
    rows, cols = torch.nonzero(idx_s != tabs["idx"], as_tuple=True)
    ties = bool(((tabs["d2"][rows] == tabs["d2"][rows, cols][:, None])
                 .sum(1) > 1).all()) if len(rows) else True
    same_set = (torch.sort(idx_s, 1).values
                == torch.sort(tabs["idx"], 1).values).all(1).cpu().numpy()
    geof_err = float(np.abs(geof_s - geof_1)[same_set].max())
    feats = assemble_partition_features(geof_s, vrgb, cfg)
    src = g_s["source"].astype(np.int64)
    tgt = g_s["target"].astype(np.int64)
    w = edge_weights(g_s["distances"], cfg.lambda_edge_weight)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    comps_1, ic_1 = cb.cutpursuit_band(feats, src, tgt, w, cfg.reg_strength,
                                       cutoff=cfg.cp_cutoff, xyz=vox,
                                       device=dev)
    single_s = time.perf_counter() - t0
    single_solve = dict(cb.LAST_SOLVE_STATS)
    own = types.SimpleNamespace(geof=geof_s, rgb=vrgb, graph_nn=g_s,
                                labels=vlab)
    q_s = partition_quality(own, cfg, ic_s, comps_s,
                            runs[0]["seconds"]["cut_pursuit"])
    q_1 = partition_quality(own, cfg, ic_1, comps_1, single_s)
    on_room = partition_quality(room, cfg, ic_s, comps_s, 0.0)
    cmp = {"same_component": same_component_share(ic_s, ic_1),
           "energy_ratio": q_s["energy"] / q_1["energy"],
           "n_comp_diff": abs(q_s["n_comp"] - q_1["n_comp"]),
           "vs_exact": {"energy_ratio": on_room["energy"] / exact["energy"],
                        "n_comp_ratio": on_room["n_comp"] / exact["n_comp"],
                        "ooa_drop": exact["OOA"] - on_room["OOA"]}}
    out = {"voxels": len(vox), "nn1_launches": launches,
           "knn": {"d2_equal": d2_equal, "indices_differ": idx_differ,
                   "differ_at_ties": ties,
                   "rows_same_set": float(same_set.mean()),
                   "geof_max_abs_same_set": geof_err,
                   "geof_max_abs": float(np.abs(geof_s - geof_1).max())},
           "sharded": q_s, "single_card": q_1, "compare": cmp,
           "runs_bit_identical": same_runs,
           "seconds": [r_["seconds"] for r_ in runs],
           "layout": runs[0]["layout"], "solve": runs[0]["solve"],
           "single_card_solve": single_solve}
    print(f"[parallel] room on {PARALLEL_SHARDS} shards: {json.dumps(out)}; "
          f"bounds {json.dumps(SHARD_BOUNDS)}, {json.dumps(QUALITY_BOUNDS)}",
          flush=True)
    lo, hi = QUALITY_BOUNDS["n_comp_ratio"]
    vs = cmp["vs_exact"]
    if not (d2_equal and ties and geof_err <= 1e-5 and same_runs
            and cmp["same_component"] >= SHARD_BOUNDS["same_component"]
            and abs(cmp["energy_ratio"] - 1) <= SHARD_BOUNDS["energy_ratio"] - 1
            and cmp["n_comp_diff"] <= SHARD_BOUNDS["n_comp_diff"]
            and vs["energy_ratio"] <= QUALITY_BOUNDS["energy_ratio"]
            and lo <= vs["n_comp_ratio"] <= hi
            and vs["ooa_drop"] <= QUALITY_BOUNDS["ooa_drop"]
            and q_s["disconnected_labels"] == 0
            and runs[0]["solve"]["cc_capped"] == 0):
        raise AssertionError(f"the sharded room is outside its bounds: {out}")
    if dev.type == "cuda" and launches < 2:
        raise AssertionError(f"nn1 launched {launches} times on the read")
    return launches, out


def sharded_station(dev, scan_part, cfg):
    """partition_big_sharded on PARALLEL_SHARDS shards of `dev` on the scan
    phase's voxels, against that phase's partition_cloud_big result on its
    features and graph: energy within SCAN_BOUNDS, every label one
    connected piece, no capped CC call. Returns the numbers."""
    import torch

    from superpoint_graph_tpu_torch.parallel import partition_big_shard as pbs
    from superpoint_graph_tpu_torch.parallel import partition_shard as ps
    from superpoint_graph_tpu_torch.parallel.mesh import make_mesh
    from superpoint_graph_tpu_torch.pipeline_big import CHUNK_POINTS

    mesh = make_mesh(devices=[dev] * PARALLEL_SHARDS)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, comps, ic = pbs.partition_big_sharded(
        scan_part.xyz, scan_part.rgb, cfg, mesh, chunk_points=CHUNK_POINTS)
    seconds = time.perf_counter() - t0
    stats = dict(pbs.LAST_SHARDED_CP_STATS)
    sharded = partition_quality(scan_part, cfg, ic, comps, seconds)
    path = partition_quality(scan_part, cfg, scan_part.in_component,
                             scan_part.components, 0.0)
    out = {"voxels": len(scan_part.xyz), "seconds": seconds,
           "sharded": sharded, "single_card": path,
           "energy_ratio": sharded["energy"] / path["energy"],
           "ooa_drop": path["OOA"] - sharded["OOA"],
           "cut_pursuit": stats, "knn_layout": ps.LAST_SHARD_STATS["knn"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[parallel] station on {PARALLEL_SHARDS} shards: "
          f"{json.dumps(out)}; bounds {json.dumps(SCAN_BOUNDS)}", flush=True)
    if not (out["energy_ratio"] <= SCAN_BOUNDS["energy_ratio"]
            and out["ooa_drop"] <= SCAN_BOUNDS["ooa_drop"]
            and sharded["disconnected_labels"] == 0
            and stats["cc_capped"] == 0):
        raise AssertionError(f"the sharded station is outside its bounds: "
                             f"{out}")
    return out


def dp_steps(dev, ctx):
    """The flagship's data-parallel step (parallel/dp.py) in an NCCL group
    of one rank on `dev`, joined by multihost.initialize at an explicit
    address: DP_STEPS steps against Trainer.train_step from the same
    weights and generator seed, losses, parameters and running statistics
    bit for bit (deterministic kernels on both); the dp eval step equal to
    eval_step; global_edge_scaler of the training entries within 1e-5 of
    their float64 fit (the mean by its scale; its distance from
    EdgeFeatScaler.fit printed). Then both steps' steps/s (CUDA events)
    and the all-reduce's share of a step. Returns the numbers."""
    import warnings

    import torch
    import torch.distributed as dist

    from superpoint_graph_tpu_torch.data.spg_io import EdgeFeatScaler
    from superpoint_graph_tpu_torch.parallel import multihost
    from superpoint_graph_tpu_torch.parallel.dp import (allreduce_mean,
                                                        make_dp_eval_step,
                                                        make_dp_train_step,
                                                        running_stats)

    fresh, batches = ctx["fresh"], ctx["batches"]
    address = f"tcp://127.0.0.1:{free_port()}"
    # one host: NCCL's bootstrap on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    multihost.initialize(address, 1, 0, device=dev)
    try:
        a, b = fresh(dev), fresh(dev)
        step = make_dp_train_step(a)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pairs = [(step(bt)[0], b.train_step(bt)[0]) for bt in
                         (batches[i % len(batches)] for i in range(DP_STEPS))]
                ev = (make_dp_eval_step(a)(batches[0]),
                      a.eval_step(batches[0]))
        finally:
            torch.use_deterministic_algorithms(False)
        equal = {
            "losses": all(torch.equal(x, y) for x, y in pairs),
            "parameters": all(torch.equal(p, q) for p, q in
                              zip(a.model.parameters(),
                                  b.model.parameters())),
            "running_stats": all(torch.equal(p, q) for p, q in
                                 zip(running_stats(a.model),
                                     running_stats(b.model))),
            "eval": (torch.equal(ev[0][0], ev[1][0])
                     and torch.equal(ev[0][1], ev[1][1]))}
        # the scaler of the union: the moments' against a float64 fit (the
        # reference's StandardScaler accumulates in float64), and its
        # distance from EdgeFeatScaler.fit, whose float32 column sums
        # numpy adds row by row
        feats = np.concatenate([e[3] for e in ctx["train_entries"]])
        s_g = multihost.global_edge_scaler(ctx["train_entries"])
        s_f = EdgeFeatScaler().fit(ctx["train_entries"])
        mean64 = feats.astype(np.float64).mean(0)
        std64 = feats.astype(np.float64).std(0)
        scale64 = np.where(std64 == 0, 1.0, std64)
        scaler = {
            "rows": len(feats),
            "vs_f64": {"mean_by_scale": float(np.max(np.abs(
                s_g.mean - mean64) / scale64)), "scale_rel": float(np.max(
                    np.abs(s_g.scale / scale64 - 1)))},
            "vs_fit": {"mean_by_scale": float(np.max(np.abs(
                s_g.mean - s_f.mean) / s_f.scale)), "scale_rel": float(
                    np.max(np.abs(s_g.scale / s_f.scale - 1)))},
            "fit_vs_f64": {"mean_by_scale": float(np.max(np.abs(
                s_f.mean - mean64) / scale64)), "scale_rel": float(np.max(
                    np.abs(s_f.scale / scale64 - 1)))}}
        scaler_ok = max(scaler["vs_f64"].values()) <= 1e-5

        def steps(fn):
            for i in range(WARM_STEPS):
                fn(batches[i % len(batches)])
            return timed(lambda: [fn(batches[i % len(batches)])
                                  for i in range(TIMED_STEPS)])[1] / TIMED_STEPS

        dp_ms = steps(make_dp_train_step(fresh(dev)))
        plain_ms = steps(fresh(dev).train_step)
        grads = [p.grad for p in a.params]
        tensors = [torch.zeros((), device=dev)] + grads + running_stats(
            a.model)
        reduce_ms = cuda_ms(lambda: allreduce_mean(tensors), TIMED_STEPS)
    finally:
        dist.destroy_process_group()
    out = {"address": address, "world_size": 1, "steps": DP_STEPS,
           "bit_equal": equal, "scaler": scaler,
           "dp_steps_per_s": 1e3 / dp_ms, "train_steps_per_s": 1e3 / plain_ms,
           "dp_step_ms": dp_ms, "train_step_ms": plain_ms,
           "allreduce_ms": reduce_ms, "allreduce_share": reduce_ms / dp_ms,
           "allreduce_numel": int(sum(t.numel() for t in tensors))}
    print(f"[parallel] data parallel, NCCL world 1: {json.dumps(out)}",
          flush=True)
    if not (all(equal.values()) and scaler_ok):
        raise AssertionError(f"the dp step differs from train_step: {out}")
    return out


def parallel_phase(dev, tmp, room, cfg, exact, scan_part, scan_cfg, ctx):
    """Phase 16: the sharded room, the sharded station and data-parallel
    training (the functions above). Returns (nn1 launches of the room's
    read, the phase's numbers)."""
    t0 = time.perf_counter()
    launches, room_out = sharded_room(dev, tmp, room, cfg, exact)
    station = sharded_station(dev, scan_part, scan_cfg)
    dp = dp_steps(dev, ctx)
    out = {"shards": PARALLEL_SHARDS, "room": room_out, "station": station,
           "dp": dp, "phase_s": time.perf_counter() - t0}
    print(f"[parallel] phase_s: {out['phase_s']}", flush=True)
    return launches, out


# phase 17: the JAX package's Semantic3D chain at its own scale
# (tools/torch_semantic3d_headline.py at its defaults: 1e8 raw points,
# chunks of 5e6 rows, 0.1 m, k 45/10, reg 0.8)
HEADLINE_TOOL = ROOT / "tools" / "torch_semantic3d_headline.py"


def headline_phase(dev, scan_part):
    """The 1e8-point Semantic3D chain on the card, cold then warm
    (`run_chain`), with checks (a)-(f) of chip_smoke.py's docstring;
    `scan_part` is the scan phase's partition, for (e). Returns the numbers
    printed, for the JSON line."""
    import torch

    from superpoint_graph_tpu_torch import native
    from superpoint_graph_tpu_torch.data.synthetic import station_chunk
    from superpoint_graph_tpu_torch.learn.metrics import disconnected_labels
    from superpoint_graph_tpu_torch.ops import voxel
    from superpoint_graph_tpu_torch.ops.components import (
        relabel_connected, relabel_connected_plain)
    from superpoint_graph_tpu_torch.ops.cutpursuit import greedy_matching_plain
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud

    spec = importlib.util.spec_from_file_location("torch_semantic3d_headline",
                                                  HEADLINE_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t_phase = time.perf_counter()
    calls0 = {k: getattr(native, k).calls
              for k in ("prune", "connected_comp", "greedy_matching")}
    # the matchings of the runs' merge rounds, for (f): the wrapper keeps
    # each call's inputs and calls the library
    matched = []
    library_matching = native.greedy_matching

    def recording(a, b, n_comp):
        matched.append((np.asarray(a), np.asarray(b), int(n_comp)))
        return library_matching(a, b, n_comp)

    native.greedy_matching = recording
    try:
        split, extra = tool.run_chain(warm_repeat=True, device=dev)
    finally:
        native.greedy_matching = library_matching
    calls = {k: getattr(native, k).calls - v for k, v in calls0.items()}
    cold, warm = extra["results"]
    xyz = extra["xyz"]
    n = len(xyz)
    show = {k: v for k, v in split.items() if not k.startswith("times")}
    print(f"[headline] {json.dumps(show)}")
    for name in ("cold", "warm"):
        times = split[f"times_{name}"]
        print(f"[headline] {name} stages: " + json.dumps(
            {k: v for k, v in times.items() if k != "cp_info"}))
        print(f"[headline] {name} chunked cut pursuit: "
              f"{json.dumps(times['cp_info'])}")
    print(f"[headline] host library calls of the chain: {json.dumps(calls)}",
          flush=True)
    checks = {}
    # (a) cold and warm partitions bit-identical
    checks["a_cold_warm_identical"] = bool(
        np.array_equal(cold.in_component, warm.in_component)
        and all(np.array_equal(np.asarray(cold.graph_sp[k]),
                               np.asarray(warm.graph_sp[k]))
                for k in cold.graph_sp))
    # (c) the kNN table against a direct-form brute force, then (b) every
    # label connected in the kNN adjacency, no capped CC call
    cfg = dict(k_geof=45, k_adj=10)
    x_dev = torch.as_tensor(xyz, device=dev)
    t0 = time.perf_counter()
    bi, bd2, _ = knn_bigcloud(x_dev, cfg["k_geof"])
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randperm(n, device=dev, generator=g)[:N_CHECK]
    want_i, want_d = brute_knn_rows(x_dev, rows, cfg["k_geof"])
    checks["c_knn_equal_to_brute_force"] = bool(
        torch.equal(bi[rows], want_i) and torch.equal(bd2[rows], want_d))
    knn_s = time.perf_counter() - t0
    tgt = bi[:, :cfg["k_adj"]].reshape(-1).cpu().numpy().astype(np.int64)
    del bi, bd2, want_i, want_d
    src = np.repeat(np.arange(n, dtype=np.int64), cfg["k_adj"])
    t0 = time.perf_counter()
    n_disc = disconnected_labels(cold.in_component, src, tgt)
    checks["b_connected_uncapped"] = bool(
        n_disc == 0 and cold.times["cp_info"]["cc_capped"] == 0)
    disc_s = time.perf_counter() - t0
    del src, tgt
    # the device prune of the global re-prune's rows, beside the library's
    rows_ac = extra["rows_after_chunks"]
    dev_prune = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = voxel.voxel_prune(
            torch.as_tensor(rows_ac, device=dev), split["voxel_width"],
            torch.zeros((len(rows_ac), 3), dtype=torch.uint8, device=dev),
            None, None, 0, 0)
        dev_xyz = out["xyz"].cpu().numpy()
        dev_prune.append(time.perf_counter() - t0)
        del out
    prune_cmp = {
        "rows": len(rows_ac), "native_s": split["global_prune_seconds"],
        "device_s": dev_prune, "device_voxels": len(dev_xyz),
        "device_equal_to_native": bool(np.array_equal(dev_xyz, xyz)),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del dev_xyz, rows_ac
    # (d) the library's prune against prune_plain on the first chunk
    chunk = station_chunk(np.random.default_rng(0), tool.VER_BATCH)
    t0 = time.perf_counter()
    got = native.prune(chunk, split["voxel_width"], None, None, None, 0, 0)
    t1 = time.perf_counter()
    want = voxel.prune_plain(chunk, split["voxel_width"], None, None, None,
                             0, 0)
    t2 = time.perf_counter()
    ulp = np.abs(got[0].view(np.int32).astype(np.int64)
                 - want[0].view(np.int32).astype(np.int64))
    checks["d_prune_equal_to_plain"] = bool(
        len(got[0]) == len(want[0]) and ulp.max() <= 4
        and all(np.array_equal(a, b) for a, b in zip(got[1:], want[1:])))
    prune_chunk = {"rows": len(chunk), "voxels": len(got[0]),
                   "max_ulp": int(ulp.max()), "native_s": t1 - t0,
                   "plain_s": t2 - t1}
    # (e) the library's relabel_connected against the plain one on the scan
    # phase's station, cutoff 0
    s_src = scan_part.graph_nn["source"].astype(np.int64)
    s_tgt = scan_part.graph_nn["target"].astype(np.int64)
    s_n = len(scan_part.xyz)
    t0 = time.perf_counter()
    _, ic_lib = relabel_connected(s_n, s_src, s_tgt, scan_part.in_component)
    t1 = time.perf_counter()
    _, ic_plain = relabel_connected_plain(s_n, s_src, s_tgt,
                                          scan_part.in_component)
    t2 = time.perf_counter()
    checks["e_relabel_equal_to_plain"] = bool(np.array_equal(ic_lib,
                                                             ic_plain))
    relabel = {"voxels": s_n, "edges": len(s_src), "native_s": t1 - t0,
               "plain_s": t2 - t1}
    # (f) the library's greedy matching against the plain one on the heal's
    # own candidates (the merge rounds over the whole cloud's regions)
    heal_in = cold.times["cp_info"]["heal_regions_in"]
    heal = [m for m in matched if m[2] == heal_in]
    checks["f_heal_matching_equal_to_plain"] = bool(heal) and all(
        np.array_equal(library_matching(a, b, c), greedy_matching_plain(a, b, c))
        for a, b, c in heal)
    a, b, c = max(heal, key=lambda m: len(m[0])) if heal else ((), (), 0)
    t0 = time.perf_counter()
    library_matching(a, b, c)
    t1 = time.perf_counter()
    greedy_matching_plain(np.asarray(a), np.asarray(b), c)
    matching = {"heal_calls": len(heal), "candidates": len(a),
                "native_s": t1 - t0, "plain_s": time.perf_counter() - t1}
    out = {"split": show, "checks": checks, "knn_check_s": knn_s,
           "disconnected_check_s": disc_s, "device_prune": prune_cmp,
           "prune_chunk": prune_chunk, "relabel": relabel,
           "matching": matching, "library_calls": calls,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[headline] device prune of the global re-prune's rows: "
          f"{json.dumps(prune_cmp)}")
    print(f"[headline] host library against plain: prune {json.dumps(prune_chunk)}"
          f", relabel_connected {json.dumps(relabel)}, greedy matching "
          f"{json.dumps(matching)}")
    print(f"[headline] checks {json.dumps(checks)}; kNN check {knn_s:.1f} s, "
          f"connectivity check {disc_s:.1f} s; phase {out['phase_s']:.1f} s",
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the Semantic3D chain failed a check: {checks}")
    if min(calls.values()) == 0:
        raise AssertionError(f"the chain skipped the host library: {calls}")
    return out


def main() -> int:
    if not (ROOT / "superpoint_graph_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from superpoint_graph_tpu_torch.data.provider import read_s3dis_format
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.device import cuda_device
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from superpoint_graph_tpu_torch.ops import _build, cutpursuit_band
    from superpoint_graph_tpu_torch.ops.nn1 import nn1, nn1_cuda, nn1_plan
    from superpoint_graph_tpu_torch.ops.nn1_cases import nn1_cases
    from superpoint_graph_tpu_torch.pipeline import PartitionConfig
    from superpoint_graph_tpu_torch.room import label_room
    from superpoint_graph_tpu_torch.scan import SEMA3D_CONFIG

    dev = cuda_device(0)
    # ---- 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"[header] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"[header] nvcc: {nvcc.splitlines()[-1]}")
    print(f"[header] nvidia-smi: {smi}")
    print("[header] optional packages: " + ", ".join(
        f"{m}={'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("h5py", "pandas", "sklearn")), flush=True)

    # ---- 2. build: the kernel, and the host library (g++)
    lib, build_s, ptxas = _build.build("nn1")
    print(f"[build] nn1: {lib.relative_to(ROOT)} in {build_s:.2f} s")
    host_lib, host_s = _build.build_host("spgt_native")
    print(f"[build] host library: {host_lib.relative_to(ROOT)} in "
          f"{host_s:.2f} s ({_build.gxx_path()})")
    for line in ptxas.splitlines():
        print(f"[build] ptxas: {line}")
    sys.stdout.flush()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw_path, want_labels, n_objects = write_s3dis_room(
            Path(tmp) / "Area_1" / "room_0", np.random.RandomState(SEED),
            N_POINTS)
        print(f"[data] wrote {N_POINTS} raw points, {n_objects} annotation "
              f"objects in {time.perf_counter() - t0:.2f} s", flush=True)

        # ---- 3. quick kernel check before the slice: the room's points as
        # db, a query subset of exact copies and of perturbed points
        from superpoint_graph_tpu_torch.data.provider import read_rows

        room_xyz = read_rows(str(raw_path))[:, :3].astype(np.float32)
        ann_xyz = np.concatenate([
            read_rows(str(f))[:, :3]
            for f in sorted(raw_path.parent.glob("Annotations/*.txt"))
        ]).astype(np.float32)
        room = torch.as_tensor(room_xyz, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        pick = torch.randint(0, len(room), (N_CHECK,), device=dev, generator=g)
        q_sub = room[pick].clone()
        q_sub[N_CHECK // 2:] += 0.01 * torch.randn(
            (N_CHECK - N_CHECK // 2, 3), device=dev, generator=g)
        check_sub, _ = compare_nn1(room, q_sub, "query subset")

        # ---- 4. adversarial nn1 check, exact indices at every size
        checks = [check_sub]
        for n_db, n_q in ADVERSARIAL_SIZES:
            cases = nn1_cases(SEED, n_db, n_q)
            for name, (a_db, a_q) in cases.items():
                a_db = torch.as_tensor(a_db, device=dev)
                a_q = torch.as_tensor(a_q, device=dev)
                splits, _, _ = nn1_plan(len(a_q), len(a_db))
                checks.append(compare_nn1(
                    a_db, a_q, f"adversarial {name} ({splits} splits)")[0])

        # ---- 5. the slice, default config; only its own nn1 launches are
        # counted
        model = SpgModel(13, **FLAGSHIP)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
        model = model.to(dev).eval()
        cfg = PartitionConfig(spg_adjacency="knn")
        nn1.launches = 0
        t0 = time.perf_counter()
        r = label_room(str(raw_path), model, dev, cfg=cfg)
        total = time.perf_counter() - t0
        launches = nn1.launches
        solve_stats = dict(cutpursuit_band.LAST_SOLVE_STATS)
        raw = read_s3dis_format(str(raw_path), device=dev)  # for phase 8
    print(f"[slice] counts {json.dumps(r.counts)}")
    for k, v in r.times.items():
        print(f"[slice] {k}: {v:.3f} s")
    print(f"[slice] device cut pursuit: {json.dumps(solve_stats)}")
    print(f"[slice] total {total:.3f} s; nn1 launches {launches}", flush=True)
    if "partition_cloud.partition.solve" not in r.times:
        raise AssertionError("the room did not go through the device solver")

    # ---- 6. checks of the slice's output
    n_sp = r.counts["superpoints"]
    if launches < 2:
        raise AssertionError(f"nn1 launched {launches} times on the main path")
    if r.logits.shape != (n_sp, 13) or not np.isfinite(r.logits).all():
        raise AssertionError(f"logits {r.logits.shape} not finite [n_sp, 13]")
    if r.labels.shape != (N_POINTS,) or not 0 <= r.labels.min() <= r.labels.max() <= 12:
        raise AssertionError("raw-point labels out of shape or range")
    read_agree = float((r.raw_labels == want_labels).mean())
    print(f"[check] reader labels equal to the generator's: {read_agree:.6f}")
    if read_agree < 0.9999:
        raise AssertionError("read_s3dis_format labels disagree with the room")
    # the kernel against its plain version at the main path's two full
    # shapes, on the inputs the path gave it: the room against its
    # annotation points (reader), the voxels against the raw points (spread)
    ann = torch.as_tensor(ann_xyz, device=dev)
    check_read, _ = compare_nn1(room, ann, "read shape")
    vox = torch.as_tensor(r.partition.xyz, device=dev)
    check_up, plain_idx = compare_nn1(vox, room, "interpolate shape")
    checks += [check_read, check_up]
    pred_voxel = r.logits.argmax(1)[r.partition.in_component]
    up_agree = float((pred_voxel[plain_idx.cpu().numpy()] == r.labels).mean())
    print(f"[check] spread labels equal to the plain nn1's: {up_agree:.6f}")
    if up_agree < 0.999:
        raise AssertionError("interpolate_labels disagrees with plain nn1")
    # the model on the card vs the same weights and batch on the CPU
    # (full f32 both; 1e-3 covers summation order over 10 GRU rounds)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_batch = type(r.batch)(**{
        k: None if v is None else v.cpu() for k, v in vars(r.batch).items()})
    with torch.no_grad():
        cpu_logits = cpu_model(cpu_batch)[:n_sp].numpy()
    model_err = float(np.abs(cpu_logits - r.logits).max())
    print(f"[check] logits card vs CPU: max abs diff {model_err:.3e}")
    if not np.allclose(r.logits, cpu_logits, atol=1e-3, rtol=1e-3):
        raise AssertionError("model logits on the card disagree with the CPU")

    exact = quality_phase(r, cfg, solve_stats)
    dense = dense_crop_phase(r.partition, cfg)
    run_to_run_phase(r, cfg, raw, dev)

    # ---- 9. the training path; only its own nn1 launches are counted
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, checks_train, train, train_ctx = train_phase(
            dev, tmp, r.partition)
    checks += checks_train

    # ---- 10. the scan path, then (12) the submission writer on its
    # output; only each one's own nn1 launches are counted
    with tempfile.TemporaryDirectory() as tmp:
        scan_launches, checks_scan, (s_vox, s_chunks), scan, scan_path = \
            scan_phase(dev, tmp)
        submission_launches, submission = submission_phase(dev, tmp, scan,
                                                           scan_path)
    scan_part = scan.partition
    del scan
    checks += checks_scan

    # ---- 11. the supervised partition; only its own nn1 launches are
    # counted
    with tempfile.TemporaryDirectory() as tmp:
        ssp_launches, checks_ssp, ssp = ssp_phase(dev, tmp)
    checks += checks_ssp

    # ---- 13. the custom-dataset recipe; 14. the vKITTI3D recipe (neither
    # runs a kernel: their readers parse files on the host)
    with tempfile.TemporaryDirectory() as tmp:
        custom = custom_phase(dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        vkitti = vkitti_phase(dev, tmp)
    # ---- 15. visualize's writer on the room's result
    with tempfile.TemporaryDirectory() as tmp:
        visualize = visualize_phase(tmp, r)

    # ---- 16. the parallel phase: the room and the station sharded over
    # the card, data-parallel training; only the room read's nn1 launches
    # are counted
    with tempfile.TemporaryDirectory() as tmp:
        parallel_launches, parallel = parallel_phase(
            dev, tmp, r.partition, cfg, exact, scan_part, SEMA3D_CONFIG,
            train_ctx)
    del train_ctx

    # ---- 17. the JAX package's Semantic3D chain at 1e8 raw points (no
    # kernel: it reads no file and spreads no labels)
    headline = headline_phase(dev, scan_part)
    del scan_part

    # ---- 18. nn1 at its shapes: kernel, plain (on plain_rows sampled
    # queries where given), library, bound
    shapes = []
    for (db, q, check, name) in (
            (room, ann, check_read, "read"), (vox, room, check_up, "spread"),
            (room, q_sub, check_sub, "room check"),
            *((s_vox, q, c, f"scan spread, chunk {i}") for i, (q, c)
              in enumerate(zip(s_chunks, checks_scan)))):
        ms = cuda_ms(lambda: nn1_cuda(db, q), reps=3)
        bound_ms, bound_by = nn1_bound_ms(len(db), len(q))
        shapes.append({
            "path": name, "shape": f"db {len(db)} x queries {len(q)}",
            "ms": ms, "plain_ms": check["plain_ms"],
            "plain_rows": check.get("plain_rows", len(q)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_nn1_ms(db, q),
            "splits": nn1_plan(len(q), len(db))[0]})
        print(f"[time] nn1 {json.dumps(shapes[-1])}", flush=True)

    # ---- 19. result lines; the top-level numbers are the read shape's
    # (1M x 1M, the largest launch of the room path)
    read = shapes[0]
    kernels = [{
        "name": "nn1",
        "route": "cuda",
        "source": "superpoint_graph_tpu_torch/csrc/nn1.cu",
        "replaces": "superpoint_graph_tpu/ops/nn1_pallas.py:27",
        "launches": launches,
        "launches_by_path": {"room": launches, "train": train_launches,
                             "scan": scan_launches, "ssp": ssp_launches,
                             "submission": submission_launches,
                             "parallel": parallel_launches},
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        **{k: read[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "shape")},
        "shapes": shapes,
        "ptxas": [line for line in ptxas.splitlines() if "Used" in line],
    }]
    print(json.dumps({"kernels": kernels, "train": train, "ssp": ssp,
                      "custom": custom, "vkitti": vkitti,
                      "parallel": parallel, "headline": headline,
                      "dense_crop": dense,
                      "outputs": {"submission": submission,
                                  "visualize": visualize}}))
    print(f"[card] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
