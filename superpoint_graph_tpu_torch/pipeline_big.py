"""Giant-cloud geometric partition: one cloud beyond a single solve.

Port of superpoint_graph_tpu/pipeline_big.py (`CHUNKED_CP_THRESHOLD`,
`LAST_CP_STATS`, `_knn_edges_device`, `_global_dmean`,
`chunked_cutpursuit_device`, `chunked_cutpursuit`, `partition_cloud_big`).
Every stage is bounded in device memory:

* kNN: `ops/knn.py::knn_bigcloud` (multi-level sorted cells, exact).
* geof: rows in chunks of GEOF_CHUNK over the device kNN table.
* cut pursuit: the cloud's global Morton order is cut into windows of
  `chunk_pad` rows, each solved alone with its in-window kNN edges
  (`ops/cutpursuit_band.py::prep_chunk`, `solve`), merged inside the window
  (`ops/merge_device.py`), and only its core rows' labels kept; then the
  global merge step over the full directed kNN list heals the window
  boundaries, and `relabel_connected` splits a label connected only through
  a halo.
* SPG: `graph/spg_device.py::compute_sp_graph_device`.

`pipeline.partition_cloud` dispatches here above CHUNKED_CP_THRESHOLD pruned
voxels with the device cut pursuit.

Departures from the JAX version: the CC cap is the port's 256 (the JAX
chunk solver caps at 24, which binds at room scale; `cc_capped` counts
capped calls), the weights are f32, and the JAX pad rows of each window
(features 0, node weight 0) are kept as their one effect, a covariance term
(`solve`'s `pad_rows` = chunk_pad - window rows).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .device import card_unless
from .graph.spg_device import compute_sp_graph_device
from .ops.components import relabel_connected
from .ops.cutpursuit import _densify_first_occurrence, merge_regions
from .ops.cutpursuit_band import (cutpursuit_band, morton_order,
                                  morton_perm_device, prep_chunk, solve)
from .ops.geof import compute_geof
from .ops.knn import knn_bigcloud
from .ops.merge_device import LAST_MERGE_STATS, merge_regions_device

# the last chunked_cutpursuit_device call's stage split: the JAX keys
# (seconds: morton, prep, solve, chunk_merge, heal, group, host_edges,
# merge_reduce, merge_rounds, other; n, n_chunks, solve_iters) plus, summed
# over the windows, host_syncs and cc_capped, the largest cc_rounds_max,
# the per-window host_syncs, and the heal's split (heal_reduce,
# heal_rounds seconds; regions before and after)
LAST_CP_STATS: dict = {}

# above this many pruned voxels the partition goes through this module
# (superpoint_graph_tpu/pipeline_big.py:51)
CHUNKED_CP_THRESHOLD = 1 << 19
# rows of a solve window, and of a geof launch (JAX pipeline_big.py:379-380)
CHUNK_POINTS = 1 << 19
GEOF_CHUNK = 1 << 21
# the chunk solver's settings (JAX pipeline_big.py:208-221): per-region
# accept (global accept under-segmented 2.2x at 656k voxels), a deeper
# outer loop, a relative stop, one pointer jump a CC round; the CC cap is
# the port's (cutpursuit_band.CC_ROUNDS), not JAX's 24
CHUNK_SOLVER = {"accept": "region", "max_iter": 16, "stop_tol": 1e-3,
                "cc_jumps": 1}
# the split-direction damping of the JAX callers (cutpursuit_band.py:770)
_WEIGHT_DECAY = 0.7
# window rows are a multiple of the JAX band's block (cutpursuit_band.py:47)
_BLOCK = 512


def chunk_geometry(n: int, chunk_points: int):
    """(chunk_pad, halo, stride, windows): windows rounded up to whole
    512-row blocks, a halo of chunk_pad // 8 on each side of a core of
    `stride` rows, so a halo-extended window never exceeds chunk_pad rows
    (JAX pipeline_big.py:230-235). `windows` lists (s, e, x0, x1): the core
    [s, e) and the window [x0, x1) in Morton positions."""
    chunk_pad = -(-chunk_points // _BLOCK) * _BLOCK
    halo = chunk_pad // 8
    stride = chunk_pad - 2 * halo
    windows = []
    for c in range(-(-n // stride)):
        s, e = c * stride, min((c + 1) * stride, n)
        windows.append((s, e, max(0, s - halo), min(n, e + halo)))
    return chunk_pad, halo, stride, windows


def _knn_edges_device(idx_adj, d2_adj, dmean, lam: float):
    """The directed kNN edge list (i -> idx_adj[i, j]) with the reference
    weights w = 1 / (lam + d / dmean) (partition.py:175), on the device,
    for the global heal."""
    n, k = idx_adj.shape
    src = torch.arange(n, device=idx_adj.device).repeat_interleave(k)
    d = torch.sqrt(torch.clamp(d2_adj.reshape(-1), min=0.0))
    return src, idx_adj.reshape(-1), 1.0 / (lam + d / torch.clamp(
        dmean, min=1e-12))


def _global_dmean(d2_adj):
    return torch.sqrt(torch.clamp(d2_adj, min=0.0)).mean()


def chunked_cutpursuit_device(f_dev, idx_adj_dev, d2_adj_dev, xyz,
                              reg_strength: float,
                              lambda_edge_weight: float = 1.0,
                              cutoff: int = 0,
                              chunk_points: int = CHUNK_POINTS):
    """Cut pursuit of a giant cloud over its device tables: f_dev [n, d]
    features, idx_adj_dev / d2_adj_dev [n, k] kNN neighbours and squared
    distances, and `xyz` [n, 3] the points, whose Morton order
    (`morton_perm_device`) cuts the windows, all on one device (the JAX
    version's xyz_dev; its host-array branch has no caller here). Per
    window: `prep_chunk`, `solve`
    (CHUNK_SOLVER), the in-window merge step (it
    shrinks the raw split regions before the heal: without it the JAX heal
    took ~180 s instead of 5 s at 2e6), the core labels densified and
    offset. Then the global heal over the full directed kNN list and
    `relabel_connected` with `cutoff`. Returns (components, in_component
    int32); the split is in LAST_CP_STATS."""
    t_all0 = time.perf_counter()
    dev = f_dev.device
    n = int(f_dev.shape[0])
    chunk_pad, _, _, windows = chunk_geometry(n, chunk_points)

    t0 = time.perf_counter()
    perm = morton_perm_device(xyz[:n])
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    perm_h = perm.cpu().numpy()
    dmean = _global_dmean(d2_adj_dev)
    t_morton = time.perf_counter() - t0

    in_comp = np.empty(n, np.int64)
    base = 0
    t_prep = t_solve = t_merge = 0.0
    iters, syncs, capped, ccr_max = [], [], 0, 0
    LAST_MERGE_STATS.update(reduce=0.0, rounds=0.0)
    for s, e, x0, x1 in windows:
        t0 = time.perf_counter()
        f_rows, (src, tgt, w), (esrc, etgt, ew) = prep_chunk(
            f_dev, idx_adj_dev, d2_adj_dev, perm, inv, x0, x1, dmean,
            lambda_edge_weight)
        nw = torch.ones(x1 - x0, device=dev)
        t1 = time.perf_counter()
        t_prep += t1 - t0
        comp, st = solve(f_rows, src, tgt, w, nw, float(reg_strength),
                         _WEIGHT_DECAY, pad_rows=chunk_pad - (x1 - x0),
                         **CHUNK_SOLVER)
        comp_core = comp[s - x0:e - x0].cpu().numpy()
        t2 = time.perf_counter()
        t_solve += t2 - t1
        iters.append(st["iters"])
        syncs.append(st["host_syncs"])
        capped += st["cc_capped"]
        ccr_max = max(ccr_max, st["cc_rounds_max"])
        label = merge_regions_device(f_rows, nw, comp, esrc, etgt, ew,
                                     x1 - x0, float(reg_strength))
        core = _densify_first_occurrence(label[comp_core])
        in_comp[perm_h[s:e]] = base + core
        base += int(core.max()) + 1 if len(core) else 0
        t_merge += time.perf_counter() - t2

    t0 = time.perf_counter()
    chunk_stats = dict(LAST_MERGE_STATS)
    gsrc, gtgt, gw = _knn_edges_device(idx_adj_dev, d2_adj_dev, dmean,
                                       lambda_edge_weight)
    label = merge_regions_device(
        f_dev, torch.ones(n, device=dev), torch.as_tensor(in_comp, device=dev),
        gsrc, gtgt, gw, base, float(reg_strength))
    in_comp = _densify_first_occurrence(label[in_comp]).astype(np.int64)
    t_heal = time.perf_counter() - t0

    t0 = time.perf_counter()
    k = idx_adj_dev.shape[1]
    src_h = np.repeat(np.arange(n, dtype=np.int64), k)
    tgt_h = idx_adj_dev.reshape(-1).cpu().numpy().astype(np.int64)
    t_edges = time.perf_counter() - t0
    components, in_comp = relabel_connected(n, src_h, tgt_h, in_comp, cutoff)
    t_group = time.perf_counter() - t0
    timed = t_morton + t_prep + t_solve + t_merge + t_heal + t_group
    LAST_CP_STATS.clear()
    LAST_CP_STATS.update(
        n=n, n_chunks=len(windows), morton=t_morton, solve_iters=iters,
        prep=t_prep, solve=t_solve, chunk_merge=t_merge, heal=t_heal,
        group=t_group, host_edges=t_edges,
        merge_reduce=LAST_MERGE_STATS["reduce"],
        merge_rounds=LAST_MERGE_STATS["rounds"],
        heal_reduce=LAST_MERGE_STATS["reduce"] - chunk_stats["reduce"],
        heal_rounds=LAST_MERGE_STATS["rounds"] - chunk_stats["rounds"],
        heal_regions_in=base, heal_regions_out=int(in_comp.max()) + 1,
        host_syncs=int(sum(syncs)), host_syncs_per_chunk=syncs,
        cc_capped=int(capped), cc_rounds_max=int(ccr_max),
        other=time.perf_counter() - t_all0 - timed)
    return components, in_comp.astype(np.int32)


def chunked_cutpursuit(features, xyz, src, tgt, w, reg_strength: float,
                       cutoff: int = 0, chunk_points: int = CHUNK_POINTS,
                       device=None):
    """Cut pursuit of a large graph fed from host arrays (the JAX
    `chunked_cutpursuit`): host Morton order, windows of chunk_points rows
    with a halo of chunk_points // 8 a side, each solved alone by
    `cutpursuit_band` on `device` (default: the card) with its in-window
    edges and merged in the window, core labels kept; then the global
    merge step over the full edge list and `relabel_connected`; solver
    settings CHUNK_SOLVER. Returns (components, in_component int32)."""
    device = card_unless(device)
    n = len(features)
    xyz = np.asarray(xyz)
    perm = morton_order(xyz)
    halo = chunk_points // 8
    stride = max(chunk_points - 2 * halo, 1)
    mpos = np.empty(n, np.int64)
    mpos[perm] = np.arange(n)
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    w = np.asarray(w, np.float32)
    in_comp = np.empty(n, np.int64)
    local = np.full(n, -1, np.int64)
    base = 0
    ps, pt = mpos[src], mpos[tgt]
    for c in range(-(-n // stride)):
        s, e = c * stride, min((c + 1) * stride, n)
        x0, x1 = max(0, s - halo), min(n, e + halo)
        rows = perm[x0:x1]
        local[rows] = np.arange(x1 - x0)
        emask = (ps >= x0) & (ps < x1) & (pt >= x0) & (pt < x1)
        _, ic_ext = cutpursuit_band(
            features[rows], local[src[emask]], local[tgt[emask]], w[emask],
            reg_strength, xyz=xyz[rows], device=device, **CHUNK_SOLVER)
        core = _densify_first_occurrence(ic_ext[s - x0:e - x0])
        in_comp[perm[s:e]] = base + core
        base += int(core.max()) + 1 if len(core) else 0
    in_comp = merge_regions(features, np.ones(n), in_comp, src, tgt, w,
                            float(reg_strength))
    components, in_comp = relabel_connected(n, src, tgt, in_comp, cutoff)
    return components, in_comp.astype(np.int32)


def partition_cloud_big(xyz, rgb=None, labels=None, objects=None,
                        n_labels: int = 0, cfg=None,
                        host_outputs: bool = True, device=None):
    """Prune, kNN, geof (GEOF_CHUNK rows a launch), chunked cut pursuit
    (CHUNK_POINTS-row windows) and SPG of one giant cloud on `device`
    (default: the card), every stage bounded in memory. Returns a
    `pipeline.PartitionResult`. `times` holds "features", "partition",
    "spg" (seconds), "features_info" (knn_call, geof, host_fetch),
    "cp_info" (LAST_CP_STATS) and "knn_info" (the kNN's stage seconds);
    `cfg.spg_adjacency` is not read (the superedges' support is the kNN
    adjacency, as in the JAX version). With host_outputs=False the [n, k]
    tables and geof stay on the device: geof is None and graph_nn holds
    only is_nn."""
    from .pipeline import (PartitionConfig, PartitionResult,
                           _assemble_features_device, prune_stage)

    device = card_unless(device)
    cfg = cfg or PartitionConfig()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = {}
    t0 = time.perf_counter()
    xyz, rgb, labels = prune_stage(xyz, rgb, labels, objects, n_labels, cfg,
                                   device)
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    xyz_dev = torch.as_tensor(xyz, device=device)
    t1 = time.perf_counter()
    bi, bd2, info = knn_bigcloud(xyz_dev, cfg.k_nn_geof)
    idx_adj = bi[:, :cfg.k_nn_adj]
    d2_adj = bd2[:, :cfg.k_nn_adj]
    sync()
    t_knn = time.perf_counter() - t1
    t1 = time.perf_counter()
    geof_dev = compute_geof(xyz_dev, bi, chunk=GEOF_CHUNK)
    del bi, bd2
    use_color = cfg.dataset == "s3dis" and rgb is not None and len(rgb) > 0
    f_dev = _assemble_features_device(
        geof_dev, torch.as_tensor(np.asarray(rgb, np.uint8), device=device)
        if use_color else None)
    sync()
    times["features"] = time.perf_counter() - t0
    times["features_info"] = {"knn_call": t_knn,
                              "geof": time.perf_counter() - t1}

    t0 = time.perf_counter()
    components, in_component = chunked_cutpursuit_device(
        f_dev, idx_adj, d2_adj, xyz_dev, cfg.reg_strength,
        lambda_edge_weight=cfg.lambda_edge_weight, cutoff=cfg.cp_cutoff,
        chunk_points=CHUNK_POINTS)
    times["partition"] = time.perf_counter() - t0
    times["cp_info"] = dict(LAST_CP_STATS)

    t0 = time.perf_counter()
    if host_outputs:
        tgt = idx_adj.reshape(-1).cpu().numpy().astype(np.uint32)
        graph_nn = {
            "is_nn": True,
            "source": np.repeat(np.arange(n, dtype=np.uint32), cfg.k_nn_adj),
            "target": tgt,
            "distances": np.sqrt(np.maximum(
                d2_adj.cpu().numpy(), 0.0)).reshape(-1).astype(np.float32),
        }
        geof = geof_dev.cpu().numpy()
    else:
        graph_nn, geof = {"is_nn": True}, None
    times["features_info"]["host_fetch"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    graph_sp = compute_sp_graph_device(xyz_dev, cfg.d_se_max, in_component,
                                       labels, n_labels, idx_adj=idx_adj)
    times["spg"] = time.perf_counter() - t0
    times["knn_info"] = info["stage_seconds"]
    times["knn_levels"] = {"levels": info["levels"],
                           "n_fallback": info["n_fallback"]}
    return PartitionResult(
        xyz=xyz,
        rgb=(np.asarray(rgb) if rgb is not None
             else np.zeros((n, 3), np.uint8)),
        labels=np.asarray(labels) if labels is not None else np.zeros(0),
        geof=geof, graph_nn=graph_nn, components=components,
        in_component=in_component, graph_sp=graph_sp, times=times)

