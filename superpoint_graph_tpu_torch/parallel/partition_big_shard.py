"""Giant-cloud partition on a mesh: Morton-windowed cut pursuit where each
shard owns one contiguous slab of the cloud, so that no device holds a
whole-cloud table.

Port of superpoint_graph_tpu/parallel/partition_big_shard.py
(`chunked_cutpursuit_sharded`, `partition_big_sharded`), the scale-out of
`pipeline_big.chunked_cutpursuit_device`.

Layout: the cloud in its Morton order (`morton_perm_device`'s, computed
on the host); shard s owns the core rows [s*L, (s+1)*L), L a whole number
of window strides, plus `halo` rows on each side, and receives only that
buffer of features, kNN targets (as buffer positions) and squared
distances. In round r every shard solves its r-th window with the
single-device window step (`prep_chunk`, `solve` at CHUNK_SOLVER, the
in-window merge by `merge_device.pair_stats` and `merge_rounds`): the
windows, their cores and halos are exactly `chunk_geometry`'s, so each
window's labels are the single-device path's. Then the heal: each shard
reduces the kNN edges of its core rows that reach at most `halo` Morton
positions (so they lie in its buffer) to region pairs on its device
(`_compact_cross`, `_dedup_pairs`, `_compact_pairs`), the region moments
S and m are joined by `psum`, and the host adds the edges beyond the halo,
runs `merge_rounds` and `relabel_connected`, as the single-device heal.
The mean kNN distance of the edge weights is a `psum` of the shards' sums.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.components import relabel_connected
from ..ops.cutpursuit import _densify_first_occurrence, merge_rounds
from ..ops.cutpursuit_band import (_Segments, edge_weights_device,
                                   morton_perm_device, prep_chunk, solve)
from ..ops.merge_device import (_compact_cross, _compact_pairs, _dedup_pairs,
                                pair_stats)
from ..pipeline_big import (CHUNK_POINTS, CHUNK_SOLVER, _WEIGHT_DECAY,
                            chunk_geometry)
from .mesh import make_mesh, run_shards
from .partition_shard import _sharded_knn_geof

# the last chunked_cutpursuit_sharded call: rounds, windows solved, the
# edges beyond the halo folded in on the host, regions before and after
# the heal, the solves' host syncs and capped CC calls, seconds a stage,
# each shard's buffer rows
LAST_SHARDED_CP_STATS: dict = {}


def _window_labels(f_b, idx_b, d2_b, nw_b, x0: int, x1: int, s: int, e: int,
                   chunk_pad: int, dmean, lam: float, reg: float):
    """One window [x0, x1) of a shard's buffer (buffer positions), solved
    and merged inside the window; returns its core [s, e)'s labels
    numbered by first occurrence, and the solve's statistics."""
    ident = torch.arange(len(f_b) + 1, device=f_b.device)
    f_rows, (src, tgt, w), (esrc, etgt, ew) = prep_chunk(
        f_b, idx_b, d2_b, ident, ident, x0, x1, dmean, lam)
    nw = nw_b[x0:x1]
    comp, st = solve(f_rows, src, tgt, w, nw, reg, _WEIGHT_DECAY,
                     pad_rows=chunk_pad - (x1 - x0), **CHUNK_SOLVER)
    S, m, pa, pb, pw = pair_stats(f_rows, nw, comp, esrc, etgt, ew, x1 - x0)
    label = (merge_rounds(S, m, pa, pb, pw, x1 - x0, reg) if len(pa)
             else np.arange(x1 - x0))
    return _densify_first_occurrence(label[comp[s - x0:e - x0].cpu().numpy()]
                                     ), st


def chunked_cutpursuit_sharded(features, xyz, idx_adj, d2_adj,
                               reg_strength: float, mesh=None,
                               lambda_edge_weight: float = 1.0,
                               cutoff: int = 0,
                               chunk_points: int = CHUNK_POINTS):
    """Cut pursuit of ONE giant cloud with every O(n) table sharded over
    `mesh` (default: every card): features [n, d], idx_adj [n, k] (cloud
    ids) and d2_adj [n, k] on the host, each shard receiving its slab and
    halo (module docstring). Returns (components, in_component int32), the
    contract of `pipeline_big.chunked_cutpursuit_device`; the split is in
    LAST_SHARDED_CP_STATS."""
    mesh = mesh or make_mesh()
    t_all = time.perf_counter()
    n_sh = mesh.size
    f = torch.as_tensor(np.ascontiguousarray(features, np.float32))
    n, d = f.shape
    idx = torch.as_tensor(np.asarray(idx_adj, np.int64))
    d2 = torch.as_tensor(np.ascontiguousarray(d2_adj, np.float32))
    k = idx.shape[1]
    chunk_pad, halo, stride, _ = chunk_geometry(n, chunk_points)
    rounds = max(1, -(-(-(-n // n_sh)) // stride))
    core = rounds * stride

    t0 = time.perf_counter()
    perm = morton_perm_device(torch.as_tensor(np.asarray(xyz, np.float32)))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n)
    f_m, idx_m, d2_m = f[perm], inv[idx[perm]], d2[perm]
    t_morton = time.perf_counter() - t0

    # per shard: the buffer [b0, b1) of Morton rows, its core [lo, hi)
    args = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * core, n), min((s + 1) * core, n)
        b0, b1 = max(0, lo - halo), min(n, hi + halo)
        # targets as buffer positions; one past the buffer for those outside
        tb = idx_m[b0:b1] - b0
        tb = torch.where((tb >= 0) & (tb < b1 - b0), tb, b1 - b0)
        args.append((f_m[b0:b1].to(dev), tb.to(dev), d2_m[b0:b1].to(dev),
                     b0, lo, hi))

    def solve_windows(shard, f_b, idx_b, d2_b, b0, lo, hi):
        dev = f_b.device
        core_d = torch.sqrt(torch.clamp(d2_b[lo - b0:hi - b0], min=0.0))
        dmean = shard.psum(core_d.sum().reshape(1))[0] / (n * k)
        nw_b = torch.ones(len(f_b), device=dev)
        windows, stats = [], []
        for r in range(rounds):
            s = lo + r * stride
            e = min(s + stride, hi)
            if e <= s:
                break
            x0, x1 = max(0, s - halo), min(n, e + halo)
            labels, st = _window_labels(
                f_b, idx_b, d2_b, nw_b, x0 - b0, x1 - b0, s - b0, e - b0,
                chunk_pad, dmean, lambda_edge_weight, float(reg_strength))
            windows.append((s, e, labels))
            stats.append(st)
        return windows, stats, dmean

    t0 = time.perf_counter()
    outs = run_shards(solve_windows, mesh, args)
    t_solve = time.perf_counter() - t0
    dmean = outs[0][2]

    # window labels offset in global window order, as the single device's
    in_comp_m = np.empty(n, np.int64)
    base = 0
    for windows, _, _ in outs:
        for s, e, labels in windows:
            in_comp_m[s:e] = base + labels
            base += int(labels.max()) + 1 if len(labels) else 0

    # ---- the heal: the edges within the halo reduced to region pairs on
    # each shard, the region moments joined by psum
    t0 = time.perf_counter()
    cap = max(base, 2)
    comp_t = torch.as_tensor(in_comp_m)

    def heal_pairs(shard, f_b, idx_b, d2_b, b0, lo, hi):
        dev = f_b.device
        comp_b = comp_t[b0:b0 + len(f_b)].to(dev)
        rows = torch.arange(lo - b0, hi - b0, device=dev)
        src = rows.repeat_interleave(k)
        tgt = idx_b[rows].reshape(-1)
        w = edge_weights_device(d2_b[rows].reshape(-1), lambda_edge_weight,
                                dmean.to(dev))
        # an edge within the halo has its target in the buffer; the others
        # are folded in on the host
        w = torch.where((tgt < len(f_b)) & ((tgt - src).abs() <= halo), w,
                        0.0)
        moments = _Segments(comp_b[rows], base).sum(
            torch.cat([f_b[rows], torch.ones(len(rows), 1, device=dev)], 1))
        moments = shard.psum(moments)
        key_s, w_s, new = _dedup_pairs(
            *_compact_cross(comp_b, src, tgt.clamp(max=len(f_b) - 1), w), cap)
        pa, pb, pw = _compact_pairs(key_s, w_s, new, cap)
        return moments, pa.cpu(), pb.cpu(), pw.cpu()

    heal = run_shards(heal_pairs, mesh, args)
    moments = heal[0][0].double().cpu().numpy()
    # the edges beyond the halo, which no buffer holds whole, on the host
    src_h = torch.arange(n).repeat_interleave(k)
    tgt_h = idx.reshape(-1)
    far = (inv[src_h] - inv[tgt_h]).abs() > halo
    w_far = edge_weights_device(d2.reshape(-1)[far], lambda_edge_weight,
                                dmean.cpu())
    ca, cb = (torch.as_tensor(in_comp_m)[inv[x]] for x in (src_h[far],
                                                           tgt_h[far]))
    cross = ca != cb
    pa_c = torch.cat([h[1] for h in heal] + [torch.minimum(ca, cb)[cross]])
    pb_c = torch.cat([h[2] for h in heal] + [torch.maximum(ca, cb)[cross]])
    pw_c = torch.cat([h[3] for h in heal] + [w_far[cross]]).double()
    key, kinv = torch.unique(pa_c * cap + pb_c, return_inverse=True)
    pw_u = torch.zeros(len(key), dtype=torch.float64).index_add_(0, kinv,
                                                                 pw_c)
    label = merge_rounds(moments[:, :-1], moments[:, -1],
                         (key // cap).numpy(), (key % cap).numpy(),
                         pw_u.numpy(), base, float(reg_strength))
    in_comp = _densify_first_occurrence(label[in_comp_m[inv.numpy()]])
    t_heal = time.perf_counter() - t0

    t0 = time.perf_counter()
    components, in_comp = relabel_connected(
        n, src_h.numpy(), tgt_h.numpy(), in_comp.astype(np.int64), cutoff)
    t_group = time.perf_counter() - t0
    stats = [st for o in outs for st in o[1]]
    LAST_SHARDED_CP_STATS.clear()
    LAST_SHARDED_CP_STATS.update(
        n=n, shards=n_sh, rounds=rounds, windows=len(stats),
        beyond_halo_edges=int(far.sum()), heal_regions_in=base,
        heal_regions_out=int(in_comp.max()) + 1 if n else 0,
        host_syncs=int(sum(st["host_syncs"] for st in stats)),
        cc_capped=int(sum(st["cc_capped"] for st in stats)),
        cc_rounds_max=int(max((st["cc_rounds_max"] for st in stats),
                              default=0)),
        solve_iters=[st["iters"] for st in stats],
        buffer_rows=[len(a[0]) for a in args],
        morton=t_morton, solve=t_solve, heal=t_heal, group=t_group,
        total=time.perf_counter() - t_all)
    return components, in_comp.astype(np.int32)


def partition_big_sharded(xyz, rgb, cfg, mesh=None,
                          chunk_points: int = CHUNK_POINTS):
    """Giant-cloud partition on `mesh` (default: every card): the slab-halo
    kNN and geof of `partition_shard.sharded_knn_geof` chained into
    `chunked_cutpursuit_sharded`; no device holds a whole-cloud table.
    For a cloud already pruned. Returns (graph_nn, geof, components,
    in_component)."""
    from ..pipeline import assemble_partition_features

    mesh = mesh or make_mesh()
    n, k = len(xyz), cfg.k_nn_adj
    idx, d2, geof = _sharded_knn_geof(xyz, cfg.k_nn_geof, mesh)
    features = assemble_partition_features(geof, rgb, cfg)
    components, in_component = chunked_cutpursuit_sharded(
        features, xyz, idx[:, :k], d2[:, :k], cfg.reg_strength, mesh,
        lambda_edge_weight=cfg.lambda_edge_weight, cutoff=cfg.cp_cutoff,
        chunk_points=chunk_points)
    graph_nn = {
        "is_nn": True,
        "source": np.repeat(np.arange(n, dtype=np.uint32), k),
        "target": idx[:, :k].reshape(-1).astype(np.uint32),
        "distances": np.sqrt(np.maximum(d2[:, :k], 0.0)).reshape(
            -1).astype(np.float32),
    }
    return graph_nn, geof, components, in_component
