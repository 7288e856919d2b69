"""Partition of ONE cloud with its tables sharded over a mesh, not only its
work.

Port of superpoint_graph_tpu/parallel/partition_shard.py
(`sharded_knn_geof`, `cutpursuit_band_sharded` with `_solve_band_sharded`,
`partition_cloud_sharded`, `_host_exact_knn`, `_sample_rk_host`,
`_geof_from`). A mesh is a list of devices (parallel/mesh.py; one card may
hold several shards), and each shard receives only its own rows:

* kNN + geof (`sharded_knn_geof`): the cloud is cell-sorted on the host as
  `ops/knn.py::knn_bigcloud` sorts a level (cells of the sampled k-NN
  radius times `cell_margin`) and cut into contiguous slabs of sorted rows,
  one a shard, each with a halo of sorted rows on both sides wide enough for
  every core query's 27-cell window. A shard searches its slab with the
  port's exact cell search (`_knn_cells_q`, ties to the lower point id) and
  computes its rows' geof there. A query whose certificate fails (found
  k-th distance above the cell size, or a window over WINDOW_CAP rows)
  goes to the exact fallback, which streams the cloud to the device in
  slices.
* cut pursuit (`cutpursuit_band_sharded`): `ops/cutpursuit_band.solve`
  with a shard context. The Morton-ordered rows are cut into D contiguous
  ranges; a shard holds their features, node weights and CSR edge range
  (the edges leaving its rows). Label vectors and region tables stay whole
  on every shard, as in JAX; sums over rows are partial sums joined by
  `psum`, and row vectors are rebuilt by `all_gather` after every sweep.
  The JAX solver's overflow edges are sharded apart from their sources,
  so it joins their CC hooks with `pmin` (:221); here every edge sits with
  its source, a sweep's minimum is whole on that shard, and the all_gather
  carries it. The sweep schedule is the single-device solver's; only the
  f32 order of the sums differs, so a threshold decision can flip between
  shard counts, while one shard count repeats bit for bit.

Apart from the O(n) label vectors and segment tables, a shard holds
O(n/D + halo) rows (`LAST_SHARD_STATS`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.components import connected_components, group_components
from ..ops.cutpursuit import _densify_first_occurrence, merge_regions
from ..ops.cutpursuit_band import (LAST_SOLVE_STATS, morton_order, solve,
                                   symmetric_edges)
from ..ops.geof import compute_geof_rows
from ..ops.knn import (_SPARE, FALLBACK_QUERY_CHUNK, TILE_ELEMS, WINDOW_CAP,
                       _bucket_sizes, _knn_cells_q, _level_sort,
                       _level_windows, sqdist)
from .mesh import make_mesh, run_shards

# the last sharded call's layout: per shard its rows (the slab buffer
# with its halo for the kNN, the solve's rows and edges), the halo, the
# queries sent to the exact fallback
LAST_SHARD_STATS: dict = {}

# rows of the JAX band's block (superpoint_graph_tpu/ops/cutpursuit_band.py
# :47), which sets the JAX sharded solve's pad rows
_BAND_B = 512


def sharded_pad_rows(n: int, n_shards: int) -> int:
    """The rows the JAX `cutpursuit_band_sharded` pads an n-row solve with
    (partition_shard.py:430-434): to a power-of-two count, at least the
    shard count, of 512-row band blocks."""
    nb = -(-max(n, _BAND_B) // _BAND_B)
    return max(1 << int(np.ceil(np.log2(max(nb, 2)))), n_shards) * _BAND_B - n


class _RowShard:
    """A shard of `solve`: its rows [row0, row1) of n, and its collectives."""

    def __init__(self, shard, row0: int, row1: int, n: int):
        self.row0, self.row1, self.n = row0, row1, n
        self.psum, self.all_gather = shard.psum, shard.all_gather


def cutpursuit_band_sharded(features, source, target, edge_weight,
                            reg_strength: float, mesh=None, cutoff: int = 0,
                            weight_decay: float = 0.7, node_weight=None,
                            xyz=None, **solver_kw):
    """libcp.cutpursuit-compatible solver with the graph sharded over
    `mesh` (default: every card). Host prep as `cutpursuit_band`'s (Morton
    order from `xyz`, else the input order; the symmetrised edge list in
    CSR order); each shard receives only its row range and the edges
    leaving it. `solver_kw` go to `solve`; `pad_rows` defaults to the JAX
    sharded solver's (`sharded_pad_rows`). Then the host merge step and
    the cutoff, as the single-device path. Returns (components,
    in_component int32)."""
    mesh = mesh or make_mesh()
    n_sh = mesh.size
    f = np.ascontiguousarray(features, dtype=np.float32)
    if f.ndim == 1:
        f = f[:, None]
    n = f.shape[0]
    src = np.asarray(source, np.int64)
    tgt = np.asarray(target, np.int64)
    w = np.asarray(edge_weight, np.float32)
    nw_h = (np.ones(n, np.float32) if node_weight is None
            else np.asarray(node_weight, np.float32))
    perm = morton_order(np.asarray(xyz)) if xyz is not None else np.arange(n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    e_src, e_tgt, e_w = symmetric_edges(
        torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(w),
        torch.as_tensor(inv.astype(np.int64)))
    bounds = [n * i // n_sh for i in range(n_sh + 1)]
    ptr = torch.searchsorted(e_src, torch.tensor(bounds)).tolist()
    f_p, nw_p = f[perm], nw_h[perm]
    pad = solver_kw.pop("pad_rows", sharded_pad_rows(n, n_sh))

    args = []
    for i, dev in enumerate(mesh.devices):
        r0, r1, p0, p1 = bounds[i], bounds[i + 1], ptr[i], ptr[i + 1]
        args.append((torch.as_tensor(f_p[r0:r1], device=dev),
                     torch.as_tensor(nw_p[r0:r1], device=dev),
                     e_src[p0:p1].to(dev), e_tgt[p0:p1].to(dev),
                     e_w[p0:p1].to(dev), r0, r1))

    def body(shard, f_s, nw_s, src_s, tgt_s, w_s, r0, r1):
        return solve(f_s, src_s, tgt_s, w_s, nw_s, float(reg_strength),
                     weight_decay, pad_rows=pad,
                     shard=_RowShard(shard, r0, r1, n), **solver_kw)

    (comp, stats), *_ = run_shards(body, mesh, args)
    LAST_SOLVE_STATS.update(n_pad=n + pad, d=int(f.shape[1]), **stats)
    LAST_SHARD_STATS.update(
        solve_rows=[bounds[i + 1] - bounds[i] for i in range(n_sh)],
        solve_edges=[ptr[i + 1] - ptr[i] for i in range(n_sh)])
    in_comp = _densify_first_occurrence(comp.cpu().numpy()[inv])
    in_comp = merge_regions(f, nw_h, in_comp, src, tgt, w,
                            float(reg_strength))
    if cutoff > 0:
        active = in_comp[src] == in_comp[tgt]
        _, in_comp = connected_components(n, src, tgt, active, cutoff)
    return group_components(in_comp), in_comp.astype(np.int32)


# ---------------------------------------------------------------------------
# sharded kNN + geometric features (slab halos, no replicated cloud)
# ---------------------------------------------------------------------------


def _exact_knn(xyz, q_ids, k: int, device):
    """Exact kNN of the points q_ids [m] of the host cloud xyz [n, 3]
    among all the others (the JAX `_host_exact_knn`), the cloud streamed to
    `device` in slices so that no more than TILE_ELEMS distances exist at
    once: direct-form distances (`sqdist`), the point itself left out, the
    k nearest by (distance, index). Returns (ids [m, k] int64, squared
    distances [m, k] f32) on the host."""
    n = len(xyz)
    out_i = torch.empty((len(q_ids), k), dtype=torch.int64)
    out_d = torch.empty((len(q_ids), k), dtype=torch.float32)
    chunk = FALLBACK_QUERY_CHUNK
    for s in range(0, len(q_ids), chunk):
        qi = q_ids[s:s + chunk].to(device)
        q = xyz[q_ids[s:s + chunk]].to(device)
        best_i = torch.full((len(qi), k), n, dtype=torch.int64, device=device)
        best_d = torch.full((len(qi), k), float("inf"), device=device)
        step = max(k + _SPARE, TILE_ELEMS // (4 * len(qi)))
        for b0 in range(0, n, step):
            blk = xyz[b0:b0 + step].to(device)
            ids = torch.arange(b0, b0 + len(blk), device=device)
            d2 = sqdist(q[:, None, :], blk[None, :, :])
            d2 = torch.where(ids[None, :] == qi[:, None], float("inf"), d2)
            top, sel = torch.topk(d2, min(k + _SPARE, len(blk)), dim=1,
                                  largest=False)
            cat_i = torch.cat([best_i, ids[sel]], 1)
            cat_d = torch.cat([best_d, top], 1)
            # ids ascending, then a stable sort by distance: ties keep the
            # lower id
            cat_i, o = torch.sort(cat_i, dim=1)
            cat_d, o2 = torch.sort(torch.gather(cat_d, 1, o), dim=1,
                                   stable=True)
            best_i = torch.gather(cat_i, 1, o2[:, :k])
            best_d = cat_d[:, :k]
        out_i[s:s + chunk] = best_i.cpu()
        out_d[s:s + chunk] = best_d.cpu()
    return out_i, out_d


def _sample_radius(xyz, k: int, device, sample: int = 256,
                   quantile: float = 0.999) -> float:
    """The `quantile` of the exact k-th-neighbour distance over a
    RandomState(0) sample of the points (the JAX `_sample_rk_host`)."""
    sel = np.random.RandomState(0).choice(
        len(xyz), size=min(sample, len(xyz) - 1), replace=False)
    _, d2 = _exact_knn(xyz, torch.as_tensor(sel), k, device)
    return float(np.quantile(np.sqrt(np.maximum(d2[:, k - 1].numpy(), 0.0)),
                             quantile))


def _geof_of(q_xyz, nbr_xyz):
    """geof of the points q_xyz [m, 3] with their neighbours' coordinates
    nbr_xyz [m, k, 3] (the JAX `_geof_from` on gathered rows)."""
    m, k, _ = nbr_xyz.shape
    return compute_geof_rows(
        nbr_xyz.reshape(-1, 3), q_xyz,
        torch.arange(m * k, device=q_xyz.device).reshape(m, k))


def _slab_search(xs, cs, ids, qpos, starts, spans, need, k: int,
                 dy_dim: int, h_cert: float):
    """One shard's kNN and geof over its slab buffer (sorted rows xs,
    cells cs, cloud ids ids): the query blocks qpos [mb, bq] (buffer
    positions) in windows starts/spans [mb, 9], by window-size buckets up
    to WINDOW_CAP (`knn_bigcloud`'s launch plan). Returns, on the host,
    (query rows' cloud ids, their neighbours' cloud ids, squared
    distances, geof, failed certificate mask)."""
    mb, bq = qpos.shape
    dev = xs.device
    n_buf = len(xs)
    order = torch.arange(n_buf, device=dev)
    out_i = torch.full((n_buf, k), n_buf, dtype=torch.int64, device=dev)
    out_d = torch.full((n_buf, k), float("inf"), device=dev)
    bad = torch.zeros((mb, bq), dtype=torch.bool, device=dev)
    trunc = np.flatnonzero(need > WINDOW_CAP)
    if len(trunc):
        bad[torch.as_tensor(trunc, device=dev)] = True
    lo = 0
    for size in _bucket_sizes(WINDOW_CAP):
        blk_all = np.flatnonzero((need > lo) & (need <= size))
        lo = size
        step = max(1, TILE_ELEMS // (bq * 9 * size))
        for c0 in range(0, len(blk_all), step):
            blk = torch.as_tensor(blk_all[c0:c0 + step], device=dev)
            qp = qpos[blk]
            got_i, got_d = _knn_cells_q(xs, xs, cs, order, qp, starts[blk],
                                        spans[blk], k, size, dy_dim,
                                        tie_ids=ids)
            rows = qp.reshape(-1)
            out_i[rows], out_d[rows] = got_i, got_d
            bad[blk] |= ~(got_d[:, k - 1] <= h_cert * h_cert).view(
                len(blk), bq)
    rows = torch.unique(qpos)
    nbr = out_i[rows].clamp(max=n_buf - 1)
    geof = compute_geof_rows(xs, xs[rows], nbr)
    failed = torch.zeros(n_buf, dtype=torch.bool, device=dev)
    failed[qpos.reshape(-1)[bad.reshape(-1)]] = True
    return (ids[rows].cpu(), ids[nbr].cpu(), out_d[rows].cpu(), geof.cpu(),
            failed[rows].cpu())


def _sharded_knn_geof(xyz, k: int, mesh, block_q: int = 128,
                      cell_margin: float = 1.3):
    """(idx [n, k] int64, squared distances [n, k] f32, geof [n, 4] f32),
    numpy in the input order, of `sharded_knn_geof`; its layout in
    LAST_SHARD_STATS["knn"]."""
    n_sh = mesh.size
    xyz_h = torch.as_tensor(np.ascontiguousarray(xyz, np.float32))
    n = len(xyz_h)
    if n <= k:
        raise ValueError(f"k={k} needs more than {n} points")
    mins = xyz_h.min(0).values
    extent = float((xyz_h.max(0).values - mins).max())
    h = max(_sample_radius(xyz_h, k, mesh.devices[0]) * cell_margin, 1e-6,
            extent / float(1 << 20))
    h_cert = h * (1.0 - 1e-5) - 4.8e-7 * extent
    keys_s, order, cells, dims = _level_sort(xyz_h, mins, h)

    # core rows per shard: whole query blocks; the last block of a shard
    # is filled with its last query (rows rewritten with the same values)
    core = -(-n // (n_sh * block_q)) * block_q
    plan = []
    for s in range(n_sh):
        lo, hi = min(s * core, n), min((s + 1) * core, n)
        m = -(-(hi - lo) // block_q)
        qpos = torch.minimum(lo + torch.arange(m * block_q),
                             torch.tensor(max(hi - 1, lo))).reshape(m, block_q)
        starts, spans = _level_windows(keys_s, qpos[:, 0], qpos[:, -1], dims)
        plan.append((lo, hi, qpos, starts, spans))
    # the halo: how far any shard's windows reach beyond its core rows
    halo = 0
    for lo, hi, _, starts, spans in plan:
        fit = spans.max(1).values <= WINDOW_CAP
        if fit.any():
            halo = max(halo, lo - int(starts[fit].min()),
                       int((starts + spans)[fit].max()) - hi)

    xs_h, cs_h = xyz_h[order], cells[order]
    args, rows = [], []
    for (lo, hi, qpos, starts, spans), dev in zip(plan, mesh.devices):
        g0, g1 = max(0, lo - halo), min(n, hi + halo)
        rows.append(g1 - g0)
        args.append((xs_h[g0:g1].to(dev), cs_h[g0:g1].to(dev),
                     order[g0:g1].to(dev), (qpos - g0).to(dev),
                     (starts - g0).to(dev), spans.to(dev),
                     spans.max(1).values.numpy()))

    def body(_, xs, cs, ids, qpos, starts, spans, need):
        if not len(qpos):
            return None
        return _slab_search(xs, cs, ids, qpos, starts, spans, need, k,
                            dims[1], h_cert)

    idx = np.empty((n, k), np.int64)
    d2 = np.empty((n, k), np.float32)
    geof = np.empty((n, 4), np.float32)
    failed = np.zeros(n, bool)
    for out in run_shards(body, mesh, args):
        if out is None:
            continue
        q, i, d, g, bad = (t.numpy() for t in out)
        idx[q], d2[q], geof[q], failed[q] = i, d, g, bad

    miss = torch.as_tensor(np.flatnonzero(failed))
    if len(miss):
        fi, fd = _exact_knn(xyz_h, miss, k, mesh.devices[0])
        idx[miss.numpy()], d2[miss.numpy()] = fi.numpy(), fd.numpy()
        dev = mesh.devices[0]
        geof[miss.numpy()] = _geof_of(xyz_h[miss].to(dev),
                                      xyz_h[fi].to(dev)).cpu().numpy()
    LAST_SHARD_STATS["knn"] = {
        "h": h, "halo": halo, "core_rows": [hi - lo for lo, hi, *_ in plan],
        "buffer_rows": rows, "n_fallback": int(len(miss))}
    return idx, d2, geof


def sharded_knn_geof(xyz, k_adj: int, k_geof: int, mesh=None,
                     block_q: int = 128, cell_margin: float = 1.3):
    """kNN graph + geof of a cloud with the cloud sharded over `mesh`
    (default: every card; see the module docstring): one exact search at
    k_geof, ties to the lower point id, as `ops/knn.py`'s. Returns
    (graph_nn dict of numpy {is_nn, source u32, target u32, distances f32}
    at k_adj, geof [n, 4] f32, idx [n, k_geof] int64), the contract of the
    JAX function."""
    mesh = mesh or make_mesh()
    n = len(xyz)
    idx, d2, geof = _sharded_knn_geof(xyz, k_geof, mesh, block_q,
                                      cell_margin)
    graph_nn = {
        "is_nn": True,
        "source": np.repeat(np.arange(n, dtype=np.uint32), k_adj),
        "target": idx[:, :k_adj].reshape(-1).astype(np.uint32),
        "distances": np.sqrt(np.maximum(d2[:, :k_adj], 0.0)).reshape(
            -1).astype(np.float32),
    }
    return graph_nn, geof, idx


def partition_cloud_sharded(xyz, rgb, cfg, mesh=None):
    """Geometric partition of ONE cloud with its kNN, geof and cut-pursuit
    tables sharded over `mesh` (default: every card): the features and
    partition stages of `pipeline.partition_cloud`, for a cloud already
    pruned (prune and SPG stay the single-device path's). Returns
    (graph_nn, geof, components, in_component)."""
    from ..pipeline import assemble_partition_features, edge_weights

    mesh = mesh or make_mesh()
    graph_nn, geof, _ = sharded_knn_geof(xyz, cfg.k_nn_adj, cfg.k_nn_geof,
                                         mesh)
    features = assemble_partition_features(geof, rgb, cfg)
    components, in_component = cutpursuit_band_sharded(
        features, graph_nn["source"].astype(np.int64),
        graph_nn["target"].astype(np.int64),
        edge_weights(graph_nn["distances"], cfg.lambda_edge_weight),
        cfg.reg_strength, mesh, cutoff=cfg.cp_cutoff, xyz=xyz)
    return graph_nn, geof, components, in_component
