"""k-nearest-neighbour graphs of one cloud: brute force and sorted cells.

Port of superpoint_graph_tpu/ops/knn.py (`knn`, `_knn_with_adj`,
`compute_graph_nn_2`, `knn_bigcloud` and its level search). Every search here
is exact: candidates are picked on a |q|^2 + |p|^2 - 2 q.p distance tile
(full f32, coordinates centred to shrink the cancellation) with `topk` and a
few spare places, then re-ranked on the exact (q - p)^2 distance with the
lower index first on equal distances, the point itself removed by index.
The JAX version selects with the TPU's approximate `approx_min_k` (recall
0.95), so the two agree on ~99% of indices, not all.

Up to BIGCLOUD_THRESHOLD points `compute_graph_nn_2` runs the blocked brute
force (`knn`); above it the multi-level sorted-cell search (`knn_bigcloud`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import card_unless

BIGCLOUD_THRESHOLD = 300_000  # points (superpoint_graph_tpu/ops/knn.py:963)
_SPARE = 8  # extra candidates re-ranked exactly: covers f32 near-ties
# queries per straggler brute-force slice of knn_bigcloud (tests lower it)
FALLBACK_QUERY_CHUNK = 8192
# distance-tile elements per launch of the brute force and the cell search:
# 2^27 f32 = 512 MB, which bounds the transients at any cloud size
TILE_ELEMS = 1 << 27
# knn_bigcloud's ladder (JAX knn.py:653-663, 719-724): level cell sizes at
# quantiles x factors of the sampled k-NN radius, then larger by
# EXTRA_LEVEL_FACTOR; queries a block (BLOCK_Q) and the widest window
# (WINDOW_CAP) while many queries are pending; the ladder stops once pending
# queries x points falls below LEVEL_MIN_WORK (the rest is cheaper by brute
# force). Tests lower them to reach every branch at small sizes.
LEVEL_QUANTILES = ((0.9, 1.1), (0.999, 1.25))
EXTRA_LEVEL_FACTOR, N_EXTRA_LEVELS = 3.0, 2
BLOCK_Q, WINDOW_CAP = 128, 8192
LEVEL_MIN_WORK = 4e9
# the 9 (dx, dy) cell columns a query's 27-cell block spans, in JAX's order
_CELL_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def sqdist(a, b):
    """Squared distances of broadcast points a, b [..., 3] as (dx^2 + dy^2)
    + dz^2, elementwise (a reduction kernel may add the three terms in
    another order from one tensor shape to the next)."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _rerank(xyz, q_ids, cand, k: int):
    """The k nearest of the candidate ids `cand` [m, c] (n: no candidate)
    for the points q_ids [m] of xyz, by the exact distance, lower id first
    on ties, the point itself excluded. Returns (ids [m, k] int64, squared
    distances [m, k] f32; inf and id n where fewer than k candidates)."""
    n = xyz.shape[0]
    # index order first so the stable sort breaks distance ties by the
    # lower index
    cand, _ = torch.sort(cand, dim=1)
    exact = sqdist(xyz[q_ids][:, None, :], xyz[cand.clamp(max=n - 1)])
    exact = torch.where((cand == q_ids[:, None]) | (cand >= n), float("inf"),
                        exact)
    exact, order = torch.sort(exact, dim=1, stable=True)
    return torch.gather(cand, 1, order[:, :k]), exact[:, :k]


def knn_vs_db(xyz: torch.Tensor, q_ids: torch.Tensor, k: int,
              block_q: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the points q_ids [m] of xyz [n, 3] among all the other
    points, by blocked brute force: query slices of `block_q` rows (default
    TILE_ELEMS // n) against the whole cloud. Returns (ids [m, k] int64,
    squared distances [m, k] f32), ascending, lower id first on ties."""
    n = xyz.shape[0]
    n_cand = min(k + 1 + _SPARE, n)
    if n_cand < k + 1:
        raise ValueError(f"k={k} needs more than {n} points")
    pts = xyz - xyz.mean(0)
    sq = (pts * pts).sum(1)
    m = q_ids.shape[0]
    out_i = torch.empty((m, k), dtype=torch.int64, device=xyz.device)
    out_d = torch.empty((m, k), dtype=torch.float32, device=xyz.device)
    bq = block_q or max(1, TILE_ELEMS // n)
    for s in range(0, m, bq):
        ids = q_ids[s:s + bq]
        d2 = sq[ids, None] + sq[None, :] - 2.0 * (pts[ids] @ pts.T)
        _, cand = torch.topk(d2, n_cand, dim=1, largest=False)
        out_i[s:s + bq], out_d[s:s + bq] = _rerank(xyz, ids, cand, k)
    return out_i, out_d


def knn(xyz: torch.Tensor, k: int, *, block_q: int = 2048
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of every point among the other points of the same cloud (the
    point itself excluded, reference graphs.py:30-40), by brute force, for
    clouds up to BIGCLOUD_THRESHOLD points (above it the O(n^2) search is
    refused: `knn_bigcloud` serves those).

    Returns (indices [n, k] int64, squared distances [n, k] f32), ascending;
    equal distances keep the lower index first."""
    n = xyz.shape[0]
    if n > BIGCLOUD_THRESHOLD:
        raise ValueError(
            f"{n} points > BIGCLOUD_THRESHOLD={BIGCLOUD_THRESHOLD}: brute "
            "force is O(n^2) there; use knn_bigcloud")
    return knn_vs_db(xyz, torch.arange(n, device=xyz.device), k,
                     block_q=block_q)


# ---------------------------------------------------------------------------
# knn_bigcloud: multi-level sorted-cell search (JAX knn.py:653-954)
# ---------------------------------------------------------------------------


def _sample_knn_radius(xyz, k: int, sample: int = 1024):
    """Exact k-th-neighbour distances of a RandomState(0) sample of the
    points (the JAX sample; its approximate search can only find them
    larger). Returns r_k [sample] numpy."""
    n = xyz.shape[0]
    sel = np.random.RandomState(0).choice(n, size=min(sample, n),
                                          replace=False)
    _, d2 = knn_vs_db(xyz, torch.as_tensor(sel, device=xyz.device), k)
    return np.sqrt(np.maximum(d2[:, k - 1].cpu().numpy(), 0.0))


def _level_sort(xyz, mins, h: float):
    """The cell sort of one ladder level: per-axis cells floor((x - min) /
    h) + 1 (so every cell +-1 stays inside the key's range), one int64 key
    (x, y, z) lexicographic, one stable sort. Returns (sorted keys, order,
    cells [n, 3] in input order, key dims (Dx, Dy, Dz))."""
    cells = torch.floor((xyz - mins) / torch.tensor(
        h, dtype=xyz.dtype, device=xyz.device)).to(torch.int64) + 1
    dims = (cells.max(0).values + 2).tolist()
    key = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    keys_s, order = torch.sort(key, stable=True)
    return keys_s, order, cells, dims


def _pending_positions(order, pending):
    """Sorted-order positions of the pending query ids, ascending."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=order.device)
    return torch.sort(inv[pending]).values


def _level_windows(keys_s, pos_first, pos_last, dims):
    """Per (query block, cell column) candidate windows: the sorted rows
    with key in [(x_f + dx, y_f + dy, z_f - 1), (x_l + dx, y_l + dy,
    z_l + 1)] lexicographic, for the block's first and last query (the JAX
    `_level_windows`, whose `_lex_lower` binary search over two int32 keys
    is one `searchsorted` over the int64 key here). Returns (starts [m, 9],
    spans [m, 9]) int64."""
    dz = dims[2]
    offs = torch.tensor([dx * dims[1] + dy for dx, dy in _CELL_OFFSETS],
                        device=keys_s.device)
    kf, kl = keys_s[pos_first], keys_s[pos_last]
    lo = ((kf // dz)[:, None] + offs) * dz + (kf % dz)[:, None] - 1
    hi = ((kl // dz)[:, None] + offs) * dz + (kl % dz)[:, None] + 2
    starts = torch.searchsorted(keys_s, lo)
    return starts, torch.searchsorted(keys_s, hi) - starts


def _knn_cells_q(xyz, xs, cs, order, qpos, starts, spans, k: int,
                 window: int, dy_dim: int):
    """kNN of the query blocks qpos [mb, bq] (sorted positions) among their
    blocks' windows of `window` rows a cell column (the JAX
    `_knn_cells_q_concat` / `_knn_cells_q_device`, exact): a candidate
    counts for a query when it lies in the column's cell (qx + dx, qy + dy)
    and within one cell of qz, inside its window, and is not the query.
    Returns (ids [mb * bq, k] original ids, exact squared distances)."""
    mb, bq = qpos.shape
    dev = xyz.device
    w = torch.arange(window, device=dev)
    cpos = starts[:, :, None] + w                              # [mb, 9, W]
    inside = w < spans[:, :, None]
    cpos = torch.where(inside, cpos, 0).reshape(mb, 9 * window)
    inside = inside.reshape(mb, 1, 9 * window)
    q_xyz, q_cell = xs[qpos], cs[qpos]                         # [mb, bq, 3]
    c_xyz, c_cell = xs[cpos], cs[cpos]                         # [mb, 9W, 3]
    origin = q_xyz[:, :1, :]
    qc, cc = q_xyz - origin, c_xyz - origin
    d2 = ((qc * qc).sum(-1)[:, :, None] + (cc * cc).sum(-1)[:, None, :]
          - 2.0 * torch.bmm(qc, cc.transpose(1, 2)))
    # a candidate's column key moved back by its pass's offset must equal
    # the query's column key; comparisons of broadcast operands only, so no
    # [mb, bq, 9W] integer temporaries
    off = torch.tensor(_CELL_OFFSETS, device=dev).repeat_interleave(window, 0)
    col_c = (c_cell[..., 0] - off[:, 0]) * dy_dim + (c_cell[..., 1] - off[:, 1])
    col_q = q_cell[..., 0] * dy_dim + q_cell[..., 1]
    cz, qz = c_cell[:, None, :, 2], q_cell[:, :, None, 2]
    valid = (inside & (col_c[:, None, :] == col_q[:, :, None])
             & (cz >= qz - 1) & (cz <= qz + 1)
             & (cpos[:, None, :] != qpos[:, :, None]))
    d2 = torch.where(valid, d2, float("inf"))
    top, sel = torch.topk(d2, min(k + _SPARE, 9 * window), dim=2,
                          largest=False)
    n = xyz.shape[0]
    cand = torch.where(torch.isfinite(top), order[torch.gather(
        cpos[:, None, :].expand(-1, bq, -1), 2, sel)], n)
    return _rerank(xyz, order[qpos.reshape(-1)], cand.reshape(mb * bq, -1), k)


def _bucket_sizes(cap: int):
    sizes, s = [], 256
    while s < cap:
        sizes.append(s)
        s *= 2
    return sizes + [cap]


def knn_bigcloud(xyz: torch.Tensor, k: int):
    """Exact kNN of every point of a large cloud xyz [n, 3] f32 (on its
    device) by the JAX package's multi-level sorted-cell search: level 0
    uses cells sized from the sampled k-NN radius (LEVEL_QUANTILES), and
    each later level re-solves, with larger cells, only the queries whose
    exactness certificate failed: found k-th distance <= the cell size (so
    every nearer point lies in the 27-cell block) and no truncated window.
    Once pending queries x points falls below LEVEL_MIN_WORK the rest goes
    to blocked brute force in FALLBACK_QUERY_CHUNK slices. Query blocks of BLOCK_Q consecutive sorted queries (8 after
    level 0 when few are pending) are grouped by the widest of their 9
    column windows into power-of-two window buckets up to WINDOW_CAP (4x
    when few are pending), and launched in chunks of TILE_ELEMS distances.
    The sorted-order coordinates and cells of a level are one gather each
    (the JAX `_sort_gather`).

    Returns (indices [n, k] int64 in the input order, squared distances
    [n, k] f32, info: ladder top "h", per-level queries and failures,
    "n_fallback", "stage_seconds")."""
    n = xyz.shape[0]
    if n <= k:
        raise ValueError(f"k={k} needs more than {n} points")
    dev = xyz.device
    t_stage = {"radius_sample": 0.0, "sort_and_windows": 0.0,
               "device_search": 0.0, "check_and_fallback": 0.0}
    t0 = time.perf_counter()
    mins, maxs = xyz.min(0).values, xyz.max(0).values
    extent = float((maxs - mins).max())
    rk = _sample_knn_radius(xyz, k)
    ladder = [max(float(np.quantile(rk, q)) * m, 1e-6)
              for q, m in LEVEL_QUANTILES]
    for _ in range(N_EXTRA_LEVELS):
        ladder.append(ladder[-1] * EXTRA_LEVEL_FACTOR)
    ladder = sorted(set(ladder))
    t_stage["radius_sample"] = time.perf_counter() - t0

    out_i = torch.full((n, k), n, dtype=torch.int64, device=dev)
    out_d = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    pending = torch.arange(n, device=dev)
    level_stats = []
    for h in ladder:
        P = len(pending)
        if P == 0 or (level_stats and P * n < LEVEL_MIN_WORK):
            break
        t0 = time.perf_counter()
        bq, cap = (BLOCK_Q, WINDOW_CAP) if P > 65536 else (8, 4 * WINDOW_CAP)
        # at most 2^20 cells an axis, so the three-axis key fits an int64
        # (JAX clamps at 32,000 for its fused int32 xy key)
        h = max(h, extent / float(1 << 20))
        keys_s, order, cells, dims = _level_sort(xyz, mins, h)
        qpos = (torch.arange(n, device=dev) if P == n
                else _pending_positions(order, pending))
        m = -(-P // bq)
        # the last block is filled with its last query (rows rewritten with
        # the same values)
        flat = torch.minimum(torch.arange(m * bq, device=dev),
                             torch.tensor(P - 1, device=dev))
        qpos2d = qpos[flat].reshape(m, bq)
        starts, spans = _level_windows(keys_s, qpos2d[:, 0], qpos2d[:, -1],
                                       dims)
        need = spans.max(1).values.cpu().numpy()
        t_stage["sort_and_windows"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        xs, cs = xyz[order], cells[order]
        bad = torch.zeros(m * bq, dtype=torch.bool, device=dev)
        # exactness margin for the f32 cell arithmetic: a few ulps of the
        # extent
        h_cert = h * (1.0 - 1e-5) - 4.8e-7 * extent
        cap = min(cap, n)
        trunc = np.flatnonzero(need > cap)
        if len(trunc):
            bad.view(m, bq)[torch.as_tensor(trunc, device=dev)] = True
        lo = 0
        for size in _bucket_sizes(cap):
            blk_all = np.flatnonzero((need > lo) & (np.minimum(need, cap)
                                                    <= size))
            lo = size
            step = max(1, TILE_ELEMS // (bq * 9 * size))
            for c0 in range(0, len(blk_all), step):
                blk = torch.as_tensor(blk_all[c0:c0 + step], device=dev)
                qp = qpos2d[blk]
                ids, d2 = _knn_cells_q(xyz, xs, cs, order, qp, starts[blk],
                                       spans[blk], k, size, dims[1])
                rows = order[qp.reshape(-1)]
                out_i[rows], out_d[rows] = ids, d2
                fail = ~(d2[:, k - 1] <= h_cert * h_cert)
                bad.view(m, bq)[blk] |= fail.view(len(blk), bq)
        bad_pos = qpos2d.reshape(-1)[bad]
        pending = torch.unique(order[bad_pos])
        level_stats.append({"h": round(h, 5), "queries": int(P),
                            "bad": int(len(pending))})
        t_stage["device_search"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    n_bad = len(pending)
    for s in range(0, n_bad, FALLBACK_QUERY_CHUNK):
        ids = pending[s:s + FALLBACK_QUERY_CHUNK]
        out_i[ids], out_d[ids] = knn_vs_db(xyz, ids, k)
    t_stage["check_and_fallback"] = time.perf_counter() - t0
    info = {"h": ladder[-1], "levels": level_stats, "n_fallback": int(n_bad),
            "window": WINDOW_CAP, "n_blocks": -(-n // BLOCK_Q),
            "stage_seconds": {k_: round(v, 3) for k_, v in t_stage.items()}}
    return out_i, out_d, info


def compute_graph_nn_2(xyz: np.ndarray, k_nn_adj: int, k_nn_geof: int,
                       device=None, return_device: bool = False):
    """Adjacency graph + geof neighbour table from ONE search at k_nn_geof
    (reference graphs.py:26-73): brute force up to BIGCLOUD_THRESHOLD
    points, `knn_bigcloud` above. Returns (graph dict of numpy {is_nn,
    source u32, target u32, distances f32}, geof neighbours [n, k_nn_geof]
    int64 tensor on `device`, default the card). With `return_device`, also
    the search's tables on `device`, {"idx": [n, k_nn_geof] int64, "d2":
    [n, k_nn_geof] f32}, for the device cut pursuit (the JAX version's
    `dev`, without pad rows)."""
    device = card_unless(device)
    assert k_nn_adj <= k_nn_geof
    n = len(xyz)
    xyz_t = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                            device=device)
    if n > BIGCLOUD_THRESHOLD:
        idx, d2, _ = knn_bigcloud(xyz_t, k_nn_geof)
    else:
        idx, d2 = knn(xyz_t, k_nn_geof)
    idx_adj = idx[:, :k_nn_adj].cpu().numpy()
    dist = np.sqrt(np.maximum(d2[:, :k_nn_adj].cpu().numpy(), 0.0))
    graph = {
        "is_nn": True,
        "source": np.repeat(np.arange(n, dtype=np.uint32), k_nn_adj),
        "target": idx_adj.reshape(-1).astype(np.uint32),
        "distances": dist.reshape(-1).astype(np.float32),
    }
    if return_device:
        return graph, idx, {"idx": idx, "d2": d2}
    return graph, idx
