"""l0 cut pursuit on the device: the JAX package's band solver, on an edge list.

Port of superpoint_graph_tpu/ops/cutpursuit_band.py (`morton_order`,
`morton_perm_device`, `_solve_band`, `_prep_band_device`,
`cutpursuit_band_device`, `cutpursuit_band`). The algorithm is the JAX
solver's, operation for operation: per outer iteration a principal-direction
split of every unsaturated region (per-label covariance, power iteration),
`flow_steps` rounds of side means each followed by `2 * icm_sweeps` red/black
ICM sweeps, connected components of the same-(region, side) graph by Jacobi
min propagation and pointer jumping, then the global or the per-region
accept.

What the JAX version does to fit a TPU is a layout, and is dropped here. On
a TPU a gather costs per index, so it stores the graph as a block band
(`geom`: B, PAD, WIN) of bf16 weights plus an overflow edge list with static
caps (`split_band_edges`, `_dedup_of`), and pads the vertex count to a power
of two (`n_pad` bucketing) so executables are reused. On Hopper a gather is
cheap, so the graph here is the symmetrised directed edge list in Morton
positions, in f32, sorted by source (CSR order). Both directions of a mutual
kNN pair are kept, so the pair counts twice, as the band's scatter-add makes
it count. The Morton order stays because it decides the result: ICM's
red/black split is the parity of the Morton position, and a CC label is the
least Morton position of its component.

One difference follows from the layout: f32 weights where JAX stores bf16
(its labels agree with an f32 band on ~0.9999 of points), so the two solvers
are compared on energy, component count and OOA, not label for label. The
JAX rows padded to the band's power of two are kept in effect: a pad row
(features 0, node weight 0, no edge) sits in label 0 in the first iteration,
where its residual adds mean ⊗ mean to that label's covariance and so turns
the first split direction; afterwards it is a singleton and changes nothing.
The solver adds that term for `pad_rows` rows (`jax_pad_rows`) instead of
the rows themselves.

The loop runs on the host: one device-to-host read per CC round ("did a
label change") and one per outer iteration ("did the energy improve"), which
LAST_SOLVE_STATS counts (each a `utils/tracing.to_host`). Every float
segment sum runs in a fixed order (`_Segments`), so two solves of one input
on one device give the same labels (the JAX solver is deterministic on its
TPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import card_unless
from ..utils import tracing
from .components import connected_components, group_components
from .cutpursuit import _densify_first_occurrence, merge_regions

# The last solve's executed outer iterations, CC rounds, final energy and
# shape (the JAX version's keys; n_pad = n plus the JAX pad rows), plus
# cc_capped (CC calls stopped at `cc_rounds` with labels still changing: a
# binding cap silently changes labels) and host_syncs (device-to-host reads
# inside the solve).
LAST_SOLVE_STATS: dict = {}

# Cap on the rounds of one CC call; the loop ends earlier on convergence. The
# JAX solver caps at 24, which binds at room scale: on chip_smoke.py's room
# (202,962 voxels) a CC call needs up to 41 rounds, and at 24 one of the
# three calls stops with labels still changing (tools/cp_room_quality.py
# reports cc_rounds_max and cc_capped).
CC_ROUNDS = 256


def morton_order(xyz: np.ndarray, bits: int = 16) -> np.ndarray:
    """Morton (z-order) sort permutation, on the host in uint64."""
    xyz = np.asarray(xyz, np.float64)
    lo = xyz.min(0)
    span = max(float(np.ptp(xyz, 0).max()), 1e-9)
    q = ((xyz - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(xyz), np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + a
            )
    return np.argsort(code, kind="stable")


def morton_perm_device(xyz: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Morton permutation on xyz's device: the quantisation of
    `morton_order` in f32 arithmetic (so ties may order differently from the
    host version), the 3*bits-bit code as one int64 key where JAX sorts two
    int32 halves, one stable sort. Returns the int64 permutation."""
    lo = xyz.min(0).values
    span = torch.clamp((xyz.max(0).values - lo).max(), min=1e-9)
    scale = float((1 << bits) - 1)
    q = torch.clamp((xyz - lo) / span * scale, 0, scale).to(torch.int64)
    code = torch.zeros(len(xyz), dtype=torch.int64, device=xyz.device)
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return torch.sort(code, stable=True).indices


def symmetric_edges(src0, tgt0, w0, inv):
    """Directed edges (src0 -> tgt0, weight w0) in original ids to the
    symmetrised directed list in positions inv[.], stably sorted by source.
    Returns (src, tgt, w), each twice as long as the input."""
    ps, pt = inv[src0], inv[tgt0]
    src = torch.cat([ps, pt])
    order = torch.sort(src, stable=True).indices
    return src[order], torch.cat([pt, ps])[order], torch.cat([w0, w0])[order]


class _Segments:
    """Sums of rows by a segment id in [0, n), in one fixed order: the rows
    stably sorted by id, then summed run by run (`segment_reduce`). On CUDA
    a float index_add_ adds by atomics in no fixed order, and a decision
    near its threshold could then flip between two calls. `presorted`: the
    rows are in id order already (the CSR edge list)."""

    def __init__(self, seg, n, presorted=False, reduce=None):
        self.order = None if presorted else torch.sort(seg, stable=True).indices
        # a sharded solve's psum of the shards' partial sums (None: whole)
        self.reduce = reduce
        # integer adds: the same counts in any order, and no host read
        self.lengths = torch.zeros(n, dtype=torch.int64,
                                   device=seg.device).index_add_(
            0, seg, torch.ones_like(seg))

    def sum(self, data):
        # (flatten, not reshape(n, -1): a shard may hold no rows)
        cols = (data[:, None] if data.ndim == 1 else data.flatten(1)).T
        cols = cols[:, self.order] if self.order is not None else cols
        # one column at a time: on CUDA the 1-D form sums a segment with a
        # block of threads, the 2-D form with one thread a segment and
        # column, serially (63% of the solve's device time on chip_smoke.py's
        # room, PERF.md). unsafe: the lengths count the ids, so no check (a
        # host read) is needed
        out = torch.stack([torch.segment_reduce(c.contiguous(), "sum",
                                                lengths=self.lengths,
                                                unsafe=True) for c in cols], 1)
        out = out.reshape((len(self.lengths),) + data.shape[1:])
        return out if self.reduce is None else self.reduce(out)

    def mean(self, data, weights):
        s = self.sum(torch.cat([data * weights[:, None], weights[:, None]], 1))
        return s[:, :-1] / torch.clamp(s[:, -1:], min=1e-12)


def _same(x):
    return x


def _shard_rows(shard, n: int):
    """(first row, slice of the rows, all-gather) of a solve's shard; the
    whole [0, n) and the identity without one."""
    if shard is None:
        return 0, slice(0, n), _same
    return shard.row0, slice(shard.row0, shard.row1), shard.all_gather


def _seg_any(mask, seg, n):
    return torch.zeros(n, dtype=torch.int32, device=seg.device).scatter_reduce(
        0, seg, mask.to(torch.int32), "amax") > 0


def cc_labels(key, src, tgt, w, *, cc_rounds: int = CC_ROUNDS,
              cc_sweeps_per_round: int = 4, cc_jumps: int = 1, read=bool,
              shard=None):
    """Connected components of the graph of the edges (w > 0) whose two ends
    have the same `key` (the JAX `cc_full`): a label is the least position
    of its component. A round is `cc_sweeps_per_round` Jacobi min sweeps
    over all edges, then `cc_jumps` pointer jumps; rounds run until one
    changes no label or `cc_rounds` have run. `read` turns the 0-d
    "changed" tensor into a bool (a host read). `shard`: as in `solve`;
    the edges are then the shard's (src in its rows), each sweep updates
    its rows and all-gathers them.

    Returns (labels [n] int64, rounds, capped): capped is True when the cap
    stopped the loop while labels were still changing."""
    n = key.shape[0]
    row0, rows, gather = _shard_rows(shard, n)
    same = (key[src] == key[tgt]) & (w > 0)
    src_loc = src - row0
    lab = torch.arange(n, device=key.device)
    rounds, changed = 0, True
    while changed and rounds < cc_rounds:
        new = lab
        for _ in range(cc_sweeps_per_round):
            cand = torch.where(same, new[tgt], n)
            new = gather(new[rows].scatter_reduce(0, src_loc, cand, "amin"))
        for _ in range(cc_jumps):
            new = torch.minimum(new, new[new])
        changed = read(torch.any(new != lab))
        lab = new
        rounds += 1
    return lab, rounds, changed


def solve(f, src, tgt, w, nw, reg, weight_decay=1.0, *, pad_rows: int = 0,
          max_iter: int = 8, icm_sweeps: int = 3, flow_steps: int = 2,
          power_iters: int = 8, cc_rounds: int = CC_ROUNDS,
          cc_sweeps_per_round: int = 4, cc_jumps: int = 1,
          accept: str = "global", stop_tol: float = 0.0, shard=None):
    """The JAX `_solve_band` on an edge list. f [n, d] f32 features and nw
    [n] node weights in Morton order; (src, tgt, w) the symmetrised directed
    edges in Morton positions, sorted by source. `pad_rows`: the JAX rows
    padded after these (features 0, node weight 0, no edges; see the module
    docstring). Defaults are the JAX solver's but for the CC cap
    (CC_ROUNDS; the CC loop ends on convergence).

    `shard`: one shard of a sharded solve (the JAX `_solve_band_sharded`,
    parallel/partition_shard.py), with row0, row1, n, psum and all_gather.
    f and nw are then its rows [row0, row1) of the n, and (src, tgt, w) the
    edges whose source is one of them. The labels and the region tables
    stay whole on every shard; sums over rows are the shard's partial sums
    joined by psum, and row vectors (the sides, CC labels) are rebuilt by
    all_gather after each sweep. Without a shard the solve is the
    single-device one.

    Returns (comp [n] int64: the least Morton position of each vertex's
    region, stats dict: iters, cc_rounds (in all), cc_rounds_max (of one CC
    call), cc_capped, energy, host_syncs)."""
    if accept not in ("global", "region"):
        raise ValueError(f"accept={accept!r}: 'global' or 'region'")
    n_loc, d = f.shape
    n = n_loc if shard is None else shard.n
    row0, rows, gather = _shard_rows(shard, n)
    psum = _same if shard is None else shard.psum
    dev = f.device
    iota = torch.arange(n, device=dev)
    parity = (iota[rows] % 2).bool()
    by_src = _Segments(src - row0, n_loc, presorted=True)
    reads = 0

    def read(t):
        nonlocal reads
        reads += 1
        return bool(tracing.to_host(t, "cp.solve.loop"))

    def energy_of(comp, mean):
        fid = (nw * ((f - mean[comp[rows]]) ** 2).sum(1)).sum()
        # every undirected edge appears twice (both directions)
        cross = torch.where(comp[src] != comp[tgt], w, 0.0).sum()
        return psum(fid + reg * 0.5 * cross)

    def segments(comp):
        return _Segments(comp[rows], n,
                         reduce=None if shard is None else shard.psum)

    def split_once(comp, by_comp, saturated, mean, it):
        steps_now = max(1, int(np.round(
            np.float32(flow_steps) * np.float32(weight_decay) ** np.float32(it)
            + np.float32(0.5))))
        comp_loc = comp[rows]
        resid = f - mean[comp_loc]
        cov = by_comp.sum((resid[:, :, None] * resid[:, None, :]).reshape(
            n_loc, d * d)).reshape(n, d, d)
        if it == 0 and pad_rows:
            # the pad rows' residuals (0 - mean) in label 0, the only label
            cov[0] += pad_rows * torch.outer(mean[0], mean[0])
        v = 1.0 + 0.01 * torch.sin(iota[:, None].to(f.dtype) * torch.arange(
            1, d + 1, dtype=f.dtype, device=dev))
        for _ in range(power_iters):
            v = (cov * v[:, None, :]).sum(2)
            v = v * torch.rsqrt((v * v).sum(1, keepdim=True) + 1e-20)
        b = ((resid * v[comp_loc]).sum(1) > 0) & ~saturated[comp_loc]
        b_all = gather(b)
        w_intra = torch.where(comp[src] == comp[tgt], w, 0.0)
        # steps past steps_now leave b as it was (the JAX step_on gate)
        for _ in range(min(steps_now, flow_steps)):
            # both side means from one segment sum; delta_u in the expanded
            # form |f-hp|^2 - |f-hm|^2 = -2 f.(hp-hm) + |hp|^2 - |hm|^2
            wp = nw * b.to(f.dtype)
            wm = nw - wp
            sides = by_comp.sum(torch.cat([f * wp[:, None], wp[:, None],
                                           f * wm[:, None], wm[:, None]], 1))
            cp_, cm_ = sides[:, d], sides[:, 2 * d + 1]
            hp = torch.where((cp_ > 0)[:, None], sides[:, :d]
                             / torch.clamp(cp_, min=1e-12)[:, None], mean)
            hm = torch.where((cm_ > 0)[:, None], sides[:, d + 1:2 * d + 1]
                             / torch.clamp(cm_, min=1e-12)[:, None], mean)
            hd = torch.cat([hp - hm, ((hp * hp).sum(1)
                                      - (hm * hm).sum(1))[:, None]], 1)
            hd_q = hd[comp_loc]
            delta_u = nw * (-2.0 * (f * hd_q[:, :d]).sum(1) + hd_q[:, d])
            for s in range(2 * icm_sweeps):
                spin = 1.0 - 2.0 * b_all.to(f.dtype)
                field = reg * by_src.sum(w_intra * spin[tgt])
                # red/black: odd Morton positions on even sweeps
                b = torch.where(parity == (s % 2 == 0),
                                (delta_u + field) < 0, b)
                b_all = gather(b)
        return b_all & ~saturated[comp], w_intra

    comp = torch.zeros(n, dtype=torch.int64, device=dev)
    by_comp = segments(comp)
    saturated = torch.zeros(n, dtype=torch.bool, device=dev)
    energy = energy_of(comp, by_comp.mean(f, nw))
    it = ccr = ccr_max = capped = 0
    improved = True
    while it < max_iter and improved:
        mean = by_comp.mean(f, nw)
        b, w_intra = split_once(comp, by_comp, saturated, mean, it)
        new_comp, rounds, cap = cc_labels(
            comp * 2 + b.to(torch.int64), src, tgt, w, cc_rounds=cc_rounds,
            cc_sweeps_per_round=cc_sweeps_per_round, cc_jumps=cc_jumps,
            read=read, shard=shard)
        by_new = segments(new_comp)
        ccr += rounds
        ccr_max = max(ccr_max, rounds)
        capped += int(cap)
        it += 1
        if accept == "region":
            # per-old-region accept: the energy is separable by old region
            # (fidelity per node, newly cut edges intra-region), and labels
            # stay collision free (least positions of disjoint node sets)
            new_mean = by_new.mean(f, nw)
            fo_node = nw * ((f - mean[comp[rows]]) ** 2).sum(1)
            fn_node = nw * ((f - new_mean[new_comp[rows]]) ** 2).sum(1)
            cut_node = by_src.sum(
                torch.where(new_comp[src] != new_comp[tgt], w_intra, 0.0))
            dfid, fo_reg, cut = by_comp.sum(
                torch.stack([fn_node - fo_node, fo_node, cut_node], 1)).T
            delta = dfid + reg * (0.5 * cut)
            acc_r = delta < -1e-6 * torch.clamp(fo_reg, min=1.0)
            acc_n = acc_r[comp]
            e_drop = torch.where(acc_r, delta, 0.0).sum()
            # stop_tol = 0: go on while any region was accepted
            improved = read(
                e_drop < -stop_tol * torch.clamp(energy.abs(), min=1.0))
            comp = torch.where(acc_n, new_comp, comp)
            by_comp = segments(comp)
            # accepted regions' children stay splittable; the rest saturate
            saturated = _seg_any(~acc_n, comp, n)
            energy = energy + e_drop
            continue
        new_energy = energy_of(new_comp, by_new.mean(f, nw))
        improved = read(
            new_energy < energy - 1e-6 * torch.clamp(energy.abs(), min=1.0))
        if improved:
            # a region that did not split saturates
            hi = torch.full((n,), -1, device=dev).scatter_reduce(
                0, comp, new_comp, "amax")
            lo = torch.full((n,), n, device=dev).scatter_reduce(
                0, comp, new_comp, "amin")
            saturated = _seg_any((hi == lo)[comp], new_comp, n)
            comp, by_comp, energy = new_comp, by_new, new_energy
    energy = float(tracing.to_host(energy, "cp.solve.energy"))
    tracing.count("cp.solve_iters", it)
    return comp, {"iters": it, "cc_rounds": ccr, "cc_rounds_max": ccr_max,
                  "cc_capped": capped, "energy": energy,
                  "host_syncs": reads + 1}


def jax_pad_rows(n: int, host_arrays: bool = False) -> int:
    """The rows the JAX caller pads an n-row solve with: to a power of two
    of at least 1024 on the device path (its kNN bucketing,
    superpoint_graph_tpu/ops/knn.py:1007); fed from host arrays, to a
    power-of-two count of band blocks of 1024 rows up to 2^17 rows, of 512
    above (`geom_for`, superpoint_graph_tpu/ops/cutpursuit_band.py:905-911)."""
    if not host_arrays:
        return (1 << max(int(np.ceil(np.log2(max(n, 1024)))), 10)) - n
    b = 1024 if n <= 1 << 17 else 512
    blocks = -(-max(n, b) // b)
    return (1 << int(np.ceil(np.log2(max(blocks, 2))))) * b - n


def edge_weights_device(d2: torch.Tensor, lam: float,
                        dmean: torch.Tensor | None = None) -> torch.Tensor:
    """w = 1 / (lam + d / mean(d)) from squared kNN distances (partition.py:
    175; the JAX `_prep_band_device`). The mean is over all the given
    (real) edges unless `dmean` gives it (the chunked path's global mean)."""
    d0 = torch.sqrt(torch.clamp(d2, min=0.0))
    if dmean is None:
        dmean = d0.mean()
    return 1.0 / (lam + d0 / torch.clamp(dmean, min=1e-12))


def prep_chunk(f, idx_adj, d2_adj, perm, inv, x0: int, x1: int, dmean,
               lam: float):
    """One window of the chunked giant-cloud solve (the JAX
    `_prep_band_chunk`, cutpursuit_band.py:684-759, in CSR form): rows
    perm[x0:x1] of the global Morton order, their features, and the kNN
    edges with both ends inside the window (the others are dropped, to be
    healed by the global merge), weighted with the GLOBAL mean distance
    `dmean`. f [n, d], idx_adj / d2_adj [n, k] in input order; inv the
    inverse of perm.

    Returns (f_rows [x1 - x0, d], (src, tgt, w) the symmetrised list in
    window positions sorted by source for `solve`, (esrc, etgt, ew) the
    directed in-window list for the per-chunk merge)."""
    rows = perm[x0:x1]
    n_ext = x1 - x0
    k = idx_adj.shape[1]
    tgt0 = (inv[idx_adj[rows]] - x0).reshape(-1)
    w0 = edge_weights_device(d2_adj[rows].reshape(-1), lam, dmean)
    src0 = torch.arange(n_ext, device=f.device).repeat_interleave(k)
    ok = (tgt0 >= 0) & (tgt0 < n_ext)
    esrc, etgt, ew = src0[ok], tgt0[ok], w0[ok]
    return (f[rows], symmetric_edges(
        esrc, etgt, ew, torch.arange(n_ext, device=f.device)),
        (esrc, etgt, ew))


def cutpursuit_band_device(f_dev, idx_adj_dev, d2_adj_dev, xyz, n: int,
                           reg_strength: float, lambda_edge_weight: float = 1.0,
                           weight_decay: float = 0.7, **solver_kw):
    """Cut pursuit over the kNN output where it lies: f_dev [n, d] features,
    idx_adj_dev / d2_adj_dev [n, k] neighbours and squared distances, all
    on one device; xyz [n, 3] (numpy or tensor) for the Morton order, made
    on that device. Only the labels come back. `solver_kw` go to `solve`;
    `pad_rows` defaults to the JAX device path's. Returns in_component [n]
    int32 (before the merge step, original order, numbered by first
    occurrence)."""
    dev = f_dev.device
    xyz_t = torch.as_tensor(xyz, dtype=torch.float32, device=dev)[:n]
    perm = morton_perm_device(xyz_t)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    k = idx_adj_dev.shape[1]
    src, tgt, w = symmetric_edges(
        torch.arange(n, device=dev).repeat_interleave(k),
        idx_adj_dev[:n].reshape(-1).to(torch.int64),
        edge_weights_device(d2_adj_dev[:n].reshape(-1), lambda_edge_weight),
        inv)
    f_p = f_dev[:n][perm]
    pad = solver_kw.pop("pad_rows", jax_pad_rows(n))
    comp, stats = solve(f_p, src, tgt, w, torch.ones(n, device=dev),
                        float(reg_strength), weight_decay, pad_rows=pad,
                        **solver_kw)
    LAST_SOLVE_STATS.update(n_pad=n + pad, d=int(f_p.shape[1]), **stats)
    return _densify_first_occurrence(
        tracing.to_host(comp[inv], "cp.solve.labels").numpy())


def cutpursuit_band(features, source, target, edge_weight, reg_strength,
                    cutoff: int = 0, spatial: bool = False,
                    weight_decay: float = 0.7, node_weight=None, xyz=None,
                    merge: bool = True, device=None, **solver_kw):
    """libcp.cutpursuit-compatible solver on host arrays; the solve runs on
    `device` (default: the card). `xyz` gives the Morton order (host
    `morton_order`); without it the input order is used. `merge=False`
    skips the backward merge step. `solver_kw` go to `solve`; `pad_rows`
    defaults to the JAX host-array path's. Returns (components, in_component int32)
    like the host oracle."""
    del spatial
    device = card_unless(device)
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

    def dev_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    e_src, e_tgt, e_w = symmetric_edges(dev_(src), dev_(tgt), dev_(w),
                                        dev_(inv.astype(np.int64)))
    pad = solver_kw.pop("pad_rows", jax_pad_rows(n, host_arrays=True))
    comp, stats = solve(dev_(f[perm]), e_src, e_tgt, e_w, dev_(nw_h[perm]),
                        float(reg_strength), weight_decay, pad_rows=pad,
                        **solver_kw)
    LAST_SOLVE_STATS.update(n_pad=n + pad, d=int(f.shape[1]), **stats)
    in_comp = _densify_first_occurrence(
        tracing.to_host(comp, "cp.solve.labels").numpy()[inv])
    if merge:
        in_comp = merge_regions(f, nw_h, in_comp, src, tgt, w,
                                float(reg_strength))
    if cutoff > 0:
        active = in_comp[src] == in_comp[tgt]
        _, in_comp = connected_components(n, src, tgt, active, cutoff)
    return group_components(in_comp), in_comp.astype(np.int32)
