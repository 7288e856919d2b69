"""l0 cut pursuit on the device for clouds below the band solver's size:
every region split at once, with the graph as a dense neighbour matrix.

Port of superpoint_graph_tpu/ops/cutpursuit_jax.py (`_solve`,
`_solve_dense`, `_dense_neighbors`, `cutpursuit_tpu`). Per outer iteration:
region means; a split direction per region (the principal component of its
residuals, by power iteration on per-region covariances); `flow_steps`
rounds of side means, each followed by `2 * icm_sweeps` red/black ICM
sweeps on the unary difference plus the graph field (a parallel
relaxation of the reference's max-flow split); connected components of the
same-(region, side) graph by min propagation and pointer jumping; the split
is kept when the energy falls, and regions that did not split are frozen.

kNN graphs have a bounded degree, so `_solve_dense` keeps the graph as an
[n, K] neighbour matrix (each undirected edge in both endpoints' rows) and
every edge aggregation is a gather and a row reduction; `_solve` is the
edge-list form, for graphs whose degree cap (64) would drop edges. As in
the JAX wrapper, `cutpursuit_dense` pads the vertices to a power of two
(at least 1,024) and the neighbour slots to a multiple of 16 (at least
32): the pad rows (features 0, node weight 0, no neighbour) sit in region
0 in the first iteration, where their residuals turn its split direction,
so they are kept for the same partition. Clouds of `band_threshold`
vertices or more go to the band solver (`cutpursuit_band`), as in the JAX
package.

The JAX version runs its loops inside one jitted while loop; here they run
on the host, with one device read per CC block and per outer iteration.
Values are f32 as in the JAX version, but every sum (segment sums in one
fixed order, `cutpursuit_band._Segments`, row sums, the power iteration's
products) accumulates in float64 and rounds once to f32 (`_sum`, `_segsum`):
the card and the CPU add in other orders, and an f32 sum's last bit then
turned ICM decisions at a tie and parted the partitions (energy 1.8e-3
apart on chip_smoke.py's room crop); rounded once, the sums agree on both.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import card_unless
from .components import connected_components, group_components
from .cutpursuit import merge_regions
from .cutpursuit_band import _Segments, cutpursuit_band

_BIG = torch.iinfo(torch.int64).max


def _sum(x, dim):
    """Sum of f32 values along `dim`, accumulated in float64 and rounded
    once to f32."""
    return x.double().sum(dim).float()


def _segsum(segs: _Segments, x):
    """`segs.sum` of f32 rows, accumulated in float64, rounded to f32."""
    return segs.sum(x.double()).float()


def _seg_mean(segs: _Segments, f, weights):
    """(weighted mean of f's rows per segment, total weight per segment)."""
    s = _segsum(segs, torch.cat([f * weights[:, None], weights[:, None]], 1))
    cnt = s[:, -1]
    return s[:, :-1] / torch.clamp(cnt, min=1e-12)[:, None], cnt


def _seg_extreme(values, seg, n, reduce):
    fill = _BIG if reduce == "amin" else -_BIG
    return torch.full((n,), fill, dtype=values.dtype,
                      device=values.device).scatter_reduce(0, seg, values,
                                                           reduce)


def _steps_now(flow_steps, weight_decay, it):
    """The alternations of outer iteration `it`: max(1, round(flow_steps *
    weight_decay^it + 0.5)) in f32, rounding half to even, as the JAX
    solvers compute it, and at most flow_steps (their unrolled steps); on
    the host, so that every device takes the same count."""
    t = torch.tensor([flow_steps, weight_decay, it], dtype=torch.float32)
    return min(flow_steps,
               max(1, int(torch.round(t[0] * t[1] ** t[2] + 0.5))))


def _split_direction(f, comp, segs, saturated, mean, power_iters):
    """The side of every vertex (False where its region is saturated): the
    sign of its residual along its region's principal direction."""
    n, d = f.shape
    resid = f - mean[comp]
    cov = _segsum(segs, (resid[:, :, None] * resid[:, None, :]).reshape(
        n, d * d)).reshape(n, d, d)
    # the JAX start 1 + 0.01 sin(i k), its sine in float64 (the card's and
    # the CPU's f32 sines part in the last bit)
    iota = torch.arange(n, device=f.device, dtype=torch.float64)
    v = (1.0 + 0.01 * torch.sin(iota[:, None] * torch.arange(
        1, d + 1, dtype=torch.float64, device=f.device))).to(f.dtype)
    for _ in range(power_iters):
        v = _sum(cov * v[:, None, :], 2)
        norm = torch.sqrt(_sum(v * v, 1).double()[:, None] + 1e-20)
        v = (v.double() / norm).float()
    b = _sum(resid * v[comp], 1) > 0
    return torch.where(saturated[comp], False, b)


def _alternate(f, nw, comp, segs, mean, b, steps, icm_sweeps, field_of):
    """`steps` rounds of side means, each followed by 2 * icm_sweeps
    red/black ICM sweeps on the unary difference plus field_of(b)."""
    parity = (torch.arange(f.shape[0], device=f.device) % 2).bool()
    for _ in range(steps):
        bf = b.to(f.dtype)
        hp, cp = _seg_mean(segs, f, nw * bf)
        hm, cm = _seg_mean(segs, f, nw * (1.0 - bf))
        hp = torch.where((cp > 0)[:, None], hp, mean)
        hm = torch.where((cm > 0)[:, None], hm, mean)
        delta_u = nw * (_sum((f - hp[comp]) ** 2, 1)
                        - _sum((f - hm[comp]) ** 2, 1))
        for s in range(2 * icm_sweeps):
            want = (delta_u + field_of(b)) < 0
            b = torch.where(parity == (s % 2 == 0), want, b)
    return b


def _outer(f, nw, reg, weight_decay, max_iter, flow_steps, icm_sweeps,
           power_iters, energy_of, field_builder, components_of):
    """The outer loop both solvers share. energy_of(comp, mean) -> 0-d
    energy; field_builder(comp) -> field_of(b); components_of(comp, b) ->
    labels of the same-(region, side) components."""
    n = f.shape[0]
    dev = f.device

    def means_of(comp, segs):
        return _seg_mean(segs, f, nw)[0]

    comp = torch.zeros(n, dtype=torch.int64, device=dev)
    saturated = torch.zeros(n, dtype=torch.bool, device=dev)
    segs = _Segments(comp, n)
    energy = energy_of(comp, means_of(comp, segs))
    for it in range(max_iter):
        mean = means_of(comp, segs)
        b = _split_direction(f, comp, segs, saturated, mean, power_iters)
        b = _alternate(f, nw, comp, segs, mean, b,
                       _steps_now(flow_steps, weight_decay, it),
                       icm_sweeps, field_builder(comp))
        b = torch.where(saturated[comp], False, b)
        new_comp = components_of(comp, b)
        new_segs = _Segments(new_comp, n)
        new_energy = energy_of(new_comp, means_of(new_comp, new_segs))
        if not bool(new_energy < energy - 1e-6 * torch.clamp(
                torch.abs(energy), min=1.0)):
            break
        # a new region is frozen when its old region did not split
        hi = _seg_extreme(new_comp, comp, n, "amax")
        lo = _seg_extreme(new_comp, comp, n, "amin")
        unsplit = (hi == lo)[comp]
        saturated = _seg_extreme(unsplit.to(torch.int64), new_comp, n,
                                 "amax") > 0
        comp, segs, energy = new_comp, new_segs, new_energy
    return comp, energy


def _solve_dense(f, nbr, nbr_w, nbr_mask, nw, reg, weight_decay=1.0, *,
                 max_iter: int = 8, icm_sweeps: int = 3, flow_steps: int = 2,
                 power_iters: int = 8, cc_iters: int = 48):
    """Cut pursuit over a dense neighbour matrix: nbr [n, K] neighbour ids
    (padding: the vertex itself), nbr_w [n, K] weights, nbr_mask [n, K]
    validity; each undirected edge in both rows, so the cut weight is
    halved. Returns (region label of each vertex: a vertex id, energy)."""
    n = f.shape[0]
    iota = torch.arange(n, device=f.device)
    wmask = torch.where(nbr_mask, nbr_w, 0.0)

    def energy_of(comp, mean):
        fid = _sum(nw * _sum((f - mean[comp]) ** 2, 1), 0)
        cross = _sum(torch.where(comp[nbr] != comp[:, None], wmask,
                                 0.0).reshape(-1), 0)
        return fid + reg * 0.5 * cross

    def field_builder(comp):
        w_intra = torch.where(comp[nbr] == comp[:, None], wmask, 0.0)
        return lambda b: reg * _sum(
            w_intra * (1.0 - 2.0 * b[nbr].to(f.dtype)), 1)

    def components_of(comp, b):
        same = ((comp[nbr] == comp[:, None]) & (b[nbr] == b[:, None])
                & nbr_mask)

        def block(lab):
            for _ in range(12):
                cand = torch.where(same, lab[nbr], _BIG)
                lab = torch.minimum(lab, cand.min(1).values)
                for _ in range(3):
                    lab = torch.minimum(lab, lab[lab])
            return lab

        lab = block(iota)
        for _ in range(1, max(1, -(-cc_iters // 12))):
            new = block(lab)
            changed = bool(torch.any(new != lab))
            lab = new
            if not changed:
                break
        return lab

    return _outer(f, nw, reg, weight_decay, max_iter, flow_steps, icm_sweeps,
                  power_iters, energy_of, field_builder, components_of)


def _solve(f, src, tgt, w, nw, reg, weight_decay=1.0, *, max_iter: int = 8,
           icm_sweeps: int = 3, flow_steps: int = 2, power_iters: int = 8,
           cc_iters: int = 48):
    """Cut pursuit over an edge list (src, tgt, w), each edge once. Returns
    (region label of each vertex: a vertex id, energy)."""
    n = f.shape[0]
    iota = torch.arange(n, device=f.device)
    by_src, by_tgt = _Segments(src, n), _Segments(tgt, n)

    def energy_of(comp, mean):
        fid = _sum(nw * _sum((f - mean[comp]) ** 2, 1), 0)
        cross = comp[src] != comp[tgt]
        return fid + reg * _sum(torch.where(cross, w, 0.0), 0)

    def field_builder(comp):
        w_intra = torch.where(comp[src] == comp[tgt], w, 0.0)
        return lambda b: (
            _segsum(by_src, reg * w_intra * (1.0 - 2.0 * b[tgt].to(f.dtype)))
            + _segsum(by_tgt, reg * w_intra * (1.0 - 2.0 * b[src].to(f.dtype))))

    def components_of(comp, b):
        active = (comp[src] == comp[tgt]) & (b[src] == b[tgt])
        lab = iota
        for _ in range(cc_iters):
            m = torch.where(active, torch.minimum(lab[src], lab[tgt]), _BIG)
            new = torch.minimum(_seg_extreme(m, src, n, "amin"),
                                _seg_extreme(m, tgt, n, "amin"))
            lab = torch.minimum(lab, torch.where(new == _BIG, lab, new))
            for _ in range(3):
                lab = torch.minimum(lab, lab[lab])
        return lab

    return _outer(f, nw, reg, weight_decay, max_iter, flow_steps, icm_sweeps,
                  power_iters, energy_of, field_builder, components_of)


def _dense_neighbors(n, source, target, weight, cap=None):
    """Symmetrised dense neighbour matrix of an edge list: duplicate
    undirected edges merged with their weights summed (a mutual kNN pair
    counts twice, as the reference counts each input edge). Returns (nbr
    [n, K] int64, w [n, K] f32, mask [n, K] bool, kept fraction); a vertex
    of degree above `cap` keeps its `cap` heaviest edges."""
    src = np.asarray(source, np.int64)
    tgt = np.asarray(target, np.int64)
    w = np.asarray(weight, np.float64)
    lo = np.minimum(src, tgt)
    hi = np.maximum(src, tgt)
    uniq_key, inv = np.unique(lo * n + hi, return_inverse=True)
    wsum = np.zeros(len(uniq_key))
    np.add.at(wsum, inv, w)
    lo, hi, w = uniq_key // n, uniq_key % n, wsum
    a = np.concatenate([lo, hi])
    b = np.concatenate([hi, lo])
    ww = np.concatenate([w, w])
    deg = np.bincount(a, minlength=n)
    max_deg = int(deg.max())
    K = max_deg if cap is None else min(max_deg, cap)
    if cap is None or max_deg <= cap:
        order = np.argsort(a, kind="stable")
    else:
        order = np.lexsort((-ww, a))  # per vertex, heaviest first
    a, b, ww = a[order], b[order], ww[order]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(a)) - starts[a]
    keep = slot < K
    nbr = np.zeros((n, K), np.int64)
    wmat = np.zeros((n, K), np.float32)
    mask = np.zeros((n, K), bool)
    nbr[a[keep], slot[keep]] = b[keep]
    wmat[a[keep], slot[keep]] = ww[keep]
    mask[a[keep], slot[keep]] = True
    nbr[~mask] = np.arange(n)[:, None].repeat(K, 1)[~mask]
    return nbr, wmat, mask, float(keep.sum() / max(len(a), 1))


def cutpursuit_dense(features, source, target, edge_weight, reg_strength,
                     cutoff: int = 0, spatial: bool = False,
                     weight_decay: float = 0.7, node_weight=None, xyz=None,
                     band_threshold: int = 16384, device=None, **solver_kw):
    """libcp.cutpursuit-compatible solver with the split loop on `device`
    (default: the card); the JAX package's `cutpursuit_tpu`. Clouds of
    band_threshold vertices or more go to `cutpursuit_band` (`xyz` gives
    its Morton order). Below it the dense solver, or the edge-list one
    when the degree cap of 64 would drop more than 0.1% of the edge slots;
    then the host merge step and, with `cutoff`, the small-component fuse.
    `solver_kw` go to the solver (max_iter, icm_sweeps, flow_steps,
    power_iters, cc_iters); `spatial` is not read. Returns (components,
    in_component int32)."""
    del spatial
    device = card_unless(device)
    if features.shape[0] >= band_threshold:
        return cutpursuit_band(features, source, target, edge_weight,
                               reg_strength, cutoff=cutoff,
                               weight_decay=weight_decay,
                               node_weight=node_weight, xyz=xyz,
                               device=device, **solver_kw)
    f = np.ascontiguousarray(features, np.float32)
    if f.ndim == 1:
        f = f[:, None]
    n = f.shape[0]
    src_h = np.asarray(source, np.int64)
    tgt_h = np.asarray(target, np.int64)
    w_h = np.asarray(edge_weight, np.float32)
    if not np.all(src_h[1:] >= src_h[:-1]):
        e_order = np.argsort(src_h, kind="stable")
        src_h, tgt_h, w_h = src_h[e_order], tgt_h[e_order], w_h[e_order]
    nw = (np.ones(n, np.float32) if node_weight is None
          else np.asarray(node_weight, np.float32))
    nbr, wmat, mask, kept = _dense_neighbors(n, src_h, tgt_h, w_h, cap=64)

    def t(a):
        return torch.as_tensor(a, device=device)

    if kept >= 0.999:
        n_pad = 1 << max(int(np.ceil(np.log2(max(n, 1024)))), 10)
        K = nbr.shape[1]
        K_pad = max(32, -(-K // 16) * 16)
        f_p = np.zeros((n_pad, f.shape[1]), np.float32)
        f_p[:n] = f
        nbr_p = np.tile(np.arange(n_pad)[:, None], (1, K_pad))
        nbr_p[:n, :K] = nbr
        w_p = np.zeros((n_pad, K_pad), np.float32)
        w_p[:n, :K] = wmat
        m_p = np.zeros((n_pad, K_pad), bool)
        m_p[:n, :K] = mask
        nw_p = np.zeros(n_pad, np.float32)
        nw_p[:n] = nw
        comp, _ = _solve_dense(t(f_p), t(nbr_p), t(w_p), t(m_p), t(nw_p),
                               float(reg_strength), float(weight_decay),
                               **solver_kw)
        comp = comp[:n]
    else:
        comp, _ = _solve(t(f), t(src_h), t(tgt_h), t(w_h), t(nw),
                         float(reg_strength), float(weight_decay),
                         **solver_kw)
    comp = comp.cpu().numpy()
    _, first_pos, inv = np.unique(comp, return_index=True, return_inverse=True)
    in_comp = np.argsort(np.argsort(first_pos))[inv]
    in_comp = merge_regions(f, nw, in_comp, src_h, tgt_h, w_h,
                            float(reg_strength))
    if cutoff > 0:
        src_o = np.asarray(source, np.int64)
        tgt_o = np.asarray(target, np.int64)
        active = in_comp[src_o] == in_comp[tgt_o]
        _, in_comp = connected_components(n, src_o, tgt_o, active, cutoff)
    return group_components(in_comp), in_comp.astype(np.int32)
