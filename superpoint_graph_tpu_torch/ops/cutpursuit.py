"""l0 cut pursuit, host-exact solver (numpy + scipy max-flow).

Carried over unchanged in behaviour from superpoint_graph_tpu/ops/cutpursuit.py
(`cutpursuit`, `merge_regions`, `merge_rounds`, `_greedy_matching`,
`_mincut_binary`), whose package `__init__` imports jax. Same `seed`,
`max_iter` and `flow_steps`, so the labels equal the JAX package's oracle.
The greedy matching runs as the plain Python scan (the JAX package may call
its native C++ twin, same result).

Solves  argmin_x sum_i nw_i ||x_i - f_i||^2 + reg sum_(u,v) w_uv [x_u != x_v]
over piecewise-constant x (Landrieu & Obozinski 2017, l0 variant). The
pipeline runs it on request (`cp_backend="exact"`), as the oracle the device
solver (ops/cutpursuit_band.py) is held to; `merge_regions` is also the
device solver's host merge step.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import breadth_first_order, maximum_flow

from .components import connected_components, group_components

_FLOW_SCALE = 2**16
_WEIGHT_DECAY = 0.7  # damps the split alternations per outer iteration


def _mincut_binary(n, unary0, unary1, src, tgt, pair_w):
    """Global binary min-cut, label 1 <=> source side: cap(s->i) =
    unary0[i], cap(i->t) = unary1[i], cap(u<->v) = pair_w, scaled to the
    integer capacities scipy needs."""
    scale_ref = max(
        float(np.max(unary0, initial=0.0)),
        float(np.max(unary1, initial=0.0)),
        float(np.max(pair_w, initial=0.0)),
        1e-12,
    )
    scale = _FLOW_SCALE / scale_ref
    s, t = n, n + 1
    cap_s = np.rint(unary0 * scale).astype(np.int64)
    cap_t = np.rint(unary1 * scale).astype(np.int64)
    cap_e = np.rint(pair_w * scale).astype(np.int64)

    rows = np.concatenate([np.full(n, s), np.arange(n), src, tgt])
    cols = np.concatenate([np.arange(n), np.full(n, t), tgt, src])
    data = np.concatenate([cap_s, cap_t, cap_e, cap_e])
    keep = data > 0
    graph = csr_matrix(
        (data[keep], (rows[keep], cols[keep])), shape=(n + 2, n + 2),
        dtype=np.int64,
    )
    res = maximum_flow(graph, s, t)
    # source side = vertices reachable from s in the residual graph
    residual = graph - res.flow
    residual.data = np.maximum(residual.data, 0)
    order = breadth_first_order(residual, s, directed=True,
                                return_predecessors=False)
    b = np.zeros(n, dtype=bool)
    b[order[order < n]] = True
    return b


def _energy(f, nw, in_comp, src, tgt, w, reg):
    d = f.shape[1]
    n_comp = in_comp.max() + 1
    wsum = np.zeros(n_comp)
    np.add.at(wsum, in_comp, nw)
    mean = np.zeros((n_comp, d))
    np.add.at(mean, in_comp, f * nw[:, None])
    mean /= np.maximum(wsum, 1e-12)[:, None]
    fid = float(np.sum(nw[:, None] * (f - mean[in_comp]) ** 2))
    cross = in_comp[src] != in_comp[tgt]
    return fid + reg * float(np.sum(w[cross])), mean


def merge_regions(f, nw, in_comp, src, tgt, w, reg, max_rounds: int = 10):
    """Backward step: greedily merge adjacent regions whenever it lowers the
    energy, from region sufficient statistics (sum S_C, mass m_C)."""
    in_comp = np.asarray(in_comp, np.int64).copy()
    f = np.asarray(f, np.float64)
    if f.ndim == 1:
        f = f[:, None]
    nw = np.asarray(nw, np.float64)
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    w = np.asarray(w, np.float64)

    n_comp = int(in_comp.max()) + 1
    S = np.zeros((n_comp, f.shape[1]))
    np.add.at(S, in_comp, f * nw[:, None])
    m = np.zeros(n_comp)
    np.add.at(m, in_comp, nw)
    m = np.maximum(m, 1e-12)
    ca, cb = in_comp[src], in_comp[tgt]
    cross = ca != cb
    if not cross.any():
        return _densify_first_occurrence(in_comp)
    lo0 = np.minimum(ca[cross], cb[cross])
    hi0 = np.maximum(ca[cross], cb[cross])
    key0, inv0 = np.unique(lo0 * n_comp + hi0, return_inverse=True)
    pair_w = np.zeros(len(key0))
    np.add.at(pair_w, inv0, w[cross])
    label = merge_rounds(S, m, key0 // n_comp, key0 % n_comp, pair_w, n_comp,
                         reg, max_rounds=max_rounds)
    return _densify_first_occurrence(label[in_comp])


def merge_rounds(S, m, pair_a, pair_b, pair_w, n_comp, reg, max_rounds=10):
    """Region-level greedy merge rounds. Each round every region pair with a
    negative energy delta is a candidate; candidates are accepted best first
    when neither end was touched this round (union-find, roots kept small).
    Returns the root of every region [n_comp]."""
    S = np.asarray(S, np.float64)
    m = np.maximum(np.asarray(m, np.float64), 1e-12)
    pair_a = np.asarray(pair_a, np.int64)
    pair_b = np.asarray(pair_b, np.int64)
    pair_w = np.asarray(pair_w, np.float64)
    label = np.arange(n_comp)

    def _compress(lab):
        while True:
            nxt = lab[lab]
            if np.array_equal(nxt, lab):
                return lab
            lab = nxt[nxt]

    for _ in range(max_rounds):
        label = _compress(label)
        A = label[pair_a]
        B = label[pair_b]
        live = A != B
        if not live.any():
            break
        k2 = np.minimum(A[live], B[live]) * n_comp + np.maximum(A[live], B[live])
        korder = np.argsort(k2, kind="stable")
        ks = k2[korder]
        heads = np.empty(len(ks), bool)
        heads[0] = True
        np.not_equal(ks[1:], ks[:-1], out=heads[1:])
        starts = np.flatnonzero(heads)
        key = ks[starts]
        w_pair = np.add.reduceat(pair_w[live][korder], starts)
        A = key // n_comp
        B = key % n_comp
        # delta of merging (A, B): |S_A|^2/m_A + |S_B|^2/m_B
        #   - |S_A + S_B|^2/(m_A + m_B) - reg * w
        q = np.einsum("cd,cd->c", S, S) / m
        mA = m[A]
        mB = m[B]
        cross = np.einsum("pd,pd->p", S[A], S[B])
        qa = q[A]
        qb = q[B]
        sab = (qa * mA + qb * mB + 2.0 * cross) / (mA + mB)
        delta = (qa + qb - sab) - reg * w_pair
        good = delta < -1e-12
        if not good.any():
            break
        order = np.argsort(delta[good])
        Ag, Bg = A[good][order], B[good][order]
        acc = _greedy_matching(Ag, Bg, n_comp)
        if not acc.any():
            break
        keep = np.minimum(Ag[acc], Bg[acc])
        gone = np.maximum(Ag[acc], Bg[acc])
        label[gone] = keep
        S[keep] += S[gone]
        m[keep] += m[gone]
    return _compress(label)


def _greedy_matching(a: np.ndarray, b: np.ndarray, n_comp: int) -> np.ndarray:
    """Accept mask over ordered candidates: candidate i is accepted iff
    neither endpoint was touched by an earlier accepted one."""
    used = np.zeros(n_comp, bool)
    acc = np.zeros(len(a), bool)
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        if used[x] or used[y]:
            continue
        used[x] = used[y] = True
        acc[i] = True
    return acc


def _densify_first_occurrence(labels: np.ndarray) -> np.ndarray:
    """Dense int32 ids numbered in order of first occurrence."""
    labels = np.asarray(labels)
    n = labels.size
    if n == 0:
        return labels.astype(np.int32)
    bound = int(labels.max()) + 1
    # reversed fancy assignment: the last write per index sticks, so writing
    # positions in descending order leaves each label's first occurrence
    first = np.full(bound, -1, np.int64)
    first[labels[::-1]] = np.arange(n - 1, -1, -1)
    vals = np.flatnonzero(first >= 0)
    order = np.argsort(first[vals], kind="stable")
    newlab = np.empty(bound, np.int32)
    newlab[vals[order]] = np.arange(len(vals), dtype=np.int32)
    return newlab[labels]


def cutpursuit(features, source, target, edge_weight, reg_strength,
               cutoff: int = 0, max_iter: int = 10, flow_steps: int = 4,
               seed: int = 0):
    """Drop-in for `libcp.cutpursuit` (partition.py:177). Returns
    (components: list of uint32 index arrays, in_component int32 [n])."""
    f = np.ascontiguousarray(features, dtype=np.float64)
    if f.ndim == 1:
        f = f[:, None]
    n, d = f.shape
    src = np.asarray(source, dtype=np.int64)
    tgt = np.asarray(target, dtype=np.int64)
    w = np.asarray(edge_weight, dtype=np.float64)
    nw = np.ones(n)  # node weights (cutpursuit2 of SSP sets them)
    reg = float(reg_strength)
    del seed  # the solver draws no random numbers; kept for the libcp signature

    in_comp = np.zeros(n, dtype=np.int64)
    energy, mean = _energy(f, nw, in_comp, src, tgt, w, reg)
    saturated = np.zeros(1, dtype=bool)

    for it in range(max_iter):
        n_comp = in_comp.max() + 1
        active_v = ~saturated[in_comp]
        if not active_v.any():
            break
        # split direction: principal component of the residuals per region
        resid = f - mean[in_comp]
        cov = np.zeros((n_comp, d, d))
        np.add.at(cov, in_comp, resid[:, :, None] * resid[:, None, :])
        _, evec = np.linalg.eigh(cov)
        dirs = evec[..., -1]
        dirs[saturated] = 0.0
        b = np.einsum("nd,nd->n", resid, dirs[in_comp]) > 0

        hp = np.zeros((n_comp, d))
        hm = np.zeros((n_comp, d))
        intra = in_comp[src] == in_comp[tgt]
        e_src, e_tgt, e_w = src[intra], tgt[intra], w[intra]
        steps = max(1, int(round(flow_steps * (_WEIGHT_DECAY ** it) + 0.5)))
        for _ in range(steps):
            # weighted centroids of the two sides; an empty side keeps the mean
            for side, h in ((True, hp), (False, hm)):
                sel = b == side
                wsum = np.zeros(n_comp)
                np.add.at(wsum, in_comp[sel], nw[sel])
                acc = np.zeros((n_comp, d))
                np.add.at(acc, in_comp[sel], f[sel] * nw[sel, None])
                empty = wsum <= 0
                h[:] = np.where(
                    empty[:, None], mean, acc / np.maximum(wsum, 1e-12)[:, None]
                )
            u1 = nw * np.sum((f - hp[in_comp]) ** 2, axis=1)
            u0 = nw * np.sum((f - hm[in_comp]) ** 2, axis=1)
            # saturated regions stay on side 0
            u1 = np.where(active_v, u1, 1.0)
            u0 = np.where(active_v, u0, 0.0)
            b = _mincut_binary(n, u0, u1, e_src, e_tgt, reg * e_w)

        # new regions = connected components of constant (region, side)
        same = intra & (b[src] == b[tgt])
        _, new_in_comp = connected_components(n, src, tgt, same, 0)
        new_in_comp = new_in_comp.astype(np.int64)
        new_energy, new_mean = _energy(f, nw, new_in_comp, src, tgt, w, reg)

        if new_energy < energy - 1e-9 * max(abs(energy), 1.0):
            # a region that did not split is saturated
            n_new = new_in_comp.max() + 1
            sat_new = np.zeros(n_new, dtype=bool)
            pair = np.unique(np.stack([in_comp, new_in_comp]), axis=1)
            old_counts = np.bincount(pair[0], minlength=n_comp)
            sat_new[pair[1, old_counts[pair[0]] == 1]] = True
            in_comp, mean, energy, saturated = (new_in_comp, new_mean,
                                                new_energy, sat_new)
        else:
            break

    in_comp = merge_regions(f, nw, in_comp, src, tgt, w, reg).astype(np.int64)
    if cutoff > 0:
        # fuse regions smaller than cutoff into their largest neighbour
        active = in_comp[src] == in_comp[tgt]
        _, in_comp32 = connected_components(n, src, tgt, active, cutoff)
        in_comp = in_comp32.astype(np.int64)
    return group_components(in_comp), in_comp.astype(np.int32)
