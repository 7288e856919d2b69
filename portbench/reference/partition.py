"""The partition's l0 energy, and a plain solver of it, for the check of the
cut pursuit.

The cut pursuit of the reference repository (loicland/superpoint_graph
partition/partition.py, after Landrieu & Obozinski 2017) minimises, over
the partitions of the voxels,

    E = sum_i |f_i - mean of f over i's component|^2
        + reg * sum over the kNN edges (i, j) cut by the partition of w_ij

with f_i a voxel's features (linearity, planarity, scattering, twice the
verticality; S3DIS adds the mean colour / 255), the kNN edges directed
(each voxel to its k_nn_adj nearest others, so that an edge both ways
counts twice) and w_ij = 1 / (lambda + d_ij / mean d). `graph` works the
features and the edges out again from the reference's voxels (a k-d tree
search in float64, the covariances in float64); `energy` gives any
partition's E on that graph; `greedy` is the reference's own solver:
starting from one component a voxel, it merges, round after round,
adjacent components into groups about one partner each, every group's
change of E worked out exactly and every merge lowering E (the groups are
disjoint, so their changes add up), until no merge of two lowers E.
"""
from __future__ import annotations

import numpy as np
import torch

from .cloud import eigen_features


def neighbours(xyz64: np.ndarray, k: int):
    """(indices [n, k] int64, distances [n, k] float64) of each voxel's k
    nearest other voxels, nearest first."""
    from scipy.spatial import cKDTree

    n = len(xyz64)
    dist, idx = cKDTree(xyz64).query(xyz64, k + 1, workers=-1)
    # the voxel itself leaves its own list (the last neighbour goes where
    # a coinciding voxel took its place)
    self_ = idx == np.arange(n)[:, None]
    keep = np.argsort(self_, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(idx, keep, 1).astype(np.int64),
            np.take_along_axis(dist, keep, 1))


def geof_all(xyz64: np.ndarray, nbr: np.ndarray, device,
             block: int = 1 << 18) -> np.ndarray:
    """Linearity, planarity, scattering and verticality [n, 4] of every
    voxel over itself and its neighbours `nbr` [n, k] (covariance divided
    by k + 1, all in float64; the covariances on `device`, their
    eigen-solve on the host, which takes blocks of any size)."""
    pts = torch.as_tensor(xyz64, dtype=torch.float64, device=device)
    nb = torch.as_tensor(nbr, device=device)
    out = []
    for s in range(0, len(pts), block):
        pos = torch.cat([pts[s:s + block, None, :], pts[nb[s:s + block]]], 1)
        cen = pos - pos.mean(1, keepdim=True)
        cov = cen.transpose(1, 2) @ cen / float(pos.shape[1])
        out.append(eigen_features(cov.cpu())[0])
    return torch.cat(out).numpy()


def graph(xyz64: np.ndarray, rgb: np.ndarray | None, pcfg, device) -> dict:
    """{"f" [n, d], "src", "tgt" [n k_nn_adj], "w"}: the energy's features
    and weighted directed kNN edges for a partition config `pcfg`."""
    nbr, dist = neighbours(xyz64, max(pcfg.k_nn_geof, pcfg.k_nn_adj))
    f = geof_all(xyz64, nbr[:, :pcfg.k_nn_geof], device)
    f[:, 3] *= 2.0
    if pcfg.dataset == "s3dis" and rgb is not None:
        f = np.hstack([f, np.asarray(rgb, np.float64) / 255.0])
    k = pcfg.k_nn_adj
    d = dist[:, :k].reshape(-1)
    return {"f": f, "src": np.repeat(np.arange(len(xyz64)), k),
            "tgt": nbr[:, :k].reshape(-1),
            "w": 1.0 / (pcfg.lambda_edge_weight + d / d.mean())}


def energy(g: dict, comp: np.ndarray, reg: float) -> float:
    """E of the partition that gives voxel i the component comp[i]."""
    comp = np.unique(np.asarray(comp, np.int64), return_inverse=True)[1]
    comp = comp.ravel()
    f = g["f"]
    m = np.bincount(comp).astype(np.float64)
    mean = np.stack([np.bincount(comp, f[:, c]) for c in range(f.shape[1])],
                    1) / m[:, None]
    fit = float(((f - mean[comp]) ** 2).sum())
    cut = comp[g["src"]] != comp[g["tgt"]]
    return fit + reg * float(g["w"][cut].sum())


def greedy(g: dict, reg: float, device) -> np.ndarray:
    """The reference's partition of the graph `g` (component a voxel),
    by rounds of merges, as the module docstring says: in each round every
    component with a merge that lowers E points at its best partner (least
    change of E, then least pair index); a component that nothing points at, or
    the larger of two that point at each other, joins its partner unless
    the partner joins another itself. A partner takes all that join it
    where that lowers E (the change worked out for the whole group), else
    the best one alone."""
    f = torch.as_tensor(g["f"], dtype=torch.float64, device=device)
    n = len(f)
    iota = torch.arange(n, device=device)
    comp = iota.clone()
    s, m = f.clone(), torch.ones(n, dtype=torch.float64, device=device)
    a = torch.as_tensor(g["src"], device=device)
    b = torch.as_tensor(g["tgt"], device=device)
    w = torch.as_tensor(g["w"], dtype=torch.float64, device=device)

    def seg_min(idx, val, fill):
        out = torch.full((n,), fill, dtype=val.dtype, device=device)
        return out.scatter_reduce(0, idx, val, "amin")

    while True:
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        inside = lo == hi
        key, inv = torch.unique(lo[~inside] * n + hi[~inside],
                                return_inverse=True)
        w = torch.zeros(len(key), dtype=torch.float64,
                        device=device).index_add_(0, inv, w[~inside])
        a, b = key // n, key % n
        sq = (s * s).sum(1) / m  # |S|^2 / m of each component
        diff = s[a] / m[a, None] - s[b] / m[b, None]
        gain = m[a] * m[b] / (m[a] + m[b]) * (diff * diff).sum(1) - reg * w
        ok = gain < 0
        if not bool(ok.any()):
            break
        # each component's best pair: least gain, then least pair index
        pa, pb, pg = a[ok], b[ok], gain[ok]
        pid = torch.nonzero(ok)[:, 0]
        ends, other = torch.cat([pa, pb]), torch.cat([pb, pa])
        g2, id2 = torch.cat([pg, pg]), torch.cat([pid, pid])
        best = seg_min(ends, g2, float("inf"))
        at = g2 == best[ends]
        bp = seg_min(ends[at], id2[at], len(key))
        has = bp < len(key)
        sel = torch.nonzero(at & (id2 == bp[ends]))[:, 0]
        t = torch.full((n,), -1, device=device)
        t[ends[sel]] = other[sel]
        hub = torch.zeros(n, dtype=torch.bool, device=device)
        hub[t[has]] = True
        tt = torch.where(has, t, iota)
        mutual = has & (t[tt] == iota) & (iota > tt)
        cand = has & (~hub | mutual)
        client = cand & ~cand[tt] & (tt != iota)
        cl = torch.nonzero(client)[:, 0]
        h = t[cl]
        # each group's change of E, worked out whole
        s_u = s.clone().index_add_(0, h, s[cl])
        m_u = m.clone().index_add_(0, h, m[cl])
        parts = sq.clone().index_add_(0, h, sq[cl])
        cut = torch.zeros(n, dtype=torch.float64, device=device)
        cut.index_add_(0, h, w[bp[cl]])
        both = client[a] & client[b] & (t[a] == t[b])
        cut.index_add_(0, t[a[both]], w[both])
        change = parts - (s_u * s_u).sum(1) / m_u - reg * cut
        whole = change < 0
        # elsewhere the best one alone
        cg = gain[bp[cl]]
        lone = seg_min(h, cg, float("inf"))
        first = seg_min(h[cg == lone[h]], cl[cg == lone[h]], n)
        join = whole[h] | (first[h] == cl)
        cl, h = cl[join], h[join]
        s.index_add_(0, h, s[cl])
        m.index_add_(0, h, m[cl])
        parent = iota.clone()
        parent[cl] = h
        comp = parent[comp]
        a, b = parent[a], parent[b]
    return comp.cpu().numpy()
