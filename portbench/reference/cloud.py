"""The partition chain in plain NumPy and PyTorch, for the benchmark's checks.

Each function works one stage out again from the inputs the benchmark made
(or, where a stage can only be followed from the program's own state, from
that state, as its docstring says), after the reference repository
loicland/superpoint_graph (partition/partition.py, partition/graphs.py,
partition/provider.py, the C++ `libply_c.prune` and geof):

- `read_rows`, `s3dis_read`: the S3DIS text rows and the labels that the
  Annotations/ objects give them (each object's points claim the room point
  they coincide with; a later object wins);
- `prune`: the voxel grid anchored at the cloud's min corner, occupied
  voxels in the order a point first reaches them, mean xyz (float64 here),
  mean colour truncated, label histograms;
- `cluster_blocks`, `knn_distances`: groups of nearby sampled voxels, and
  their k nearest other voxels' distances;
- `geof_rows`: linearity, planarity, scattering and verticality of sampled
  rows over their k nearest voxels;
- `partition_faults`: voxels not in exactly one component, and components
  that the kNN adjacency does not hold together;
- `superedges`: the superpoint graph's superedges and their features;
- `nearest`: the voxels nearest each sampled raw point.

Matrix products, and the segment sums that are products with an incidence
matrix (`segment_sum`), round their inputs to TensorFloat-32 in the
control (`tf32=True`).
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .model import matmul, round_tf32

GEOF_EPS = 1e-10
# geof_rows: neighbourhoods whose k-th and (k+1)-th squared distances lie
# this close (relative) are ties at a float32 search's precision (the
# scan's coordinates reach 27 m); eigenvalues this close (relative to the
# largest) leave the eigenvectors, so verticality, unfixed at a float32
# eigen-solver's precision
TIE_REL = 1e-3
EIG_REL = 1e-2


def _mm(a, b, tf32):
    return matmul(a, b, tf32)


def read_rows(path: str) -> np.ndarray:
    """A whitespace-separated numeric text file as float64 [rows, cols]."""
    with open(path, "rb") as f:
        data = f.read()
    first = data[:data.index(b"\n")]
    vals = np.array(data.split(), dtype=np.float64)
    return vals.reshape(-1, len(first.split()))


S3DIS_IDS = {"ceiling": 1, "floor": 2, "wall": 3, "column": 4, "beam": 5,
             "window": 6, "door": 7, "table": 8, "chair": 9, "bookcase": 10,
             "sofa": 11, "board": 12, "clutter": 13, "stairs": 0}


def _row_keys(a: np.ndarray) -> np.ndarray:
    """One void key a float32 xyz row, for exact matching."""
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()


def s3dis_read(room_file: str):
    """(xyz f32, rgb u8, labels u8) of a raw S3DIS room: each Annotations/
    object's points label the room point they coincide with (the lowest
    index among coinciding ones), objects in file-name order, a later one
    overwriting; a room point no object reaches keeps 0."""
    room = read_rows(room_file)
    xyz = room[:, :3].astype(np.float32)
    rgb = room[:, 3:6].astype(np.uint8)
    labels = np.zeros(len(room), np.uint8)
    keys = _row_keys(xyz)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    files = sorted(glob.glob(os.path.join(os.path.dirname(room_file),
                                          "Annotations", "*.txt")))
    for f in files:
        pts = read_rows(f)[:, :3].astype(np.float32)
        k = _row_keys(pts)
        pos = np.searchsorted(sorted_keys, k)
        pos_c = np.minimum(pos, len(keys) - 1)
        if not (sorted_keys[pos_c] == k).all():
            raise ValueError(f"{f}: an object point lies on no room point")
        name = os.path.splitext(os.path.basename(f))[0].split("_")[0]
        labels[order[pos_c]] = S3DIS_IDS.get(name, 0)
    return xyz, rgb, labels


def prune(xyz: np.ndarray, width: float, rgb: np.ndarray,
          labels: np.ndarray | None, n_labels: int) -> dict:
    """Occupied voxels of `xyz` (float32) at `width`: bins
    floor((xyz - min) / width) in float32, voxels in first-point order.
    {"xyz": float64 means, "rgb": u8 truncated means, "hist": [m,
    n_labels+1] counts or None}."""
    xyz = np.asarray(xyz, np.float32)
    bins = np.floor((xyz - xyz.min(0)) / np.float32(width)).astype(np.int64)
    dims = bins.max(0) + 1
    key = (bins[:, 0] * dims[1] + bins[:, 1]) * dims[2] + bins[:, 2]
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    inv = inv.ravel()
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    vox = rank[inv]
    m = len(first)
    cnt = np.bincount(vox, minlength=m).astype(np.float64)
    mean = np.stack([np.bincount(vox, xyz[:, a].astype(np.float64), m)
                     for a in range(3)], 1) / cnt[:, None]
    rgb_sum = np.stack([np.bincount(vox, rgb[:, a].astype(np.int64), m)
                        for a in range(3)], 1)
    hist = None
    if labels is not None and n_labels > 0:
        hist = np.zeros((m, n_labels + 1), np.int64)
        np.add.at(hist, (vox, labels.astype(np.int64)), 1)
    return {"xyz": mean,
            "rgb": (rgb_sum // cnt[:, None].astype(np.int64)).astype(np.uint8),
            "hist": hist}


def cluster_blocks(xyz: np.ndarray, n_blocks: int, per_block: int, rng,
                   device) -> list:
    """`n_blocks` groups of rows of `xyz`: around each of `n_blocks` rows
    drawn from `rng`, the `per_block` rows nearest to it (by float64
    distance), so that a group's rows lie close together."""
    pts = torch.as_tensor(np.asarray(xyz, np.float64), device=device)
    centres = rng.choice(len(xyz), n_blocks, replace=False)
    blocks = []
    for c in centres:
        d2 = ((pts - pts[int(c)]) ** 2).sum(1)
        k = min(per_block, len(xyz))
        blocks.append(torch.topk(d2, k, largest=False).indices.cpu().numpy())
    return blocks


def knn_distances(xyz: np.ndarray, blocks: list, k: int, device,
                  tf32: bool = False) -> np.ndarray:
    """Sorted distances [rows, k] from each row of `blocks` (in their
    order) to its k nearest other rows of `xyz`: |p - c|^2 + |q - c|^2 -
    2 (q - c).(p - c), c the centre of the row's block, the product a
    matrix product."""
    pts = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    out = []
    for blk in blocks:
        q_ids = torch.as_tensor(blk, device=device)
        c = pts[q_ids].mean(0)
        p = pts - c
        q = p[q_ids]
        d2 = ((q * q).sum(1)[:, None] + (p * p).sum(1)[None, :]
              - 2.0 * _mm(q, p.t().contiguous(), tf32))
        d2[torch.arange(len(blk), device=device), q_ids] = float("inf")
        vals = torch.topk(d2, k, dim=1, largest=False).values
        out.append(torch.sqrt(torch.clamp(vals, min=0.0)).cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def _nearest_direct(pts64: torch.Tensor, q_ids: torch.Tensor, k: int):
    """Indices [m, k + 1] and squared distances of each query's k + 1
    nearest other points, by float64 differences (for the choice of the
    neighbourhood only; the features' arithmetic is `geof_rows`')."""
    idx, dist = [], []
    for s in range(0, len(q_ids), 32):
        q = pts64[q_ids[s:s + 32]]
        d2 = ((pts64[None, :, :] - q[:, None, :]) ** 2).sum(-1)
        d2[torch.arange(len(q), device=q.device), q_ids[s:s + 32]] = \
            float("inf")
        v, i = torch.topk(d2, k + 1, dim=1, largest=False)
        idx.append(i)
        dist.append(v)
    return torch.cat(idx), torch.cat(dist)


def geof_rows(xyz: np.ndarray, rows: np.ndarray, k: int, device,
              tf32: bool = False):
    """(features [m, 4] float64, usable [m, 4] bool, tie [m], gap [m]) of
    `rows` over their k nearest other points: the covariance of the point
    and its neighbours (divided by k + 1) by a matrix product in float32,
    its eigenvalues l1 >= l2 >= l3 in float64, linearity (s1 - s2)/s1,
    planarity (s2 - s3)/s1, scattering s3/s1 (s = sqrt(l), GEOF_EPS under
    the first root), verticality |sum l_i |v_i||'s z share. A feature is
    not usable where the cloud does not fix it to the precision of a
    float32 search: every feature where the k-th and (k+1)-th neighbours'
    squared distances lie within TIE_REL of each other (`tie`, relative),
    and verticality where two eigenvalues lie within EIG_REL of l1
    (`gap`)."""
    pts = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    q_ids = torch.as_tensor(np.asarray(rows), device=device)
    nb, d2 = _nearest_direct(pts.double(), q_ids, k)
    pos = torch.cat([pts[q_ids][:, None, :], pts[nb[:, :k]]], 1)
    cen = pos - pos.mean(1, keepdim=True)
    cov = bmm_t(cen, tf32) / float(k + 1)
    feats, lam = eigen_features(cov)
    tie = (d2[:, k] - d2[:, k - 1]) / d2[:, k].clamp(min=1e-30)
    scale = lam[:, 0].clamp(min=1e-30)
    gap = torch.minimum(lam[:, 0] - lam[:, 1], lam[:, 1] - lam[:, 2]) / scale
    usable = (tie > TIE_REL)[:, None].expand(-1, 4).clone()
    usable[:, 3] &= gap > EIG_REL
    return (feats.cpu().numpy(), usable.cpu().numpy(), tie.cpu().numpy(),
            gap.cpu().numpy())


def eigen_features(cov: torch.Tensor):
    """(features [m, 4] float64, eigenvalues l1 >= l2 >= l3 [m, 3]) of
    covariances [m, 3, 3], as `geof_rows` describes them."""
    lam, vec = torch.linalg.eigh(cov.double())
    lam, vec = lam.flip(-1).clamp(min=0.0), vec.flip(-1)
    s0 = torch.sqrt(lam[:, 0] + GEOF_EPS)
    s1, s2 = torch.sqrt(lam[:, 1]), torch.sqrt(lam[:, 2])
    unary = torch.einsum("ni,nji->nj", lam, vec.abs())
    norm = torch.sqrt((unary * unary).sum(-1) + GEOF_EPS)
    return torch.stack([(s0 - s1) / s0, (s1 - s2) / s0, s2 / s0,
                        unary[:, 2] / norm], -1), lam


def bmm_t(x, tf32):
    """x^T x for each [k, 3] block of x [m, k, 3]."""
    return matmul(x.transpose(1, 2).contiguous(), x, tf32)


def partition_faults(n: int, components, in_component, src, tgt) -> int:
    """Voxels not in exactly one component, or whose component label
    disagrees with the component lists, plus, for each component, the
    pieces beyond one into which the kNN edges inside it split it."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    in_component = np.asarray(in_component, np.int64)
    seen = np.zeros(n, np.int64)
    owner = np.full(n, -1, np.int64)
    for c, comp in enumerate(components):
        comp = np.asarray(comp, np.int64)
        seen[comp] += 1
        owner[comp] = c
    faults = int((seen != 1).sum()) + int((owner != in_component).sum())
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    inside = in_component[src] == in_component[tgt]
    graph = coo_matrix((np.ones(int(inside.sum()), np.int8),
                        (src[inside], tgt[inside])), shape=(n, n))
    _, piece = connected_components(graph, directed=False)
    pairs = np.unique(np.stack([in_component, piece], 1), axis=0)
    pieces = np.bincount(pairs[:, 0], minlength=len(components))
    return faults + int((pieces - 1).clip(min=0).sum())


def round_tf32_np(x: np.ndarray) -> np.ndarray:
    """`model.round_tf32` for NumPy arrays (float32 in, float32 out)."""
    return round_tf32(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                      ).numpy()


def segment_sum(values, ids, n: int, tf32: bool) -> np.ndarray:
    """Sums of `values` [m] or [m, c] by segment id: the product of the
    segments' incidence matrix with the values, accumulated in float64;
    with `tf32` the values are rounded to TF32 first, as a TF32 product
    rounds its inputs."""
    v = np.asarray(values, np.float64)
    if tf32:
        v = round_tf32_np(v).astype(np.float64)
    if v.ndim == 1:
        return np.bincount(ids, v, n)
    return np.stack([np.bincount(ids, v[:, a], n) for a in range(v.shape[1])],
                    1)


def _component_stats(xyz64, in_comp, n_com, tf32):
    """Per component over its distinct points: centroid, and from the
    ddof-1 covariance of the centred points the eigenvalues' length l1,
    surface sqrt(l1 l2), volume sqrt(l1 l2 l3) (1e-10 inside the roots);
    one point: zeros; two: length the root of the summed ddof-0
    variance. Sums by `segment_sum`."""
    order = np.lexsort((xyz64[:, 2], xyz64[:, 1], xyz64[:, 0], in_comp))
    sc, sx = in_comp[order], xyz64[order]
    head = np.ones(len(order), bool)
    head[1:] = (sc[1:] != sc[:-1]) | (sx[1:] != sx[:-1]).any(1)
    ux, uc = sx[head], sc[head]
    cnt = np.bincount(uc, minlength=n_com).astype(np.float64)
    cent = segment_sum(ux, uc, n_com, tf32) / np.maximum(cnt, 1)[:, None]
    d = ux - cent[uc]
    outer = (d[:, :, None] * d[:, None, :]).reshape(-1, 9)
    cov = segment_sum(outer, uc, n_com, tf32).reshape(-1, 3, 3)
    cov /= np.maximum(cnt - 1, 1)[:, None, None]
    lam = np.maximum(np.linalg.eigvalsh(cov)[:, ::-1], 0.0)
    length = lam[:, 0]
    surface = np.sqrt(lam[:, 0] * lam[:, 1] + 1e-10)
    volume = np.sqrt(lam[:, 0] * lam[:, 1] * lam[:, 2] + 1e-10)
    one, two = cnt <= 1, cnt == 2
    var_tr = segment_sum((d * d).sum(1), uc, n_com, tf32) / np.maximum(cnt, 1)
    length = np.where(two, np.sqrt(var_tr), length)
    length = np.where(one, 0.0, length)
    surface = np.where(one | two, 0.0, surface)
    volume = np.where(one | two, 0.0, volume)
    return cent, length, surface, volume


SUPEREDGE_KEYS = ("se_delta_mean", "se_delta_std", "se_delta_norm",
                  "se_delta_centroid", "se_length_ratio", "se_surface_ratio",
                  "se_volume_ratio", "se_point_count_ratio")


def superedges(xyz, in_component, src, tgt, tf32: bool = False) -> dict:
    """The superpoint graph over the kNN adjacency (src -> tgt): every pair
    of components joined by an edge in either direction is a superedge
    (source, target), supported by the distinct directed edges that join
    them; features as the reference's graphs.py: mean, ddof-0 std and mean
    norm of the support's deltas, centroid delta, length, surface, volume
    and point-count ratios (1e-6 added to each denominator). Returns
    {"key": sorted source * n_com + target, feature name: [n_se, c]}."""
    xyz64 = np.asarray(xyz, np.float64)
    in_comp = np.asarray(in_component, np.int64)
    n_com = int(in_comp.max()) + 1
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    cross = in_comp[src] != in_comp[tgt]
    n = len(xyz64)
    e = np.unique(np.concatenate([src[cross] * n + tgt[cross],
                                  tgt[cross] * n + src[cross]]))
    e = np.stack([e // n, e % n])
    key = in_comp[e[0]] * n_com + in_comp[e[1]]
    skeys, sid = np.unique(key, return_inverse=True)
    sid = sid.ravel()
    n_se = len(skeys)
    delta = xyz64[e[0]] - xyz64[e[1]]
    cnt = np.bincount(sid, minlength=n_se).astype(np.float64)
    dmean = segment_sum(delta, sid, n_se, tf32) / cnt[:, None]
    dvar = segment_sum((delta - dmean[sid]) ** 2, sid, n_se, tf32) / cnt[:, None]
    dstd = np.where((cnt <= 1)[:, None], 0.0, np.sqrt(dvar))
    dnorm = segment_sum(np.sqrt((delta ** 2).sum(1)), sid, n_se, tf32) / cnt
    cent, length, surface, volume = _component_stats(xyz64, in_comp, n_com,
                                                     tf32)
    counts = np.bincount(in_comp, minlength=n_com).astype(np.float64)
    cs, ct = skeys // n_com, skeys % n_com
    eps = 1e-6
    return {"key": skeys, "se_delta_mean": dmean, "se_delta_std": dstd,
            "se_delta_norm": dnorm[:, None],
            "se_delta_centroid": cent[cs] - cent[ct],
            "se_length_ratio": (length[cs] / (length[ct] + eps))[:, None],
            "se_surface_ratio": (surface[cs] / (surface[ct] + eps))[:, None],
            "se_volume_ratio": (volume[cs] / (volume[ct] + eps))[:, None],
            "se_point_count_ratio": (counts[cs] / (counts[ct] + eps))[:, None]}


def nearest(db: np.ndarray, queries: np.ndarray, device):
    """For each query: the float32 squared distance (q - p)^2 summed x, y,
    z in that order, to its nearest db point, and a bool [m, n_db]-free
    list of every db index at that distance."""
    p = torch.as_tensor(np.asarray(db, np.float32), device=device)
    out = []
    for s in range(0, len(queries), 64):
        q = torch.as_tensor(np.asarray(queries[s:s + 64], np.float32),
                            device=device)
        d = (q[:, None, 0] - p[None, :, 0]) ** 2
        d = d + (q[:, None, 1] - p[None, :, 1]) ** 2
        d = d + (q[:, None, 2] - p[None, :, 2]) ** 2
        best = d.min(1, keepdim=True).values
        hit = (d == best).nonzero()
        rows = hit[:, 0].cpu().numpy()
        cols = hit[:, 1].cpu().numpy()
        out.extend(np.split(cols, np.flatnonzero(np.diff(rows)) + 1))
    return out
