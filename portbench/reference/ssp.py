"""The learned partition (SSP) in plain PyTorch and NumPy, for the checks
of the vKITTI3D frame cell.

Landrieu & Boussaha, "Point Cloud Oversegmentation with Graph-Structured
Deep Metric Learning", CVPR 2019 (arXiv 1904.02113), with the layers and
steps of loicland/superpoint_graph's supervized_partition
(supervized_partition.py:411-434, learning/pointnet.py:182-218,
graph_processing.py:347-436, losses.py:67-89, partition/graphs.py:75-109):

- `read_frame`: a vKITTI3D frame's rows, labels shifted by one and the
  don't-care class made 0;
- `plane_elevation`: each voxel's height above the RANSAC ground plane of
  the voxels near the lowest;
- `local_clouds`: each voxel's k_nn_local nearest other voxels (a float64
  k-d tree search) centred on it and scaled by their diameter, with their
  colours, and the voxel's global features (diameter, elevation, colour,
  xy normalised to the frame's box);
- `embed`: the LocalEmbedder: a 2x2 spatial transformer over the local
  clouds' xy, xy @ T, a PointNet with the global features and T appended
  before its dense layers, the output L2-normalised (`F.normalize`);
- `partition_graph`: the cut pursuit's values [embeddings | spatial_emb *
  xyz] and the directed kNN edges weighted exp(-0.5 d) / exp(-0.5), d the
  squared embedding distance, for `reference/partition.py`'s energy and
  greedy solver (reg = reg_strength / (4 k_nn_adj));
- `cutoff_fuse`: the cut pursuit's CP_cutoff, components of fewer voxels
  merged into a neighbour (libcp CutPursuit.h `cutoff`);
- `delaunay_edges`: the Delaunay tetrahedra's edges no longer than d_max,
  the superedges' support (`reference/cloud.superedges` groups them).

Everything is float32 on the device with TF32 off, but the neighbour
search, the edge weights and the energy (float64). Parameters are a dict
keyed by the LocalEmbedder's state-dict names (`embedder_specs`), drawn by
the benchmark (harness/frames.py). Batch norm: running statistics (eval
mode). Nothing of the measured program is imported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from scipy.linalg import lstsq

from .model import _mlp_point, batch_norm, bmm, linear
from .partition import neighbours

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the value the edge weights take the embedding distance at
# (edge_weight_threshold, losses.py:71-75)
EDGE_WEIGHT_THRESHOLD = -0.5
# the rounds of merges `cutoff_fuse` makes at most (CutPursuit.h `cutoff`)
CUTOFF_ROUNDS = 50


def read_frame(path: str):
    """(xyz f32, rgb f32, labels int64) of a vKITTI3D frame (.npy rows
    [x y z r g b ... label]): labels + 1, and 14 (the don't-care class 13)
    made 0 (provider.py:219-227)."""
    data = np.load(path)
    labels = data[:, -1].astype(np.int64) + 1
    labels[labels == 14] = 0
    return (np.ascontiguousarray(data[:, :3], np.float32),
            np.ascontiguousarray(data[:, 3:6], np.float32), labels)


def n_global(cfg: dict) -> int:
    """The global features a voxel brings (without T): diameter, then
    elevation, colour, XY and xy as `global_feat` names them."""
    gf = cfg["global_feat"]
    return (1 + ("e" in gf.replace("rgb", "")) + 3 * ("rgb" in gf)
            + 2 * ("XY" in gf) + 2 * ("xy" in gf.replace("XY", "")))


def embedder_specs(cfg: dict) -> list:
    """[(name, shape, kind)] of the LocalEmbedder in `cfg` (a
    configuration's "embedder" entry), kinds as reference/model.py's."""
    specs = []

    def lin(name, n_in, n_out, conv=False):
        specs.append((f"{name}.weight",
                      (n_out, n_in, 1) if conv else (n_out, n_in), "weight"))
        specs.append((f"{name}.bias", (n_out,), "bias"))

    def bn(name, n):
        specs.extend([(f"{name}.weight", (n,), "bn_weight"),
                      (f"{name}.bias", (n,), "bn_bias"),
                      (f"{name}.running_mean", (n,), "bn_mean"),
                      (f"{name}.running_var", (n,), "bn_var")])

    def stack(prefix, n, widths, conv, last_bn=True):
        for i, w in enumerate(widths):
            lin(f"{prefix}.{3 * i}", n, w, conv)
            if last_bn or i < len(widths) - 1:
                bn(f"{prefix}.{3 * i + 1}", w)
            n = w
        return n

    if cfg["ptn_norm"] != "batch" or cfg.get("ptn_prelast_do", 0):
        raise NotImplementedError("the embedder with batch norm, no dropout")
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    n = stack("stn.convs", cfg["ptn_nfeat_stn"], stn_conv_w, True)
    n = stack("stn.fcs", n, stn_fc_w, False)
    specs.append(("stn.proj.weight", (4, n), "stn_proj"))
    specs.append(("stn.proj.bias", (4,), "bias"))
    n_feat = 3 + 3 * bool(cfg["use_rgb"])
    n = stack("ptn.convs", n_feat, conv_w, True)
    n += n_global(cfg) + 4 * bool(cfg["stn_as_global"])
    stack("ptn.fcs", n, fc_w, False, last_bn=False)
    return specs


def plane_elevation(xyz: np.ndarray, low: float = 0.5) -> np.ndarray:
    """z above the ground plane z = a x + b y + c of the voxels within
    `low` of the lowest z (s3dis_dataset.py:127-133, graph_processing.py),
    which the reference fits by RANSACRegressor(random_state=0) (sklearn,
    which the card's machine has not): `ransac_plane`, in the voxels'
    float32 as sklearn keeps it."""
    xyz = np.asarray(xyz, np.float32)
    pts = xyz[xyz[:, 2] - xyz[:, 2].min() < low]
    coef, icpt = ransac_plane(pts[:, :2], pts[:, 2])
    return xyz[:, 2] - (xyz[:, :2] @ coef + icpt)


def ransac_plane(x: np.ndarray, y: np.ndarray, trials: int = 100,
                 stop: float = 0.99):
    """(coefficients, intercept) of RANSACRegressor(random_state=0).fit(x,
    y) with its LinearRegression: inliers within the median absolute
    deviation of y; at most `trials` trials, fewer as the best one's
    inlier share allows at stop probability `stop`; a trial fits three
    points drawn by RandomState(0) (sklearn's sample_without_replacement:
    a permutation where 3 / n lies in (0.01, 0.99), else distinct draws)
    and wins with more inliers, or as many and an R^2 on them no lower;
    the winner's inliers are fitted again."""
    n = len(y)
    threshold = np.median(np.abs(y - np.median(y)))
    rs = np.random.RandomState(0)
    best_n, best_r2, best = 1, -np.inf, None
    t = 0
    while t < trials:
        t += 1
        if 0.01 < 3 / n < 0.99:
            pick = rs.permutation(n)[:3]
        else:
            pick = []
            while len(pick) < 3:
                j = rs.randint(n)
                if j not in pick:
                    pick.append(j)
        coef, icpt = _least_squares(x[pick], y[pick])
        inl = np.abs(y - (x @ coef + icpt)) <= threshold
        n_in = int(inl.sum())
        if n_in < best_n:
            continue
        r2 = _r2(x[inl] @ coef + icpt, y[inl])
        if n_in == best_n and r2 < best_r2:
            continue
        best_n, best_r2, best = n_in, r2, inl
        share = n_in / n
        fail = max(np.spacing(1), 1 - share ** 3)
        trials = min(trials, float("inf") if fail == 1 else abs(float(
            np.ceil(np.log(max(np.spacing(1), 1 - stop)) / np.log(fail)))))
    return _least_squares(x[best], y[best])


def _least_squares(x, y):
    """(coefficients, intercept): least squares with an intercept, on the
    centred data by LAPACK's gelsd (LinearRegression)."""
    xm, ym = x.mean(0), y.mean()
    coef = lstsq(x - xm, y - ym)[0]
    return coef.astype(x.dtype), ym - xm @ coef.astype(x.dtype)


def _r2(pred, y) -> float:
    """R^2 (r2_score): 1 where the fit is exact, 0 where y is constant and
    the fit is not."""
    num = float(((y - pred) ** 2).sum())
    den = float(((y - y.mean()) ** 2).sum())
    if num == 0:
        return 1.0
    return 0.0 if den == 0 else 1 - num / den


def local_clouds(xyz64: np.ndarray, rgb: np.ndarray, elevation: np.ndarray,
                 cfg: dict, k_local: int):
    """(clouds [n, k_local, 6] f32, globals [n, G] f32, neighbours [n,
    k_local], tie gap [n]) of voxels `xyz64` (float64) with colours `rgb`
    (0..255) and elevation: graph_processing.py:378-418 on a float64
    neighbour search. Colours are scaled to 0..1; XY is the voxels' xy
    over the frame's box. The tie gap is how much farther a voxel's next
    neighbour lies than its last: where it is within a search's rounding,
    another search may take the next one."""
    nbr, dist = neighbours(xyz64, k_local + 1)
    gap = dist[:, k_local] - dist[:, k_local - 1]
    nbr = np.ascontiguousarray(nbr[:, :k_local])
    xyz = xyz64.astype(np.float32)
    rgb = np.asarray(rgb, np.float32) / 255.0
    pts = xyz[nbr]
    diam = np.sqrt(pts.var(1).sum(1))
    clouds = (pts - xyz[:, None, :]) / (diam[:, None, None] + 1e-10)
    if cfg["use_rgb"]:
        clouds = np.concatenate([clouds, rgb[nbr]], 2)
    gf = cfg["global_feat"]
    cols = [diam[:, None]]
    if "e" in gf.replace("rgb", ""):
        cols.append(np.asarray(elevation, np.float32)[:, None])
    if "rgb" in gf:
        cols.append(rgb)
    if "XY" in gf:
        mi, ma = xyz[:, :2].min(0), xyz[:, :2].max(0)
        cols.append((xyz[:, :2] - mi) / (ma - mi + 1e-8))
    if "xy" in gf.replace("XY", ""):
        cols.append(xyz[:, :2])
    return (clouds.astype(np.float32),
            np.hstack(cols).astype(np.float32), nbr, gap)


def embed(p: dict, cfg: dict, clouds, globals_, tf32: bool = False,
          block: int = 1 << 16) -> torch.Tensor:
    """Unit embeddings [n, out] of local clouds [n, k, C] with their
    global features [n, G] (tensors on one device), in blocks of `block`
    voxels (eval mode: the rows are independent)."""
    out = []
    for s in range(0, len(clouds), block):
        out.append(_embed(p, cfg, clouds[s:s + block],
                          globals_[s:s + block], tf32))
    return torch.cat(out)


def _embed(p, cfg, clouds, globals_, tf32):
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    h = _mlp_point(p, "stn.convs", clouds[..., :cfg["ptn_nfeat_stn"]],
                   stn_conv_w, tf32).amax(1)
    h = _mlp_point(p, "stn.fcs", h, stn_fc_w, tf32)
    t = linear(h, p["stn.proj.weight"], p["stn.proj.bias"], tf32)
    t = t.reshape(-1, 2, 2) + torch.eye(2, dtype=t.dtype, device=t.device)
    x = torch.cat([bmm(clouds[..., :2], t, tf32), clouds[..., 2:]], -1)
    x = _mlp_point(p, "ptn.convs", x, conv_w, tf32).amax(1)
    g = [x, globals_] + ([t.reshape(-1, 4)] if cfg["stn_as_global"] else [])
    x = torch.cat(g, 1)
    for i in range(len(fc_w)):
        x = linear(x, p[f"ptn.fcs.{3 * i}.weight"], p[f"ptn.fcs.{3 * i}.bias"],
                   tf32)
        if i < len(fc_w) - 1:
            x = torch.relu(batch_norm(p, f"ptn.fcs.{3 * i + 1}", x))
    return F.normalize(x)


def partition_graph(emb: np.ndarray, xyz64: np.ndarray, nbr_adj: np.ndarray,
                    spatial_emb: float) -> dict:
    """{"f", "src", "tgt", "w"} of reference/partition.py: values
    [emb | spatial_emb * xyz], the directed kNN edges (each voxel to its
    k_nn_adj nearest others, `nbr_adj`) weighted exp(t d) / exp(t), d the
    squared distance of their ends' embeddings and t
    EDGE_WEIGHT_THRESHOLD; all float64."""
    e = np.asarray(emb, np.float64)
    n, k = nbr_adj.shape
    src = np.repeat(np.arange(n), k)
    tgt = nbr_adj.reshape(-1).astype(np.int64)
    d = ((e[src] - e[tgt]) ** 2).sum(1)
    t = EDGE_WEIGHT_THRESHOLD
    return {"f": np.hstack([e, spatial_emb * xyz64]), "src": src, "tgt": tgt,
            "w": np.exp(d * t) / np.exp(t)}


def cutoff_fuse(g: dict, comp: np.ndarray, reg: float,
                cutoff: int) -> np.ndarray:
    """The partition `comp` of the graph `g` (`partition_graph`) with its
    components of fewer than `cutoff` voxels merged away, as libcp's
    cutoff does after the cut pursuit (CutPursuit.h `cutoff`, `merge`
    with is_cutoff): in each round every pair of adjacent components of
    which one is that small is a candidate; the candidates are taken in
    the order of least change of E (then pair order), each component
    merging at most once a round; until no component that small has a
    neighbour, CUTOFF_ROUNDS rounds at most."""
    f, src, tgt, w = g["f"], g["src"], g["tgt"], g["w"]
    comp = np.unique(np.asarray(comp, np.int64), return_inverse=True)[1]
    comp = comp.ravel()
    for _ in range(CUTOFF_ROUNDS):
        n = int(comp.max()) + 1
        m = np.bincount(comp, minlength=n).astype(np.float64)
        s = np.stack([np.bincount(comp, f[:, c], minlength=n)
                      for c in range(f.shape[1])], 1)
        a, b = comp[src], comp[tgt]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        cross = lo != hi
        key, inv = np.unique(lo[cross] * n + hi[cross], return_inverse=True)
        wk = np.bincount(inv.ravel(), w[cross], minlength=len(key))
        pa, pb = key // n, key % n
        small = np.minimum(m[pa], m[pb]) < cutoff
        if not small.any():
            break
        pa, pb, wk = pa[small], pb[small], wk[small]
        diff = s[pa] / m[pa, None] - s[pb] / m[pb, None]
        change = (m[pa] * m[pb] / (m[pa] + m[pb]) * (diff * diff).sum(1)
                  - reg * wk)
        merged = np.zeros(n, bool)
        parent = np.arange(n)
        for i in np.argsort(change, kind="stable").tolist():
            x, y = int(pa[i]), int(pb[i])
            if not (merged[x] or merged[y]):
                merged[x] = merged[y] = True
                parent[y] = x
        comp = np.unique(parent[comp], return_inverse=True)[1].ravel()
    return comp


def delaunay_edges(xyz: np.ndarray, d_max: float):
    """(src, tgt) of the Delaunay tetrahedra's six edges each, both ways,
    shorter than d_max (graphs.py:82-109, 112-116)."""
    from scipy.spatial import Delaunay

    tets = Delaunay(np.asarray(xyz)).simplices
    a = np.concatenate([tets[:, i] for i, _ in _PAIRS])
    b = np.concatenate([tets[:, j] for _, j in _PAIRS])
    pts = np.asarray(xyz, np.float64)
    keep = np.sqrt(((pts[a] - pts[b]) ** 2).sum(1)) < d_max
    a, b = a[keep].astype(np.int64), b[keep].astype(np.int64)
    return np.concatenate([a, b]), np.concatenate([b, a])


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
