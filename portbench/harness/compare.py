"""The comparisons that decide `correct`, and the verdict against limits.

Every number is either a count of answers that differ (an exact
comparison, limit 0) or the widest gap between the program's answers and
the reference's, in the unit its docstring gives. The limits of a cell are
in portbench/limits/<cell>.json, each set between the readings of sound
runs and of the control (PERF.md gives both).
"""
from __future__ import annotations

import numpy as np

from ..reference.cloud import SUPEREDGE_KEYS

# prune_off: a voxel's mean xyz differs where it lies this far (m) from the
# reference's float64 mean; the program's float32 sums in point order lie
# within some 1e-5 m of it at the scan's 27-m coordinates
XYZ_TOL = 1e-3

# the superedge features `spg_err` compares: those whose arithmetic is sums
# (segment sums, which the control takes as TF32 products). The length,
# surface and volume ratios come from eigenvalues of the components'
# covariances; input rounding barely moves those, so no control separates
# them from the program's float32 eigen-solver (PERF.md gives both
# readings), and they are not compared.
COMPARED_SUPEREDGE_KEYS = ("se_delta_mean", "se_delta_std", "se_delta_norm",
                           "se_delta_centroid", "se_point_count_ratio")


def max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def logit_err(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap between two [superpoints, classes] logit tables, over
    the reference's largest logit in magnitude."""
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rows_off(got: list, want: list) -> int:
    """Rows where any of the paired arrays differ, plus the difference in
    row counts."""
    n = min(len(g) for g in got + want)
    diff = np.zeros(n, bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g)[:n], np.asarray(w)[:n]
        diff |= (g != w).reshape(n, -1).any(1)
    return int(diff.sum()) + max(len(g) for g in got + want) - n


def prune_off(part, vox: dict) -> int:
    """Voxels whose mean xyz (beyond XYZ_TOL), truncated mean colour or
    label histogram differs from the reference's, plus the difference in
    voxel counts."""
    got = [np.abs(np.asarray(part.xyz, np.float64)[:len(vox["xyz"])]
                  - vox["xyz"][:len(part.xyz)]) > XYZ_TOL, part.rgb]
    want = [np.zeros_like(got[0]), vox["rgb"]]
    if vox["hist"] is not None:
        got.append(np.asarray(part.labels, np.int64))
        want.append(vox["hist"])
    return rows_off(got, want)


def batch_off(got: dict, want: dict) -> int:
    """Superpoints whose sampled rows, diameter or embeddability differ
    between the model's input `got` (tensors) and the reference loader's
    `want` (reference/loader.py), superedges whose ends or features
    differ, and the differences in their counts: a sound loader gives the
    same arrays bit for bit."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    n_g, n_w = len(g["clouds"]), len(want["clouds"])
    return (rows_off([g["clouds"].reshape(n_g, -1), g["diameters"],
                      g["embeddable"]],
                     [want["clouds"].reshape(n_w, -1), want["diameters"],
                      want["embeddable"]])
            + rows_off([g["src"], g["tgt"], g["edge_feats"]],
                       [want["src"], want["tgt"], want["edge_feats"]]))


def program_superedges(graph_sp: dict) -> dict:
    """The program's superpoint graph as `reference.cloud.superedges`
    returns it: sorted by key."""
    src = np.asarray(graph_sp["source"], np.int64).ravel()
    tgt = np.asarray(graph_sp["target"], np.int64).ravel()
    n_com = len(graph_sp["sp_point_count"])
    key = src * n_com + tgt
    order = np.argsort(key, kind="stable")
    out = {"key": key[order]}
    for k in SUPEREDGE_KEYS:
        v = np.asarray(graph_sp[k], np.float64)
        out[k] = v.reshape(len(key), -1)[order]
    return out


def superedge_diff(got: dict, want: dict):
    """(superedges in one graph and not the other, the widest gap of a
    shared superedge's feature among COMPARED_SUPEREDGE_KEYS, each over
    |reference| + the median |reference| of its column)."""
    common, gi, wi = np.intersect1d(got["key"], want["key"],
                                    return_indices=True)
    off = len(got["key"]) + len(want["key"]) - 2 * len(common)
    err = 0.0
    for k in COMPARED_SUPEREDGE_KEYS:
        g, w = got[k][gi], want[k][wi]
        if not len(w):
            continue
        scale = np.abs(w) + np.median(np.abs(w), 0)[None, :]
        err = max(err, float((np.abs(g - w) / np.maximum(scale, 1e-30)).max()))
    return int(off), err


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and every limit's number present."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok &= bool(good)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
