"""Superpoint sampling and padded collation into an SpgBatch of torch tensors.

Port of the inference half of superpoint_graph_tpu/data/loader.py
(`LoaderConfig`, `pc_attrib_dims`, `select_channels`, `load_superpoint`, the
eval branch of `load_spg_sample`, `collate_spg`; reference learning/spg.py),
whose module imports h5py and the flax model. Superpoint rows come from any
mapping str(id) -> array (data/parsed.py::parsed_entries, or an open parsed
h5 file). Training-time augmentation (graph subsampling, rotations, jitter)
waits for the training port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

from ..device import card_unless
from ..models.spgmodel import SpgBatch

# column layout of parsed superpoint rows (s3dis_dataset.py:151-158)
COL_XYZ = slice(0, 3)
COL_RGB = slice(3, 6)
COL_E = 6
COL_LPSV = slice(7, 11)
COL_XYZN = slice(11, 14)
COL_D = 14


@dataclasses.dataclass
class LoaderConfig:
    ptn_npts: int = 128
    ptn_minpts: int = 40
    pc_attribs: str = "xyzrgbelpsvXYZ"
    pc_xyznormalize: bool = True
    # padded capacities; batches are bucketed to multiples of these
    n_sp_bucket: int = 128
    n_edge_bucket: int = 512
    # unique-edge-feature rows bucket (edge-feature compaction); 0 disables
    n_uniq_bucket: int = 256


def _has_e(pc_attribs: str) -> bool:
    return "e" in pc_attribs.replace("rgb", "").replace("lpsv", "")


def pc_attrib_dims(pc_attribs: str) -> int:
    """Number of point channels the pc_attribs DSL selects."""
    return (3 * ("xyz" in pc_attribs) + 3 * ("rgb" in pc_attribs)
            + _has_e(pc_attribs) + 4 * ("lpsv" in pc_attribs)
            + 3 * ("XYZ" in pc_attribs) + ("d" in pc_attribs))


def select_channels(P: np.ndarray, pc_attribs: str) -> np.ndarray:
    cols = []
    if "xyz" in pc_attribs:
        cols.append(P[:, COL_XYZ])
    if "rgb" in pc_attribs:
        cols.append(P[:, COL_RGB])
    if _has_e(pc_attribs):
        cols.append(P[:, COL_E, None])
    if "lpsv" in pc_attribs:
        cols.append(P[:, COL_LPSV])
    if "XYZ" in pc_attribs:
        cols.append(P[:, COL_XYZN])
    if "d" in pc_attribs:
        cols.append(P[:, COL_D, None])
    return np.concatenate(cols, axis=1)


def load_superpoint(parsed: Mapping, sp_id: int, cfg: LoaderConfig,
                    test_seed_offset: int = 0):
    """One superpoint's rows sampled to exactly ptn_npts with
    RandomState(sp_id + offset) (spg.py:198-236, test time). Returns
    (P [npts, C], diameter) or (None, n) below ptn_minpts."""
    P = parsed[str(sp_id)]
    n = P.shape[0]
    if n < cfg.ptn_minpts:
        return None, n
    P = np.asarray(P[:], np.float32)
    rs = np.random.RandomState(seed=sp_id + test_seed_offset)
    if n > cfg.ptn_npts:
        P = P[rs.choice(n, cfg.ptn_npts), :]
    elif n < cfg.ptn_npts:
        P = np.concatenate([P, P[rs.choice(n, cfg.ptn_npts - n), :]], 0)
    if cfg.pc_xyznormalize:
        diameter = float(np.max(np.max(P[:, :3], 0) - np.min(P[:, :3], 0)))
        P[:, :3] = ((P[:, :3] - P[:, :3].mean(0, keepdims=True))
                    / (diameter + 1e-10))
    else:
        diameter = 0.0
        P[:, :3] = P[:, :3] - P[:, :3].mean(0, keepdims=True)
    if cfg.pc_attribs:
        P = select_channels(P, cfg.pc_attribs)
    return P, np.float32(diameter)


def load_spg_sample(spg_entry, parsed: Mapping, cfg: LoaderConfig,
                    test_seed_offset: int = 0) -> dict | None:
    """Test-time sample of one cloud: every superpoint's point set. Returns
    None for a graph without edges."""
    node_gt, node_gt_size, edges, edge_feats, name = spg_entry
    if len(edges) == 0:
        return None
    k = node_gt.shape[0]
    clouds = np.zeros((k, cfg.ptn_npts, pc_attrib_dims(cfg.pc_attribs)),
                      np.float32)
    globs = np.zeros(k, np.float32)
    flags = np.zeros(k, np.int32)
    for sp in range(k):
        P, diam = load_superpoint(parsed, sp, cfg, test_seed_offset)
        if P is None:
            flags[sp] = -1
        else:
            clouds[sp] = P
            globs[sp] = diam
    return {"node_gt": node_gt, "node_gt_size": node_gt_size, "edges": edges,
            "edge_feats": edge_feats, "clouds": clouds, "clouds_global": globs,
            "cloud_flag": flags, "name": name}


def _bucket(n, b):
    return max(b, int(math.ceil(n / b)) * b)


def collate_spg(samples: Sequence[dict], cfg: LoaderConfig, n_classes: int,
                n_ch: int, device=None) -> SpgBatch:
    """Concatenate per-cloud samples into one padded disconnected union of
    torch tensors on `device` (default: the card), with the edge-feature
    compaction (the fnet runs once per unique feature row; reference
    ecc/utils.py:44-48)."""
    device = card_unless(device)
    n_sp = sum(s["node_gt"].shape[0] for s in samples)
    n_ed = sum(len(s["edges"]) for s in samples)
    cap_sp = _bucket(n_sp, cfg.n_sp_bucket)
    cap_ed = _bucket(max(n_ed, 1), cfg.n_edge_bucket)

    clouds = np.zeros((cap_sp, cfg.ptn_npts, n_ch), np.float32)
    glob = np.zeros((cap_sp, 1), np.float32)
    cloud_mask = np.zeros(cap_sp, bool)
    node_mask = np.zeros(cap_sp, bool)
    targets = np.full(cap_sp, -100, np.int64)
    tsize = np.zeros((cap_sp, n_classes + 1), np.int64)
    src = np.zeros(cap_ed, np.int64)
    tgt = np.zeros(cap_ed, np.int64)
    efeat_dim = samples[0]["edge_feats"].shape[1] if samples else 0
    efeats = np.zeros((cap_ed, efeat_dim), np.float32)
    emask = np.zeros(cap_ed, bool)

    sp_off = ed_off = 0
    for s in samples:
        k = s["node_gt"].shape[0]
        clouds[sp_off:sp_off + k] = s["clouds"]
        glob[sp_off:sp_off + k, 0] = s["clouds_global"]
        cloud_mask[sp_off:sp_off + k] = s["cloud_flag"] == 0
        node_mask[sp_off:sp_off + k] = True
        targets[sp_off:sp_off + k] = s["node_gt"].ravel()
        tsize[sp_off:sp_off + k, :s["node_gt_size"].shape[1]] = s["node_gt_size"]
        e = len(s["edges"])
        if e:
            src[ed_off:ed_off + e] = s["edges"][:, 0] + sp_off
            tgt[ed_off:ed_off + e] = s["edges"][:, 1] + sp_off
            efeats[ed_off:ed_off + e] = s["edge_feats"]
            emask[ed_off:ed_off + e] = True
        sp_off += k
        ed_off += e

    # compaction only where the unique rows' bucket is smaller than the
    # edges' (loader.py:282-299); padding edges map to row 0
    uniq = idx = uniq_mask = None
    if cfg.n_uniq_bucket > 0 and n_ed:
        uniq_rows, inv = np.unique(efeats[:n_ed], axis=0, return_inverse=True)
        cap_eu = _bucket(len(uniq_rows), cfg.n_uniq_bucket)
        if cap_eu < cap_ed:
            uniq = np.zeros((cap_eu, efeat_dim), np.float32)
            uniq[:len(uniq_rows)] = uniq_rows
            idx = np.zeros(cap_ed, np.int64)
            idx[:n_ed] = inv.ravel()
            uniq_mask = np.zeros(cap_eu, bool)
            uniq_mask[:len(uniq_rows)] = True

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return SpgBatch(
        clouds=t(clouds), clouds_global=t(glob), cloud_mask=t(cloud_mask),
        node_mask=t(node_mask), targets=t(targets), target_size=t(tsize),
        src=t(src), tgt=t(tgt), edge_feats=t(efeats), edge_mask=t(emask),
        edge_feat_uniq=t(uniq), edge_feat_idx=t(idx),
        edge_uniq_mask=t(uniq_mask),
    )
