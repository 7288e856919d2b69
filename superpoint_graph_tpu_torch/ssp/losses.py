"""Graph-structured contrastive losses for learned partitions.

Port of superpoint_graph_tpu/ssp/losses.py (reference
supervized_partition/losses.py):
  * compute_dist: per-edge embedding distances, euclidian (squared L2),
    intrinsic (normalised arccos of the dot product) or scalar (dot - 1);
  * compute_loss: the intra-edge term tv (sqrt), laplacian (square) or TVH
    (pseudo-Huber, delta 0.2), and the inter-edge push, zhang's hinge
    max(0, -lam x + lam beta) (beta 1, or pi/3 for intrinsic) or TVminus;
    masked sums on tensors, differentiable;
  * compute_partition: cut pursuit on [embeddings | spatial_emb * xyz] with
    edge weights from edge_weight_threshold (> 0: edges of distance > 1
    take the threshold; < 0: exp(diff t) / exp(t)), reg = reg_strength /
    (4 k_nn_adj). cp_backend "exact" is the host solver; "device" the
    port's device solver (ops/cutpursuit_band.py; the JAX "tpu"), Morton
    ordered by xyz, with the JAX host-array pad rows;
  * weighting: none / proportional / SEAL (per-component impurity) /
    crosspartition (components of the graph cut by neither the ground
    truth nor the prediction; each transition superedge between two of
    them weighs min(|C1|, |C2|) / |superedge| * factor), host numpy;
  * relax_edge_binary: transition masks dilated for BR/BP's tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import card_unless
from ..ops.components import connected_components
from ..ops.cutpursuit import cutpursuit as cutpursuit_exact
from ..ops.cutpursuit_band import cutpursuit_band

CP_BACKENDS = ("exact", "device")


@dataclasses.dataclass
class SspLossConfig:
    loss: str = "TVH_zhang"
    dist_type: str = "euclidian"
    loss_weight: str = "crosspartition"
    transition_factor: float = 5.0
    edge_weight_threshold: float = -0.5
    spatial_emb: float = 0.2
    reg_strength: float = 0.8
    k_nn_adj: int = 5
    CP_cutoff: int = 25
    cp_backend: str = "exact"  # the in-loop partition: "exact" | "device"


def zhang(x, lam, dist_type: str):
    beta = 1.0471975512 if dist_type == "intrinsic" else 1.0
    return torch.clamp(-lam * x + lam * beta, min=0.0)


def compute_dist(embeddings: torch.Tensor, edg_source: torch.Tensor,
                 edg_target: torch.Tensor, dist_type: str) -> torch.Tensor:
    es = embeddings[edg_source]
    et = embeddings[edg_target]
    if dist_type == "euclidian":
        return ((es - et) ** 2).sum(1)
    if dist_type == "intrinsic":
        smoothness = 0.999
        dot = (es * et).sum(1) * smoothness
        return ((torch.arccos(dot) - np.arccos(smoothness))
                / (np.arccos(-smoothness) - np.arccos(smoothness)) * np.pi)
    if dist_type == "scalar":
        return (es * et).sum(1) - 1.0
    raise ValueError(f"unknown dist_type {dist_type!r}")


def compute_loss(cfg: SspLossConfig, diff: torch.Tensor,
                 is_transition: torch.Tensor, weights_loss: torch.Tensor):
    """(intra_loss, inter_loss) as losses.py:44-64, masked sums over the
    edges (the reference indexes the two sets out)."""
    intra = (is_transition == 0).to(diff.dtype)
    inter = (is_transition == 1).to(diff.dtype)
    w_intra = weights_loss * intra
    w_inter = weights_loss * inter
    if "TVH" in cfg.loss:
        delta = 0.2
        loss1 = delta * (w_intra * (torch.sqrt(1.0 + diff / delta ** 2)
                                    - 1.0)).sum()
    elif "tv" in cfg.loss:
        loss1 = (w_intra * torch.sqrt(diff + 1e-10)).sum()
    elif "laplacian" in cfg.loss:
        loss1 = (w_intra * diff).sum()
    else:
        raise ValueError(f"unknown intra loss in {cfg.loss!r}")
    if "zhang" in cfg.loss:
        loss2 = (inter * zhang(torch.sqrt(diff + 1e-10), w_inter,
                               cfg.dist_type)).sum()
    elif "TVminus" in cfg.loss:
        loss2 = (w_inter * torch.sqrt(diff + 1e-10)).sum()
    else:
        raise ValueError(f"unknown inter loss in {cfg.loss!r}")
    return loss1, loss2


def compute_partition(cfg: SspLossConfig, embeddings, edg_source, edg_target,
                      diff, xyz=None, device=None):
    """Cut pursuit on learned embeddings (losses.py:67-89), host arrays in
    and out. The device backend solves on `device` (default: the card)."""
    embeddings = np.asarray(embeddings)
    diff = np.asarray(diff)
    edge_weight = np.ones(len(edg_source), np.float32)
    if cfg.edge_weight_threshold > 0:
        edge_weight[diff > 1] = cfg.edge_weight_threshold
    elif cfg.edge_weight_threshold < 0:
        edge_weight = (np.exp(diff * cfg.edge_weight_threshold)
                       / np.exp(cfg.edge_weight_threshold)).astype(np.float32)
    ver_value = embeddings.astype(np.float32)
    if cfg.spatial_emb > 0 and xyz is not None:
        ver_value = np.hstack([ver_value, (cfg.spatial_emb * np.asarray(xyz))
                               .astype(np.float32)])
    # the JAX call's weight_decay (0.7) is both solvers' default, and its
    # `spatial` flag changes nothing in either
    if cfg.cp_backend == "device":
        # Morton order by position, the global accept (the JAX choice for
        # these in-loop solves of <= 10k vertices a cloud)
        solver = cutpursuit_band
        kw = {"xyz": None if xyz is None else np.asarray(xyz, np.float32),
              "device": card_unless(device)}
    elif cfg.cp_backend == "exact":
        solver, kw = cutpursuit_exact, {}
    else:
        raise ValueError(f"cp_backend {cfg.cp_backend!r}: one of "
                         f"{CP_BACKENDS}")
    return solver(ver_value, np.asarray(edg_source, np.int64),
                  np.asarray(edg_target, np.int64), edge_weight,
                  cfg.reg_strength / (4 * cfg.k_nn_adj), cutoff=cfg.CP_cutoff,
                  **kw)


def _mode_freq(array):
    _, counts = np.unique(array, return_counts=True)
    return counts.max()


def compute_weights_SEAL(pred_components, pred_in_component, objects,
                         edg_source, edg_target, is_transition,
                         transition_factor):
    """Per-component impurity weighting (losses.py:119-128)."""
    w = np.ones(len(edg_source), np.float32)
    per_comp = np.array(
        [len(c) - _mode_freq(objects[np.asarray(c, np.int64)])
         for c in pred_components], dtype=np.float32)
    tr = np.flatnonzero(is_transition)
    w[tr] += np.maximum(per_comp[pred_in_component[edg_source[tr]]],
                        per_comp[pred_in_component[edg_target[tr]]]
                        ) * transition_factor
    return w


def compute_weights_XPART(pred_components, pred_in_component, objects,
                          edg_source, edg_target, is_transition,
                          transition_factor):
    """Cross-partition weighting (losses.py:130-166), by sorted superedge
    keys: each transition edge between the intersection components C1, C2
    gains min(|C1|, |C2|) / (edges between them) * factor."""
    n = len(pred_in_component)
    pred_transition = (pred_in_component[edg_source]
                       != pred_in_component[edg_target])
    keep = (np.asarray(is_transition) + pred_transition) == 0
    comps_x, in_comp_x = connected_components(n, edg_source, edg_target,
                                              keep, 0)
    sizes = np.bincount(in_comp_x)
    w = np.ones(len(edg_source), np.float32)
    tr = np.flatnonzero(is_transition)
    if len(tr) == 0:
        return w
    c1 = in_comp_x[edg_source[tr]].astype(np.int64)
    c2 = in_comp_x[edg_target[tr]].astype(np.int64)
    n_compx = len(comps_x)
    key = np.minimum(c1, c2) * n_compx + np.maximum(c1, c2)
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    min_size = np.minimum(sizes[uniq // n_compx], sizes[uniq % n_compx])
    w[tr] += (min_size[inv] / cnt[inv] * transition_factor).astype(np.float32)
    return w


def compute_weight_loss(cfg: SspLossConfig, embeddings, objects, edg_source,
                        edg_target, is_transition, diff, return_partition,
                        xyz=None, device=None):
    """losses.py:91-117 (host): the loss weights [E], and with
    `return_partition` the in-loop partition (components, in_component)."""
    pred_components = pred_in_component = None
    if cfg.loss_weight in ("seal", "crosspartition") or return_partition:
        pred_components, pred_in_component = compute_partition(
            cfg, embeddings, edg_source, edg_target, diff, xyz, device)
    is_tr = np.asarray(is_transition)
    if cfg.loss_weight == "none":
        w = np.ones(len(edg_target), np.float32)
    elif cfg.loss_weight == "proportional":
        w = np.ones(len(edg_target), np.float32) * (
            float(len(is_tr)) / max((1 - is_tr).sum(), 1))
        w[is_tr.nonzero()] = (float(len(is_tr)) / max(float(is_tr.sum()), 1.0)
                              * cfg.transition_factor)
    elif cfg.loss_weight == "seal":
        w = compute_weights_SEAL(
            pred_components, pred_in_component, np.asarray(objects),
            edg_source, edg_target, is_tr, cfg.transition_factor)
    elif cfg.loss_weight == "crosspartition":
        w = compute_weights_XPART(
            pred_components, pred_in_component, np.asarray(objects),
            edg_source, edg_target, is_tr,
            cfg.transition_factor * 2 * cfg.k_nn_adj)
    else:
        raise ValueError(f"unknown loss_weight {cfg.loss_weight!r}")
    if return_partition:
        return w, pred_components, pred_in_component
    return w


def relax_edge_binary(edg_binary, edg_source, edg_target, n_ver, tolerance):
    """A transition-edge mask dilated `tolerance` hops (losses.py:175-186)."""
    relaxed = np.asarray(edg_binary).copy().astype(bool)
    vertex = np.zeros(n_ver, bool)
    for _ in range(tolerance):
        vertex[edg_source[relaxed]] = True
        vertex[edg_target[relaxed]] = True
        relaxed |= vertex[edg_source] | vertex[edg_target]
    return relaxed
