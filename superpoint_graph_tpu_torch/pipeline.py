"""End-to-end geometric partition of point clouds.

Port of superpoint_graph_tpu/pipeline.py (`PartitionConfig`,
`partition_features`, `assemble_partition_features`, `edge_weights`,
`partition_cloud`, `partition_clouds`; reference partition/partition.py:
113-189): voxel prune -> kNN graphs -> geometric features on `device`, then
l0 cut pursuit and the superpoint graph, timed in the same three buckets
(features / partition / spg).

Cut pursuit (`PartitionConfig.cp_backend`):
- "device", the default (the JAX package calls it "tpu"): the JAX package's
  default path. The solver runs over the kNN tables where the search left
  them on `device` and only the labels come back, then the host merge step
  (`_cutpursuit_device_path`). The JAX package feeds clouds below 16,384
  voxels to the same solver from host arrays instead (`cutpursuit_band`),
  for its band's executables; here one path serves every size up to
  CHUNKED_CP_THRESHOLD pruned voxels. Above it the cloud goes to the
  chunked giant-cloud path, `pipeline_big.partition_cloud_big` (as the JAX
  package's `partition_cloud` does), whose result has the same contract.
- "exact": the host max-flow oracle (`ops/cutpursuit.py`).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .device import card_unless
from .graph.spg import compute_sp_graph
from .ops import voxel
from .ops.components import connected_components, group_components
from .ops.cutpursuit import cutpursuit as cutpursuit_exact
from .ops.cutpursuit import merge_regions
from .ops.cutpursuit_band import cutpursuit_band_device
from .ops.geof import compute_geof
from . import pipeline_big
from .ops.knn import compute_graph_nn_2
from .pipeline_big import CHUNKED_CP_THRESHOLD

CP_BACKENDS = ("device", "exact")


@dataclasses.dataclass
class PartitionConfig:
    """The reference partition CLI flags (partition.py:20-31)."""

    k_nn_geof: int = 45
    k_nn_adj: int = 10
    lambda_edge_weight: float = 1.0
    reg_strength: float = 0.03
    d_se_max: float = 0.0
    voxel_width: float = 0.03
    dataset: str = "s3dis"  # controls partition feature assembly
    cp_backend: str = "device"  # 'device' (JAX: 'tpu') | 'exact'
    cp_cutoff: int = 0
    spg_adjacency: str = "delaunay"  # 'delaunay' | 'knn'


@dataclasses.dataclass
class PartitionResult:
    xyz: np.ndarray
    rgb: np.ndarray
    labels: np.ndarray  # per-voxel label histogram (or raw labels)
    geof: np.ndarray
    graph_nn: dict
    components: list
    in_component: np.ndarray
    graph_sp: dict
    times: dict  # features / partition / spg seconds


def partition_features(xyz: np.ndarray, cfg: PartitionConfig, device=None,
                       return_device: bool = False):
    """kNN graphs + geometric features (the 'features' bucket). The geof
    neighbour table stays on `device` (default: the card) between the two;
    returns (graph_nn dict of numpy, geof [n, 4] f32 numpy). With
    `return_device`, also the device tables {"idx", "d2", "geof"} for the
    device cut pursuit."""
    device = card_unless(device)
    graph_nn, target_geof, *dev = compute_graph_nn_2(
        xyz, cfg.k_nn_adj, cfg.k_nn_geof, device=device,
        return_device=return_device)
    xyz_t = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                            device=device)
    geof_t = compute_geof(xyz_t, target_geof)
    geof = geof_t.cpu().numpy()
    if return_device:
        return graph_nn, geof, dict(dev[0], geof=geof_t)
    return graph_nn, geof


def assemble_partition_features(geof: np.ndarray, rgb, cfg: PartitionConfig):
    """Feature vector for cut pursuit (partition.py:164-173): verticality
    doubled; s3dis appends rgb/255."""
    g = geof.copy()
    g[:, 3] *= 2.0
    if cfg.dataset == "s3dis" and rgb is not None and len(rgb) > 0:
        return np.hstack([g, np.asarray(rgb, np.float32) / 255.0]).astype(
            np.float32)
    return g.astype(np.float32)


def _assemble_features_device(geof: torch.Tensor, rgb=None) -> torch.Tensor:
    """assemble_partition_features on the device; `rgb` a uint8 tensor, or
    None for geof alone."""
    g = geof * torch.tensor([1.0, 1.0, 1.0, 2.0], dtype=geof.dtype,
                            device=geof.device)
    if rgb is None:
        return g
    return torch.cat([g, rgb.to(torch.float32) / 255.0], 1)


def edge_weights(distances: np.ndarray, lambda_edge_weight: float) -> np.ndarray:
    """w = 1 / (lambda + d / mean(d))  (partition.py:175)."""
    return np.asarray(
        1.0 / (lambda_edge_weight + distances / distances.mean()), np.float32
    )


def _cutpursuit_device_path(xyz, rgb, graph_nn, dev, cfg: PartitionConfig):
    """The device solve over the kNN tables in `dev` (only the labels come
    back), then the host merge step with unit node weights over the directed
    kNN edges, then the cutoff. Returns (components, in_component int32,
    {"solve": s, "merge": s})."""
    n = len(xyz)
    geof = dev["geof"]
    use_color = cfg.dataset == "s3dis" and rgb is not None and len(rgb) > 0
    t0 = time.perf_counter()
    f_dev = _assemble_features_device(
        geof, torch.as_tensor(np.asarray(rgb, np.uint8), device=geof.device)
        if use_color else None)
    in_comp = cutpursuit_band_device(
        f_dev, dev["idx"][:, :cfg.k_nn_adj], dev["d2"][:, :cfg.k_nn_adj],
        np.asarray(xyz, np.float32), n, cfg.reg_strength,
        lambda_edge_weight=cfg.lambda_edge_weight)
    t1 = time.perf_counter()
    features = assemble_partition_features(
        geof.cpu().numpy(), rgb if use_color else None, cfg)
    src = np.asarray(graph_nn["source"], np.int64)
    tgt = np.asarray(graph_nn["target"], np.int64)
    w = edge_weights(graph_nn["distances"], cfg.lambda_edge_weight)
    in_comp = merge_regions(features, np.ones(n), in_comp, src, tgt, w,
                            float(cfg.reg_strength))
    if cfg.cp_cutoff > 0:
        active = in_comp[src] == in_comp[tgt]
        _, in_comp = connected_components(n, src, tgt, active, cfg.cp_cutoff)
    times = {"solve": t1 - t0, "merge": time.perf_counter() - t1}
    return group_components(in_comp), in_comp.astype(np.int32), times


def prune_stage(xyz, rgb, labels, objects, n_labels, cfg, device):
    """The voxel prune at cfg.voxel_width (none at 0): (xyz, rgb, labels
    histograms)."""
    if cfg.voxel_width > 0:
        n_obj = (int(objects.max()) + 1
                 if objects is not None and np.size(objects) else 0)
        xyz, rgb, labels, _ = voxel.prune(
            xyz, cfg.voxel_width,
            rgb if rgb is not None else np.zeros((len(xyz), 3), np.uint8),
            labels, objects, n_labels, n_obj, device=device,
        )
    return xyz, rgb, labels


def _features_stage(xyz, rgb, labels, objects, n_labels, cfg, device):
    """Prune, then features, keeping the device tables for the device
    solver. Returns (xyz, rgb, labels, graph_nn, geof, dev or None); a
    giant cloud (device solver, above CHUNKED_CP_THRESHOLD voxels) comes
    back pruned with graph_nn None, for `_big`."""
    xyz, rgb, labels = prune_stage(xyz, rgb, labels, objects, n_labels, cfg,
                                   device)
    if cfg.cp_backend == "device" and len(xyz) > CHUNKED_CP_THRESHOLD:
        return xyz, rgb, labels, None, None, None
    graph_nn, geof, *dev = partition_features(
        np.asarray(xyz, np.float32), cfg, device=device,
        return_device=cfg.cp_backend == "device")
    return xyz, rgb, labels, graph_nn, geof, (dev[0] if dev else None)


def _big(xyz, rgb, labels, n_labels, cfg, device, prune_s: float):
    """The pruned giant cloud through `partition_cloud_big` (JAX
    pipeline.py:190-198); the prune's seconds join its features time."""
    res = pipeline_big.partition_cloud_big(xyz, rgb, labels, None, n_labels,
                              dataclasses.replace(cfg, voxel_width=0.0),
                              device=device)
    res.times["features"] += prune_s
    return res


def _partition_stage(xyz, rgb, graph_nn, geof, dev, cfg):
    """Cut pursuit by cfg.cp_backend. Returns (components, in_component,
    sub-stage seconds)."""
    if dev is not None:
        return _cutpursuit_device_path(xyz, rgb, graph_nn, dev, cfg)
    components, in_component = cutpursuit_exact(
        assemble_partition_features(geof, rgb, cfg), graph_nn["source"],
        graph_nn["target"],
        edge_weights(graph_nn["distances"], cfg.lambda_edge_weight),
        cfg.reg_strength, cutoff=cfg.cp_cutoff)
    return components, in_component, {}


def _spg_stage(xyz, labels, n_labels, graph_nn, in_component, cfg, device):
    return compute_sp_graph(
        xyz, cfg.d_se_max, in_component, labels, n_labels,
        adjacency=cfg.spg_adjacency,
        # 'knn' reuses the partition's adjacency edges as superedge support
        knn_edges=((graph_nn["source"], graph_nn["target"])
                   if cfg.spg_adjacency == "knn" else None),
        device=device,
    )


def _result(xyz, rgb, labels, geof, graph_nn, components, in_component,
            graph_sp, times) -> PartitionResult:
    return PartitionResult(
        xyz=np.asarray(xyz),
        rgb=(np.asarray(rgb) if rgb is not None
             else np.zeros((len(xyz), 3), np.uint8)),
        labels=np.asarray(labels) if labels is not None else np.zeros(0),
        geof=geof, graph_nn=graph_nn, components=components,
        in_component=in_component, graph_sp=graph_sp, times=times)


def _check_backend(cfg: PartitionConfig):
    if cfg.cp_backend not in CP_BACKENDS:
        raise ValueError(f"cp_backend={cfg.cp_backend!r}: one of "
                         f"{CP_BACKENDS} ('device' is the JAX package's "
                         "'tpu')")


def partition_cloud(
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    objects: Optional[np.ndarray] = None,
    n_labels: int = 0,
    cfg: PartitionConfig = PartitionConfig(),
    device=None,
) -> PartitionResult:
    """Prune, features, cut pursuit and superpoint graph of one cloud; the
    device stages run on `device` (default: the card). `times` holds the
    three buckets, and for the device solver "partition.solve" (the device
    solve, labels fetched) and "partition.merge" (host merge step). Above
    CHUNKED_CP_THRESHOLD pruned voxels (device solver) the result is
    `pipeline_big.partition_cloud_big`'s, with its times."""
    _check_backend(cfg)
    device = card_unless(device)
    t0 = time.perf_counter()
    xyz, rgb, labels, graph_nn, geof, dev = _features_stage(
        xyz, rgb, labels, objects, n_labels, cfg, device)
    if graph_nn is None:
        return _big(xyz, rgb, labels, n_labels, cfg, device,
                    time.perf_counter() - t0)
    times = {"features": time.perf_counter() - t0}
    t0 = time.perf_counter()
    components, in_component, sub = _partition_stage(
        xyz, rgb, graph_nn, geof, dev, cfg)
    times["partition"] = time.perf_counter() - t0
    times.update({f"partition.{k}": v for k, v in sub.items()})
    t0 = time.perf_counter()
    graph_sp = _spg_stage(xyz, labels, n_labels, graph_nn, in_component, cfg,
                          device)
    times["spg"] = time.perf_counter() - t0
    return _result(xyz, rgb, labels, geof, graph_nn, components, in_component,
                   graph_sp, times)


def partition_clouds(clouds, cfg: PartitionConfig = PartitionConfig(),
                     n_labels: int = 0, device=None) -> list:
    """Partition a sequence of clouds with a 2-stage software pipeline: the
    feature stage (prune, kNN, geof) of cloud i+1 runs in a worker thread
    while cloud i is solved and its SPG built. The reference processes files
    strictly serially (partition.py:57-113).

    `clouds` yields (xyz, rgb, labels, objects) tuples; returns a list of
    PartitionResult, whose "features" time is 0 (overlapped)."""
    _check_backend(cfg)
    device = card_unless(device)
    clouds = list(clouds)
    results = []

    def stage_a(args):
        return _features_stage(*args, n_labels, cfg, device)

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage_a, clouds[0]) if clouds else None
        for i in range(len(clouds)):
            xyz, rgb, labels, graph_nn, geof, dev = fut.result()
            if i + 1 < len(clouds):
                fut = pool.submit(stage_a, clouds[i + 1])
            if graph_nn is None:
                results.append(_big(xyz, rgb, labels, n_labels, cfg, device,
                                    0.0))
                continue
            t0 = time.perf_counter()
            components, in_component, sub = _partition_stage(
                xyz, rgb, graph_nn, geof, dev, cfg)
            times = {"features": 0.0, "partition": time.perf_counter() - t0}
            times.update({f"partition.{k}": v for k, v in sub.items()})
            t0 = time.perf_counter()
            graph_sp = _spg_stage(xyz, labels, n_labels, graph_nn,
                                  in_component, cfg, device)
            times["spg"] = time.perf_counter() - t0
            results.append(_result(xyz, rgb, labels, geof, graph_nn,
                                   components, in_component, graph_sp, times))
    return results
