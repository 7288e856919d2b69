"""Label one raw Semantic3D scan end to end: the port's large-scale serving path.

The counterpart of `room.label_room` for the reference's Semantic3D recipe
(docs/DATASETS.md, reduced-8), following the JAX package's CLIs:
`read_semantic3d_format` in chunks of `ver_batch` raw rows, each pruned at
0.05 m on the device (cli/partition.py:118-129) -> `partition_cloud` at
reg_strength 0.8, k 45/10, with no second prune; past 2^19 voxels it runs
the giant-cloud path (`pipeline_big.partition_cloud_big`: sorted-cell kNN,
chunked device cut pursuit with its heal, device SPG) -> superpoint point
sets in the 11-column Semantic3D rows, pc_attribs "xyzrgbelpsv" -> the
flagship Semantic3D SpgModel (`gru_10,f_8`, 8 classes; cli/train.py:62,
datasets.py:87) -> per-voxel classes 1..8 (`reduced_labels2full` of the
superpoint classes + 1, cli/write_semantic3d.py:55-58) -> every raw point's
class by `interpolate_labels_batch` (one nn1 kernel call per chunk of raw
rows). The text is parsed once: the reader's float32 `x y z` chunks are held
on the host until the spread, 12 bytes a raw point (96 MB for 8e6 points,
about 1.2 GB for 1e8), and released once it has returned; the card holds
none of them but the chunk the spread is labelling. Each stage's wall time
is recorded (`utils/tracing.stage`), synchronised with the card when
`device` is CUDA. With tracing on, the scan is the root span `spgt.cloud`.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .data.loader import LoaderConfig
from .data.provider import (interpolate_labels_batch, read_semantic3d_format,
                            reduced_labels2full)
from .data.spg_io import EdgeFeatScaler
from .device import card_unless
from .learn.infer import eval_step
from .models.spgmodel import SpgBatch
from .pipeline import PartitionConfig, PartitionResult, partition_cloud
from .room import EDGE_ATTRIBS, superpoint_batch
from .utils import tracing
from .utils.tracing import stage

SEMA3D_N_LABELS = 8
# the reference's Semantic3D partition recipe (Semantic3D.md:18-24)
SEMA3D_CONFIG = PartitionConfig(voxel_width=0.05, reg_strength=0.8,
                                k_nn_geof=45, k_nn_adj=10, dataset="sema3d",
                                spg_adjacency="knn")
SEMA3D_LOADER = LoaderConfig(pc_attribs="xyzrgbelpsv")
VER_BATCH = 5_000_000
# the flagship Semantic3D model (cli/train.py defaults, --ptn_nfeat_stn 11)
SEMA3D_MODEL = dict(model_config="gru_10,f_8", ptn_nfeat=11, ptn_nfeat_stn=11)


@dataclasses.dataclass
class ScanLabels:
    labels: np.ndarray    # [n_raw] predicted Semantic3D class 1..8 per raw point
    logits: np.ndarray    # [n_superpoints, n_classes]
    partition: PartitionResult  # labels: the voxels' label histograms
    batch: SpgBatch       # the model's input, on `device`
    counts: dict
    times: dict           # seconds per stage; partition_cloud.* its split


def scan_batch(part: PartitionResult, n_classes: int,
               loader_cfg: LoaderConfig = SEMA3D_LOADER,
               edge_attribs: str = EDGE_ATTRIBS,
               scaler: EdgeFeatScaler | None = None, device=None) -> SpgBatch:
    """The model's input for a scan's partition: every superpoint's points
    as 11-column Semantic3D rows, the SPG entry (edge features scaled by
    `scaler` when given), collated on `device` (default: the card)."""
    return superpoint_batch(part, n_classes, loader_cfg, edge_attribs, scaler,
                            card_unless(device), style="sema3d")


def label_scan(raw_path: str, model, device=None,
               cfg: PartitionConfig = SEMA3D_CONFIG,
               ver_batch: int = VER_BATCH,
               loader_cfg: LoaderConfig = SEMA3D_LOADER,
               edge_attribs: str = EDGE_ATTRIBS,
               scaler: EdgeFeatScaler | None = None) -> ScanLabels:
    """Run the Semantic3D serving path on one scan file (`x y z intensity
    r g b` rows; its `.labels` sibling, when present, gives the voxels'
    label histograms); `model` is an SpgModel in eval mode on `device`
    (default: the card), `scaler` the edge-feature scaler it was trained
    with (None: features unscaled)."""
    device = card_unless(device)
    with tracing.span("spgt.cloud", path="scan") as cloud:
        return _label_scan(raw_path, model, device, cfg, ver_batch,
                           loader_cfg, edge_attribs, scaler, cloud)


def _label_scan(raw_path, model, device, cfg, ver_batch, loader_cfg,
                edge_attribs, scaler, cloud) -> ScanLabels:
    times = {}
    label_file = os.path.splitext(raw_path)[0] + ".labels"
    has_labels = os.path.isfile(label_file)
    raw_xyz = []  # the reader's chunks of raw x y z, for the spread
    with stage("spgt.read", times, "read_semantic3d", device):
        read = read_semantic3d_format(
            raw_path, SEMA3D_N_LABELS if has_labels else 0,
            label_file if has_labels else "", cfg.voxel_width, ver_batch,
            device=device, raw_xyz_out=raw_xyz)
    xyz, rgb = read[:2]
    labels = read[2] if has_labels else None
    with stage("spgt.partition", times, "partition_cloud", device):
        part = partition_cloud(xyz, rgb, labels, None, SEMA3D_N_LABELS,
                               dataclasses.replace(cfg, voxel_width=0.0),
                               device=device)
    times.update({f"partition_cloud.{k}": v for k, v in part.times.items()})

    with stage("spgt.batch", times, "superpoint_batch", device):
        batch = scan_batch(part, model.n_classes, loader_cfg, edge_attribs,
                           scaler, device)
    with stage("spgt.model", times, "model", device):
        _, logits = eval_step(model, batch)
    n_sp = len(part.components)
    logits = tracing.to_host(logits[:n_sp], "logits").numpy()
    with stage("spgt.voxel_labels", times, "voxel_labels", device):
        voxel_cls = reduced_labels2full(
            logits.argmax(1).astype(np.uint8) + 1, part.components,
            len(part.xyz))
    with stage("spgt.spread", times, "interpolate_labels_batch", device):
        pred = interpolate_labels_batch(raw_path, part.xyz, voxel_cls,
                                        ver_batch, device=device,
                                        raw_xyz=raw_xyz)
    raw_xyz.clear()
    cloud.set(raw_points=len(pred))
    cp = part.times.get("cp_info", {})
    counts = {
        "raw_points": len(pred),
        "voxels": len(part.xyz),
        "chunks": cp.get("n_chunks", 1),
        "superpoints": n_sp,
        "superedges": int(len(part.graph_sp["source"])),
        "embedded_superpoints": int(tracing.to_host(batch.cloud_mask.sum(),
                                                    "embedded")),
    }
    return ScanLabels(labels=pred, logits=logits, partition=part, batch=batch,
                      counts=counts, times=times)
