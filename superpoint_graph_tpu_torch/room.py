"""Label one raw S3DIS room end to end: the port's serving path.

raw room + Annotations (nn1 kernel) -> voxel prune -> kNN + geometric
features -> cut pursuit -> superpoint graph -> superpoint point sets ->
SpgModel logits -> per-superpoint classes spread to the raw points (nn1
kernel). With the default config the cut pursuit is the device solver over
the kNN tables where they lie on `device`, then the host merge step
(`pipeline._cutpursuit_device_path`); the superpoint graph and the batch
are built on the host. Each stage's wall time is recorded
(`utils/tracing.stage`), synchronised with the card when `device` is CUDA;
on the device solver's path `partition_cloud.partition.solve` and `.merge`
split the cut pursuit. With tracing on, the room is the root span
`spgt.cloud`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .data.loader import (LoaderConfig, collate_spg, load_spg_sample,
                          pc_attrib_dims)
from .data.parsed import build_point_matrix, parsed_entries
from .data.provider import interpolate_labels, read_s3dis_format
from .data.spg_io import EdgeFeatScaler, spg_entry
from .device import card_unless
from .learn.infer import eval_step
from .models.spgmodel import SpgBatch
from .pipeline import PartitionConfig, PartitionResult, partition_cloud
from .utils import tracing
from .utils.tracing import stage

# the flagship recipe's superedge features (13 columns)
EDGE_ATTRIBS = "delta_avg,delta_std,nlength/ld,surface/ld,volume/ld,size/ld,xyz/d"
S3DIS_N_LABELS = 13


@dataclasses.dataclass
class RoomLabels:
    labels: np.ndarray    # [n_raw] predicted class (0..n_classes-1) per raw point
    logits: np.ndarray    # [n_superpoints, n_classes]
    raw_labels: np.ndarray  # [n_raw] S3DIS label id read from Annotations/
    partition: PartitionResult
    batch: SpgBatch       # the model's input, on `device`
    counts: dict
    times: dict           # seconds per stage


def label_room(raw_path: str, model, device=None,
               cfg: PartitionConfig = PartitionConfig(spg_adjacency="knn"),
               loader_cfg: LoaderConfig = LoaderConfig(),
               edge_attribs: str = EDGE_ATTRIBS,
               scaler: EdgeFeatScaler | None = None) -> RoomLabels:
    """Run the serving path on one room; `model` is an SpgModel in eval
    mode on `device` (default: the card), `scaler` the edge-feature scaler
    it was trained with (None: features unscaled)."""
    device = card_unless(device)
    with tracing.span("spgt.cloud", path="room") as cloud:
        return _label_room(raw_path, model, device, cfg, loader_cfg,
                           edge_attribs, scaler, cloud)


def superpoint_batch(part: PartitionResult, n_classes: int,
                     loader_cfg: LoaderConfig, edge_attribs: str,
                     scaler: EdgeFeatScaler | None, device,
                     style: str = "s3dis") -> SpgBatch:
    """The model's input for a partition: every superpoint's points as
    parsed rows (`style`), the SPG entry (edge features scaled by `scaler`
    when given), one sample collated on `device`."""
    with tracing.span("spgt.batch.parsed_entries"):
        rows = parsed_entries(
            build_point_matrix(part.xyz, part.rgb, part.geof, style=style),
            part.components)
    with tracing.span("spgt.batch.spg_entry"):
        entry = spg_entry(part.graph_sp, edge_attribs)
        if scaler is not None:
            entry = entry[:3] + (scaler.transform(entry[3]), entry[4])
    with tracing.span("spgt.batch.sample"):
        sample = load_spg_sample(entry, rows, loader_cfg)
    with tracing.span("spgt.batch.collate"):
        return collate_spg([sample], loader_cfg, n_classes,
                           pc_attrib_dims(loader_cfg.pc_attribs), device)


def _label_room(raw_path, model, device, cfg, loader_cfg, edge_attribs,
                scaler, cloud) -> RoomLabels:
    times = {}
    with stage("spgt.read", times, "read_s3dis", device):
        xyz, rgb, labels, objects = read_s3dis_format(raw_path,
                                                      device=device)
    cloud.set(raw_points=len(xyz))
    with stage("spgt.partition", times, "partition_cloud", device):
        part = partition_cloud(xyz, rgb, labels, objects, S3DIS_N_LABELS,
                               cfg, device=device)
    times.update({f"partition_cloud.{k}": v for k, v in part.times.items()})
    with stage("spgt.batch", times, "superpoint_batch", device):
        batch = superpoint_batch(part, model.n_classes, loader_cfg,
                                 edge_attribs, scaler, device)
    with stage("spgt.model", times, "model", device):
        _, logits = eval_step(model, batch)
    n_sp = len(part.components)
    logits = tracing.to_host(logits[:n_sp], "logits").numpy()
    pred_voxel = logits.argmax(1)[part.in_component]
    with stage("spgt.spread", times, "interpolate_labels", device):
        pred = interpolate_labels(xyz, part.xyz, pred_voxel, device=device)
    counts = {
        "raw_points": len(xyz),
        "voxels": len(part.xyz),
        "superpoints": n_sp,
        "superedges": int(len(part.graph_sp["source"])),
        "embedded_superpoints": int(tracing.to_host(batch.cloud_mask.sum(),
                                                    "embedded")),
    }
    return RoomLabels(labels=pred, logits=logits, raw_labels=labels,
                      partition=part, batch=batch, counts=counts, times=times)
