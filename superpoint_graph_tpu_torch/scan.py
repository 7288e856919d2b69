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
rows). Each stage's wall time is recorded, synchronised with the card when
`device` is CUDA.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .data.loader import (LoaderConfig, collate_spg, load_spg_sample,
                          pc_attrib_dims)
from .data.parsed import build_point_matrix, parsed_entries
from .data.provider import (interpolate_labels_batch, read_semantic3d_format,
                            reduced_labels2full)
from .data.spg_io import EdgeFeatScaler, spg_entry
from .device import card_unless
from .learn.infer import eval_step
from .models.spgmodel import SpgBatch
from .pipeline import PartitionConfig, PartitionResult, partition_cloud
from .room import EDGE_ATTRIBS, stage_timer

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
    device = card_unless(device)
    rows = parsed_entries(
        build_point_matrix(part.xyz, part.rgb, part.geof, style="sema3d"),
        part.components)
    entry = spg_entry(part.graph_sp, edge_attribs)
    if scaler is not None:
        entry = entry[:3] + (scaler.transform(entry[3]), entry[4])
    sample = load_spg_sample(entry, rows, loader_cfg)
    return collate_spg([sample], loader_cfg, n_classes,
                       pc_attrib_dims(loader_cfg.pc_attribs), device)


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
    times = {}
    stage = stage_timer(device, times)
    label_file = os.path.splitext(raw_path)[0] + ".labels"
    has_labels = os.path.isfile(label_file)
    read = stage("read_semantic3d", read_semantic3d_format, raw_path,
                 SEMA3D_N_LABELS if has_labels else 0,
                 label_file if has_labels else "", cfg.voxel_width,
                 ver_batch, device=device)
    xyz, rgb = read[:2]
    labels = read[2] if has_labels else None
    part = stage("partition_cloud", partition_cloud, xyz, rgb, labels, None,
                 SEMA3D_N_LABELS, dataclasses.replace(cfg, voxel_width=0.0),
                 device=device)
    times.update({f"partition_cloud.{k}": v for k, v in part.times.items()})

    batch = stage("superpoint_batch", scan_batch, part, model.n_classes,
                  loader_cfg, edge_attribs, scaler, device)
    _, logits = stage("model", eval_step, model, batch)
    n_sp = len(part.components)
    logits = logits[:n_sp].cpu().numpy()
    voxel_cls = stage("voxel_labels", reduced_labels2full,
                      logits.argmax(1).astype(np.uint8) + 1, part.components,
                      len(part.xyz))
    pred = stage("interpolate_labels_batch", interpolate_labels_batch,
                 raw_path, part.xyz, voxel_cls, ver_batch, device=device)
    cp = part.times.get("cp_info", {})
    counts = {
        "raw_points": len(pred),
        "voxels": len(part.xyz),
        "chunks": cp.get("n_chunks", 1),
        "superpoints": n_sp,
        "superedges": int(len(part.graph_sp["source"])),
        "embedded_superpoints": int(batch.cloud_mask.sum()),
    }
    return ScanLabels(labels=pred, logits=logits, partition=part, batch=batch,
                      counts=counts, times=times)
