"""Label one raw vKITTI3D frame end to end through the learned partition
(SSP + SPG): the port's serving path for street frames.

raw .npy frame -> voxel prune -> one kNN search (adjacency and local
neighbourhoods), elevation over the RANSAC plane, xy normalised -> every
voxel's local cloud through the LocalEmbedder (eval mode), per-edge
embedding distances -> cut pursuit on [embeddings | spatial_emb * xyz]
(the device solver) -> superpoint graph with Delaunay superedge support
(the voxels triangulated in the calling thread from the prune on, while a
worker thread runs the kNN, the embedder and the solve) ->
superpoint point sets (vKITTI rows) -> SpgModel logits -> per-superpoint
classes spread to the raw points (nn1 kernel).

Landrieu & Boussaha, CVPR 2019 (arXiv 1904.02113) for the partition, as
`cli/ssp_generate.py` makes it (ssp/generate.py), and the SPG of
arXiv 1711.09869 over the learned superpoints. Each stage's wall time is
recorded (`utils/tracing.stage`), synchronised with the card when
`device` is CUDA; with tracing on, the frame is the root span
`spgt.cloud` (path "frame").
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import (FIRST_COMPLETED, Future,
                                ThreadPoolExecutor, wait)

import numpy as np

from .data.loader import LoaderConfig
from .data.provider import interpolate_labels, read_vkitti_format
from .device import card_unless
from .graph import spg
from .learn.infer import eval_step
from .models.spgmodel import SpgBatch
from .pipeline import PartitionResult
from .room import EDGE_ATTRIBS, superpoint_batch
from .ssp import generate
from .ssp.graph_processing import (SspLoaderConfig, SspPreprocessConfig,
                                   serving_structure)
from .ssp.losses import SspLossConfig
from .utils import tracing
from .utils.tracing import stage

VKITTI_N_LABELS = 13
# the vKITTI3D recipe of the learned partition (docs/DATASETS.md): voxels
# of 5 cm, reg_strength 0.5, spatial_emb 0.2, CP_cutoff 25; the rest of
# cli/ssp_train.py's defaults, which are the reference's
PREPROCESS = SspPreprocessConfig(k_nn_adj=5, k_nn_local=20, voxel_width=0.05,
                                 compute_geof=False, dataset="vkitti")
LOSS = SspLossConfig(reg_strength=0.5, spatial_emb=0.2, k_nn_adj=5,
                     CP_cutoff=25, cp_backend="device")
LOADER = LoaderConfig(pc_attribs="xyzXYZrgb", ptn_npts=128, ptn_minpts=15)


@dataclasses.dataclass
class FrameLabels:
    labels: np.ndarray    # [n_raw] predicted class (0..n_classes-1) per raw point
    logits: np.ndarray    # [n_superpoints, n_classes]
    raw_labels: np.ndarray  # [n_raw] label read from the frame (0: don't care)
    partition: PartitionResult
    embedding: generate.CloudPartition  # the embedded sample and its partition
    batch: SpgBatch       # the model's input, on `device`
    counts: dict
    times: dict           # seconds per stage


def label_frame(raw_path: str, embedder, model, device=None,
                structure_cfg: SspPreprocessConfig = PREPROCESS,
                loss_cfg: SspLossConfig = LOSS,
                loader_cfg: LoaderConfig = LOADER,
                edge_attribs: str = EDGE_ATTRIBS) -> FrameLabels:
    """Run the serving path on one frame; `embedder` is a LocalEmbedder and
    `model` an SpgModel in eval mode, both on `device` (default: the card);
    the superedge features go to the model unscaled.

    The stages after the read run on a worker thread; the calling thread
    triangulates the voxels as soon as the prune hands them over, and the
    SPG waits for the tetrahedra where it needs them. Qhull stays in the
    calling thread, in practice the main one: on an H100's 8-core host it
    ran up to 30% slower in most runs in another thread, whose many
    allocations glibc serves from another malloc arena, though not in
    every run (PERF.md, section 6)."""
    device = card_unless(device)
    with tracing.span("spgt.cloud", path="frame") as cloud:
        times = {}
        with stage("spgt.read", times, "read_vkitti", device):
            xyz, rgb, labels = read_vkitti_format(raw_path)
        cloud.set(raw_points=len(xyz))
        voxels, delaunay = Future(), spg.DelaunayJob()

        def stages():
            with tracing.within(cloud):
                return _label_frame(xyz, rgb, labels, embedder, model,
                                    device, structure_cfg, loss_cfg,
                                    loader_cfg, edge_attribs, times, voxels,
                                    delaunay)

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="frame") as pool:
            path = pool.submit(stages)
            try:
                wait([voxels, path], return_when=FIRST_COMPLETED)
                if voxels.done():
                    delaunay.run(voxels.result())
            finally:  # interrupted here: the worker stops waiting
                delaunay.future.cancel()
            return path.result()


def _label_frame(xyz, rgb, labels, embedder, model, device, structure_cfg,
                 loss_cfg, loader_cfg, edge_attribs, times, voxels,
                 delaunay) -> FrameLabels:
    """The stages after the read: the prune hands the voxels to `voxels`
    (a Future), and the SPG takes the tetrahedra from `delaunay`, which
    the calling thread of `label_frame` runs on them."""
    with stage("spgt.features", times, "partition_cloud.features", device):
        structure = serving_structure(xyz, rgb, np.asarray(labels, np.int32),
                                      structure_cfg, VKITTI_N_LABELS, device,
                                      on_voxels=voxels.set_result)
    sub = {}
    emb = generate.partition_cloud(embedder, loss_cfg, SspLoaderConfig(),
                                   structure, device, sub)
    times["ssp_embed"] = sub["embed"]
    times["partition_cloud.partition"] = sub["partition"]
    with stage("spgt.spg", times, "partition_cloud.spg", device):
        # no voxels handed over (serving_structure replaced): in line
        graph_sp = generate.superpoint_graph(
            emb, VKITTI_N_LABELS, device, times,
            delaunay=delaunay if voxels.done() else None)
    part = PartitionResult(
        xyz=structure["xyz"], rgb=structure["rgb"].astype(np.uint8),
        labels=structure["labels"],
        geof=np.zeros((len(structure["xyz"]), 0), np.float32),
        graph_nn=structure["graph_nn"], components=emb.components,
        in_component=emb.in_component, graph_sp=graph_sp,
        times={k: times[f"partition_cloud.{k}"]
               for k in ("features", "partition", "spg")})
    with stage("spgt.batch", times, "superpoint_batch", device):
        batch = superpoint_batch(part, model.n_classes, loader_cfg,
                                 edge_attribs, None, device, style="vkitti")
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
        "superedges": int(len(graph_sp["source"])),
        "embedded_superpoints": int(tracing.to_host(batch.cloud_mask.sum(),
                                                    "embedded")),
    }
    return FrameLabels(labels=pred, logits=logits, raw_labels=labels,
                       partition=part, embedding=emb, batch=batch,
                       counts=counts, times=times)
