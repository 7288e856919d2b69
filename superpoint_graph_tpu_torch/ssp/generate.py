"""One cloud through a trained SSP embedder: its embeddings, its learned
partition and its superpoint graph.

The per-cloud generation of the reference's supervized_partition
(generate_partition.py:23-140, and the final evaluation of
supervized_partition.py:297-375), shared by `cli/ssp_generate.py`, the
evaluation of `cli/ssp_train.py` and the serving path `frame.label_frame`:

  * `partition_cloud`: the whole cloud's sample (graph_loader, no
    augmentation or subsampling), the embedder's eval-mode embeddings of
    its local clouds and the per-edge distances on `device`, then cut
    pursuit on [embeddings | spatial_emb * xyz] (ssp/losses.py);
  * `superpoint_graph`: the SPG of the learned components with Delaunay
    superedge support, superedges no longer than D_SE_MAX; the serving
    path hands it a triangulation started on the voxels before the
    embedding.

With `times`, the embedding and the partition are timed stages
(`utils/tracing.stage`: `spgt.ssp.embed` with `spgt.ssp.local_clouds`
inside it, `spgt.cp`) whose seconds go under "embed" and "partition";
the counters `ssp.vertices`, `ssp.local_points` and `ssp.edges` count
what was embedded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import card_unless
from ..graph.spg import DelaunayJob, compute_sp_graph
from ..utils import tracing
from ..utils.tracing import stage
from .embed import embed_rows
from .graph_processing import graph_collate, graph_loader
from .losses import compute_dist, compute_partition

# the superedges' length cap of generate_partition.py (graphs.py's d_max)
D_SE_MAX = 100.0


@dataclasses.dataclass
class CloudPartition:
    sample: dict            # graph_loader's whole-cloud sample
    embeddings: np.ndarray  # [n, d] float32
    diff: np.ndarray        # [E] per-edge embedding distances
    components: list
    in_component: np.ndarray  # [n] int32


@torch.no_grad()
def embed_cloud(embedder, sample: dict, dist_type: str, device,
                use_geof: bool = False):
    """(embeddings [n, d], per-edge distances [E]) of a loaded cloud, host
    numpy: `embedder` (a LocalEmbedder, put in eval mode) over its local
    clouds on `device`, embed.EMBED_ROWS at a time (`embed_rows`), or
    with `use_geof` the sample's handcrafted features flattened."""
    n = len(sample["xyz"])
    if use_geof:
        emb = torch.as_tensor(np.asarray(sample["clouds"], np.float32)
                              .reshape(n, -1), device=device)
    else:
        dtype = next(embedder.parameters()).dtype
        emb = embed_rows(
            embedder,
            torch.as_tensor(sample["clouds"], dtype=dtype, device=device),
            torch.as_tensor(sample["clouds_global"], dtype=dtype,
                            device=device))
        tracing.count("ssp.local_points", int(np.prod(
            sample["clouds"].shape[:2])))
    src = torch.as_tensor(sample["edg_source"], device=device)
    tgt = torch.as_tensor(sample["edg_target"], device=device)
    diff = compute_dist(emb, src, tgt, dist_type)
    tracing.count("ssp.vertices", n)
    tracing.count("ssp.edges", len(sample["edg_source"]))
    return (tracing.to_host(emb, "ssp.embeddings").numpy(),
            tracing.to_host(diff, "ssp.edge_distances").numpy())


def partition_cloud(embedder, loss_cfg, loader_cfg, structure, device=None,
                    times: dict | None = None,
                    use_geof: bool = False) -> CloudPartition:
    """A cloud's embeddings and learned partition (see the module
    docstring) from its structure, a features_supervision file or the dict
    `build_supervision_structure` or `serving_structure` returns; the
    embedder and the device solver run on `device` (default: the card)."""
    device = card_unless(device)
    with stage("spgt.ssp.embed", times, "embed", device):
        with tracing.span("spgt.ssp.local_clouds"):
            sample = graph_collate([graph_loader(structure, False,
                                                 loader_cfg)])
        emb, diff = embed_cloud(embedder, sample, loss_cfg.dist_type, device,
                                use_geof)
    with stage("spgt.cp", times, "partition", device):
        comps, in_comp = compute_partition(
            loss_cfg, emb, sample["edg_source"], sample["edg_target"], diff,
            sample["xyz"], device)
    return CloudPartition(sample, emb, diff, comps, in_comp)


def superpoint_graph(part: CloudPartition, n_classes: int, device=None,
                     times: dict | None = None,
                     delaunay: DelaunayJob | None = None) -> dict:
    """The SPG of a learned partition (graph/spg.py, Delaunay support, at
    most D_SE_MAX long), with the voxels' labels where the sample has
    them; the Delaunay's seconds go under times["delaunay"]. `delaunay`:
    the triangulation of the sample's voxels, a `graph/spg.DelaunayJob`
    that the calling thread of `frame.label_frame` runs."""
    return compute_sp_graph(part.sample["xyz"], D_SE_MAX, part.in_component,
                            part.sample["labels"], n_classes, device=device,
                            times=times, delaunay=delaunay)
