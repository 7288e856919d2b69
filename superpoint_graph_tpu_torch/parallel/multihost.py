"""Multi-rank input pipeline: the training file list sharded per rank, and
an edge scaler fitted on the union of the ranks' shards.

Port of superpoint_graph_tpu/parallel/multihost.py (`process_info`,
`shard_files_by_process`, `global_edge_scaler`, `get_datasets_multihost`)
over a `torch.distributed` process group, one process a rank: NCCL between
cards, gloo on the CPU. `initialize` builds the group from an explicit
address, world size and rank (the JAX caller's
`jax.distributed.initialize`); nothing is read from launcher environment
variables.

  * every rank derives the SAME globally ordered file list, then takes a
    round-robin slice of it, wrapped cyclically so every rank runs the
    same number of steps an epoch (collectives would deadlock otherwise);
  * the edge-feature StandardScaler must be identical on all ranks though
    each reads only its shard: the ranks' float64 moments (count, sum, sum
    of squares) are all-gathered in rank order and summed, as the JAX
    package's `process_allgather(...).sum(0)`; a single process fits on
    its own moments.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import card_unless


def process_info():
    """(rank, world size) of the default process group; (0, 1) where none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(address: str, world_size: int, rank: int, device=None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the default process group at `address` (an init_method URL:
    "tcp://host:port" or "file:///path") as `rank` of `world_size`: NCCL for
    a card (`device`, default the card, raising where there is none), gloo
    for the CPU. Returns the device. Collectives time out after
    `timeout_s` seconds."""
    device = card_unless(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=address,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shard_files_by_process(files, process_index: int | None = None,
                           process_count: int | None = None):
    """Round-robin slice of a globally ordered file list, wrapped
    cyclically so all ranks receive exactly ceil(n / process_count)
    entries.

    Round-robin (not contiguous blocks) so each rank sees a balanced mix of
    areas/folds: the reference's file lists are grouped by area
    (s3dis_dataset.py:23-63)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    files = list(files)
    if process_count <= 1 or not files:
        return files
    per_host = -(-len(files) // process_count)
    out = []
    for j in range(per_host):
        out.append(files[(process_index + j * process_count) % len(files)])
    return out


def _all_gather_rows(packed: np.ndarray) -> np.ndarray:
    """Every rank's float64 vector `packed`, stacked in rank order (the JAX
    `process_allgather`); on the group's device for NCCL."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.as_tensor(packed, dtype=torch.float64, device=dev)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    return torch.stack(rows).cpu().numpy()


def global_edge_scaler(local_train_entries, process_count: int | None = None):
    """EdgeFeatScaler fit on the UNION of all ranks' train shards, from the
    ranks' (count, sum, sum of squares) moments combined in rank order;
    identical on every rank by construction. With one process: the same
    moments, its own."""
    from ..data.spg_io import EdgeFeatScaler

    feats = (np.concatenate([g[3] for g in local_train_entries], 0)
             if local_train_entries else np.zeros((0, 1), np.float64))
    cnt = np.asarray([feats.shape[0]], np.float64)
    s1 = feats.sum(0, dtype=np.float64)
    s2 = (feats.astype(np.float64) ** 2).sum(0)

    if process_count is None:
        _, process_count = process_info()
    if process_count > 1:
        allp = _all_gather_rows(np.concatenate([cnt, s1, s2]))
        cnt = allp[:, :1].sum(0)
        d = s1.shape[0]
        s1 = allp[:, 1:1 + d].sum(0)
        s2 = allp[:, 1 + d:].sum(0)

    n = max(float(cnt[0]), 1.0)
    mean = s1 / n
    var = np.maximum(s2 / n - mean ** 2, 0.0)
    std = np.sqrt(var)
    scale = np.where(std == 0, 1.0, std)
    return EdgeFeatScaler(mean.astype(np.float32), scale.astype(np.float32))


def get_datasets_multihost(dataset: str, root: str, edge_attribs: str, **kw):
    """data/datasets.get_datasets with the TRAIN list sharded per rank and
    the scaler fitted on all ranks' shards. Test and validation stay whole
    (every rank evaluates the full sets, as the metrics are rank-local)."""
    from ..data.datasets import split_names
    from ..data.spg_io import spg_reader

    pi, pc = process_info()
    spg_attribs01 = kw.pop("spg_attribs01", True)
    train_f, test_f, valid_f = split_names(
        dataset, root, kw.pop("cvfold", 0), kw.pop("use_val_set", False),
        kw.pop("db_train_name", "train"), kw.pop("db_test_name", "test"))
    cutoff = kw.pop("spg_superedge_cutoff", -1)

    def read(rel):
        return spg_reader(os.path.join(root, "superpoint_graphs", rel),
                          edge_attribs, cutoff, incl_dir_in_name=True)

    train_local = [read(f) for f in shard_files_by_process(train_f, pi, pc)]
    testlist = [read(f) for f in test_f]
    validlist = [read(f) for f in valid_f]
    scaler = None
    if spg_attribs01 and train_local:
        scaler = global_edge_scaler(train_local, pc)

        def apply(lst):
            return [(g[0], g[1], g[2], scaler.transform(g[3]), *g[4:])
                    for g in lst]

        train_local = apply(train_local)
        testlist = apply(testlist)
        validlist = apply(validlist)
    return train_local, testlist, validlist, scaler
