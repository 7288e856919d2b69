"""Voxel-grid pruning of raw point clouds.

Port of superpoint_graph_tpu/ops/voxel.py (`voxel_prune`, `prune`), whose
behaviour follows the reference C++ `libply_c.prune` (ply_c.cpp:288-380):
bin points into a grid anchored at the cloud's min corner, then per occupied
voxel output the mean xyz, the mean rgb truncated to uint8, and the label and
object histograms, with voxels in the order a point first touches them.

torch has int64, so one flat key per point replaces the JAX version's 3-key
int32 sort, and no power-of-two padding is needed (no recompilation).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import card_unless


def voxel_prune(xyz: torch.Tensor, voxel_size: float, rgb: torch.Tensor,
                labels: torch.Tensor | None, objects: torch.Tensor | None,
                n_labels: int, n_objects: int) -> dict:
    """Occupied-voxel means and histograms of a cloud, all on xyz's device.

    Returns a dict: xyz [m, 3] f32, rgb [m, 3] f32 (mean, not truncated),
    label_hist [m, n_labels+1] int64, object_hist [m, n_objects+1] int64
    ([m, 1] zeros when the count is 0)."""
    n = xyz.shape[0]
    mins = xyz.min(0).values
    # f32 subtract and divide, as the JAX version: the same bins. The
    # divisor is a tensor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which bins points on voxel boundaries differently
    # (chip_smoke.py's room: 202,992 voxels on an H100, 202,962 on the CPU)
    bins = torch.floor((xyz - mins) / torch.tensor(
        voxel_size, dtype=xyz.dtype, device=xyz.device)).to(torch.int64)
    dims = bins.max(0).values + 1
    key = (bins[:, 0] * dims[1] + bins[:, 1]) * dims[2] + bins[:, 2]
    _, inv = torch.unique(key, return_inverse=True)
    m = int(inv.max()) + 1
    # first-occurrence order: rank key-ordered voxels by their lowest point
    first = torch.full((m,), n, dtype=torch.int64, device=xyz.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=xyz.device), "amin")
    rank = torch.empty_like(first)
    rank[torch.argsort(first)] = torch.arange(m, device=xyz.device)
    vox = rank[inv]

    counts = torch.bincount(vox, minlength=m)
    cnt_f = counts.clamp(min=1).to(torch.float32)[:, None]
    # sums in a fixed order, the points of a voxel in input order: on CUDA
    # index_add_ adds by float atomics in no fixed order (two calls on an
    # H100 gave voxel means that differed in the last bit on ~11% of the
    # voxels of chip_smoke.py's room)
    order = torch.sort(vox, stable=True).indices
    sum_xyz = torch.segment_reduce(xyz[order], "sum", lengths=counts)
    sum_rgb = torch.segment_reduce(rgb.to(torch.float32)[order], "sum",
                                   lengths=counts)

    def hist(values, n_bins):
        if n_bins <= 0:
            return torch.zeros((m, 1), dtype=torch.int64, device=xyz.device)
        h = torch.zeros((m, n_bins + 1), dtype=torch.int64, device=xyz.device)
        if values is None:
            values = torch.zeros(n, dtype=torch.int64, device=xyz.device)
        h.index_put_((vox, values.to(torch.int64)),
                     torch.ones(n, dtype=torch.int64, device=xyz.device),
                     accumulate=True)
        return h

    return {
        "xyz": sum_xyz / cnt_f,
        "rgb": sum_rgb / cnt_f,
        "label_hist": hist(labels, n_labels),
        "object_hist": hist(objects, n_objects),
    }


def prune(xyz, voxel_size, rgb, labels, objects, n_labels, n_objects,
          device=None):
    """`libply_c.prune` contract on numpy in and out (ply_c.cpp:497-505):
    (xyz f32, rgb u8, label_hist u32, object_hist u32) in first-occurrence
    voxel order; the work runs on `device` (default: the card)."""
    device = card_unless(device)
    xyz_t = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                            device=device)
    rgb_t = torch.as_tensor(np.asarray(rgb), device=device)

    def opt(a):
        if a is None or np.size(a) == 0:
            return None
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

    out = voxel_prune(xyz_t, float(voxel_size), rgb_t, opt(labels),
                      opt(objects), int(n_labels), int(n_objects))
    return (
        out["xyz"].cpu().numpy(),
        out["rgb"].to(torch.uint8).cpu().numpy(),  # truncates like the C++ cast
        out["label_hist"].cpu().numpy().astype(np.uint32),
        out["object_hist"].cpu().numpy().astype(np.uint32),
    )
