"""Voxel-grid pruning of raw point clouds.

Port of superpoint_graph_tpu/ops/voxel.py (`voxel_prune`, `prune`), whose
behaviour follows the reference C++ `libply_c.prune` (ply_c.cpp:288-380):
bin points into a grid anchored at the cloud's min corner, then per occupied
voxel output the mean xyz, the mean rgb truncated to uint8, and the label and
object histograms, with voxels in the order a point first touches them.

torch has int64, so one flat key per point replaces the JAX version's 3-key
int32 sort, and no power-of-two padding is needed (no recompilation).

Above PRUNE_DEVICE_MAX rows `prune` runs the host library's hash-grid prune
(`native.prune`), as the JAX version does. `prune_plain` is that prune in
numpy, for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import card_unless
from ..utils import tracing

# above this many rows `prune` runs on the host library (the JAX package's
# threshold, superpoint_graph_tpu/ops/voxel.py:118-122, set for the
# memory of a TPU, where its device prune of a ~5e7-row re-prune failed)
PRUNE_DEVICE_MAX = 20_000_000


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
    m = int(tracing.to_host(inv.max(), "prune.voxels")) + 1
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


def prune_plain(xyz, voxel_size, rgb, labels, objects, n_labels, n_objects):
    """`native.prune` in numpy, for the tests: the JAX package's
    `prune_host` (superpoint_graph_tpu/ops/voxel.py:125; a flat-key stable
    argsort, voxels ranked by their first point, histograms by add.at) with
    the library's arithmetic. Keys come from f32 (xyz - min) / voxel_size,
    as in the library and both device prunes, where `prune_host` divides
    in float64: a point within rounding of a voxel face can be binned apart
    (a few on the Semantic3D chain's first 5e6-row chunk). Sums are f32
    in point order (add.at) and means
    f32, as the library's, where `prune_host` takes float64 means. Returns
    what `prune` returns."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    mins = xyz.min(0)
    bins = np.floor((xyz - mins) / np.float32(voxel_size)).astype(np.int64)
    dims = bins.max(0) + 1
    key = (bins[:, 0] * dims[1] + bins[:, 1]) * dims[2] + bins[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    head = np.empty(n, bool)
    head[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    m = len(starts)
    # first-occurrence order: a stable sort puts each voxel's lowest
    # original index first in its run
    rank = np.argsort(np.argsort(order[starts], kind="stable"), kind="stable")
    vox = np.empty(n, np.int64)
    vox[order] = rank[np.cumsum(head) - 1]
    counts = np.bincount(vox, minlength=m).astype(np.float32)[:, None]

    def mean(a):
        s = np.zeros((m, 3), np.float32)
        np.add.at(s, vox, a)
        return s / counts

    if rgb is None or np.size(rgb) == 0:
        rgb = np.zeros((n, 3), np.uint8)
    out_xyz = mean(xyz)
    out_rgb = mean(np.asarray(rgb, np.uint8).astype(np.float32)).astype(
        np.uint8)

    def hist(values, n_bins):
        if n_bins <= 0:
            return np.zeros((m, 1), np.uint32)
        h = np.zeros((m, n_bins + 1), np.uint32)
        values = (np.asarray(values, np.int64)
                  if values is not None and np.size(values)
                  else np.zeros(n, np.int64))
        np.add.at(h, (vox, values), 1)
        return h

    return out_xyz, out_rgb, hist(labels, n_labels), hist(objects, n_objects)


def prune(xyz, voxel_size, rgb, labels, objects, n_labels, n_objects,
          device=None):
    """`libply_c.prune` contract on numpy in and out (ply_c.cpp:497-505):
    (xyz f32, rgb u8, label_hist u32, object_hist u32) in first-occurrence
    voxel order; the work runs on `device` (default: the card), or above
    PRUNE_DEVICE_MAX rows on the host library."""
    device = card_unless(device)
    if len(xyz) > PRUNE_DEVICE_MAX:
        return native.prune(xyz, voxel_size, rgb, labels, objects,
                            n_labels, n_objects)
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
        tracing.to_host(out["xyz"], "prune.out").numpy(),
        # truncates like the C++ cast
        tracing.to_host(out["rgb"].to(torch.uint8), "prune.out").numpy(),
        tracing.to_host(out["label_hist"], "prune.out").numpy().astype(
            np.uint32),
        tracing.to_host(out["object_hist"], "prune.out").numpy().astype(
            np.uint32),
    )
