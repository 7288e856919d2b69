"""Geometric partition CLI: raw clouds -> features/ and superpoint_graphs/
h5 caches.

Port of superpoint_graph_tpu/cli/partition.py (flags :16-40; reference
partition/partition.py:20-31, 113-189). `partition_file` is the per-file
work: the dataset's reader (S3DIS, the nn1 kernel
re-associates the annotation objects; Semantic3D, chunks pruned on the
card as they are read; vKITTI npy; custom_dataset ply, pcd or las), then
`pipeline.partition_cloud` (prune, kNN, geof, the device cut pursuit,
SPG), returning the PartitionResult. `main` walks <ROOT>/data, skips files
whose caches exist (unless --overwrite 1) and writes the caches with
utils/h5io.py. custom_dataset's class count is --n_labels; at 0 the first
labelled ply or pcd gives it (its largest label) for that file and every
later one, as in the JAX CLI. --cp_backend keeps the JAX values: "tpu" is
the port's device solver (cp_backend="device"), "exact" the host one.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np

from ..device import card_unless
from ..pipeline import PartitionConfig, PartitionResult, partition_cloud

N_LABELS = {"s3dis": 13, "sema3d": 8, "vkitti": 13}
DATASETS = (*N_LABELS, "custom_dataset")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Large-scale point cloud segmentation on the GPU "
                    "— geometric partition")
    parser.add_argument("--ROOT_PATH", default="datasets/s3dis")
    parser.add_argument("--dataset", default="s3dis",
                        help="s3dis|sema3d|vkitti|custom_dataset")
    parser.add_argument("--k_nn_geof", default=45, type=int)
    parser.add_argument("--k_nn_adj", default=10, type=int)
    parser.add_argument("--lambda_edge_weight", default=1.0, type=float)
    parser.add_argument("--reg_strength", default=0.03, type=float)
    parser.add_argument("--d_se_max", default=0, type=float)
    parser.add_argument("--voxel_width", default=0.03, type=float)
    parser.add_argument("--ver_batch", default=0, type=int)
    parser.add_argument("--overwrite", default=0, type=int)
    parser.add_argument("--cp_backend", default="tpu", choices=["tpu", "exact"],
                        help="tpu: the device cut-pursuit solver (the JAX "
                             "name); exact: the host max-flow solver")
    parser.add_argument("--n_labels", default=0, type=int,
                        help="class count for custom_dataset")
    parser.add_argument("--spg_adjacency", default="delaunay",
                        choices=["delaunay", "knn"])
    return parser.parse_args(argv)


def partition_config(args) -> PartitionConfig:
    return PartitionConfig(
        k_nn_geof=args.k_nn_geof, k_nn_adj=args.k_nn_adj,
        lambda_edge_weight=args.lambda_edge_weight,
        reg_strength=args.reg_strength, d_se_max=args.d_se_max,
        voxel_width=args.voxel_width, dataset=args.dataset,
        cp_backend={"tpu": "device", "exact": "exact"}[args.cp_backend],
        spg_adjacency=args.spg_adjacency)


def check_dataset(dataset: str):
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}: one of {DATASETS}")


def find_folders(root: str) -> list[str]:
    return sorted(os.path.basename(f)
                  for f in glob.glob(os.path.join(root, "data", "*"))
                  if os.path.isdir(f))


def files_in_folder(root: str, folder: str, dataset: str) -> list[str]:
    """The raw files of one folder: <room>/<room>.txt (s3dis), *.txt
    (sema3d), *.npy (vkitti), *.ply then *.las then *.pcd, sorted together
    (custom_dataset)."""
    data = os.path.join(root, "data", folder)
    patterns = {"s3dis": ["*/*.txt"], "sema3d": ["*.txt"],
                "vkitti": ["*.npy"]}.get(dataset, ["*.ply", "*.las", "*.pcd"])
    return sorted(f for p in patterns
                  for f in glob.glob(os.path.join(data, p)))


def cloud_name(data_file: str, dataset: str) -> str:
    """The cache name: the room folder (s3dis) or the file stem."""
    if dataset == "s3dis":
        return os.path.basename(os.path.dirname(data_file))
    return os.path.splitext(os.path.basename(data_file))[0]


def _partition_file(data_file: str, args, n_labels: int, device):
    """(partition_file's result, the class count after this file): the
    reader of args.dataset (JAX cli/partition.py:116-152), then
    partition_cloud. `n_labels` is the class count so far, which a
    custom_dataset ply or pcd with labels sets to its largest label when
    it is 0."""
    from ..data import provider

    cfg = partition_config(args)
    labels = objects = None
    if args.dataset == "s3dis":
        xyz, rgb, labels, objects = provider.read_s3dis_format(
            data_file, device=device)
    elif args.dataset == "sema3d":
        label_file = data_file[:-4] + ".labels"
        has_labels = os.path.isfile(label_file)
        out = provider.read_semantic3d_format(
            data_file, n_labels if has_labels else 0,
            label_file if has_labels else "", args.voxel_width,
            args.ver_batch, device=device)
        xyz, rgb = out[:2]
        labels = out[2] if has_labels else None
        # the reader pruned each chunk already
        cfg = dataclasses.replace(cfg, voxel_width=0.0)
    elif args.dataset == "vkitti":
        xyz, rgb, labels = provider.read_vkitti_format(data_file)
    elif data_file.endswith(".pcd"):
        xyz, labels = provider.read_pcd(data_file)
        rgb = np.zeros((len(xyz), 3), np.uint8)
    elif data_file.endswith(".las"):
        xyz = provider.read_las(data_file)
        rgb = np.zeros((len(xyz), 3), np.uint8)
    else:
        xyz, rgb, labels = provider.read_ply(data_file)
    if labels is not None and np.size(labels) == 0:
        labels = None
    elif labels is not None and n_labels == 0:
        n_labels = int(np.max(labels))
    res = partition_cloud(
        xyz, rgb, None if labels is None else np.asarray(labels),
        None if objects is None else np.asarray(objects),
        n_labels=n_labels, cfg=cfg, device=device)
    return res, n_labels


def partition_file(data_file: str, args, device=None) -> PartitionResult:
    """Read one raw cloud and partition it on `device` (default: the
    card) with the flags in `args` (parse_args); a custom_dataset file's
    class count is --n_labels, or its largest label at 0."""
    check_dataset(args.dataset)
    device = card_unless(device)
    return _partition_file(data_file, args,
                           N_LABELS.get(args.dataset, args.n_labels),
                           device)[0]


def main(argv=None, device=None):
    """Partition every raw cloud under <ROOT_PATH>/data into the caches,
    on `device` (default: the card)."""
    from ..utils.h5io import write_features, write_spg

    args = parse_args(argv)
    check_dataset(args.dataset)
    device = card_unless(device)
    root = args.ROOT_PATH.rstrip("/")
    n_labels = N_LABELS.get(args.dataset, args.n_labels)
    times = {"features": 0.0, "partition": 0.0, "spg": 0.0}
    for folder in find_folders(root):
        files = files_in_folder(root, folder, args.dataset)
        fea_dir = os.path.join(root, "features", folder)
        spg_dir = os.path.join(root, "superpoint_graphs", folder)
        os.makedirs(fea_dir, exist_ok=True)
        os.makedirs(spg_dir, exist_ok=True)
        for i_file, data_file in enumerate(files):
            name = cloud_name(data_file, args.dataset)
            fea_file = os.path.join(fea_dir, name + ".h5")
            spg_file = os.path.join(spg_dir, name + ".h5")
            print(f"{i_file + 1} / {len(files)} ---> {folder}/{name}")
            if (os.path.isfile(fea_file) and os.path.isfile(spg_file)
                    and not args.overwrite):
                print("    already computed, skipping (use --overwrite 1)")
                continue
            res, n_labels = _partition_file(data_file, args, n_labels,
                                            device)
            for k in times:
                times[k] += res.times[k]
            write_features(fea_file, res.geof, res.xyz, res.rgb, res.graph_nn,
                           res.labels)
            write_spg(spg_file, res.graph_sp, res.components,
                      res.in_component)
            print("Timer : %5.1f / %5.1f / %5.1f" % (
                times["features"], times["partition"], times["spg"]))


if __name__ == "__main__":
    main()
