"""SSP preprocessing CLI: raw clouds -> features_supervision/ structures.

Port of superpoint_graph_tpu/cli/ssp_preprocess.py (flags :13-25;
reference supervized_partition/graph_processing.py:34-46, 110-193).
`preprocess_file` is the per-file work: the dataset's reader (S3DIS: the
nn1 kernel re-associates the annotation objects; Semantic3D: chunks pruned
on the card as they are read; vKITTI: npy frames), then `ssp/
graph_processing.build_supervision_structure` (prune, kNN, geof on the
card; transitions, RANSAC elevation on the host). `main` walks
<ROOT>/data, skips files whose structure exists (unless --overwrite 1) and
writes each with h5py (imported there). `--ver_batch` is the Semantic3D
reader's chunk.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from ..device import card_unless
from .partition import cloud_name, files_in_folder, find_folders

N_LABELS = {"s3dis": 13, "sema3d": 8, "vkitti": 13}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SSP graph preprocessing")
    p.add_argument("--ROOT_PATH", default="datasets/s3dis")
    p.add_argument("--dataset", default="s3dis", help="s3dis|sema3d|vkitti")
    p.add_argument("--k_nn_local", default=20, type=int)
    p.add_argument("--k_nn_adj", default=5, type=int)
    p.add_argument("--voxel_width", default=0.03, type=float)
    p.add_argument("--plane_model", default=1, type=int)
    p.add_argument("--use_voronoi", default=0.0, type=float)
    p.add_argument("--ver_batch", default=5000000, type=int)
    p.add_argument("--overwrite", default=0, type=int)
    p.add_argument("--compute_geof", default=1, type=int)
    return p.parse_args(argv)


def _supported(dataset: str):
    if dataset not in N_LABELS:
        raise ValueError(f"unknown dataset {dataset!r}: one of "
                         f"{tuple(N_LABELS)}")


def preprocess_config(args):
    from ..ssp.graph_processing import SspPreprocessConfig

    return SspPreprocessConfig(
        k_nn_adj=args.k_nn_adj, k_nn_local=args.k_nn_local,
        voxel_width=args.voxel_width, compute_geof=bool(args.compute_geof),
        plane_model=bool(args.plane_model),
        use_voronoi=float(args.use_voronoi), dataset=args.dataset)


def preprocess_file(data_file: str, args, device=None) -> dict:
    """One raw cloud's supervision structure (the dict write_structure
    stores), read and built on `device` (default: the card) with the flags
    in `args` (parse_args)."""
    from ..data import provider
    from ..ssp.graph_processing import build_supervision_structure

    _supported(args.dataset)
    device = card_unless(device)
    n_labels = N_LABELS[args.dataset]
    cfg = preprocess_config(args)
    objects = None
    if args.dataset == "s3dis":
        xyz, rgb, labels, objects = provider.read_s3dis_format(
            data_file, device=device)
    elif args.dataset == "vkitti":
        xyz, rgb, labels = provider.read_vkitti_format(data_file)
    else:
        label_file = data_file[:-4] + ".labels"
        if os.path.isfile(label_file):
            xyz, rgb, labels = provider.read_semantic3d_format(
                data_file, n_labels, label_file, args.voxel_width,
                args.ver_batch, device=device)
        else:
            xyz, rgb = provider.read_semantic3d_format(
                data_file, 0, "", args.voxel_width, args.ver_batch,
                device=device)
            labels = np.zeros(len(xyz), np.int32)
        # the chunked reader pruned the cloud (labels arrive as histograms)
        cfg = dataclasses.replace(cfg, voxel_width=0.0)
    return build_supervision_structure(
        np.asarray(xyz, np.float32), np.asarray(rgb),
        np.asarray(labels, np.int32),
        None if objects is None else np.asarray(objects, np.int32),
        cfg, n_labels, device=device)


def main(argv=None, device=None):
    """Preprocess every raw cloud under <ROOT_PATH>/data into
    features_supervision/, on `device` (default: the card)."""
    from ..ssp.graph_processing import write_structure

    args = parse_args(argv)
    _supported(args.dataset)
    device = card_unless(device)
    root = args.ROOT_PATH.rstrip("/")
    for folder in find_folders(root):
        out_dir = os.path.join(root, "features_supervision", folder)
        os.makedirs(out_dir, exist_ok=True)
        files = files_in_folder(root, folder, args.dataset)
        for i, data_file in enumerate(files):
            name = cloud_name(data_file, args.dataset)
            str_file = os.path.join(out_dir, name + ".h5")
            print(f"{i + 1} / {len(files)} ---> {folder}/{name}")
            if os.path.isfile(str_file) and not args.overwrite:
                print("    already computed, skipping")
                continue
            write_structure(str_file, preprocess_file(data_file, args, device))


if __name__ == "__main__":
    main()
