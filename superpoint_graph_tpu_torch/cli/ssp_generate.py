"""Partition-inference CLI: a trained SSP embedder partitions every
preprocessed cloud into superpoint_graphs/.

Port of superpoint_graph_tpu/cli/ssp_generate.py (reference
supervized_partition/generate_partition.py:23-140). The model's args come
from the checkpoint (generate_partition.py:88), so the architecture cannot
drift. `generate_cloud` is the per-cloud work (ssp/generate.py:
embed on the card, the per-edge distances, cut pursuit; then the SPG with
Delaunay support), on a structure file or the dict
build_supervision_structure returns; `main`
walks features_supervision/ and writes each SPG with h5py (imported
there), skipping those that exist unless --overwrite 1. --cp_backend keeps
the JAX values: "tpu" is the port's device solver, "exact" the host one.
"""
from __future__ import annotations

import argparse
import os

from ..device import card_unless
from ..ssp.generate import partition_cloud, superpoint_graph
from .ssp_train import N_CLASSES, configs


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="generate partitions with a trained SSP model")
    p.add_argument("--ROOT_PATH", default="datasets/s3dis")
    p.add_argument("--dataset", default="s3dis")
    p.add_argument("--model_path", default="results_partition/cv1/model.ckpt")
    p.add_argument("--folder", default="", help="restrict to one subfolder")
    p.add_argument("--overwrite", default=0, type=int)
    p.add_argument("--cp_backend", default="tpu", choices=["exact", "tpu"])
    return p.parse_args(argv)


def load_model(model_path: str, cp_backend: str, device=None):
    """(SspTrainer with the checkpoint's weights, SspLossConfig,
    SspLoaderConfig without subsampling), the model built from the
    checkpoint's own args on `device` (default: the card); the in-loop
    solver is `cp_backend` ("tpu" | "exact")."""
    import dataclasses

    from ..learn.checkpoint import load_checkpoint, read_checkpoint_args
    from ..ssp.embed import SspTrainer

    device = card_unless(device)
    ck = dict(read_checkpoint_args(model_path), cp_backend=cp_backend)
    model_cfg, loss_cfg, loader_cfg = configs(ck)
    loader_cfg = dataclasses.replace(loader_cfg, max_ver_train=0)
    trainer = SspTrainer(model_cfg, loss_cfg, device=device)
    state, _, _, _ = load_checkpoint(model_path, map_location=device)
    trainer.load_state_dict(state)
    return trainer, loss_cfg, loader_cfg


def generate_partition(trainer, loss_cfg, loader_cfg, structure,
                       device=None):
    """(the loaded cloud, components, in_component) of one cloud: its
    eval-mode embeddings, the partition of loss_cfg's backend on `device`
    (default: the card); ssp/generate.partition_cloud."""
    part = partition_cloud(trainer.model, loss_cfg, loader_cfg, structure,
                           device)
    return part.sample, part.components, part.in_component


def generate_cloud(trainer, loss_cfg, loader_cfg, structure, n_classes: int,
                   device=None):
    """(graph_sp, components, in_component) of one cloud: its partition
    (generate_partition), then its SPG (ssp/generate.superpoint_graph:
    Delaunay support)."""
    part = partition_cloud(trainer.model, loss_cfg, loader_cfg, structure,
                           device)
    return (superpoint_graph(part, n_classes, device), part.components,
            part.in_component)


def main(argv=None, device=None):
    """Partition every structure under <ROOT_PATH>/features_supervision on
    `device` (default: the card)."""
    from ..utils.h5io import write_spg

    args = parse_args(argv)
    device = card_unless(device)
    root = args.ROOT_PATH.rstrip("/")
    n_classes = N_CLASSES[args.dataset]
    trainer, loss_cfg, loader_cfg = load_model(args.model_path,
                                               args.cp_backend, device)
    base = os.path.join(root, "features_supervision")
    folders = [args.folder] if args.folder else sorted(os.listdir(base))
    for folder in folders:
        in_dir = os.path.join(base, folder)
        if not os.path.isdir(in_dir):
            continue
        out_dir = os.path.join(root, "superpoint_graphs", folder)
        os.makedirs(out_dir, exist_ok=True)
        for fname in sorted(os.listdir(in_dir)):
            if not fname.endswith(".h5"):
                continue
            out_path = os.path.join(out_dir, fname)
            if os.path.isfile(out_path) and not args.overwrite:
                print(f"{folder}/{fname}: exists, skipping")
                continue
            graph_sp, comps, in_comp = generate_cloud(
                trainer, loss_cfg, loader_cfg, os.path.join(in_dir, fname),
                n_classes, device)
            write_spg(out_path, graph_sp, comps, in_comp)
            print(f"{folder}/{fname}: {len(comps)} superpoints")


if __name__ == "__main__":
    main()
