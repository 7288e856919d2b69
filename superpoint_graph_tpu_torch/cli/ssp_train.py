"""SSP embedding-training CLI.

Port of superpoint_graph_tpu/cli/ssp_train.py (flags :19-76, with the
adaptive CP_cutoff rule; reference supervized_partition.py:57-135 and its
embed() driver, 152-408): train the local embedder with the
graph-structured loss and the in-loop cross-partition weighting, then
partition the test clouds and write res.h5 (ASA/BR/BP matrices),
superpoint_graphs/ for the segmentation stage, trainlog.json and
model.ckpt. With --learned_embeddings 0 or a geof --ver_value the
handcrafted features are the embeddings: no training, straight to the
evaluation. --cp_backend keeps the JAX values: "tpu" is the port's device
solver, "exact" the host one.

--lr_decay, --lr_steps, --test_nth_epoch, --nworkers and --ptn_embedding
are parsed and never used, as in the JAX CLI: the learning rate stays
constant (ROADMAP queue 3).

`run_epoch` and `evaluate_clouds` take each cloud's structure as a file or
as the dict build_supervision_structure returns; `main(argv, device)` reads
features_supervision/ (h5py) and runs on the card unless `device` names
another (the CPU tests pass device="cpu").
"""
from __future__ import annotations

import argparse
import ast
import json
import os

import numpy as np

from ..device import card_unless

N_CLASSES = {"s3dis": 13, "sema3d": 8, "vkitti": 13}
CP_BACKEND = {"tpu": "device", "exact": "exact"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SSP embedding training")
    p.add_argument("--ROOT_PATH", default="datasets/s3dis")
    p.add_argument("--dataset", default="s3dis")
    p.add_argument("--cvfold", default=1, type=int)
    p.add_argument("--odir", default="results_partition")
    p.add_argument("--resume", default="")
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--lr", default=1e-2, type=float)
    p.add_argument("--lr_decay", default=0.7, type=float)
    p.add_argument("--lr_steps", default="[20,35]")
    p.add_argument("--grad_clip", default=1.0, type=float)
    p.add_argument("--nworkers", default=0, type=int)
    p.add_argument("--test_nth_epoch", default=10, type=int)
    # embeddings / model
    p.add_argument("--learned_embeddings", default=1, type=int)
    p.add_argument("--ptn_embedding", default="ptn")
    p.add_argument("--ver_value", default="ptn")
    p.add_argument("--ptn_widths", default="[[32,128], [34,32,32,4]]")
    p.add_argument("--ptn_widths_stn", default="[[16,64], [32,16]]")
    p.add_argument("--ptn_nfeat_stn", default=2, type=int)
    p.add_argument("--use_rgb", default=1, type=int)
    p.add_argument("--global_feat", default="eXYrgb")
    p.add_argument("--stn_as_global", default=1, type=int)
    p.add_argument("--ptn_norm", default="batch")
    p.add_argument("--ptn_prelast_do", default=0.0, type=float)
    # loss / partition
    p.add_argument("--loss", default="TVH_zhang")
    p.add_argument("--dist_type", default="euclidian")
    p.add_argument("--loss_weight", default="crosspartition")
    p.add_argument("--transition_factor", default=5.0, type=float)
    p.add_argument("--edge_weight_threshold", default=-0.5, type=float)
    p.add_argument("--spatial_emb", default=0.2, type=float)
    p.add_argument("--reg_strength", default=0.8, type=float)
    p.add_argument("--CP_cutoff", default=25, type=int)
    p.add_argument("--k_nn_adj", default=5, type=int)
    p.add_argument("--k_nn_local", default=20, type=int)
    p.add_argument("--max_ver_train", default=10000, type=int)
    p.add_argument("--BR_tolerance", default=1, type=int)
    p.add_argument("--spg_out", default=1, type=int)
    p.add_argument("--cp_backend", default="tpu", choices=["exact", "tpu"],
                   help="tpu: the device cut-pursuit solver (the JAX "
                        "name); exact: the host max-flow solver")
    p.add_argument("--pc_augm_rot", default=1, type=int)
    p.add_argument("--pc_augm_jitter", default=1, type=int)
    p.add_argument("--seed", default=1, type=int)
    args = p.parse_args(argv)
    args.ptn_widths = ast.literal_eval(args.ptn_widths)
    args.ptn_widths_stn = ast.literal_eval(args.ptn_widths_stn)
    args.lr_steps = ast.literal_eval(args.lr_steps)
    if args.CP_cutoff < 0:
        # the adaptive cutoff (supervized_partition.py:132-133): a negative
        # value means |cutoff|, scaled down for small reg_strength
        args.CP_cutoff = max(-args.CP_cutoff // 2,
                             int(-args.CP_cutoff * args.reg_strength))
    return args


def configs(args: dict):
    """(SspModelConfig, SspLossConfig, SspLoaderConfig) of the CLI's args
    (a dict: vars(parse_args(...)), or a checkpoint's args)."""
    from ..ssp.embed import SspModelConfig
    from ..ssp.graph_processing import SspLoaderConfig
    from ..ssp.losses import SspLossConfig

    model_cfg = SspModelConfig(
        ptn_widths=tuple(map(tuple, args["ptn_widths"])),
        ptn_widths_stn=tuple(map(tuple, args["ptn_widths_stn"])),
        ptn_nfeat_stn=args["ptn_nfeat_stn"], use_rgb=bool(args["use_rgb"]),
        global_feat=args["global_feat"],
        stn_as_global=bool(args["stn_as_global"]),
        ptn_norm=args["ptn_norm"], ptn_prelast_do=args["ptn_prelast_do"])
    loss_cfg = SspLossConfig(
        loss=args["loss"], dist_type=args["dist_type"],
        loss_weight=args["loss_weight"],
        transition_factor=args["transition_factor"],
        edge_weight_threshold=args["edge_weight_threshold"],
        spatial_emb=args["spatial_emb"], reg_strength=args["reg_strength"],
        k_nn_adj=args["k_nn_adj"], CP_cutoff=args["CP_cutoff"],
        cp_backend=CP_BACKEND[args["cp_backend"]])
    loader_cfg = SspLoaderConfig(
        k_nn_local=args["k_nn_local"], max_ver_train=args["max_ver_train"],
        use_rgb=bool(args["use_rgb"]), global_feat=args["global_feat"],
        pc_augm_rot=bool(args["pc_augm_rot"]),
        pc_augm_jitter=bool(args["pc_augm_jitter"]),
        ver_value=args["ver_value"])
    return model_cfg, loss_cfg, loader_cfg


def supervision_files(root, dataset, cvfold):
    """(train, test) structure files: the cvfold-th folder of
    features_supervision/ is the test split (s3dis, vkitti); every folder
    but train (sema3d)."""
    base = os.path.join(root, "features_supervision")
    folders = sorted(d for d in os.listdir(base)
                     if os.path.isdir(os.path.join(base, d)))
    train, test = [], []
    for i, folder in enumerate(folders, start=1):
        files = sorted(os.path.join(base, folder, f)
                       for f in os.listdir(os.path.join(base, folder))
                       if f.endswith(".h5"))
        if dataset in ("s3dis", "vkitti") and i == cvfold:
            test.extend(files)
        elif dataset == "sema3d" and folder != "train":
            test.extend(files)
        else:
            train.extend(files)
    return train, test


def run_epoch(trainer, structures, loader_cfg, batch_size: int,
              rs: np.random.RandomState, on_step=None) -> dict:
    """One training epoch: the clouds in an order drawn from `rs`, batches
    of `batch_size` loaded (augmented, subsampled) with `rs` and collated,
    one train_step each; `on_step(loss, components, batch)` after each.
    Returns {"loss": mean, "avg_comp_size": mean vertices a component}."""
    from ..ssp.graph_processing import graph_collate, graph_loader

    order = rs.permutation(len(structures))
    losses, comp_size = [], []
    for i in range(0, len(order), batch_size):
        batch = graph_collate([graph_loader(structures[j], True, loader_cfg, rs)
                               for j in order[i:i + batch_size]])
        loss, comps, _ = trainer.train_step(batch)
        losses.append(loss)
        comp_size.append(len(batch["xyz"]) / max(len(comps), 1))
        if on_step is not None:
            on_step(loss, comps, batch)
    return {"loss": float(np.mean(losses)),
            "avg_comp_size": float(np.mean(comp_size))}


def evaluate_clouds(trainer, loss_cfg, loader_cfg, structures,
                    n_classes: int, BR_tolerance: int, device, spg_paths=None,
                    use_geof=False):
    """The final evaluation (supervized_partition.py:297-375): each cloud
    embedded whole and partitioned (ssp/generate.partition_cloud), then
    counted; its SPG written to spg_paths[i] when given. Returns the
    FinalEvaluator."""
    from ..ssp.evaluate import FinalEvaluator
    from ..ssp.generate import partition_cloud

    ev = FinalEvaluator(n_classes, BR_tolerance, device)
    for i, structure in enumerate(structures):
        part = partition_cloud(None if use_geof else trainer.model, loss_cfg,
                               loader_cfg, structure, device,
                               use_geof=use_geof)
        ev.add_cloud(part,
                     spg_out_path=None if spg_paths is None else spg_paths[i])
    return ev


def main(argv=None, device=None):
    """The CLI; trains and partitions on `device` (default: the card)."""
    from ..learn.checkpoint import load_checkpoint, save_checkpoint
    from ..ssp.embed import SspTrainer
    from ..ssp.evaluate import FolderHierarchy

    args = parse_args(argv)
    device = card_unless(device)
    root = args.ROOT_PATH.rstrip("/")
    n_classes = N_CLASSES[args.dataset]
    hierarchy = FolderHierarchy(args.odir, args.dataset, root, args.cvfold)
    with open(os.path.join(hierarchy.outputdir, "cmdline.txt"), "w") as f:
        f.write(json.dumps(vars(args)))
    model_cfg, loss_cfg, loader_cfg = configs(vars(args))
    train_files, test_files = supervision_files(root, args.dataset,
                                                args.cvfold)
    if not train_files:
        raise SystemExit("no features_supervision files found; run "
                         "ssp_preprocess")
    eval_files = test_files or train_files
    base = os.path.join(root, "features_supervision")
    spg_paths = None
    if args.spg_out:
        spg_paths = [os.path.join(hierarchy.spg_folder,
                                  os.path.relpath(p, base))
                     for p in eval_files]
    res_path = os.path.join(hierarchy.outputdir, "res.h5")

    use_geof = (not args.learned_embeddings) or "geof" in args.ver_value
    if use_geof:
        # spatialEmbedder parity (graph_processing.py:548-560): the
        # handcrafted geof (+rgb) features are the embeddings
        evaluate_clouds(None, loss_cfg, loader_cfg, eval_files, n_classes,
                        args.BR_tolerance, device, spg_paths,
                        use_geof=True).write_res(res_path)
        return

    rs = np.random.RandomState(args.seed)
    trainer = SspTrainer(model_cfg, loss_cfg, lr=args.lr,
                         grad_clip=args.grad_clip, seed=args.seed,
                         device=device)
    stats, start_epoch = [], 0
    if args.resume:
        path = (args.resume if os.path.isfile(args.resume)
                else hierarchy.model_path)
        if os.path.isfile(path):
            state, start_epoch, _, _ = load_checkpoint(path,
                                                       map_location=device)
            trainer.load_state_dict(state)
            log = os.path.join(hierarchy.outputdir, "trainlog.json")
            if os.path.isfile(log):
                with open(log) as f:
                    stats = json.load(f)
    for epoch in range(start_epoch, args.epochs):
        entry = {"epoch": epoch, **run_epoch(trainer, train_files, loader_cfg,
                                             args.batch_size, rs)}
        stats.append(entry)
        print(json.dumps(entry))
        with open(os.path.join(hierarchy.outputdir, "trainlog.json"),
                  "w") as f:
            json.dump(stats, f, indent=2)
        if not np.isfinite(entry["loss"]):
            print("NaN loss, aborting")
            break

    # the final evaluation and the SPGs for the segmentation stage
    evaluate_clouds(trainer, loss_cfg, loader_cfg, eval_files, n_classes,
                    args.BR_tolerance, device, spg_paths).write_res(res_path)
    save_checkpoint(hierarchy.model_path, trainer.state_dict(), args.epochs,
                    dict(vars(args)), None)


if __name__ == "__main__":
    main()
