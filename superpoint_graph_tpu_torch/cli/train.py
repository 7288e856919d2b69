"""Training and evaluation CLI of the SPG semantic segmentation.

Port of superpoint_graph_tpu/cli/train.py (flags :22-103, reference
learning/main.py:40-135; epoch loop 176-388): each epoch trains on the
train split with graph subsampling and point augmentation, optionally
keeps the best model on a validation split, tests every test_nth_epoch,
and saves model.ckpt; the last step is a multisample evaluation (logits
averaged over test_multisamp_n reseeded superpoint samplings) that writes
predictions_<db>.h5, scores_<db>.json and pointwise_cm.npy. trainlog.json,
cmdline.txt and resume (the model rebuilt from the checkpoint's own args)
as in the JAX CLI.

Several ranks (the JAX CLI's multi-host branch, :321-339): where the
caller has joined a process group of more than one rank
(parallel/multihost.initialize) before `main`, each rank reads its
round-robin shard of the training files, the edge scaler is fitted on all
shards (`get_datasets_multihost`), and every training step is
parallel/dp.py's, so all ranks keep one model. Every rank evaluates the
full test and validation sets; only rank 0 writes into odir. The JAX CLI
steps each host alone and lets every host write the same files (ROADMAP
queue 3); the port does not copy that. Every rank must take the same
number of steps: a batch that loads no cloud on one rank alone would
stall the others' all-reduce.

`run_epoch` and `eval_final` take each cloud's parsed rows through a
callable name -> Mapping: `main` opens parsed/<name>.h5 (h5py, imported
there), a caller may pass in-memory dicts (data/parsed.py::parsed_entries).
`main(argv, device)` runs on the card unless device names another (the CPU
tests pass device="cpu").
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

import numpy as np
import torch

from ..data.loader import (LoaderConfig, collate_spg, load_spg_sample,
                           pc_attrib_dims)
from ..device import card_unless
from ..learn.metrics import ConfusionMatrix
from ..learn.train import Trainer
from ..models.spgmodel import SpgModel

# args a resumed run takes from its checkpoint: the architecture
ARCH_KEYS = ("model_config", "fnet_widths", "fnet_llbias", "fnet_orthoinit",
             "fnet_bnidx", "ptn_widths", "ptn_widths_stn", "ptn_nfeat_stn",
             "ptn_prelast_do", "pc_attribs")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Superpoint-graph semantic segmentation on the GPU")
    # Optimization
    parser.add_argument("--wd", default=0, type=float)
    parser.add_argument("--lr", default=1e-2, type=float)
    parser.add_argument("--lr_decay", default=0.7, type=float)
    parser.add_argument("--lr_steps", default="[]")
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=2, type=int)
    parser.add_argument("--optim", default="adam")
    parser.add_argument("--grad_clip", default=1, type=float)
    parser.add_argument("--loss_weights", default="none",
                        choices=["none", "proportional", "sqrt"])
    # Learning process
    parser.add_argument("--nworkers", default=0, type=int)
    parser.add_argument("--steps_per_dispatch", default=1, type=int,
                        help="train batches handed to Trainer.train_steps "
                             "at once (the same steps one after another)")
    parser.add_argument("--test_nth_epoch", default=1, type=int)
    parser.add_argument("--save_nth_epoch", default=1, type=int)
    parser.add_argument("--test_multisamp_n", default=10, type=int)
    # Dataset
    parser.add_argument("--dataset", default="sema3d")
    parser.add_argument("--cvfold", default=0, type=int)
    parser.add_argument("--odir", default="results")
    parser.add_argument("--resume", default="")
    parser.add_argument("--db_train_name", default="train")
    parser.add_argument("--db_test_name", default="test")
    parser.add_argument("--use_val_set", type=int, default=0)
    parser.add_argument("--SEMA3D_PATH", default="datasets/semantic3d")
    parser.add_argument("--S3DIS_PATH", default="datasets/s3dis")
    parser.add_argument("--VKITTI_PATH", default="datasets/vkitti")
    parser.add_argument("--CUSTOM_SET_PATH", default="datasets/custom_set")
    # Model
    parser.add_argument("--model_config", default="gru_10,f_8")
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument(
        "--edge_attribs",
        default="delta_avg,delta_std,nlength/ld,surface/ld,volume/ld,size/ld,xyz/d")
    # Point cloud processing
    parser.add_argument("--pc_attribs", default="xyzrgbelpsvXYZ")
    parser.add_argument("--pc_augm_scale", default=0, type=float)
    parser.add_argument("--pc_augm_rot", default=1, type=int)
    parser.add_argument("--pc_augm_mirror_prob", default=0, type=float)
    parser.add_argument("--pc_augm_jitter", default=1, type=int)
    parser.add_argument("--pc_xyznormalize", default=1, type=int)
    # Filter generating network
    parser.add_argument("--fnet_widths", default="[32,128,64]")
    parser.add_argument("--fnet_llbias", default=0, type=int)
    parser.add_argument("--fnet_orthoinit", default=1, type=int)
    parser.add_argument("--fnet_bnidx", default=2, type=int)
    parser.add_argument("--edge_mem_limit", default=30000, type=int,
                        help="kept for flag parity; the padded batches bound "
                             "memory instead")
    # Superpoint graph
    parser.add_argument("--spg_attribs01", default=1, type=int)
    parser.add_argument("--spg_augm_nneigh", default=100, type=int)
    parser.add_argument("--spg_augm_order", default=3, type=int)
    parser.add_argument("--spg_augm_hardcutoff", default=512, type=int)
    parser.add_argument("--spg_superedge_cutoff", default=-1, type=float)
    # Point net
    parser.add_argument("--ptn_minpts", default=40, type=int)
    parser.add_argument("--ptn_npts", default=128, type=int)
    parser.add_argument("--ptn_widths",
                        default="[[64,64,128,128,256], [256,64,32]]")
    parser.add_argument("--ptn_widths_stn", default="[[64,64,128], [128,64]]")
    parser.add_argument("--ptn_nfeat_stn", default=11, type=int)
    parser.add_argument("--ptn_prelast_do", default=0, type=float)
    parser.add_argument("--ptn_mem_monger", default=1, type=int)

    args = parser.parse_args(argv)
    args.start_epoch = 0
    args.lr_steps = ast.literal_eval(args.lr_steps)
    args.fnet_widths = ast.literal_eval(args.fnet_widths)
    args.ptn_widths = ast.literal_eval(args.ptn_widths)
    args.ptn_widths_stn = ast.literal_eval(args.ptn_widths_stn)
    return args


def dataset_root(args) -> str:
    return {"s3dis": args.S3DIS_PATH, "sema3d": args.SEMA3D_PATH,
            "vkitti": args.VKITTI_PATH,
            "custom_dataset": args.CUSTOM_SET_PATH}[args.dataset]


def build(args, dbinfo, device=None):
    """(model, trainer, loader_cfg, n_ch) from args (reference
    create_model, main.py:414-431); the model initialised from
    torch.Generator().manual_seed(args.seed), the trainer on `device`
    (default: the card)."""
    loader_cfg = LoaderConfig(
        ptn_npts=args.ptn_npts, ptn_minpts=args.ptn_minpts,
        pc_attribs=args.pc_attribs,
        pc_xyznormalize=bool(args.pc_xyznormalize),
        pc_augm_scale=args.pc_augm_scale, pc_augm_rot=bool(args.pc_augm_rot),
        pc_augm_mirror_prob=args.pc_augm_mirror_prob,
        pc_augm_jitter=bool(args.pc_augm_jitter),
        spg_augm_nneigh=args.spg_augm_nneigh,
        spg_augm_order=args.spg_augm_order,
        spg_augm_hardcutoff=args.spg_augm_hardcutoff)
    n_ch = pc_attrib_dims(args.pc_attribs)
    model = SpgModel(
        n_classes=dbinfo.classes, model_config=args.model_config,
        ptn_widths=tuple(map(tuple, args.ptn_widths)),
        ptn_widths_stn=tuple(map(tuple, args.ptn_widths_stn)),
        ptn_nfeat=n_ch, ptn_nfeat_stn=args.ptn_nfeat_stn,
        ptn_prelast_do=args.ptn_prelast_do,
        fnet_widths=tuple([dbinfo.edge_feats] + list(args.fnet_widths)),
        fnet_orthoinit=bool(args.fnet_orthoinit),
        fnet_llbias=bool(args.fnet_llbias), fnet_bnidx=args.fnet_bnidx)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    trainer = Trainer(
        model, optim=args.optim, lr=args.lr, lr_steps=args.lr_steps,
        lr_decay=args.lr_decay, momentum=args.momentum, wd=args.wd,
        grad_clip=args.grad_clip, class_weights=dbinfo.class_weights,
        checkpoint_ptn=bool(args.ptn_mem_monger), seed=args.seed,
        device=device)
    return model, trainer, loader_cfg, n_ch


def load_sample(entry, name, parsed_rows, loader_cfg, train, rs=None,
                test_seed_offset=0):
    """load_spg_sample over the rows parsed_rows(name) gives; they are
    closed afterwards when they can be (an open h5 file)."""
    rows = parsed_rows(name)
    try:
        return load_spg_sample(entry, rows, loader_cfg, train=train,
                               test_seed_offset=test_seed_offset, rs=rs)
    finally:
        close = getattr(rows, "close", None)
        if close is not None:
            close()


def _account(cm, batch, logits):
    pred = logits.argmax(1).cpu().numpy()
    tsize = batch.target_size.cpu().numpy()
    valid = batch.targets.cpu().numpy() != -100
    cm.count_predicted_batch(tsize[valid][:, 1:], pred[valid])


def run_epoch(trainer, entries, names, parsed_rows, loader_cfg, n_ch, dbinfo,
              train, rng_np, batch_size, test_seed_offset=0, nworkers=0,
              steps_per_dispatch=1, train_step=None):
    """One pass over `entries` (train: shuffled by rng_np, batches of
    batch_size, each stepped by `train_step` when given, the trainer's
    own step otherwise; else one cloud a batch, eval mode). Returns (mean loss,
    ConfusionMatrix, info) with info's host seconds loading and collating
    ("load_s"), seconds in the device steps ("step_s", synchronised by the
    loss fetch), batches and superpoints per batch.

    With nworkers > 0 a thread pool loads and collates the next batches
    while the device steps; the samples then draw from the one rng_np in
    the order the threads reach it, as the JAX CLI does (:200-213), so a
    run is reproducible only with nworkers 0."""
    order = (rng_np.permutation(len(entries)) if train
             else np.arange(len(entries)))
    cm = ConfusionMatrix(dbinfo.classes)
    losses, n_sp = [], []
    info = {"load_s": 0.0, "step_s": 0.0}
    bs = batch_size if train else 1

    def load_batch(idx):
        t0 = time.perf_counter()
        samples = [s for j in idx
                   if (s := load_sample(entries[j], names[j], parsed_rows,
                                        loader_cfg, train, rng_np,
                                        test_seed_offset)) is not None]
        batch = (collate_spg(samples, loader_cfg, dbinfo.classes, n_ch,
                             trainer.device) if samples else None)
        return batch, time.perf_counter() - t0

    groups = [order[i:i + bs] for i in range(0, len(order), bs)]
    pool = None
    if nworkers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=nworkers)
        batches = pool.map(load_batch, groups)
    else:
        batches = (load_batch(g) for g in groups)

    pending = []

    def flush():
        t0 = time.perf_counter()
        out_losses, out_logits = trainer.train_steps(pending,
                                                     step=train_step)
        out_losses = out_losses.cpu().numpy()
        info["step_s"] += time.perf_counter() - t0
        for b, loss, logits in zip(pending, out_losses, out_logits):
            losses.append(float(loss))
            _account(cm, b, logits)
        pending.clear()

    try:
        for batch, load_s in batches:
            info["load_s"] += load_s
            if batch is None:
                continue
            n_sp.append(int(batch.node_mask.sum()))
            if train:
                pending.append(batch)
                if len(pending) >= max(steps_per_dispatch, 1):
                    flush()
                continue
            t0 = time.perf_counter()
            loss, logits = trainer.eval_step(batch)
            losses.append(float(loss))
            info["step_s"] += time.perf_counter() - t0
            _account(cm, batch, logits)
        if pending:
            flush()
    finally:
        if pool is not None:
            pool.shutdown()
    info["batches"] = len(n_sp)
    info["superpoints_per_batch"] = float(np.mean(n_sp)) if n_sp else 0.0
    return (float(np.mean(losses)) if losses else 0.0), cm, info


def eval_final(args, trainer, entries, names, parsed_rows, loader_cfg, n_ch,
               dbinfo):
    """Multisample voting (main.py:267-311): each cloud's logits summed over
    test_multisamp_n samplings reseeded by test_seed_offset 0, 1, ...;
    returns ({name: predicted class per superpoint}, ConfusionMatrix)."""
    cm = ConfusionMatrix(dbinfo.classes)
    predictions = {}
    for entry, name in zip(entries, names):
        acc = None
        for ss in range(max(args.test_multisamp_n, 1)):
            s = load_sample(entry, name, parsed_rows, loader_cfg, False,
                            test_seed_offset=ss)
            if s is None:
                break
            batch = collate_spg([s], loader_cfg, dbinfo.classes, n_ch,
                                trainer.device)
            _, logits = trainer.eval_step(batch)
            logits = logits[:s["node_gt"].shape[0]].cpu().numpy()
            acc = logits if acc is None else acc + logits
        if acc is None:
            continue
        pred = acc.argmax(1)
        predictions[name] = pred
        valid = entry[0].ravel() != -100
        if valid.any():  # (a cloud without labels may have fewer columns)
            cm.count_predicted_batch(entry[1][valid][:, 1:], pred[valid])
    return predictions, cm


def _scores(cm, dbinfo) -> dict:
    return {
        "oacc": cm.get_overall_accuracy(),
        "avg_iou": cm.get_average_intersection_union(),
        "avg_acc": cm.get_mean_class_accuracy(),
        "per_class_iou": {
            dbinfo.inv_class_map[i]: iou
            for i, iou in enumerate(cm.get_intersection_union_per_class())},
    }


def main(argv=None, device=None):
    """The CLI; trains on `device` (default: the card)."""
    import h5py

    from ..data import datasets as ds
    from ..data.spg_io import EdgeFeatScaler
    from ..learn.checkpoint import (load_checkpoint, read_checkpoint_args,
                                    save_checkpoint)
    from ..parallel.dp import make_dp_train_step
    from ..parallel.multihost import get_datasets_multihost, process_info

    args = parse_args(argv)
    device = card_unless(device)
    rank, world = process_info()
    writer = rank == 0
    if writer:
        os.makedirs(args.odir, exist_ok=True)
        with open(os.path.join(args.odir, "cmdline.txt"), "w") as f:
            f.write(" ".join(sys.argv[:1] + (sys.argv[1:] if argv is None
                                             else list(argv))))

    root = dataset_root(args)
    dbinfo = ds.get_info(args.dataset, root, args.edge_attribs,
                         args.pc_attribs, args.loss_weights, args.cvfold)
    if world > 1:
        trainlist, testlist, validlist, scaler = get_datasets_multihost(
            args.dataset, root, args.edge_attribs,
            spg_superedge_cutoff=args.spg_superedge_cutoff,
            spg_attribs01=bool(args.spg_attribs01), cvfold=args.cvfold,
            use_val_set=bool(args.use_val_set),
            db_train_name=args.db_train_name, db_test_name=args.db_test_name)
    else:
        trainlist, testlist, validlist, scaler = ds.get_datasets(
            args.dataset, root, args.edge_attribs, args.spg_superedge_cutoff,
            bool(args.spg_attribs01), args.cvfold, bool(args.use_val_set),
            args.db_train_name, args.db_test_name)
    train_names = [e[4] for e in trainlist]
    test_names = [e[4] for e in testlist]
    valid_names = [e[4] for e in validlist]

    resume_path = ""
    if args.resume:
        resume_path = args.resume
        if not os.path.isfile(resume_path):
            resume_path = os.path.join(args.odir, "model.ckpt")
    build_args = args
    if resume_path:
        # the architecture comes from the checkpoint (main.py:390-412);
        # optimisation and run control stay on the current args
        ckpt_args = read_checkpoint_args(resume_path)
        build_args = argparse.Namespace(**vars(args))
        for key in ARCH_KEYS:
            if key in ckpt_args:
                setattr(build_args, key, ckpt_args[key])
    _, trainer, loader_cfg, n_ch = build(build_args, dbinfo, device)
    rng_np = np.random.RandomState(args.seed)

    def parsed_rows(name):
        return h5py.File(os.path.join(root, "parsed", name + ".h5"), "r")

    stats = []
    if resume_path:
        state, args.start_epoch, _, scaler_state = load_checkpoint(
            resume_path, map_location=trainer.device)
        trainer.load_state_dict(state)
        if scaler_state is not None:
            scaler = EdgeFeatScaler.from_state(scaler_state)
        log = os.path.join(args.odir, "trainlog.json")
        if os.path.isfile(log):
            with open(log) as f:
                stats = json.load(f)

    def ckpt_args():
        return vars(args) | {"lr_steps": list(args.lr_steps)}

    def save(fname, epoch):
        if not writer:
            return
        save_checkpoint(os.path.join(args.odir, fname), trainer.state_dict(),
                        epoch, ckpt_args(),
                        scaler.state_dict() if scaler else None)

    train_step = make_dp_train_step(trainer) if world > 1 else None
    best_val = -1.0
    for epoch in range(args.start_epoch, args.epochs):
        trainer.set_epoch_lr(epoch)
        t0 = time.time()
        tr_loss, tr_cm, _ = run_epoch(
            trainer, trainlist, train_names, parsed_rows, loader_cfg, n_ch,
            dbinfo, True, rng_np, args.batch_size, nworkers=args.nworkers,
            steps_per_dispatch=args.steps_per_dispatch, train_step=train_step)
        entry = {"epoch": epoch, "loss": tr_loss,
                 "acc": 100 * tr_cm.get_overall_accuracy(),
                 "time": time.time() - t0}
        if args.use_val_set and validlist:
            _, v_cm, _ = run_epoch(
                trainer, validlist, valid_names, parsed_rows, loader_cfg,
                n_ch, dbinfo, False, rng_np, 1)
            entry["val_oacc"] = 100 * v_cm.get_overall_accuracy()
            if entry["val_oacc"] > best_val:
                best_val = entry["val_oacc"]
                save("model_best.ckpt", epoch + 1)
        if (testlist and args.test_nth_epoch > 0
                and (epoch + 1) % args.test_nth_epoch == 0):
            _, te_cm, _ = run_epoch(
                trainer, testlist, test_names, parsed_rows, loader_cfg, n_ch,
                dbinfo, False, rng_np, 1)
            entry["oacc"] = 100 * te_cm.get_overall_accuracy()
            entry["avg_iou"] = 100 * te_cm.get_average_intersection_union()
        stats.append(entry)
        print(json.dumps(entry))
        if args.save_nth_epoch > 0 and (epoch + 1) % args.save_nth_epoch == 0:
            save("model.ckpt", epoch + 1)
        if writer:
            with open(os.path.join(args.odir, "trainlog.json"), "w") as f:
                json.dump(stats, f, indent=2)
        if not np.isfinite(tr_loss):
            print("NaN loss, aborting")
            break

    if testlist:
        predictions, cm = eval_final(args, trainer, testlist, test_names,
                                     parsed_rows, loader_cfg, n_ch, dbinfo)
        scores = _scores(cm, dbinfo)
        if writer:
            with h5py.File(os.path.join(
                    args.odir, f"predictions_{args.db_test_name}.h5"),
                    "w") as f:
                for name, pred in predictions.items():
                    f.create_dataset(name.replace("/", "__"),
                                     data=pred.astype(np.int32))
            with open(os.path.join(
                    args.odir, f"scores_{args.db_test_name}.json"), "w") as f:
                json.dump(scores, f, indent=2)
            np.save(os.path.join(args.odir, "pointwise_cm.npy"),
                    cm.confusion_matrix)
        print(json.dumps({"final": scores["oacc"],
                          "miou": scores["avg_iou"]}))


if __name__ == "__main__":
    main()
