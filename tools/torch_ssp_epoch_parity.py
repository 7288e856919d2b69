#!/usr/bin/env python3
"""Where two SSP trainings part: the JAX CLI and the port's CLI (on the
CPU) trained on tests/test_torch_ssp_cli.py's tiny tree from the same
initial weights, step by step.

Printed, one JSON object: each step's loss in both packages, their
in-loop partitions (components, equal or not, edges whose loss weight
differs); after the first step, every parameter that differs by more than
1e-5 (elements, largest difference, the port's largest |gradient| there,
and whether the gradient is zero by construction: a bias feeding a batch
norm, or the batch-norm bias before a max-pool); and the second step's
loss taken apart: the port's weights under the JAX partition and the
reverse, the port from the JAX weights, and the port's weights with one
group of parameters replaced by the JAX values. Imports both packages;
~1 minute on a CPU. From the repository root:

    python3 tools/torch_ssp_epoch_parity.py [--epochs 2]
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ROOMS = (("Area_1", "room_0"), ("Area_2", "room_0"), ("Area_2", "room_1"))
PREPROCESS = ["--voxel_width", "0.08", "--k_nn_adj", "5", "--k_nn_local",
              "10", "--plane_model", "1"]


def train_args(epochs):
    return ["--dataset", "s3dis", "--cvfold", "1", "--epochs", str(epochs),
            "--batch_size", "2", "--ptn_widths", "[[16,32],[18,16,4]]",
            "--ptn_widths_stn", "[[8,16],[16,8]]", "--k_nn_local", "10",
            "--max_ver_train", "400", "--CP_cutoff", "5",
            "--cp_backend", "exact"]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    epochs = p.parse_args().epochs
    sys.path.insert(0, str(ROOT))
    import torch

    from superpoint_graph_tpu.cli import ssp_preprocess as preprocess_j
    from superpoint_graph_tpu.cli import ssp_train as train_j
    from superpoint_graph_tpu.ssp import embed as embed_j
    from superpoint_graph_tpu_torch.cli import ssp_train as train_t
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.learn.checkpoint import save_checkpoint
    from superpoint_graph_tpu_torch.learn.convert_jax import (
        convert_local_embedder, flax_to_state_dict)
    from superpoint_graph_tpu_torch.learn.train_check import (
        bn_fed_biases, pooling_nets)
    from superpoint_graph_tpu_torch.ssp.embed import SspTrainer

    argv = train_args(epochs)
    steps = {"j": [], "t": []}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        for i, (area, room) in enumerate(ROOMS):
            write_s3dis_room(base / "j" / "data" / area / room,
                             np.random.RandomState(30 + i), 2500)
        preprocess_j.main(["--ROOT_PATH", str(base / "j"), *PREPROCESS])
        shutil.copytree(base / "j" / "features_supervision",
                        base / "t" / "features_supervision")
        init_j, step_j = embed_j.SspTrainer.init, embed_j.SspTrainer.train_step
        weights_j = embed_j.compute_weight_loss
        states, host_j = [], []

        def init(self, *a, **k):
            states.append(init_j(self, *a, **k))
            return states[-1]

        def weight_loss(*a, **k):
            host_j.append(weights_j(*a, **k))
            return host_j[-1]

        def step(self, state, batch):
            new, loss, comp, in_comp = step_j(self, state, batch)
            steps["j"].append({"loss": loss, "before": state, "after": new,
                               "batch": batch, "weights": host_j[-1][0],
                               "in_comp": np.asarray(in_comp)})
            return new, loss, comp, in_comp

        embed_j.SspTrainer.init, embed_j.SspTrainer.train_step = init, step
        embed_j.compute_weight_loss = weight_loss
        try:
            train_j.main(["--ROOT_PATH", str(base / "j"), "--odir",
                          str(base / "j" / "res"), *argv])
        finally:
            embed_j.SspTrainer.init = init_j
            embed_j.SspTrainer.train_step = step_j
            embed_j.compute_weight_loss = weights_j

        model_cfg, loss_cfg, _ = train_t.configs(vars(train_t.parse_args(argv)))

        def trainer(state=None):
            t = SspTrainer(model_cfg, loss_cfg, device="cpu")
            if state is not None:
                t.model.load_state_dict(state)
            return t

        ref = trainer()

        def to_port(st):
            return flax_to_state_dict({"params": st["params"],
                                       "batch_stats": st["batch_stats"]},
                                      ref.model, convert_local_embedder)

        host_t, step_t = SspTrainer.host_weights, SspTrainer.train_step

        def host(self, emb, batch):
            out = host_t(self, emb, batch)
            steps["t"].append({"weights": out[0], "in_comp": out[2]})
            return out

        def train_step(self, batch):
            loss, comps, in_comp = step_t(self, batch)
            steps["t"][-1].update(
                loss=loss, grads={k: p.grad.detach().clone()
                                  for k, p in self.model.named_parameters()},
                after={k: v.detach().clone()
                       for k, v in self.model.state_dict().items()})
            return loss, comps, in_comp

        path = str(base / "w.ckpt")
        save_checkpoint(path, trainer(to_port(states[0])).state_dict(), 0,
                        vars(train_t.parse_args(argv)), None)
        SspTrainer.host_weights, SspTrainer.train_step = host, train_step
        try:
            train_t.main(["--ROOT_PATH", str(base / "t"), "--odir",
                          str(base / "t" / "res"), *argv, "--resume", path],
                         device="cpu")
        finally:
            SspTrainer.host_weights, SspTrainer.train_step = host_t, step_t

    zero = bn_fed_biases(ref.model)
    pre_pool = {f"{p}convs.{len(n.convs) - 2}.bias"
                for p, n in pooling_nets(ref.model)}
    out = {"steps": []}
    for s, (j, t) in enumerate(zip(steps["j"], steps["t"])):
        out["steps"].append({
            "loss_jax": j["loss"], "loss_port": t["loss"],
            "loss_rel": abs(t["loss"] / j["loss"] - 1),
            "components": [int(j["in_comp"].max() + 1),
                           int(t["in_comp"].max() + 1)],
            "partition_equal": bool(np.array_equal(j["in_comp"],
                                                   t["in_comp"])),
            "edges_weight_differs": int((np.asarray(j["weights"])
                                         != t["weights"]).sum()),
            "edges": len(t["weights"])})
    want = to_port(steps["j"][0]["after"])
    t0 = steps["t"][0]
    differ = {}
    for k, v in t0["after"].items():
        d = (v - want[k]).abs()
        if float(d.max()) > 1e-5:
            g = t0["grads"].get(k)
            differ[k] = {
                "elements": int((d > 1e-5).sum()), "of": v.numel(),
                "max": float(d.max()),
                "port_grad_max_there": (None if g is None else
                                        float(g[d > 1e-5].abs().max())),
                "zero_by_construction": ("bias into a batch norm" if k in zero
                                         else "pre-pool batch-norm bias"
                                         if k in pre_pool else None)}
            if k.endswith("weight") and v.dim() == 2:
                differ[k]["columns"] = sorted(
                    set((d > 1e-5).nonzero()[:, 1].tolist()))
    out["after_step_1_differ"] = differ
    if len(steps["j"]) > 1:
        j1 = steps["j"][1]
        batch = j1["batch"]
        w_j, w_t = j1["weights"], steps["t"][1]["weights"]

        def loss(state, weights):
            tr = trainer(state)
            return float(tr.loss_and_grads(tr.embed_train(batch), batch,
                                           weights))

        own, theirs = t0["after"], to_port(j1["before"])
        split = {"port_weights_jax_partition": loss(own, w_j),
                 "jax_weights_port_partition": loss(theirs, w_t),
                 "jax_weights_jax_partition": loss(theirs, w_j)}
        groups = {"biases into a batch norm": lambda k: k in zero,
                  "pre-pool batch-norm biases": lambda k: k in pre_pool,
                  "ptn.fcs.0.weight": lambda k: k == "ptn.fcs.0.weight"}
        for name, sel in groups.items():
            split[f"port_weights_jax_partition, {name} from JAX"] = loss(
                {k: theirs[k] if sel(k) else v for k, v in own.items()}, w_j)
        out["step_2_loss_rel_to_jax"] = {
            k: abs(v / j1["loss"] - 1) for k, v in split.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
