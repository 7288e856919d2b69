"""Checks of training steps: one step on two devices, or with the memory
monger on and off, held to TRAIN_TOL.

Used by chip_smoke.py's training phase (checks (b) and (c)), by
tests/test_torch_cuda.py and by tools/torch_train_{phase_cpu,profile}.py;
the training path itself never imports it.

Card against CPU (`card_vs_cpu`) compares the port's own step on both
devices. The model is piecewise smooth: a ReLU passes its gradient only
above zero, and the PointNet's max-pools send each channel's gradient to
the points at its maximum. Where an element lies within rounding of such
a branch point, the two f32 forwards may take different branches and the
gradients jump (a few such elements a step move the PointNet's weight
gradients by ~1e-3 of their largest). Only then, when every such element
is a near-tie (within TIE_REL of its channel's scale), is the CPU's step
run again on the card's branches, and that comparison must hold; the
card's step is always the port's own, and the re-run is printed.
"""
from __future__ import annotations

import contextlib
import copy
import json
import time

import numpy as np
import torch
from torch import nn

from ..models import pointnet
from ..models.norm import MaskedBatchNorm

# the loss (relative), each gradient (of its tensor's largest |g|; those
# zero by construction, bn_fed_biases and pool_fed_biases, of the model's
# largest), the running statistics (of 1 + |value|)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5}
# an element that takes another branch on one device than on the other
# (a ReLU's sign, a max-pool's points at the maximum) must be a near-tie:
# within TIE_REL of its channel's largest |value|
TIE_REL = 1e-5


def bn_fed_biases(model) -> set:
    """Names of the biases of layers whose output goes straight into a
    MaskedBatchNorm. In training mode the batch mean cancels them, so their
    gradient is zero up to rounding: a gradient check holds them to the
    model's largest gradient, not to their own."""
    names = set()
    for prefix, module in model.named_modules():
        kids = list(module.named_children())
        for (name, layer), (_, nxt) in zip(kids, kids[1:]):
            if (isinstance(nxt, MaskedBatchNorm)
                    and getattr(layer, "bias", None) is not None):
                names.add(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return names


def pool_fed_biases(model, pooled, mask) -> set:
    """Names of the batch-norm biases just before a PointNet max-pool whose
    every channel's maximum is positive on every valid superpoint in
    `pooled` (each pool's maxima [N, C] after the ReLU, STN first, as the
    pools run). Such a bias then shifts every pooled value of its channel
    by the same amount; the Linear after the pool turns that into a
    constant shift, which its batch norm cancels: the gradient is zero up
    to rounding, as bn_fed_biases'."""
    nets = [n for n in (model.ptn.stn, model.ptn) if n is not None]
    names = set()
    for net, top in zip(nets, pooled):
        if not (isinstance(net.convs[-2], MaskedBatchNorm)
                and isinstance(net.fcs[1], MaskedBatchNorm)):
            continue
        if bool((top[mask] > 0).all()):
            prefix = "ptn." if net is model.ptn else "ptn.stn."
            names.add(f"{prefix}convs.{len(net.convs) - 2}.bias")
    return names


def grads_of(trainer) -> dict:
    return {k: p.grad.detach().cpu().numpy()
            for k, p in trainer.model.named_parameters()}


def stats_of(trainer) -> dict:
    return {k: b.detach().cpu().numpy()
            for k, b in trainer.model.named_buffers()}


def step_record(trainer, batch):
    """(loss, gradients, buffers) of one training forward and backward."""
    loss, _ = trainer.loss_and_grads(batch)
    return float(loss), grads_of(trainer), stats_of(trainer)


def compare_steps(a, b, label, zero_names, exact_stats=False) -> dict:
    """Two step_records held to TRAIN_TOL (running statistics bit-equal
    with exact_stats). Prints the worst tensors, returns the largest
    errors, raises beyond the bounds."""
    (la, ga, sa), (lb, gb, sb) = a, b
    top = max(float(np.abs(g).max()) for g in gb.values())
    loss_rel = abs(la - lb) / abs(lb)
    rel = {}
    for k, g in gb.items():
        if k in zero_names:
            rel[k] = float(max(np.abs(ga[k]).max(), np.abs(g).max())) / top
        else:
            rel[k] = float(np.abs(np.asarray(ga[k], np.float64) - g).max()
                           / max(float(np.abs(g).max()), 1e-300))
    bad = [k for k in rel if rel[k] > TRAIN_TOL["grad"]]
    worst = sorted(rel, key=rel.get)[-5:]
    print(f"[train] {label}: largest gradient errors (error, largest |g|, "
          "zero by construction) " + json.dumps(
              {k: [rel[k], float(np.abs(gb[k]).max()), k in zero_names]
               for k in worst}))
    stats_err = max(float((np.abs(sa[k] - s) / (1 + np.abs(s))).max())
                    for k, s in sb.items())
    out = {"loss_rel": loss_rel, "grad_rel_max": max(rel.values()),
           "grads_beyond_tol": len(bad), "stats_rel_max": stats_err}
    print(f"[train] {label}: {json.dumps(out)}", flush=True)
    if loss_rel > TRAIN_TOL["loss"] or bad:
        raise AssertionError(f"{label}: loss or gradients disagree {out}, "
                             f"{bad}")
    if exact_stats:
        if not all(np.array_equal(sa[k], s) for k, s in sb.items()):
            raise AssertionError(f"{label}: running statistics differ")
    elif stats_err > TRAIN_TOL["stats"]:
        raise AssertionError(f"{label}: running statistics disagree {out}")
    return out


def _gap(kind, x, own, other):
    """How far from its branch point the input `x` is where `other`'s
    branch differs from `own`, over the channel's scale: a ReLU's |input|,
    a max-pool's maximum less its value at `other`'s points; 0 where they
    agree."""
    if kind == "relu":
        diff = own != other
        away = x.abs()
        scale = away.reshape(-1, x.shape[-1]).amax(0)
    else:
        diff = (own != other).any(1)
        top = x.amax(1)
        away = torch.where(other, top[:, None, :] - x, 0.0).amax(1)
        scale = top.abs().amax(0)
    if not diff.any():
        return 0, 0.0
    return int(diff.sum()), float((away / scale.clamp_min(1e-30))[diff].max())


@contextlib.contextmanager
def branches(model, against=None, follow=None):
    """Within: every nn.ReLU of `model` and the PointNet's max-pools note,
    call by call and on the CPU, the branch each element takes: a ReLU the
    elements above zero, a max-pool the points at each maximum ([N, P, C];
    amax's backward splits the gradient evenly among them), and each
    pool's maxima. With `against` (another run's record, the same calls),
    count the elements whose branch differs and the largest gap (_gap).
    With `follow`, take that run's branches instead: a ReLU passes exactly
    the elements marked, a max-pool takes the mean of the marked points,
    and their gradients go the same way."""
    rec = {"kinds": [], "masks": [], "pooled": [], "gap": 0.0,
           "diffs": {"relu": 0, "pool": 0}}

    def note(kind, x, own):
        i = len(rec["masks"])
        rec["kinds"].append(kind)
        rec["masks"].append(own.cpu())
        if against is not None:
            n, gap = _gap(kind, x.detach().cpu(), rec["masks"][i],
                          against["masks"][i])
            rec["diffs"][kind] += n
            rec["gap"] = max(rec["gap"], gap)
        return None if follow is None else follow["masks"][i].to(x.device)

    def relu_hook(module, inputs, output):
        x = inputs[0]
        m = note("relu", x, x.detach() > 0)
        return None if m is None else x * m.to(x.dtype)

    orig = pointnet.max_pool

    def pool(x):
        x0 = x.detach()
        top = x0.amax(1)
        rec["pooled"].append(top.cpu())
        m = note("pool", x0, x0 == top[:, None, :])
        if m is None:
            return orig(x)
        return torch.where(m, x, 0.0).sum(1) / m.sum(1)

    hooks = [mod.register_forward_hook(relu_hook)
             for mod in model.modules() if isinstance(mod, nn.ReLU)]
    pointnet.max_pool = pool
    try:
        yield rec
    finally:
        pointnet.max_pool = orig
        for h in hooks:
            h.remove()


def card_vs_cpu(fresh, batch, zero_names,
                label="(b) card vs CPU, monger on") -> dict:
    """One training step's forward and backward by fresh(card) on `batch`
    and by fresh("cpu") on its copy, held to TRAIN_TOL (compare_steps;
    zero_names, and the pool_fed_biases of the CPU's forward, are zero by
    construction). Where an element takes another branch on the CPU than
    on the card (a ReLU's sign, a max-pool's points at the maximum), each
    must be a near-tie (TIE_REL), and the CPU's step is run again taking
    the card's branches (printed); the card's step is always its own."""
    dev = batch.clouds.device
    cpu = torch.device("cpu")
    cpu_batch = type(batch)(**{k: None if v is None else v.cpu()
                               for k, v in vars(batch).items()})
    card_t = fresh(dev)
    with branches(card_t.model) as on_card:
        rec_dev = step_record(card_t, batch)
    cpu_t = fresh(cpu)
    with branches(cpu_t.model, against=on_card) as on_cpu:
        rec_cpu = step_record(cpu_t, cpu_batch)
    mask = cpu_batch.cloud_mask
    n_pools = 1 + (cpu_t.model.ptn.stn is not None)
    zero_names = set(zero_names) | pool_fed_biases(
        cpu_t.model, on_cpu["pooled"][:n_pools], mask)
    diffs, gap = sum(on_cpu["diffs"].values()), on_cpu["gap"]
    print(f"[train] {label}: elements whose branch differs from the "
          f"card's: {json.dumps(on_cpu['diffs'])}, largest gap {gap:.3e} "
          "of the channel's scale", flush=True)
    if diffs == 0:
        out = compare_steps(rec_dev, rec_cpu, label, zero_names)
        return dict(out, branch_diffs=0, branch_gap=0.0, followed=False)
    if gap > TIE_REL:
        raise AssertionError(f"{label}: a branch differs beyond a near-tie: "
                             f"{gap:.3e}")
    print(f"[train] {label}: {diffs} near-ties resolved differently; the "
          "CPU's step again taking the card's branches", flush=True)
    cpu_t = fresh(cpu)
    with branches(cpu_t.model, follow=on_card):
        rec_cpu = step_record(cpu_t, cpu_batch)
    out = compare_steps(rec_dev, rec_cpu,
                        label + ", CPU on the card's branches", zero_names)
    return dict(out, branch_diffs=diffs, branch_gap=gap, followed=True)


def trainer_factory(args, dbinfo, state):
    """fresh(device, monger=True): a trainer built by cli/train.build from
    args, with the model weights and running statistics `state`."""
    from ..cli import train as cli_train

    snapshot = {k: v.detach().cpu().clone() for k, v in state.items()}

    def fresh(device, monger=True):
        a = copy.copy(args)
        a.ptn_mem_monger = int(monger)
        _, t, _, _ = cli_train.build(a, dbinfo, device)
        t.model.load_state_dict(snapshot)
        return t

    return fresh


def training_rooms(parts: dict, edge_attribs: str):
    """({name: SPG entry}, {name: parsed rows}) of PartitionResults in
    memory: the caches the training CLI reads from h5 files, without
    them."""
    from ..data.parsed import build_point_matrix, parsed_entries
    from ..data.spg_io import spg_entry

    entries = {n: spg_entry(p.graph_sp, edge_attribs, n)
               for n, p in parts.items()}
    rows = {n: parsed_entries(build_point_matrix(p.xyz, p.rgb, p.geof),
                              p.components) for n, p in parts.items()}
    return entries, rows


def draw_batches(trainlist, names, rows, loader_cfg, dbinfo, n_ch, rng,
                 batch_size, device, k=4):
    """k training batches of batch_size clouds drawn from rng (as
    cli/train.run_epoch draws them) and collated on `device`, with each
    one's host seconds."""
    from ..data.loader import collate_spg, load_spg_sample

    batches, seconds = [], []
    for _ in range(k):
        t0 = time.perf_counter()
        idx = rng.permutation(len(trainlist))[:batch_size]
        samples = [load_spg_sample(trainlist[j], rows[names[j]], loader_cfg,
                                   train=True, rs=rng) for j in idx]
        batches.append(collate_spg(samples, loader_cfg, dbinfo.classes, n_ch,
                                   device))
        seconds.append(time.perf_counter() - t0)
    return batches, seconds
