"""Checks of training steps: one step on two devices, or with the memory
monger on and off, held to TRAIN_TOL.

Used by chip_smoke.py's training phases (checks (b) and (c); the SSP
step's card against CPU), by tests/test_torch_cuda.py and by
tools/torch_train_{phase_cpu,profile}.py; the training paths themselves
never import it.

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
# largest), the running statistics (of 1 + |value|); in the SSP step each
# channel of a batch-norm bias before a max-pool (of its cancelled sum,
# pool_residue_scales; chip_smoke.py prints the card's error over it)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5, "residue": 1e-6}
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


def pooling_nets(model) -> list:
    """[(state-dict prefix, net)] of the max-pooling nets of `model` in the
    order their pools run: the SPG model's PointNet STN, then its PointNet;
    the SSP LocalEmbedder's STN, then its PointNet."""
    nets = []
    if getattr(model, "stn", None) is not None:
        nets.append(("stn.", model.stn))
    if model.ptn.stn is not None:
        nets.append(("ptn.stn.", model.ptn.stn))
    return nets + [("ptn.", model.ptn)]


def pool_fed_biases(model, pooled, mask) -> set:
    """Names of the batch-norm biases just before a PointNet max-pool whose
    every channel's maximum is positive on every valid row (mask None: all
    rows) in `pooled` (each pool's maxima [N, C] after the ReLU, as the
    pools run). Such a bias then shifts every pooled value of its channel
    by the same amount; the Linear after the pool turns that into a
    constant shift, which its batch norm cancels: the gradient is zero up
    to rounding, as bn_fed_biases'."""
    names = set()
    for (prefix, net), top in zip(pooling_nets(model), pooled):
        if not (isinstance(net.convs[-2], MaskedBatchNorm)
                and isinstance(net.fcs[1], MaskedBatchNorm)):
            continue
        if bool(((top if mask is None else top[mask]) > 0).all()):
            names.add(f"{prefix}convs.{len(net.convs) - 2}.bias")
    return names


def pool_residue_scales(model, pooled_grads) -> dict:
    """{name: [C] float64} for each batch-norm bias just before a PointNet
    max-pool whose pooled channels feed a Linear and a batch norm
    (pool_fed_biases' layers, whatever the signs): each channel's cancelled
    sum, the upstream gradient's |value| summed over the rows of
    `pooled_grads` (each pool's gradient [N, C], as the pools run;
    branches records them).

    A channel's gradient is the upstream gradient summed over the rows
    whose maximum is positive; the next batch norm makes the sum over all
    rows zero, so the value is a residue: zero where every row's maximum
    is positive, else minus the other rows' sum. Float32 rounds it at the
    scale of the cancelled sum, not of the residue, so compare_steps holds
    each channel's difference to TRAIN_TOL["residue"] of that sum (the
    SSP step; chip_smoke.py prints each channel's error over it)."""
    out = {}
    for (prefix, net), g in zip(pooling_nets(model), pooled_grads):
        if (g is not None and isinstance(net.convs[-2], MaskedBatchNorm)
                and isinstance(net.fcs[1], MaskedBatchNorm)):
            out[f"{prefix}convs.{len(net.convs) - 2}.bias"] = (
                g.abs().double().sum(0).numpy())
    return out


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


def compare_steps(a, b, label, zero_names, exact_stats=False,
                  residue_scales=None) -> dict:
    """Two step_records held to TRAIN_TOL (running statistics bit-equal
    with exact_stats): each gradient's difference to its tensor's largest,
    the gradients of `zero_names` themselves to the model's largest, and
    each channel's difference of those in `residue_scales`
    (pool_residue_scales) to its cancelled sum. Prints the worst tensors,
    returns the largest errors, raises beyond the bounds."""
    (la, ga, sa), (lb, gb, sb) = a, b
    residue_scales = residue_scales or {}
    top = max(float(np.abs(g).max()) for g in gb.values())
    loss_rel = abs(la - lb) / abs(lb)
    rel, tol = {}, {}
    for k, g in gb.items():
        diff = np.abs(np.asarray(ga[k], np.float64) - g)
        tol[k] = TRAIN_TOL["grad"]
        if k in zero_names:
            rel[k] = float(max(np.abs(ga[k]).max(), np.abs(g).max())) / top
        elif k in residue_scales:
            scale = residue_scales[k]
            rel[k] = float(np.where(diff > 0, diff / np.maximum(scale, 1e-300),
                                    0.0).max())
            tol[k] = TRAIN_TOL["residue"]
        else:
            rel[k] = float(diff.max()) / max(float(np.abs(g).max()), 1e-300)
    bad = [k for k in rel if rel[k] > tol[k]]
    worst = sorted(rel, key=lambda k: rel[k] / tol[k])[-5:]
    print(f"[train] {label}: largest gradient errors (error, bound, largest "
          "|g|, zero by construction) " + json.dumps(
              {k: [rel[k], tol[k], float(np.abs(gb[k]).max()),
                   k in zero_names] for k in worst}))
    if residue_scales:
        print(f"[train] {label}: each pre-pool batch-norm bias's largest "
              "channel error over its cancelled sum (bound "
              f"{TRAIN_TOL['residue']}) " + json.dumps(
                  {k: rel[k] for k in residue_scales}))
    stats_err = max(float((np.abs(sa[k] - s) / (1 + np.abs(s))).max())
                    for k, s in sb.items())
    out = {"loss_rel": loss_rel,
           "grad_rel_max": max(rel[k] for k in rel if k not in residue_scales),
           "grads_beyond_tol": len(bad), "stats_rel_max": stats_err}
    if residue_scales:
        out["residue_rel_max"] = max(rel[k] for k in residue_scales)
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
    amax's backward splits the gradient evenly among them), each pool's
    maxima and, after the backward, their gradient. With `against`
    (another run's record, the same calls), count the elements whose
    branch differs and the largest gap (_gap).
    With `follow`, take that run's branches instead: a ReLU passes exactly
    the elements marked, a max-pool takes the mean of the marked points,
    and their gradients go the same way."""
    rec = {"kinds": [], "masks": [], "pooled": [], "pooled_grads": [],
           "gap": 0.0, "diffs": {"relu": 0, "pool": 0}}

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
        rec["pooled_grads"].append(None)
        m = note("pool", x0, x0 == top[:, None, :])
        out = (orig(x) if m is None
               else torch.where(m, x, 0.0).sum(1) / m.sum(1))
        if out.requires_grad:
            i = len(rec["pooled"]) - 1
            out.register_hook(lambda g: rec["pooled_grads"].__setitem__(
                i, g.detach().cpu()))
        return out

    hooks = [mod.register_forward_hook(relu_hook)
             for mod in model.modules() if isinstance(mod, nn.ReLU)]
    pointnet.max_pool = pool
    try:
        yield rec
    finally:
        pointnet.max_pool = orig
        for h in hooks:
            h.remove()


def ssp_step_record(weights):
    """A step_record for the SSP trainer (ssp/embed.py) with the loss
    weights `weights` fixed: the training forward, the loss under them and
    its backward."""
    def record(trainer, batch):
        emb = trainer.embed_train(batch)
        loss = trainer.loss_and_grads(emb, batch, weights)
        return float(loss), grads_of(trainer), stats_of(trainer)

    return record


def card_vs_cpu(fresh, batch, zero_names,
                label="(b) card vs CPU, monger on", record=step_record,
                device=None) -> dict:
    """One training step's forward and backward by fresh(card) on `batch`
    and by fresh("cpu") on its copy, held to TRAIN_TOL (compare_steps).
    `batch` is an SpgBatch on the card: zero_names, and the
    pool_fed_biases of the CPU's forward, are zero by construction. Or it
    is a host dict that both trainers read (the SSP step, with `device`
    the card and `record` its ssp_step_record): zero_names are zero by
    construction, and each channel of a pre-pool batch-norm bias is held
    to its cancelled sum in the CPU's step (pool_residue_scales). Where an
    element takes another branch on the CPU than on the card (a ReLU's
    sign, a max-pool's points at the maximum), each must be a near-tie
    (TIE_REL), and the CPU's step is run again taking the card's branches
    (printed); the card's step is always its own."""
    cpu = torch.device("cpu")
    ssp = isinstance(batch, dict)
    if ssp:
        dev, cpu_batch = device, batch
    else:
        dev = batch.clouds.device
        cpu_batch = type(batch)(**{k: None if v is None else v.cpu()
                                   for k, v in vars(batch).items()})
    card_t = fresh(dev)
    with branches(card_t.model) as on_card:
        rec_dev = record(card_t, batch)
    cpu_t = fresh(cpu)
    with branches(cpu_t.model, against=on_card) as on_cpu:
        rec_cpu = record(cpu_t, cpu_batch)

    def bounds(rec):
        """(zero_names, residue_scales) of the CPU's step `rec`."""
        if ssp:
            return set(zero_names), pool_residue_scales(
                cpu_t.model, rec["pooled_grads"])
        n_pools = 1 + (cpu_t.model.ptn.stn is not None)
        return set(zero_names) | pool_fed_biases(
            cpu_t.model, rec["pooled"][:n_pools], cpu_batch.cloud_mask), None

    diffs, gap = sum(on_cpu["diffs"].values()), on_cpu["gap"]
    print(f"[train] {label}: elements whose branch differs from the "
          f"card's: {json.dumps(on_cpu['diffs'])}, largest gap {gap:.3e} "
          "of the channel's scale", flush=True)
    if diffs == 0:
        zero, scales = bounds(on_cpu)
        out = compare_steps(rec_dev, rec_cpu, label, zero,
                            residue_scales=scales)
        return dict(out, branch_diffs=0, branch_gap=0.0, followed=False)
    if gap > TIE_REL:
        raise AssertionError(f"{label}: a branch differs beyond a near-tie: "
                             f"{gap:.3e}")
    print(f"[train] {label}: {diffs} near-ties resolved differently; the "
          "CPU's step again taking the card's branches", flush=True)
    cpu_t = fresh(cpu)
    with branches(cpu_t.model, follow=on_card) as followed:
        rec_cpu = record(cpu_t, cpu_batch)
    zero, scales = bounds(followed if ssp else on_cpu)
    out = compare_steps(rec_dev, rec_cpu,
                        label + ", CPU on the card's branches", zero,
                        residue_scales=scales)
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


def ssp_trainer_factory(model_cfg, loss_cfg, state):
    """fresh(device, dtype=None): an SspTrainer of these configs with the
    model weights and running statistics `state`, in `dtype` (default:
    float32 on the card, float64 on the CPU).

    The CPU's step is the reference in float64, so that the check reads
    the card's float32 error alone, not the sum of two float32 errors
    (chip_smoke.py prints each float32 step's distance from it)."""
    from ..ssp.embed import SspTrainer

    snapshot = {k: v.detach().cpu().clone() for k, v in state.items()}

    def fresh(device, dtype=None):
        if dtype is None:
            dtype = (torch.float64 if torch.device(device).type == "cpu"
                     else torch.float32)
        t = SspTrainer(model_cfg, loss_cfg, device=device, dtype=dtype)
        t.model.load_state_dict(snapshot)
        return t

    return fresh


def training_rooms(parts: dict, edge_attribs: str, style: str = "s3dis"):
    """({name: SPG entry}, {name: parsed rows in `style`}) of
    PartitionResults in memory: the caches the training CLI reads from h5
    files, without them."""
    from ..data.parsed import build_point_matrix, parsed_entries
    from ..data.spg_io import spg_entry

    entries = {n: spg_entry(p.graph_sp, edge_attribs, n)
               for n, p in parts.items()}
    rows = {n: parsed_entries(build_point_matrix(p.xyz, p.rgb, p.geof, style),
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
