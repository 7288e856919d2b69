"""Data-parallel training: one process a rank, each with its own batch and
a replica of the model, the gradients averaged over a `torch.distributed`
group.

Port of superpoint_graph_tpu/parallel/dp.py (`make_dp_train_step`,
`make_dp_eval_step`). The JAX package runs the ranks as the devices of one
`shard_map`; here each rank is a process (multihost.initialize: NCCL
between cards, gloo on the CPU) stepping the port's `Trainer`, with the
JAX step's semantics:

1. the rank's forward and backward on its own batch, with the batch
   statistics of that batch (the JAX `local_step`), its dropout from a
   generator seeded by rank (the JAX `fold_in(rng, axis_index)`);
2. the mean over ranks of the loss and of every gradient (`pmean`, :56-57)
   and of every masked batch norm's running mean and variance after this
   step's local update (:58): the mean of the updated buffers, neither
   `SyncBatchNorm` nor DDP's broadcast of rank 0's buffers;
3. the clamp and the optimizer step on the mean gradient, identical on
   every rank (optax's chain after the pmean).

The loss is the mean of the ranks' means, not a mean over their pooled
superpoints. One all-reduce a step carries the loss, the gradients and the
running statistics. The JAX `stack_device_batches` and `shard_batch` have
no counterpart: a rank collates its own batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.norm import MaskedBatchNorm


def allreduce_mean(tensors, group=None) -> None:
    """Each tensor replaced in place by its mean over the group's ranks:
    one all-reduce (sum) of their concatenation, then / world size."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def running_stats(model) -> list:
    """The running means and variances of the model's masked batch norms."""
    return [b for m in model.modules() if isinstance(m, MaskedBatchNorm)
            for b in (m.running_mean, m.running_var)]


def make_dp_train_step(trainer, group=None):
    """step(batch) -> (loss, logits): one data-parallel training step of
    `trainer` on this rank's batch (module docstring); the loss is the mean
    over ranks, the logits this rank's. Needs an initialised group."""
    rank = dist.get_rank(group)
    generator = torch.Generator(trainer.device).manual_seed(
        trainer.generator.initial_seed() + rank)
    stats = running_stats(trainer.model)

    def step(batch):
        loss, logits = trainer.loss_and_grads(batch, generator)
        allreduce_mean([loss] + [p.grad for p in trainer.params] + stats,
                       group)
        trainer.apply_grads()
        return loss, logits

    return step


def make_dp_eval_step(trainer, group=None):
    """step(batch) -> (loss, logits): evaluation of this rank's batch, the
    loss the mean over ranks, the logits this rank's."""

    def step(batch):
        loss, logits = trainer.eval_step(batch)
        allreduce_mean([loss], group)
        return loss, logits

    return step
