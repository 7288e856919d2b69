"""Inference step: loss and logits of one SpgBatch.

Port of superpoint_graph_tpu/learn/train.py (`weighted_ce_loss` 70-83 and
the eval step 170-173). Multisample mean logits and training wait for the
training port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_ce_loss(logits, targets, class_weights=None):
    """Cross entropy ignoring -100 targets, optional per-class weights,
    normalised by the summed sample weights (torch F.cross_entropy)."""
    valid = targets != -100
    t = torch.where(valid, targets, 0)
    nll = -torch.gather(F.log_softmax(logits, -1), 1, t[:, None])[:, 0]
    w = torch.ones_like(nll) if class_weights is None else class_weights[t]
    w = torch.where(valid, w, 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


@torch.no_grad()
def eval_step(model, batch, class_weights=None):
    """(loss, logits) of `model` (in eval mode) on `batch`."""
    if model.training:
        raise ValueError("eval_step needs model.eval()")
    logits = model(batch)
    return weighted_ce_loss(logits, batch.targets, class_weights), logits
