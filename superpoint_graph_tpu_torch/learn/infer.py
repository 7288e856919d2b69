"""Inference step: loss and logits of one SpgBatch.

Port of the eval step of superpoint_graph_tpu/learn/train.py (170-173);
`weighted_ce_loss` lives in learn/train.py.
"""
from __future__ import annotations

import torch

from .train import weighted_ce_loss

__all__ = ["eval_step", "weighted_ce_loss"]


@torch.no_grad()
def eval_step(model, batch, class_weights=None):
    """(loss, logits) of `model` (in eval mode) on `batch`."""
    if model.training:
        raise ValueError("eval_step needs model.eval()")
    logits = model(batch)
    return weighted_ce_loss(logits, batch.targets, class_weights), logits
