"""Normalisation layers with padding-mask support (inference).

Port of superpoint_graph_tpu/models/norm.py (`MaskedBatchNorm`,
`instance_norm_row`). Parameter and buffer names are torch BatchNorm1d's
(weight, bias, running_mean, running_var), so state dicts follow the
reference's layout. Batch statistics (training mode) wait for the training
port; in training mode the layer raises.
"""
from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis with running statistics; rows whose mask
    [N] entry is False come out as zeros."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics (training) are not ported "
                "yet (ROADMAP queue 1, training); call .eval()"
            )
        y = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        if mask is not None:
            y = torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)),
                            y, 0.0)
        return y


def instance_norm_row(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each row over its feature axis, no affine (reference
    GRUCellEx 'ini'/'inh', modules.py:212-222)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)
