"""Normalisation and dropout layers with padding-mask support.

Port of superpoint_graph_tpu/models/norm.py (`MaskedBatchNorm`,
`GroupNormRow`, `instance_norm_row`). Parameter and buffer names are torch
BatchNorm1d's (weight, bias, running_mean, running_var), so state dicts
follow the reference's layout. In training mode the batch statistics cover
the valid rows only (the JAX package pads its batches to static shapes;
the reference filters invalid superpoints out before the net,
pointnet.py:147-158), and the variance is the biased one both to normalise
and in the running update (flax's, not torch BatchNorm1d's unbiased running
variance).

`recomputing()` marks the forward that torch.utils.checkpoint replays in
backward (the PointNet memory monger, models/spgmodel.py): there the
batch norms leave their running statistics alone, so a step updates them
once, as the JAX package's `jax.checkpoint` does.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

_RECOMPUTE = threading.local()
DECAY = 0.9  # of the running statistics (torch BatchNorm momentum 0.1)


@contextlib.contextmanager
def recomputing():
    """Within this context (in this thread) MaskedBatchNorm does not update
    its running statistics."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis of [N, C] (or [N, P, C], N*P rows) with
    running statistics (decay 0.9); rows whose mask [N] entry is False are
    left out of the batch statistics and come out as zeros."""

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

    def _batch_stats(self, x, mask):
        axes = tuple(range(x.ndim - 1))
        if mask is None:
            return x.mean(axes), x.var(axes, unbiased=False)
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).to(x.dtype)
        # valid rows times the points of each ([N, P, C]: sum(mask) * P)
        cnt = torch.clamp(m.sum() * (x.numel() / (x.shape[-1] * mask.numel())),
                          min=1.0)
        mean = (x * m).sum(axes) / cnt
        var = (((x - mean) ** 2) * m).sum(axes) / cnt
        return mean, var

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        if self.training:
            mean, var = self._batch_stats(x, mask)
            if not getattr(_RECOMPUTE, "on", False):
                with torch.no_grad():
                    self.running_mean.mul_(DECAY).add_((1 - DECAY) * mean)
                    self.running_var.mul_(DECAY).add_((1 - DECAY) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) / torch.sqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        if mask is not None:
            y = torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)),
                            y, 0.0)
        return y


class GroupNormRow(nn.Module):
    """GroupNorm over the channel axis of each row ([..., C], groups of
    C / num_groups channels), with a per-channel affine: the JAX package's
    `GroupNormRow`, the reference's 'layer' (one group) and 'group' norm
    modes (pointnet.py:30-36). No running statistics; the mask is not
    needed (rows are normalised alone)."""

    def __init__(self, num_groups: int, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xg = x.reshape(x.shape[:-1] + (self.num_groups, c // self.num_groups))
        mean = xg.mean(-1, keepdim=True)
        var = xg.var(-1, unbiased=False, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit torch.Generator
    (on the input's device; None: torch's default generator). Identity in
    eval mode or at p = 0. No state: its place in an nn.Sequential keeps
    the reference's module indices."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def instance_norm_row(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each row over its feature axis, no affine (reference
    GRUCellEx 'ini'/'inh', modules.py:212-222)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)
