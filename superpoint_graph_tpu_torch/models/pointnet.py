"""PointNet superpoint embedder with its spatial transformer.

Port of superpoint_graph_tpu/models/pointnet.py (`STNkD`, `PointNet`;
reference learning/pointnet.py:16-133) with the reference's module layout:
`convs` = [Conv1x1, BN, ReLU]*, `fcs` = [Linear, BN, ReLU]* (+ Dropout before
the last Linear when prelast_do > 0, its mask drawn from the generator the
caller passes), `stn.proj`. The norm is MaskedBatchNorm ("batch", the
default) or a one-group GroupNormRow ("layer", and "group" at the JAX
package's n_group of 1, which no caller changes): its `norm` option. Clouds are [n_sp, n_pts, C]
(feature last, the JAX package's layout). Input widths are explicit: the STN
sees the first `nfeat_stn` channels, the conv stack all `nfeat`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import Dropout, GroupNormRow, MaskedBatchNorm


class Conv1x1(nn.Module):
    """A kernel-size-1 Conv1d applied per point on feature-last input; the
    weight keeps Conv1d's [out, in, 1] shape."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 1))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight[..., 0], self.bias)


def _run(seq: nn.Sequential, x, mask, generator=None):
    for layer in seq:
        if isinstance(layer, MaskedBatchNorm):
            x = layer(x, mask)
        elif isinstance(layer, Dropout):
            x = layer(x, generator)
        else:
            x = layer(x)
    return x


def max_pool(x):
    """Max over the points of [n_sp, n_pts, C]; its gradient goes to the
    maximal point (split evenly among exact ties)."""
    return x.amax(1)


def make_norm(norm: str, width: int) -> nn.Module:
    if norm == "batch":
        return MaskedBatchNorm(width)
    if norm in ("layer", "group"):
        return GroupNormRow(1, width)
    raise ValueError(f"unknown norm {norm!r}")


def _conv_stack(n_in: int, widths: Sequence[int],
                norm: str = "batch") -> nn.Sequential:
    layers = []
    for w in widths:
        layers += [Conv1x1(n_in, w), make_norm(norm, w), nn.ReLU()]
        n_in = w
    return nn.Sequential(*layers)


class STNkD(nn.Module):
    """Spatial transformer: a per-superpoint KxK matrix (identity + a
    zero-initialised projection)."""

    def __init__(self, nfeat: int, nf_conv: Sequence[int],
                 nf_fc: Sequence[int], k: int = 2, norm: str = "batch"):
        super().__init__()
        self.k = k
        self.convs = _conv_stack(nfeat, nf_conv, norm)
        layers, n_in = [], nf_conv[-1]
        for w in nf_fc:
            layers += [nn.Linear(n_in, w), make_norm(norm, w), nn.ReLU()]
            n_in = w
        self.fcs = nn.Sequential(*layers)
        self.proj = nn.Linear(n_in, k * k)

    def forward(self, x, mask=None):
        x = max_pool(_run(self.convs, x, mask))
        x = self.proj(_run(self.fcs, x, mask))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device)
        return x.reshape(-1, self.k, self.k) + eye


class PointNet(nn.Module):
    """Superpoint embedder (reference pointnet.py:63-133)."""

    def __init__(self, nf_conv, nf_fc, nf_conv_stn, nf_fc_stn, nfeat: int,
                 nfeat_stn: int = 2, nfeat_global: int = 1,
                 prelast_do: float = 0.5, norm: str = "batch"):
        super().__init__()
        self.nfeat_stn = nfeat_stn
        self.stn = (STNkD(nfeat_stn, nf_conv_stn, nf_fc_stn, norm=norm)
                    if nfeat_stn > 0 else None)
        self.convs = _conv_stack(nfeat, nf_conv, norm)
        layers, n_in = [], nf_conv[-1] + nfeat_global
        for i, w in enumerate(nf_fc):
            layers.append(nn.Linear(n_in, w))
            if i < len(nf_fc) - 1:
                layers += [make_norm(norm, w), nn.ReLU()]
            if i == len(nf_fc) - 2 and prelast_do > 0:
                layers.append(Dropout(prelast_do))
            n_in = w
        self.fcs = nn.Sequential(*layers)

    def forward(self, clouds, clouds_global, mask=None, generator=None):
        """clouds [n_sp, n_pts, C], clouds_global [n_sp, G], mask [n_sp];
        `generator` draws the dropout mask in training mode."""
        x = clouds
        if self.stn is not None:
            t = self.stn(x[..., :self.nfeat_stn], mask)
            # xy' = xy @ T (reference pointnet.py:121-124)
            x = torch.cat([torch.bmm(x[..., :2], t), x[..., 2:]], -1)
        x = max_pool(_run(self.convs, x, mask))
        if clouds_global is not None:
            g = clouds_global if clouds_global.ndim > 1 else clouds_global[:, None]
            x = torch.cat([x, g], -1)
        x = _run(self.fcs, x, mask, generator)
        if mask is not None:
            x = torch.where(mask[:, None], x, 0.0)  # CloudEmbedder zero-fill
        return x
