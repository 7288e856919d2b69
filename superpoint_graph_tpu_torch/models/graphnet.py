"""GraphNetwork: the ECC graph network assembled from the layer-config DSL.

Port of superpoint_graph_tpu/models/graphnet.py (`FNet`, `GraphNetwork`;
reference learning/graphnet.py:17-99, modules.py). Tokens: `f_K` linear,
`b[_na]` batch norm, `r` relu, `d_p` dropout, `crf_N` ECC-CRF,
`gru_N[_vv[_ln[_ingate[_cat]]]]` / `lstm_...` recurrent ECC (vv=0: matrix
nfeat x nfeat filters; cat: concatenate all N+1 states for the head).
Module names follow the reference state dict: `ecc.{d}` per token,
`ecc.{d}._fnet.{j}`, `ecc.{d}._cell.*`, `ecc.{d}._propagation._fnet.{j}`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .cells import GRUCellEx, LSTMCellEx
from .ecc import ecc_conv
from .norm import Dropout, MaskedBatchNorm
from .pointnet import _run


def make_fnet(widths: Sequence[int], out: int, llbias: bool = True,
              bnidx: int = -1) -> nn.Sequential:
    """Filter-generating MLP over edge features (graphnet.py:17-34):
    [Linear, (BN at bnidx), ReLU]* then a last Linear."""
    ws = list(widths)
    layers = []
    for k in range(len(ws) - 1):
        layers.append(nn.Linear(ws[k], ws[k + 1]))
        if bnidx == k:
            layers.append(MaskedBatchNorm(ws[k + 1]))
        layers.append(nn.ReLU())
    layers.append(nn.Linear(ws[-1], out, bias=llbias))
    return nn.Sequential(*layers)


class RNNGraphConv(nn.Module):
    """gru/lstm token: fnet evaluated once, then N rounds of ecc_conv + cell
    (modules.py:128-183)."""

    def __init__(self, kind, nfeat, nrepeats, vv, layernorm, ingate, cat_all,
                 fnet_widths, fnet_llbias, fnet_bnidx):
        super().__init__()
        self.kind, self.nrepeats, self.vv, self.cat_all = (kind, nrepeats, vv,
                                                           cat_all)
        self.nfeat = nfeat
        self._fnet = make_fnet(fnet_widths, nfeat if vv else nfeat * nfeat,
                               fnet_llbias, fnet_bnidx)
        cell = GRUCellEx if kind == "gru" else LSTMCellEx
        self._cell = cell(nfeat, nfeat, layernorm=layernorm, ingate=ingate)

    def forward(self, h, weights, src, tgt, edge_mask):
        if not self.vv:
            weights = weights.reshape(-1, self.nfeat, self.nfeat)
        hxs = [h]
        cx = torch.zeros_like(h)
        for _ in range(self.nrepeats):
            inp = ecc_conv(h, weights, src, tgt, edge_mask, h.shape[0])
            if self.kind == "gru":
                h = self._cell(inp, h)
            else:
                h, cx = self._cell(inp, (h, cx))
            hxs.append(h)
        return torch.cat(hxs, 1) if self.cat_all else h


class CRFGraphConv(nn.Module):
    """crf token: CRF-as-RNN over matrix filters (modules.py:185-202)."""

    def __init__(self, nfeat, nrepeats, fnet_widths, fnet_llbias, fnet_bnidx):
        super().__init__()
        self.nfeat, self.nrepeats = nfeat, nrepeats
        # the reference keeps the fnet inside its GraphConvModule
        self._propagation = nn.Module()
        self._propagation._fnet = make_fnet(fnet_widths, nfeat * nfeat,
                                            fnet_llbias, fnet_bnidx)

    def forward(self, h, weights, src, tgt, edge_mask):
        weights = weights.reshape(-1, self.nfeat, self.nfeat)
        q = torch.softmax(h, -1)
        for i in range(self.nrepeats):
            q = h - ecc_conv(q, weights, src, tgt, edge_mask, h.shape[0])
            if i < self.nrepeats - 1:
                q = torch.softmax(q, -1)
        return q


class GraphNetwork(nn.Module):
    def __init__(self, config: str, nfeat: int, fnet_widths: Sequence[int],
                 fnet_llbias: bool = True, fnet_bnidx: int = -1):
        super().__init__()
        self.config = config
        for d, conf in enumerate(config.split(",")):
            parts = conf.strip().split("_")
            t = parts[0]
            if t == "f":
                module = nn.Linear(nfeat, int(parts[1]))
                nfeat = int(parts[1])
            elif t == "b":
                module = MaskedBatchNorm(nfeat, affine=len(parts) == 1)
            elif t == "r":
                module = nn.ReLU()
            elif t == "d":
                module = Dropout(float(parts[1]))
            elif t in ("gru", "lstm"):
                nrep = int(parts[1])
                flags = [bool(int(p)) for p in parts[2:6]]
                vv, layernorm, ingate, cat_all = flags + [True] * (4 - len(flags))
                module = RNNGraphConv(t, nfeat, nrep, vv, layernorm, ingate,
                                      cat_all, fnet_widths, fnet_llbias,
                                      fnet_bnidx)
                if cat_all:
                    nfeat *= nrep + 1
            elif t == "crf":
                module = CRFGraphConv(nfeat, int(parts[1]), fnet_widths,
                                      fnet_llbias, fnet_bnidx)
            elif t:
                raise NotImplementedError(f"Unknown module: {t}")
            else:
                module = nn.Identity()
            self.add_module(str(d), module)

    def forward(self, h, edge_feats, src, tgt, edge_mask, node_mask=None,
                edge_feat_idx=None, fnet_mask=None, generator=None):
        """With edge_feat_idx set, `edge_feats` holds the UNIQUE feature rows
        and each fnet output row is gathered back per edge; `fnet_mask`
        masks the fnet's batch-norm rows (defaults to edge_mask);
        `generator` draws the masks of `d` tokens in training mode."""
        if fnet_mask is None:
            fnet_mask = edge_mask
        for module in self.children():
            if isinstance(module, (RNNGraphConv, CRFGraphConv)):
                fnet = (module._fnet if isinstance(module, RNNGraphConv)
                        else module._propagation._fnet)
                weights = _run(fnet, edge_feats, fnet_mask)
                if edge_feat_idx is not None:
                    weights = weights[edge_feat_idx]
                h = module(h, weights, src, tgt, edge_mask)
            elif isinstance(module, MaskedBatchNorm):
                h = module(h, node_mask)
            elif isinstance(module, Dropout):
                h = module(h, generator)
            else:
                h = module(h)
        return h
