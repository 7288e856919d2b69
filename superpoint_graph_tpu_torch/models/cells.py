"""Recurrent cells of the ECC-RNN: GRU/LSTM with row instance-norm on the
gate pre-activations and a learned input gate.

Port of superpoint_graph_tpu/models/cells.py (reference modules.py:205-316).
Parameter names are the reference's (weight_ih [G*H, in], weight_hh
[G*H, H], bias_ih, bias_hh, ig). GRU biases go AFTER the instance norm;
LSTM biases go BEFORE it (modules.py:299-300).
"""
from __future__ import annotations

import torch
from torch import nn

from .norm import instance_norm_row


class _GatedCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, n_gates: int,
                 layernorm: bool = True, ingate: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.layernorm = layernorm
        g = n_gates * hidden_size
        self.weight_ih = nn.Parameter(torch.empty(g, input_size))
        self.weight_hh = nn.Parameter(torch.empty(g, hidden_size))
        self.bias_ih = nn.Parameter(torch.zeros(g))
        self.bias_hh = nn.Parameter(torch.zeros(g))
        self.ig = nn.Linear(hidden_size, input_size) if ingate else None

    def _gate_input(self, x, h):
        if self.ig is not None:
            x = torch.sigmoid(self.ig(h)) * x
        return x


class GRUCellEx(_GatedCell):
    def __init__(self, input_size, hidden_size, layernorm=True, ingate=True):
        super().__init__(input_size, hidden_size, 3, layernorm, ingate)

    def forward(self, x, h):
        x = self._gate_input(x, h)
        gi = x @ self.weight_ih.T
        gh = h @ self.weight_hh.T
        if self.layernorm:
            gi = instance_norm_row(gi)
            gh = instance_norm_row(gh)
        i_r, i_z, i_n = (gi + self.bias_ih).chunk(3, -1)
        h_r, h_z, h_n = (gh + self.bias_hh).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return n + z * (h - n)


class LSTMCellEx(_GatedCell):
    def __init__(self, input_size, hidden_size, layernorm=True, ingate=True):
        super().__init__(input_size, hidden_size, 4, layernorm, ingate)

    def forward(self, x, hc):
        h, c = hc
        x = self._gate_input(x, h)
        gi = x @ self.weight_ih.T + self.bias_ih
        gh = h @ self.weight_hh.T + self.bias_hh
        if self.layernorm:
            gi = instance_norm_row(gi)
            gh = instance_norm_row(gh)
        i, f, g, o = (gi + gh).chunk(4, -1)
        cy = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(cy), cy
