"""Per-point local geometric features: linearity, planarity, scattering,
verticality.

Port of superpoint_graph_tpu/ops/geof.py (`compute_geof`,
`compute_geof_rows`); semantics of the reference C++ kernel
(ply_c.cpp:384-462): covariance of [self; k neighbours] normalised by (k+1),
eigenvalues sorted descending and clamped at 0,
  linearity   = (sqrt(l1) - sqrt(l2)) / sqrt(l1)
  planarity   = (sqrt(l2) - sqrt(l3)) / sqrt(l1)
  scattering  = sqrt(l3) / sqrt(l1)
  verticality = z of unit(sum_i l_i |v_i|).
The _EPS placements are the JAX version's, so degenerate neighbourhoods give
the same values.
"""
from __future__ import annotations

import torch

from .eigen3 import eigh3x3

_EPS = 1e-10


def compute_geof_rows(xyz_full: torch.Tensor, xyz_rows: torch.Tensor,
                      neighbors_rows: torch.Tensor) -> torch.Tensor:
    """Features [m, 4] f32 of the query points `xyz_rows` [m, 3] whose
    neighbours `neighbors_rows` [m, k] index into `xyz_full`."""
    k = neighbors_rows.shape[1]
    pos = torch.cat([xyz_rows[:, None, :], xyz_full[neighbors_rows]], 1)
    centered = pos - pos.mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / float(k + 1)

    lams, vecs = eigh3x3(cov)
    lams = torch.clamp(lams, min=0.0)
    s0 = torch.sqrt(lams[:, 0] + _EPS)
    s1 = torch.sqrt(lams[:, 1])
    s2 = torch.sqrt(lams[:, 2])
    # unary vector: sum_i lambda_i * |v_i| (ply_c.cpp:443-448)
    unary = torch.einsum("ni,nji->nj", lams, vecs.abs())
    norm = torch.sqrt((unary * unary).sum(-1) + _EPS)
    return torch.stack(
        [(s0 - s1) / s0, (s1 - s2) / s0, s2 / s0, unary[:, 2] / norm], -1
    ).to(torch.float32)


def compute_geof(xyz: torch.Tensor, neighbors: torch.Tensor,
                 chunk: int = 1 << 18) -> torch.Tensor:
    """Features [n, 4] of every point of a cloud; `neighbors` [n, k] excludes
    the point itself. Rows go in chunks of `chunk` to bound the [m, k+1, 3]
    gather."""
    return torch.cat([
        compute_geof_rows(xyz, xyz[s:s + chunk], neighbors[s:s + chunk])
        for s in range(0, len(xyz), chunk)
    ]) if len(xyz) else xyz.new_zeros((0, 4))
