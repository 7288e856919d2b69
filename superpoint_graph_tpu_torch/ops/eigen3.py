"""Closed-form symmetric 3x3 eigendecomposition, batched.

Port of superpoint_graph_tpu/ops/eigen3.py::eigh3x3 (the analytic
trigonometric method, element-wise over any batch). Eigenvalues come out in
descending order; eigenvectors are the columns of the second result.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-20


def eigh3x3(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigvals [..., 3] descending, eigvecs [..., 3, 3] column i for
    eigenvalue i) of symmetric [..., 3, 3] matrices."""
    a00 = cov[..., 0, 0]
    a11 = cov[..., 1, 1]
    a22 = cov[..., 2, 2]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a12 = cov[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    # B = (A - q I) / p ; r = det(B) / 2 in [-1, 1]
    b00 = (a00 - q) / p
    b11 = (a11 - q) / p
    b22 = (a22 - q) / p
    b01 = a01 / p
    b02 = a02 / p
    b12 = a12 / p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam0 = q + 2.0 * p * torch.cos(phi)                      # largest
    lam2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam0 - lam2

    # degenerate (near-diagonal / isotropic): the sorted diagonal
    diag_sorted = torch.sort(torch.stack([a00, a11, a22], -1), -1,
                             descending=True).values
    is_diag = p2 <= _EPS * 10.0
    lams = torch.where(is_diag[..., None], diag_sorted,
                       torch.stack([lam0, lam1, lam2], -1))
    vecs = torch.stack([_eigvec(cov, lams[..., i]) for i in range(3)], -1)
    return lams, vecs


def _eigvec(cov: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of `cov` for `lam`: the longest of the three pairwise
    cross products of the rows of (A - lam I); e_z when all vanish."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    m = cov - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], -2)  # [..., 3cand, 3]
    idx = torch.argmax((cands * cands).sum(-1), -1)
    v = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    norm2 = (v * v).sum(-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=cov.dtype,
                            device=cov.device).expand_as(v)
    return torch.where(norm2 > _EPS,
                       v * torch.rsqrt(torch.clamp(norm2, min=_EPS)), fallback)
