"""Closed-form symmetric 3x3 eigendecomposition, batched.

Port of superpoint_graph_tpu/ops/eigen3.py (`eigh3x3`, `eigvals3x3_cols`:
the analytic trigonometric method, element-wise over any batch, in one copy
here). Eigenvalues come out in descending order; eigenvectors are the
columns of eigh3x3's second result.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-20


def eigh3x3(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigvals [..., 3] descending, eigvecs [..., 3, 3] column i for
    eigenvalue i) of symmetric [..., 3, 3] matrices."""
    lams = torch.stack(eigvals3x3_cols(
        cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2], cov[..., 0, 1],
        cov[..., 0, 2], cov[..., 1, 2]), -1)
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


def eigvals3x3_cols(a00, a11, a22, a01, a02, a12):
    """Eigenvalues (descending) of symmetric 3x3 matrices given as six
    coefficient tensors of one shape: the analytic trigonometric method,
    and in the near-diagonal / isotropic case the diagonal's max, middle
    and min (the JAX `eigvals3x3_cols`; `eigh3x3` adds the vectors).
    Returns (lam0, lam1, lam2)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(detb / 2.0, -1.0, 1.0)) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi)
    lam2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    is_diag = p2 <= _EPS * 10.0
    dmax = torch.maximum(torch.maximum(a00, a11), a22)
    dmin = torch.minimum(torch.minimum(a00, a11), a22)
    dmid = a00 + a11 + a22 - dmax - dmin
    return (torch.where(is_diag, dmax, lam0), torch.where(is_diag, dmid, lam1),
            torch.where(is_diag, dmin, lam2))
