"""Exact 1-nearest-neighbour search: CUDA kernel and its plain torch version.

Port of superpoint_graph_tpu/ops/nn1_pallas.py. The kernel
(csrc/nn1.cu, `spgt_nn1`) replaces the Pallas `_nn1_kernel`; it is FP32-ALU
bound at 3 subtracts, 3 FMAs and 1 compare per (query, db point) pair (about
1e12 pairs for a 1M-point room against its annotations), and stages db tiles
in shared memory so the db stream stays out of device memory traffic per
pair. Both versions compute d^2 = (q - p)^2 directly and resolve ties to the
lowest db index.

`nn1` dispatches on the tensors' device: the plain version for CPU tensors,
the kernel for CUDA tensors (it raises rather than fall back). `nn1.launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch


def _check(db: torch.Tensor, queries: torch.Tensor) -> None:
    for name, t in (("db", db), ("queries", queries)):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be float32 [n, 3], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if db.device != queries.device:
        raise ValueError(f"db on {db.device}, queries on {queries.device}")
    if max(len(db), len(queries)) >= 2**31:
        raise ValueError("nn1 takes fewer than 2**31 points per side")


def nn1_plain(db: torch.Tensor, queries: torch.Tensor,
              block_q: int = 4096, block_db: int = 65536) -> torch.Tensor:
    """Plain torch version: blocked argmin over direct (q - p)^2 tiles, with
    a strict-'<' running minimum across db blocks (lowest index on ties)."""
    n, m = len(queries), len(db)
    out = torch.zeros(n, dtype=torch.int64, device=queries.device)
    if n == 0 or m == 0:
        return out[:0]
    for i in range(0, n, block_q):
        q = queries[i:i + block_q]
        best_d = torch.full((len(q),), float("inf"), device=q.device)
        best_i = torch.zeros(len(q), dtype=torch.int64, device=q.device)
        for j in range(0, m, block_db):
            p = db[j:j + block_db]
            d = (q[:, None, 0] - p[None, :, 0]) ** 2
            d += (q[:, None, 1] - p[None, :, 1]) ** 2
            d += (q[:, None, 2] - p[None, :, 2]) ** 2
            tile_d, tile_i = torch.min(d, dim=1)
            upd = tile_d < best_d
            best_d = torch.where(upd, tile_d, best_d)
            best_i = torch.where(upd, tile_i + j, best_i)
        out[i:i + block_q] = best_i
    return out


def nn1_cuda(db: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Launch csrc/nn1.cu on the current stream; no synchronisation."""
    from ._build import load

    lib = load("nn1")
    fn = lib.spgt_nn1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    db = db.contiguous()
    queries = queries.contiguous()
    out = torch.empty(len(queries), dtype=torch.int64, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), db.data_ptr(), len(queries), len(db),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: CUDA error {err}")
    nn1.launches += 1
    return out


def nn1(db: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index (int64) of the nearest db point for every query, exact.

    Empty db or queries give an empty result, as in the JAX package."""
    _check(db, queries)
    if len(db) == 0 or len(queries) == 0:
        return torch.zeros(0, dtype=torch.int64, device=queries.device)
    if queries.device.type == "cpu":
        return nn1_plain(db, queries)
    if queries.device.type == "cuda":
        return nn1_cuda(db, queries)
    raise ValueError(f"nn1 runs on cpu or cuda tensors, not {queries.device}")


nn1.launches = 0
