"""Exact 1-nearest-neighbour search: CUDA kernel and its plain torch version.

Port of superpoint_graph_tpu/ops/nn1_pallas.py. The kernel
(csrc/nn1.cu, `spgt_nn1`) replaces the Pallas `_nn1_kernel`. It is bound by
instruction issue (about 1e12 (query, db point) pairs for a 1M-point room
against its annotations): an expanded-form filter on coordinates centred on
the db's bounding box costs 3 FMAs and half an integer min a pair, and only
chunks that may hold a closer point are re-checked in the direct form.
`nn1_margin` bounds the filter's rounding, so the kernel returns
`nn1_plain`'s indices exactly:
the lowest db index among the equal smallest direct-form distances
fl(fl(dx*dx + dy*dy) + dz*dz), dx = fl(qx - px).

`nn1` dispatches on the tensors' device: the plain version for CPU tensors,
the kernel for CUDA tensors (it raises rather than fall back).
`nn1.launches` counts kernel launches: 2 a call (stage, scan), 3 when the db
is split across blocks (and merged).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_U = 2.0 ** -24  # unit roundoff of float32
# thr = fl(best * NN1_REL + (margin + K) - fl(|q'|^2)) in the kernel; covers
# the direct form's relative rounding (5u) and the threshold's own (2u)
NN1_REL = 1.0 + 16 * _U


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


def nn1_margin(p_max: float, q_max: float, shift: float) -> float:
    """Absolute slack of the kernel's filter threshold, for centred db points
    within `p_max` and centred queries within `q_max` of the centre
    (Euclidean norms, bounds on the float32 values the kernel holds) and the
    filter's shift K (csrc/nn1.cu, steps 1 and 4).

    With u = 2^-24: the filter s = fl(|p'|^2 + K - 2 q'.p') (the staged
    |p'|^2 + K and three FMAs) is within 3u (2P^2 + 2PQ + 2K) of its exact
    value; centring moves |q - p|^2 by at most 2u (P + Q)^2; fl(|q'|^2) is
    within 3u Q^2; forming the threshold adds at most 2u (M + Q^2) beyond
    what NN1_REL covers. A point whose direct-form distance is below the
    query's best therefore has s <= thr whenever the margin is at least
    u (8P^2 + 10PQ + 7Q^2 + 8K). This returns twice that (and a floor far
    below any float32 rounding of a real cloud, for a cloud of one point)."""
    p, q, k = float(p_max), float(q_max), float(shift)
    return 2 * _U * (8 * p * p + 10 * p * q + 7 * q * q + 8 * k) + 2.0 ** -120


def _reach(lo: np.ndarray, hi: np.ndarray, centre: np.ndarray) -> float:
    """Largest distance from `centre` to a point of the box [lo, hi],
    rounded up past the float32 rounding of the centred coordinates."""
    far = np.maximum(np.abs(lo - centre), np.abs(hi - centre))
    return float(np.sqrt((far * far).sum())) * (1 + 2.0 ** -20)


def _up(x: float) -> np.float32:
    """x as a float32 no smaller than x."""
    f = np.float32(x)
    return f if f >= x else np.nextafter(f, np.float32(np.inf))


def nn1_frame(box) -> tuple[np.ndarray, np.float32, np.float32]:
    """The kernel's centre (float32 [3], the db bounding box's centre),
    shift K (float32, at least every query's fl(|q'|^2)) and margin + K
    (float32, rounded up), from `box` = [4, 3] rows: db min, db max,
    queries min, queries max."""
    box = np.asarray(box, np.float64)
    if not np.isfinite(box).all():
        raise ValueError("nn1 takes finite coordinates")
    centre = ((box[0] + box[1]) / 2).astype(np.float32)
    c64 = centre.astype(np.float64)
    p_max, q_max = _reach(box[0], box[1], c64), _reach(box[2], box[3], c64)
    shift = _up(q_max * q_max * (1 + 2.0 ** -20))
    margin = nn1_margin(p_max, q_max, shift)
    return centre, shift, _up(margin + float(shift))


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    return bind(load("nn1"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded nn1 library."""
    lib.spgt_nn1_plan.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.spgt_nn1_plan.restype = ctypes.c_int
    lib.spgt_nn1.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * 6
        + [ctypes.c_void_p] * 4)
    lib.spgt_nn1.restype = ctypes.c_int
    return lib


def nn1_plan(n: int, m: int) -> tuple[int, int, int]:
    """The kernel's launch shape for n queries against m db points on the
    current device: (db splits, tiles per split, staged db rows). More than
    one split when the query blocks alone would make fewer than two waves
    on the SMs, or a ragged last wave."""
    splits, tiles, m_pad = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().spgt_nn1_plan(n, m, ctypes.byref(splits), ctypes.byref(tiles),
                               ctypes.byref(m_pad))
    if err != 0:
        raise RuntimeError(f"nn1 launch plan failed: CUDA error {err}")
    return splits.value, tiles.value, m_pad.value


def nn1_cuda(db: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Launch csrc/nn1.cu on the current stream. Reads the two clouds'
    bounding boxes back to the host first (one small synchronising copy)
    to centre them and size the margin."""
    db = db.contiguous()
    queries = queries.contiguous()
    n, m = len(queries), len(db)
    centre, shift, margin_shift = nn1_frame(torch.stack([
        db.amin(0), db.amax(0), queries.amin(0), queries.amax(0)]).cpu())
    dev = queries.device
    with torch.cuda.device(dev):
        splits, tiles, m_pad = nn1_plan(n, m)
        db4 = torch.empty((m_pad, 4), dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.int64, device=dev)
        part_d = part_i = None
        if splits > 1:
            part_d = torch.empty((splits, n), dtype=torch.float32, device=dev)
            part_i = torch.empty((splits, n), dtype=torch.int32, device=dev)
        err = _lib().spgt_nn1(
            queries.data_ptr(), db.data_ptr(), db4.data_ptr(), n, m, m_pad,
            splits, tiles, *map(float, centre), float(shift),
            float(margin_shift), NN1_REL,
            None if part_d is None else part_d.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: CUDA error {err}")
    nn1.launches += 2 if splits == 1 else 3
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
