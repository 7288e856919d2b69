"""The nn1 kernel's filter and search, emulated in numpy on the CPU.

csrc/nn1.cu runs only on the card, so its arithmetic is held here: the
expanded-form filter s = fl(|p'|^2 + K - 2 q'.p') on centred float32
coordinates, computed in the kernel's order (fmaf emulated as a float64
product and sum rounded to float32), the chunk minimum taken on the float
bits as int32, the threshold fl(best * NN1_REL + fl(M - fl(|q'|^2))) with
M = margin + K, and the exact re-check of each chunk whose minimum passes
it. The cases are the adversarial clouds of ops/nn1_cases.py (also
chip_smoke.py's) at a small size.
"""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.ops.nn1 import NN1_REL, nn1_frame, nn1_plain
from superpoint_graph_tpu_torch.ops.nn1_cases import nn1_cases

F32 = np.float32
CASES = nn1_cases(seed=3, n_db=3001, n_q=517)


def fma32(a, b, c):
    """fmaf(a, b, c): the float32 product is exact in float64; the sum is
    rounded to float64, then to float32 (double rounding may differ from a
    true FMA by one ulp in rare halfway cases, far inside the margin)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _frame(db, q):
    return nn1_frame(np.stack([db.min(0), db.max(0), q.min(0), q.max(0)]))


def _filter(db, q, centre, shift):
    """(s [n, m], fl(|q'|^2) [n]) as nn1_stage and nn1_scan compute them."""
    p = db - centre
    w = fma32(p[:, 2], p[:, 2], fma32(p[:, 1], p[:, 1],
                                      fma32(p[:, 0], p[:, 0], shift)))
    qc = q - centre
    a = F32(-2) * qc
    s = fma32(a[:, None, 0], p[None, :, 0],
              fma32(a[:, None, 1], p[None, :, 1],
                    fma32(a[:, None, 2], p[None, :, 2], w[None, :])))
    qq = fma32(qc[:, 2], qc[:, 2], fma32(qc[:, 1], qc[:, 1],
                                         qc[:, 0] * qc[:, 0]))
    return s, qq


def _direct(db, q):
    """nn1_plain's distances in float32: ((dx*dx + dy*dy) + dz*dz)."""
    d = q[:, None, :] - db[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _thr(best, aq):
    return fma32(best, F32(NN1_REL), aq)


def _emulate(db, q, tile, tiles_per_split, chunk=32):
    """nn1.cu's search: per split, chunks of `chunk` points, the chunk
    minimum of s against each query's threshold, the exact re-check
    (first minimum of the chunk, strict '<'), then the merge of the splits
    in order. Returns (indices, share of (query, chunk) re-checks)."""
    centre, shift, margin_shift = _frame(db, q)
    s, qq = _filter(db, q, centre, shift)
    d = _direct(db, q)
    aq = margin_shift - qq
    assert (aq >= 0).all()  # so thr >= 0 and a negative s always passes
    n, m = len(q), len(db)
    step = tile * tiles_per_split
    best_all = np.full(n, np.inf, F32)
    arg_all = np.zeros(n, np.int64)
    hits = chunks = 0
    for j0 in range(0, m, step):
        j1 = min(m, j0 + step)
        best = np.full(n, np.inf, F32)
        arg = np.full(n, j0, np.int64)
        thr = np.full(n, np.inf, F32)
        for c in range(j0, j1, chunk):
            e = min(c + chunk, j1)
            mn = s[:, c:e].view(np.int32).min(1).view(F32)
            hit = np.flatnonzero(mn <= thr)
            hits += len(hit)
            chunks += n
            k = d[hit, c:e].argmin(1)
            dk = d[hit, c + k]
            upd = dk < best[hit]
            best[hit] = np.where(upd, dk, best[hit])
            arg[hit] = np.where(upd, c + k, arg[hit])
            thr[hit] = _thr(best[hit], aq[hit])
        upd = best < best_all
        best_all = np.where(upd, best, best_all)
        arg_all = np.where(upd, arg, arg_all)
    return arg_all, hits / chunks


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn1_filter_within_margin(name):
    """For every (query, db point) pair, the float32 filter minus K plus
    fl(|q'|^2) lies within half the margin of the exact squared distance
    (the other half is slack), and nn1_plain's answer passes the threshold
    formed from its own direct-form distance, so the kernel's re-check
    always sees it."""
    db, q = CASES[name]
    centre, shift, margin_shift = _frame(db, q)
    margin = float(margin_shift) - float(shift)
    s, qq = _filter(db, q, centre, shift)
    exact = ((q[:, None, :].astype(np.float64) - db[None]) ** 2).sum(-1)
    err = np.abs(s.astype(np.float64) - float(shift) + qq[:, None] - exact)
    assert err.max() <= margin / 2, (err.max(), margin)
    want = nn1_plain(torch.from_numpy(db), torch.from_numpy(q)).numpy()
    rows = np.arange(len(q))
    d_want = _direct(db, q)[rows, want]
    assert (s[rows, want] <= _thr(d_want, margin_shift - qq)).all()


def test_nn1_plain_is_the_direct_form():
    """nn1_plain (torch on the CPU) returns the first minimum of the
    float32 direct form, the function the kernel's re-check computes."""
    for db, q in CASES.values():
        want = _direct(db, q).argmin(1)
        got = nn1_plain(torch.from_numpy(db), torch.from_numpy(q),
                        block_q=100, block_db=700).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tiles_per_split", [1, 3, 100])
@pytest.mark.parametrize("name", sorted(CASES))
def test_nn1_kernel_search_matches_plain(name, tiles_per_split):
    """The emulated kernel search (tiles of 256 points; one split, or
    splits of 1 and 3 tiles merged in order) gives nn1_plain's indices
    exactly; on the clouds without ties, few chunks go to the re-check."""
    db, q = CASES[name]
    got, share = _emulate(db, q, tile=256, tiles_per_split=tiles_per_split)
    want = nn1_plain(torch.from_numpy(db), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    if name in ("room", "offset_1e3"):
        assert share < 0.5, share


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """The library's name changes with the .cu, with any csrc/*.cuh and
    with the flags, so a stale build is never loaded."""
    from superpoint_graph_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    seen = {_build._digest(src)}
    (tmp_path / "common.cuh").write_text("// header\n")
    seen.add(_build._digest(src))
    (tmp_path / "common.cuh").write_text("// header, edited\n")
    seen.add(_build._digest(src))
    src.write_text("// kernel, edited\n")
    seen.add(_build._digest(src))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    seen.add(_build._digest(src))
    assert len(seen) == 5


def test_ptxas_summary_keeps_registers_and_spills():
    from superpoint_graph_tpu_torch.ops._build import ptxas_summary

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8nn1_scan' for 'sm_90a'
ptxas info    : Function properties for _Z8nn1_scan
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 117 registers, used 1 barriers, 32768 bytes smem
"""
    assert ptxas_summary(log).splitlines() == [
        "Compiling entry function '_Z8nn1_scan' for 'sm_90a'",
        "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "Used 117 registers, used 1 barriers, 32768 bytes smem"]
