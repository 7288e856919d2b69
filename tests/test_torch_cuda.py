"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked `cuda` and skips where no CUDA device is visible
(a CUDA kernel has no CPU mode). This file imports neither jax nor the JAX
package, so it also runs on a machine without them; there, from the
repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

nn1's kernel returns nn1_plain's indices exactly (the lowest index among
equal direct-form distances), so every comparison is equality.
"""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.ops.nn1 import nn1, nn1_plain, nn1_plan
from superpoint_graph_tpu_torch.ops.nn1_cases import nn1_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    from superpoint_graph_tpu_torch.device import cuda_device

    return cuda_device(0)


def _check_exact(dev, db, q):
    """nn1 on the card equals nn1_plain on the card, index for index, and
    counts 2 launches (stage, scan) or 3 (and merge) as planned."""
    db_t, q_t = torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev)
    splits, _, _ = nn1_plan(len(q), len(db))
    before = nn1.launches
    got = nn1(db_t, q_t)
    torch.cuda.synchronize()
    assert nn1.launches == before + (2 if splits == 1 else 3)
    want = nn1_plain(db_t, q_t)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got.cpu().numpy(), splits


@pytest.mark.parametrize("n_db,n_q", [(20000, 6000), (2049, 257), (1, 5)])
def test_nn1_kernel_matches_plain(dev, n_db, n_q):
    """Equal indices; exact copies find themselves."""
    rng = np.random.RandomState(0)
    db = rng.rand(n_db, 3).astype(np.float32) * 5
    q = rng.rand(n_q, 3).astype(np.float32) * 5
    n_copy = min(n_db, n_q) // 2
    q[:n_copy] = db[:n_copy]
    got, _ = _check_exact(dev, db, q)
    np.testing.assert_array_equal(got[:n_copy], np.arange(n_copy))


def test_nn1_kernel_ties_lowest_index(dev):
    """Points duplicated across db tiles and splits: the lowest index."""
    rng = np.random.RandomState(1)
    base = rng.rand(1500, 3).astype(np.float32)
    db = np.concatenate([base, base[::-1], base])
    got, splits = _check_exact(dev, db, base)
    assert splits > 1
    np.testing.assert_array_equal(got, np.arange(1500))


@pytest.mark.parametrize("name", ["room", "near_ties_room", "offset_1e3",
                                  "near_ties_offset_1e3", "duplicates",
                                  "one_point"])
@pytest.mark.parametrize("n_db,n_q", [(50_001, 9_999), (1_000, 70_001)])
def test_nn1_kernel_adversarial(dev, name, n_db, n_q):
    """The adversarial clouds of ops/nn1_cases.py, split (a large db
    against few queries) and unsplit (a db of one tile)."""
    db, q = nn1_cases(5, n_db, n_q)[name]
    _, splits = _check_exact(dev, db, q)
    assert (splits > 1) == (n_db > 1024)


@pytest.mark.parametrize("n_db", [1, 31, 33, 1023, 1025, 4097])
@pytest.mark.parametrize("n_q", [1, 63, 65, 511, 513, 8193])
def test_nn1_kernel_size_edges(dev, n_db, n_q):
    """Sizes one off the chunk (32 points), the block's 64 threads, the 512
    queries of a block and the 1024-point tile."""
    rng = np.random.RandomState(n_db * 7 + n_q)
    db = rng.rand(n_db, 3).astype(np.float32) * 4
    q = rng.rand(n_q, 3).astype(np.float32) * 4
    _check_exact(dev, db, q)


def test_nn1_kernel_rejects_mixed_devices(dev):
    with pytest.raises(ValueError):
        nn1(torch.zeros((4, 3), device=dev), torch.zeros((4, 3)))


# ---------------------------------------------------------------- partition
def test_prune_on_card_equals_cpu(dev):
    """The prune on the card gives the CPU's voxels bit for bit: the same
    bins (true division, not a reciprocal multiply) and the same sums (in
    input order within a voxel, not float atomics)."""
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
    from superpoint_graph_tpu_torch.ops.voxel import prune

    xyz, rgb, labels, objects = synthetic_room(
        np.random.RandomState(0), 200_000, noise=0.008, clutter_blobs=True)
    args = (xyz, 0.03, rgb, labels, objects, 6, int(objects.max()) + 1)
    for got, want in zip(prune(*args, device=dev), prune(*args, device="cpu")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("accept", ["global", "region"])
def test_device_solver_on_card_matches_cpu(dev, accept):
    """The device cut pursuit on the card against the same solve on the CPU,
    on planted clusters on a 40 x 60 grid with unit weights: the same
    labels, no CC call at its cap."""
    from superpoint_graph_tpu_torch.ops import cutpursuit_band as cb

    h, w = 40, 60
    idx = np.arange(h * w).reshape(h, w)
    src = np.r_[idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    tgt = np.r_[idx[:, 1:].ravel(), idx[1:, :].ravel()]
    rng = np.random.RandomState(0)
    f = np.zeros((h * w, 3), np.float32)
    f[(idx % w >= w // 3).ravel(), 0] = 1.0
    f[(idx // w >= h // 2).ravel(), 1] = 1.0
    f += rng.randn(h * w, 3).astype(np.float32) * 0.05
    ij = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    xyz = np.c_[ij.reshape(2, -1).T, np.zeros(h * w)].astype(np.float32)
    kw = dict(accept=accept, xyz=xyz, max_iter=16 if accept == "region" else 8)
    _, got = cb.cutpursuit_band(f, src, tgt, np.ones(len(src)), 0.1,
                                device=dev, **kw)
    assert cb.LAST_SOLVE_STATS["cc_capped"] == 0
    _, want = cb.cutpursuit_band(f, src, tgt, np.ones(len(src)), 0.1,
                                 device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


def test_segment_sums_on_card_repeat_bit_for_bit(dev):
    """The solver's segment sums on the card give the same bits on every
    call (a float index_add_ there adds by atomics in no fixed order)."""
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import _Segments

    g = torch.Generator(device=dev).manual_seed(0)
    seg = torch.randint(0, 1000, (2_000_000,), device=dev, generator=g)
    seg[:1_000_000] = 3
    data = torch.randn((2_000_000, 7), device=dev, generator=g)
    segs = _Segments(seg, 1000)
    first = segs.sum(data)
    for _ in range(3):
        assert torch.equal(_Segments(seg, 1000).sum(data), first)


# ---------------------------------------------------------------- giant path
def test_knn_bigcloud_on_card_equals_cpu(dev):
    """The sorted-cell kNN on the card gives the CPU's table, indices and
    squared distances bit for bit (exact re-rank in the same elementwise
    form on both)."""
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud

    xyz, _, _, _ = synthetic_room(np.random.RandomState(0), 60_000)
    outliers = np.random.RandomState(1).rand(30, 3).astype(np.float32) * 40
    xyz = torch.from_numpy(np.concatenate([xyz, outliers + 10]))
    got_i, got_d, info = knn_bigcloud(xyz.to(dev), 45)
    want_i, want_d, _ = knn_bigcloud(xyz, 45)
    assert info["levels"][0]["bad"] > 0
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_d.cpu(), want_d)


def test_chunked_partition_on_card_repeats_bit_for_bit(dev):
    """The chunked device cut pursuit with its merges and heal gives the
    same labels on every call on the card (fixed-order sums throughout),
    with several windows and no capped CC call."""
    from superpoint_graph_tpu_torch import pipeline_big
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
    from superpoint_graph_tpu_torch.ops.geof import compute_geof
    from superpoint_graph_tpu_torch.ops.knn import knn_bigcloud

    xyz, _, _, _ = synthetic_room(np.random.RandomState(2), 60_000)
    xyz = torch.from_numpy(xyz).to(dev)
    idx, d2, _ = knn_bigcloud(xyz, 20)
    f = compute_geof(xyz, idx)
    runs = [pipeline_big.chunked_cutpursuit_device(
        f, idx[:, :10], d2[:, :10], xyz, 0.05, chunk_points=16_384)[1]
        for _ in range(3)]
    assert pipeline_big.LAST_CP_STATS["n_chunks"] >= 4
    assert pipeline_big.LAST_CP_STATS["cc_capped"] == 0
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
