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
