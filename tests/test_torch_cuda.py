"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked `cuda` and skips where no CUDA device is visible
(a CUDA kernel has no CPU mode). This file imports neither jax nor the JAX
package, so it also runs on a machine without them; there, from the
repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from superpoint_graph_tpu_torch.ops.nn1 import nn1, nn1_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    from superpoint_graph_tpu_torch.device import cuda_device

    return cuda_device(0)


@pytest.mark.parametrize("n_db,n_q", [(20000, 6000), (2049, 257), (1, 5)])
def test_nn1_kernel_matches_plain(dev, n_db, n_q):
    """Squared distances of the chosen points within rtol 1e-4, atol 1e-6;
    >= 99.9% equal indices; exact copies find themselves; one launch."""
    rng = np.random.RandomState(0)
    db = rng.rand(n_db, 3).astype(np.float32) * 5
    q = rng.rand(n_q, 3).astype(np.float32) * 5
    n_copy = min(n_db, n_q) // 2
    q[:n_copy] = db[:n_copy]
    db_t, q_t = torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev)
    before = nn1.launches
    got = nn1(db_t, q_t).cpu().numpy()
    torch.cuda.synchronize()
    assert nn1.launches == before + 1
    want = nn1_plain(db_t, q_t).cpu().numpy()
    np.testing.assert_allclose(((q - db[got]) ** 2).sum(1),
                               ((q - db[want]) ** 2).sum(1),
                               rtol=1e-4, atol=1e-6)
    assert (got == want).mean() >= 0.999
    np.testing.assert_array_equal(got[:n_copy], np.arange(n_copy))


def test_nn1_kernel_ties_lowest_index(dev):
    """Points duplicated across db tiles (tile = 2048): the lowest index."""
    rng = np.random.RandomState(1)
    base = rng.rand(1500, 3).astype(np.float32)
    db = np.concatenate([base, base[::-1], base])
    got = nn1(torch.from_numpy(db).to(dev), torch.from_numpy(base).to(dev))
    np.testing.assert_array_equal(got.cpu().numpy(), np.arange(1500))


def test_nn1_kernel_rejects_mixed_devices(dev):
    with pytest.raises(ValueError):
        nn1(torch.zeros((4, 3), device=dev), torch.zeros((4, 3)))
