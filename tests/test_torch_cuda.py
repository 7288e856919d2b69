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


# ---------------------------------------------------------------- training
def test_train_step_on_card_matches_cpu(dev):
    """One training step's forward and backward of the flagship (memory
    monger on) on the card against the CPU from the same weights and batch,
    by learn/train_check.py's card_vs_cpu (chip_smoke.py's check (b)): the
    loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
    largest |g| (the biases feeding a batch norm, zero by construction,
    below 1e-4 of the model's largest gradient), the running statistics
    within 1e-5; where a ReLU or a max-pool takes another branch on the
    CPU than on the card, each such element must be a near-tie, and the
    CPU's step is run again on the card's branches."""
    from superpoint_graph_tpu_torch.learn.train import Trainer
    from superpoint_graph_tpu_torch.learn.train_check import (bn_fed_biases,
                                                              card_vs_cpu)
    from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel

    rng = np.random.RandomState(0)
    n_sp, pad_sp, n_e, pad_e = 300, 384, 2000, 2048
    a = {
        "clouds": rng.randn(pad_sp, 128, 14).astype(np.float32),
        "clouds_global": rng.rand(pad_sp, 1).astype(np.float32),
        "cloud_mask": np.r_[np.ones(n_sp, bool), np.zeros(pad_sp - n_sp, bool)],
        "node_mask": np.r_[np.ones(n_sp, bool), np.zeros(pad_sp - n_sp, bool)],
        "targets": np.r_[rng.randint(0, 13, n_sp), np.full(pad_sp - n_sp, -100)],
        "target_size": np.zeros((pad_sp, 14), np.int64),
        "src": np.r_[rng.randint(0, n_sp, n_e), np.zeros(pad_e - n_e, int)],
        "tgt": np.r_[rng.randint(0, n_sp, n_e), np.zeros(pad_e - n_e, int)],
        "edge_mask": np.r_[np.ones(n_e, bool), np.zeros(pad_e - n_e, bool)],
        "edge_feats": rng.randn(pad_e, 13).astype(np.float32),
    }
    model = SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14)
    model.reset_parameters(torch.Generator().manual_seed(0))

    def fresh(device):
        m = SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14)
        m.load_state_dict(model.state_dict())
        return Trainer(m, checkpoint_ptn=True, device=device)

    batch = SpgBatch(**{k: torch.as_tensor(v, device=dev)
                        for k, v in a.items()})
    card_vs_cpu(fresh, batch, bn_fed_biases(model))


# ---------------------------------------------------------------- parallel
def test_sharded_solve_on_card_matches_single_card(dev):
    """cutpursuit_band_sharded on two shards of one card against the
    single-card cutpursuit_band with the same pad rows, on a 30,000-point
    room and its k = 10 graph: label agreement above 0.999, component
    counts within 2 (the sharded sums round in another order); a second
    sharded run equal bit for bit."""
    from superpoint_graph_tpu_torch.data.synthetic import synthetic_room
    from superpoint_graph_tpu_torch.ops.cutpursuit_band import cutpursuit_band
    from superpoint_graph_tpu_torch.ops.knn import knn
    from superpoint_graph_tpu_torch.parallel import partition_shard as ps
    from superpoint_graph_tpu_torch.parallel.mesh import make_mesh

    xyz, rgb, _, _ = synthetic_room(np.random.RandomState(0), 30_000)
    idx, d2 = knn(torch.from_numpy(xyz).to(dev), 10)
    src = np.repeat(np.arange(len(xyz)), 10)
    tgt = idx.reshape(-1).cpu().numpy()
    dist = np.sqrt(d2.reshape(-1).cpu().numpy())
    w = (1.0 / (1.0 + dist / dist.mean())).astype(np.float32)
    f = np.c_[xyz, rgb / 255.0].astype(np.float32)
    comps_1, ic_1 = cutpursuit_band(f, src, tgt, w, 0.1, xyz=xyz, device=dev,
                                    pad_rows=ps.sharded_pad_rows(len(xyz), 2))
    mesh = make_mesh(devices=[dev, dev])
    runs = [ps.cutpursuit_band_sharded(f, src, tgt, w, 0.1, mesh, xyz=xyz)
            for _ in range(2)]
    assert (runs[0][1] == ic_1).mean() > 0.999
    assert abs(len(runs[0][0]) - len(comps_1)) <= 2
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_dp_step_nccl_world_one_equals_train_step(dev):
    """parallel/dp.py's step in an NCCL group of one rank on the card
    equals Trainer.train_step from the same weights and generator seed,
    bit for bit (a mean over one rank is the identity): losses, parameters
    and running statistics over 3 steps."""
    import os
    import socket
    import warnings

    import torch.distributed as dist

    from superpoint_graph_tpu_torch.learn.train import Trainer
    from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel
    from superpoint_graph_tpu_torch.parallel import multihost
    from superpoint_graph_tpu_torch.parallel.dp import make_dp_train_step

    rng = np.random.RandomState(1)
    n_sp, n_e = 64, 256
    batch = SpgBatch(**{k: torch.as_tensor(v, device=dev) for k, v in {
        "clouds": rng.randn(n_sp, 32, 14).astype(np.float32),
        "clouds_global": rng.rand(n_sp, 1).astype(np.float32),
        "cloud_mask": np.ones(n_sp, bool), "node_mask": np.ones(n_sp, bool),
        "targets": rng.randint(0, 13, n_sp),
        "target_size": np.zeros((n_sp, 14), np.int64),
        "src": rng.randint(0, n_sp, n_e), "tgt": rng.randint(0, n_sp, n_e),
        "edge_mask": np.ones(n_e, bool),
        "edge_feats": rng.randn(n_e, 13).astype(np.float32)}.items()})
    model = SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14)
    model.reset_parameters(torch.Generator().manual_seed(0))

    def fresh():
        m = SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14)
        m.load_state_dict(model.state_dict())
        return Trainer(m, device=dev, seed=3)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # one host: NCCL's bootstrap on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device=dev)
    # index_add_'s float atomics would add in no fixed order
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a, b = fresh(), fresh()
            step = make_dp_train_step(a)
            for _ in range(3):
                assert torch.equal(step(batch)[0], b.train_step(batch)[0])
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k


# ---------------------------------------------------------------- SSP
def _ssp_batch(rng, n=4000, k=5, k_local=20):
    """A collated SSP batch (host arrays): a cloud of n points in 8
    objects, its kNN edges, local clouds and globals at the recipe's
    widths."""
    xyz = (rng.rand(n, 3) * [4.0, 4.0, 2.0]).astype(np.float32)
    objects = (xyz[:, 0] // 1.0 + 4 * (xyz[:, 1] // 2.0)).astype(np.int64)
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nb = np.argsort(d2, 1)[:, :k_local]
    es = np.repeat(np.arange(n), k)
    et = nb[:, :k].reshape(-1)
    clouds = np.concatenate([xyz[nb] - xyz[:, None], rng.rand(n, k_local, 3)],
                            2).astype(np.float32)
    return {"clouds": clouds,
            "clouds_global": rng.rand(n, 7).astype(np.float32),
            "edg_source": es, "edg_target": et,
            "is_transition": (objects[es] != objects[et]).astype(np.int32),
            "objects": objects, "xyz": xyz, "labels": np.zeros(1)}


def test_ssp_embedder_on_card_matches_cpu(dev):
    """The SSP LocalEmbedder at the recipe's widths on the card (float32)
    against the same weights on the CPU in float64, the reference:
    embeddings within 1e-4 in eval and in training mode (float32's own
    rounding here is ~4e-5 on either device, PERF.md), the running
    statistics of the training forward within 1e-5."""
    from superpoint_graph_tpu_torch.ssp.embed import (LocalEmbedder,
                                                      SspModelConfig)

    rng = np.random.RandomState(0)
    batch = _ssp_batch(rng)
    model = LocalEmbedder(SspModelConfig())
    model.reset_parameters(torch.Generator().manual_seed(0))
    card = LocalEmbedder(SspModelConfig())
    card.load_state_dict(model.state_dict())
    card.to(dev)
    model.double()
    args = [torch.as_tensor(batch[k]) for k in ("clouds", "clouds_global")]
    for train in (False, True):
        model.train(train)
        card.train(train)
        with torch.no_grad():
            want = model(*(a.double() for a in args)).numpy()
            got = card(*(a.to(dev) for a in args)).cpu().numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
    for (k, a), b in zip(card.state_dict().items(),
                         model.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   err_msg=k)


def test_ssp_step_on_card_matches_cpu(dev):
    """One SSP training step at the recipe's widths (chip_smoke.py's SSP
    check): the card's in-loop device partition gives the loss weights,
    then learn/train_check.py's card_vs_cpu holds the card's float32 step
    on those weights to the CPU's in float64, the reference
    (ssp_trainer_factory): loss 1e-5 relative, gradients 1e-4 of each
    tensor's largest (each channel of a batch-norm bias before a max-pool
    1e-6 of its cancelled sum, pool_residue_scales), running statistics
    1e-5; near-tie branches followed as for the SPG model."""
    from superpoint_graph_tpu_torch.learn.train_check import (
        bn_fed_biases, card_vs_cpu, ssp_step_record, ssp_trainer_factory)
    from superpoint_graph_tpu_torch.ssp.embed import SspModelConfig, SspTrainer
    from superpoint_graph_tpu_torch.ssp.losses import SspLossConfig

    rng = np.random.RandomState(1)
    batch = _ssp_batch(rng)
    model_cfg = SspModelConfig()
    loss_cfg = SspLossConfig(cp_backend="device")
    first = SspTrainer(model_cfg, loss_cfg, seed=0, device=dev)
    fresh = ssp_trainer_factory(model_cfg, loss_cfg, first.model.state_dict())
    emb = first.embed_train(batch)
    weights, comps, _ = first.host_weights(emb, batch)
    assert 1 < len(comps) < len(batch["xyz"])
    card_vs_cpu(fresh, batch, bn_fed_biases(first.model), "SSP step",
                record=ssp_step_record(weights), device=dev)


def test_submission_spread_on_card_matches_plain(dev, tmp_path):
    """cli/write_semantic3d.write_submission on the card: the nn1 kernel's
    spread (one launch plan a chunk of raw rows) gives the labels the
    plain nn1 picks, written one a line, and the same file as on the
    CPU."""
    from superpoint_graph_tpu_torch.cli.write_semantic3d import (
        write_submission)
    from superpoint_graph_tpu_torch.data.synthetic import write_semantic3d_scan
    from superpoint_graph_tpu_torch.ops.voxel import prune

    raw = tmp_path / "station.txt"
    write_semantic3d_scan(raw, 40_000, 3)
    rows = np.loadtxt(raw, usecols=(0, 1, 2), dtype=np.float32)
    xyz = prune(rows, 0.1, np.zeros((len(rows), 3), np.uint8), None, None,
                0, 0, device="cpu")[0]
    comps = np.array_split(np.random.RandomState(4).permutation(len(xyz)), 97)
    pred = np.random.RandomState(5).randint(0, 8, len(comps))
    before = nn1.launches
    got = write_submission(str(tmp_path / "card.labels"), str(raw), xyz,
                           comps, pred, 15_000, dev)
    assert nn1.launches - before >= 6  # 3 chunks, 2 or 3 launches each
    voxel_cls = np.zeros(len(xyz), np.uint8)
    for c, comp in enumerate(comps):
        voxel_cls[comp] = pred[c] + 1
    idx = nn1_plain(torch.from_numpy(xyz).to(dev),
                    torch.from_numpy(rows).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, voxel_cls[idx])
    cpu = write_submission(str(tmp_path / "cpu.labels"), str(raw), xyz,
                           comps, pred, 15_000, "cpu")
    np.testing.assert_array_equal(cpu, got)
    assert (tmp_path / "card.labels").read_bytes() == \
        (tmp_path / "cpu.labels").read_bytes()


# ------------------------------------------- the dense solver, the prunes
def test_dense_solver_on_card_matches_cpu(dev):
    """ops/cutpursuit_dense.py on the card against the CPU on a
    3,000-vertex kNN graph: the same labels (fixed-order segment sums on
    both), and the same labels on a second card call."""
    from scipy.spatial import cKDTree

    from superpoint_graph_tpu_torch.ops.cutpursuit_dense import (
        cutpursuit_dense)

    rs = np.random.RandomState(3)
    xyz = rs.rand(3000, 3).astype(np.float32)
    d, i = cKDTree(xyz).query(xyz, 6)
    src, tgt = np.repeat(np.arange(3000), 5), i[:, 1:].ravel()
    w = (1.0 / (1.0 + d[:, 1:].ravel() / d[:, 1:].mean())).astype(np.float32)
    f = np.concatenate([xyz, 0.1 * rs.rand(3000, 2)], 1).astype(np.float32)
    got = cutpursuit_dense(f, src, tgt, w, 0.05, device=dev)[1]
    np.testing.assert_array_equal(
        got, cutpursuit_dense(f, src, tgt, w, 0.05, device="cpu")[1])
    np.testing.assert_array_equal(
        got, cutpursuit_dense(f, src, tgt, w, 0.05, device=dev)[1])


def test_prune_above_device_max_equals_card_prune(dev, monkeypatch):
    """Above PRUNE_DEVICE_MAX rows `prune` runs the host library; on the
    station generator's points its voxels and means equal the card's
    prune (f32 keys and f32 sums in point order on both)."""
    from superpoint_graph_tpu_torch import native
    from superpoint_graph_tpu_torch.data.synthetic import station_chunk
    from superpoint_graph_tpu_torch.ops import voxel

    xyz = station_chunk(np.random.default_rng(0), 500_000)
    zeros = np.zeros((len(xyz), 3), np.uint8)
    want = voxel.prune(xyz, 0.1, zeros, None, None, 0, 0, device=dev)
    monkeypatch.setattr(voxel, "PRUNE_DEVICE_MAX", len(xyz) - 1)
    calls = native.prune.calls
    got = voxel.prune(xyz, 0.1, zeros, None, None, 0, 0, device=dev)
    assert native.prune.calls == calls + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
