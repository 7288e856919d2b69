"""The training-step checks of learn/train_check.py (chip_smoke.py's checks
(b) and (c), tests/test_torch_cuda.py) on the CPU: what they accept, what
they refuse, and the branch recording and following they rely on."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from superpoint_graph_tpu_torch.learn.train import Trainer
from superpoint_graph_tpu_torch.learn.train_check import (
    TRAIN_TOL, _gap, bn_fed_biases, branches, card_vs_cpu, compare_steps,
    pool_fed_biases, step_record)
from superpoint_graph_tpu_torch.models import pointnet
from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel

SMALL = dict(model_config="gru_2_0,f_6", ptn_widths=((16, 32), (32, 24, 16)),
             ptn_widths_stn=((8, 16), (16, 8)), fnet_widths=(7, 16, 24),
             fnet_bnidx=1, ptn_nfeat=11, ptn_nfeat_stn=11)


def _batch(rng, n_sp=20, pad_sp=24, n_pts=16, n_e=70, pad_e=80):
    return SpgBatch(**{k: torch.as_tensor(v) for k, v in {
        "clouds": rng.randn(pad_sp, n_pts, 11).astype(np.float32),
        "clouds_global": rng.rand(pad_sp, 1).astype(np.float32),
        "cloud_mask": np.r_[rng.rand(n_sp) > 0.15, np.zeros(pad_sp - n_sp, bool)],
        "node_mask": np.r_[np.ones(n_sp, bool), np.zeros(pad_sp - n_sp, bool)],
        "targets": np.r_[rng.randint(0, 6, n_sp), np.full(pad_sp - n_sp, -100)],
        "target_size": np.zeros((pad_sp, 7), np.int64),
        "src": np.r_[rng.randint(0, n_sp, n_e), np.zeros(pad_e - n_e, int)],
        "tgt": np.r_[rng.randint(0, n_sp, n_e), np.zeros(pad_e - n_e, int)],
        "edge_mask": np.r_[np.ones(n_e, bool), np.zeros(pad_e - n_e, bool)],
        "edge_feats": rng.randn(pad_e, 7).astype(np.float32),
    }.items()})


def _f64(batch):
    return SpgBatch(**{k: v.double() if v.dtype == torch.float32 else v
                       for k, v in vars(batch).items() if v is not None})


def _fresh_factory(seed=0):
    model = SpgModel(6, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    state = model.state_dict()

    def fresh(device, monger=True):
        m = SpgModel(6, **SMALL)
        m.load_state_dict(state)
        return Trainer(m, checkpoint_ptn=monger, device=device)

    return fresh, bn_fed_biases(model)


def test_card_vs_cpu_on_own_branches_when_they_agree():
    """With both sides on the CPU every ReLU and max-pool takes the same
    branch, so the port's own step is compared on both (no following) and
    matches (the biases feeding a batch norm read as their rounding noise
    over the largest gradient)."""
    fresh, zero = _fresh_factory()
    out = card_vs_cpu(fresh, _batch(np.random.RandomState(0)), zero)
    assert out["branch_diffs"] == 0 and out["followed"] is False
    assert out["loss_rel"] == 0.0 and out["grads_beyond_tol"] == 0
    assert out["grad_rel_max"] < 1e-6 and out["stats_rel_max"] == 0.0
    assert pointnet.max_pool.__name__ == "max_pool"  # restored


def test_following_branches_removes_the_jumps():
    """One step of the flagship in f64 against the same step in f32 (two
    roundings, as card and CPU), memory monger on: some elements take
    other branches, all near-ties, and the PointNet's gradients jump; on
    the f32 step's branches the f64 step's gradients agree to 1e-5 of
    each tensor's largest, and following a step's own branches gives that
    step (to 1e-5: the CPU's f32 step itself varies by ~1e-6 between
    runs)."""
    rng = np.random.RandomState(0)
    n_sp, pad_sp, n_e, pad_e = 300, 384, 2000, 2048
    batch = SpgBatch(**{k: torch.as_tensor(v) for k, v in {
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
    }.items()})
    model = SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14)
    model.reset_parameters(torch.Generator().manual_seed(0))
    zero = bn_fed_biases(model)

    def step(dtype, **kw):
        t = Trainer(SpgModel(13, ptn_nfeat=14, ptn_nfeat_stn=14).to(dtype),
                    device="cpu")
        t.model.load_state_dict(model.state_dict())
        with branches(t.model, **kw) as rec:
            out = step_record(t, batch if dtype == torch.float32
                              else _f64(batch))
        return rec, out

    r32, s32 = step(torch.float32)
    r64, s64 = step(torch.float64, against=r32)
    zero |= pool_fed_biases(model, r64["pooled"][:2], batch.cloud_mask)
    assert sum(r64["diffs"].values()) > 0 and r64["gap"] < 1e-6

    def worst(a, b):
        top = max(float(np.abs(g).max()) for g in b.values())
        return max(float(np.abs(a[k] - g).max()) / max(
            top if k in zero else float(np.abs(g).max()), 1e-30)
            for k, g in b.items())

    assert worst(s32[1], s64[1]) > 1e-4  # the jumps
    _, followed = step(torch.float64, follow=r32)
    assert worst(s32[1], followed[1]) <= 1e-5
    _, again = step(torch.float32, follow=r32)
    assert again[0] == s32[0] and worst(again[1], s32[1]) <= 1e-5


def test_compare_steps_holds_each_gradient_to_its_own_max():
    """A gradient off by 2x TRAIN_TOL of its tensor's max fails; a bias
    feeding a batch norm is held to the model's largest gradient instead;
    exact_stats asks for bit-equal running statistics."""
    fresh, zero = _fresh_factory()
    rec = step_record(fresh("cpu"), _batch(np.random.RandomState(1)))
    loss, grads, stats = rec
    name = "ptn.fcs.0.weight"
    bad = dict(grads)
    bad[name] = grads[name] + 2 * TRAIN_TOL["grad"] * np.abs(
        grads[name]).max()
    with pytest.raises(AssertionError, match=name):
        compare_steps((loss, bad, stats), rec, "test", zero)
    top = max(float(np.abs(g).max()) for g in grads.values())
    assert "ptn.convs.0.bias" in zero
    noisy = dict(grads)
    noisy["ptn.convs.0.bias"] = np.full_like(grads["ptn.convs.0.bias"],
                                             0.5 * TRAIN_TOL["grad"] * top)
    compare_steps((loss, noisy, stats), rec, "test", zero)
    moved = {k: v + (k.endswith("running_mean") * 1e-7)
             for k, v in stats.items()}
    compare_steps((loss, grads, moved), rec, "test", zero)
    with pytest.raises(AssertionError, match="running statistics differ"):
        compare_steps((loss, grads, moved), rec, "test", zero,
                      exact_stats=True)


def test_gap_of_a_relu_and_a_pool():
    """_gap counts the elements whose branch differs, with the input's
    distance from the branch point over the channel's scale: a ReLU's
    |input|, a max-pool's maximum less its value at the other run's
    points (an exact tie on one side only counts, at gap 0)."""
    x = torch.tensor([[2.0**-21, -4.0], [1.0, 2.0]])
    own = x > 0
    other = own.clone()
    other[0, 0] = False
    assert _gap("relu", x, own, own) == (0, 0.0)
    assert _gap("relu", x, own, other) == (1, 2.0**-21)
    x = torch.tensor([[[1.0, 2.0], [1.0 - 2.0**-20, 0.0]],
                      [[1.0, 4.0], [1.0, 1.0]]])
    own = x == x.amax(1, keepdim=True)
    other = own.clone()
    other[0, :, 0] = torch.tensor([False, True])
    other[1, 1, 0] = False
    assert _gap("pool", x, own, other) == (2, 2.0**-20)


def test_branches_follow_a_relu_and_a_pool():
    """Following another run's branches, a ReLU passes exactly the marked
    elements and a max-pool takes the mean of the marked points, their
    gradients alike; both hooks come off after."""
    relu = nn.Sequential(nn.ReLU())
    x = torch.tensor([[[1.0, -1.0], [3.0, -2.0], [3.0, 0.5]]],
                     requires_grad=True)
    with branches(relu) as own:
        pointnet.max_pool(relu(x)).sum().backward()
    assert own["kinds"] == ["relu", "pool"]
    assert torch.equal(x.grad, torch.tensor([[[0.0, 0.0], [0.5, 0.0],
                                              [0.5, 1.0]]]))
    x.grad = None
    flip = {"masks": [torch.ones(1, 3, 2, dtype=torch.bool),
                      torch.tensor([[[True, True], [False, False],
                                     [False, False]]])]}
    with branches(relu, follow=flip):
        y = pointnet.max_pool(relu(x))
        y.sum().backward()
    assert torch.equal(y, torch.tensor([[1.0, -1.0]]))
    assert torch.equal(x.grad, torch.tensor([[[1.0, 1.0], [0.0, 0.0],
                                              [0.0, 0.0]]]))
    assert not relu[0]._forward_hooks
    assert pointnet.max_pool.__name__ == "max_pool"


def test_pool_fed_biases_have_zero_gradient():
    """Where every pooled channel is positive on every valid superpoint,
    the batch-norm bias before the pool is named and its gradient is zero
    up to rounding (f64); a channel whose maximum is 0 on a valid row
    leaves it out."""
    model = SpgModel(6, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = Trainer(model.double(), device="cpu")
    batch = _f64(_batch(np.random.RandomState(2)))
    with branches(model) as rec:
        _, grads, _ = step_record(trainer, batch)
    pooled = rec["pooled"][:2]
    names = pool_fed_biases(model, pooled, batch.cloud_mask)
    assert names == {"ptn.stn.convs.4.bias", "ptn.convs.4.bias"}
    top = max(float(np.abs(g).max()) for g in grads.values())
    for k in names:
        assert np.abs(grads[k]).max() <= 1e-12 * top, k
    top_ptn = pooled[1].clone()
    top_ptn[int(batch.cloud_mask.nonzero()[0]), 3] = 0.0
    assert pool_fed_biases(model, [pooled[0], top_ptn],
                           batch.cloud_mask) == {"ptn.stn.convs.4.bias"}


def test_pool_residue_scales_bound_the_residue():
    """The SSP LocalEmbedder (its STN and PointNet pool over each point's
    20 neighbours) in float64 and float32 on the same batch and weights:
    pool_residue_scales names the batch-norm bias before each pool; where
    a channel is positive on every row its gradient is zero up to rounding
    of its cancelled sum, the other channels' is real (minus the inactive
    rows' upstream gradient). The float32 step is within
    TRAIN_TOL["residue"] of each channel's cancelled sum and compare_steps
    accepts it; an error of 1% of a real channel's gradient fails."""
    from superpoint_graph_tpu_torch.learn.train_check import (
        pool_residue_scales, ssp_step_record)
    from superpoint_graph_tpu_torch.ssp.embed import (SspModelConfig,
                                                      SspTrainer)
    from superpoint_graph_tpu_torch.ssp.losses import SspLossConfig

    rng = np.random.RandomState(3)
    n, e = 600, 3000
    clouds = rng.randn(n, 20, 6)
    clouds[:3] = clouds[:3, :1]  # one point repeated: some maxima below 0
    batch = {"clouds": clouds, "clouds_global": rng.rand(n, 7),
             "edg_source": rng.randint(0, n, e),
             "edg_target": rng.randint(0, n, e),
             "is_transition": (rng.rand(e) < 0.3).astype(np.int32),
             "objects": np.arange(n) // 50, "xyz": rng.rand(n, 3)}
    cfg = SspModelConfig(ptn_widths=((16, 32), (18, 16, 4)),
                         ptn_widths_stn=((8, 16), (16, 8)))
    weights = rng.rand(e) + 0.5
    steps = {}
    for dtype in (torch.float64, torch.float32):
        trainer = SspTrainer(cfg, SspLossConfig(), device="cpu", dtype=dtype)
        with branches(trainer.model) as rec:
            steps[dtype] = ssp_step_record(weights)(trainer, batch)
        if dtype == torch.float64:
            pooled = rec["pooled"][:2]
            scales = pool_residue_scales(trainer.model, rec["pooled_grads"])
    assert set(scales) == {"stn.convs.4.bias", "ptn.convs.4.bias"}
    grads = steps[torch.float64][1]
    for (name, scale), top_c in zip(scales.items(), pooled):
        pos = (top_c > 0).all(0).numpy()
        assert (np.abs(grads[name][pos]) <= 1e-12 * scale[pos]).all(), name
    # the STN's gradients are 0 at its zero projection; the PointNet's
    # pooled layer is partly positive, and its other channels are real
    assert not pos.all()
    real = np.abs(grads["ptn.convs.4.bias"][~pos])
    assert (real > 1e-8 * scale[~pos]).all()
    zero = bn_fed_biases(trainer.model)
    out = compare_steps(steps[torch.float32], steps[torch.float64],
                        "f32 against f64", zero, residue_scales=scales)
    assert 0 < out["residue_rel_max"] <= TRAIN_TOL["residue"]
    c = np.flatnonzero(~pos)[real.argmax()]
    wrong = {k: v.copy() for k, v in steps[torch.float32][1].items()}
    wrong["ptn.convs.4.bias"][c] += 0.01 * grads["ptn.convs.4.bias"][c]
    with pytest.raises(AssertionError, match="gradients disagree"):
        compare_steps((steps[torch.float32][0], wrong,
                       steps[torch.float32][2]), steps[torch.float64],
                      "a wrong real channel", zero, residue_scales=scales)
