"""Training parity of the port (superpoint_graph_tpu_torch: models in
training mode, learn/train.py, learn/checkpoint.py) with the JAX package on
the CPU. Flax variables are randomised from a numpy seed and carried into
the port by learn/convert_jax.py; gradients and updated batch statistics
come back through the same bridge. Tolerances: batch-norm outputs and
statistics 1e-5, model logits 1e-4, one step's loss 1e-5 (relative) and
each gradient tensor within 1e-4 of its largest |g| (the biases feeding a
batch norm, zero by construction, below 1e-4 of the model's largest
gradient), the optimizer chain 1e-6 against optax on the same injected
gradients."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from superpoint_graph_tpu.learn import checkpoint as ckpt_j
from superpoint_graph_tpu.learn import train as train_j
from superpoint_graph_tpu.models import SpgModel as FlaxSpgModel
from superpoint_graph_tpu.models.norm import MaskedBatchNorm as FlaxBN
from superpoint_graph_tpu.models.spgmodel import SpgBatch as FlaxBatch
from superpoint_graph_tpu_torch.learn import checkpoint as ckpt_t
from superpoint_graph_tpu_torch.learn import train as train_t
from superpoint_graph_tpu_torch.learn.train_check import bn_fed_biases
from superpoint_graph_tpu_torch.learn.convert_jax import (convert_state_dict,
                                                          flax_to_state_dict)
from superpoint_graph_tpu_torch.models.norm import MaskedBatchNorm
from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel

SMALL = dict(model_config="gru_2_0,f_6",
             ptn_widths=((16, 32), (32, 24, 16)),
             ptn_widths_stn=((8, 16), (16, 8)),
             fnet_widths=(7, 16, 24), fnet_llbias=False, fnet_bnidx=1)
N_CH, N_CLS = 11, 6


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
    return out


def _batch_arrays(rng, n_sp=20, pad_sp=24, n_pts=16, n_edges=70,
                  pad_edges=80, ignore=0.0):
    """A padded batch as numpy: masked clouds, padding nodes and edges,
    a share `ignore` of the real targets set to -100."""
    targets = rng.randint(0, N_CLS, n_sp)
    targets[rng.rand(n_sp) < ignore] = -100
    tsize = np.zeros((pad_sp, N_CLS + 1), np.int64)
    tsize[np.arange(n_sp), np.maximum(targets, -1) + 1] = rng.randint(
        1, 50, n_sp)
    return {
        "clouds": rng.randn(pad_sp, n_pts, N_CH).astype(np.float32),
        "clouds_global": rng.rand(pad_sp, 1).astype(np.float32),
        "cloud_mask": np.r_[rng.rand(n_sp) > 0.15,
                            np.zeros(pad_sp - n_sp, bool)],
        "node_mask": np.r_[np.ones(n_sp, bool), np.zeros(pad_sp - n_sp, bool)],
        "targets": np.r_[targets, np.full(pad_sp - n_sp, -100)],
        "target_size": tsize,
        "src": np.r_[rng.randint(0, n_sp, n_edges),
                     np.zeros(pad_edges - n_edges, int)],
        "tgt": np.r_[rng.randint(0, n_sp, n_edges),
                     np.zeros(pad_edges - n_edges, int)],
        "edge_mask": np.r_[np.ones(n_edges, bool),
                           np.zeros(pad_edges - n_edges, bool)],
        "edge_feats": rng.randn(pad_edges, 7).astype(np.float32),
    }


def _flax_batch(a):
    ints = ("targets", "src", "tgt", "target_size")
    return FlaxBatch(**{k: jnp.asarray(v.astype(np.int32) if k in ints else v)
                        for k, v in a.items()})


def _torch_batch(a):
    return SpgBatch(**{k: torch.as_tensor(v) for k, v in a.items()})


def _pair(seed, kw=SMALL):
    """Flax model + randomised variables, the port's model carrying them,
    and a batch."""
    rng = np.random.RandomState(seed)
    fmodel = FlaxSpgModel(n_classes=N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH,
                          **kw)
    a = _batch_arrays(rng, ignore=0.2)
    shapes = jax.eval_shape(lambda b: fmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), _flax_batch(a))
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats")}
    tmodel = SpgModel(n_classes=N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH, **kw)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    return fmodel, variables, tmodel, a, rng


def assert_grads_close(got, want, zero_names, rel=1e-4):
    """Each gradient tensor of `got` within rel * max|want| of `want`
    ({name: array}); the tensors in zero_names (learn/train_check.py::
    bn_fed_biases: zero by construction, rounding noise on both sides)
    below rel * the largest gradient of the model instead."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[k]
        if k in zero_names:
            assert max(np.abs(g).max(), np.abs(w).max()) <= rel * top, k
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{k}: {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("shape", [(40, 8), (12, 9, 8)], ids=["NC", "NPC"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_masked_batchnorm_train_matches_flax(shape, masked):
    """Training-mode outputs and the updated running mean and (biased)
    variance within 1e-5; masked rows zero and out of the statistics."""
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    mask = (rng.rand(shape[0]) > 0.3) if masked else None
    c = shape[-1]
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": (rng.rand(c) + 0.5).astype(np.float32)}
    params = {"scale": rng.randn(c).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    want, mut = FlaxBN(use_running_average=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        None if mask is None else jnp.asarray(mask), mutable=["batch_stats"])
    bn = MaskedBatchNorm(c).train()
    bn.load_state_dict({"weight": torch.as_tensor(params["scale"]),
                        "bias": torch.as_tensor(params["bias"]),
                        "running_mean": torch.as_tensor(stats["mean"]),
                        "running_var": torch.as_tensor(stats["var"])})
    got = bn(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, buf).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   atol=1e-5, rtol=1e-5)
    if masked:
        assert (got.detach().numpy()[~mask] == 0).all()


def test_spgmodel_train_logits_match_flax():
    """Training-mode logits (batch statistics, dropout 0) within 1e-4 and
    every updated running statistic within 1e-5."""
    fmodel, variables, tmodel, a, _ = _pair(5)
    want, mut = fmodel.apply(variables, _flax_batch(a), train=True,
                             mutable=["batch_stats"])
    got = tmodel.train()(_torch_batch(a))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    sd = flax_to_state_dict({"params": variables["params"],
                             "batch_stats": mut["batch_stats"]}, tmodel)
    for k, v in tmodel.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def _jax_loss_and_grads(fmodel, variables, a, class_weights, monger):
    """jax.value_and_grad of the JAX Trainer's training loss (its
    _train_step_fn, with jax.checkpoint when monger)."""
    jt = train_j.Trainer(fmodel, class_weights=class_weights,
                         checkpoint_ptn=monger)
    batch = _flax_batch(a)

    def loss_fn(params):
        fwd = functools.partial(jt._apply,
                                rngs={"dropout": jax.random.PRNGKey(0)})
        if monger:
            fwd = jax.checkpoint(fwd, static_argnums=(3,))
        logits, new_bs = fwd(params, variables["batch_stats"], batch, True)
        return (train_j.weighted_ce_loss(logits, batch.targets,
                                         jt.class_weights), new_bs)

    (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return float(loss), grads, new_bs


@pytest.mark.parametrize("monger,weighted", [(True, False), (False, True)],
                         ids=["monger", "class_weights"])
def test_train_step_grads_match_jax(monger, weighted):
    """One training step: the loss within 1e-5 relative, each parameter's
    gradient within 1e-4 of its tensor's largest |g|, the running
    statistics after the step within 1e-5 (-100 targets in the batch)."""
    fmodel, variables, tmodel, a, rng = _pair(9)
    cw = (rng.rand(N_CLS) + 0.5).astype(np.float32) if weighted else None
    want_loss, grads, new_bs = _jax_loss_and_grads(fmodel, variables, a, cw,
                                                   monger)
    trainer = train_t.Trainer(tmodel, class_weights=cw, checkpoint_ptn=monger,
                              device="cpu")
    loss, _ = trainer.loss_and_grads(_torch_batch(a))
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    want = flax_to_state_dict({"params": grads, "batch_stats": new_bs}, tmodel)
    params = dict(tmodel.named_parameters())
    zero = bn_fed_biases(tmodel)
    assert "ptn.convs.0.bias" in zero and "ptn.fcs.6.bias" not in zero
    assert_grads_close({k: p.grad.numpy() for k, p in params.items()},
                       {k: want[k].numpy() for k in params}, zero)
    for k, v in tmodel.state_dict().items():
        if k not in params:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


OPTIMIZERS = {
    "adam": dict(optim="adam", lr=1e-2, momentum=0.9, wd=0.0, grad_clip=1.0),
    "sgd_momentum_wd": dict(optim="sgd", lr=1e-2, momentum=0.9, wd=1e-3,
                            grad_clip=1.0),
    "adam_wd_noclip": dict(optim="adam", lr=3e-3, momentum=0.9, wd=1e-3,
                           grad_clip=0.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_chain_matches_optax(name):
    """5 steps on the same injected gradients (some beyond the clip), with
    the rate changed by set_epoch_lr at step 3: every parameter within 1e-6
    of optax's chain (clip -> add_decayed_weights -> sgd/adam)."""
    kw = OPTIMIZERS[name]
    _, variables, tmodel, _, rng = _pair(2)
    trainer = train_t.Trainer(tmodel, lr_steps=(1,), lr_decay=0.5,
                              device="cpu", **kw)
    tx = train_j.make_optimizer(kw["optim"], kw["lr"], kw["momentum"],
                                kw["wd"], kw["grad_clip"])
    sched = train_j.make_lr_schedule(kw["lr"], (1,), 0.5)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    zeros_bs = jax.tree.map(np.zeros_like, variables["batch_stats"])
    for step in range(5):
        epoch = int(step >= 3)
        trainer.set_epoch_lr(epoch)
        opt_state = opt_state[:-1] + (opt_state[-1]._replace(
            hyperparams={**opt_state[-1].hyperparams,
                         "learning_rate": jnp.asarray(sched(epoch))}),)
        grads = jax.tree.map(
            lambda p: (rng.randn(*p.shape) * 1.5).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g_sd = flax_to_state_dict({"params": grads, "batch_stats": zeros_bs},
                                  tmodel)
        for k, p in tmodel.named_parameters():
            p.grad.copy_(g_sd[k])
        trainer.apply_grads()
    got = convert_state_dict(tmodel.state_dict(), tmodel)["params"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)


def test_lr_schedule_matches_jax():
    """MultiStepLR [275, 320] x0.7 at epochs 0, 275, 320 and 349."""
    got = train_t.make_lr_schedule(1e-2, [275, 320], 0.7)
    want = train_j.make_lr_schedule(1e-2, [275, 320], 0.7)
    for epoch in (0, 274, 275, 320, 349):
        assert abs(got(epoch) - float(want(epoch))) <= 1e-9
    assert got(0) == 1e-2 and abs(got(349) - 1e-2 * 0.49) < 1e-12


def test_memory_monger_equal_and_recomputes():
    """Memory monger on and off (dropout 0.5 in the PointNet and a `d`
    token): the same loss, gradients, running statistics and generator
    state, bit for bit; with it on, the PointNet's batch norms run twice
    (the replay in backward) and update once."""
    kw = dict(SMALL, model_config="gru_2,d_0.3,f_6")
    model = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH,
                     ptn_prelast_do=0.5, **kw)
    model.reset_parameters(torch.Generator().manual_seed(1))
    batch = _torch_batch(_batch_arrays(np.random.RandomState(4)))
    runs = []
    for monger in (True, False):
        trainer = train_t.Trainer(copy.deepcopy(model), checkpoint_ptn=monger,
                                  seed=3, device="cpu")
        bn = trainer.model.ptn.convs[1]
        calls = []
        bn.register_forward_hook(lambda *_: calls.append(1))
        loss, _ = trainer.loss_and_grads(batch)
        runs.append((loss, trainer.model, trainer.generator.get_state(),
                     len(calls)))
    (l1, m1, g1, c1), (l2, m2, g2, c2) = runs
    assert (c1, c2) == (2, 1)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    for (k, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1.grad, p2.grad), k
    for (k, b1), b2 in zip(m1.named_buffers(), m2.buffers()):
        assert torch.equal(b1, b2), k
    # the dropout draws from the trainer's generator: another seed differs
    t3 = train_t.Trainer(copy.deepcopy(model), seed=4, device="cpu")
    assert not torch.equal(t3.loss_and_grads(batch)[0], l1)


def test_class_weights_and_ignore_match_torch_cross_entropy():
    """weighted_ce_loss equals F.cross_entropy(weight, ignore_index=-100);
    the logits of ignored rows get no gradient."""
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(30, N_CLS).astype(np.float32),
                          requires_grad=True)
    targets = torch.as_tensor(np.where(rng.rand(30) < 0.3, -100,
                                       rng.randint(0, N_CLS, 30)))
    w = torch.as_tensor(rng.rand(N_CLS).astype(np.float32) + 0.5)
    for cw in (None, w):
        got = train_t.weighted_ce_loss(logits, targets, cw)
        want = F.cross_entropy(logits, targets, weight=cw, ignore_index=-100)
        assert torch.allclose(got, want, atol=1e-6, rtol=1e-6)
    got.backward()
    assert (logits.grad[targets == -100] == 0).all()
    assert (logits.grad[targets != -100] != 0).any()


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """The JAX framing (header readable by both packages' readers); a
    trainer rebuilt from the checkpoint's args and state gives the same
    eval logits and continues exactly as the uninterrupted one."""
    model = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH, **SMALL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    batches = [_torch_batch(_batch_arrays(rng)) for _ in range(3)]
    a = train_t.Trainer(model, lr_steps=(1,), device="cpu")
    a.train_step(batches[0])
    args = {"model_config": SMALL["model_config"], "lr_steps": [1],
            "ptn_widths": [list(w) for w in SMALL["ptn_widths"]]}
    scaler = {"mean": np.arange(3.0), "scale": np.ones(3)}
    path = str(tmp_path / "model.ckpt")
    ckpt_t.save_checkpoint(path, a.state_dict(), 1, args, scaler)
    assert ckpt_j.read_checkpoint_args(path) == args
    assert ckpt_t.read_checkpoint_args(path) == args

    state, epoch, got_args, got_scaler = ckpt_t.load_checkpoint(path)
    assert epoch == 1 and got_args == args
    np.testing.assert_array_equal(got_scaler["mean"], scaler["mean"])
    model_b = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH,
                       **dict(SMALL, model_config=got_args["model_config"]))
    b = train_t.Trainer(model_b, lr_steps=got_args["lr_steps"], device="cpu")
    b.load_state_dict(state)
    assert b.step == 1
    assert torch.equal(a.eval_step(batches[1])[1], b.eval_step(batches[1])[1])
    for t in (a, b):
        t.set_epoch_lr(epoch)
        t.generator.manual_seed(7)
        t.train_step(batches[2])
    for (k, pa), pb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(pa, pb), k

    # a checkpoint of the JAX package: the port reads its header
    jpath = str(tmp_path / "jax.ckpt")
    ckpt_j.save_checkpoint(jpath, {"w": np.zeros(2)}, 3, args, None)
    assert ckpt_t.read_checkpoint_args(jpath) == args


def test_trainer_needs_a_device():
    """Without a card the default device raises; the CPU must be named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_t.Trainer(model)
