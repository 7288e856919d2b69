"""Data-parallel training of the port (superpoint_graph_tpu_torch/parallel/
dp.py) on gloo ranks, against the JAX package's `make_dp_train_step` and
`make_dp_eval_step` on its virtual CPU mesh.

Each rank is a process running this file as its worker (`python
tests/test_torch_dp.py mode rank world dir`): it imports only the port,
joins a gloo group through a `file://` rendezvous in the test's directory
and writes its result there. The JAX references are computed in the pytest
process. Flax variables are randomised from a numpy seed and carried into
the port by learn/convert_jax.py; each rank gets its own seeded batch.
Tolerances are tests/test_torch_train.py's for one step: the loss 1e-5
relative, each parameter's update within 1e-4 of its tensor's largest
(the biases feeding a batch norm, zero by construction, below 1e-4 of the
model's largest update), running statistics 1e-5, logits 1e-4. A run that
has not finished in RANK_TIMEOUT seconds is killed and fails its test."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
# a model without dropout, as the JAX package's dp test uses
SMALL = dict(model_config="gru_2_0,f_6", ptn_widths=((16, 32), (32, 24, 16)),
             ptn_widths_stn=((8, 16), (16, 8)), fnet_widths=(7, 16, 24),
             fnet_llbias=False, fnet_bnidx=1, ptn_prelast_do=0.0)
N_CH, N_CLS = 11, 6
# SGD so that a parameter's update is lr times its mean gradient
TRAINER = dict(optim="sgd", lr=0.1, momentum=0.9, wd=0.0, grad_clip=1.0)


def run_ranks(script, mode: str, world: int, workdir: Path,
              timeout: float = RANK_TIMEOUT) -> list:
    """Start `world` ranks of `script`'s worker (`script mode rank world
    workdir`), wait for all, kill every one still running after `timeout`
    seconds; each must exit 0. Returns the ranks' outputs
    (workdir/out_<rank>.pt)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), mode, str(r), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


def join_group(rank: int, world: int, workdir: str) -> None:
    """A worker's gloo group through the rendezvous file in workdir."""
    from superpoint_graph_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"file://{workdir}/rdzv", world, rank, device="cpu",
                         timeout_s=RANK_TIMEOUT / 2)


# ---------------------------------------------------------------- worker
def _worker(mode: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from superpoint_graph_tpu_torch.learn.train import Trainer
    from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel
    from superpoint_graph_tpu_torch.parallel.dp import (make_dp_eval_step,
                                                        make_dp_train_step)

    join_group(rank, world, workdir)
    inp = torch.load(f"{workdir}/in.pt", weights_only=False)
    model = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH, **SMALL)
    model.load_state_dict(inp["state"])
    trainer = Trainer(model, checkpoint_ptn=False, device="cpu", **TRAINER)
    batch = SpgBatch(**inp["batches"][rank])
    eval_loss, eval_logits = make_dp_eval_step(trainer)(batch)
    loss, logits = make_dp_train_step(trainer)(batch)
    torch.save({"loss": loss, "eval_loss": eval_loss,
                "eval_logits": eval_logits,
                "state": trainer.model.state_dict()},
               f"{workdir}/out_{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------- tests
def _inputs(world: int, replicated: bool):
    """(flax model, variables, the port's model carrying them, per-rank
    batch arrays)."""
    import jax

    from tests.test_torch_train import (_batch_arrays, _flax_batch,
                                        _randomize)
    from superpoint_graph_tpu.models import SpgModel as FlaxSpgModel
    from superpoint_graph_tpu_torch.learn.convert_jax import flax_to_state_dict
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel

    rng = np.random.RandomState(11)
    arrays = [_batch_arrays(np.random.RandomState(20 + (0 if replicated
                                                        else r)), ignore=0.2)
              for r in range(world)]
    fmodel = FlaxSpgModel(n_classes=N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH,
                          **SMALL)
    shapes = jax.eval_shape(lambda b: fmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False),
                            _flax_batch(arrays[0]))
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats")}
    tmodel = SpgModel(N_CLS, ptn_nfeat=N_CH, ptn_nfeat_stn=N_CH, **SMALL)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    return fmodel, variables, tmodel, arrays


def _launch(tmp_path, tmodel, arrays):
    torch.save({"state": tmodel.state_dict(),
                "batches": [{k: torch.as_tensor(v) for k, v in a.items()}
                            for a in arrays]}, tmp_path / "in.pt")
    return run_ranks(__file__, "dp", len(arrays), tmp_path)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(world, tmp_path):
    """`world` gloo ranks, each with its own batch, one make_dp_train_step
    (after one make_dp_eval_step) against the JAX steps on make_mesh(world)
    with the same batches and weights: the mean loss, every rank's
    parameters and running statistics, the mean eval loss and each rank's
    eval logits. All ranks end with the same model, bit for bit."""
    import jax

    from tests.test_torch_train import _flax_batch
    from superpoint_graph_tpu.learn.train import Trainer as JaxTrainer
    from superpoint_graph_tpu.learn.train import TrainState
    from superpoint_graph_tpu.parallel import (make_dp_eval_step,
                                               make_dp_train_step, make_mesh,
                                               shard_batch,
                                               stack_device_batches)
    from superpoint_graph_tpu_torch.learn.convert_jax import flax_to_state_dict
    from superpoint_graph_tpu_torch.learn.train_check import bn_fed_biases

    fmodel, variables, tmodel, arrays = _inputs(world, replicated=False)
    outs = _launch(tmp_path, tmodel, arrays)

    jt = JaxTrainer(fmodel, checkpoint_ptn=False, **TRAINER)
    params = jax.tree.map(np.asarray, variables["params"])
    state = TrainState(step=np.int32(0), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(params))
    mesh = make_mesh(world)
    sharded = shard_batch(stack_device_batches(
        [_flax_batch(a) for a in arrays]), mesh)
    eloss, elogits = make_dp_eval_step(jt, mesh)(state, sharded)
    new_state, loss, _ = make_dp_train_step(jt, mesh)(
        state, sharded, jax.random.PRNGKey(1))
    want = flax_to_state_dict({"params": new_state.params,
                               "batch_stats": new_state.batch_stats}, tmodel)
    before = tmodel.state_dict()
    params_t = dict(tmodel.named_parameters())
    zero = bn_fed_biases(tmodel)
    top = max(float((want[k] - before[k]).abs().max()) for k in params_t)

    for r, out in enumerate(outs):
        assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(float(out["eval_loss"]) - float(eloss)) <= (
            1e-5 * abs(float(eloss)))
        np.testing.assert_allclose(out["eval_logits"].numpy(),
                                   np.asarray(elogits[r]), atol=1e-4,
                                   rtol=1e-4)
        got = out["state"]
        for k in params_t:
            upd_t, upd_j = got[k] - before[k], want[k] - before[k]
            bound = 1e-4 * (top if k in zero
                            else float(upd_j.abs().max()))
            err = float((upd_t - upd_j).abs().max())
            assert err <= bound + 1e-7, f"rank {r} {k}: {err:.3e} > {bound:.3e}"
        for k in got:
            if k not in params_t:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=k)
        for k, v in got.items():
            assert torch.equal(v, outs[0]["state"][k]), (r, k)


def test_dp_replicated_equals_single_process_step(tmp_path):
    """Two gloo ranks with the same batch: the mean of equal gradients and
    statistics is each of them, so the dp step equals one single-process
    Trainer.train_step bit for bit."""
    from superpoint_graph_tpu_torch.learn.train import Trainer
    from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch

    _, _, tmodel, arrays = _inputs(2, replicated=True)
    state0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    outs = _launch(tmp_path, tmodel, arrays)
    tmodel.load_state_dict(state0)
    trainer = Trainer(tmodel, checkpoint_ptn=False, device="cpu", **TRAINER)
    loss, _ = trainer.train_step(SpgBatch(**{
        k: torch.as_tensor(v) for k, v in arrays[0].items()}))
    for out in outs:
        assert torch.equal(out["loss"], loss)
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(out["state"][k], v), k


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
