"""Parity of the port's model (superpoint_graph_tpu_torch.models) with the
flax model on the CPU: the flax variables are randomised from a numpy seed,
carried into the port by learn/convert_jax.py, and both run on the same
batch. Logits agree within atol and rtol 1e-4 (f32, different summation
orders); the bridge is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.learn import convert_torch as convert_j
from superpoint_graph_tpu.models import SpgModel as FlaxSpgModel
from superpoint_graph_tpu.models.spgmodel import SpgBatch as FlaxBatch
from superpoint_graph_tpu_torch.learn.convert_jax import (convert_state_dict,
                                                          flax_to_state_dict)
from superpoint_graph_tpu_torch.models.spgmodel import SpgBatch, SpgModel

FLAGSHIP = dict(
    model_config="gru_10_0,f_13",
    ptn_widths=((64, 64, 128, 128, 256), (256, 64, 32)),
    ptn_widths_stn=((64, 64, 128), (128, 64)),
    fnet_widths=(13, 32, 128, 64), fnet_llbias=False, fnet_bnidx=2,
)
SMALL = dict(ptn_widths=((16, 32), (32, 24, 16)),
             ptn_widths_stn=((8, 16), (16, 8)),
             fnet_widths=(7, 16, 24), fnet_llbias=False, fnet_bnidx=1)


def _randomize(tree, rng):
    """Every flax leaf replaced by seeded values; batch-norm variances kept
    positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
    return out


def _batch_arrays(rng, n_ch, edge_dim, n_sp=20, pad_sp=24, n_pts=16,
                  n_edges=70, pad_edges=80, compact=False):
    """Padded batch as numpy: some clouds too small (masked), padding nodes
    and edges, optionally the unique-edge-feature compaction."""
    a = {
        "clouds": rng.randn(pad_sp, n_pts, n_ch).astype(np.float32),
        "clouds_global": rng.rand(pad_sp, 1).astype(np.float32),
        "cloud_mask": np.r_[rng.rand(n_sp) > 0.15, np.zeros(pad_sp - n_sp, bool)],
        "node_mask": np.r_[np.ones(n_sp, bool), np.zeros(pad_sp - n_sp, bool)],
        "targets": np.r_[rng.randint(0, 6, n_sp), np.full(pad_sp - n_sp, -100)],
        "target_size": np.zeros((pad_sp, 7), np.int64),
        "src": np.r_[rng.randint(0, n_sp, n_edges), np.zeros(pad_edges - n_edges, int)],
        "tgt": np.r_[rng.randint(0, n_sp, n_edges), np.zeros(pad_edges - n_edges, int)],
        "edge_mask": np.r_[np.ones(n_edges, bool), np.zeros(pad_edges - n_edges, bool)],
    }
    if compact:
        uniq = rng.randn(32, edge_dim).astype(np.float32)
        idx = np.r_[rng.randint(0, 25, n_edges), np.zeros(pad_edges - n_edges, int)]
        a["edge_feats"] = uniq[idx]
        a["edge_feat_uniq"] = uniq
        a["edge_feat_idx"] = idx
        a["edge_uniq_mask"] = np.arange(32) < 25
    else:
        a["edge_feats"] = rng.randn(pad_edges, edge_dim).astype(np.float32)
    return a


def _flax_batch(a):
    ints = ("targets", "src", "tgt", "edge_feat_idx", "target_size")
    return FlaxBatch(**{k: jnp.asarray(v.astype(np.int32) if k in ints else v)
                        for k, v in a.items()})


def _torch_batch(a):
    return SpgBatch(**{k: torch.as_tensor(v) for k, v in a.items()})


def _pair(kw, n_ch, stn, prelast_do, seed):
    """A flax model with randomised variables and the port model carrying
    them through the bridge."""
    rng = np.random.RandomState(seed)
    fmodel = FlaxSpgModel(n_classes=6, ptn_nfeat=n_ch, ptn_nfeat_stn=stn,
                          ptn_prelast_do=prelast_do, **kw)
    a = _batch_arrays(rng, n_ch, kw["fnet_widths"][0])
    # only the shapes: every leaf is replaced by seeded values
    shapes = jax.eval_shape(lambda b: fmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), _flax_batch(a))
    variables = {c: _randomize(dict(shapes[c]), rng)
                 for c in ("params", "batch_stats")}
    tmodel = SpgModel(n_classes=6, ptn_nfeat=n_ch, ptn_nfeat_stn=stn,
                      ptn_prelast_do=prelast_do, **kw)
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    return fmodel, variables, tmodel.eval(), rng


def _assert_trees_equal(got, want, path=""):
    assert got.keys() == want.keys(), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


CASES = [
    ("flagship", FLAGSHIP, 14, 11, 0.0, False),
    ("gru_matrix", dict(SMALL, model_config="gru_3_0,f_6"), 11, 11, 0.0, False),
    ("gru_vector_dropout_compact", dict(SMALL, model_config="gru_2,f_6"),
     11, 11, 0.5, True),
    ("lstm", dict(SMALL, model_config="lstm_2_0,f_6"), 11, 6, 0.0, False),
    ("crf", dict(SMALL, model_config="gru_2_0,f_6,crf_2"), 11, 11, 0.0, True),
    ("r_d_tokens", dict(SMALL, model_config="gru_1_0,r,d_0.3,f_6"),
     14, 11, 0.0, False),
    # 'b' tokens: flax names the layer ecc/{d}_bn (affine, and b_na without
    # scale or bias)
    ("b_token", dict(SMALL, model_config="gru_2,b,f_6"), 11, 11, 0.0, False),
    ("b_na_token", dict(SMALL, model_config="gru_1_0,b_na,r,f_6"),
     11, 11, 0.0, True),
]


@pytest.mark.parametrize("name,kw,n_ch,stn,prelast_do,compact", CASES,
                         ids=[c[0] for c in CASES])
def test_spgmodel_logits_match_flax(name, kw, n_ch, stn, prelast_do, compact):
    """Logits of the whole model within atol/rtol 1e-4; the port's torch ->
    flax map of its state dict reproduces the flax tree exactly."""
    fmodel, variables, tmodel, rng = _pair(kw, n_ch, stn, prelast_do, seed=7)
    a = _batch_arrays(rng, n_ch, kw["fnet_widths"][0], compact=compact)
    want = np.asarray(jax.jit(lambda v, b: fmodel.apply(v, b, train=False))(
        variables, _flax_batch(a)))
    with torch.no_grad():
        got = tmodel(_torch_batch(a)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    _assert_trees_equal(convert_state_dict(tmodel.state_dict(), tmodel),
                        variables)


@pytest.mark.parametrize("name,kw,n_ch,stn,prelast_do,compact",
                         [c for c in CASES if "b_" not in c[0]],
                         ids=[c[0] for c in CASES if "b_" not in c[0]])
def test_convert_state_dict_copy_matches_jax(name, kw, n_ch, stn, prelast_do,
                                             compact):
    """Without a 'b' token, the port's copy of the torch -> flax map gives
    the JAX package's tree exactly (with one, the JAX map nests the layer
    under a MaskedBatchNorm_0 level that the flax model does not have)."""
    _, variables, tmodel, _ = _pair(kw, n_ch, stn, prelast_do, seed=11)
    sd = tmodel.state_dict()
    _assert_trees_equal(convert_state_dict(sd, tmodel),
                        convert_j.convert_state_dict(sd, tmodel))


def test_pointnet_embeddings_match_flax():
    """PointNet + STN alone (flagship widths, 14 channels, STN on 11):
    embeddings within atol/rtol 1e-4, masked superpoints zero."""
    fmodel, variables, tmodel, rng = _pair(FLAGSHIP, 14, 11, 0.0, seed=3)
    a = _batch_arrays(rng, 14, 13)
    want = np.asarray(fmodel.apply(
        variables, jnp.asarray(a["clouds"]), jnp.asarray(a["clouds_global"]),
        jnp.asarray(a["cloud_mask"]), train=False,
        method=lambda m, *x, **k: m.ptn(*x, **k)))
    with torch.no_grad():
        got = tmodel.ptn(torch.as_tensor(a["clouds"]),
                         torch.as_tensor(a["clouds_global"]),
                         torch.as_tensor(a["cloud_mask"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (got[~a["cloud_mask"]] == 0).all()


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("layernorm,ingate", [(True, True), (False, False)])
def test_cells_match_flax(rng, kind, layernorm, ingate):
    """One recurrent step within atol/rtol 1e-5, weights mapped by hand
    (torch [out, in] = flax kernel transposed)."""
    from superpoint_graph_tpu.models.cells import GRUCellEx as FG
    from superpoint_graph_tpu.models.cells import LSTMCellEx as FL
    from superpoint_graph_tpu_torch.models.cells import GRUCellEx, LSTMCellEx

    n, c = 9, 8
    x = rng.randn(n, c).astype(np.float32)
    h = rng.randn(n, c).astype(np.float32)
    cx = rng.randn(n, c).astype(np.float32)
    fcell = (FG if kind == "gru" else FL)(c, layernorm=layernorm, ingate=ingate)
    carry = h if kind == "gru" else (h, cx)
    params = _randomize(dict(jax.eval_shape(
        lambda: fcell.init(jax.random.PRNGKey(0), x, carry))["params"]), rng)
    tcell = (GRUCellEx if kind == "gru" else LSTMCellEx)(
        c, c, layernorm=layernorm, ingate=ingate)
    sd = {"weight_ih": params["ih"]["kernel"].T,
          "weight_hh": params["hh"]["kernel"].T}
    if kind == "gru":
        sd.update(bias_ih=params["bias_ih"], bias_hh=params["bias_hh"])
    else:
        sd.update(bias_ih=params["ih"]["bias"], bias_hh=params["hh"]["bias"])
    if ingate:
        sd.update({"ig.weight": params["ig"]["kernel"].T,
                   "ig.bias": params["ig"]["bias"]})
    tcell.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    want = fcell.apply({"params": params}, x, carry)
    tcarry = (torch.as_tensor(h) if kind == "gru"
              else (torch.as_tensor(h), torch.as_tensor(cx)))
    with torch.no_grad():
        got = tcell(torch.as_tensor(x), tcarry)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_bridge_rejects_wrong_widths():
    """A flax tree whose widths do not fit the port model raises (the conv
    stack sized for 11 channels, the port for 14)."""
    fmodel, variables, _, _ = _pair(dict(SMALL, model_config="gru_1_0,f_6"),
                                    11, 11, 0.0, seed=1)
    tmodel = SpgModel(n_classes=6, ptn_nfeat=14, ptn_nfeat_stn=11,
                      model_config="gru_1_0,f_6", **SMALL)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(variables, tmodel)


def test_weighted_ce_loss_matches_jax(rng):
    """Loss with class weights and -100 targets within 1e-6."""
    from superpoint_graph_tpu.learn.train import weighted_ce_loss as lj
    from superpoint_graph_tpu_torch.learn.infer import weighted_ce_loss as lt

    logits = rng.randn(30, 6).astype(np.float32)
    targets = np.where(rng.rand(30) < 0.2, -100, rng.randint(0, 6, 30))
    w = rng.rand(6).astype(np.float32) + 0.5
    for cw in (None, w):
        got = float(lt(torch.as_tensor(logits), torch.as_tensor(targets),
                       None if cw is None else torch.as_tensor(cw)))
        want = float(lj(jnp.asarray(logits), jnp.asarray(targets),
                        None if cw is None else jnp.asarray(cw)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_model_is_inference_only():
    """eval_step is inference only: it refuses a model in training mode
    (which now runs on batch statistics and updates the running ones) and
    runs in eval mode; seeded initialisation is reproducible."""
    from superpoint_graph_tpu_torch.learn.infer import eval_step

    m1 = SpgModel(6, **dict(SMALL, model_config="gru_1_0,f_6"), ptn_nfeat=11)
    m1.reset_parameters(torch.Generator().manual_seed(5))
    m2 = SpgModel(6, **dict(SMALL, model_config="gru_1_0,f_6"), ptn_nfeat=11)
    m2.reset_parameters(torch.Generator().manual_seed(5))
    for (k, v1), v2 in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(v1, v2), k
    batch = _torch_batch(_batch_arrays(np.random.RandomState(0), 11, 7))
    with pytest.raises(ValueError):
        eval_step(m1, batch)
    before = m1.ptn.convs[1].running_mean.clone()
    assert torch.isfinite(m1(batch)).all()
    assert not torch.equal(m1.ptn.convs[1].running_mean, before)
    loss, logits = eval_step(m1.eval(), batch)
    assert torch.isfinite(loss) and torch.isfinite(logits).all()
