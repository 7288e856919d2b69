"""The port's last modules against the JAX package's, on the CPU: graph
pooling (models/pool.py), the reference checkpoint loader (learn/checkpoint.load_reference_checkpoint, against
learn/convert_torch.load_reference_checkpoint) and the dense device cut
pursuit (ops/cutpursuit_dense.py, against ops/cutpursuit_jax.py).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superpoint_graph_tpu.ops import cutpursuit_jax as cp_j
from superpoint_graph_tpu_torch.ops import cutpursuit as cp_host
from superpoint_graph_tpu_torch.ops import cutpursuit_dense as cp_d
from tests.test_cutpursuit import grid_graph, partition_energy


# ---------------------------------------------------------------- pooling
def _pool_inputs(rng, n=20, m=40, c=6, nc=8):
    h = rng.randn(n, c).astype(np.float32)
    child = rng.randint(0, n, m)
    parent = rng.randint(0, nc - 2, m)  # the last two coarse nodes empty
    mask = rng.rand(m) > 0.2
    return h, child, parent, mask, nc


class TestGraphPool:
    def _oracle(self, h, child, parent, mask, n_coarse, aggr):
        out = np.zeros((n_coarse, h.shape[1]))
        for c in range(n_coarse):
            rows = [h[child[m]] for m in range(len(child))
                    if mask[m] and parent[m] == c]
            if rows:
                out[c] = (np.mean(rows, 0) if aggr == "mean"
                          else np.max(rows, 0))
        return out

    @pytest.mark.parametrize("aggr", ["mean", "max"])
    def test_matches_oracle_and_jax(self, rng, aggr):
        from superpoint_graph_tpu.models.pool import graph_pool as pool_j
        from superpoint_graph_tpu_torch.models.pool import graph_pool

        h, child, parent, mask, nc = _pool_inputs(rng)
        got = graph_pool(torch.from_numpy(h), torch.from_numpy(child),
                         torch.from_numpy(parent), nc,
                         torch.from_numpy(mask), aggr).numpy()
        want = np.asarray(pool_j(jnp.asarray(h), jnp.asarray(child),
                                 jnp.asarray(parent), nc, jnp.asarray(mask),
                                 aggr))
        np.testing.assert_allclose(
            got, self._oracle(h, child, parent, mask, nc, aggr),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert not got[-2:].any()

    @pytest.mark.parametrize("aggr", ["mean", "max"])
    def test_gradients_match_jax(self, rng, aggr):
        from superpoint_graph_tpu.models.pool import graph_pool as pool_j
        from superpoint_graph_tpu_torch.models.pool import graph_pool

        h, child, parent, mask, nc = _pool_inputs(rng)
        up = rng.randn(nc, h.shape[1]).astype(np.float32)
        want = np.asarray(jax.grad(lambda x: jnp.sum(
            pool_j(x, jnp.asarray(child), jnp.asarray(parent), nc,
                   jnp.asarray(mask), aggr) * up))(jnp.asarray(h)))
        ht = torch.from_numpy(h).requires_grad_()
        (graph_pool(ht, torch.from_numpy(child), torch.from_numpy(parent),
                    nc, torch.from_numpy(mask), aggr)
         * torch.from_numpy(up)).sum().backward()
        np.testing.assert_allclose(ht.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-6)

    def test_padding_invariance(self, rng):
        from superpoint_graph_tpu_torch.models.pool import graph_pool

        n, m, c, nc = 10, 20, 4, 5
        h = torch.from_numpy(rng.randn(n, c).astype(np.float32))
        child = rng.randint(0, n, m)
        parent = rng.randint(0, nc, m)
        base = graph_pool(h, torch.from_numpy(child),
                          torch.from_numpy(parent), nc,
                          torch.ones(m, dtype=torch.bool), "max")
        child2 = np.concatenate([child, rng.randint(0, n, 7)])
        parent2 = np.concatenate([parent, rng.randint(0, nc, 7)])
        mask2 = np.concatenate([np.ones(m, bool), np.zeros(7, bool)])
        padded = graph_pool(h, torch.from_numpy(child2),
                            torch.from_numpy(parent2), nc,
                            torch.from_numpy(mask2), "max")
        np.testing.assert_array_equal(base.numpy(), padded.numpy())

    def test_unpool_and_unknown_aggr(self, rng):
        from superpoint_graph_tpu_torch.models.pool import (graph_pool,
                                                            graph_unpool)

        hc = rng.randn(4, 3).astype(np.float32)
        parent_of = np.array([0, 0, 1, 3, 2])
        out = graph_unpool(torch.from_numpy(hc), torch.from_numpy(parent_of))
        np.testing.assert_array_equal(out.numpy(), hc[parent_of])
        with pytest.raises(ValueError, match="unknown aggr"):
            graph_pool(torch.zeros(2, 1), torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64), 1, None, "sum")


# ------------------------------------------------ the reference checkpoint
def test_reference_checkpoint_read_by_both_loaders(tmp_path):
    """A torch.save'd reference-layout model.pth.tar (epoch, args as an
    argparse.Namespace, state_dict, optimizer, scaler) read by the port's
    load_reference_checkpoint and the JAX package's: the same args, and
    logits within 1e-5 on one batch."""
    from superpoint_graph_tpu.learn.convert_torch import (
        load_reference_checkpoint as load_j)
    from superpoint_graph_tpu_torch.learn.checkpoint import (
        load_reference_checkpoint)
    from superpoint_graph_tpu_torch.models.spgmodel import SpgModel
    from tests.test_torch_models import (SMALL, _batch_arrays, _flax_batch,
                                         _torch_batch)

    kw = dict(SMALL, model_config="gru_2_0,f_6")
    src = SpgModel(n_classes=6, ptn_nfeat=11, ptn_nfeat_stn=11, **kw)
    src.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    sd = src.state_dict()
    for k, v in sd.items():  # batch-norm statistics away from 0 and 1
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.rand(*v.shape).astype(np.float32)
                                     + 0.5))
    args = argparse.Namespace(
        model_config=kw["model_config"],
        ptn_widths=[list(w) for w in kw["ptn_widths"]],
        ptn_widths_stn=[list(w) for w in kw["ptn_widths_stn"]],
        fnet_widths=list(kw["fnet_widths"]), fnet_llbias=0,
        fnet_bnidx=kw["fnet_bnidx"], ptn_nfeat_stn=11, ptn_prelast_do=0.0,
        inv_class_map={i: str(i) for i in range(6)})
    path = tmp_path / "model.pth.tar"
    torch.save({"epoch": 3, "args": args, "state_dict": sd, "optimizer": {},
                "scaler": None}, path)

    args_t, model = load_reference_checkpoint(str(path))
    args_j, variables, fmodel = load_j(str(path))
    assert vars(args_t) == vars(args_j)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    a = _batch_arrays(rng, 11, kw["fnet_widths"][0])
    with torch.no_grad():
        got = model.eval()(_torch_batch(a)).numpy()
    want = np.asarray(fmodel.apply(variables, _flax_batch(a), train=False))
    assert got.shape == want.shape == (24, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------- the dense cut pursuit
def _bands(trial, h=10, w=10, d=4, scale=1.5):
    r = np.random.RandomState(trial)
    f = r.rand(h * w, d).astype(np.float32)
    band = ((np.arange(h * w).reshape(h, w) % w) // (w // 3 + 1)).ravel()
    f += np.stack([band == i for i in range(d)], 1).astype(np.float32) * scale
    return f


class TestCutPursuitDense:
    """tests/test_cutpursuit_tpu.py:11-85 on the port."""

    def test_two_clusters_recovered(self, rng):
        h, w = 8, 12
        src, tgt = grid_graph(h, w)
        f = np.zeros((h * w, 2), np.float32)
        gt = (np.arange(h * w).reshape(h, w) % w >= w // 2).ravel()
        f[gt] = [1.0, 0.5]
        f += rng.randn(h * w, 2).astype(np.float32) * 0.02
        comps, in_comp = cp_d.cutpursuit_dense(f, src, tgt,
                                               np.ones(len(src)), 0.1,
                                               device="cpu")
        assert len(comps) == 2
        side = in_comp == in_comp[np.flatnonzero(gt)[0]]
        assert np.array_equal(side, gt)

    def test_huge_reg_single_component(self, rng):
        src, tgt = grid_graph(6, 6)
        f = rng.randn(36, 3).astype(np.float32)
        comps, _ = cp_d.cutpursuit_dense(f, src, tgt, np.ones(len(src)), 1e6,
                                         device="cpu")
        assert len(comps) == 1

    def test_energy_close_to_exact_and_equal_to_jax(self):
        """Within 10% of the max-flow oracle's energy on planted bands (the
        JAX test's bound), and the JAX solver's energy to 1e-6 relative."""
        src, tgt = grid_graph(10, 10)
        ew = np.ones(len(src))
        ratios = []
        for trial in range(5):
            f = _bands(trial)
            _, ic_host = cp_host.cutpursuit(f, src, tgt, ew, 0.3)
            _, ic = cp_d.cutpursuit_dense(f, src, tgt, ew, 0.3, device="cpu")
            _, ic_j = cp_j.cutpursuit_tpu(f, src, tgt, ew, 0.3)
            e = partition_energy(f, ic, src, tgt, ew, 0.3)
            ratios.append(e / max(partition_energy(f, ic_host, src, tgt, ew,
                                                   0.3), 1e-9))
            assert e == pytest.approx(
                partition_energy(f, ic_j, src, tgt, ew, 0.3), rel=1e-6)
        assert np.mean(ratios) < 1.10, ratios

    def test_weight_decay_honored(self, rng):
        h, w = 10, 10
        src, tgt = grid_graph(h, w)
        ew = np.ones(len(src))
        f = rng.rand(h * w, 3).astype(np.float32)
        band = ((np.arange(h * w).reshape(h, w) % w) // 4).ravel()
        f += np.stack([band == i for i in range(3)], 1).astype(
            np.float32) * 2.0
        _, ic_full = cp_d.cutpursuit_dense(f, src, tgt, ew, 0.3,
                                           weight_decay=1.0, flow_steps=3,
                                           device="cpu")
        _, ic_decay = cp_d.cutpursuit_dense(f, src, tgt, ew, 0.3,
                                            weight_decay=0.3, flow_steps=3,
                                            device="cpu")
        e_full = partition_energy(f, ic_full, src, tgt, ew, 0.3)
        e_decay = partition_energy(f, ic_decay, src, tgt, ew, 0.3)
        e_single = partition_energy(f, np.zeros(h * w, np.int64), src, tgt,
                                    ew, 0.3)
        assert e_decay < e_single
        assert e_decay < e_full * 1.5

    def test_cutoff(self, rng):
        src, tgt = grid_graph(6, 6)
        f = rng.randn(36, 2).astype(np.float32) * 0.01
        f[0] += 100.0
        _, in_comp = cp_d.cutpursuit_dense(f, src, tgt, np.ones(len(src)),
                                           0.05, cutoff=3, device="cpu")
        assert np.bincount(in_comp).min() >= 3


def _knn_graph(n, k, seed):
    from scipy.spatial import cKDTree

    rs = np.random.RandomState(seed)
    xyz = rs.rand(n, 3).astype(np.float32)
    d, i = cKDTree(xyz).query(xyz, k + 1)
    src = np.repeat(np.arange(n), k)
    tgt = i[:, 1:].ravel()
    w = 1.0 / (1.0 + d[:, 1:].ravel() / d[:, 1:].mean())
    f = np.concatenate([xyz, 0.1 * rs.rand(n, 2)], 1).astype(np.float32)
    return f, src, tgt, w.astype(np.float32), xyz


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 1.0, "flow_steps": 3},
                                {"icm_sweeps": 2, "max_iter": 4}])
def test_dense_matches_jax_on_knn_graphs(kw):
    """The JAX `cutpursuit_tpu` and the port on a 3,000-vertex kNN graph:
    the same partition (energy to 1e-6 relative, component count)."""
    f, src, tgt, w, _ = _knn_graph(3000, 5, 3)
    _, ic = cp_d.cutpursuit_dense(f, src, tgt, w, 0.05, device="cpu", **kw)
    _, ic_j = cp_j.cutpursuit_tpu(f, src, tgt, w, 0.05, **kw)
    assert partition_energy(f, ic, src, tgt, w, 0.05) == pytest.approx(
        partition_energy(f, ic_j, src, tgt, w, 0.05), rel=1e-6)
    assert ic.max() == ic_j.max()


def test_edge_list_solver_matches_jax():
    """The edge-list `_solve` (a degree above the dense cap) against the
    JAX `_solve` on the same padded-free inputs: equal labels and energy."""
    f, src, tgt, w, _ = _knn_graph(1500, 5, 4)
    hub = np.arange(1, 200)  # vertex 0 joins 199 others: above the cap
    src = np.concatenate([src, np.zeros(len(hub), np.int64)])
    tgt = np.concatenate([tgt, hub])
    w = np.concatenate([w, np.full(len(hub), 0.5, np.float32)])
    order = np.argsort(src, kind="stable")
    src, tgt, w = src[order], tgt[order], w[order]
    n = len(f)
    nw = np.ones(n, np.float32)
    lab, e = cp_d._solve(torch.from_numpy(f), torch.from_numpy(src),
                         torch.from_numpy(tgt), torch.from_numpy(w),
                         torch.from_numpy(nw), 0.05, 0.7)
    lab_j, e_j = cp_j._solve(
        jnp.asarray(f), jnp.asarray(src, jnp.int32),
        jnp.asarray(tgt, jnp.int32), jnp.asarray(w), jnp.asarray(nw),
        jnp.float32(0.05), jnp.asarray(np.argsort(tgt, kind="stable"),
                                       jnp.int32), jnp.float32(0.7))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    assert float(e) == pytest.approx(float(e_j), rel=1e-6)
    _, ic = cp_d.cutpursuit_dense(f, src, tgt, w, 0.05, device="cpu")
    _, ic_j = cp_j.cutpursuit_tpu(f, src, tgt, w, 0.05)
    assert partition_energy(f, ic, src, tgt, w, 0.05) == pytest.approx(
        partition_energy(f, ic_j, src, tgt, w, 0.05), rel=1e-6)


def test_band_threshold_routes_to_band_solver(monkeypatch):
    """At band_threshold vertices and above the call is the band solver's,
    with its arguments."""
    seen = {}

    def band(*a, **k):
        seen.update(k)
        return "band"

    monkeypatch.setattr(cp_d, "cutpursuit_band", band)
    f, src, tgt, w, xyz = _knn_graph(600, 4, 5)
    assert cp_d.cutpursuit_dense(f, src, tgt, w, 0.05, xyz=xyz,
                                 band_threshold=600, device="cpu",
                                 max_iter=3) == "band"
    assert seen["xyz"] is xyz and seen["max_iter"] == 3
    assert cp_d.cutpursuit_dense(f, src, tgt, w, 0.05, band_threshold=601,
                                 device="cpu") != "band"
