"""Weight bridge: the JAX package's flax variables -> the port's state dict.

The port's modules carry the reference's torch state-dict names.
`convert_state_dict` maps that layout onto the flax tree (torch -> flax); it
is the port's own copy of superpoint_graph_tpu/learn/convert_torch.py:30-219,
with one repair: a `b` token maps to `ecc/{d}_bn`, the name the flax
GraphNetwork gives that layer, where the JAX package's map adds a
`MaskedBatchNorm_0` level that does not exist.

`convert_local_embedder` is the same map for the supervised partition's
LocalEmbedder (superpoint_graph_tpu/ssp/embed.py).

`flax_to_state_dict` inverts either map rather than restating it: every entry
of the port's state dict is replaced by the positions of its elements, the
positions are pushed through `convert_state_dict`, and each flax leaf then
says where its values go. The inverse is therefore exact by construction,
and every element of the state dict must be reached exactly once, with the
flax leaf of the same shape, or the bridge raises.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(w):
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _conv_w(w):
    return _t(np.asarray(w, np.float32)[:, :, 0])


class _TreeBuilder:
    def __init__(self):
        self.params = {}
        self.batch_stats = {}

    def dense(self, flax_path, sd, torch_prefix, conv=False):
        w = sd[f"{torch_prefix}.weight"]
        self._set(self.params, flax_path + ("kernel",),
                  _conv_w(w) if conv else _t(w))
        b = sd.get(f"{torch_prefix}.bias")
        if b is not None:
            self._set(self.params, flax_path + ("bias",),
                      np.asarray(b, np.float32))

    def bn(self, flax_path, sd, torch_prefix):
        if f"{torch_prefix}.weight" in sd:  # affine
            self._set(self.params, flax_path + ("scale",),
                      np.asarray(sd[f"{torch_prefix}.weight"], np.float32))
            self._set(self.params, flax_path + ("bias",),
                      np.asarray(sd[f"{torch_prefix}.bias"], np.float32))
        if f"{torch_prefix}.running_mean" in sd:  # not a GroupNormRow
            self._set(self.batch_stats, flax_path + ("mean",),
                      np.asarray(sd[f"{torch_prefix}.running_mean"],
                                 np.float32))
            self._set(self.batch_stats, flax_path + ("var",),
                      np.asarray(sd[f"{torch_prefix}.running_var"],
                                 np.float32))

    @staticmethod
    def _set(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value


def _convert_stack(tb, sd, torch_prefix, flax_prefix, n_conv, n_fc,
                   dense_base=0, norm_base=0, prelast_do=0.0,
                   fc_last_plain=True, norm_module="MaskedBatchNorm_0"):
    """Conv1d stack + fc stack shared by PointNet/STNkD (pointnet.py:34-47,
    83-110); `norm_module` is the flax name of the norm inside each
    _NormAct. Returns the next dense/norm indices."""
    di, ni = dense_base, norm_base
    for i in range(n_conv):
        tb.dense(flax_prefix + (f"Dense_{di}",), sd,
                 f"{torch_prefix}.convs.{3 * i}", conv=True)
        tb.bn(flax_prefix + (f"_NormAct_{ni}", norm_module), sd,
              f"{torch_prefix}.convs.{3 * i + 1}")
        di += 1
        ni += 1
    j = 0  # torch module index inside fcs
    for i in range(n_fc):
        tb.dense(flax_prefix + (f"Dense_{di}",), sd,
                 f"{torch_prefix}.fcs.{j}")
        di += 1
        j += 1
        last = i == n_fc - 1
        if not last or not fc_last_plain:
            tb.bn(flax_prefix + (f"_NormAct_{ni}", norm_module), sd,
                  f"{torch_prefix}.fcs.{j}")
            ni += 1
            j += 2  # BN + ReLU
        if i == n_fc - 2 and prelast_do > 0:
            j += 1  # Dropout module
    return di, ni


def _fnet_layout(fnet_widths, nfeat_out, bnidx):
    """Torch Sequential indices of the fnet's Linear (and one BN) modules
    (graphnet.py:17-34)."""
    widths = list(fnet_widths) + [nfeat_out]
    linear_idx = []
    bn_torch_idx = None
    j = 0
    for k in range(len(widths) - 2):
        linear_idx.append(j)
        j += 1
        if bnidx == k:
            bn_torch_idx = j
            j += 1
        j += 1  # ReLU
    linear_idx.append(j)
    if bnidx == len(widths) - 1:
        bn_torch_idx = j + 1
    return linear_idx, bn_torch_idx


def convert_state_dict(sd, model) -> dict:
    """Map a state dict in the reference's layout onto the flax SpgModel's
    variable tree for `model` (the port's SpgModel, which carries the same
    widths and config). Supports the full f/b/r/d/crf/gru/lstm DSL surface.
    Returns {"params": ..., "batch_stats": ...} of numpy arrays.
    """
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
          for k, v in sd.items()}
    tb = _TreeBuilder()

    # --- ptn (+stn) ---
    n_conv, n_fc = len(model.ptn_widths[0]), len(model.ptn_widths[1])
    if model.ptn_nfeat_stn > 0:
        sn_conv = len(model.ptn_widths_stn[0])
        sn_fc = len(model.ptn_widths_stn[1])
        di, ni = 0, 0
        for i in range(sn_conv):
            tb.dense(("ptn", "stn", f"Dense_{di}"), sd,
                     f"ptn.stn.convs.{3 * i}", conv=True)
            tb.bn(("ptn", "stn", f"_NormAct_{ni}", "MaskedBatchNorm_0"), sd,
                  f"ptn.stn.convs.{3 * i + 1}")
            di += 1
            ni += 1
        for i in range(sn_fc):  # stn fcs all carry BN+ReLU (pointnet.py:39-49)
            tb.dense(("ptn", "stn", f"Dense_{di}"), sd, f"ptn.stn.fcs.{3 * i}")
            tb.bn(("ptn", "stn", f"_NormAct_{ni}", "MaskedBatchNorm_0"), sd,
                  f"ptn.stn.fcs.{3 * i + 1}")
            di += 1
            ni += 1
        tb.dense(("ptn", "stn", f"Dense_{di}"), sd, "ptn.stn.proj")
    _convert_stack(
        tb, sd, "ptn", ("ptn",), n_conv, n_fc,
        prelast_do=model.ptn_prelast_do,
    )

    # --- ecc (DSL tokens, graphnet.py:44-84) ---
    nfeat = int(model.ptn_widths[1][-1])
    for d, conf in enumerate(model.model_config.split(",")):
        conf = conf.strip().split("_")
        if conf[0] == "f":
            tb.dense(("ecc", f"{d}_fc"), sd, f"ecc.{d}")
            nfeat = int(conf[1])
        elif conf[0] == "b":
            # flax names this layer ecc/{d}_bn itself (models/graphnet.py:
            # 103-108); b_na has no scale or bias
            tb.bn(("ecc", f"{d}_bn"), sd, f"ecc.{d}")
        elif conf[0] in ("gru", "lstm"):
            vv = bool(int(conf[2])) if len(conf) > 2 else True
            ingate = bool(int(conf[4])) if len(conf) > 4 else True
            out = nfeat if vv else nfeat * nfeat
            lin_idx, bn_idx = _fnet_layout(
                model.fnet_widths, out, model.fnet_bnidx
            )
            for k, j in enumerate(lin_idx):
                tb.dense(("ecc", f"{d}_fnet", f"Dense_{k}"), sd,
                         f"ecc.{d}._fnet.{j}")
            if bn_idx is not None:
                tb.bn(("ecc", f"{d}_fnet", "MaskedBatchNorm_0"), sd,
                      f"ecc.{d}._fnet.{bn_idx}")
            cell = ("ecc", f"{d}_cell")
            tb._set(tb.params, cell + ("ih", "kernel"),
                    _t(sd[f"ecc.{d}._cell.weight_ih"]))
            tb._set(tb.params, cell + ("hh", "kernel"),
                    _t(sd[f"ecc.{d}._cell.weight_hh"]))
            if conf[0] == "gru":
                # GRU adds biases AFTER instance norm -> separate params
                tb._set(tb.params, cell + ("bias_ih",),
                        np.asarray(sd[f"ecc.{d}._cell.bias_ih"], np.float32))
                tb._set(tb.params, cell + ("bias_hh",),
                        np.asarray(sd[f"ecc.{d}._cell.bias_hh"], np.float32))
            else:
                # LSTM adds biases inside the linear (modules.py:299-300)
                tb._set(tb.params, cell + ("ih", "bias"),
                        np.asarray(sd[f"ecc.{d}._cell.bias_ih"], np.float32))
                tb._set(tb.params, cell + ("hh", "bias"),
                        np.asarray(sd[f"ecc.{d}._cell.bias_hh"], np.float32))
            if ingate:
                tb.dense(cell + ("ig",), sd, f"ecc.{d}._cell.ig")
            cat_all = bool(int(conf[5])) if len(conf) > 5 else True
            if cat_all:
                nfeat *= int(conf[1]) + 1
        elif conf[0] == "crf":
            # ECC_CRFModule stores its GraphConvModule as `_propagation`
            # (reference graphnet.py:58-64, modules.py:185-191), so the
            # fnet keys sit one level deeper than gru/lstm's. Matrix
            # (nfeat^2) filters always; nfeat unchanged.
            lin_idx, bn_idx = _fnet_layout(
                model.fnet_widths, nfeat * nfeat, model.fnet_bnidx
            )
            for k, j in enumerate(lin_idx):
                tb.dense(("ecc", f"{d}_fnet", f"Dense_{k}"), sd,
                         f"ecc.{d}._propagation._fnet.{j}")
            if bn_idx is not None:
                tb.bn(("ecc", f"{d}_fnet", "MaskedBatchNorm_0"), sd,
                      f"ecc.{d}._propagation._fnet.{bn_idx}")
        elif conf[0] in ("r", "d") or not conf[0]:
            continue
        else:
            raise NotImplementedError(
                f"no conversion for DSL token {conf[0]!r}"
            )
    return {"params": tb.params, "batch_stats": tb.batch_stats}



def convert_local_embedder(sd, model) -> dict:
    """The torch -> flax map of the SSP LocalEmbedder (ssp/embed.py): its
    STN ("stn": conv and fc stacks, every layer normed, then the
    projection) and its PointNet ("ptn", no inner STN). Returns
    {"params": ..., "batch_stats": ...} of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
          for k, v in sd.items()}
    cfg = model.cfg
    norm_module = ("MaskedBatchNorm_0" if cfg.ptn_norm == "batch"
                   else "GroupNormRow_0")
    tb = _TreeBuilder()
    if model.stn is not None:
        n_conv, n_fc = len(cfg.ptn_widths_stn[0]), len(cfg.ptn_widths_stn[1])
        di, _ = _convert_stack(tb, sd, "stn", ("stn",), n_conv, n_fc,
                               fc_last_plain=False, norm_module=norm_module)
        tb.dense(("stn", f"Dense_{di}"), sd, "stn.proj")
    _convert_stack(tb, sd, "ptn", ("ptn",), len(cfg.ptn_widths[0]),
                   len(cfg.ptn_widths[1]), prelast_do=cfg.ptn_prelast_do,
                   norm_module=norm_module)
    return {"params": tb.params, "batch_stats": tb.batch_stats}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def flax_to_state_dict(variables: dict, model,
                       convert=convert_state_dict) -> dict:
    """{"params", "batch_stats"} flax tree (numpy or jax arrays) -> a state
    dict for `model` (the port's SpgModel; with
    convert=convert_local_embedder, the SSP LocalEmbedder), float32 CPU
    tensors."""
    sd = model.state_dict()
    sizes = [v.numel() for v in sd.values()]
    total = sum(sizes)
    if total >= 2**24:  # positions must stay exact in float32
        raise ValueError(f"{total} parameters: too many for the position map")
    offsets = np.cumsum([0] + sizes)
    probe = {
        k: np.arange(o, o + v.numel(), dtype=np.float64).reshape(v.shape)
        for (k, v), o in zip(sd.items(), offsets)
    }
    flat = np.full(total, np.nan, np.float32)
    hits = np.zeros(total, np.int64)
    for coll, tree in convert(probe, model).items():
        for path, pos in _leaves(tree):
            value = np.asarray(_get(variables[coll], path), np.float32)
            if value.shape != pos.shape:
                raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                                 f"{value.shape}, port expects {pos.shape}")
            idx = pos.astype(np.int64).ravel()
            flat[idx] = value.ravel()
            hits[idx] += 1
    if not (hits == 1).all():
        missed = [k for k, o, n in zip(sd, offsets, sizes)
                  if not (hits[o:o + n] == 1).all()]
        raise ValueError(f"state-dict entries not mapped exactly once: {missed}")
    return {k: torch.from_numpy(flat[o:o + v.numel()].reshape(v.shape).copy())
            for (k, v), o in zip(sd.items(), offsets)}
