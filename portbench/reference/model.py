"""The superpoint-graph model in plain PyTorch, for the benchmark's checks.

Landrieu & Simonovsky, "Large-scale Point Cloud Semantic Segmentation with
Superpoint Graphs", CVPR 2018, with the layers of loicland/superpoint_graph
(learning/pointnet.py, learning/graphnet.py, learning/modules.py,
learning/ecc): a PointNet with a 2x2 spatial transformer embeds every
superpoint's sampled points, then an edge-conditioned GRU runs N rounds
over the superpoint graph and a linear layer reads the concatenated
states. Everything is a plain torch operation in float32; nothing of the
measured program is imported.

Parameters are a dict keyed by the reference repository's state-dict
names, so that the benchmark can draw one set of weights and hand it to
both sides. Batch norm: running statistics (eval mode).

Departures from the reference repository: dropout before the last PointNet
layer is not supported (the configurations run without it); the weights'
initialisation is the benchmark's own draw (harness/weights.py).

`tf32=True` rounds both inputs of every matrix product to TensorFloat-32
(10 mantissa bits), as the card's TF32 tensor cores do: the benchmark's
control, one precision below the float32 that the configurations state.
"""
from __future__ import annotations

import torch

BN_EPS = 1e-5


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TensorFloat-32 value (10 explicit
    mantissa bits, ties away from zero in magnitude)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with both inputs rounded to TF32, and in backward the two
    products likewise (the incoming gradient rounded too), accumulated in
    float32: a product on TF32 tensor cores."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ra, rb, rg = round_tf32(a), round_tf32(b), round_tf32(g)
        ga = torch.matmul(rg, rb.transpose(-1, -2))
        gb = torch.matmul(ra.transpose(-1, -2), rg)
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def matmul(a, b, tf32=False):
    """a @ b in float32, or as TF32 tensor cores compute it."""
    return _TF32Product.apply(a, b) if tf32 else torch.matmul(a, b)


def linear(x, w, b=None, tf32=False):
    """x @ w.T + b."""
    y = matmul(x, w.t(), tf32)
    return y if b is None else y + b


def bmm(a, b, tf32=False):
    return matmul(a, b, tf32)


def parse_config(model_config: str):
    """[("gru", n_rounds, vv, layernorm, ingate, cat_all) | ("f", width)]:
    the graph network's tokens (graphnet.py's DSL, the two kinds the
    configurations use)."""
    tokens = []
    for conf in model_config.split(","):
        parts = conf.strip().split("_")
        if parts[0] == "gru":
            flags = [bool(int(p)) for p in parts[2:6]]
            flags += [True] * (4 - len(flags))
            tokens.append(("gru", int(parts[1]), *flags))
        elif parts[0] == "f":
            tokens.append(("f", int(parts[1])))
        else:
            raise NotImplementedError(f"token {conf!r}")
    return tokens


def param_specs(cfg: dict) -> list:
    """[(name, shape, kind)] of the model in `cfg` (a configuration's
    "model" entry); kind is one of weight, bias, bn_weight, bn_bias,
    bn_mean, bn_var, stn_proj."""
    specs = []

    def lin(name, n_in, n_out, bias=True, conv=False):
        shape = (n_out, n_in, 1) if conv else (n_out, n_in)
        specs.append((f"{name}.weight", shape, "weight"))
        if bias:
            specs.append((f"{name}.bias", (n_out,), "bias"))

    def bn(name, n):
        specs.extend([(f"{name}.weight", (n,), "bn_weight"),
                      (f"{name}.bias", (n,), "bn_bias"),
                      (f"{name}.running_mean", (n,), "bn_mean"),
                      (f"{name}.running_var", (n,), "bn_var")])

    def conv_stack(prefix, n_in, widths):
        for i, w in enumerate(widths):
            lin(f"{prefix}.{3 * i}", n_in, w, conv=True)
            bn(f"{prefix}.{3 * i + 1}", w)
            n_in = w
        return n_in

    if cfg.get("ptn_prelast_do", 0):
        raise NotImplementedError("dropout in the PointNet")
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    n = conv_stack("ptn.stn.convs", cfg["ptn_nfeat_stn"], stn_conv_w)
    for i, w in enumerate(stn_fc_w):
        lin(f"ptn.stn.fcs.{3 * i}", n, w)
        bn(f"ptn.stn.fcs.{3 * i + 1}", w)
        n = w
    specs.append(("ptn.stn.proj.weight", (4, n), "stn_proj"))
    specs.append(("ptn.stn.proj.bias", (4,), "bias"))
    n = conv_stack("ptn.convs", cfg["ptn_nfeat"], conv_w) + 1  # + diameter
    for i, w in enumerate(fc_w):
        lin(f"ptn.fcs.{3 * i}", n, w)
        if i < len(fc_w) - 1:
            bn(f"ptn.fcs.{3 * i + 1}", w)
        n = w
    for d, tok in enumerate(parse_config(cfg["model_config"])):
        if tok[0] == "f":
            lin(f"ecc.{d}", n, tok[1])
            n = tok[1]
            continue
        _, rounds, vv, layernorm, ingate, cat_all = tok
        if not (layernorm and ingate):
            raise NotImplementedError("GRU without its norm and input gate")
        ws = list(cfg["fnet_widths"])
        j = 0
        for k in range(len(ws) - 1):
            lin(f"ecc.{d}._fnet.{j}", ws[k], ws[k + 1])
            j += 1
            if cfg["fnet_bnidx"] == k:
                bn(f"ecc.{d}._fnet.{j}", ws[k + 1])
                j += 1
            j += 1  # relu
        lin(f"ecc.{d}._fnet.{j}", ws[-1], n if vv else n * n,
            bias=cfg["fnet_llbias"])
        specs.extend([(f"ecc.{d}._cell.weight_ih", (3 * n, n), "weight"),
                      (f"ecc.{d}._cell.weight_hh", (3 * n, n), "weight"),
                      (f"ecc.{d}._cell.bias_ih", (3 * n,), "bias"),
                      (f"ecc.{d}._cell.bias_hh", (3 * n,), "bias")])
        lin(f"ecc.{d}._cell.ig", n, n)
        if cat_all:
            n *= rounds + 1
    return specs


def batch_norm(p, name, x):
    """x [..., C] normalised by the running statistics (eval mode)."""
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def instance_norm(x, eps=BN_EPS):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _mlp_point(p, prefix, x, widths, tf32):
    for i in range(len(widths)):
        w = p[f"{prefix}.{3 * i}.weight"]
        x = linear(x, w.reshape(w.shape[0], -1), p[f"{prefix}.{3 * i}.bias"],
                   tf32)
        x = torch.relu(batch_norm(p, f"{prefix}.{3 * i + 1}", x))
    return x


def pointnet(p, cfg, clouds, diameters, tf32=False):
    """Embeddings [n, out] of n valid superpoints' point sets [n, P, C] and
    their diameters [n]."""
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    h = _mlp_point(p, "ptn.stn.convs", clouds[..., :cfg["ptn_nfeat_stn"]],
                   stn_conv_w, tf32).amax(1)
    for i in range(len(stn_fc_w)):
        h = linear(h, p[f"ptn.stn.fcs.{3 * i}.weight"],
                   p[f"ptn.stn.fcs.{3 * i}.bias"], tf32)
        h = torch.relu(batch_norm(p, f"ptn.stn.fcs.{3 * i + 1}", h))
    t = linear(h, p["ptn.stn.proj.weight"], p["ptn.stn.proj.bias"], tf32)
    t = t.reshape(-1, 2, 2) + torch.eye(2, dtype=t.dtype, device=t.device)
    x = torch.cat([bmm(clouds[..., :2], t, tf32), clouds[..., 2:]], -1)
    x = _mlp_point(p, "ptn.convs", x, conv_w, tf32).amax(1)
    x = torch.cat([x, diameters[:, None]], -1)
    for i in range(len(fc_w)):
        x = linear(x, p[f"ptn.fcs.{3 * i}.weight"], p[f"ptn.fcs.{3 * i}.bias"],
                   tf32)
        if i < len(fc_w) - 1:
            x = torch.relu(batch_norm(p, f"ptn.fcs.{3 * i + 1}", x))
    return x


def filter_net(p, prefix, cfg, feats, tf32):
    """The filter-generating network over edge-feature rows [m, F]."""
    ws = list(cfg["fnet_widths"])
    j = 0
    x = feats
    for k in range(len(ws) - 1):
        x = linear(x, p[f"{prefix}.{j}.weight"], p[f"{prefix}.{j}.bias"], tf32)
        j += 1
        if cfg["fnet_bnidx"] == k:
            x = batch_norm(p, f"{prefix}.{j}", x)
            j += 1
        x = torch.relu(x)
        j += 1
    return linear(x, p[f"{prefix}.{j}.weight"], p.get(f"{prefix}.{j}.bias"),
                  tf32)


def gru_cell(p, prefix, x, h, tf32):
    """The reference's GRUCellEx: input gate, instance-normed gates."""
    x = torch.sigmoid(linear(h, p[f"{prefix}.ig.weight"],
                             p[f"{prefix}.ig.bias"], tf32)) * x
    gi = instance_norm(linear(x, p[f"{prefix}.weight_ih"], None, tf32))
    gh = instance_norm(linear(h, p[f"{prefix}.weight_hh"], None, tf32))
    i_r, i_z, i_n = (gi + p[f"{prefix}.bias_ih"]).chunk(3, -1)
    h_r, h_z, h_n = (gh + p[f"{prefix}.bias_hh"]).chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def forward(p: dict, cfg: dict, g: dict, tf32: bool = False) -> torch.Tensor:
    """Logits [n_nodes, n_classes] of one graph (or a disconnected union):
    `g` holds clouds [n, P, C], diameters [n], embeddable [n] bool (the
    others embed as zeros), edges src, tgt [E] and edge features [E, F]."""
    n_nodes = g["clouds"].shape[0]
    emb_valid = pointnet(p, cfg, g["clouds"][g["embeddable"]],
                         g["diameters"][g["embeddable"]], tf32)
    h = emb_valid.new_zeros((n_nodes, emb_valid.shape[1]))
    h = h.index_put((g["embeddable"].nonzero()[:, 0],), emb_valid)
    src, tgt = g["src"], g["tgt"]
    uniq, inv = torch.unique(g["edge_feats"], dim=0, return_inverse=True)
    deg = torch.zeros(n_nodes, dtype=h.dtype, device=h.device).index_add_(
        0, tgt, torch.ones_like(tgt, dtype=h.dtype))
    for d, tok in enumerate(parse_config(cfg["model_config"])):
        if tok[0] == "f":
            h = linear(h, p[f"ecc.{d}.weight"], p[f"ecc.{d}.bias"], tf32)
            continue
        _, rounds, vv, _, _, cat_all = tok
        width = h.shape[1]
        filters = filter_net(p, f"ecc.{d}._fnet", cfg, uniq, tf32)[inv]
        if not vv:
            filters = filters.reshape(-1, width, width)
        states = [h]
        for _ in range(rounds):
            hs = h[src]
            msg = (hs * filters if vv
                   else bmm(hs[:, None, :], filters, tf32)[:, 0])
            agg = torch.zeros_like(h).index_add_(0, tgt, msg)
            agg = agg / deg.clamp(min=1.0)[:, None]
            h = gru_cell(p, f"ecc.{d}._cell", agg, h, tf32)
            states.append(h)
        if cat_all:
            h = torch.cat(states, 1)
    return h
