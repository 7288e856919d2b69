"""Operation counts and bounds: the yardstick for the roofline and peak shares.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): 67 TFLOP/s in float32 outside the tensor cores (the
port runs with TF32 off) and 3.35 TB/s of HBM.
"""
from __future__ import annotations

from ..reference.model import parse_config

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# the least arithmetic an nn1 pair needs: the expanded form's 3 FMAs
NN1_FLOPS_PER_PAIR = 6


def nn1_flops(m: int, n: int) -> float:
    """Operations of a brute-force 1-NN of n queries over m db points."""
    return float(NN1_FLOPS_PER_PAIR) * m * n


def nn1_bound_s(m: int, n: int) -> float:
    """Least seconds the card needs for nn1 at m db points x n queries: the
    larger of the pairs' FP32 operations over the FP32 peak and the bytes
    (both clouds' float32 xyz read once, the int64 indices written once)
    over the memory rate."""
    ops_s = nn1_flops(m, n) / FP32_FLOPS
    bytes_s = (12 * (m + n) + 8 * n) / HBM_BYTES
    return max(ops_s, bytes_s)


def _mlp(widths) -> int:
    """Multiply-adds x 2 of a chain of dense layers."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def model_forward_flops(cfg: dict, n_embedded: int, n_points: int,
                        n_nodes: int, n_edges: int, n_filter_rows: int) -> float:
    """Matrix-product operations (2 per multiply-add) of one forward pass
    of the SPG model in `cfg` (a configuration's "model" entry) over a
    batch: n_embedded superpoints of n_points sampled points each through
    the PointNet and its transformer, the filter network over
    n_filter_rows distinct edge-feature rows, and per GRU round one filter
    product per edge and the cell's three products per node, then the
    linear layers. Element-wise work is left out."""
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    per_point = (_mlp([cfg["ptn_nfeat_stn"], *stn_conv_w])
                 + 2 * 2 * 2  # the 2x2 transform of xy
                 + _mlp([cfg["ptn_nfeat"], *conv_w]))
    per_cloud = (_mlp([stn_conv_w[-1], *stn_fc_w]) + 2 * stn_fc_w[-1] * 4
                 + _mlp([conv_w[-1] + 1, *fc_w]))
    flops = n_embedded * (n_points * per_point + per_cloud)
    width = fc_w[-1]
    for tok in parse_config(cfg["model_config"]):
        if tok[0] == "f":
            flops += n_nodes * 2 * width * tok[1]
            width = tok[1]
            continue
        _, rounds, vv, _, _, cat_all = tok
        out = width if vv else width * width
        flops += n_filter_rows * _mlp([*cfg["fnet_widths"], out])
        per_edge = 2 * width if vv else 2 * width * width
        per_node = 2 * width * width + 2 * 2 * width * 3 * width
        flops += rounds * (n_edges * per_edge + n_nodes * per_node)
        if cat_all:
            width *= rounds + 1
    return float(flops)


def batch_counts(batch) -> dict:
    """The shape counts `model_forward_flops` needs, from an SpgBatch."""
    n_edges = int(batch.edge_mask.sum())
    uniq = (int(batch.edge_uniq_mask.sum())
            if batch.edge_uniq_mask is not None else n_edges)
    return {"n_embedded": int(batch.cloud_mask.sum()),
            "n_points": int(batch.clouds.shape[1]),
            "n_nodes": int(batch.node_mask.sum()), "n_edges": n_edges,
            "n_filter_rows": uniq}
