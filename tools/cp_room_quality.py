#!/usr/bin/env python3
"""Cut-pursuit quality on chip_smoke.py's room, on the CPU: the port's device
solver, the JAX package's band solver and the exact max-flow solver on the
same features and kNN graph.

Writes chip_smoke.py's synthetic 1,000,000-point S3DIS room (seed 0) in the
raw layout and reads it back (xyz and colours as the reader parses them, the
generator's labels, which the reader reproduces on every point), prunes it at
0.03 m and builds the kNN graph and features with the port on the CPU. Then
the same features and graph go through
- the port: `pipeline._cutpursuit_device_path` (device solver + host merge);
- the port's solver again, at the JAX CC cap (`cc_rounds=24`), to show
  whether that cap binds here (`cc_capped`);
- the port's solver again without the JAX pad rows' term (`pad_rows=0`),
  to show what that term does;
- the JAX package: `ops/cutpursuit_band.cutpursuit_band_device` on the rows
  padded to a power of two, then its host `merge_regions`, as its
  `pipeline._cutpursuit_device_path` does;
- the exact solver (`ops/cutpursuit.py`, the port's copy).
Prints one JSON object: per solver the energy (the port's `_energy`), its
ratio to the exact solver's, the component count, OOA against the voxels'
labels and seconds on this CPU; then the port against the JAX solver.
Exits 1 unless the port is within the parity tests' limits of the JAX
solver (tests/test_torch_cutpursuit.py::test_device_path_matches_jax):
energy within 3%, component count within 15%, OOA within 1 point. Takes
~10 minutes and ~8 GB; imports both packages, so it runs where JAX is
installed. From the repository root:

    python3 tools/cp_room_quality.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax.numpy as jnp
    import torch

    from superpoint_graph_tpu.ops import cutpursuit as cp_j
    from superpoint_graph_tpu.ops import cutpursuit_band as band_j
    from superpoint_graph_tpu_torch.data.provider import read_rows
    from superpoint_graph_tpu_torch.data.synthetic import write_s3dis_room
    from superpoint_graph_tpu_torch.learn.metrics import compute_OOA
    from superpoint_graph_tpu_torch.ops import cutpursuit_band as band_t
    from superpoint_graph_tpu_torch.ops.components import group_components
    from superpoint_graph_tpu_torch.ops.cutpursuit import (_energy,
                                                           merge_regions)
    from superpoint_graph_tpu_torch.ops.cutpursuit import cutpursuit as exact
    from superpoint_graph_tpu_torch.ops.voxel import prune
    from superpoint_graph_tpu_torch.pipeline import (
        PartitionConfig, _assemble_features_device, _cutpursuit_device_path,
        assemble_partition_features, edge_weights, partition_features)

    cfg = PartitionConfig(spg_adjacency="knn")
    with tempfile.TemporaryDirectory() as tmp:
        raw, labels, _ = write_s3dis_room(Path(tmp) / "Area_1" / "room_0",
                                          np.random.RandomState(0), 1_000_000)
        rows = read_rows(str(raw))
    xyz, rgb, hist, _ = prune(rows[:, :3].astype(np.float32), cfg.voxel_width,
                              rows[:, 3:6].astype(np.uint8), labels, None, 13,
                              0, device="cpu")
    graph, geof, dev = partition_features(xyz, cfg, device="cpu",
                                          return_device=True)
    n = len(xyz)
    feats = assemble_partition_features(geof, rgb, cfg)
    src = graph["source"].astype(np.int64)
    tgt = graph["target"].astype(np.int64)
    w = edge_weights(graph["distances"], cfg.lambda_edge_weight)

    def quality(in_comp, seconds):
        e, _ = _energy(feats.astype(np.float64), np.ones(n),
                       np.asarray(in_comp, np.int64), src, tgt,
                       w.astype(np.float64), cfg.reg_strength)
        return {"energy": e, "n_comp": int(in_comp.max()) + 1,
                "OOA": compute_OOA(group_components(in_comp), hist[:, 1:]),
                "seconds": seconds}

    out = {"voxels": n}
    t0 = time.perf_counter()
    _, ic, _ = _cutpursuit_device_path(xyz, rgb, graph, dev, cfg)
    out["port_device"] = quality(ic, time.perf_counter() - t0)
    out["port_device"]["solve_stats"] = dict(band_t.LAST_SOLVE_STATS)

    k = cfg.k_nn_adj
    f_dev = _assemble_features_device(dev["geof"], torch.as_tensor(rgb))
    for key, kw in (("port_device_cc_rounds_24", {"cc_rounds": 24}),
                    ("port_device_no_pad_rows", {"pad_rows": 0})):
        t0 = time.perf_counter()
        ic = band_t.cutpursuit_band_device(
            f_dev, dev["idx"][:, :k], dev["d2"][:, :k], xyz, n,
            cfg.reg_strength, lambda_edge_weight=cfg.lambda_edge_weight, **kw)
        ic = merge_regions(feats, np.ones(n), ic, src, tgt, w,
                           cfg.reg_strength)
        out[key] = quality(ic, time.perf_counter() - t0)
        out[key]["solve_stats"] = dict(band_t.LAST_SOLVE_STATS)

    # the JAX solver on the same rows, padded as its caller pads them
    f_dev = f_dev.numpy()
    pad = ((0, band_t.jax_pad_rows(n)), (0, 0))
    t0 = time.perf_counter()
    ic = band_j.cutpursuit_band_device(
        jnp.asarray(np.pad(f_dev, pad)),
        jnp.asarray(np.pad(dev["idx"][:, :k].numpy().astype(np.int32), pad)),
        jnp.asarray(np.pad(dev["d2"][:, :k].numpy(), pad)),
        xyz, n, cfg.reg_strength, lambda_edge_weight=cfg.lambda_edge_weight)
    ic = cp_j.merge_regions(feats, np.ones(n), ic, src, tgt, w,
                            cfg.reg_strength)
    out["jax_band_device"] = quality(ic, time.perf_counter() - t0)
    out["jax_band_device"]["solve_stats"] = dict(band_j.LAST_SOLVE_STATS)

    t0 = time.perf_counter()
    _, ic = exact(feats, src, tgt, w, cfg.reg_strength)
    out["exact"] = quality(ic, time.perf_counter() - t0)
    solvers = ("port_device", "port_device_cc_rounds_24",
               "port_device_no_pad_rows", "jax_band_device")
    for key in solvers:
        out[key]["energy_ratio_to_exact"] = (out[key]["energy"]
                                             / out["exact"]["energy"])
    port, ref = out["port_device"], out["jax_band_device"]
    out["port_vs_jax"] = {"energy_ratio": port["energy"] / ref["energy"],
                          "n_comp_ratio": port["n_comp"] / ref["n_comp"],
                          "ooa_diff": port["OOA"] - ref["OOA"]}
    print(json.dumps(out, indent=1))
    gap = out["port_vs_jax"]
    return int(not (abs(gap["energy_ratio"] - 1.0) <= 0.03
                    and abs(gap["n_comp_ratio"] - 1.0) <= 0.15
                    and abs(gap["ooa_diff"]) <= 1.0))


if __name__ == "__main__":
    sys.exit(main())
