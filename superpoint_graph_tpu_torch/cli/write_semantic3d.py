"""Semantic3D submission writer: superpoint predictions spread to every raw
point of the test clouds, written as `.labels` files.

Port of superpoint_graph_tpu/cli/write_semantic3d.py (reference
partition/write_Semantic3d.py:16-75). `write_submission` is the work on
arrays: the superpoint classes + 1 spread to the pruned points
(`reduced_labels2full`), then to every raw point of the scan
(`interpolate_labels_batch`: one nn1 kernel call per chunk of `ver_batch`
raw rows on `device`, default the card), then one class a line. `main`
reads predictions_<db_test_name>.h5 and each scan's features/ and
superpoint_graphs/ caches (h5py, imported there) and writes
<odir>/submission/<scan>.labels.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..device import card_unless


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="write Semantic3D .labels submissions")
    p.add_argument("--SEMA3D_PATH", default="datasets/semantic3d")
    p.add_argument("--odir", default="results/sema3d")
    p.add_argument("--db_test_name", default="testred",
                   choices=["testred", "testfull"])
    p.add_argument("--ver_batch", default=5000000, type=int)
    return p.parse_args(argv)


def write_labels(path: str, labels) -> None:
    """One integer a line, "%d\\n": the bytes np.savetxt(path, labels,
    fmt="%d") writes, without its per-row Python formatting."""
    labels = np.asarray(labels, np.int64).ravel()
    with open(path, "w") as f:
        if len(labels):
            f.write("\n".join(map(str, labels.tolist())) + "\n")


def write_submission(out_path: str, raw_file: str, xyz, components,
                     predictions, ver_batch: int, device=None) -> np.ndarray:
    """The `.labels` of one scan: `predictions` (a class 0..7 a superpoint
    of `components`, which index the pruned points `xyz`) + 1 spread to
    every raw row of `raw_file` by exact 1-NN among `xyz` on `device`
    (default: the card), read in chunks of `ver_batch` rows; written to
    `out_path` and returned (uint8 [raw rows])."""
    from ..data.provider import interpolate_labels_batch, reduced_labels2full

    device = card_unless(device)
    pruned = reduced_labels2full(
        np.asarray(predictions).astype(np.uint8) + 1, components, len(xyz))
    full = interpolate_labels_batch(raw_file, xyz, pruned, ver_batch,
                                    device=device)
    write_labels(out_path, full)
    return full


def main(argv=None, device=None):
    """Write the submission of every scan of the test split that has a
    prediction, its spread on `device` (default: the card)."""
    import h5py

    from ..utils.h5io import read_spg

    args = parse_args(argv)
    device = card_unless(device)
    root = args.SEMA3D_PATH.rstrip("/")
    sub = {"testred": "test_reduced",
           "testfull": "test_full"}[args.db_test_name]
    pred_file = os.path.join(args.odir, f"predictions_{args.db_test_name}.h5")
    out_dir = os.path.join(args.odir, "submission")
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(pred_file, "r") as f:
        preds = {k: f[k][:] for k in f.keys()}
    for raw in sorted(glob.glob(os.path.join(root, "data", sub, "*.txt"))):
        name = os.path.splitext(os.path.basename(raw))[0]
        key = f"{sub}__{name}"
        if key not in preds and f"{sub}/{name}" in preds:
            key = f"{sub}/{name}"
        if key not in preds:
            print(f"{name}: no prediction, skipping")
            continue
        _, components, _ = read_spg(
            os.path.join(root, "superpoint_graphs", sub, name + ".h5"))
        with h5py.File(os.path.join(root, "features", sub, name + ".h5"),
                       "r") as f:
            xyz = f["xyz"][:]
        out = os.path.join(out_dir, name + ".labels")
        write_submission(out, raw, xyz, components, preds[key],
                         args.ver_batch, device)
        print(f"{name}: wrote {out}")


if __name__ == "__main__":
    main()
