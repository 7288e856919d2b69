"""Visualisation CLI: ply files of one cloud's caches, one a letter of
--output_type.

Port of superpoint_graph_tpu/cli/visualize.py (reference
partition/visualize.py:15-123): i = the input rgb cloud, g = the ground
truth, f = the geometric features, p = the partition, r = the prediction,
e = the errors, s = the SPG. `write_clouds` writes them from arrays with
the ply writers of data/provider.py (host numpy, no device); `main` reads
the features/ (or features_supervision/) and superpoint_graphs/ caches and
the predictions file (h5py, imported there) and writes
<ROOT_PATH>/clouds/<folder>/<name>_<kind>.ply. --upsample and --ver_batch
are parsed and never used, as in the JAX CLI: the plys hold the pruned
points.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import provider


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ply visualization export")
    p.add_argument("--dataset", default="s3dis")
    p.add_argument("--ROOT_PATH", default="datasets/s3dis")
    p.add_argument("--res_file", default="results/predictions_test")
    p.add_argument("--supervized_partition", type=int, default=0)
    p.add_argument("--file_path", default="Area_1/conferenceRoom_1")
    p.add_argument("--upsample", default=0, type=int)
    p.add_argument("--ver_batch", default=0, type=int)
    p.add_argument("--output_type", default="igfpres")
    return p.parse_args(argv)


def write_clouds(ply_file: str, output_type: str, dataset: str, xyz, rgb,
                 labels, geof, graph_sp=None, components=None,
                 pred_red=None) -> list[str]:
    """The plys of `output_type` for one cloud, each `ply_file` +
    "_<kind>.ply": rgb (i), GT (g, when there are labels), geof (f),
    partition (p), pred (r, when `pred_red`, a class a superpoint, is
    given), err (e, with labels and pred_red), spg (s). p, r, e and s need
    `components` and `graph_sp`. Returns the paths written, in that
    order."""
    n_labels = {"s3dis": 13, "sema3d": 8, "vkitti": 13}.get(dataset, 10)
    pred_full = (None if pred_red is None else
                 provider.reduced_labels2full(pred_red, components, len(xyz)))
    has_labels = np.size(labels) > 0
    written = []

    def out(kind):
        written.append(f"{ply_file}_{kind}.ply")
        return written[-1]

    if "i" in output_type:
        provider._write_ply_xyzrgb(out("rgb"), xyz, rgb)
    if "g" in output_type and has_labels:
        lab = labels.argmax(1) if np.ndim(labels) > 1 else labels
        provider.prediction2ply(out("GT"), xyz, lab, n_labels, dataset)
    if "f" in output_type:
        provider.geof2ply(out("geof"), xyz, geof)
    if "p" in output_type:
        provider.partition2ply(out("partition"), xyz, components)
    if "r" in output_type and pred_full is not None:
        provider.prediction2ply(out("pred"), xyz, pred_full + 1, n_labels,
                                dataset)
    if "e" in output_type and pred_full is not None and has_labels:
        provider.error2ply(out("err"), xyz, rgb, labels, pred_full + 1)
    if "s" in output_type:
        provider.spg2ply(out("spg"), graph_sp)
    return written


def main(argv=None) -> list[str]:
    """Write the plys of --output_type for --file_path; returns their
    paths."""
    import h5py

    from ..utils.h5io import read_features, read_spg

    args = parse_args(argv)
    root = args.ROOT_PATH.rstrip("/") + "/"
    folder, file_name = os.path.split(args.file_path)
    folder += "/"
    fea_file = root + "features/" + folder + file_name + ".h5"
    if not os.path.isfile(fea_file) or args.supervized_partition:
        fea_file = root + "features_supervision/" + folder + file_name + ".h5"
    spg_file = root + "superpoint_graphs/" + folder + file_name + ".h5"
    ply_folder = root + "clouds/" + folder
    os.makedirs(ply_folder, exist_ok=True)
    if not os.path.isfile(fea_file):
        raise SystemExit(f"{fea_file} does not exist and is needed")
    geof, xyz, rgb, _, labels = read_features(fea_file)
    ot = args.output_type
    graph_sp = components = pred_red = None
    if any(k in ot for k in "prse"):
        if not os.path.isfile(spg_file):
            raise SystemExit(f"{spg_file} needed for partition/result output")
        graph_sp, components, _ = read_spg(spg_file)
    if "r" in ot or "e" in ot:
        res_file = args.res_file + ".h5"
        if not os.path.isfile(res_file):
            raise SystemExit(f"{res_file} needed for result output")
        with h5py.File(res_file, "r") as f:
            key = (folder + file_name).replace("/", "__")
            if key not in f and folder + file_name in f:
                key = folder + file_name
            pred_red = np.array(f[key])
    written = write_clouds(ply_folder + file_name, ot, args.dataset, xyz, rgb,
                           labels, geof, graph_sp, components, pred_red)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
