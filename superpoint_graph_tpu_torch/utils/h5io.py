"""HDF5 caches of the partition: the JAX package's layout
(superpoint_graph_tpu/utils/h5io.py; reference provider.py:516-628), same
dataset names, dtypes and shapes, so a file written by either package reads
in the other.

  features/<split>/<name>.h5
  superpoint_graphs/<split>/<name>.h5

h5py is imported inside each function: the card's machine need not have it.
"""
from __future__ import annotations

import os

import numpy as np

SPG_KEYS_F32 = (
    "sp_centroids", "sp_length", "sp_surface", "sp_volume", "se_delta_mean",
    "se_delta_std", "se_delta_norm", "se_delta_centroid", "se_length_ratio",
    "se_surface_ratio", "se_volume_ratio", "se_point_count_ratio",
)


def write_features(file_name, geof, xyz, rgb, graph_nn, labels):
    """geof f32, source/target u32, distances f32, xyz f32, rgb u8 (when
    given), labels u32 histograms or u8 ids (provider.py:516-532)."""
    import h5py

    if os.path.isfile(file_name):
        os.remove(file_name)
    with h5py.File(file_name, "w") as f:
        f.create_dataset("geof", data=geof, dtype="float32")
        f.create_dataset("source", data=graph_nn["source"], dtype="uint32")
        f.create_dataset("target", data=graph_nn["target"], dtype="uint32")
        f.create_dataset("distances", data=graph_nn["distances"],
                         dtype="float32")
        f.create_dataset("xyz", data=xyz, dtype="float32")
        if rgb is not None and len(rgb) > 0:
            f.create_dataset("rgb", data=rgb, dtype="uint8")
        if (labels is not None and np.size(labels) > 0
                and np.ndim(labels) > 1 and np.shape(labels)[1] > 1):
            f.create_dataset("labels", data=labels, dtype="uint32")
        else:
            f.create_dataset("labels", data=[] if labels is None else labels,
                             dtype="uint8")


def read_features(file_name):
    """(geof, xyz, rgb, graph_nn, labels) of a features file
    (provider.py:534-556); rgb zeros when the file has none."""
    import h5py

    with h5py.File(file_name, "r") as f:
        labels = np.array(f["labels"]) if len(f["labels"]) else []
        geof = f["geof"][:]
        xyz = f["xyz"][:]
        rgb = f["rgb"][:] if "rgb" in f else np.zeros((len(xyz), 3), np.uint8)
        graph_nn = {"is_nn": True, "source": f["source"][:],
                    "target": f["target"][:]}
        if "distances" in f:
            graph_nn["distances"] = f["distances"][:]
    return geof, xyz, rgb, graph_nn, labels


def write_spg(file_name, graph_sp, components, in_component):
    """components/<i> u32, in_component u32, sp_labels u32, sp_point_count
    u64, source/target u32, the SPG_KEYS_F32 f32 (provider.py:558-600)."""
    import h5py

    if os.path.isfile(file_name):
        os.remove(file_name)
    with h5py.File(file_name, "w") as f:
        grp = f.create_group("components")
        for i, comp in enumerate(components):
            grp.create_dataset(str(i), data=comp, dtype="uint32")
        f.create_dataset("in_component", data=in_component, dtype="uint32")
        f.create_dataset("sp_labels", data=graph_sp["sp_labels"],
                         dtype="uint32")
        f.create_dataset("sp_point_count", data=graph_sp["sp_point_count"],
                         dtype="uint64")
        f.create_dataset("source", data=graph_sp["source"], dtype="uint32")
        f.create_dataset("target", data=graph_sp["target"], dtype="uint32")
        for k in SPG_KEYS_F32:
            f.create_dataset(k, data=graph_sp[k], dtype="float32")


def read_spg(file_name):
    """(graph, components, in_component) of an SPG file
    (provider.py:602-628); components as a list of u32 arrays."""
    import h5py

    with h5py.File(file_name, "r") as f:
        graph = {"is_nn": False,
                 "source": np.array(f["source"], dtype="uint32"),
                 "target": np.array(f["target"], dtype="uint32")}
        for k in SPG_KEYS_F32:
            graph[k] = np.array(f[k], dtype="float32")
        graph["sp_point_count"] = np.array(f["sp_point_count"],
                                           dtype="uint64")
        graph["sp_labels"] = np.array(f["sp_labels"], dtype="uint32")
        in_component = np.array(f["in_component"], dtype="uint32")
        grp = f["components"]
        components = [np.array(grp[str(i)], dtype="uint32")
                      for i in range(len(graph["sp_length"]))]
    return graph, components, in_component
