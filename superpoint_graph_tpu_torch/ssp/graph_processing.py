"""SSP preprocessing: the features_supervision structures, graph loading,
collation.

Port of superpoint_graph_tpu/ssp/graph_processing.py (reference
supervized_partition/graph_processing.py):
  * build_supervision_structure: prune (with object histograms for S3DIS),
    one kNN search for the adjacency (k_nn_adj) and the local clouds
    (k_nn_local), ground-truth transition edges, geof with the verticality
    doubled, the elevation above a RANSAC plane (utils/ransac.py) or above
    the lowest point, xy normalised to the cloud's box. Prune, kNN and geof
    run on `device` (default: the card). `serving_structure` is the same
    without the ground truth and the geof, for a cloud to be partitioned;
  * compute_transitions: s3dis, object ids differ; sema3d, labels inpainted
    by cut pursuit (zero fidelity on unlabelled points), then object ids
    differ; vkitti, components of constant label;
  * write_structure / read_structure: the features_supervision h5 layout,
    h5py imported when called. `structure_arrays` gives read_structure's
    arrays from the dict in memory (the card's machine has no h5py);
  * graph_loader: whole-cloud augmentation, BFS subgraph of at most
    max_ver_train vertices with its indices remapped, per-point local
    clouds xyz[nei] centred and scaled by sqrt(sum var) plus rgb, the
    global features; from a structure file or the dict;
  * graph_collate: concatenation with edge indices offset.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..device import card_unless
from ..ops import geof as geof_ops
from ..ops.components import connected_components
from ..ops.cutpursuit import cutpursuit2
from ..ops.knn import compute_graph_nn_2
from ..ops.subgraph import random_subgraph
from ..ops.voxel import prune
from ..utils import tracing
from ..utils.ransac import plane_elevation


@dataclasses.dataclass
class SspPreprocessConfig:
    k_nn_adj: int = 5
    k_nn_local: int = 20
    voxel_width: float = 0.03
    compute_geof: bool = True
    plane_model: bool = True
    use_voronoi: float = 0.0  # > 0: Delaunay edges below this squared length
    dataset: str = "s3dis"


def compute_transitions(dataset, objects, labels, graph_nn, n_ver):
    """(is_transition [E], objects [n]) of the ground truth
    (graph_processing.py:148-173)."""
    src, tgt = graph_nn["source"], graph_nn["target"]
    if dataset == "s3dis":
        return objects[src] != objects[tgt], objects
    if dataset == "sema3d":
        hard = np.argmax(labels[:, 1:], 1) + 1
        no_lab = np.flatnonzero(labels[:, 1:].sum(1) == 0)
        hard[no_lab] = 0
        is_transition = ((hard[src] != hard[tgt]) & (hard[src] != 0)
                         & (hard[tgt] != 0))
        keep = ~is_transition
        node_weight = np.ones(n_ver, np.float32)
        node_weight[no_lab] = 0
        _, objects = cutpursuit2(
            hard.astype(np.float32), src[keep].astype(np.int64),
            tgt[keep].astype(np.int64), np.ones(keep.sum(), np.float32),
            node_weight, 0.01)
        return objects[src] != objects[tgt], objects.astype(np.uint32)
    if dataset == "vkitti":
        hard = np.argmax(labels, 1)
        is_transition = hard[src] != hard[tgt]
        _, objects = connected_components(
            n_ver, src.astype(np.int64), tgt.astype(np.int64),
            (~is_transition).astype(np.uint8), 0)
        return is_transition, objects.astype(np.uint32)
    raise ValueError(f"unknown dataset {dataset!r}")


def build_supervision_structure(xyz, rgb, labels, objects,
                                cfg: SspPreprocessConfig, n_labels: int,
                                device=None) -> dict:
    """One cloud's features_supervision structure (the dict write_structure
    stores), its device stages on `device` (default: the card)."""
    device = card_unless(device)
    if cfg.voxel_width > 0 and cfg.dataset == "s3dis":
        n_objects = int(objects.max()) + 1
        xyz, rgb, labels, obj_hist = prune(
            xyz, cfg.voxel_width, rgb, labels, objects, n_labels, n_objects,
            device=device)
        objects = obj_hist[:, 1:].argmax(1) + 1
    elif cfg.voxel_width > 0:
        xyz, rgb, labels, _ = prune(xyz, cfg.voxel_width, rgb, labels, None,
                                    n_labels, 0, device=device)
        objects = np.zeros(len(xyz), np.uint32)
    s, local_neighbors = _structure(xyz, rgb, labels, cfg, device)
    is_transition, objects = compute_transitions(
        cfg.dataset, objects, labels, s["graph_nn"], len(xyz))
    if cfg.compute_geof:
        xyz_t = torch.as_tensor(s["xyz"], device=device)
        geof = tracing.to_host(geof_ops.compute_geof(xyz_t, local_neighbors),
                               "ssp.geof").numpy()
        geof[:, 3] *= 2.0
    else:
        geof = np.zeros(0)
    return dict(s, is_transition=np.asarray(is_transition, np.uint8),
                objects=np.asarray(objects, np.uint32), geof=geof)


def serving_structure(xyz, rgb, labels, cfg: SspPreprocessConfig,
                      n_labels: int, device=None, on_voxels=None) -> dict:
    """A cloud's structure for partitioning it, not for training: the
    voxels, the kNN graph, the local neighbourhoods, the elevation and the
    normalised xy of `build_supervision_structure`, without the
    ground-truth transitions and objects (zeros here: only the training
    loss reads them) or the geometric features. `labels` (raw ids) become
    the voxels' histograms for the SPG. `on_voxels(xyz)`, where given, is
    called with the voxels (float32, the structure's "xyz") before the
    kNN search."""
    device = card_unless(device)
    if cfg.voxel_width > 0:
        xyz, rgb, labels, _ = prune(xyz, cfg.voxel_width, rgb, labels, None,
                                    n_labels, 0, device=device)
    xyz = np.asarray(xyz, np.float32)
    if on_voxels is not None:
        on_voxels(xyz)
    s, _ = _structure(xyz, rgb, labels, cfg, device)
    n_ver, n_edg = len(s["xyz"]), len(s["graph_nn"]["source"])
    return dict(s, is_transition=np.zeros(n_edg, np.uint8),
                objects=np.zeros(n_ver, np.uint32), geof=np.zeros(0))


def _structure(xyz, rgb, labels, cfg: SspPreprocessConfig, device):
    """(the structure's keys that do not depend on the ground truth, the
    local neighbours [n, k_nn_local] on `device`) of pruned voxels: one kNN
    search for the adjacency and the local clouds, in tiles of a fixed
    size so that the peak memory does not follow the voxel count, the
    elevation above a RANSAC plane (or the lowest point), xy normalised to
    the box."""
    xyz = np.asarray(xyz, np.float32)
    n_ver = len(xyz)
    graph_nn, local_neighbors = compute_graph_nn_2(
        xyz, cfg.k_nn_adj, cfg.k_nn_local, device=device,
        voronoi=float(cfg.use_voronoi), block_q=None)
    if cfg.plane_model:
        elevation = plane_elevation(xyz)
    else:
        elevation = xyz[:, 2] - xyz[:, 2].min()
    ma = xyz[:, :2].max(0, keepdims=True)
    mi = xyz[:, :2].min(0, keepdims=True)
    xyn = (xyz[:, :2] - mi) / (ma - mi + 1e-8)
    local = tracing.to_host(local_neighbors, "ssp.local_neighbors").numpy()
    return {
        "xyz": xyz,
        "rgb": np.asarray(rgb, np.float32),
        "graph_nn": graph_nn,
        "target_local_geometry": local.astype(np.uint32).reshape(
            n_ver, cfg.k_nn_local),
        "labels": labels,
        "elevation": np.asarray(elevation, np.float32),
        "xyn": np.asarray(xyn, np.float32),
    }, local_neighbors


def _label_dtype(labels) -> str:
    """The h5 dtype of a structure's labels: int32 histograms, uint8 ids."""
    if np.size(labels) > 0 and np.ndim(labels) > 1 and np.shape(labels)[1] > 1:
        return "int32"
    return "uint8"


def write_structure(file_name, s: dict):
    """features_supervision h5 layout (graph_processing.py:198-221)."""
    import h5py

    with h5py.File(file_name, "w") as f:
        for key in ("xyz", "rgb", "elevation", "xyn"):
            f.create_dataset(key, data=s[key], dtype="float32")
        f.create_dataset("source", data=s["graph_nn"]["source"], dtype="int")
        f.create_dataset("target", data=s["graph_nn"]["target"], dtype="int")
        f.create_dataset("is_transition", data=s["is_transition"],
                         dtype="uint8")
        f.create_dataset("target_local_geometry",
                         data=s["target_local_geometry"], dtype="uint32")
        f.create_dataset("objects", data=s["objects"], dtype="uint32")
        if np.size(s["geof"]) > 0:
            f.create_dataset("geof", data=s["geof"], dtype="float32")
        f.create_dataset("labels", data=s["labels"],
                         dtype=_label_dtype(s["labels"]))


def structure_arrays(s: dict, read_geof: bool = False):
    """read_structure's tuple from a structure dict in memory, in the
    dtypes the h5 round trip gives: (xyz, rgb, edg_source, edg_target,
    is_transition, local_geometry, labels, objects, elevation, xyn)."""
    labels = np.asarray(s["labels"]).astype(_label_dtype(s["labels"])).squeeze()
    is_transition = np.asarray(s["is_transition"], np.uint8)
    if labels.ndim == 0:
        labels = np.array([0])
    if is_transition.ndim == 0:
        is_transition = np.array([0])
    local = (np.asarray(s["geof"], np.float32) if read_geof
             else np.asarray(s["target_local_geometry"], np.uint32))
    return (np.asarray(s["xyz"], np.float32), np.asarray(s["rgb"], np.float32),
            np.asarray(s["graph_nn"]["source"], np.int64).squeeze(),
            np.asarray(s["graph_nn"]["target"], np.int64).squeeze(),
            is_transition, local, labels, np.asarray(s["objects"], np.uint32),
            np.asarray(s["elevation"], np.float32),
            np.asarray(s["xyn"], np.float32))


def read_structure(file_name, read_geof: bool = False):
    """graph_processing.py:224-247: structure_arrays of a file."""
    import h5py

    with h5py.File(file_name, "r") as f:
        s = {key: np.array(f[key]) for key in (
            "xyz", "rgb", "elevation", "xyn", "is_transition", "objects",
            "labels", "target_local_geometry")}
        s["graph_nn"] = {"source": np.array(f["source"]),
                         "target": np.array(f["target"])}
        s["geof"] = np.array(f["geof"]) if read_geof else np.zeros(0)
    return structure_arrays(s, read_geof)


def augment_cloud_whole(xyz, rgb, rot: bool, jitter: bool, use_rgb: bool,
                        rs: np.random.RandomState):
    """The whole cloud rotated about a random point, then jittered
    (graph_processing.py:534-546)."""
    if rot:
        ref = xyz[rs.randint(len(xyz)), :3].copy()
        ref[2] = 0
        a = rs.uniform(0, 2 * math.pi)
        c, s = math.cos(a), math.sin(a)
        M = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        xyz = (xyz[:, :3] - ref) @ M + ref
    if jitter:
        sigma, clip = 0.002, 0.005
        xyz = xyz + np.clip(sigma * rs.standard_normal(xyz.shape), -clip,
                            clip).astype(np.float32)
        if use_rgb:
            rgb = np.clip(rgb + np.clip(sigma * rs.standard_normal(rgb.shape),
                                        -clip, clip), -1, 1).astype(np.float32)
    return xyz.astype(np.float32), rgb


@dataclasses.dataclass
class SspLoaderConfig:
    k_nn_local: int = 20
    max_ver_train: int = 10000
    use_rgb: bool = True
    global_feat: str = "eXYrgb"
    pc_augm_rot: bool = True
    pc_augm_jitter: bool = True
    learned_embeddings: bool = True
    ver_value: str = "ptn"  # 'ptn' | 'geof' | 'geofrgb'


def graph_loader(structure, train: bool, cfg: SspLoaderConfig,
                 rs: np.random.RandomState | None = None) -> dict:
    """One cloud's sample (graph_processing.py:347-436) from a structure
    file or a structure dict; augmentation and subsampling draw from
    `rs`."""
    rs = rs or np.random.RandomState()
    read_geof = "geof" in cfg.ver_value
    if isinstance(structure, (str, os.PathLike)):
        arrays = read_structure(structure, read_geof)
    else:
        arrays = structure_arrays(structure, read_geof)
    (xyz, rgb, edg_source, edg_target, is_transition, local_geometry, labels,
     objects, elevation, xyn) = arrays
    rgb = rgb / 255.0
    n_ver = xyz.shape[0]
    if train:
        xyz, rgb = augment_cloud_whole(xyz, rgb, cfg.pc_augm_rot,
                                       cfg.pc_augm_jitter, cfg.use_rgb, rs)
    selected_ver = np.ones(n_ver, bool)
    if train and 0 < cfg.max_ver_train < n_ver:
        selected_edg, selected_ver = random_subgraph(
            n_ver, edg_source, edg_target, int(cfg.max_ver_train), rs)
        new_index = -np.ones(n_ver, np.int64)
        new_index[selected_ver] = np.arange(selected_ver.sum())
        edg_source = new_index[edg_source[selected_edg]]
        edg_target = new_index[edg_target[selected_edg]]
        is_transition = is_transition[selected_edg]
        labels = labels[selected_ver] if labels.ndim else labels
        objects = objects[selected_ver]
        elevation = elevation[selected_ver]
        xyn = xyn[selected_ver]

    if cfg.learned_embeddings and cfg.ver_value == "ptn":
        nei = local_geometry[selected_ver, :cfg.k_nn_local].astype(np.int64)
        clouds = xyz[nei]  # [n, k, 3], coordinates before the subsampling
        diameters = np.sqrt(clouds.var(1).sum(1))
        clouds = (clouds - xyz[selected_ver, None, :]) / (
            diameters[:, None, None] + 1e-10)
        if cfg.use_rgb:
            clouds = np.concatenate([clouds, rgb[nei]], axis=2)
        clouds_global = diameters[:, None]
        gf = cfg.global_feat
        if "e" in gf.replace("rgb", ""):
            clouds_global = np.hstack([clouds_global, elevation[:, None]])
        if "rgb" in gf:
            clouds_global = np.hstack([clouds_global, rgb[selected_ver]])
        if "XY" in gf:
            clouds_global = np.hstack([clouds_global, xyn])
        if "xy" in gf.replace("XY", ""):
            clouds_global = np.hstack([clouds_global, xyz[selected_ver, :2]])
    elif cfg.ver_value == "geofrgb":
        clouds = np.concatenate([local_geometry, rgb[selected_ver]], axis=1)
        clouds_global = np.zeros((1,), np.float32)
    else:  # 'geof'
        clouds = local_geometry
        clouds_global = np.zeros((1,), np.float32)

    return {
        "edg_source": edg_source.astype(np.int64),
        "edg_target": edg_target.astype(np.int64),
        "is_transition": np.asarray(is_transition).astype(np.int32),
        "labels": labels,
        "objects": objects.astype(np.int64),
        "clouds": clouds.astype(np.float32),
        "clouds_global": clouds_global.astype(np.float32),
        "xyz": xyz[selected_ver].astype(np.float32),
    }


def graph_collate(samples) -> dict:
    """Per-cloud samples concatenated, edge indices offset by the vertices
    before them (graph_processing.py:439-472)."""
    out = {}
    v_off = 0
    srcs, tgts = [], []
    for s in samples:
        srcs.append(s["edg_source"] + v_off)
        tgts.append(s["edg_target"] + v_off)
        v_off += len(s["xyz"])
    out["edg_source"] = np.concatenate(srcs)
    out["edg_target"] = np.concatenate(tgts)
    for k in ("is_transition", "objects", "clouds", "clouds_global", "xyz"):
        out[k] = np.concatenate([s[k] for s in samples])
    labs = [np.atleast_1d(s["labels"]) for s in samples]
    try:
        out["labels"] = np.concatenate(labs)
    except ValueError:
        out["labels"] = labs[0]
    return out
