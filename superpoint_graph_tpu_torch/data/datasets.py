"""Dataset adapters: class maps, split definitions, dataset info and the
split lists of SPG entries.

Port of superpoint_graph_tpu/data/datasets.py (reference learning/
{s3dis,sema3d,vkitti,custom}_dataset.py `get_datasets` / `get_info`), host
code only, with its own copy of the class maps and validation names.
Entries are spg_reader tuples named '<split>/<cloud>' so that the parsed
rows resolve; the edge-feature scaler is fit on the train split.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .parsed import class_weights as compute_class_weights
from .parsed import read_class_count
from .spg_io import scaler01, spg_reader

S3DIS_INV_CLASS_MAP = {
    0: "ceiling", 1: "floor", 2: "wall", 3: "column", 4: "beam", 5: "window",
    6: "door", 7: "table", 8: "chair", 9: "bookcase", 10: "sofa", 11: "board",
    12: "clutter",
}
SEMA3D_INV_CLASS_MAP = {
    0: "terrain_man", 1: "terrain_nature", 2: "veget_hi", 3: "veget_low",
    4: "building", 5: "scape", 6: "artefact", 7: "cars",
}
VKITTI_INV_CLASS_MAP = {
    0: "Terrain", 1: "Tree", 2: "Vegetation", 3: "Building", 4: "Road",
    5: "GuardRail", 6: "TrafficSign", 7: "TrafficLight", 8: "Pole", 9: "Misc",
    10: "Truck", 11: "Car", 12: "Van",
}

S3DIS_VALID_NAMES = [
    "hallway_1.h5", "hallway_6.h5", "hallway_11.h5", "office_1.h5",
    "office_6.h5", "office_11.h5", "office_16.h5", "office_21.h5",
    "office_26.h5", "office_31.h5", "office_36.h5", "WC_2.h5", "storage_1.h5",
    "storage_5.h5", "conferenceRoom_2.h5", "auditorium_1.h5",
]
SEMA3D_TRAIN_NAMES = [
    "bildstein_station1", "bildstein_station5", "domfountain_station1",
    "domfountain_station3", "neugasse_station1", "sg27_station1",
    "sg27_station2", "sg27_station5", "sg27_station9", "sg28_station4",
    "untermaederbrunnen_station1",
]
SEMA3D_VALID_NAMES = [
    "bildstein_station3", "domfountain_station2", "sg27_station4",
    "untermaederbrunnen_station3",
]
VKITTI_VALID_NAMES = [
    "0001_00000.h5", "0001_00085.h5", "0001_00170.h5", "0001_00230.h5",
    "0001_00325.h5", "0001_00420.h5", "0002_00000.h5", "0002_00111.h5",
    "0002_00223.h5", "0018_00030.h5", "0018_00184.h5", "0018_00338.h5",
    "0020_00080.h5", "0020_00262.h5", "0020_00444.h5", "0020_00542.h5",
    "0020_00692.h5", "0020_00800.h5",
]


@dataclasses.dataclass
class DatasetInfo:
    node_feats: int
    edge_feats: int
    classes: int
    class_weights: np.ndarray
    inv_class_map: dict


def edge_feat_dim(edge_attribs: str) -> int:
    """Columns of the --edge_attribs DSL (3 for vectors, 1 otherwise)."""
    return sum(3 if a.split("/")[0] in ("delta_avg", "delta_std", "xyz") else 1
               for a in edge_attribs.split(","))


def get_info(dataset: str, root: str, edge_attribs: str, pc_attribs: str,
             loss_weights: str = "none", cvfold: int = 0) -> DatasetInfo:
    """Classes, class map, edge-feature width and class weights (read from
    parsed/class_count.h5 unless loss_weights is 'none', leaving out the
    test fold's column for s3dis and vkitti). node_feats counts pc_attribs'
    characters, as the reference does (s3dis_dataset.py:85); the loader's
    channel count is data/loader.py::pc_attrib_dims."""
    n_classes, inv_map, default_nf = {
        "s3dis": (13, S3DIS_INV_CLASS_MAP, 14),
        "sema3d": (8, SEMA3D_INV_CLASS_MAP, 14),
        "vkitti": (13, VKITTI_INV_CLASS_MAP, 9),
        "custom_dataset": (13, S3DIS_INV_CLASS_MAP, 14),
    }[dataset]
    if loss_weights == "none":
        weights = np.ones(n_classes, np.float32)
    else:
        cc = read_class_count(os.path.join(root, "parsed", "class_count.h5"))
        fold_cols = ([i for i in range(6) if i != cvfold - 1]
                     if dataset in ("s3dis", "vkitti") and cc.ndim > 1
                     else None)
        weights = compute_class_weights(cc, loss_weights, fold_cols)
    return DatasetInfo(
        node_feats=default_nf if pc_attribs == "" else len(pc_attribs),
        edge_feats=edge_feat_dim(edge_attribs), classes=n_classes,
        class_weights=weights, inv_class_map=inv_map)


def _list_h5(path: str) -> list[str]:
    if not os.path.isdir(path):
        return []
    return sorted(f for f in os.listdir(path) if f.endswith(".h5"))


def split_names(dataset: str, root: str, cvfold: int = 0,
                use_val_set: bool = False, db_train_name: str = "train",
                db_test_name: str = "test"):
    """(train, test, valid) file lists, as '<split>/<name>.h5' relative to
    <root>/superpoint_graphs: s3dis and vkitti by cross-validation fold
    (the named validation rooms apart with use_val_set), sema3d by the
    station lists, custom_dataset by its train/ and test/ folders."""
    train, test, valid = [], [], []
    spg_root = os.path.join(root, "superpoint_graphs")
    if dataset in ("s3dis", "vkitti"):
        folds = ([f"Area_{n}" for n in range(1, 7)] if dataset == "s3dis"
                 else [f"0{n}" for n in range(1, 7)])
        val_names = (S3DIS_VALID_NAMES if dataset == "s3dis"
                     else VKITTI_VALID_NAMES)
        for n, fold in enumerate(folds, start=1):
            files = [f"{fold}/{f}"
                     for f in _list_h5(os.path.join(spg_root, fold))]
            if n == cvfold:
                test.extend(files)
                continue
            for f in files:
                if use_val_set and os.path.basename(f) in val_names:
                    valid.append(f)
                else:
                    train.append(f)
    elif dataset == "sema3d":
        names = SEMA3D_TRAIN_NAMES + (
            SEMA3D_VALID_NAMES if db_train_name == "trainval" else [])
        train = [f"train/{n}.h5" for n in names]
        if use_val_set:
            valid = [f"train/{n}.h5" for n in SEMA3D_VALID_NAMES]
        sub = {"testred": "test_reduced",
               "testfull": "test_full"}.get(db_test_name)
        if sub:
            test = [f"{sub}/{f}" for f in _list_h5(os.path.join(spg_root, sub))]
    else:  # custom_dataset
        train = [f"train/{f}" for f in _list_h5(os.path.join(spg_root, "train"))]
        test = [f"test/{f}" for f in _list_h5(os.path.join(spg_root, "test"))]
    return train, test, valid


def get_datasets(dataset: str, root: str, edge_attribs: str,
                 spg_superedge_cutoff: float = -1, spg_attribs01: bool = True,
                 cvfold: int = 0, use_val_set: bool = False,
                 db_train_name: str = "train", db_test_name: str = "test"):
    """(trainlist, testlist, validlist, scaler): the spg_reader entries of
    each split, edge features scaled by a scaler fit on the train split
    (None without spg_attribs01 or train entries)."""
    train_f, test_f, valid_f = split_names(
        dataset, root, cvfold, use_val_set, db_train_name, db_test_name)

    def read(rel):
        return spg_reader(os.path.join(root, "superpoint_graphs", rel),
                          edge_attribs, spg_superedge_cutoff,
                          incl_dir_in_name=True)

    trainlist = [read(f) for f in train_f]
    testlist = [read(f) for f in test_f]
    validlist = [read(f) for f in valid_f]
    scaler = None
    if spg_attribs01 and trainlist:
        trainlist, testlist, validlist, scaler = scaler01(
            trainlist, testlist, validlist=validlist)
    return trainlist, testlist, validlist, scaler
