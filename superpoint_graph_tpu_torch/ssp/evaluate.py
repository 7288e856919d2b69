"""SSP partition evaluation: ASA, boundary recall, boundary precision.

Port of superpoint_graph_tpu/ssp/evaluate.py (reference
supervized_partition.py:248-375, the per-epoch `evaluate` and the final
`evaluate_final` writing res.h5 and the SPG files; evaluate_partition.py:
24-86, the aggregation over folds). h5py is imported when a file is
written or read; `FinalEvaluator.matrices` gives res.h5's arrays in
memory.
"""
from __future__ import annotations

import os

import numpy as np

from ..graph.spg import compute_sp_graph
from ..learn import metrics
from ..learn.metrics import perfect_prediction
from ..utils.h5io import write_spg
from .losses import relax_edge_binary


def evaluate_cloud(batch: dict, partition, n_classes: int,
                   BR_tolerance: int = 1) -> dict:
    """One partitioned cloud's quality: n_clusters, the ASA confusion matrix
    (`cm`, `asa`) where the labels are histograms, BR, BP, the partition
    and both transition masks; `partition` is (components, in_component)
    of the loaded cloud `batch`."""
    pred_components, pred_in_component = partition
    es, et = batch["edg_source"], batch["edg_target"]
    is_transition = np.asarray(batch["is_transition"]).astype(bool)
    pred_transition = pred_in_component[es] != pred_in_component[et]
    n_ver = len(pred_in_component)
    labels = np.asarray(batch["labels"])
    out = {"n_clusters": len(pred_components),
           "pred_components": pred_components,
           "pred_in_component": pred_in_component}
    if labels.ndim > 1:
        per_pred = perfect_prediction(pred_components, labels)
        cm = metrics.ConfusionMatrix(n_classes)
        cm.count_predicted_batch(labels[:, 1:], per_pred)
        out["cm"] = cm.confusion_matrix
        out["asa"] = 100.0 * np.trace(cm.confusion_matrix) / max(
            cm.confusion_matrix.sum(), 1)
    if is_transition.sum() > 0:
        out["br"] = metrics.compute_boundary_recall(
            is_transition,
            relax_edge_binary(pred_transition, es, et, n_ver, BR_tolerance))
    if pred_transition.sum() > 0:
        out["bp"] = metrics.compute_boundary_precision(
            relax_edge_binary(is_transition, es, et, n_ver, BR_tolerance),
            pred_transition)
    out["pred_transition"] = pred_transition
    out["is_transition"] = is_transition
    return out


class FinalEvaluator:
    """The res.h5 confusion matrices summed over the test clouds
    (supervized_partition.py:297-375)."""

    def __init__(self, n_classes: int, BR_tolerance: int = 1, device=None):
        self.n_classes = n_classes
        self.tol = BR_tolerance
        self.device = device
        self.cm_classes = metrics.ConfusionMatrix(n_classes)
        self.cm_br = metrics.ConfusionMatrix(2)
        self.cm_bp = metrics.ConfusionMatrix(2)
        self.n_clusters = []

    def add_cloud(self, part, spg_out_path=None, d_se_max: float = 100.0):
        """Evaluate one partitioned cloud (an ssp/generate.CloudPartition)
        and count it; its SPG (graph/spg.py, Delaunay support) goes to
        `spg_out_path` (h5) when given."""
        batch = part.sample
        res = evaluate_cloud(batch, (part.components, part.in_component),
                             self.n_classes, self.tol)
        labels = np.asarray(batch["labels"])
        es, et = batch["edg_source"], batch["edg_target"]
        n_ver = len(res["pred_in_component"])
        if labels.ndim > 1:
            self.cm_classes.confusion_matrix += res["cm"]
            self.cm_br.count_predicted_batch_hard(
                res["is_transition"].astype(np.uint8),
                relax_edge_binary(res["pred_transition"], es, et, n_ver,
                                  self.tol).astype(np.uint8))
            self.cm_bp.count_predicted_batch_hard(
                relax_edge_binary(res["is_transition"], es, et, n_ver,
                                  self.tol).astype(np.uint8),
                res["pred_transition"].astype(np.uint8))
        self.n_clusters.append(res["n_clusters"])
        if spg_out_path is not None:
            graph_sp = compute_sp_graph(
                batch["xyz"], d_se_max, res["pred_in_component"], labels,
                self.n_classes, device=self.device)
            os.makedirs(os.path.dirname(spg_out_path), exist_ok=True)
            write_spg(spg_out_path, graph_sp, res["pred_components"],
                      res["pred_in_component"])
        return res

    def matrices(self) -> dict:
        """The arrays res.h5 holds, as it holds them (uint64; the mean
        cluster count truncated)."""
        return {k: np.asarray(v).astype(np.uint64) for k, v in {
            "confusion_matrix_classes": self.cm_classes.confusion_matrix,
            "confusion_matrix_BR": self.cm_br.confusion_matrix,
            "confusion_matrix_BP": self.cm_bp.confusion_matrix,
            "n_clusters": float(np.mean(self.n_clusters or [0])),
        }.items()}

    def write_res(self, path: str):
        import h5py

        with h5py.File(path, "w") as f:
            for k, v in self.matrices().items():
                f.create_dataset(k, data=v, dtype="uint64")


def aggregate_matrices(results) -> dict:
    """{n_sp, ASA, BR, BP} of the summed matrices of `results` (dicts as
    FinalEvaluator.matrices gives them)."""
    cm_c = cm_br = cm_bp = None
    n_sp = []
    for r in results:
        c = np.asarray(r["confusion_matrix_classes"], np.float64)
        br = np.asarray(r["confusion_matrix_BR"], np.float64)
        bp = np.asarray(r["confusion_matrix_BP"], np.float64)
        n_sp.append(float(np.asarray(r["n_clusters"])))
        cm_c = c if cm_c is None else cm_c + c
        cm_br = br if cm_br is None else cm_br + br
        cm_bp = bp if cm_bp is None else cm_bp + bp
    return {
        "n_sp": float(np.mean(n_sp)),
        "ASA": 100.0 * np.trace(cm_c) / max(cm_c.sum(), 1),
        "BR": 100.0 * cm_br[1, 1] / max(cm_br[1, :].sum(), 1),
        "BP": 100.0 * cm_bp[1, 1] / max(cm_bp[:, 1].sum(), 1),
    }


def read_res(path: str) -> dict:
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k][()]) for k in (
            "confusion_matrix_classes", "confusion_matrix_BR",
            "confusion_matrix_BP", "n_clusters")}


def aggregate_results(res_files: list[str]) -> dict:
    """Cross-fold aggregation of res.h5 files (evaluate_partition.py:24-86):
    the summed confusion matrices' {n_sp, ASA, BR, BP}."""
    return aggregate_matrices([read_res(p) for p in res_files])


class FolderHierarchy:
    """The output tree (reference folderhierarchy.py:7-51)."""

    MODEL_FILE = "model.ckpt"

    def __init__(self, output_dir: str, dataset_name: str, root_dir: str,
                 cv_fold: int):
        self.outputdir = os.path.join(output_dir,
                                      f"cv{cv_fold}" if cv_fold else "")
        self.root = root_dir
        self.spg_folder = os.path.join(root_dir, "superpoint_graphs")
        self.emb_folder = os.path.join(root_dir, "embeddings")
        self.scalars = os.path.join(root_dir, "scalars")
        for d in (self.outputdir, self.spg_folder, self.emb_folder,
                  self.scalars):
            os.makedirs(d, exist_ok=True)
        self.model_path = os.path.join(self.outputdir, self.MODEL_FILE)
