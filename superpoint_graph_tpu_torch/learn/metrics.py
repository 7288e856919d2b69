"""Segmentation and partition-quality metrics, host numpy.

`ConfusionMatrix` is superpoint_graph_tpu/learn/metrics.py:14-60's
(reference metrics.py): soft ground-truth histograms counted against hard
predictions, mIoU over the classes seen, mAcc over all classes.
`compute_OOA` carries the JAX package's (reference metrics.py:102-108),
vectorised; `disconnected_labels` the connectivity audit of
tools/partition_quality.py. The supervised partition's boundary recall and
precision, `mode` and `perfect_prediction` are the JAX package's
(learn/metrics.py:62-106)."""
from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, number_of_labels: int = 2):
        self.number_of_labels = number_of_labels
        self.confusion_matrix = np.zeros(
            (number_of_labels, number_of_labels), dtype=np.float64)

    def count_predicted(self, ground_truth, predicted, n=1):
        self.confusion_matrix[ground_truth, predicted] += n

    def count_predicted_batch(self, ground_truth_vec, predicted):
        """ground_truth_vec [n, C] soft histograms, predicted [n] hard ids."""
        np.add.at(self.confusion_matrix.T, predicted, ground_truth_vec)

    def count_predicted_batch_hard(self, ground_truth_vec, predicted):
        np.add.at(self.confusion_matrix, (ground_truth_vec, predicted), 1)

    def get_count(self, ground_truth, predicted):
        return self.confusion_matrix[ground_truth, predicted]

    def get_confusion_matrix(self):
        return self.confusion_matrix

    def get_intersection_union_per_class(self):
        cm = self.confusion_matrix
        diag = np.diag(cm)
        divisor = cm.sum(0) + cm.sum(1) - diag
        divisor = np.where(diag == 0, 1.0, divisor)
        return (diag / divisor).tolist()

    def get_overall_accuracy(self):
        total = self.confusion_matrix.sum()
        return float(np.trace(self.confusion_matrix)) / max(total, 1.0)

    def get_average_intersection_union(self):
        values = self.get_intersection_union_per_class()
        cm = self.confusion_matrix
        seen = ((cm.sum(1) + cm.sum(0)) != 0).sum()
        return sum(values) / max(seen, 1)

    def get_mean_class_accuracy(self):
        cm = self.confusion_matrix
        per_class = np.diag(cm) / np.maximum(1, cm.sum(1))
        return float(per_class.sum()) / self.number_of_labels

    def count_gt(self, ground_truth):
        return self.confusion_matrix[ground_truth, :].sum()


def compute_OOA(components, labels) -> float:
    """Optimal attainable overall accuracy of a partition, in percent: every
    component takes its majority label (argmax of each row of `labels`
    [n, n_classes]; ties to the lower class)."""
    hard = np.asarray(labels).argmax(1)
    n_cls = np.asarray(labels).shape[1]
    in_comp = np.empty(len(hard), np.int64)
    for i, comp in enumerate(components):
        in_comp[comp] = i
    counts = np.bincount(in_comp * n_cls + hard,
                         minlength=len(components) * n_cls)
    return 100.0 * counts.reshape(-1, n_cls).max(1).sum() / len(hard)


def disconnected_labels(in_comp, src, tgt) -> int:
    """How many more connected components the graph of the edges (src, tgt)
    inside a label has than there are labels: 0 when every label is one
    connected component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    in_comp = np.asarray(in_comp)
    n = len(in_comp)
    m = in_comp[src] == in_comp[tgt]
    g = coo_matrix((np.ones(int(m.sum()), np.int8), (src[m], tgt[m])),
                   shape=(n, n))
    return int(connected_components(g, directed=False)[0]
               - (int(in_comp.max()) + 1))


def compute_predicted_transitions(in_component, edg_source, edg_target):
    """Edges whose ends lie in different components."""
    return in_component[edg_source] != in_component[edg_target]


def compute_boundary_recall(is_transition, pred_transitions):
    """Share of the true transition edges predicted as transitions, in
    percent (reference metrics.py)."""
    return (100.0 * ((is_transition == pred_transitions) * is_transition).sum()
            / is_transition.sum())


def compute_boundary_precision(is_transition, pred_transitions):
    """Share of the predicted transition edges that are true ones, in
    percent."""
    return (100.0
            * ((is_transition == pred_transitions) * pred_transitions).sum()
            / pred_transitions.sum())


def mode(array, only_freq=False):
    """(most frequent value, its count), or the count alone; ties to the
    lowest value."""
    value, counts = np.unique(array, return_counts=True)
    if only_freq:
        return np.amax(counts)
    return value[np.argmax(counts)], np.amax(counts)


def perfect_prediction(components, labels):
    """Majority-label oracle per component spread to its points (reference
    provider.py:689-695): `labels` is the [n, n_classes + 1] histogram whose
    column 0 counts unlabelled points; a component's label is the argmax
    of its summed class columns (0-based class ids)."""
    full_pred = np.zeros(labels.shape[0], dtype=np.int64)
    for comp in components:
        comp = np.asarray(comp, np.int64)
        if len(comp):
            full_pred[comp] = labels[comp, 1:].sum(0).argmax()
    return full_pred
