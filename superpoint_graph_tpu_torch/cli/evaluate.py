"""Cross-fold aggregation of pointwise confusion matrices.

Port of superpoint_graph_tpu/cli/evaluate.py (reference
learning/evaluate.py:20-59): sums <odir>/cv<fold>/pointwise_cm.npy over the
folds and prints each fold's and the overall OA / mAcc / mIoU and the
per-class IoU (s3dis, vkitti). Host numpy only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.datasets import S3DIS_INV_CLASS_MAP, VKITTI_INV_CLASS_MAP
from ..learn.metrics import ConfusionMatrix


def _summary(cm: ConfusionMatrix) -> str:
    return (f"OA {100 * cm.get_overall_accuracy():.2f} "
            f"mAcc {100 * cm.get_mean_class_accuracy():.2f} "
            f"mIoU {100 * cm.get_average_intersection_union():.2f}")


def main(argv=None) -> ConfusionMatrix:
    """Print the summary; returns the summed ConfusionMatrix."""
    p = argparse.ArgumentParser(description="cross-fold result aggregation")
    p.add_argument("--odir", default="results/s3dis",
                   help="directory containing cv1..cv6 fold results")
    p.add_argument("--dataset", default="s3dis")
    p.add_argument("--cvfold", default="123456")
    args = p.parse_args(argv)

    inv_map = (VKITTI_INV_CLASS_MAP if args.dataset == "vkitti"
               else S3DIS_INV_CLASS_MAP)
    n_classes = len(inv_map)
    total = ConfusionMatrix(n_classes)
    for fold in args.cvfold:
        path = os.path.join(args.odir, f"cv{fold}", "pointwise_cm.npy")
        if not os.path.isfile(path):
            print(f"fold {fold}: missing {path}")
            continue
        cm = ConfusionMatrix(n_classes)
        cm.confusion_matrix = np.load(path)
        print(f"fold {fold}: {_summary(cm)}")
        total.confusion_matrix += cm.confusion_matrix
    print(f"overall: {_summary(total)}")
    for i, iou in enumerate(total.get_intersection_union_per_class()):
        print(f"  {inv_map[i]:>14}: {100 * iou:.2f}")
    return total


if __name__ == "__main__":
    main()
