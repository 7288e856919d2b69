"""Median seconds a cloud spreading the classes to the raw points
(`interpolate_labels` or `interpolate_labels_batch`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("interpolate_labels", "interpolate_labels_batch"))
