"""Median seconds a cloud in prune, kNN and geometric features
(`partition_cloud.features`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("partition_cloud.features",))
