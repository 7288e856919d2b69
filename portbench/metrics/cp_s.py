"""Median seconds a cloud in the cut pursuit (`partition_cloud.partition`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("partition_cloud.partition",))
