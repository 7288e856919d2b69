"""Median seconds a cloud building the superpoint graph (`partition_cloud.spg`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("partition_cloud.spg",))
