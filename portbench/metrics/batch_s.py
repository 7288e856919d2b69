"""Median seconds a cloud building the model's batch (`superpoint_batch`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("superpoint_batch",))
