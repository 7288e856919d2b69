"""Median seconds a cloud in the model's forward pass (`model`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("model",))
