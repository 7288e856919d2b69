"""Median seconds a cloud in the reader (the program's stage
`read_s3dis` or `read_semantic3d`)."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("read_s3dis", "read_semantic3d"))
