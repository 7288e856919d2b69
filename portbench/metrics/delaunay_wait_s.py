"""Median seconds a frame waiting at the SPG for the Delaunay
triangulation made beside its other stages (`delaunay_wait`): the part
of `delaunay_s` those stages did not hide; nothing where the clouds have
no such stage."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("delaunay_wait",))
