"""Median seconds a frame in the Delaunay triangulation of the SPG's
superedge support (`delaunay`); nothing where the clouds have no such
stage."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("delaunay",))
