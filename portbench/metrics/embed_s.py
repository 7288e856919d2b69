"""Median seconds a frame in the learned partition's embedder (`ssp_embed`:
the local clouds, the LocalEmbedder and the edge distances); nothing where
the clouds have no such stage."""
from portbench.harness.readers import stage_median


def read(rec):
    return stage_median(rec, ("ssp_embed",))
