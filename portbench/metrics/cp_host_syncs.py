"""Median device-to-host reads a cloud in the band cut pursuit
(`ops/cutpursuit_band.LAST_SOLVE_STATS["host_syncs"]`); nothing where the
cloud took another solver."""
from portbench.harness.readers import timed_clouds


def read(rec):
    vals = sorted(c["host_syncs"] for c in timed_clouds(rec)
                  if c.get("host_syncs") is not None)
    return float(vals[len(vals) // 2]) if vals else None
