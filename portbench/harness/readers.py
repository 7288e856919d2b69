"""What several metric readers share."""
from __future__ import annotations

import numpy as np


def timed_clouds(rec) -> list:
    """The window's clouds, without the profiled one where others exist."""
    clouds = rec.get("clouds", [])
    if rec.get("trace") is not None and len(clouds) > 1:
        return clouds[1:]
    return clouds


def stage_median(rec, keys) -> float | None:
    """Median over the clouds of the first of `keys` in each cloud's
    stage seconds."""
    vals = []
    for c in timed_clouds(rec):
        for k in keys:
            if k in c["times"]:
                vals.append(c["times"][k])
                break
    return float(np.median(vals)) if vals else None
