"""Stage timing and device profiling.

Port of superpoint_graph_tpu/utils/tracing.py: `StageTimer`, a nestable
wall-clock bucket timer whose report feeds logs and JSON lines; `trace`,
which records a torch.profiler trace (host and device) as a Chrome trace
under $SPGT_TRACE_DIR/<name> when that variable is set and does nothing
otherwise; `annotate`, a named range in that trace
(`torch.profiler.record_function`, the counterpart of
jax.profiler.TraceAnnotation). The host clock measures what a stage
enqueues on the card unless the stage ends in a synchronisation.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulating wall-clock buckets (the partition CLI's three-bucket
    timing, reference partition.py:48,189, generalised)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_s": round(v / max(self.counts[k], 1), 4)}
            for k, v in sorted(self.totals.items())
        }

    def __str__(self):
        return json.dumps(self.report())


@contextlib.contextmanager
def trace(name: str = "spgt"):
    """Record a torch.profiler trace of the block (CPU, and CUDA when a card
    is visible) into $SPGT_TRACE_DIR/<name>/trace.json when that variable is
    set; nothing otherwise."""
    trace_dir = os.environ.get("SPGT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def annotate(name: str):
    """A named range in the profiler's timeline
    (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)
