"""The program's own spans (`spgt.*`, superpoint_graph_tpu_torch/utils/
tracing.py) in a profile the benchmark reads: `trace.summarize` never
counts one as device work nor names a gap after one."""
from types import SimpleNamespace

import torch

from portbench.harness import trace


def _evt(name, start, end, device=False, annotation=False):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_program_spans_are_neither_work_nor_gap_names():
    events = [
        _evt("_spg_stage", 0.0, 50.0),
        _evt("spgt.spg", 5.0, 45.0),
        _evt("spgt.spg.components", 10.0, 40.0),
        # the device-side echoes of the program's spans
        _evt("spgt.spg", 5.0, 45.0, device=True, annotation=True),
        _evt("spgt.spg.components", 10.0, 40.0, device=True, annotation=True),
        _evt("kernel_a", 0.0, 5.0, device=True),
        _evt("kernel_b", 45.0, 50.0, device=True),
        _evt("kernel_c", 60.0, 70.0, device=True),
    ]
    prof = SimpleNamespace(events=lambda: events)
    got = trace.summarize(prof, {"_spg_stage"}, 100e-6)
    assert set(got["kernels"]) == {"kernel_a", "kernel_b", "kernel_c"}
    assert abs(got["busy_s"] - 20e-6) < 1e-12
    assert [g[0] for g in got["gaps"]] == ["_spg_stage",
                                           "outside the benchmark's spans"]


def test_a_traced_cpu_profile_holds_no_program_span_as_work():
    from superpoint_graph_tpu_torch.utils import tracing

    tracing.collect()
    tracing.enable()
    try:
        with trace.profiler() as prof:
            with tracing.span("spgt.cloud"):
                with tracing.span("spgt.step"):
                    tracing.to_host(torch.ones(64).cumsum(0), "test")
    finally:
        tracing.disable()
        tracing.collect()
    assert {"spgt.cloud", "spgt.step", "spgt.d2h"} <= {
        e.name for e in prof.events()}
    got = trace.summarize(prof, set(), 1.0)
    assert not [k for k in got["kernels"] if k.startswith("spgt.")]
