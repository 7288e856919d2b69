"""Reading a torch.profiler trace of the card: busy time, kernel sums,
idle gaps and what the host was doing in them.

The benchmark's spans are `torch.profiler.record_function` ranges that it
opens around the program's stages (`spans`); a gap between kernels is
named after the innermost span that covers its middle.
"""
from __future__ import annotations

import contextlib

import torch


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _is_device(evt, span_names) -> bool:
    """A kernel or a copy on the device; the device-side echo of a
    record_function span (a user annotation) is not work."""
    kind = getattr(evt, "device_type", None)
    return (kind is not None and kind != torch.autograd.DeviceType.CPU
            and not getattr(evt, "is_user_annotation", False)
            and evt.name not in span_names)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, span_names, t_window: float) -> dict:
    """{"busy_s", "window_s", "kernels": {name: seconds}, "gaps":
    [[span, seconds]] longest first} of a finished profile; `t_window` is
    the host-clock length of the profiled region, `span_names` the spans
    the benchmark opened."""
    kernels, spans = [], []
    for evt in prof.events():
        tr = evt.time_range
        if _is_device(evt, span_names):
            kernels.append((tr.start, tr.end, evt.name))
        elif evt.name in span_names:
            spans.append((tr.start, tr.end, evt.name))
    by_name = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = _union([(s, e) for s, e, _ in kernels])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        cover = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        name = (min(cover, key=lambda sp: sp[1] - sp[0])[2] if cover
                else "outside the benchmark's spans")
        gaps.append([name, (s1 - e0) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_s, "window_s": t_window, "kernels": by_name,
            "gaps": gaps, "n_kernels": len(kernels)}


def breakdown(summary: dict) -> dict:
    """The result line's "breakdown": the 10 device operations with most
    time and the 10 longest idle gaps by span."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": summary["gaps"][:10]}


@contextlib.contextmanager
def spans(patches):
    """Within: each (module, attribute) in `patches` runs inside a
    record_function span named after the attribute."""
    saved = []
    for module, name in patches:
        orig = getattr(module, name)

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _orig(*args, **kwargs)

        saved.append((module, name, orig))
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, orig in reversed(saved):
            setattr(module, name, orig)
