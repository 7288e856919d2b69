"""The port's one tracer: spans, timed stages, counters and counted
device-to-host reads.

- `span(name, **attrs)`: a named step. Off (the default) it costs one
  module-level boolean check and returns the shared no-op `NULL`. On
  (`enable()`), it records the step in memory (id, parent, the root span's
  id, name, `perf_counter_ns` start and end, attrs) and enters
  `torch.profiler.record_function(name)`, so that a running profiler holds
  the step on its own clock, beside the kernels (`name_idle`). Parents come
  from a thread-local stack; `within(span)` carries a span into another
  thread. Children that run side by side in two threads all count: the
  parent's self time is its seconds less all its children's, and reads
  below zero by the overlap.
- `stage(name, times, key, device)`: a step that is always timed. Its
  seconds are added to `times[key]`, after a synchronisation with `device`
  when that is a CUDA device; on, it is also a span. `self_s`, once it has
  ended, is its seconds less those of the stages run inside it.
- `count(name, n)`: adds to a counter of the current root span.
- `to_host(tensor, site)`: `tensor.cpu()`, the one way the serving paths
  read the device back. On, it counts `d2h.reads` and `d2h.bytes` and
  records a `spgt.d2h` span (attrs `site`, `bytes`): the time the host
  waited on the card plus the copy.
- `collect()`: the finished root spans (a cloud each on the serving
  paths), cleared; `summary(root)`: per span name its total seconds, self
  seconds and count, and the counters.

Every program span is named `spgt.<...>`. A span is never opened in a loop
that runs more than about a hundred times a cloud: such loops are counted.
At most MAX_SPANS spans are held until collected; the rest are counted in
their root's `dropped`.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time

import torch

MAX_SPANS = 200_000

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_done: list = []   # finished roots, until collected
_held = 0          # span records held in _done and in open roots


class _Null:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def close(self):
        pass


NULL = _Null()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def _stack() -> list:
    st = getattr(_local, "spans", None)
    if st is None:
        st = _local.spans = []
    return st


class Span:
    """One recorded span; a root span (no parent) also holds its
    descendants' records and its counters."""

    __slots__ = ("id", "parent", "root", "name", "attrs", "start_ns",
                 "end_ns", "child_ns", "records", "counters", "dropped",
                 "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        st = _stack()
        self.parent = st[-1] if st else None
        self.root = self.parent.root if self.parent is not None else self
        self.child_ns = 0
        if self.root is self:
            self.records, self.counters, self.dropped = [], {}, 0
        self._rf = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def open(self):
        """Start the span without making it the thread's current one
        (`within` makes it so); `close` ends it."""
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self):
        global _held
        self.end_ns = time.perf_counter_ns()
        self._rf.__exit__(None, None, None)
        dur = self.end_ns - self.start_ns
        rec = {"id": self.id, "parent": getattr(self.parent, "id", None),
               "cloud": self.root.id, "name": self.name,
               "start_ns": self.start_ns, "end_ns": self.end_ns,
               "self_ns": dur - self.child_ns, "attrs": self.attrs}
        with _lock:
            if self.parent is not None:
                self.parent.child_ns += dur
            if _held < MAX_SPANS or self.root is self:
                _held += 1
                self.root.records.append(rec)
            else:
                self.root.dropped += 1
            if self.root is self:
                _done.append(self)

    def __enter__(self):
        self.open()
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.close()
        return False


def span(name: str, **attrs):
    """A span around the block (see the module docstring)."""
    if not _on:
        return NULL
    return Span(name, attrs)


def detached(name: str, **attrs):
    """A span opened now but made current by no thread: `within(s)` runs a
    block under it, in any thread, and `s.close()` ends it."""
    if not _on:
        return NULL
    return Span(name, attrs).open()


class within:
    """Within: `parent` (an open span, or NULL) is the current span of
    this thread, so the spans opened here are its children."""

    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        if self.parent is not NULL:
            _stack().append(self.parent)
        return self.parent

    def __exit__(self, *exc):
        if self.parent is not NULL:
            _stack().pop()
        return False


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` of the current root span."""
    if not _on:
        return
    st = _stack()
    if st:
        root = st[-1].root
        with _lock:
            root.counters[name] = root.counters.get(name, 0) + n


def to_host(tensor: torch.Tensor, site: str) -> torch.Tensor:
    """`tensor.cpu()`: a blocking read of the device; counted and timed
    as `spgt.d2h` (attr `site`) when tracing is on."""
    if not _on:
        return tensor.cpu()
    with Span("spgt.d2h", {"site": site}) as sp:
        out = tensor.cpu()
        sp.attrs["bytes"] = n = out.numel() * out.element_size()
    count("d2h.reads")
    count("d2h.bytes", n)
    return out


def _stages() -> list:
    st = getattr(_local, "stages", None)
    if st is None:
        st = _local.stages = []
    return st


class stage:
    """A step timed whether tracing is on or off: its seconds are added to
    `times[key]` (no entry with `times` None), measured after a
    synchronisation with `device` when that is a CUDA device; on, it is
    also the span `name` (none when `name` is None). After the block:
    `seconds`, and `self_s` (less the stages run inside it in this
    thread)."""

    __slots__ = ("name", "times", "key", "device", "parent", "child_s",
                 "seconds", "self_s", "_span", "_t0")

    def __init__(self, name: str, times: dict | None = None,
                 key: str | None = None, device=None):
        self.name, self.times, self.key = name, times, key
        self.device = device

    def __enter__(self):
        st = _stages()
        self.parent = st[-1] if st else None
        st.append(self)
        self.child_s = 0.0
        self._span = span(self.name) if self.name else NULL
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        _stages().pop()
        self.self_s = self.seconds - self.child_s
        if self.parent is not None:
            self.parent.child_s += self.seconds
        if self.times is not None:
            self.times[self.key] = self.times.get(self.key, 0.0) + self.seconds
        return False


def collect() -> list:
    """The finished root spans since the last call, cleared: each a dict
    of its own record, `spans` (its records and its descendants'),
    `counters` and `dropped`."""
    global _held
    with _lock:
        roots, _done[:] = list(_done), []
        out = []
        for r in roots:
            _held -= len(r.records)
            own = next(s for s in r.records if s["id"] == r.id)
            out.append(dict(own, spans=r.records, counters=dict(r.counters),
                            dropped=r.dropped))
    return out


def summary(root: dict) -> dict:
    """{"spans": {name: {"seconds", "self_s", "count"}}, "counters",
    "dropped"} of one root from `collect`."""
    spans = {}
    for s in root["spans"]:
        e = spans.setdefault(s["name"], {"seconds": 0.0, "self_s": 0.0,
                                         "count": 0})
        e["seconds"] += (s["end_ns"] - s["start_ns"]) * 1e-9
        e["self_s"] += s["self_ns"] * 1e-9
        e["count"] += 1
    return {"spans": spans, "counters": dict(root["counters"]),
            "dropped": root["dropped"]}


def _is_kernel(evt) -> bool:
    """A kernel or a copy on the device (not a span's device-side echo)."""
    kind = getattr(evt, "device_type", None)
    return (kind is not None and kind != torch.autograd.DeviceType.CPU
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith("spgt."))


def name_idle(events, root: str = "spgt.cloud", program=None) -> dict:
    """The card's idle time inside the profiled `root` span, named by the
    program: `events` a finished torch.profiler's `events()`. The idle
    stretches are those before the first kernel, between kernels and
    after the last, clipped to the root. Each instant of them belongs to
    the innermost `spgt.` span covering it, and is not named where that is
    the root. Returns {"idle_s", "named_s" (idle inside a span below the
    root), "by_span": {name: idle seconds}, "gaps": [[name, seconds]] each
    stretch named after the innermost span at its middle, longest
    first}.

    The profiler holds the spans of the thread that started it only.
    `program`, the same root as `collect()` gives it, names the idle time
    by the tracer's records instead, those of every thread (a frame's
    stages run on a worker), put on the profiler's clock by the root's
    start; where spans of two threads cover an instant, the shorter
    names it."""
    kernels, spans = [], []
    for evt in events:
        tr = evt.time_range
        if _is_kernel(evt):
            kernels.append((tr.start, tr.end))
        elif evt.name.startswith("spgt."):
            spans.append((tr.start, tr.end, evt.name))
    starts = [s for s, _, name in spans if name == root]
    if program is not None and starts:
        off = min(starts) - program["start_ns"] * 1e-3
        spans = [(r["start_ns"] * 1e-3 + off, r["end_ns"] * 1e-3 + off,
                  r["name"]) for r in program["spans"]]
    roots = [s for s in spans if s[2] == root]
    if not roots:
        return {"idle_s": 0.0, "named_s": 0.0, "by_span": {}, "gaps": []}
    t0 = min(s for s, _, _ in roots)
    t1 = max(e for _, e, _ in roots)
    busy = []
    for s, e in sorted(kernels):
        s, e = max(s, t0), min(e, t1)
        if s >= e:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # the innermost span of each piece between two span boundaries
    cuts = sorted({t0, t1} | {min(max(x, t0), t1)
                              for s, e, _ in spans for x in (s, e)})
    owner = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        cover = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        name = min(cover, key=lambda sp: sp[1] - sp[0])[2] if cover else root
        owner.append(None if name == root else name)
    by_span, gaps = {}, []
    i = 0
    for a, b in idle:
        mid = 0.5 * (a + b)
        gaps.append([owner[bisect.bisect_right(cuts, mid) - 1]
                     or "not named", (b - a) * 1e-6])
        while cuts[i + 1] <= a:
            i += 1
        j = i
        while j < len(owner) and cuts[j] < b:
            part = min(b, cuts[j + 1]) - max(a, cuts[j])
            if part > 0:
                key = owner[j] or "not named"
                by_span[key] = by_span.get(key, 0.0) + part * 1e-6
            j += 1
    gaps.sort(key=lambda g: -g[1])
    idle_s = sum((b - a) for a, b in idle) * 1e-6
    return {"idle_s": idle_s,
            "named_s": idle_s - by_span.get("not named", 0.0),
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "gaps": gaps}
