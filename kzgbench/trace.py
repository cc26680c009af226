"""The traced run's device timeline and the arithmetic the per-layer
metrics share: busy time as a union of intervals, device time by kernel
name inside the benchmark's spans, idle gaps by what the host was doing.

A `Trace` holds plain tuples (name, start_ns, end_ns) on the profiler's
clock, so a test builds one by hand. `from_profiler` reads a finished
`torch.profiler.profile`: the device operations (kernels, copies, sets),
the benchmark's spans (its `record_function` ranges) and the host
operations of the thread that opened the window. It follows `_profile` of
`kzg_tpu_torch/bench/paths.py` (one profiler session over the calls, the
device events it records), with the events read one by one instead of
summed, so that time can be placed in spans.
"""

import bisect
from dataclasses import dataclass, field

WINDOW = "window"


@dataclass
class Trace:
    device_ops: list                 # (name, start_ns, end_ns) of each device operation
    spans: list                      # (name, start_ns, end_ns) of the benchmark's spans
    host_ops: list = field(default_factory=list)  # (name, start_ns, end_ns), one thread

    def window(self):
        for name, s, e in self.spans:
            if name == WINDOW:
                return s, e
        return None

    def window_s(self) -> float:
        s, e = self.window()
        return (e - s) / 1e9

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]


def from_profiler(prof) -> Trace:
    """The trace of a finished profiler session, read from its raw events
    (name, device, start and end, thread; the few accessors every recent
    torch has). A device-side copy of a span carries the span's name and
    is not a device operation."""
    events = list(prof.profiler.kineto_results.events())
    cpu = [ev for ev in events if ev.device_type().name == "CPU"]
    names = {ev.name() for ev in cpu if ev.is_user_annotation()}
    window_thread = next((ev.start_thread_id() for ev in cpu
                          if ev.is_user_annotation() and ev.name() == WINDOW), None)
    device_ops, spans, host = [], [], []
    for ev in events:
        s = ev.start_ns()
        t = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type().name == "CUDA":
            if not ev.is_user_annotation() and ev.name() not in names:
                device_ops.append(t)
        elif ev.is_user_annotation():
            spans.append(t)
        elif ev.device_type().name == "CPU" and ev.start_thread_id() == window_thread:
            host.append(t)
    device_ops.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(device_ops=device_ops, spans=spans, host_ops=host)


def merge(intervals) -> list:
    """Sorted, disjoint (start, end) covering the given intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_ns(trace: Trace) -> int:
    """Nanoseconds of the window in which some device operation ran."""
    lo, hi = trace.window()
    return sum(e - s for s, e in merge(clip([(s, e) for _, s, e in trace.device_ops], lo, hi)))


def device_ns_in(trace: Trace, key: str, spans) -> int:
    """Device nanoseconds of the operations whose name holds `key`, inside
    the given (start, end) spans (clipped to them)."""
    ops = merge([(s, e) for n, s, e in trace.device_ops if key in n])
    total = 0
    for lo, hi in spans:
        total += sum(e - s for s, e in clip(ops, lo, hi))
    return total


def _short(name: str) -> str:
    """A kernel's name without its return type and its argument list
    (template arguments, which may hold parentheses, stay)."""
    n = name.strip()
    if n.startswith("void "):
        n = n[5:]
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n.strip()[:120]


def top_device_ops(trace: Trace, count: int = 10) -> list:
    """[name, seconds] of the device operations that took most time in the
    window, by name (argument lists dropped)."""
    lo, hi = trace.window()
    by = {}
    for n, s, e in trace.device_ops:
        for cs, ce in clip([(s, e)], lo, hi):
            by[_short(n)] = by.get(_short(n), 0) + (ce - cs)
    return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:count]]


def _innermost(events, starts, t):
    """Name of the innermost event of `events` (sorted by start) that
    contains time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(-1, i - 4096), -1):
        n, s, e = events[j]
        if e >= t:
            best = n
            break
    return best


def idle_gaps(trace: Trace, count: int = 10) -> list:
    """[name, seconds] of the window's idle device time, summed by what the
    host was doing at the middle of each gap: the innermost benchmark span
    and, after a slash, the innermost host operation of that thread."""
    lo, hi = trace.window()
    busy = merge(clip([(s, e) for _, s, e in trace.device_ops], lo, hi))
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted((t for t in trace.spans if t[0] != WINDOW), key=lambda t: t[1])
    span_starts = [t[1] for t in spans]
    host_starts = [t[1] for t in trace.host_ops]
    by = {}
    for s, e in gaps:
        mid = (s + e) // 2
        where = _innermost(spans, span_starts, mid) or "between spans"
        op = _innermost(trace.host_ops, host_starts, mid)
        key = f"{where}/{op}" if op else where
        by[key] = by.get(key, 0) + (e - s)
    return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:count]]
