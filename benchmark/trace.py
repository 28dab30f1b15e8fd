"""The reduction from a profiler trace and host clocks to numbers.

``Trace`` holds what one profiled step of a run left: the device's
operations (kernels, copies, sets) and the host spans the harness recorded
(``torch.profiler.record_function``), on the profiler's clock in
microseconds, and the window they are read in.  The functions below it are
plain arithmetic on intervals and lists, so the CPU tests can hold them to
synthetic events.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

# the harness's own spans, around each call into a layer of the program,
# are named with this prefix (an entry added later names its own alike)
SPAN_PREFIX = "bench."
WINDOW = "bench.window"


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_us, end_us)
    host: list = field(default_factory=list)     # (name, start_us, end_us)
    w0: float = 0.0
    w1: float = 0.0
    segments: int = 0                            # segments in the window

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def in_window(self):
        return [(n, max(s, self.w0), min(e, self.w1)) for n, s, e in self.device
                if e > self.w0 and s < self.w1]

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(
            [(s, e) for _, s, e in self.in_window()])) * 1e-6

    def launches(self) -> int:
        return len(self.in_window())

    def kernel_times(self, match) -> list:
        """Durations in seconds of the window's device operations whose
        name ``match(name)`` accepts."""
        return [(e - s) * 1e-6 for n, s, e in self.in_window() if match(n)]


def from_profiler(prof, segments: int) -> Trace:
    """The trace of a ``torch.profiler.profile`` run whose profiled step
    the harness wrapped in a ``bench.window`` span."""
    from torch.autograd import DeviceType

    tr = Trace(segments=segments)
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        span = ev.name.startswith(SPAN_PREFIX)
        if ev.device_type == DeviceType.CUDA:
            if not span:                      # not a span's device-side twin
                tr.device.append((ev.name, s, e))
        elif span:
            tr.host.append((ev.name, s, e))
    win = [(s, e) for n, s, e in tr.host if n == WINDOW]
    if not win:
        raise RuntimeError("the profiled step left no bench.window span")
    tr.w0, tr.w1 = win[0]
    return tr


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """The window's idle time (no device operation running) by what the
    host was doing: each gap named by the innermost harness span the host
    was in when it began ("host" outside every span), summed by name,
    longest first: [[name, seconds], ...]."""
    busy = union([(s, e) for _, s, e in tr.in_window()])
    edges = [tr.w0] + [v for iv in busy for v in iv] + [tr.w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    spans = [(n, s, e) for n, s, e in tr.host if n != WINDOW]

    def name(t):
        inside = [(e - s, n) for n, s, e in spans if s <= t < e]
        return min(inside)[1] if inside else "host"

    tot: dict = {}
    for s, e in gaps:
        tot[name(s)] = tot.get(name(s), 0.0) + (e - s) * 1e-6
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def device_ops(tr: Trace, top: int = 10) -> list:
    """The device operations that took most time in the window, summed by
    name: [[name, seconds], ...]."""
    tot: dict = {}
    for n, s, e in tr.in_window():
        tot[n[:200]] = tot.get(n[:200], 0.0) + (e - s) * 1e-6
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def percentile(values, pct: int) -> float:
    """The ``pct``-th percentile of all ``values`` (Python's
    ``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        raise ValueError("a percentile needs two values or more")
    return statistics.quantiles(values, n=100)[pct - 1]


def rate(amount: float, seconds: float) -> float:
    """All the work over all the time."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return amount / seconds
