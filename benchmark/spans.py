"""The port's own spans in a traced step, beside the harness's.

The port marks the phases of a segment with host events on the
profiler's clock, named ``dspi.*`` (``dspi_tpu_torch.runtime.telemetry
.span``): ``dspi.segment`` and in it ``dspi.unpack``, ``dspi.master``,
``dspi.leveller``, ``dspi.outputs``, ``dspi.tail`` and ``dspi.wire``;
``dspi.q15_mul`` in each ``q15_mul``; ``dspi.bucket_in`` and
``dspi.bucket_out`` around a multi-tenant server's gathers;
``dspi.ack_fold``; ``dspi.kernel_load``.  They have no device-side twin.

``from_profiler`` here takes ``trace.from_profiler``'s trace and makes
one more pass over the profile: it adds the program's host spans, drops
any device-side twin of them, and gives each device operation beside
``Trace.device`` the span that launched it: the innermost span open on
the host around the CUDA runtime call that launched it, which carries
the operation's correlation id (``FunctionEvent.id``).  An operation
launched in no span belongs to "host", one whose launch the trace lacks
to "unlinked".  A trace with no program spans keeps every field of
``trace.from_profiler``'s.

The readings below it are plain arithmetic on that trace: each span's
host self time and the part of it spent waiting for the device, the
device time, launches and uploads it issued, and the idle time named by
it (``span_table``); and four per-layer readings, each None where its
span did not run in the window.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

makes one traced run of a cell through the harness (``harness.run_cell``,
the check included), prints its result line, then extends the trace the
harness read with the program's spans and prints one JSON line: the
readings, the span table, the idle gaps by span, and the launches and
idle share before and after the extension.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field

from . import trace
from .trace import union

PROGRAM_PREFIX = "dspi."
PREFIXES = (trace.SPAN_PREFIX, PROGRAM_PREFIX)
HOST = "host"
UNLINKED = "unlinked"
# the CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel,
# ...): a device operation's id is the id of the call that launched it;
# other host events number their ids apart
RUNTIME = "cu"
UPLOAD = "Memcpy HtoD"
# runtime calls in which the host waits for the device (a copy from
# pageable host memory ends in one)
WAIT = "Synchronize"


@dataclass
class SpanTrace(trace.Trace):
    owner: list = field(default_factory=list)   # a span name a device op
    waits: list = field(default_factory=list)   # (span, start_us, end_us)


def _span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _launcher(ev) -> str:
    """The innermost span (not the window) around a host event."""
    p = ev.cpu_parent
    while p is not None and not (_span(p.name) and p.name != trace.WINDOW):
        p = p.cpu_parent
    return HOST if p is None else p.name


def from_profiler(prof, segments: int) -> SpanTrace:
    """``trace.from_profiler``'s trace of ``prof``, with the program's
    spans in ``host`` and each device operation's launching span in
    ``owner``."""
    return extend(trace.from_profiler(prof, segments), prof)


def extend(base: trace.Trace, prof) -> SpanTrace:
    """``base``, the trace ``trace.from_profiler`` read from ``prof``,
    with what only the program's spans add: their host events, no
    device-side twin of theirs, and the launching span of every device
    operation."""
    from torch.autograd import DeviceType

    tr = SpanTrace(device=[d for d in base.device
                           if not d[0].startswith(PROGRAM_PREFIX)],
                   host=list(base.host), w0=base.w0, w1=base.w1,
                   segments=base.segments)
    launched, ids = {}, []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if not _span(ev.name):            # as ``tr.device``, in order
                ids.append(ev.id)
        elif ev.name.startswith(PROGRAM_PREFIX):
            tr.host.append((ev.name, float(ev.time_range.start),
                            float(ev.time_range.end)))
        elif ev.name.startswith(RUNTIME):
            launched[ev.id] = _launcher(ev)
            if WAIT in ev.name:
                tr.waits.append((launched[ev.id],
                                 float(ev.time_range.start),
                                 float(ev.time_range.end)))
    if len(ids) != len(tr.device):
        raise RuntimeError("the profile's device operations and the base "
                           "trace's differ")
    tr.owner = [launched.get(i, UNLINKED) for i in ids]
    return tr


def owned(tr: SpanTrace) -> list:
    """The window's device operations as ``Trace.in_window`` gives them,
    each with its launching span: [(name, start, end, span), ...]."""
    return [(n, max(s, tr.w0), min(e, tr.w1), o)
            for (n, s, e), o in zip(tr.device, tr.owner)
            if e > tr.w0 and s < tr.w1]


def launches_by_span(tr: SpanTrace) -> dict:
    """{span: device operations in the window it launched}; the counts
    sum to ``tr.launches()``."""
    out: dict = {}
    for *_, o in owned(tr):
        out[o] = out.get(o, 0) + 1
    return out


def _spans_in_window(tr: SpanTrace) -> list:
    return [(n, max(s, tr.w0), min(e, tr.w1)) for n, s, e in tr.host
            if n != trace.WINDOW and e > tr.w0 and s < tr.w1]


def self_s(tr: SpanTrace) -> dict:
    """{span: host self seconds in the window}: each span's duration less
    the part of it that the spans nested in it cover, summed by name;
    "host" is the window outside every span."""
    spans = _spans_in_window(tr)
    out: dict = {}
    for i, (n, s, e) in enumerate(spans):
        inner = union([(s2, e2) for j, (_, s2, e2) in enumerate(spans)
                       if j != i and s <= s2 and e2 <= e])
        out[n] = out.get(n, 0.0) + ((e - s) - sum(b - a for a, b in inner)
                                    ) * 1e-6
    covered = sum(b - a for a, b in union([(s, e) for _, s, e in spans]))
    out[HOST] = (tr.w1 - tr.w0 - covered) * 1e-6
    return out


def span_table(tr: SpanTrace) -> list:
    """[[span, host self ms, of it waiting ms, device ms, launches,
    uploads, idle ms], ...] over the window, by host self time: the host's
    waits for the device in the span itself, the device time, count and
    host-to-device copies of the operations each span launched, the idle
    time (no device operation running) in gaps that began while the host
    was in it."""
    host = self_s(tr)
    wait: dict = {}
    for o, s, e in tr.waits:
        s, e = max(s, tr.w0), min(e, tr.w1)
        wait[o] = wait.get(o, 0.0) + max(e - s, 0.0) * 1e-6
    dev: dict = {}
    up: dict = {}
    for name, s, e, o in owned(tr):
        dev[o] = dev.get(o, 0.0) + (e - s) * 1e-6
        up[o] = up.get(o, 0) + name.startswith(UPLOAD)
    n = launches_by_span(tr)
    idle = dict(trace.idle_gaps(tr, top=len(tr.host) + 1))
    names = sorted(set(host) | set(dev) | set(idle),
                   key=lambda k: -host.get(k, 0.0))
    return [[k, 1e3 * host.get(k, 0.0), 1e3 * wait.get(k, 0.0),
             1e3 * dev.get(k, 0.0), n.get(k, 0), up.get(k, 0),
             1e3 * idle.get(k, 0.0)] for k in names]


def ops_by_span(tr: SpanTrace, match) -> dict:
    """{span: device ms of the window's operations whose name ``match``
    accepts, that the span launched}."""
    out: dict = {}
    for name, s, e, o in owned(tr):
        if match(name):
            out[o] = out.get(o, 0.0) + (e - s) * 1e-3
    return out


def ran(tr: SpanTrace, name: str) -> bool:
    return any(n == name for n, _, _ in _spans_in_window(tr))


def leveller_host_pct(tr: SpanTrace):
    """Host self time of ``dspi.leveller`` over the window, in %: the
    leveller packet loop's dispatch."""
    if not ran(tr, "dspi.leveller"):
        return None
    return 100.0 * self_s(tr)["dspi.leveller"] / tr.window_s


def leveller_launches_per_seg(tr: SpanTrace):
    """Device operations that ``dspi.leveller`` launched, a segment."""
    if not ran(tr, "dspi.leveller") or not tr.segments:
        return None
    return launches_by_span(tr).get("dspi.leveller", 0) / tr.segments


def uploads_per_seg(tr: SpanTrace):
    """Host-to-device copies launched inside the program's spans, a
    segment: values uploaded anew every segment."""
    if not tr.segments or not any(n.startswith(PROGRAM_PREFIX)
                                  for n, _, _ in _spans_in_window(tr)):
        return None
    return sum(1 for n, _, _, o in owned(tr) if n.startswith(UPLOAD)
               and o.startswith(PROGRAM_PREFIX)) / tr.segments


def q15_busy_pct(tr: SpanTrace):
    """The device time of the operations ``dspi.q15_mul`` launched (their
    union) over the window's device busy time, in %."""
    busy = tr.busy_s()
    if not ran(tr, "dspi.q15_mul") or busy <= 0:
        return None
    mine = union([(s, e) for _, s, e, o in owned(tr) if o == "dspi.q15_mul"])
    return 100.0 * sum(e - s for s, e in mine) * 1e-6 / busy


READINGS = {"leveller_host_pct": leveller_host_pct,
            "leveller_launches_per_seg": leveller_launches_per_seg,
            "uploads_per_seg": uploads_per_seg,
            "q15_busy_pct": q15_busy_pct}


def traced_cell(cell: str, seed: int, seconds: float, device, **kw):
    """One traced run of ``cell`` through ``harness.run_cell`` (its
    keywords as there): (the result line's object, the profiled step as
    ``trace.from_profiler`` read it for the harness, the same step with
    the program's spans, ``extend``-ed from it)."""
    from . import harness

    reduce, got = trace.from_profiler, []

    def keep(prof, segments):
        got.append(reduce(prof, segments))
        got.append(extend(got[0], prof))
        return got[0]

    trace.from_profiler = keep
    try:
        res = harness.run_cell(cell, seed, seconds, True, time.perf_counter(),
                               device, **kw)
    finally:
        trace.from_profiler = reduce
    return res, got[0], got[1]


def summary(old: trace.Trace, tr: SpanTrace) -> dict:
    """What one traced step reads: ``old`` as the harness read it,
    ``tr`` with the program's spans added."""
    def idle_pct(t):
        return 100.0 * (1.0 - t.busy_s() / t.window_s)

    return {"segments": tr.segments, "window_s": tr.window_s,
            "readings": {k: f(tr) for k, f in READINGS.items()},
            "launches": [old.launches(), tr.launches(),
                         sum(launches_by_span(tr).values())],
            "unlinked": launches_by_span(tr).get(UNLINKED, 0),
            "idle_pct": [idle_pct(old), idle_pct(tr)],
            "idle_gaps": trace.idle_gaps(tr, top=12),
            "old_idle_gaps": trace.idle_gaps(old, top=4),
            "table": span_table(tr),
            # device ms by span of torch's copy kernels and of its int64
            # ("long") kernels
            "copy_ms": ops_by_span(tr, lambda n: "direct_copy" in n),
            "int64_ms": ops_by_span(tr, lambda n: "long" in n)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no result", file=sys.stderr)
        return 3
    res, old, tr = traced_cell(args.workload, args.seed, args.seconds,
                               "cuda:0")
    print(json.dumps(res), flush=True)
    print(json.dumps({"cell": args.workload, "seed": args.seed,
                      **summary(old, tr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
