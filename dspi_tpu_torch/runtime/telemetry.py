"""Load metering and status plumbing — the firmware's telemetry, batched.

A copy of the JAX package's ``runtime/telemetry.py`` for the PyTorch port;
``feed_device`` takes the engine's output tensors wherever they lie.

The firmware reports per-core idle-time EMA loads (usb_audio.c:1300-1316,
pdm_generator.c:399-410): an exponential moving average (1/8 new, 7/8 old,
Q8) of busy/total time per packet.  Here the equivalent "device load" is
wall-clock segment time over audio time — i.e. 1/RTF — smoothed with the
same EMA shape and folded to the same Q8 wire value the host app expects.

``span(name)`` names a phase of a segment for ``torch.profiler``.  The
chain's spans: ``dspi.segment`` and in it ``dspi.unpack``,
``dspi.master``, ``dspi.leveller``, ``dspi.outputs`` (the master peaks;
in it ``dspi.xf``, the crossfeed, ``dspi.mix``, the matrix mix, and
``dspi.out_eq``, the per-output EQ, on every chain and lowering),
``dspi.tail`` and ``dspi.wire``; ``dspi.q15_mul`` in the Q28 chain's Q15
products, the scan lowering's float cascade calls ``dspi.f32_cascade``, a
packet schedule's own work ``dspi.sched``; outside the segment the
multi-tenant bucket gathers ``dspi.bucket_in``/``_out``, the ack fold
``dspi.ack_fold`` and kernel builds ``dspi.kernel_load``.  They appear in
a profile exactly when one records, and cost one flag check otherwise.

While a profiler records, the same spans also keep a record of what each
phase did (``record``): a summary a ``dspi.segment``, of the spans opened
inside it, by name: device seconds between two CUDA events on the
segment's stream (a segment on a card), and the host-to-device copies
made through ``upload``, the segment path's one upload site, with the
host seconds spent in them, against the innermost open span; and the
segment's own host seconds (``time.perf_counter``).  The benchmark's
readers ``uploads_per_seg``, ``upload_wait_pct``, ``mix_ms_per_seg``,
``unpack_ms_per_seg`` and ``wire_ms_per_seg`` read it.  The last ``KEEP``
summaries are kept.  The record is on exactly when the spans are: no
switch of its own, no synchronisation inside a segment and no device
operation; its events are read when ``record`` is called.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN_PREFIX = "dspi."
_NOOP = contextlib.nullcontext()


def _open(name: str):
    """A host event named ``name`` on the profiler's clock, nested under
    the op or span that encloses it: ``torch._C._profiler
    ._RecordFunctionFast``, a private class of torch (present in torch
    2.11 and 2.13).  Its scope is a function's, not a user annotation's
    as ``torch.profiler.record_function``'s is, so the profiler adds no
    device-side twin: device operations stay what the device ran, and
    each still links to its launch through its correlation id.  Looked up
    only while a profiler records, so a torch without it fails a profiled
    run and nothing else."""
    return torch._C._profiler._RecordFunctionFast(name)


SEGMENT = "dspi.segment"
KEEP = 64                       # segment summaries the record keeps


class _Entry:
    """One span name's numbers in one segment's summary: its (entry, exit)
    events and, once read, their device seconds; its uploads and their
    host seconds; and ``dspi.segment``'s host seconds."""

    __slots__ = ("events", "device_s", "uploads", "upload_s", "host_s")

    def __init__(self):
        self.events = []
        self.device_s = self.host_s = None
        self.uploads = 0
        self.upload_s = 0.0


class _Record:
    """The spans' record: the last ``keep`` segment summaries, and the
    spans open in the current segment with its summary so far."""

    def __init__(self, keep: int = KEEP):
        self.summaries: deque = deque(maxlen=keep)
        self.open: list = []            # the open spans, innermost last
        self.cur: dict = {}             # {name: _Entry} of this segment
        self.stream = None              # its CUDA stream, None on the CPU
        self.t0 = 0.0                   # its entry on perf_counter

    def entry(self, name: str) -> _Entry:
        e = self.cur.get(name)
        if e is None:
            e = self.cur[name] = _Entry()
        return e

    def event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev


_REC = _Record()


class _Span:
    """A span while a profiler records: the host event (``_open``) and,
    inside a ``dspi.segment``, its entry in the record."""

    __slots__ = ("name", "device", "_rf", "_on", "_ev")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self._rf = _open(name)

    def __enter__(self):
        self._rf.__enter__()
        rec = _REC
        self._on = bool(rec.open) or self.name == SEGMENT
        if self._on:
            if not rec.open:
                rec.cur = {}
                dev = torch.device(self.device or "cpu")
                rec.stream = (torch.cuda.current_stream(dev)
                              if dev.type == "cuda" else None)
                rec.t0 = time.perf_counter()
            self._ev = rec.event()
            rec.open.append(self)
        return self

    def __exit__(self, *exc):
        if self._on:
            rec = _REC
            ev = rec.event()
            rec.open.pop()
            e = rec.entry(self.name)
            if ev is not None:
                e.events.append((self._ev, ev))
            if not rec.open:
                e.host_s = time.perf_counter() - rec.t0
                rec.summaries.append(rec.cur)
                rec.cur, rec.stream = {}, None
        return self._rf.__exit__(*exc)


def span(name: str, device=None):
    """A context that marks ``name`` on the profiler's clock while a
    ``torch.profiler`` records, and a shared no-op one otherwise.  It
    launches no device work.  ``device``: the device a ``dspi.segment``
    runs on, whose current stream the record's events of the segment's
    spans are recorded on (a CPU segment's have none)."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _Span(name, device)


def upload(values, device, dtype=None) -> torch.Tensor:
    """``values`` (a NumPy array, a list or a CPU tensor) as a tensor of
    ``dtype`` on ``device``: ``torch.as_tensor(values, dtype=dtype)
    .to(device)``, to a card a pageable copy that PyTorch follows with a
    stream sync.  While the record is on, a copy to a card counts against
    the innermost open span: one upload and its host seconds, the sync
    included."""
    src = torch.as_tensor(values, dtype=dtype)
    rec = _REC
    if (not rec.open or torch.device(device).type != "cuda"
            or not torch.autograd._profiler_enabled()):
        return src.to(device)
    t0 = time.perf_counter()
    out = src.to(device)
    dt = time.perf_counter() - t0
    e = rec.entry(rec.open[-1].name)
    e.uploads += 1
    e.upload_s += dt
    return out


def record(k: int) -> list:
    """The record's last ``k`` segment summaries, oldest first (fewer if
    fewer are kept): ``[{span name: {"device_s", "uploads", "upload_s"}},
    ...]`` in plain Python numbers, ``dspi.segment``'s with its
    ``host_s`` too.  ``device_s`` sums the span's device seconds between
    its events (waiting for the last of them), None on the CPU; a span
    nested in one of its own name counts in both."""
    out = []
    for summ in list(_REC.summaries)[-k:] if k > 0 else []:
        row = {}
        for name, e in summ.items():
            if e.events:
                e.events[-1][1].synchronize()
                e.device_s = sum(a.elapsed_time(b) for a, b in e.events) * 1e-3
                e.events = []
            row[name] = {"device_s": e.device_s,
                         "uploads": e.uploads, "upload_s": e.upload_s}
            if e.host_s is not None:
                row[name]["host_s"] = e.host_s
        out.append(row)
    return out


@dataclass
class LoadMeter:
    """EMA load in Q8, mirroring the firmware's smoothing constants."""

    load_q8: int = 0
    primed: bool = False

    def update(self, busy_frac: float) -> int:
        inst_q8 = int(min(max(busy_frac, 0.0), 1.0) * 25600)
        if not self.primed:
            self.primed = True
            self.load_q8 = 0
        # load += -load/8 + inst/8  (usb_audio.c:1310)
        self.load_q8 = self.load_q8 - (self.load_q8 >> 3) + (inst_q8 >> 3)
        return self.percent

    @property
    def percent(self) -> int:
        return (self.load_q8 + 128) >> 8


@dataclass
class EngineTelemetry:
    """Collects timing + engine outputs into the vendor status surface."""

    sample_rate: float = 48000.0
    load = None
    packets_processed: int = 0
    segments: int = 0
    last_rtf: float = 0.0
    _t_last: float = field(default=0.0, repr=False)

    def __post_init__(self):
        self.load = LoadMeter()

    def segment_begin(self):
        self._t_last = time.perf_counter()

    def segment_end(self, n_packets: int, block: int, n_streams: int) -> float:
        wall = time.perf_counter() - self._t_last
        audio = n_packets * block / self.sample_rate
        self.last_rtf = (n_streams * audio / wall) if wall > 0 else 0.0
        # busy fraction per stream-equivalent device = wall / (audio)
        self.load.update(wall / audio if audio > 0 else 0.0)
        self.packets_processed += n_packets
        self.segments += 1
        return self.last_rtf

    def feed_device(self, dev, out, stream: int = 0):
        """Push peaks/clips/loads/counters into a VirtualDSPi."""
        peaks = out["peaks"]
        if hasattr(peaks, "detach"):
            peaks = peaks.detach().cpu().numpy()
        peaks = np.asarray(peaks)
        dev.peaks = [int(v) for v in peaks[:, stream]]
        clip = getattr(dev, "clip_flags", 0)
        dev.clip_flags = clip  # sticky bits live engine-side too
        dev.cpu_loads = (self.load.percent, self.load.percent)
        dev.counters["usb_audio_packets"] = self.packets_processed & 0xFFFFFFFF
