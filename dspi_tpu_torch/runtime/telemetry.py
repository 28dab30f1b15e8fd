"""Load metering and status plumbing — the firmware's telemetry, batched.

A copy of the JAX package's ``runtime/telemetry.py`` for the PyTorch port;
``feed_device`` takes the engine's output tensors wherever they lie.

The firmware reports per-core idle-time EMA loads (usb_audio.c:1300-1316,
pdm_generator.c:399-410): an exponential moving average (1/8 new, 7/8 old,
Q8) of busy/total time per packet.  Here the equivalent "device load" is
wall-clock segment time over audio time — i.e. 1/RTF — smoothed with the
same EMA shape and folded to the same Q8 wire value the host app expects.

``span(name)`` names a phase of a segment for ``torch.profiler``: the
chain's spans (``dspi.segment`` and its phases, ``dspi.q15_mul``, the
multi-tenant bucket gathers, the ack fold, kernel builds) appear in a
profile exactly when one records, and cost one flag check otherwise.
"""

from __future__ import annotations

import contextlib
import time
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


def span(name: str):
    """A context that marks ``name`` on the profiler's clock while a
    ``torch.profiler`` records, and a shared no-op one otherwise.  It
    launches no device work."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _open(name)


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
