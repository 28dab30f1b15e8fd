"""The reduction that keeps the program's spans (``benchmark.spans``) on
synthetic profiler events: a trace with the harness's spans only reads as
``trace.from_profiler`` reads it; the program's spans add no device
operation; every operation of the window is attributed once; each reading
holds its hand-computed value, and None where its span did not run.  Then
a traced run of each cell on the CPU through the harness."""

from __future__ import annotations

import math
from dataclasses import dataclass

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans, trace
from benchmark.tests import cpu_run


@dataclass
class _Range:
    start: float
    end: float


class _Ev:
    """What the reductions read of a ``FunctionEvent``."""

    def __init__(self, name, s, e, dev=DeviceType.CPU, id=0, parent=None):
        self.name, self.time_range = name, _Range(s, e)
        self.device_type, self.id, self.cpu_parent = dev, id, parent


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _launch(evs, parent, runtime, rid, t, op, s, e):
    """A runtime call at host time ``t`` inside ``parent`` (under an aten
    op) and the device operation it launched, [s, e) on the device."""
    aten = _Ev("aten::op", t - 0.5, t + 1.5, id=rid % 7, parent=parent)
    evs += [aten, _Ev(runtime, t, t + 0.5, id=rid, parent=aten),
            _Ev(op, s, e, DeviceType.CUDA, id=rid)]
    if op.startswith("Memcpy HtoD"):      # a pageable copy waits after it
        evs.append(_Ev("cudaStreamSynchronize", t + 0.5, t + 1.25,
                       id=rid + 500, parent=aten))


def _events(program: bool):
    """One traced step, microseconds: the harness's spans (each with its
    device-side twin); with ``program``, the port's spans inside
    ``bench.segment_fn`` (and device-side twins of them, which a span of
    another scope would have)."""
    win = _Ev("bench.window", 0.0, 100.0, id=1)
    seg = _Ev("bench.segment_fn", 0.5, 60.0, id=2, parent=win)
    ack = _Ev("bench.ack_readback", 60.0, 100.0, id=3, parent=win)
    evs = [win, seg, ack,
           _Ev("bench.window", 5.0, 96.0, DeviceType.CUDA, id=1),
           _Ev("bench.segment_fn", 5.0, 48.0, DeviceType.CUDA, id=2)]
    lev = q15 = seg
    if program:
        root = _Ev("dspi.segment", 1.0, 58.0, id=4, parent=seg)
        lev = _Ev("dspi.leveller", 2.0, 22.0, id=5, parent=root)
        out = _Ev("dspi.outputs", 24.0, 50.0, id=6, parent=root)
        q15 = _Ev("dspi.q15_mul", 30.0, 36.0, id=8, parent=out)
        evs += [root, lev, out, q15,
                _Ev("dspi.leveller", 5.0, 24.0, DeviceType.CUDA, id=5),
                _Ev("dspi.segment", 5.0, 48.0, DeviceType.CUDA, id=4)]
    _launch(evs, lev, "cudaLaunchKernel", 101, 3.0, "k_add", 5.0, 15.0)
    _launch(evs, lev, "cudaMemcpyAsync", 102, 4.0,
            "Memcpy HtoD (Pageable -> Device)", 15.0, 16.0)
    _launch(evs, lev, "cudaLaunchKernel", 103, 6.0, "k_mul", 20.0, 24.0)
    _launch(evs, q15, "cudaLaunchKernel", 104, 31.0, "k_i64", 32.0, 40.0)
    _launch(evs, q15, "cudaLaunchKernel", 105, 33.0, "k_i64", 40.0, 44.0)
    _launch(evs, seg, "cudaLaunchKernel", 106, 52.0, "pdm_kernel", 44.0,
            48.0)
    _launch(evs, ack, "cudaMemcpyAsync", 107, 70.0, "Memcpy DtoH", 90.0,
            110.0)
    # launched before the window, running into it; and one whose launch
    # the trace lost
    _launch(evs, None, "cudaLaunchKernel", 108, -8.0, "k_a", -5.0, 2.0)
    evs.append(_Ev("k_lost", 50.0, 52.0, DeviceType.CUDA, id=999))
    # the CPU numbers its ops' ids apart: an op may share a device op's id
    evs.append(_Ev("aten::other", 80.0, 81.0, id=104, parent=ack))
    return evs


def _both(program: bool):
    prof = _Prof(_events(program))
    return trace.from_profiler(prof, 2), spans.from_profiler(prof, 2)


def _layer(tr):
    run = harness.Run("c", {}, {}, {"samples": 6144, "lanes": 16384,
                                    "packets": 128})
    run.trace = tr
    return {m: harness.metric_reader(m).read(run)
            for m in ("idle_pct", "launches_per_seg", "pdm_roofline_pct")}


def test_a_trace_without_program_spans_reads_as_before():
    old, new = _both(program=False)
    assert new.device == old.device and new.host == old.host
    assert (new.w0, new.w1, new.segments) == (old.w0, old.w1, old.segments)
    assert _layer(new) == _layer(old)
    assert trace.device_ops(new) == trace.device_ops(old)
    assert trace.idle_gaps(new) == trace.idle_gaps(old)


def test_program_spans_add_no_device_operation():
    _, parent = _both(program=False)
    old, new = _both(program=True)
    assert new.device == parent.device
    assert _layer(new) == _layer(parent)
    assert new.launches() == 9 and _layer(new)["launches_per_seg"] == 4.5
    # the accepted reduction counts a twin as an operation; this one not
    assert old.launches() == 11
    # idle gaps are named by the innermost span, program or harness:
    # [2, 5] [16, 20] | [24, 32] [48, 50] | [52, 90]
    assert dict(trace.idle_gaps(parent)) == {
        "bench.segment_fn": pytest.approx(55e-6)}
    assert dict(trace.idle_gaps(new)) == {
        "dspi.leveller": pytest.approx(7e-6),
        "dspi.outputs": pytest.approx(10e-6),
        "dspi.segment": pytest.approx(38e-6)}


def test_every_operation_of_the_window_is_attributed_once():
    _, tr = _both(program=True)
    by = spans.launches_by_span(tr)
    assert sum(by.values()) == tr.launches()
    assert by == {"dspi.leveller": 3, "dspi.q15_mul": 2,
                  "bench.segment_fn": 1, "bench.ack_readback": 1,
                  spans.HOST: 1, spans.UNLINKED: 1}


def test_readings_hold_their_hand_computed_values():
    _, tr = _both(program=True)
    self_s = spans.self_s(tr)
    assert self_s["dspi.leveller"] == pytest.approx(20e-6)
    assert self_s["dspi.outputs"] == pytest.approx(20e-6)
    assert self_s["dspi.segment"] == pytest.approx(11e-6)
    assert self_s["bench.segment_fn"] == pytest.approx(2.5e-6)
    assert self_s[spans.HOST] == pytest.approx(0.5e-6)
    assert spans.leveller_host_pct(tr) == pytest.approx(20.0)
    assert spans.leveller_launches_per_seg(tr) == 1.5
    assert spans.uploads_per_seg(tr) == 0.5
    # q15_mul's operations cover [32, 44] of the busy [0, 2] + [5, 16]
    # + [20, 24] + [32, 48] + [50, 52] + [90, 100]
    assert spans.q15_busy_pct(tr) == pytest.approx(100 * 12 / 45)
    table = {r[0]: r[1:] for r in spans.span_table(tr)}
    assert table["dspi.leveller"] == pytest.approx([20e-3, 0.75e-3, 15e-3,
                                                    3, 1, 7e-3])
    assert table["dspi.q15_mul"] == pytest.approx([6e-3, 0.0, 12e-3, 2, 0,
                                                   0.0])
    assert spans.ops_by_span(tr, lambda n: n.startswith("k_")) == {
        "dspi.leveller": pytest.approx(14e-3),
        "dspi.q15_mul": pytest.approx(12e-3), spans.HOST: pytest.approx(2e-3),
        spans.UNLINKED: pytest.approx(2e-3)}


def test_readings_are_none_where_their_span_did_not_run():
    _, tr = _both(program=False)
    for read in spans.READINGS.values():
        assert read(tr) is None


def test_the_program_prefix_is_the_ports():
    from dspi_tpu_torch.runtime import telemetry

    assert spans.PROGRAM_PREFIX == telemetry.SPAN_PREFIX
    assert trace.SPAN_PREFIX in spans.PREFIXES


@pytest.mark.parametrize("cell", ["rp2350_render", "rp2040_render",
                                  "rp2040_tenants8"])
def test_traced_cell_on_the_cpu(cell):
    res, old, tr = spans.traced_cell(cell, 2**31 + 91, 0.2, "cpu",
                                     traffic=dict(cpu_run.TINY), workers=1,
                                     log=lambda s: None)
    assert res["correct"], res["checked"]
    got = spans.summary(old, tr)
    # the CPU runs no device operation: the readings that count them
    # read 0, and q15_mul's share of device time has none to read
    r = got["readings"]
    assert math.isfinite(r["leveller_host_pct"]) and r["leveller_host_pct"] > 0
    assert r["leveller_launches_per_seg"] == 0 and r["uploads_per_seg"] == 0
    assert r["q15_busy_pct"] is None
    names = {row[0] for row in got["table"]}
    assert {"dspi.segment", "dspi.leveller", "dspi.wire",
            "dspi.ack_fold"} <= names
    assert ("dspi.q15_mul" in names) == cell.startswith("rp2040")
    assert ("dspi.bucket_in" in names) == cell.endswith("tenants8")
    assert got["launches"] == [0, 0, 0]
