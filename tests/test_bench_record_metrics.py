"""The benchmark's five readers of the program's span record
(``benchmark/metrics/{uploads_per_seg, upload_wait_pct, mix_ms_per_seg,
unpack_ms_per_seg, wire_ms_per_seg}.py``): on a synthetic record each
reads its hand-computed value, and each reads None without a traced
step, with fewer summaries than the step's segments, or from a program
that keeps no record."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from dspi_tpu_torch.runtime import telemetry

READERS = ("uploads_per_seg", "upload_wait_pct", "mix_ms_per_seg",
           "unpack_ms_per_seg", "wire_ms_per_seg")


def _e(device_s=None, uploads=0, upload_s=0.0):
    return {"device_s": device_s, "uploads": uploads, "upload_s": upload_s}


def _seg(host_s, *a):
    return {**_e(*a), "host_s": host_s}


# three segments kept; a traced step of the last two
SUMMARIES = [
    {"dspi.segment": _seg(9.0, 9.0), "dspi.mix": _e(9.0, 9, 9.0)},
    {"dspi.segment": _seg(0.050, 0.040, 1, 0.001),
     "dspi.unpack": _e(0.0015),
     "dspi.master": _e(0.008, 8, 0.006),
     "dspi.mix": _e(0.004),
     "dspi.out_eq": _e(0.010, 8, 0.009),
     "dspi.wire": _e(0.016)},
    {"dspi.segment": _seg(0.030, 0.040, 1, 0.001),
     "dspi.unpack": _e(0.0025),
     "dspi.master": _e(0.008, 8, 0.004),
     "dspi.mix": _e(0.006),
     "dspi.out_eq": _e(0.010, 8, 0.003),
     "dspi.wire": _e(0.018)},
]
# by hand over the last two: uploads (17 + 17) / 2; waits 0.016 + 0.008
# of 0.080 host s; device ms (4 + 6) / 2, (1.5 + 2.5) / 2, (16 + 18) / 2
WANT = {"uploads_per_seg": 17.0, "upload_wait_pct": 30.0,
        "mix_ms_per_seg": 5.0, "unpack_ms_per_seg": 2.0,
        "wire_ms_per_seg": 17.0}


def _run(segments=2):
    return SimpleNamespace(trace=SimpleNamespace(segments=segments))


def _read(name, run):
    return importlib.import_module(f"benchmark.metrics.{name}").read(run)


@pytest.fixture
def record(monkeypatch):
    kept = list(SUMMARIES)
    monkeypatch.setattr(telemetry, "record",
                        lambda k: kept[-k:] if k > 0 else [])
    return kept


@pytest.mark.parametrize("name", READERS)
def test_reads_the_hand_computed_value(record, name):
    assert _read(name, _run()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_without_a_trace_or_enough_summaries(record, name):
    assert _read(name, SimpleNamespace(trace=None)) is None
    assert _read(name, _run(0)) is None
    assert _read(name, _run(4)) is None
    del record[:2]
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", READERS)
def test_reads_nothing_from_a_program_without_the_record(monkeypatch, name):
    monkeypatch.delattr(telemetry, "record")
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", ["mix_ms_per_seg", "unpack_ms_per_seg",
                                  "wire_ms_per_seg"])
def test_a_span_with_no_device_time_reads_nothing(record, name):
    """A segment on the CPU (no device seconds), or one that did not open
    the span, gives no device ms."""
    span = "dspi." + name.split("_")[0]
    record[-1] = {**record[-1], span: {**record[-1][span], "device_s": None}}
    assert _read(name, _run()) is None
    record[-1] = {k: v for k, v in record[-1].items() if k != span}
    assert _read(name, _run()) is None
