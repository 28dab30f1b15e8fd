"""The reduction arithmetic on synthetic events: union and busy time,
idle gaps named by the host span, device-op totals, percentiles, rates,
and the metric readers on a synthetic run."""

from __future__ import annotations

import statistics

import pytest

from benchmark import harness, trace


def _trace():
    tr = trace.Trace(w0=0.0, w1=100.0, segments=2)
    tr.device = [("k_a", 10.0, 20.0), ("k_b", 15.0, 30.0),
                 ("pdm_kernel", 50.0, 60.0), ("Memcpy DtoH", 95.0, 110.0),
                 ("k_a", -5.0, 2.0)]
    tr.host = [("bench.window", 0.0, 100.0), ("bench.segment_fn", 0.0, 45.0),
               ("bench.ack_readback", 60.0, 100.0),
               ("bench.lane_snapshot", 30.0, 40.0)]
    return tr


def test_union_busy_and_launches():
    assert trace.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    tr = _trace()
    # [0,2] + [10,30] + [50,60] + [95,100] inside the window
    assert tr.busy_s() == pytest.approx(37e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.launches() == 5


def test_idle_time_is_summed_by_the_innermost_span():
    gaps = trace.idle_gaps(_trace())
    assert [g[0] for g in gaps] == ["bench.ack_readback",
                                    "bench.lane_snapshot", "bench.segment_fn"]
    assert [g[1] for g in gaps] == pytest.approx([35e-6, 20e-6, 8e-6])
    tr = _trace()
    tr.device.append(("k_c", 40.0, 41.0))
    gaps = dict(trace.idle_gaps(tr))
    assert gaps["bench.segment_fn"] == pytest.approx(17e-6)
    assert gaps["bench.lane_snapshot"] == pytest.approx(10e-6)


def test_device_ops_sum_by_name():
    ops = dict(trace.device_ops(_trace()))
    assert ops["k_a"] == pytest.approx(12e-6)
    assert ops["k_b"] == pytest.approx(15e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(5e-6)


def test_percentile_and_rate():
    v = list(range(1, 201))
    assert trace.percentile(v, 95) == statistics.quantiles(v, n=100)[94]
    assert trace.percentile(v, 95) == pytest.approx(190.95)
    assert trace.rate(10.0, 4.0) == 2.5
    with pytest.raises(ValueError):
        trace.rate(1.0, 0.0)


def test_metric_readers_on_a_synthetic_run():
    run = harness.Run("c", {}, {}, {"samples": 6144, "lanes": 16384,
                                    "packets": 128})
    run.trace = _trace()
    read = lambda n: harness.metric_reader(n).read(run)  # noqa: E731
    assert read("idle_pct") == pytest.approx(63.0)
    assert read("launches_per_seg") == 2.5
    from benchmark import roofline
    assert read("pdm_roofline_pct") == pytest.approx(
        100 * roofline.pdm_s(6144, 16384) / 10e-6)
    assert read("cascade_roofline_pct") is None
    run.audio_s, run.window_s = 30.0, 3.0
    assert read("rtf") == 10.0
    assert read("peak_mem_gb") is None
    run.peak_bytes = 2 * 10**9
    assert read("peak_mem_gb") == 2.0
    run.counters = {"lanes": 17408, "streams": 16384}
    assert read("pad_waste_pct") == pytest.approx(100 * 1024 / 17408)
