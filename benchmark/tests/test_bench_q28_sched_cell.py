"""The Q28 44.1 kHz render cell (``rp2040_render_44k1``): correct on the CPU
at a tiny size through the harness (one 10-packet group of 441 samples),
not correct with its timed path broken, with the reference handed the
cadence rotated by one packet, nor under its Q24 control; its shape at the
cell's size; and ``cascade_sched_roofline_pct`` reads the cascade kernel's
calls against ``roofline.cascade_s`` on a schedule, and nothing without a
trace or on uniform packets."""

from __future__ import annotations

import pytest

from benchmark import harness, roofline, trace
from benchmark.entries import render_sched
from benchmark.reference import config
from benchmark.tests import cpu_run
from benchmark.tests.test_bench_faults import (answer_altered,
                                               half_the_batch,
                                               state_unchanged)
from benchmark.tests.test_bench_sched_cell import cadence_rotated

CELL = "rp2040_render_44k1"


def test_cell_is_correct_on_the_cpu():
    res = cpu_run.run(CELL)
    assert res["correct"], res["checked"]
    assert res["checked"]["mismatch"]["value"] == 0
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"rtf", "setup_s"}


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered, cadence_rotated])
def test_a_broken_timed_path_or_grid_is_not_correct(fault):
    res = cpu_run.run(CELL, fault=fault)
    assert not res["correct"], res["checked"]


def test_q24_control_is_not_correct():
    res = cpu_run.run(CELL, control_bits=4)
    assert not res["correct"]
    assert res["checked"]["mismatch"]["value"] > 0


def test_the_cells_shape():
    work = harness.workload(CELL)
    ctx = harness.Ctx(work, config.load("rp2040_44k1"), 1, "cpu",
                      {**work["traffic"], "streams": 2})
    cell = render_sched.build(ctx)
    assert cell.shape == {"samples": 5733, "lanes": 2, "packets": 130,
                          "streams": 2}
    assert cell.block == 45 and tuple(cell.x.shape) == (2, 5733, 2)
    assert cell.audio_s_per_segment == pytest.approx(2 * 5733 / 44100.0)
    assert len(cell.schedule) == 130 and sum(cell.schedule) == 5733


def _run(shape, events, segments=2):
    tr = trace.Trace(device=events, w0=0.0, w1=1e9, segments=segments)
    return harness.Run(CELL, {}, config.load("rp2040_44k1"), shape,
                       trace=tr)


def test_cascade_sched_roofline_pct_reader():
    read = harness.metric_reader("cascade_sched_roofline_pct").read
    B = 16384
    shape = {"samples": 5733, "lanes": B, "packets": 130, "streams": B}
    # two segments, each a master call of 6 ms and an output call of 3.5
    events = [("void cascade_kernel<10, true, true>", 0.0, 6000.0),
              ("void cascade_kernel<10, false, false>", 7000.0, 10500.0),
              ("pdm_kernel", 11000.0, 12000.0),
              ("void cascade_kernel<10, true, true>", 20000.0, 26000.0),
              ("void cascade_kernel<10, false, false>", 27000.0, 30500.0)]
    bound = (roofline.cascade_s(2, 10, True, True, 5733, B, 130, False)
             + roofline.cascade_s(5, 10, False, False, 5733, B, 130, False))
    assert read(_run(shape, events)) == pytest.approx(
        100.0 * bound / 9.5e-3)
    assert 50 < read(_run(shape, events)) < 80
    assert read(harness.Run(CELL, {}, {}, shape)) is None
    assert read(_run(shape, [("pdm_kernel", 0.0, 1.0)])) is None
    uniform = {"samples": 6144, "lanes": B, "packets": 128, "streams": B}
    assert read(_run(uniform, events)) is None
