"""The 44.1 kHz render cell (``rp2350_render_44k1``): correct on the CPU at a
tiny size through the harness (one 10-packet group of 441 samples), not
correct with its timed path broken nor with the reference handed the
cadence rotated by one packet; its entry refuses a rate without a packet
schedule; its counter and ``carry_steps_per_seg`` read the block layout's
arithmetic, and nothing where the program keeps no count."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.entries import render_sched
from benchmark.reference import config
from benchmark.tests import cpu_run
from benchmark.tests.test_bench_faults import (answer_altered,
                                               half_the_batch,
                                               state_unchanged)

CELL = "rp2350_render_44k1"
# cpu_run.TINY's 2 packets round up to one 10 ms group: 441 samples,
# re-blocked by the LTI passes to 9 blocks of 49
TINY_STEPS = 4 * 9 + 10


def cadence_rotated(cell):
    """The reference gets the cadence rotated by one packet (the 45 first):
    the same samples, another packet grid."""
    cell.schedule = cell.schedule[-1:] + cell.schedule[:-1]


def _run_with_log(monkeypatch, **kw):
    got = []
    real = harness.run_cell

    def keep(*a, **k):
        k["log"] = got.append
        return real(*a, **k)

    monkeypatch.setattr(harness, "run_cell", keep)
    return cpu_run.run(CELL, **kw), got


def test_cell_is_correct_on_the_cpu(monkeypatch):
    res, log = _run_with_log(monkeypatch)
    assert res["correct"], res["checked"]
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"rtf", "setup_s"}
    counters = dict(s[len("counter "):].split(": ") for s in log
                    if s.startswith("counter "))
    assert counters == {"carry_steps": str(TINY_STEPS * res["attempted"])}


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered, cadence_rotated])
def test_a_broken_timed_path_or_grid_is_not_correct(fault):
    res = cpu_run.run(CELL, fault=fault)
    assert not res["correct"], res["checked"]


def test_the_entry_refuses_a_rate_without_a_schedule():
    work = harness.workload(CELL)
    ctx = harness.Ctx(work, config.load("rp2350_full"), 1, "cpu",
                      dict(work["traffic"]))
    with pytest.raises(ValueError):
        render_sched.build(ctx)


def test_the_cells_shape_and_reference_packets():
    work = harness.workload(CELL)
    ctx = harness.Ctx(work, config.load("rp2350_44k1"), 1, "cpu",
                      {**work["traffic"], "streams": 2})
    cell = render_sched.build(ctx)
    assert cell.shape == {"samples": 5733, "lanes": 2, "packets": 130,
                          "streams": 2}
    assert cell.block == 45 and tuple(cell.x.shape) == (2, 5733, 2)
    assert cell.audio_s_per_segment == pytest.approx(2 * 5733 / 44100.0)
    task = cell._task(1, [0, 3], None)
    assert task["block"] == 45 and len(task["xs"]) == 2
    pk = task["xs"][1]
    assert [p.shape for p in pk] == [(2, n) for n in cell.schedule]
    assert (pk[9] == (cell.x_lanes[:, 396:441, 1] ^ 3)).all()


def test_carry_steps_per_seg_reader():
    read = harness.metric_reader("carry_steps_per_seg").read
    run = harness.Run(CELL, {}, {}, {}, segments=4,
                      counters={"carry_steps": 4 * 718})
    assert read(run) == 718
    assert read(harness.Run(CELL, {}, {}, {}, segments=4)) is None
    run.segments = 0
    assert read(run) is None
