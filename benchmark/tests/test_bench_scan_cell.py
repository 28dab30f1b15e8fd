"""The multi-tenant scan cell (``rp2350_scan_tenants8``): correct on the CPU
at a tiny size through the harness, not correct under its control
(``hetero_scan.bf16_coefficients``) nor with its timed path broken; its
entry refuses any other lowering or platform; the float kernels' frozen
bounds at the cell's shape (PERF.md's kernel table); and the two readers
on a synthetic trace."""

from __future__ import annotations

import pytest

from benchmark import harness, roofline_f32, trace
from benchmark.entries import hetero_scan
from benchmark.reference import config
from benchmark.tests import cpu_run
from benchmark.tests.test_bench_faults import (answer_altered,
                                               half_the_batch,
                                               state_unchanged)

CELL = "rp2350_scan_tenants8"
T, NPKT, LANES, B = 6144, 128, 17408, 16384


def test_cell_is_correct_on_the_cpu():
    res = cpu_run.run(CELL)
    assert res["correct"], res["checked"]
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"rtf", "setup_s"}


def test_bf16_coefficients_are_not_correct():
    res = cpu_run.run(CELL, fault=hetero_scan.bf16_coefficients)
    assert not res["correct"]
    assert res["checked"]["state_gap"]["value"] > \
        res["checked"]["state_gap"]["limit"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    assert not cpu_run.run(CELL, fault=fault)["correct"]


def test_counters_name_the_scan_kernels(monkeypatch):
    got = {}
    real = harness.run_cell

    def keep(*a, **kw):
        kw["log"] = lambda s: got.setdefault("log", []).append(s)
        return real(*a, **kw)

    monkeypatch.setattr(harness, "run_cell", keep)
    cpu_run.run(CELL)
    counters = dict(s[len("counter "):].split(": ") for s in got["log"]
                    if s.startswith("counter "))
    assert list(counters) == ["lanes", "streams", "padding_waste",
                              "eq_f32_lane_launches", "xf_f32_launches"]
    # the CPU runs the plain versions: no kernel launch to count
    assert counters["eq_f32_lane_launches"] == "0"
    assert counters["xf_f32_launches"] == "0"


@pytest.mark.parametrize("spec_edit", [
    lambda s: s.pop("lowering"),
    lambda s: s.__setitem__("lowering", "mxu"),
    lambda s: s["device"].__setitem__("platform", "rp2040")])
def test_the_entry_refuses_another_lowering_or_platform(spec_edit):
    spec = config.load("rp2350_scan")
    spec_edit(spec)
    work = harness.workload(CELL)
    ctx = harness.Ctx(work, spec, 1, "cpu", dict(work["traffic"]))
    with pytest.raises(ValueError):
        hetero_scan.build(ctx)


def test_float_kernel_bounds_at_the_cells_shape():
    spec = config.load("rp2350_scan")
    at = roofline_f32.segment_bounds(spec, T, LANES, NPKT, True)
    assert 1e3 * at["eq_f32"] == pytest.approx(4.780, abs=5e-4)
    assert 1e3 * at["xf_f32"] == pytest.approx(0.511, abs=5e-4)
    at = roofline_f32.segment_bounds(spec, T, B, NPKT, False)
    assert 1e3 * at["eq_f32"] == pytest.approx(4.498, abs=5e-4)
    assert 1e3 * at["xf_f32"] == pytest.approx(0.481, abs=5e-4)
    master, outs = roofline_f32.band_kinds(spec)
    kinds = (3, 4, 4, 5, 4, 4, 4, 1, 1, 1)
    assert master == [kinds] * 2 and outs == [kinds] * 9
    ms = 1e3 * roofline_f32.eq_f32_s(master, True, True, T, LANES, NPKT,
                                     True)
    assert ms == pytest.approx(1.068, abs=5e-4)


def test_the_tenant_rules_keep_the_band_kinds():
    spec = config.load("rp2350_scan")
    want = roofline_f32.band_kinds(spec)
    for tn in harness.workload(CELL)["traffic"]["tenants"]:
        scaled = config.load("rp2350_scan")
        for bands in scaled["device"]["eq"]:
            for band in bands:
                band["freq"] *= tn["freq_scale"]
        assert roofline_f32.band_kinds(scaled) == want, tn


def test_readers_on_a_synthetic_trace():
    tr = trace.Trace(w0=0.0, w1=1e5, segments=2)
    eq = "(anonymous namespace)::cascade_kernel(float const*, float const*)"
    xf = "(anonymous namespace)::xf_kernel(float const*, float const*)"
    q28 = "(anonymous namespace)::cascade_kernel(int const*, int const*)"
    # two segments: each a master and an output launch, one crossfeed
    tr.device = [(eq, 0.0, 2000.0), (eq, 2000.0, 7000.0),
                 (xf, 7000.0, 7800.0), (q28, 8000.0, 9000.0),
                 (eq, 10000.0, 12000.0), (eq, 12000.0, 17000.0),
                 (xf, 17000.0, 17800.0)]
    shape = {"samples": T, "lanes": LANES, "packets": NPKT, "streams": B,
             "tenants": 8}
    spec = config.load("rp2350_scan")
    run = harness.Run(CELL, {}, spec, shape, trace=tr)
    bound = roofline_f32.segment_bounds(spec, T, LANES, NPKT, True)
    eq_pct = harness.metric_reader("eqf32_roofline_pct").read(run)
    xf_pct = harness.metric_reader("xff32_roofline_pct").read(run)
    assert eq_pct == pytest.approx(100 * bound["eq_f32"] / 7e-3)
    assert xf_pct == pytest.approx(100 * bound["xf_f32"] / 0.8e-3)
    tr.device = [d for d in tr.device if d[0] == q28]
    assert harness.metric_reader("eqf32_roofline_pct").read(run) is None
    assert harness.metric_reader("xff32_roofline_pct").read(run) is None
