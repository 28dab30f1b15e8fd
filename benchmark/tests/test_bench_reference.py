"""The reference against the port on the CPU at a tiny size: each entry
and both configurations, through a whole run of the harness."""

import pytest

from benchmark.tests import cpu_run


@pytest.mark.parametrize("cell", ["rp2350_render", "rp2040_render",
                                  "rp2040_tenants8"])
def test_cell_is_correct_on_the_cpu(cell):
    res = cpu_run.run(cell)
    assert res["correct"], res["checked"]
    assert res["attempted"] >= 2


def test_traced_run_reports_breakdown():
    res = cpu_run.run("rp2040_tenants8", traced=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < res["metrics"]["pad_waste_pct"]["value"] < 100
