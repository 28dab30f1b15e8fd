"""A whole run of a cell on the CPU at a tiny size, for the tests: the
harness's own code, with the traffic's sizes overridden."""

from __future__ import annotations

import time

TINY = {"streams": 8, "packets": 2, "readback_every": 2, "trace_segments": 1}


def run(cell: str, seed: int = 2**31 + 77, traced: bool = False, **kw):
    from benchmark import harness

    return harness.run_cell(cell, seed, 0.2, traced, time.perf_counter(),
                            "cpu", traffic=dict(TINY), workers=1,
                            log=lambda s: None, **kw)
