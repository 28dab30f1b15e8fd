"""The control of each configuration comes out not correct.

Q28 cells: the reference put in the program's place with its Q28 EQ
coefficients 4 bits short (Q24), at a tiny size on the CPU here; at the
cells' own size through ``benchmark/control.py`` on the card's host.
Float cells: the program with TF32 on its block products, which only the
card has: ``benchmark/control.py`` on the card (this test skips without
one)."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import cpu_run


@pytest.mark.parametrize("cell", ["rp2040_render", "rp2040_tenants8"])
def test_q28_control_fails(cell):
    res = cpu_run.run(cell, control_bits=4)
    assert not res["correct"]
    assert res["checked"]["mismatch"]["value"] > 0


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    import time

    from benchmark import control, harness

    res = harness.run_cell("rp2350_render", 2**31 + 99, 1.0, False,
                           time.perf_counter(), "cuda:0",
                           traffic={"streams": 1024, "packets": 16},
                           fault=control.tf32_on, log=lambda s: None)
    assert not res["correct"], res["checked"]
