"""The frozen yardstick reproduces the bounds that PERF.md's kernel table
gives at the main path's shapes (6144 samples, 16,384 streams; the
multi-tenant path's 17,408 lanes)."""

import pytest

from benchmark import roofline

T, B, NPKT, LANES = 6144, 16384, 128, 17408


def test_pdm_bound():
    assert 1e3 * roofline.pdm_s(T, B) == pytest.approx(5.248, abs=5e-4)


def test_scalar_cascade_bound():
    ms = 1e3 * (roofline.cascade_s(2, 10, True, True, T, B, NPKT, False)
                + roofline.cascade_s(5, 10, False, False, T, B, NPKT, False))
    assert ms == pytest.approx(6.788, abs=5e-4)


def test_lane_cf_bound():
    ms = 1e3 * (roofline.cascade_s(2, 10, True, True, T, LANES, NPKT, True)
                + roofline.cascade_s(5, 10, False, False, T, LANES, NPKT,
                                     True))
    assert ms == pytest.approx(7.213, abs=1e-3)


def test_crossfeed_bound():
    assert 1e3 * roofline.xf_s(T, B) == pytest.approx(0.481, abs=5e-4)


def test_clock_is_a_constant():
    assert roofline.sm_clocks_per_s() == 132 * 1.98e9
