"""The Q28 chain on random aperiodic packet schedules (nine packets of
24-63 samples, as tests/test_fuzz.py builds them, three segments of it)
on random configs: the port's Engine word for word against the golden
model and the JAX engine (tests/fuzz_twin.py).  The seeds marked slow run
with ``-m slow``.  Also: chip_smoke.py's copy of ``random_config``, on the
port's types, against tests/test_fuzz.py's on every seed its fuzz phase
runs."""

import numpy as np
import pytest

import chip_smoke
import fuzz_twin as fz
from dspi_tpu import Platform as JPlatform
from dspi_tpu_torch import Platform
from test_fuzz import random_config
from test_torch_pack import _convert

SEEDS = [606, 707] + [pytest.param(s, marks=pytest.mark.slow)
                      for s in (13, 14)]


@pytest.mark.parametrize("against", ["golden", "jax"])
@pytest.mark.parametrize("seed", SEEDS)
def test_q28_random_schedule(seed, against):
    fz.check_q28(seed, True, against)


@pytest.mark.parametrize("seed, platform, scheduled", [
    *((s, "RP2040", False) for s in chip_smoke.FUZZ_Q28),
    *((s, "RP2040", True) for s in chip_smoke.FUZZ_SCHED),
    *((s, "RP2350", False) for s in chip_smoke.FUZZ_FLOAT)])
def test_chip_smoke_random_config_is_a_copy(seed, platform, scheduled):
    """Field for field the same config, and the same schedule after it."""
    rng = np.random.default_rng(seed)
    want = _convert(random_config(rng, getattr(JPlatform, platform)))
    sched = (tuple(int(v) for v in rng.integers(24, 64, size=9))
             if scheduled else None)
    cfg, got_sched = chip_smoke.fuzz_case(seed, getattr(Platform, platform),
                                          scheduled)
    assert type(cfg) is type(want)
    assert cfg == want
    assert got_sched == sched
