"""The float chain on random configs, seeds SEEDS: the port against the
golden model and the JAX block engine (tests/fuzz_twin.py).  The scan
lowering bit for bit, the block lowering's 1e-6 budget (a strict xfail
naming F1 where it breaks) and the assertions that show why."""

import pytest

import fuzz_twin as fz

SEEDS = [12, 35, 36, 101, 505]


@pytest.mark.parametrize("check", list(fz.FLOAT_CHECKS))
@pytest.mark.parametrize("seed", SEEDS)
def test_float_random_config(seed, check):
    fz.FLOAT_CHECKS[check](seed)


@pytest.mark.parametrize("seed", [fz.block_param(s) for s in SEEDS])
def test_block_lowering_budget(seed):
    fz.check_block_budget(seed)
