"""The Q28 chain on random configs: the port's Engine word for word
against the golden model and the JAX engine (tests/fuzz_twin.py), 24
packets of 48, on tests/test_fuzz.py's random configs.  The seeds marked
slow run with ``-m slow``."""

import pytest

import fuzz_twin as fz

SEEDS = [1, 2, 101, 303] + [pytest.param(s, marks=pytest.mark.slow)
                            for s in (3, 4, 5, 6, 202)]


@pytest.mark.parametrize("against", ["golden", "jax"])
@pytest.mark.parametrize("seed", SEEDS)
def test_q28_random_config(seed, against):
    fz.check_q28(seed, False, against)
