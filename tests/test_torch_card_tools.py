"""The chain's names that the card tools patch: each resolves, and the
chain calls it through its module, so that patching it takes effect.

``chip_smoke.recording`` wraps each (module, name) of
``chip_smoke._RECORDED`` to record the kernel wrappers' calls of a path
at its full shape, and ``chip_smoke.py`` and ``profile_torch.py`` swap
``pipeline._wire_stage`` to time and trace the wire stage alone.  Both
run only on the card, so without these tests a rename in the chain would
break them unseen.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, pipeline
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.kernels import pdm_cuda

MODULES = {"pipeline": pipeline, "pdm_cuda": pdm_cuda}
PATCHED = ([(m, n) for m, n, _ in chip_smoke._RECORDED]
           + [("pipeline", "_wire_stage")])


def _segment(platform, **kw):
    eng = Engine(full_chain_config(platform), 2, device="cpu", **kw)
    x = np.random.default_rng(5).integers(-9000, 9000, (1, 2, 48, 2))
    eng.process(torch.from_numpy(x.astype(np.int32)))


@pytest.mark.parametrize("module, name", PATCHED)
def test_patched_name_resolves(module, name):
    assert callable(getattr(MODULES[module], name))


def test_recording_sees_every_wrapper_and_restores_them():
    """One segment of each chain on its kernel wrappers (the Q28 chain
    with the PDM sub, the float chain's scan lowering) inside
    ``recording``: every kind is recorded, and the names are restored."""
    before = {(m, n): getattr(MODULES[m], n)
              for m, n, _ in chip_smoke._RECORDED}
    calls = []
    with chip_smoke.recording(calls):
        _segment(Platform.RP2040)
        _segment(Platform.RP2350, mxu=False, pdm=False)
    assert {c[0] for c in calls} == {k for _m, _n, k in chip_smoke._RECORDED}
    for (m, n), fn in before.items():
        assert getattr(MODULES[m], n) is fn


def test_the_wire_stage_is_called_through_pipeline(monkeypatch):
    seen = []
    wire = pipeline._wire_stage

    def spy(*a, **kw):
        seen.append(True)
        return wire(*a, **kw)

    monkeypatch.setattr(pipeline, "_wire_stage", spy)
    _segment(Platform.RP2350, wire=True, pdm=False)
    assert seen
