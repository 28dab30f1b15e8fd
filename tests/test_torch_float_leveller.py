"""The float chain's leveller after 130 packets, on the port, the JAX
package's ``Engine(mxu=True)`` and the golden model, at 44.1 kHz (the
44/45 cadence, 5733 samples): the headline chain, one segment.

The leveller's RMS envelope runs a ~300 ms window (alpha ~0.99993 a
sample).  The golden model computes it sample by sample, rounding each
step; both engines compute it a packet at a time from weighted block sums.
Over a window of N ~ 6,000 steps the golden model's own rounding walks by
about sqrt(N) * 2^-24 ~ 5e-6 relative, and the envelope's gap to it grows
with the packet count until N reaches the window (tests/test_torch_chain.py
reads 7.4e-7 after 16 packets).  So the carried envelope and smoothed gain
are held, after 130 packets, to 1e-5 relative RMS against the golden
model: twice that walk (the JAX engine's own distance is recorded, not
held).  The outputs, whose gain the smoothed gain sets through exp10, stay
held to the 1e-6 fidelity budget against both.  ``PYTHONPATH=. python
tests/test_torch_float_leveller.py`` prints the readings, at 48 kHz (130
packets of 48, as a uniform schedule) too.
"""

import functools

import numpy as np
import pytest

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import Engine as JEngine
from dspi_tpu.golden.model import GoldenDevice
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, packet_geometry
from dspi_tpu_torch.configs import full_chain_config

from test_torch_chain import _rel_rms
from test_torch_q28 import _np
from test_torch_schedule import _golden_feed

B, NPKT = 2, 130


@functools.lru_cache(maxsize=None)
def _run(rate):
    """One 130-packet segment through the JAX engine, the port (from its
    params and state) and the golden model (the first stream: ~4 s).
    Returns ({field: (port vs JAX, port vs golden, JAX vs golden)}, the
    outputs' relative RMS: (port vs JAX, port vs golden))."""
    sched = packet_geometry(rate, NPKT)[1] or (48,) * NPKT
    jcfg = bench.full_chain_config(JPlatform.RP2350, float(rate))
    je = JEngine(jcfg, n_streams=B, schedule=sched, emit="full", mxu=True,
                 pdm=False, unroll=4)
    te = Engine(full_chain_config(Platform.RP2350, float(rate)), n_streams=B,
                schedule=sched, emit="full", pdm=False, device="cpu")
    te.load_params_state(je.params, je.state)
    x = np.random.default_rng(0x130).integers(
        -16000, 16000, size=(2, sum(sched), B)).astype(np.int32)
    jo, to = np.asarray(je.process(x)["out"]), _np(te.process(x)["out"])
    gold = GoldenDevice(jcfg.copy())
    per = _golden_feed([gold], x, sched, np.ones(len(sched), np.float32))[0]
    want = np.concatenate([np.asarray(p["buf_out"]) for p in per], axis=-1)
    state = {"lev_env": np.asarray(gold.lev_env)[:, None],
             "lev_gain_db": np.array([gold.lev_gain_smooth_db])}
    gaps = {}
    for f, g in state.items():
        port = _np(getattr(te.state, f))[..., :1]
        jax_ = np.asarray(getattr(je.state, f))[..., :1]
        gaps[f] = (_rel_rms(port, jax_), _rel_rms(port, g), _rel_rms(jax_, g))
    return gaps, (_rel_rms(to, jo), _rel_rms(to[..., 0], want))


def test_outputs_after_130_packets():
    _, (vs_jax, vs_golden) = _run(44100)
    assert vs_jax < 1e-6 and vs_golden < 1e-6, (vs_jax, vs_golden)


@pytest.mark.parametrize("field", ["lev_env", "lev_gain_db"])
def test_leveller_state_after_130_packets(field):
    vs_jax, port, jax_ = _run(44100)[0][field]
    assert port < 1e-5, (field, port, vs_jax, jax_)


if __name__ == "__main__":
    for rate in (44100, 48000):
        gaps, outs = _run(rate)
        for f, (vs_jax, port, jax_) in gaps.items():
            print(f"{rate} Hz, {f} after {NPKT} packets: port vs JAX engine "
                  f"{vs_jax:.3e}, port vs golden model {port:.3e}, JAX "
                  f"engine vs golden model {jax_:.3e}")
        print(f"{rate} Hz, out: port vs JAX engine {outs[0]:.3e}, port vs "
              f"golden model {outs[1]:.3e}")
